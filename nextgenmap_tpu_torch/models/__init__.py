"""Port of nextgenmap_tpu.models."""
