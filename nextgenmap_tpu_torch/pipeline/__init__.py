"""Port of nextgenmap_tpu.pipeline."""
