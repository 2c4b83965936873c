"""Port of nextgenmap_tpu.io."""
