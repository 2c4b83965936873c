"""Port of nextgenmap_tpu.ops."""
