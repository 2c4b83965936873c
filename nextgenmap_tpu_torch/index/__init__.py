"""Port of nextgenmap_tpu.index."""
