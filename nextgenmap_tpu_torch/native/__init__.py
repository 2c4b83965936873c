"""Port of nextgenmap_tpu.native."""
