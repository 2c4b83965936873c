"""Port of nextgenmap_tpu.pair."""
