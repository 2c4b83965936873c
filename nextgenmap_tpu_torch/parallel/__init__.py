"""Index sharding of the port (position-range shards on one device)."""
