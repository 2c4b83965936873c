"""The port across shards, devices and processes: index sharding
(index_shard), device slots and grids (mesh), data parallelism over reads
(dp), and read sharding across processes (distributed)."""
