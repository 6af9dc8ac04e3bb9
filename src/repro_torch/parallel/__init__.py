"""Parallelism: `sharding.py` (logical-axis rules resolved on a
`DeviceMesh` into DTensor placements, the activation-sharding hooks, the
expert-parallel MoE and the vocab-sharded embedding lookup),
`local_shards.py` (attention and the kernel wrappers on DTensors, per rank
on local shards through `local_map`) and `collectives.py` (int8 gradient
compression with error feedback and the ring-cost model)."""
