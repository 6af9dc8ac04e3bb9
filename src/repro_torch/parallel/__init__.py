"""Distributed-optimisation helpers (`collectives.py`: int8 gradient
compression with error feedback and the ring-cost model).  The sharding
rules (`parallel/sharding.py` in the JAX package) wait for ROADMAP queue
1, item 9."""
