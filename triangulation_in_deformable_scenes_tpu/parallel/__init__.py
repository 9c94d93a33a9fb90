"""Multi-device execution (a NEW capability over the single-threaded reference).

- ``dist``: mesh builders, pair-batch (serving) sharding, and the
  partitioner-lowered landmark-sharded LM baseline.
- ``halo``: the production landmark-sharding path — Morton mesh partition +
  ``shard_map`` PCG with explicit O(sqrt(N)) boundary-row exchange.
- ``multihost``: ``jax.distributed`` startup, host-aware process meshes,
  and the per-host worker entry.
"""
