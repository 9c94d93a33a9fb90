"""Multi-host runtime entry: ``jax.distributed`` startup + process-aware meshes.

The reference is a single OS process (SURVEY.md section 2 "Parallelism:
none"); multi-host scale-out is a new capability of this framework
(SURVEY.md section 7 step 7: "jax.distributed initialization + collectives"
within a host and across hosts).

Topology model
--------------
On GPUs each process owns its own cards: a process started per card (or per
group of cards) passes ``local_device_ids`` to ``jax.distributed.initialize``
so no two processes open the same card. Cards of one host talk over NVLink
(fast); hosts talk over the network (slower). The two workload axes map onto
that asymmetry naturally:

- the PAIR axis (independent keyframe pairs, zero cross-pair math) goes
  ACROSS processes/hosts -- the network carries no steady-state traffic;
- the LANDMARK/points axis (per-matvec packed-tangent exchange + CG psums,
  see ``parallel/dist.py``) stays WITHIN a process's local devices.

``multihost_mesh`` builds exactly that mesh: axis "pairs" strides over
processes, axis "points" over each process's local devices. One process
driving all the cards of one host needs none of this: a 1-D mesh over
``jax.devices()`` (``dist.make_mesh``) covers it.

Launch (one command per host/process)::

    TIDS_COORDINATOR=host0:8476 TIDS_NUM_PROCESSES=4 TIDS_PROCESS_ID=$RANK \
        python your_driver.py

with ``initialize()`` called before any other JAX API. Nothing detects a
cluster by itself here: give the coordinator address, process count and
process id (variables or arguments). CPU smoke-testing uses the same path
with ``XLA_FLAGS=--xla_force_host_platform_device_count=K`` and
``JAX_PLATFORMS=cpu`` per process (tests/test_multihost.py spawns 2 such
processes; ``__graft_entry__.dryrun_multiprocess`` packages it).
"""

from __future__ import annotations

import os

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from . import dist

ENV_COORDINATOR = "TIDS_COORDINATOR"
ENV_NUM_PROCESSES = "TIDS_NUM_PROCESSES"
ENV_PROCESS_ID = "TIDS_PROCESS_ID"


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Start the distributed runtime; must run before any other JAX call.

    Arguments fall back to the ``TIDS_COORDINATOR`` / ``TIDS_NUM_PROCESSES``
    / ``TIDS_PROCESS_ID`` environment variables, and from there to JAX's own
    cluster auto-detection (SLURM, ...). Safe to call on a single process
    with no configuration at all (no-op initialization).
    """
    coordinator = coordinator or os.environ.get(ENV_COORDINATOR)
    if num_processes is None and os.environ.get(ENV_NUM_PROCESSES):
        num_processes = int(os.environ[ENV_NUM_PROCESSES])
    if process_id is None and os.environ.get(ENV_PROCESS_ID):
        process_id = int(os.environ[ENV_PROCESS_ID])
    if coordinator is None and num_processes is None:
        return  # single-process run; nothing to coordinate
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )


def multihost_mesh() -> Mesh:
    """2-D ("pairs", "points") mesh: pairs across processes, points within
    each process's local devices.

    Device order: ``jax.devices()`` sorted by (process_index, device id), so
    row p of the mesh is exactly process p's devices and the "points" axis
    never crosses a host boundary.
    """
    devs = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    n_proc = max(d.process_index for d in devs) + 1
    per_proc = len(devs) // n_proc
    if per_proc * n_proc != len(devs):
        raise ValueError(
            f"uneven device count: {len(devs)} devices over {n_proc} processes"
        )
    grid = np.array(devs).reshape(n_proc, per_proc)
    return Mesh(grid, (dist.PAIRS_AXIS, dist.POINTS_AXIS))


def points_submesh() -> Mesh:
    """1-D points mesh over ALL global devices (landmark sharding that spans
    hosts -- the halo exchange then crosses the network; use only when a
    single pair is too large for one host)."""
    devs = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    return Mesh(np.array(devs), (dist.POINTS_AXIS,))


def make_global_array(x: np.ndarray, mesh: Mesh, spec: P):
    """Build a globally-sharded jax.Array from a host-replicated numpy array.

    Every process must call this with the SAME logical value (the usual
    pattern: deterministic data loading keyed off the pair index). Each
    process donates only the shards it is addressable for.
    """
    sharding = NamedSharding(mesh, spec)
    return jax.make_array_from_callback(x.shape, sharding, lambda idx: x[idx])


def shard_pair_global(mesh: Mesh, data, state):
    """Landmark-shard one pair's (data, state) over a multi-process points
    mesh (``points_submesh`` or any mesh carrying the points axis)."""
    n = data.kp1.shape[0]

    def place(x):
        x = np.asarray(x)
        if x.ndim >= 1 and x.shape[0] == n:
            spec = P(dist.POINTS_AXIS, *([None] * (x.ndim - 1)))
        else:
            spec = P()
        return make_global_array(x, mesh, spec)

    import jax.tree_util as jtu

    return jtu.tree_map(place, data), jtu.tree_map(place, state)
