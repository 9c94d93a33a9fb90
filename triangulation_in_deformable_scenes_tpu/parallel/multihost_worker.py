"""One process of a multi-host smoke run (see ``parallel/multihost.py``).

Launch one copy per process/host::

    TIDS_COORDINATOR=host0:8476 TIDS_NUM_PROCESSES=P TIDS_PROCESS_ID=$RANK \
        python -m triangulation_in_deformable_scenes_tpu.parallel.multihost_worker

Each process: initializes the distributed runtime, builds the global points
mesh over every device of every process, landmark-shards one synthetic
deformable pair across it, runs the distributed LM solve (neighbor exchange
and CG psums become cross-process collectives), and prints one JSON line
with its view of the costs. All processes must print identical costs -- the
program is SPMD over a globally-sharded array.

CPU smoke-test form (what tests/test_multihost.py and
``__graft_entry__.dryrun_multiprocess`` run)::

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=4 \
        TIDS_COORDINATOR=localhost:8476 TIDS_NUM_PROCESSES=2 TIDS_PROCESS_ID=i ...
"""

from __future__ import annotations

import json
import os
import sys


def _tiny_problem(n_side: int):
    import jax.numpy as jnp
    import numpy as np

    from ..models import deformable
    from ..ops import camera, lie

    cam = np.array([458.654, 457.296, 367.215, 248.375, 0, 0, 0, 0], dtype=np.float64)
    rng = np.random.default_rng(0)
    xs, ys = np.meshgrid(np.linspace(-0.05, 0.05, n_side), np.linspace(-0.04, 0.04, n_side))
    p1 = np.stack([xs.ravel(), ys.ravel(), 0.2 + 0.004 * np.sin(xs.ravel() * 50)], axis=-1)
    p2 = p1 + 0.003 * np.stack(
        [np.sin(p1[:, 1] * 30), np.cos(p1[:, 0] * 25), np.sin(p1[:, 0] * 40)], axis=-1
    )
    c1 = np.array([-0.10, 0.02, 0.0])
    c2 = np.array([0.12, 0.01, 0.0])
    T1w = (lie.look_at(jnp.asarray(c1), jnp.asarray(p1.mean(0))), jnp.asarray(c1))
    T2w = (lie.look_at(jnp.asarray(c2), jnp.asarray(p2.mean(0))), jnp.asarray(c2))
    kp1 = np.asarray(camera.kb8_project(jnp.asarray(cam), lie.apply(*T1w, jnp.asarray(p1))))
    kp2 = np.asarray(camera.kb8_project(jnp.asarray(cam), lie.apply(*T2w, jnp.asarray(p2))))
    d1 = np.asarray(lie.apply(*T1w, jnp.asarray(p1)))[:, 2] * 0.4
    d2 = np.asarray(lie.apply(*T2w, jnp.asarray(p2)))[:, 2] * 1.7
    n = len(p1)
    p1_0 = p1 + rng.normal(scale=1e-3, size=p1.shape)
    p2_0 = p2 + rng.normal(scale=1e-3, size=p2.shape)
    data = deformable.make_pair_data(
        kp1=kp1, kp2=kp2, depth1=d1, depth2=d2, valid=np.ones(n, dtype=bool),
        cam_params=cam, T1w=T1w, T2w=T2w, p1=p1_0, p2=p2_0,
    )
    state0 = deformable.PairState(
        p1=p1_0, p2=p2_0,
        s1=jnp.asarray(0.42), s2=jnp.asarray(1.6),
        Rg=jnp.eye(3), tg=jnp.zeros(3),
    )
    hyper = deformable.Hyper(
        rep_w=jnp.asarray(1.0), arap_w=jnp.asarray(1e-3),
        depth_sigma=jnp.asarray(0.003), global_w=jnp.asarray(50.0),
    )
    return data, hyper, state0


def main() -> int:
    from . import multihost

    multihost.initialize()

    import jax
    import numpy as np

    from . import dist, halo

    # "baseline": partitioner-lowered all-gather solve
    # (dist.solve_pair_distributed); "halo": the production Morton/halo
    # shard_map PCG (halo.solve_pair_halo_global) whose boundary-row psum
    # crosses the process boundary.
    mode = os.environ.get("TIDS_WORKER_MODE") or (
        sys.argv[1] if len(sys.argv) > 1 else "baseline"
    )

    n_dev = len(jax.devices())
    # Landmark grid intentionally NOT divisible by the device count in halo
    # mode (5x5 = 25 over 8 devices): exercises pad_pair's shard-multiple
    # padding on the global mesh.
    if mode == "halo":
        n_side = 5
    else:
        n_side = 4
        while (n_side * n_side) % n_dev:
            n_side += 1
    data, hyper, state0 = _tiny_problem(n_side)

    mesh = multihost.points_submesh()
    if mode == "halo":
        res, _plan, _n = halo.solve_pair_halo_global(
            mesh, "KB8", data, hyper, state0, n_iterations=2, cg_iters=25
        )
    else:
        sdata, sstate = multihost.shard_pair_global(mesh, data, state0)
        res = dist.solve_pair_distributed(
            "KB8", sdata, hyper, sstate, n_iterations=2, cg_iters=25
        )

    # Costs are replicated -- every process holds the full scalar.
    cost = float(res.cost)
    cost0 = float(res.initial_cost)
    ok = bool(np.isfinite(cost)) and cost <= cost0 * 1.01
    print(json.dumps({
        "mode": mode,
        "process_id": jax.process_index(),
        "num_processes": jax.process_count(),
        "global_devices": n_dev,
        "local_devices": len(jax.local_devices()),
        "initial_cost": cost0,
        "final_cost": cost,
        "descended": ok,
    }), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
