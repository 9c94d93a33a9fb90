#!/usr/bin/env python3
"""Smoke check of the reconstruction engine on one NVIDIA GPU.

Drives the main path through its normal entry points at the sizes users run,
times each phase on the card and compares what the card produced with a
plain reference:

  simulation   SimulationPipeline.run_points on the committed sweep condition
               (20 cm depth, Gradual, 10 mm gaussian + rigid, ARAP_depth_3mm;
               FarPoints and InRays seeds; weight search + rigid selection)
               at 120 and 389 points, against the same run on the CPU backend.
  dense_solve  deformable.solve_pair, dense backend, N=600 (3608 dims):
               the damped Cholesky against numpy float64, and the final LM
               cost against the CPU backend.
  pcg_solve    deformable.solve_pair, block-PCG backend, N=861 (5174 dims)
               and N=2600 (15,608 dims), against the CPU backend; and
               block_matvec against the dense H v in float64 at N=861.
  serving      deformable.solve_pairs and solve_pairs_pipelined, 16 pairs of
               N=128, K=32, against each pair's own solve_pair on the card.
  frontend     features.extract on a seeded 480x640 frame (1000 features,
               8 levels), then matching.search_for_initialization: one-hot
               descriptor bits against a take_along_axis gather on the card,
               and the match vector against the CPU backend.

It also times the plain XLA versions of the operations that once had
hand-written kernels (matching at 1024^2..8192^2, the damped Cholesky at
3608 dims, one block-PCG damped solve at N=2600), each as a share of its
phase's warm time.

Usage:
    python chip_smoke.py               # every one-card phase
    python chip_smoke.py --four-cards  # sharded solve + pair-sharded serving
                                       # on four cards, nothing else

Every earlier stdout line reports a phase; the last line is one JSON object
``{"ok": true, "device": {...}}``, printed only when every phase passed. The
script exits non-zero, printing no result, when JAX's backend is not the GPU
or when any phase fails. Journals go to ``chiprun_out/chip_smoke/``.

Values this script chooses itself (the configuration is built in code):
  camera       KB8 fx=458.654 fy=457.296 cx=367.215 cy=248.375, no
               distortion (the camera of the repo's tests and bench.py)
  poses        C1 at the origin, C2 at (0.14, 0.01, 0.06) m (the 20 cm sweep
               pose, harness/sweep.CAMERA_POSES)
  noise        1 px pixel noise rounded to 1 decimal, 3 mm depth noise,
               unit depth scales (bench.sweep_cfg)
  parallax     min_cos 0.9998 (every match of this fixture passes)
  weights      start rep=1, global=1, arap=1e4; search bounds rep [1, 1],
               global [1, 1], arap [1e-5, 1e7] (tests/test_sequence_e2e)
  outer        5 rounds x 8 evaluations (README budget check),
               15 inner LM iterations and tolerances 1.5e-2
               (tests/test_simulation_e2e.fast_cfg)
  solves       the D1 fixture seeded InRays with the pipeline's depth-scale
               priors; 10 LM iterations for dense_solve, pcg_solve and
               four_cards; 25 for serving (bench.serving_throughput);
               hyper rep_w=1, arap_w=1e-4, depth_sigma=3 mm, global_w=50
               (bench.py)
  seed         --seed (default 0) draws every fixture, noise and frame.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# Full sizes (the driver's run). Tests pass smaller ones.
FULL_SIZES = dict(
    sim_points=(120, 389),
    sim_locations=("FarPoints", "InRays"),
    dense_n=600,
    pcg_n=(861, 2600),
    matvec_n=861,
    lm_iters=10,
    serving=(16, 128, 25),
    frame=(480, 640),
    n_features=1000,
    n_levels=8,
    match_sizes=(1024, 2048, 4096, 8192),
    four_n=16384,
    four_pairs=16,
)

CAM = np.array([458.654, 457.296, 367.215, 248.375, 0.0, 0.0, 0.0, 0.0])

# Above this many points the CPU reference covers the first outer round
# only (card and CPU both run it): a CPU run of all five rounds at 389
# points takes longer than this whole script may (dense J^T J of ~160 GFLOP
# per LM iteration). The card's full five-round run is still timed and
# reported.
SIM_FULL_REFERENCE_MAX_POINTS = 200

# Tolerances, each with its source.
TOL_SIM_FINAL = 0.05  # final avg 3D error, card vs CPU run (relative)
# Final LM cost, card vs reference (relative): 1e-3, or SPREAD_FACTOR times
# the reference's own spread over SPREAD_RUNS rounding-level variants of the
# same problem, whichever is larger. A variant reorders the points (every
# sum is taken in another order) and moves each pixel observation by at
# most one float32 ulp (as the card's own transcendental functions move a
# projection). Ten LM iterations amplify rounding: the block-PCG solve
# stops at a residual tolerance, so a rounding-level change can change its
# CG iteration count and the step by up to CG_RTOL, and the final costs of
# two such CPU runs then differ by 1e-3 to 3e-2.
TOL_COST = 1e-3
SPREAD_RUNS = 3
SPREAD_FACTOR = 3.0
TOL_CHOL_FACTOR = 2.0  # card error vs numpy f64 <= 2x the CPU f32 error
# block vs dense assembly in f32: tests/test_block_system.py pins 2e-4.
TOL_MATVEC = 2e-4


class PhaseFailed(Exception):
    pass


class Phase:
    """Prints one phase's lines and collects its failed checks."""

    def __init__(self, name, device):
        self.name = name
        self.device = device
        self.failures = []

    def line(self, msg):
        print(f"[{self.name}] {msg}", flush=True)

    def check(self, what, value, bound, source, ok=None):
        ok = bool(value <= bound) if ok is None else bool(ok)
        self.line(
            f"check {what}: {value!r} vs bound {bound!r} ({source}) -> "
            f"{'PASS' if ok else 'FAIL'}"
        )
        if not ok:
            self.failures.append(what)

    def timed(self, label, fn, block=lambda out: out):
        """Cold (compile included) and warm time of ``fn`` on this phase's
        device, each ended by ``jax.block_until_ready``."""
        import jax

        with jax.default_device(self.device):
            t0 = time.perf_counter()
            out = fn()
            jax.block_until_ready(block(out))
            cold = time.perf_counter() - t0
            t0 = time.perf_counter()
            out = fn()
            jax.block_until_ready(block(out))
            warm = time.perf_counter() - t0
        self.line(f"{label}: cold_s={cold!r} warm_s={warm!r} {peak_bytes(self.device)}")
        return out, cold, warm

    def finish(self):
        if self.failures:
            raise PhaseFailed(f"{self.name}: failed checks {self.failures}")


def peak_bytes(device):
    stats = device.memory_stats() if hasattr(device, "memory_stats") else None
    if not stats or "peak_bytes_in_use" not in stats:
        return "peak_bytes_in_use=n/a"
    return f"peak_bytes_in_use={stats['peak_bytes_in_use']}"


def reordered(host, seed):
    """The same problem with its points in another order and every pixel
    observation moved by at most one float32 ulp, the size of the
    difference between two correct float32 projections of one point."""
    rng = np.random.default_rng(seed)
    n = len(host["kp1"])
    perm = rng.permutation(n)
    out = dict(host)
    for key in ("kp1", "kp2", "depth1", "depth2", "valid", "p1", "p2"):
        out[key] = np.asarray(host[key])[perm]
    for key in ("kp1", "kp2"):
        kp = out[key].astype(np.float32)
        step = rng.integers(-1, 2, size=kp.shape)
        kp = np.where(step > 0, np.nextafter(kp, np.float32(np.inf)), kp)
        kp = np.where(step < 0, np.nextafter(kp, np.float32(-np.inf)), kp)
        out[key] = kp
    return out


def cost_spread(solve_host, host, base_cost, seed):
    """Largest relative change of the final cost ``solve_host(h)`` over
    SPREAD_RUNS reorderings of the points of ``host`` (a dict of problem
    inputs, or a list of them for a batch: elementwise then)."""
    base = np.asarray(base_cost, np.float64)
    spread = np.zeros_like(base)
    for i in range(SPREAD_RUNS):
        k = seed + 1000 + i
        h = [reordered(x, k) for x in host] if isinstance(host, list) else reordered(host, k)
        c = np.asarray(solve_host(h), np.float64)
        spread = np.maximum(spread, np.abs(c - base) / np.abs(base))
    return spread


def cost_bound(spread):
    return max(TOL_COST, SPREAD_FACTOR * float(np.max(spread)))


COST_SOURCE = f"max(1e-3, {SPREAD_FACTOR:g}x the reference's spread over rounding-level variants)"


def rel(a, b):
    a, b = np.float64(a), np.float64(b)
    return float(abs(a - b) / max(abs(b), 1e-300))


def mesh_backend_counts():
    from triangulation_in_deformable_scenes_tpu.ops import delaunay

    return dict(delaunay.CALLS)


def mesh_line(before):
    after = mesh_backend_counts()
    used = {k: after[k] - before[k] for k in after if after[k] - before[k]}
    return f"meshed by {used or 'none'}"


# ---------------------------------------------------------------------------
# Fixtures
# ---------------------------------------------------------------------------


def sim_config(location):
    from triangulation_in_deformable_scenes_tpu.config import Config

    return Config(
        fx=CAM[0], fy=CAM[1], cx=CAM[2], cy=CAM[3],
        c1_pose=(0.0, 0.0, 0.0), c2_pose=(0.14, 0.01, 0.06),
        sim_rep_error=1.0, decimals_rep_error=1,
        sim_depth_error=3.0, sim_depth_weight=3.0,
        sim_depth_scale_c1=1.0, sim_depth_scale_c2=1.0,
        min_cos=0.9998,
        triangulation_method="DepthMeasurement", triangulation_location=location,
        opt_model="ARAP_depth_3mm",
        opt_rep_weight=1.0, opt_global_weight=1.0, opt_arap_weight=1e4,
        opt_selection="twoOptimizations", opt_weights_selection="nlopt",
        n_optimizations=5, nlopt_n_optimizations=8, n_opt_iterations=15,
        nlopt_rel_tolerance=1.5e-2, nlopt_abs_tolerance=1.5e-2,
        nlopt_rep_lower=1.0, nlopt_rep_upper=1.0,
        nlopt_global_lower=1.0, nlopt_global_upper=1.0,
        nlopt_arap_lower=1e-5, nlopt_arap_upper=1e7,
    )


def d1_points(n, seed):
    """The D1 sweep condition: 20 cm depth, Gradual, 10 mm gaussian + rigid."""
    from triangulation_in_deformable_scenes_tpu.harness import create_data

    return create_data.generate_points(
        num_points=n, rigid_movement=0.010, gaussian_movement=0.010,
        z_mean=0.20, movement_type="Gradual", rng=np.random.default_rng(seed),
    )


def pair_problem(n, seed):
    """Host-side (numpy) inputs of one refinement problem on the D1
    condition, prepared as the simulation pipeline prepares its first round:
    simulated observations, InRays seed, depth-scale priors, mesh snapshot.

    InRays, not FarPoints: from the FarPoints seed the LM trajectory is so
    sensitive that two CPU runs differing only in summation order (one
    device vs four halo shards) end 4e-3 apart in cost after 10 iterations,
    which no 1e-3 comparison can survive; from InRays they stay within 3e-4.
    """
    from triangulation_in_deformable_scenes_tpu.pipeline.simulation import SimulationPipeline

    cfg = sim_config("InRays")
    pipe = SimulationPipeline(cfg, seed=seed)
    orig, moved = d1_points(n, seed)
    rng = np.random.default_rng(seed)
    T1w, T2w = pipe._poses(moved[0])
    kp1, kp2, d1, d2 = pipe._simulate_observations(orig, moved, T1w, T2w, rng)
    p1, p2, valid, _, _ = pipe._triangulate(kp1, kp2, T1w, T2w, d1, d2)
    s1, se1 = pipe._initial_depth_scale(p1, T1w, d1, valid)
    s2, se2 = pipe._initial_depth_scale(p2, T2w, d2, valid)
    T1w = tuple(np.asarray(x, np.float64) for x in T1w)
    T2w = tuple(np.asarray(x, np.float64) for x in T2w)
    return dict(
        kp1=np.asarray(kp1), kp2=np.asarray(kp2), depth1=np.asarray(d1),
        depth2=np.asarray(d2), valid=np.asarray(valid), cam_params=CAM,
        T1w=T1w, T2w=T2w, p1=np.asarray(p1, np.float64), p2=np.asarray(p2, np.float64),
        scale_priors=(s1, 1.0 / max(se1, 1e-6) ** 2, s2, 1.0 / max(se2, 1e-6) ** 2),
    )


def build_problem(host):
    """(data, state, hyper) on the current default device."""
    import jax.numpy as jnp

    from triangulation_in_deformable_scenes_tpu.models import deformable
    from triangulation_in_deformable_scenes_tpu.precision import FP

    data = deformable.make_pair_data(**host)
    s1, _, s2, _ = host["scale_priors"]
    state = deformable.PairState(
        p1=jnp.asarray(host["p1"], FP), p2=jnp.asarray(host["p2"], FP),
        s1=jnp.asarray(s1, FP), s2=jnp.asarray(s2, FP),
        Rg=jnp.eye(3, dtype=FP), tg=jnp.zeros(3, dtype=FP),
    )
    return data, state, bench_hyper()


def solve_cost(host, iters):
    """Final cost of ``solve_pair`` on the problem ``host`` describes, on the
    current default device."""
    from triangulation_in_deformable_scenes_tpu.models import deformable

    data, state, hyper = build_problem(host)
    return float(deformable.solve_pair("KB8", data, hyper, state, iters).cost)


def stack_pairs(hosts):
    """(data, state) batches with a leading pair axis."""
    import jax
    import jax.numpy as jnp

    from triangulation_in_deformable_scenes_tpu.models import deformable

    stack = lambda *xs: jnp.stack(xs)
    data = jax.tree_util.tree_map(stack, *[deformable.make_pair_data(**h) for h in hosts])
    state = jax.tree_util.tree_map(stack, *[build_problem(h)[1] for h in hosts])
    return data, state


def batch_cost(hosts, iters):
    from triangulation_in_deformable_scenes_tpu.models import deformable

    bd, bst = stack_pairs(hosts)
    return np.asarray(deformable.solve_pairs("KB8", bd, bench_hyper(), bst, iters).cost)


def bench_hyper():
    import jax.numpy as jnp

    from triangulation_in_deformable_scenes_tpu.models import deformable
    from triangulation_in_deformable_scenes_tpu.precision import FP

    return deformable.Hyper(
        rep_w=jnp.asarray(1.0, FP), arap_w=jnp.asarray(1e-4, FP),
        depth_sigma=jnp.asarray(0.003, FP), global_w=jnp.asarray(50.0, FP),
        alpha=jnp.asarray(1.0, FP), beta=jnp.asarray(1.0, FP),
    )


def serving_problems(n_pairs, n, seed):
    """Host inputs of ``n_pairs`` independent pairs with K=32 (as
    bench.serving_throughput; pairs whose mesh needs another K bucket are
    redrawn so the batch stays homogeneous). Depth scales start at 1."""
    from triangulation_in_deformable_scenes_tpu.models import deformable

    rng = np.random.default_rng(seed)
    hosts = []
    while len(hosts) < n_pairs:
        p1 = rng.normal(size=(n, 3)) * 0.05 + [0, 0, 0.2]
        p2 = p1 + rng.normal(scale=0.005, size=(n, 3))
        kp = rng.uniform(100, 600, size=(n, 2))
        host = dict(
            kp1=kp, kp2=kp, depth1=p1[:, 2], depth2=p2[:, 2], valid=np.ones(n, bool),
            cam_params=CAM, T1w=(np.eye(3), np.zeros(3)), T2w=(np.eye(3), np.zeros(3)),
            p1=p1, p2=p2, scale_priors=(1.0, 1e6, 1.0, 1e6), degree_bucket=32,
        )
        if deformable.make_pair_data(**host).nbr.shape[1] == 32:
            hosts.append(host)
    return hosts


def textured_frame(h, w, seed):
    rng = np.random.default_rng(seed)
    im = rng.uniform(0, 180, size=(h, w)) + 30 * np.sin(
        np.arange(h)[:, None] / 7.0
    ) * np.cos(np.arange(w)[None, :] / 5.0)
    return im.astype(np.float32)


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_simulation(dev, ref, sizes, seed, out_dir):
    import jax

    from triangulation_in_deformable_scenes_tpu.pipeline.simulation import SimulationPipeline

    ph = Phase("simulation", dev)
    os.makedirs(out_dir, exist_ok=True)
    for n in sizes["sim_points"]:
        orig, moved = d1_points(n, seed)
        for loc in sizes["sim_locations"]:
            cfg = sim_config(loc)

            def run(cfg, tag):
                path = os.path.join(out_dir, f"sim_{n}_{loc}_{tag}.txt")
                return SimulationPipeline(cfg, seed=seed).run_points(
                    orig, moved, journal_path=path
                )

            res, _, _ = ph.timed(f"run_points n={n} {loc}", lambda: run(cfg, "card"),
                                 block=lambda r: r.state)
            ph.line(f"n={n} {loc} card: initial_mm="
                    f"{res.initial.av_error * 1e3:.4f} final_mm={res.final.av_error * 1e3:.4f} "
                    f"rounds={res.rounds} rigid_accepted={res.rigid_accepted}")
            what = "full run"
            if n > SIM_FULL_REFERENCE_MAX_POINTS:
                what = "first outer round"
                cfg1 = dataclasses.replace(cfg, n_optimizations=1)
                with jax.default_device(dev):
                    res = run(cfg1, "card_round1")
                cfg = cfg1
            with jax.default_device(ref):
                cpu = run(cfg, "cpu")
            ph.line(
                f"n={n} {loc} compared ({what}): final_mm card={res.final.av_error * 1e3:.4f} "
                f"cpu={cpu.final.av_error * 1e3:.4f} rounds card={res.rounds} cpu={cpu.rounds} "
                f"rigid card={res.rigid_accepted} cpu={cpu.rigid_accepted}"
            )
            ph.check(f"n={n} {loc} rigid decision equal", res.rigid_accepted,
                     cpu.rigid_accepted, "same decision as the CPU run",
                     ok=res.rigid_accepted == cpu.rigid_accepted)
            ph.check(f"n={n} {loc} final avg 3D error rel diff",
                     rel(res.final.av_error, cpu.final.av_error), TOL_SIM_FINAL,
                     "5% of the CPU run's final error")
    ph.finish()


def phase_dense_solve(dev, ref, sizes, seed):
    import jax

    from triangulation_in_deformable_scenes_tpu.models import deformable
    from triangulation_in_deformable_scenes_tpu.ops import lm

    ph = Phase("dense_solve", dev)
    n, iters = sizes["dense_n"], sizes["lm_iters"]
    host = pair_problem(n, seed)
    with jax.default_device(dev):
        data, state, hyper = build_problem(host)
    K = int(data.nbr.shape[1])
    dim = 6 * n + 8
    ph.line(f"N={n} K={K} dim={dim} dense_backend={deformable.use_dense_backend(n, K)}")

    res, _, warm = ph.timed(
        f"solve_pair N={n} iters={iters}",
        lambda: deformable.solve_pair("KB8", data, hyper, state, iters),
        block=lambda r: r.cost,
    )
    with jax.default_device(ref):
        cdata, cstate, chyper = build_problem(host)
        cres = deformable.solve_pair("KB8", cdata, chyper, cstate, iters)
        spread = cost_spread(lambda h: solve_cost(h, iters), host, cres.cost, seed)
        # One linearization, assembled once on the CPU and solved by both.
        H, g = jax.jit(lambda s: deformable.build_system("KB8", cdata, chyper, s))(cstate)
        H, g = np.asarray(H), np.asarray(g)
    lam = np.float32(1e-5 * H.diagonal().max())  # g2o's initial damping rule
    A64 = H.astype(np.float64) + np.float64(lam) * np.eye(dim)
    x64 = np.linalg.solve(A64, -g.astype(np.float64))
    solve = jax.jit(lm.solve_damped_cholesky)

    def err(device):
        with jax.default_device(device):
            x = solve(jax.device_put(H, device), jax.device_put(g, device), lam)
            x = np.asarray(jax.block_until_ready(x), np.float64)
        return float(np.linalg.norm(x - x64) / np.linalg.norm(x64))

    e_card, e_cpu = err(dev), err(ref)
    ph.line(f"damped Cholesky rel err vs numpy f64: card={e_card:.3e} cpu={e_cpu:.3e}")
    ph.check("Cholesky card err", e_card, TOL_CHOL_FACTOR * e_cpu,
             "2x the CPU f32 error of the same function")
    ph.line(f"final cost card={float(res.cost)!r} cpu={float(cres.cost)!r} "
            f"initial={float(res.initial_cost)!r} accepted card={int(res.n_accepted)} "
            f"cpu={int(cres.n_accepted)}")
    ph.line(f"CPU spread over rounding-level variants: {float(spread):.3e}")
    ph.check("final LM cost rel diff vs CPU", rel(res.cost, cres.cost), cost_bound(spread),
             COST_SOURCE)

    # XLA baseline: the damped solve alone at this size.
    with jax.default_device(dev):
        Hd, gd = jax.device_put(H, dev), jax.device_put(g, dev)
    _, _, t_chol = ph.timed(f"baseline solve_damped_cholesky dim={dim}",
                            lambda: solve(Hd, gd, lam))
    ph.line(f"baseline share of solve_pair warm: {t_chol / warm:.4f}")
    ph.finish()


def phase_pcg_solve(dev, ref, sizes, seed):
    import jax

    from triangulation_in_deformable_scenes_tpu.models import block_system as bs
    from triangulation_in_deformable_scenes_tpu.models import deformable

    ph = Phase("pcg_solve", dev)
    iters = sizes["lm_iters"]
    for n in sizes["pcg_n"]:
        host = pair_problem(n, seed)
        with jax.default_device(dev):
            data, state, hyper = build_problem(host)
        K = int(data.nbr.shape[1])
        ph.line(f"N={n} K={K} dim={6 * n + 8} "
                f"dense_backend={deformable.use_dense_backend(n, K)}")
        res, _, warm = ph.timed(
            f"solve_pair N={n} iters={iters}",
            lambda: deformable.solve_pair("KB8", data, hyper, state, iters),
            block=lambda r: r.cost,
        )
        with jax.default_device(ref):
            cdata, cstate, chyper = build_problem(host)
            cres = deformable.solve_pair("KB8", cdata, chyper, cstate, iters)
            spread = cost_spread(lambda h: solve_cost(h, iters), host, cres.cost, seed)
        ph.line(f"N={n} CPU spread over rounding-level variants: {float(spread):.3e}")
        ph.line(f"N={n} final cost card={float(res.cost)!r} cpu={float(cres.cost)!r} "
                f"initial={float(res.initial_cost)!r} accepted card={int(res.n_accepted)} "
                f"cpu={int(cres.n_accepted)}")
        ph.check(f"N={n} final LM cost rel diff vs CPU", rel(res.cost, cres.cost),
                 cost_bound(spread), COST_SOURCE)

        with jax.default_device(dev):
            sys_ = jax.jit(lambda s: bs.build_block_system("KB8", data, hyper, s))(state)
            lam = 1e-5 * float(jax.device_get(bs.diag_of(sys_)).max())
        if n == sizes["matvec_n"]:
            v = np.random.default_rng(seed).normal(size=6 * n + 8).astype(np.float32)
            with jax.default_device(dev):
                y = jax.jit(bs.block_matvec)(sys_, data.nbr, jax.device_put(v, dev), lam)
                y = np.asarray(y, np.float64)
            with jax.default_device(ref):
                H, _ = jax.jit(lambda s: deformable.build_system("KB8", cdata, chyper, s))(cstate)
                H = np.asarray(H, np.float64)
            y64 = H @ v.astype(np.float64) + lam * v.astype(np.float64)
            e = float(np.linalg.norm(y - y64) / np.linalg.norm(y64))
            ph.check(f"N={n} block_matvec vs dense H v (f64) rel err", e, TOL_MATVEC,
                     "f32 block vs dense assembly, tests/test_block_system.py")
        if n == max(sizes["pcg_n"]):
            # XLA baseline: one block-PCG damped solve at this size.
            with jax.default_device(dev):
                g = bs.flat_gradient(sys_)
                pcg = jax.jit(lambda sys_, g, lam: bs.pcg_flex(
                    lambda v: bs.block_matvec(sys_, data.nbr, v, lam), -g,
                    bs.block_jacobi_apply(sys_, lam), deformable.CG_ITERS, deformable.CG_RTOL))
            _, _, t_pcg = ph.timed(f"baseline block-PCG damped solve N={n}",
                                   lambda: pcg(sys_, g, lam))
            ph.line(f"baseline share of solve_pair warm: {t_pcg / warm:.4f}")
    ph.finish()


def phase_serving(dev, ref, sizes, seed):
    import jax

    from triangulation_in_deformable_scenes_tpu.models import deformable

    del ref  # compared with single-pair solves on the card itself
    ph = Phase("serving", dev)
    n_pairs, n, iters = sizes["serving"]
    hosts = serving_problems(n_pairs, n, seed)
    hyper = bench_hyper()
    with jax.default_device(dev):
        datas = [deformable.make_pair_data(**h) for h in hosts]
        states = [build_problem(h)[1] for h in hosts]
        bd, bst = stack_pairs(hosts)
    ph.line(f"pairs={n_pairs} N={n} K={int(bd.nbr.shape[-1])} iters={iters}")
    batched, _, _ = ph.timed(
        "solve_pairs", lambda: deformable.solve_pairs("KB8", bd, hyper, bst, iters),
        block=lambda r: r.cost)
    piped, _, _ = ph.timed(
        "solve_pairs_pipelined",
        lambda: deformable.solve_pairs_pipelined("KB8", datas, hyper, states, iters),
        block=lambda rs: [r.cost for r in rs])
    with jax.default_device(dev):
        single = [deformable.solve_pair("KB8", d, hyper, s, iters).cost
                  for d, s in zip(datas, states)]
        single = np.asarray(jax.device_get(single), np.float64)
        spread = cost_spread(lambda hs: batch_cost(hs, iters), hosts, batched.cost, seed)
    ph.line(f"solve_pairs spread over rounding-level variants: max {float(np.max(spread)):.3e}")
    b = np.asarray(batched.cost, np.float64)
    p = np.asarray([float(r.cost) for r in piped], np.float64)
    ph.check("solve_pairs max rel cost diff vs solve_pair",
             float(np.max(np.abs(b - single) / single)), cost_bound(spread), COST_SOURCE)
    ph.check("solve_pairs_pipelined max rel cost diff vs solve_pair",
             float(np.max(np.abs(p - single) / single)), TOL_COST,
             "1e-3 (the same program as solve_pair)")
    ph.finish()


def frontend_inputs(sizes, seed):
    h, w = sizes["frame"]
    im1 = textured_frame(h, w, seed)
    rng = np.random.default_rng(seed + 1)
    im2 = np.roll(im1, (3, 5), axis=(0, 1)) + rng.normal(scale=1.0, size=im1.shape)
    return im1, im2.astype(np.float32)


def phase_frontend(dev, ref, sizes, seed):
    import jax
    import jax.numpy as jnp

    from triangulation_in_deformable_scenes_tpu.ops import features as F
    from triangulation_in_deformable_scenes_tpu.ops import matching

    ph = Phase("frontend", dev)
    nf, nl = sizes["n_features"], sizes["n_levels"]
    im1, im2 = frontend_inputs(sizes, seed)
    sf = np.asarray(1.2 ** np.arange(nl), np.float32)
    ph.line(f"frame={im1.shape[0]}x{im1.shape[1]} features={nf} levels={nl}")
    with jax.default_device(dev):
        im1d, im2d = jax.device_put(im1, dev), jax.device_put(im2, dev)
    k1, _, t_ext = ph.timed(
        "extract", lambda: F.extract(im1d, n_features=nf, n_scales=nl, scale_factor=1.2))
    with jax.default_device(dev):
        k2 = F.extract(im2d, n_features=nf, n_scales=nl, scale_factor=1.2)

    match_jit = jax.jit(matching.search_for_initialization)

    def match(a, b, device):
        with jax.default_device(device):
            args = jax.device_put(
                (a.xy, a.desc, a.octave, a.valid, b.xy, b.desc, b.octave, b.valid, sf),
                device)
            return match_jit(*args)

    (m_card, n_card), _, t_match = ph.timed("search_for_initialization",
                                            lambda: match(k1, k2, dev))
    m_cpu, n_cpu = match(k1, k2, ref)
    ph.line(f"valid keypoints={int(jnp.sum(k1.valid))} matches card={int(n_card)} "
            f"cpu={int(n_cpu)}")
    ph.check("match vector mismatches vs CPU", int(np.sum(np.asarray(m_card) != np.asarray(m_cpu))),
             0, "identical inputs, exact integer Hamming distances")

    # One-hot descriptor select vs plain gather on the same blurred patches.
    @jax.jit
    def both(im, kp):
        levels = F.build_pyramid(im, nl, 1.2)
        budgets = F.features_per_level(nf, nl, 1.2)
        onehot, gather, start = [], [], 0
        for lvl, budget in zip(levels, budgets):
            if budget <= 0:
                continue
            sl = slice(start, start + budget)
            start += budget
            xy = kp.level_xy[sl].astype(jnp.int32)
            patches, ang = F.descriptor_patches(lvl, xy, kp.valid[sl])
            onehot.append(F.orb_descriptors_from_patches(patches, ang, kp.valid[sl]))
            gather.append(F.orb_descriptors_gather(patches, ang, kp.valid[sl]))
        return jnp.concatenate(onehot), jnp.concatenate(gather)

    with jax.default_device(dev):
        d_onehot, d_gather = jax.device_get(both(im1d, k1))
    ph.check("one-hot vs gather descriptor bit mismatches (card)",
             int(np.sum(d_onehot != d_gather)), 0, "bit-identical in full f32")
    ph.check("recomputed one-hot bits vs extract() bits mismatches",
             int(np.sum(d_onehot != np.asarray(k1.desc))), 0, "same program, same inputs")
    warm = t_ext + t_match
    ph.line(f"phase warm (extract + match) s={warm!r}")

    # XLA baselines: the dense matcher alone at growing sizes.
    for m in sizes["match_sizes"]:
        rng = np.random.default_rng(seed)
        args = (
            rng.uniform(0, 700, size=(m, 2)).astype(np.float32),
            rng.integers(0, 2, size=(m, 256)).astype(np.int8),
            np.zeros(m, np.int32), np.ones(m, bool),
            rng.uniform(0, 700, size=(m, 2)).astype(np.float32),
            rng.integers(0, 2, size=(m, 256)).astype(np.int8),
            np.zeros(m, np.int32), np.ones(m, bool), sf,
        )
        with jax.default_device(dev):
            args = jax.device_put(args, dev)
        fn = jax.jit(lambda *a: matching.search_for_initialization(*a, window_factor=100.0))
        _, _, t = ph.timed(f"baseline matching {m}x{m}", lambda: fn(*args))
        ph.line(f"baseline matching {m}x{m} share of phase warm: {t / warm:.4f}")
    ph.finish()


def phase_four_cards(devices, sizes, seed):
    """Halo-sharded solve and pair-sharded serving over ``devices`` (a 1-D
    mesh), each against the same work on ``devices[0]`` alone."""
    import jax

    from triangulation_in_deformable_scenes_tpu.models import deformable
    from triangulation_in_deformable_scenes_tpu.parallel import dist, halo

    dev0 = devices[0]
    ph = Phase("four_cards", dev0)
    n, iters = sizes["four_n"], sizes["lm_iters"]
    ph.line(f"devices={[str(d) for d in devices]}")
    host = pair_problem(n, seed)
    with jax.default_device(dev0):
        data, state, hyper = build_problem(host)
    K = int(data.nbr.shape[1])
    ph.line(f"N={n} K={K} dim={6 * n + 8} dense_backend={deformable.use_dense_backend(n, K)}")
    one, _, _ = ph.timed(f"solve_pair one card N={n}",
                         lambda: deformable.solve_pair("KB8", data, hyper, state, iters),
                         block=lambda r: r.cost)
    with jax.default_device(dev0):
        spread = cost_spread(lambda h: solve_cost(h, iters), host, one.cost, seed)
    ph.line(f"one-card spread over rounding-level variants: {float(spread):.3e}")
    mesh = dist.make_mesh(devices)
    sharded, _, _ = ph.timed(
        f"halo.solve_pair_halo {len(devices)} cards N={n}",
        lambda: halo.solve_pair_halo(mesh, "KB8", data, hyper, state, iters,
                                     cg_iters=deformable.CG_ITERS, max_trials=10),
        block=lambda r: r.cost)
    ph.line(f"halo cost devices={sorted(d.id for d in sharded.cost.sharding.device_set)} "
            f"state devices={sorted(d.id for d in sharded.state.p1.sharding.device_set)}")
    ph.line(f"final cost one card={float(one.cost)!r} {len(devices)} cards="
            f"{float(sharded.cost)!r} initial={float(one.initial_cost)!r}")
    ph.check("halo final cost rel diff vs one card", rel(sharded.cost, one.cost),
             cost_bound(spread), COST_SOURCE)

    n_pairs, pn, piters = sizes["four_pairs"], sizes["serving"][1], sizes["serving"][2]
    hosts = serving_problems(n_pairs, pn, seed)
    with jax.default_device(dev0):
        bd, bst = stack_pairs(hosts)
    one_b, _, _ = ph.timed(f"solve_pairs one card pairs={n_pairs}",
                           lambda: deformable.solve_pairs("KB8", bd, hyper, bst, piters),
                           block=lambda r: r.cost)
    smesh = dist.make_serving_mesh(devices)
    sd, ss = dist.shard_pairs(smesh, bd, bst)
    many, _, _ = ph.timed(f"solve_pairs {len(devices)} cards pairs={n_pairs}",
                          lambda: deformable.solve_pairs("KB8", sd, hyper, ss, piters),
                          block=lambda r: r.cost)
    ph.line(f"serving cost devices={sorted(d.id for d in many.cost.sharding.device_set)} "
            f"state devices={sorted(d.id for d in many.state.p1.sharding.device_set)}")
    a = np.asarray(many.cost, np.float64)
    b = np.asarray(one_b.cost, np.float64)
    with jax.default_device(dev0):
        spread = cost_spread(lambda hs: batch_cost(hs, piters), hosts, one_b.cost, seed)
    ph.check("pair-sharded serving max rel cost diff vs one card",
             float(np.max(np.abs(a - b) / b)), cost_bound(spread), COST_SOURCE)
    ph.check("serving output spread over every card",
             len(many.cost.sharding.device_set), len(devices),
             "one shard per card", ok=len(many.cost.sharding.device_set) == len(devices))
    ph.finish()


def result_line(devices):
    """The last stdout line: the device as JAX reports it."""
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": len(devices)}})


def nvidia_smi_lines():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card sharded solve and serving checks")
    args = ap.parse_args(argv)

    import jax

    if jax.default_backend() != "gpu":
        print(f"chip_smoke: JAX backend is {jax.default_backend()!r}, not 'gpu'; "
              "nothing was run", file=sys.stderr)
        return 2

    for ln in nvidia_smi_lines():
        print(ln, flush=True)
    devices = jax.devices()
    print(f"jax {jax.__version__} devices={len(devices)} kind={devices[0].device_kind}",
          flush=True)
    seed, sizes, cpu = args.seed, FULL_SIZES, jax.devices("cpu")[0]
    out_dir = os.path.join(REPO, "chiprun_out", "chip_smoke")
    if args.four_cards:
        if len(devices) < 4:
            print(f"chip_smoke: --four-cards needs 4 GPUs, found {len(devices)}",
                  file=sys.stderr)
            return 2
        phases = {"four_cards": lambda: phase_four_cards(devices[:4], sizes, seed)}
    else:
        gpu = devices[0]
        phases = {
            "simulation": lambda: phase_simulation(gpu, cpu, sizes, seed, out_dir),
            "dense_solve": lambda: phase_dense_solve(gpu, cpu, sizes, seed),
            "pcg_solve": lambda: phase_pcg_solve(gpu, cpu, sizes, seed),
            "serving": lambda: phase_serving(gpu, cpu, sizes, seed),
            "frontend": lambda: phase_frontend(gpu, cpu, sizes, seed),
        }
    failed = []
    for name, run in phases.items():
        t0, meshes = time.perf_counter(), mesh_backend_counts()
        try:
            run()
        except Exception:  # reported, and the script exits non-zero below
            traceback.print_exc()
            failed.append(name)
        print(f"[{name}] phase_wall_s={time.perf_counter() - t0:.1f} {mesh_line(meshes)} "
              f"{'FAILED' if name in failed else 'ok'}", flush=True)
    if failed:
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1
    print(result_line(jax.devices()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
