"""Locality-aware landmark sharding with explicit halo exchange.

The plain landmark-sharded solve (``dist.solve_pair_distributed``) leaves the
mesh-neighbor gather ``v_p[nbr]`` to XLA's SPMD partitioner. The adjacency is
unpartitioned, so the partitioner proves nothing about locality and lowers
every CG matvec to an all-gather of the FULL packed tangent [N, 6] (an HLO
audit counted 44 such all-gathers per solve).

This module makes the locality explicit instead (SURVEY.md §7.7: "ARAP
neighbor exchange via halo gather (neighbor lists partitioned by mesh
block)"):

1. **Spatial reorder** (host, once per solve): landmarks are permuted into
   Morton order of their KF1 pixel coordinates — the Delaunay mesh is built
   over exactly this 2-D layout (``Geometry.cc:317-368`` lifts a 2-D
   triangulation), so Z-order curve locality in pixel space IS mesh-graph
   locality. Contiguous blocks of the permuted order become the shards.
2. **Halo plan** (host, once per solve): the boundary set B = every landmark
   referenced by a neighbor slot owned by a *different* shard. For a Delaunay
   mesh under a space-filling-curve partition, |B| grows like the perimeter
   O(sqrt(N·n_shards)), not like N.
3. **shard_map PCG**: the damped-system solve runs inside ``jax.shard_map``
   over the points axis. Each matvec exchanges ONLY the [B, 6] boundary rows
   (owners scatter their rows into a zero buffer; ONE psum shares them fused
   with the 8-dim shared-block reduction), and the heavy [n_loc, K, 6, 6]
   neighbor contraction reads local values only — the halo-dependent part
   is a perimeter-sparse edge list applied as a gather + scatter-add AFTER
   the exchange, so the dominant HBM stream carries no collective
   dependency. The CG loop itself adds two more small psums (p.Ap; fused
   (r.z, r.r), whose r.r is carried into the stop test).

Communication per matvec drops from all-gather(6·N) to psum(6·|B| + 8), and
per CG iteration from six collectives to three.
Assembly (once per LM linearization) and the robustified-cost evaluation
(once per trial) still read neighbors through the partitioner's all-gather —
they are 1-2 per LM iteration vs ``cg_iters`` matvecs, so the matvec is the
term that matters.

The reference has no counterpart: it is a single-threaded C++ process
(SURVEY.md §2 "Parallelism"); this is the framework's scale-out capability.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..models import block_system as bs_
from ..models import deformable as D_
from ..ops import lm as lm_ops
from ..precision import MATMUL_PRECISION, TINY
from . import dist

def morton_perm(xy: np.ndarray) -> np.ndarray:
    """Permutation sorting 2-D points along a Z-order (Morton) curve."""
    xy = np.asarray(xy, np.float64)
    mn = xy.min(axis=0)
    span = np.maximum(xy.max(axis=0) - mn, 1e-12)
    g = ((xy - mn) / span * 65535.0).astype(np.uint64)

    def spread(v):
        v &= np.uint64(0xFFFF)
        v = (v | (v << np.uint64(8))) & np.uint64(0x00FF00FF)
        v = (v | (v << np.uint64(4))) & np.uint64(0x0F0F0F0F)
        v = (v | (v << np.uint64(2))) & np.uint64(0x33333333)
        v = (v | (v << np.uint64(1))) & np.uint64(0x55555555)
        return v

    code = spread(g[:, 0]) | (spread(g[:, 1]) << np.uint64(1))
    return np.argsort(code, kind="stable")


class HaloPlan(NamedTuple):
    """Host-computed shard layout (all arrays in the PERMUTED index space)."""

    perm: np.ndarray        # [N] new -> old landmark index
    inv_perm: np.ndarray    # [N] old -> new
    n_shards: int
    n_boundary: int         # true boundary count (arrays padded to >= 1)
    nbr_is_local: np.ndarray  # [N, K] neighbor lives on the same shard
    nbr_loc: np.ndarray       # [N, K] index into the owning shard's block
    nbr_halo: np.ndarray      # [N, K] index into the halo buffer (off-shard)
    halo_owner: np.ndarray    # [B] shard id owning each boundary row
    halo_local: np.ndarray    # [B] index within the owner's block
    # Perimeter-sparse off-shard edge lists, padded to a common per-shard
    # length E (the matvec's halo-dependent tail; everything else streams
    # independently of the exchange -- see _pcg_halo_local).
    off_rows: np.ndarray    # [S, E] local row within the shard
    off_slots: np.ndarray   # [S, E] neighbor slot k of that row
    off_halo: np.ndarray    # [S, E] index into the halo buffer
    off_w: np.ndarray       # [S, E] 1.0 real / 0.0 padding


def plan_halo(xy, nbr, nbr_mask, n_shards: int) -> HaloPlan:
    """Build the Morton partition + halo exchange plan on the host.

    ``xy`` must be the 2-D layout the Delaunay mesh was built over — the
    (x, y) projection of the KF1 world points (``mesh.build_mesh_context``
    triangulates exactly those; ``Geometry.cc:317-368`` lifts a 2-D
    triangulation the same way). Z-order locality in that plane IS mesh-graph
    locality; sorting by any other coordinates destroys the halo bound.
    """
    xy = np.asarray(xy)[:, :2]
    nbr = np.asarray(nbr)
    mask = np.asarray(nbr_mask, bool) & (nbr >= 0)
    n, _ = nbr.shape
    if n % n_shards != 0:
        raise ValueError(
            f"landmark count {n} not divisible by {n_shards} shards; use "
            f"pad_pair (solve_pair_halo does so automatically)"
        )
    perm = morton_perm(xy)
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)

    # Adjacency in the permuted space, rows reordered to the new layout.
    nbr_new = np.where(mask, inv[np.maximum(nbr, 0)], -1)[perm]
    mask = mask[perm]

    n_loc = n // n_shards
    owner_row = np.arange(n) // n_loc
    nbr_owner = np.where(mask, nbr_new // n_loc, owner_row[:, None])
    off = mask & (nbr_owner != owner_row[:, None])

    boundary = np.unique(nbr_new[off]) if off.any() else np.zeros(0, np.int64)
    n_boundary = int(boundary.size)
    b_pad = max(n_boundary, 1)
    halo_owner = np.full(b_pad, -1, np.int32)
    halo_local = np.zeros(b_pad, np.int32)
    halo_owner[:n_boundary] = (boundary // n_loc).astype(np.int32)
    halo_local[:n_boundary] = (boundary % n_loc).astype(np.int32)
    halo_of = np.zeros(n, np.int64)
    halo_of[boundary] = np.arange(n_boundary)

    nbr_is_local = ~off
    nbr_loc = np.where(mask & nbr_is_local, nbr_new % n_loc, 0).astype(np.int32)
    nbr_halo = np.where(off, halo_of[np.maximum(nbr_new, 0)], 0).astype(np.int32)

    # Per-shard off-edge lists (row, slot, halo index), padded to the max
    # per-shard count E. |off| is perimeter-sized under the Morton
    # partition, so E << n_loc * K.
    rows_g, ks_g = np.nonzero(off)
    shard_of = rows_g // n_loc
    counts = np.bincount(shard_of, minlength=n_shards)
    E = max(int(counts.max()) if counts.size else 0, 1)
    off_rows = np.zeros((n_shards, E), np.int32)
    off_slots = np.zeros((n_shards, E), np.int32)
    off_halo = np.zeros((n_shards, E), np.int32)
    off_w = np.zeros((n_shards, E), np.float32)
    for s in range(n_shards):
        sel = shard_of == s
        m = int(sel.sum())
        off_rows[s, :m] = (rows_g[sel] % n_loc).astype(np.int32)
        off_slots[s, :m] = ks_g[sel].astype(np.int32)
        off_halo[s, :m] = halo_of[nbr_new[rows_g[sel], ks_g[sel]]].astype(np.int32)
        off_w[s, :m] = 1.0
    return HaloPlan(
        perm=perm, inv_perm=inv, n_shards=n_shards, n_boundary=n_boundary,
        nbr_is_local=nbr_is_local, nbr_loc=nbr_loc, nbr_halo=nbr_halo,
        halo_owner=halo_owner, halo_local=halo_local,
        off_rows=off_rows, off_slots=off_slots, off_halo=off_halo, off_w=off_w,
    )


def pad_pair(data: D_.PairData, state: D_.PairState, multiple: int):
    """Pad the landmark axis of (data, state) to the next multiple.

    Real pairs have arbitrary N (``make_pair_data`` pads only to the mesh
    degree bucket, not to a shard multiple); the sharded paths need
    N % n_shards == 0. Padding rows are invalid (``valid=False``, no mesh
    edges) so every residual they touch is masked to zero; their POSITIONS
    are the valid centroid -- a finite point in front of both cameras -- so
    masked projections stay NaN-free (0 * NaN would poison reductions).
    Returns (data, state, n_original).
    """
    n = int(data.kp1.shape[0])
    pad = (-n) % multiple
    if pad == 0:
        return data, state, n
    vm = np.asarray(data.valid, bool)
    centroid = np.asarray(state.p1)[vm].mean(axis=0) if vm.any() else np.array([0.0, 0.0, 1.0])

    def rows(x, fill):
        x = np.asarray(x)
        if x.ndim == 0 or x.shape[0] != n:
            return jnp.asarray(x)
        block = np.broadcast_to(np.asarray(fill, x.dtype), (pad,) + x.shape[1:])
        return jnp.asarray(np.concatenate([x, block], axis=0))

    data = data._replace(
        kp1=rows(data.kp1, [0.0, 0.0]),
        kp2=rows(data.kp2, [0.0, 0.0]),
        inv_sigma2_1=rows(data.inv_sigma2_1, 1.0),
        inv_sigma2_2=rows(data.inv_sigma2_2, 1.0),
        depth1=rows(data.depth1, 1.0),
        depth2=rows(data.depth2, 1.0),
        valid=rows(data.valid, False),
        nbr=rows(data.nbr, -1),
        nbr_mask=rows(data.nbr_mask, False),
        wcot=rows(data.wcot, 0.0),
        Ri=rows(data.Ri, np.eye(3)),
    )
    state = state._replace(p1=rows(state.p1, centroid), p2=rows(state.p2, centroid))
    return data, state, n


def unpad_state(state: D_.PairState, n: int) -> D_.PairState:
    return state._replace(p1=state.p1[:n], p2=state.p2[:n])


def permute_data(data: D_.PairData, plan: HaloPlan) -> D_.PairData:
    """Reorder every per-point array into the plan's Morton layout and remap
    the adjacency values into the new index space."""
    n = plan.perm.shape[0]
    perm = jnp.asarray(plan.perm)

    def rows(x):
        x = jnp.asarray(x)
        return x[perm] if (x.ndim >= 1 and x.shape[0] == n) else x

    fields = {name: rows(val) for name, val in data._asdict().items()}
    nbr = np.asarray(data.nbr)
    mask = np.asarray(data.nbr_mask, bool) & (nbr >= 0)
    nbr_new = np.where(mask, plan.inv_perm[np.maximum(nbr, 0)], -1)[plan.perm]
    fields["nbr"] = jnp.asarray(nbr_new, jnp.int32)
    return D_.PairData(**fields)


def permute_state(state: D_.PairState, plan: HaloPlan) -> D_.PairState:
    perm = jnp.asarray(plan.perm)
    return state._replace(p1=state.p1[perm], p2=state.p2[perm])


def unpermute_state(state: D_.PairState, plan: HaloPlan) -> D_.PairState:
    inv = jnp.asarray(plan.inv_perm)
    return state._replace(p1=state.p1[inv], p2=state.p2[inv])


def _pcg_halo_local(
    D, Bt, C, Hg, g_p, g_g,
    nbr_is_local, nbr_loc, off_rows, off_slots, off_halo, off_w,
    halo_owner, halo_local, lam,
    *, axis: str, cg_iters: int, rtol: float,
):
    """Per-shard PCG body (runs inside shard_map). Solves
    (H + lam I) x = -g with block-Jacobi preconditioning.

    Collective schedule (an earlier version paid SIX psums per CG
    iteration, every one a full barrier in front of the heavy Bt stream):
    THREE psums per iteration, and the expensive work is
    independent of the first one so the scheduler can overlap it:

    1. matvec: ONE fused psum carries the [B, 6] boundary rows AND the
       8-dim C^T v reduction. The interior contraction (the [n_loc, K, 6, 6]
       Bt stream -- the HBM-dominant term) reads only local values
       (off-shard slots zeroed), so it has NO data dependency on the psum;
       the halo-dependent tail is a perimeter-sparse [E]-edge gather +
       scatter-add, a ~1% correction.
    2. alpha: one scalar psum for p.Ap.
    3. beta/stop: one length-2 psum for (r.z, r.r); r.r is carried into the
       while-loop cond, which therefore issues NO collective of its own.
    """
    my = jax.lax.axis_index(axis)
    eye6 = jnp.eye(6, dtype=D.dtype)
    Dinv = bs_.inv6_spd(D + lam * eye6[None])  # closed form; see inv6_spd
    Hginv = jnp.linalg.inv(Hg + lam * jnp.eye(8, dtype=Hg.dtype))
    own = (halo_owner == my)[:, None]
    nb = halo_local.shape[0]
    vj_mask = nbr_is_local[..., None]
    Bt_off = Bt[off_rows, off_slots] * off_w[:, None, None]  # [E, 6, 6]

    def matvec(v_p, v_g):
        # Fused exchange: boundary rows + the C^T v_p reduction in ONE psum.
        halo_in = jnp.where(own, v_p[halo_local], 0.0)
        cg_part = jnp.einsum("nag,na->g", C, v_p, precision=MATMUL_PRECISION)
        buf = jax.lax.psum(
            jnp.concatenate([halo_in.reshape(-1), cg_part]), axis
        )
        halo = buf[: nb * 6].reshape(nb, 6)
        # Interior stream: no halo dependency (off-shard slots read zero).
        vj = jnp.where(vj_mask, v_p[nbr_loc], 0.0)
        y_p = (
            jnp.einsum("nab,nb->na", D, v_p, precision=MATMUL_PRECISION)
            + jnp.einsum("nkab,nkb->na", Bt, vj, precision=MATMUL_PRECISION)
            + jnp.einsum("nag,g->na", C, v_g, precision=MATMUL_PRECISION)
            + lam * v_p
        )
        # Perimeter-sparse halo tail.
        contrib = jnp.einsum("eab,eb->ea", Bt_off, halo[off_halo], precision=MATMUL_PRECISION)
        y_p = y_p.at[off_rows].add(contrib)
        y_g = buf[nb * 6:] + jnp.matmul(Hg, v_g, precision=MATMUL_PRECISION) + lam * v_g
        return y_p, y_g

    def pre(r_p, r_g):
        return (
            jnp.einsum("nab,nb->na", Dinv, r_p, precision=MATMUL_PRECISION),
            jnp.matmul(Hginv, r_g, precision=MATMUL_PRECISION),
        )

    def dot(a_p, a_g, b_p, b_g):
        # v_g is replicated: add its contribution once (no psum).
        return jax.lax.psum(jnp.sum(a_p * b_p), axis) + jnp.dot(
            a_g, b_g, precision=MATMUL_PRECISION
        )

    def dots_rz_rr(r_p, r_g, z_p, z_g):
        # (r.z, r.r) in one psum.
        red = jax.lax.psum(
            jnp.stack([jnp.sum(r_p * z_p), jnp.sum(r_p * r_p)]), axis
        )
        return (
            red[0] + jnp.dot(r_g, z_g, precision=MATMUL_PRECISION),
            red[1] + jnp.dot(r_g, r_g, precision=MATMUL_PRECISION),
        )

    b_p, b_g = -g_p, -g_g
    x_p = jnp.zeros_like(b_p)
    x_g = jnp.zeros_like(b_g)
    r_p, r_g = b_p, b_g
    z_p, z_g = pre(r_p, r_g)
    rz0, rr0 = dots_rz_rr(r_p, r_g, z_p, z_g)
    tol2 = rtol * rtol * rr0  # x0 = 0, so r0 = b and rr0 = b.b

    def cond(carry):
        *_, rr, k = carry
        return jnp.logical_and(k < cg_iters, rr > tol2)

    def body(carry):
        x_p, x_g, r_p, r_g, p_p, p_g, rz, _rr, k = carry
        Ap_p, Ap_g = matvec(p_p, p_g)
        alpha = rz / (dot(p_p, p_g, Ap_p, Ap_g) + TINY)
        x_p, x_g = x_p + alpha * p_p, x_g + alpha * p_g
        r_p, r_g = r_p - alpha * Ap_p, r_g - alpha * Ap_g
        z_p, z_g = pre(r_p, r_g)
        rz_new, rr_new = dots_rz_rr(r_p, r_g, z_p, z_g)
        beta = rz_new / (rz + TINY)
        p_p, p_g = z_p + beta * p_p, z_g + beta * p_g
        return (x_p, x_g, r_p, r_g, p_p, p_g, rz_new, rr_new, k + 1)

    x_p, x_g, *_ = jax.lax.while_loop(
        cond, body, (x_p, x_g, r_p, r_g, z_p, z_g, rz0, rr0, jnp.int32(0))
    )
    return x_p, x_g


def make_halo_step(mesh: Mesh, cam_kind, data, hyper, spec, plan_arrays,
                   cg_iters: int, cg_rtol: float):
    """LM step factory (``ops.lm.lm_optimize_general`` contract) whose damped
    solves run the halo-exchange PCG inside shard_map."""
    axis = dist.POINTS_AXIS
    (nbr_is_local, nbr_loc, off_rows, off_slots, off_halo, off_w,
     halo_owner, halo_local) = plan_arrays
    row = P(axis)
    rep = P()
    pcg = functools.partial(
        _pcg_halo_local, axis=axis, cg_iters=cg_iters, rtol=cg_rtol
    )
    sharded_pcg = jax.shard_map(
        pcg,
        mesh=mesh,
        in_specs=(row, row, row, rep, row, rep,      # D Bt C Hg g_p g_g
                  row, row,                          # nbr_is_local nbr_loc
                  row, row, row, row,                # off_{rows,slots,halo,w}
                  rep, rep, rep),                    # halo_owner halo_local lam
        out_specs=(row, rep),
        check_vma=False,
    )

    def make_step(state):
        sys = bs_.build_block_system(cam_kind, data, hyper, state, spec)
        g = bs_.flat_gradient(sys)
        diag_max = jnp.max(bs_.diag_of(sys))

        def solve(lam):
            x_p, x_g = sharded_pcg(
                sys.D, sys.Bt, sys.C, sys.Hg, sys.g_p, sys.g_g,
                nbr_is_local, nbr_loc, off_rows, off_slots, off_halo, off_w,
                halo_owner, halo_local,
                jnp.asarray(lam, sys.D.dtype),
            )
            return bs_._join(x_p, x_g)

        return solve, g, diag_max

    return make_step


def build_halo_solver(mesh: Mesh, cam_kind: str, n_iterations: int,
                      cg_iters: int = 50, max_trials: int = 6,
                      tau: float = 1e-5, spec: D_.ModelSpec = D_.ModelSpec()):
    """Compile-once solver factory. The returned callable takes
    (data, hyper, state0, plan_arrays) — all in the PERMUTED layout, already
    placed on the mesh — and runs the shared LM damping loop with the
    halo-PCG backend."""

    @jax.jit
    def run(data, hyper, state0, plan_arrays):
        make_step = make_halo_step(
            mesh, cam_kind, data, hyper, spec, plan_arrays, cg_iters, D_.CG_RTOL
        )
        return lm_ops.lm_optimize_general(
            make_step,
            robust_cost=lambda s: D_.robust_cost(cam_kind, data, hyper, s, spec),
            apply_delta=D_.apply_delta,
            state0=state0,
            n_iterations=n_iterations,
            tau=tau,
            max_trials=max_trials,
        )

    return run


def place_plan(mesh: Mesh, plan: HaloPlan):
    """Device-place the plan's index arrays: [N, K] rows on the points axis,
    halo owner/local replicated."""
    from jax.sharding import NamedSharding

    row = NamedSharding(mesh, P(dist.POINTS_AXIS, None))
    rep = NamedSharding(mesh, P())
    # Off-edge lists are [S, E]: flattened to [S*E] they shard one block of
    # E entries per device, exactly the shard's own edge list.
    flat = lambda a: jnp.asarray(np.asarray(a).reshape(-1))
    srow = NamedSharding(mesh, P(dist.POINTS_AXIS))
    return (
        jax.device_put(jnp.asarray(plan.nbr_is_local), row),
        jax.device_put(jnp.asarray(plan.nbr_loc), row),
        jax.device_put(flat(plan.off_rows), srow),
        jax.device_put(flat(plan.off_slots), srow),
        jax.device_put(flat(plan.off_halo), srow),
        jax.device_put(flat(plan.off_w), srow),
        jax.device_put(jnp.asarray(plan.halo_owner), rep),
        jax.device_put(jnp.asarray(plan.halo_local), rep),
    )


def solve_pair_halo(
    mesh: Mesh,
    cam_kind: str,
    data: D_.PairData,
    hyper: D_.Hyper,
    state0: D_.PairState,
    n_iterations: int,
    cg_iters: int = 50,
    max_trials: int = 6,
    tau: float = 1e-5,
    spec: D_.ModelSpec = D_.ModelSpec(),
) -> lm_ops.LMResult:
    """One-call convenience wrapper: plan, permute, place, solve, unpermute.

    Semantically identical to ``dist.solve_pair_distributed`` (same LM
    policy, same block system, same PCG tolerance) up to the CG iteration
    count actually taken; the communication pattern is the halo exchange
    described in the module docstring. Arbitrary N is padded to the shard
    multiple (``pad_pair``) and stripped from the returned state.
    """
    data, state0, n_orig = pad_pair(data, state0, int(mesh.devices.size))
    plan = plan_halo(
        np.asarray(state0.p1), np.asarray(data.nbr), np.asarray(data.nbr_mask),
        mesh.devices.size,
    )
    data_p = permute_data(data, plan)
    state_p = permute_state(state0, plan)
    data_p, state_p = dist.shard_pair(mesh, data_p, state_p)
    plan_arrays = place_plan(mesh, plan)
    run = build_halo_solver(
        mesh, cam_kind, n_iterations, cg_iters=cg_iters,
        max_trials=max_trials, tau=tau, spec=spec,
    )
    result = run(data_p, hyper, state_p, plan_arrays)
    return result._replace(state=unpad_state(unpermute_state(result.state, plan), n_orig))


def place_plan_global(mesh: Mesh, plan: HaloPlan):
    """Multi-process variant of ``place_plan``: every process holds the same
    host plan; shards are assembled per process via
    ``multihost.make_global_array``."""
    from . import multihost

    row = P(dist.POINTS_AXIS, None)
    rep = P()
    srow = P(dist.POINTS_AXIS)
    return (
        multihost.make_global_array(np.asarray(plan.nbr_is_local), mesh, row),
        multihost.make_global_array(np.asarray(plan.nbr_loc), mesh, row),
        multihost.make_global_array(np.asarray(plan.off_rows).reshape(-1), mesh, srow),
        multihost.make_global_array(np.asarray(plan.off_slots).reshape(-1), mesh, srow),
        multihost.make_global_array(np.asarray(plan.off_halo).reshape(-1), mesh, srow),
        multihost.make_global_array(np.asarray(plan.off_w).reshape(-1), mesh, srow),
        multihost.make_global_array(np.asarray(plan.halo_owner), mesh, rep),
        multihost.make_global_array(np.asarray(plan.halo_local), mesh, rep),
    )


def solve_pair_halo_global(
    mesh: Mesh,
    cam_kind: str,
    data: D_.PairData,
    hyper: D_.Hyper,
    state0: D_.PairState,
    n_iterations: int,
    cg_iters: int = 50,
    max_trials: int = 6,
    tau: float = 1e-5,
    spec: D_.ModelSpec = D_.ModelSpec(),
):
    """Cross-process ``solve_pair_halo``: the points mesh spans every device
    of every process (``multihost.points_submesh``), so the per-matvec
    boundary-row psum crosses the network between hosts (SURVEY.md §7.7's
    host-spanning landmark sharding).

    Every process must call with the SAME host-side (data, state0) (the
    plan is deterministic, so all processes compute identical layouts).
    Returns (LMResult with the state still in the PERMUTED+PADDED global
    layout, plan, n_original): eagerly unpermuting a multi-process global
    array would require non-addressable gathers; callers that need the
    refined points fetch them inside their own jit (costs are replicated
    scalars and can be read directly).
    """
    from . import multihost

    data, state0, n_orig = pad_pair(data, state0, int(mesh.devices.size))
    plan = plan_halo(
        np.asarray(state0.p1), np.asarray(data.nbr), np.asarray(data.nbr_mask),
        mesh.devices.size,
    )
    data_p = permute_data(data, plan)
    state_p = permute_state(state0, plan)
    data_p, state_p = multihost.shard_pair_global(mesh, data_p, state_p)
    plan_arrays = place_plan_global(mesh, plan)
    run = build_halo_solver(
        mesh, cam_kind, n_iterations, cg_iters=cg_iters,
        max_trials=max_trials, tau=tau, spec=spec,
    )
    return run(data_p, hyper, state_p, plan_arrays), plan, n_orig
