"""Explicit block-sparse Gauss-Newton system for the deformable pair solve.

The large-N / distributed LM path originally applied H = J^T J matrix-free
(jvp+vjp through ``deformable.residual_vector``): the AD transpose turns
every ARAP neighbor gather into a scatter-add, and each CG iteration pays
the whole residual graph three times (primal + jvp + vjp).

This module assembles the SAME operator once per LM linearization into its
natural block-sparse (ELLPACK) form instead:

- ``D``  [N, 6, 6]   per-point diagonal blocks over (p1_i, p2_i);
- ``Bt`` [N, K, 6, 6] neighbor coupling blocks aligned with ``data.nbr``;
- ``C``  [N, 6, 8]   point-to-global coupling (s1, s2, xi[6]);
- ``Hg`` [8, 8]      global block; plus the gradient (g_p, g_g).

after which one H v is ONE [N, K] gather of the packed 6-vector plus three
batched 6x6 einsums -- no scatters, no AD, ~6 kernels. The matvec FLOPs
are 72 N K + 72 N + 32 N per product.

Why no scatters even at assembly: every mesh-edge energy in the model family
is SYMMETRIC under (i, j) swap (ARAP: the first/second half-terms exchange,
``g2oTypes.h:300-349``; Elastic/Ogden depend on |d1|, |d2| only; the global
term is symmetric by inspection), so the reverse directed edge (j -> i)
carries the identical residual and the transposed Jacobian pair. All of
H therefore assembles from each point's OUTGOING slots with a factor 2:

    D_i      = 2 sum_k Ji_(i,k) Ji_(i,k)^T      (+ reprojection/depth blocks)
    Bt_(i,k) = 2 Ji_(i,k) Jj_(i,k)^T
    C_i      = 2 sum_k Ji_(i,k) Jx_(i,k)^T      (+ depth-scale couplings)
    Hg       = sum_slots Jx Jx^T                (slots already count both
                                                 directions)

The per-slot Jacobians (Ji, Jj, Jx) come from one vmapped forward-mode AD of
the scalar edge energy -- the gathers of (p1_j, p2_j, R_j) happen once, before
differentiation, so no gather is ever transposed.

The dense ``deformable.build_system`` H equals this operator by construction;
``tests/test_block_system.py`` asserts H v parity for every model spec.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from ..ops import lie
from ..precision import FP, MATMUL_PRECISION, TINY
from . import deformable as D_


class BlockSystem(NamedTuple):
    D: jnp.ndarray    # [N, 6, 6]
    Bt: jnp.ndarray   # [N, K, 6, 6]
    C: jnp.ndarray    # [N, 6, 8]
    Hg: jnp.ndarray   # [8, 8]
    g_p: jnp.ndarray  # [N, 6]
    g_g: jnp.ndarray  # [8]


def _freeze_p1_mask(dtype):
    """one_set freezes the FIRST point set (see deformable.ModelSpec): the
    packed per-point 6-block is (p1_i, p2_i), so zeroing the first three
    coordinates of every Jacobian block removes p1 from the system while
    the residuals (and hence the cost) still see it."""
    return jnp.array([0.0, 0.0, 0.0, 1.0, 1.0, 1.0], dtype=dtype)


def build_block_system(
    cam_kind: str,
    data: D_.PairData,
    hyper: D_.Hyper,
    state: D_.PairState,
    spec: D_.ModelSpec = D_.ModelSpec(),
) -> BlockSystem:
    """Assemble (H, g) at ``state`` in block-sparse form.

    Same linearization as ``deformable.build_system`` (robust weights frozen
    at ``state``, g2o-parity Huber reweighting): H = J^T J, g = J^T r of the
    weighted residual vector.
    """
    state = D_._canon_state(spec, state)
    n, K = data.nbr.shape
    dtype = state.p1.dtype
    vm = data.valid.astype(dtype)

    from ..ops import camera as cam_ops

    D = jnp.zeros((n, 6, 6), dtype)
    C = jnp.zeros((n, 6, 8), dtype)
    Hg = jnp.zeros((8, 8), dtype)
    g_p = jnp.zeros((n, 6), dtype)
    g_g = jnp.zeros((8,), dtype)

    def add_pblock(D, A, r, slot):
        """Accumulate a per-point residual family: A [N, rdim, 3] acting on
        the p1 (slot 0) or p2 (slot 1) 3-block."""
        s = 0 if slot == 0 else 3
        blk = jnp.einsum("nra,nrb->nab", A, A, precision=MATMUL_PRECISION)
        D = D.at[:, s : s + 3, s : s + 3].add(blk)
        return D, s

    # --- reprojection edges (Huber IRLS weights frozen at state) ---
    # Closed-form Jacobian: de/dp = -(dproj/dpc) R via the analytic
    # camera Jacobian -- like the depth family below, the vmapped jacfwd
    # here blocked fusion across the assembly graph.
    for slot, (p, R, t, kp, inv_s2) in enumerate((
        (state.p1, data.R1w, data.t1w, data.kp1, data.inv_sigma2_1),
        (state.p2, data.R2w, data.t2w, data.kp2, data.inv_sigma2_2),
    )):
        pc = lie.apply(R, t, p)
        e = kp - cam_ops.project(cam_kind, data.cam_params, pc)
        chi2 = jnp.sum(e * e, axis=-1) * inv_s2 * hyper.rep_w
        _, drho = D_._huber_rho(chi2)
        w = jnp.sqrt(drho * inv_s2 * hyper.rep_w) * vm

        Jpi = cam_ops.project_jac(cam_kind, data.cam_params, pc)  # [N, 2, 3]
        A = -w[:, None, None] * jnp.einsum("nab,bc->nac", Jpi, R, precision=MATMUL_PRECISION)  # [N, 2, 3]
        r = w[:, None] * e  # [N, 2]
        D, s = add_pblock(D, A, r, slot)
        g_p = g_p.at[:, s : s + 3].add(jnp.einsum("nra,nr->na", A, r, precision=MATMUL_PRECISION))

    # --- depth edges (couple the point 3-block with its scale dim) ---
    # CLOSED-FORM residual/Jacobian instead of a 4-wide vmapped jacfwd over
    # (p, s): every depth mode's e depends on p only through
    # z = (R p + t)[2], so de/dp = (de/dz) * R[2, :] and de/ds is scalar.
    if spec.depth != "none":
        inv_sigma_d = 1.0 / hyper.depth_sigma
        for slot, (p, sc, R, t, d) in enumerate((
            (state.p1, state.s1, data.R1w, data.t1w, data.depth1),
            (state.p2, state.s2, data.R2w, data.t2w, data.depth2),
        )):
            w = vm * inv_sigma_d  # [N]
            z = (jnp.matmul(p, R.T, precision=MATMUL_PRECISION) + t)[:, 2]  # [N]
            if spec.depth == "fixed":
                s0 = jax.lax.stop_gradient(sc)
                e = d - z * s0
                de_dz = jnp.full_like(e, -s0)
                de_ds = jnp.zeros_like(e)
            elif spec.depth == "fixed_squared":
                s0 = jax.lax.stop_gradient(sc)
                u = d - z * s0
                e = u * u
                de_dz = -2.0 * u * s0
                de_ds = jnp.zeros_like(e)
            elif spec.depth == "scaled_squared":
                u = d / sc - z
                pen = jnp.where(sc <= 0.0, 500.0, 1.0)
                e = pen * u * u
                de_dz = pen * (-2.0 * u)
                de_ds = pen * (-2.0 * u * d / (sc * sc))
            else:  # "scaled": linear residual
                pen = jnp.where(sc <= 0.0, jnp.sqrt(500.0), 1.0)
                e = pen * (d / sc - z)
                de_dz = jnp.full_like(e, -pen)
                de_ds = pen * (-d / (sc * sc))
            r = w * e  # [N]
            ap = (w * de_dz)[:, None] * R[2, :][None, :]  # [N, 3]
            a_s = w * de_ds  # [N]
            s = 0 if slot == 0 else 3
            D = D.at[:, s : s + 3, s : s + 3].add(jnp.einsum("na,nb->nab", ap, ap, precision=MATMUL_PRECISION))
            C = C.at[:, s : s + 3, slot].add(ap * a_s[:, None])
            Hg = Hg.at[slot, slot].add(jnp.sum(a_s * a_s))
            g_p = g_p.at[:, s : s + 3].add(ap * r[:, None])
            g_g = g_g.at[slot].add(jnp.sum(a_s * r))

    # --- mesh edges: per-slot scalar energy, symmetric in (i, j) ---
    j_safe = jnp.maximum(data.nbr, 0)
    p1j = state.p1[j_safe]  # [N, K, 3] -- the one gather family, pre-AD
    p2j = state.p2[j_safe]
    Rj = data.Ri[j_safe]  # [N, K, 3, 3]
    w_edge = (
        (data.nbr_mask & data.valid[:, None] & data.valid[j_safe]).astype(dtype)
        * jnp.sqrt(hyper.arap_w)
        * data.ntri
    )  # [N, K]
    Rg0, tg0 = state.Rg, state.tg

    def slot_fn(x, Ri, Rj_, wcot, we):
        p1i, p2i, p1j_, p2j_, xi = x[0:3], x[3:6], x[6:9], x[9:12], x[12:18]
        dR, dt = lie.se3_exp(xi)
        Rg, tg = lie.compose(dR, dt, Rg0, tg0)
        energy = D_._mesh_edge_energy_scalar(
            spec, p1i, p2i, p1j_, p2j_, Ri, Rj_, wcot, data.area, Rg, tg,
            hyper.alpha, hyper.beta,
        )
        return we * energy

    x_slots = jnp.concatenate(
        [
            jnp.broadcast_to(state.p1[:, None, :], (n, K, 3)),
            jnp.broadcast_to(state.p2[:, None, :], (n, K, 3)),
            p1j,
            p2j,
            jnp.zeros((n, K, 6), dtype),
        ],
        axis=-1,
    )  # [N, K, 18]
    Ri_b = jnp.broadcast_to(data.Ri[:, None], (n, K, 3, 3))
    if spec.energy == "ARAP":
        # ANALYTIC slot gradient for the ARAP family. The edge energy's
        # inner residuals are LINEAR in the points --
        #   f = (d2 - Ri d1)/area,  s = (-d2 + Rj d1)/area,
        #   g = Rg(p2i + p2j) - 2 tg - p1i - p1j          (use_global)
        # with d1 = p1i - p1j, d2 = p2i - p2j -- so the 18-gradient of
        # e = w(f.f + s.s) + g.g is closed-form. This replaces an 18-wide
        # vmapped jacfwd over every mesh slot with a handful of [N, K, 3]
        # einsums. The xi block uses the
        # se3_exp first-order terms at 0 (rotation-first tangent,
        # d(exp(w) x)/dw = -hat(x), d t/d upsilon = I) composed LEFT of
        # (Rg0, tg0): d g/d omega = -hat(a_i + a_j), d g/d upsilon = -2 I,
        # where a = Rg0 p2 - tg0. jacfwd parity is pinned per family in
        # tests/test_block_system.py.
        p1i_b = jnp.broadcast_to(state.p1[:, None, :], (n, K, 3))
        p2i_b = jnp.broadcast_to(state.p2[:, None, :], (n, K, 3))
        d1 = p1i_b - p1j
        d2 = p2i_b - p2j
        inv_area = 1.0 / data.area
        f = (d2 - jnp.einsum("nkab,nkb->nka", Ri_b, d1, precision=MATMUL_PRECISION)) * inv_area
        s_ = (-d2 + jnp.einsum("nkab,nkb->nka", Rj, d1, precision=MATMUL_PRECISION)) * inv_area
        w2a = (2.0 * data.wcot.astype(dtype) * inv_area)[..., None]  # [N,K,1]
        rtf = jnp.einsum("nkba,nkb->nka", Ri_b, f, precision=MATMUL_PRECISION)  # Ri^T f
        rts = jnp.einsum("nkba,nkb->nka", Rj, s_, precision=MATMUL_PRECISION)  # Rj^T s
        fs = w2a * (f - s_)
        if spec.use_global:
            ai = jnp.matmul(p2i_b, Rg0.T, precision=MATMUL_PRECISION) - tg0
            aj = jnp.matmul(p2j, Rg0.T, precision=MATMUL_PRECISION) - tg0
            g = ai + aj - p1i_b - p1j
            rg_tg = 2.0 * jnp.matmul(g, Rg0, precision=MATMUL_PRECISION)  # 2 Rg0^T g
            g2 = 2.0 * g
            d_om = 2.0 * jnp.cross(ai + aj, g)
            d_up = -4.0 * g
        else:
            zero3 = jnp.zeros_like(f)
            rg_tg = zero3
            g2 = zero3
            d_om = zero3
            d_up = zero3
        # Slot energies from the same residuals (no slot_fn evaluation --
        # skips a per-slot se3_exp): e = wcot (f.f + s.s) + g.g.
        e_slot = data.wcot.astype(dtype) * (
            jnp.sum(f * f, axis=-1) + jnp.sum(s_ * s_, axis=-1))
        if spec.use_global:
            e_slot = e_slot + jnp.sum(g * g, axis=-1)
        r_slot = w_edge * e_slot  # [N, K]
        Jfull = jnp.concatenate(
            [
                w2a * (-rtf + rts) - g2,  # d/d p1i
                fs + rg_tg,               # d/d p2i
                w2a * (rtf - rts) - g2,   # d/d p1j
                -fs + rg_tg,              # d/d p2j
                d_om,                     # d/d omega
                d_up,                     # d/d upsilon
            ],
            axis=-1,
        ) * w_edge[..., None]  # [N, K, 18]
    else:
        Jfull = jax.vmap(jax.vmap(jax.jacfwd(slot_fn)))(
            x_slots, Ri_b, Rj, data.wcot.astype(dtype), w_edge
        )  # [N, K, 18]
        r_slot = jax.vmap(jax.vmap(slot_fn))(
            x_slots, Ri_b, Rj, data.wcot.astype(dtype), w_edge
        )  # [N, K]

    Ji = Jfull[..., 0:6]
    Jj = Jfull[..., 6:12]
    Jx = Jfull[..., 12:18]
    D = D + 2.0 * jnp.einsum("nka,nkb->nab", Ji, Ji, precision=MATMUL_PRECISION)
    Bt = 2.0 * jnp.einsum("nka,nkb->nkab", Ji, Jj, precision=MATMUL_PRECISION)
    C = C.at[:, :, 2:8].add(2.0 * jnp.einsum("nka,nkg->nag", Ji, Jx, precision=MATMUL_PRECISION))
    Hg = Hg.at[2:8, 2:8].add(jnp.einsum("nka,nkb->ab", Jx, Jx, precision=MATMUL_PRECISION))
    g_p = g_p + 2.0 * jnp.einsum("nka,nk->na", Ji, r_slot, precision=MATMUL_PRECISION)
    g_g = g_g.at[2:8].add(jnp.einsum("nka,nk->a", Jx, r_slot, precision=MATMUL_PRECISION))

    # --- depth-scale prior edges (see PairData; zero info => inert) ---
    if spec.depth in ("scaled", "scaled_squared"):
        for col, (sc, prior, info) in enumerate((
            (state.s1, data.s1_prior, data.s1_info),
            (state.s2, data.s2_prior, data.s2_info),
        )):
            Hg = Hg.at[col, col].add(info)
            g_g = g_g.at[col].add(info * (sc - prior))

    if spec.one_set:
        # Frozen first set: zero p1's rows/cols of H and its gradient
        # entries (damping keeps the diagonal nonsingular; CG/PCG then
        # leaves the p1 subspace identically at zero).
        m = _freeze_p1_mask(dtype)
        D = D * m[None, :, None] * m[None, None, :]
        Bt = Bt * m[None, None, :, None] * m[None, None, None, :]
        C = C * m[None, :, None]
        g_p = g_p * m[None, :]

    return BlockSystem(D=D, Bt=Bt, C=C, Hg=Hg, g_p=g_p, g_g=g_g)


def _split(v: jnp.ndarray, n: int):
    """Flat tangent [p1(3N), p2(3N), s1, s2, xi(6)] -> packed ([N, 6], [8])."""
    v_p = jnp.concatenate([v[: 3 * n].reshape(n, 3), v[3 * n : 6 * n].reshape(n, 3)], axis=-1)
    return v_p, v[6 * n :]


def _join(y_p: jnp.ndarray, y_g: jnp.ndarray) -> jnp.ndarray:
    return jnp.concatenate([y_p[:, 0:3].reshape(-1), y_p[:, 3:6].reshape(-1), y_g])


def block_matvec(sys: BlockSystem, nbr: jnp.ndarray, v: jnp.ndarray, lam) -> jnp.ndarray:
    """(H + lam I) v with v in the solver's flat [6N + 8] tangent layout."""
    n = sys.D.shape[0]
    v_p, v_g = _split(v, n)
    vj = v_p[jnp.maximum(nbr, 0)]  # [N, K, 6] -- the only gather
    y_p = (
        jnp.einsum("nab,nb->na", sys.D, v_p, precision=MATMUL_PRECISION)
        + jnp.einsum("nkab,nkb->na", sys.Bt, vj, precision=MATMUL_PRECISION)
        + jnp.einsum("nag,g->na", sys.C, v_g, precision=MATMUL_PRECISION)
    )
    y_g = jnp.einsum("nag,na->g", sys.C, v_p, precision=MATMUL_PRECISION) + jnp.matmul(
        sys.Hg, v_g, precision=MATMUL_PRECISION
    )
    return _join(y_p, y_g) + lam * v


def flat_gradient(sys: BlockSystem) -> jnp.ndarray:
    return _join(sys.g_p, sys.g_g)


def diag_of(sys: BlockSystem) -> jnp.ndarray:
    dp = jnp.diagonal(sys.D, axis1=-2, axis2=-1)  # [N, 6]
    return _join(dp, jnp.diagonal(sys.Hg))


def inv6_spd(M):
    """Batched 6x6 SPD inverse: equilibrate, unrolled Cholesky, L^-1, Li^T Li.

    ``jnp.linalg.inv`` on a [N, 6, 6] batch lowers to an LU pivot chain,
    paid on every damped trial for the Jacobi preconditioner. This unrolled
    form is ~200 fused elementwise ops over [N] lanes (no pivot chain, no
    batched-LAPACK loop).

    Numerical note: a first attempt used a 3x3-blocked Schur adjugate
    closed form -- catastrophically wrong on the real assembled blocks
    (||I - X A|| up to 4e3 at block condition ~1e5 in f32; the Schur
    complement forms small differences of large products). Cholesky of the
    equilibrated SPD block needs no pivoting and keeps the residual at
    ~cond * eps (measured <=1e-2 on the same blocks) -- more than enough
    for a preconditioner and indistinguishable from LU in CG iteration
    counts.
    """
    s = jax.lax.rsqrt(jnp.maximum(jnp.diagonal(M, axis1=-2, axis2=-1), TINY))
    Ms = M * s[..., :, None] * s[..., None, :]

    # Unrolled lower Cholesky of the equilibrated block.
    L = [[None] * 6 for _ in range(6)]
    for i in range(6):
        for j in range(i + 1):
            acc = Ms[..., i, j]
            for k in range(j):
                acc = acc - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = jnp.sqrt(jnp.maximum(acc, TINY))
            else:
                L[i][j] = acc / L[j][j]

    # Li = L^-1 by forward substitution (also lower triangular).
    Li = [[None] * 6 for _ in range(6)]
    for i in range(6):
        Li[i][i] = 1.0 / L[i][i]
        for j in range(i - 1, -1, -1):
            acc = L[i][j] * Li[j][j]
            for k in range(j + 1, i):
                acc = acc + L[i][k] * Li[k][j]
            Li[i][j] = -acc * Li[i][i]

    # Minv = Li^T Li.
    rows = []
    for a in range(6):
        cols = []
        for b in range(6):
            acc = None
            for k in range(max(a, b), 6):
                term = Li[k][a] * Li[k][b]
                acc = term if acc is None else acc + term
            cols.append(acc)
        rows.append(jnp.stack(cols, axis=-1))
    inv = jnp.stack(rows, axis=-2)
    return inv * s[..., :, None] * s[..., None, :]


def block_jacobi_apply(sys: BlockSystem, lam) -> Callable:
    """Block-Jacobi preconditioner: invert (D_i + lam I) per point and
    (Hg + lam I) once, apply as batched 6x6 / 8x8 products.

    A principal-block restriction of the SPD damped H is SPD, so PCG theory
    holds; the 6x6 blocks capture the dominant reprojection+depth+ARAP
    curvature of each point pair, which plain (scalar) Jacobi ignores."""
    n = sys.D.shape[0]
    eye6 = jnp.eye(6, dtype=sys.D.dtype)
    Dinv = inv6_spd(sys.D + lam * eye6[None])  # [N, 6, 6]
    Hginv = jnp.linalg.inv(sys.Hg + lam * jnp.eye(8, dtype=sys.Hg.dtype))

    def apply(r):
        r_p, r_g = _split(r, n)
        return _join(
            jnp.einsum("nab,nb->na", Dinv, r_p, precision=MATMUL_PRECISION),
            jnp.matmul(Hginv, r_g, precision=MATMUL_PRECISION),
        )

    return apply


def pcg_flex(matvec: Callable, b, precond: Callable, iters: int, rtol: float = 1e-3):
    """Preconditioned CG with early exit on ||r|| <= rtol * ||b||.

    Every iteration pays a fixed multi-kernel overhead, so stopping at the
    requested tolerance -- rather than burning a fixed trip count -- saves
    whole iterations; ``iters`` stays the hard cap.
    """
    x0 = jnp.zeros_like(b)
    r0 = b
    z0 = precond(r0)
    bb = jnp.dot(b, b, precision=MATMUL_PRECISION)
    tol2 = rtol * rtol * bb

    def cond(carry):
        _, r, _, _, k = carry
        return jnp.logical_and(k < iters, jnp.dot(r, r, precision=MATMUL_PRECISION) > tol2)

    def body(carry):
        x, r, z, p, k = carry
        Ap = matvec(p)
        rz = jnp.dot(r, z, precision=MATMUL_PRECISION)
        alpha = rz / (jnp.dot(p, Ap, precision=MATMUL_PRECISION) + TINY)
        x1 = x + alpha * p
        r1 = r - alpha * Ap
        z1 = precond(r1)
        beta = jnp.dot(r1, z1, precision=MATMUL_PRECISION) / (rz + TINY)
        p1 = z1 + beta * p
        return (x1, r1, z1, p1, k + 1)

    x, *_ = jax.lax.while_loop(cond, body, (x0, r0, z0, p0 := z0, jnp.int32(0)))
    return x


def make_block_step(
    cam_kind: str,
    data: D_.PairData,
    hyper: D_.Hyper,
    spec: D_.ModelSpec,
    cg_iters: int,
    cg_rtol: float = 1e-3,
) -> Callable:
    """LM step factory for ``ops.lm.lm_optimize_general``: assemble the block
    system once per linearization, solve each damped trial with
    block-Jacobi PCG.

    The operator stays f32: streaming Bt in bfloat16 halves the matvec's
    bytes, but the perturbed operator costs more CG iterations (and
    occasional extra LM trials)."""

    def make_step(state):
        sys = build_block_system(cam_kind, data, hyper, state, spec)
        g = flat_gradient(sys)
        diag_max = jnp.max(diag_of(sys))

        def solve(lam):
            mv = lambda v: block_matvec(sys, data.nbr, v, lam)
            return pcg_flex(mv, -g, block_jacobi_apply(sys, lam), cg_iters, cg_rtol)

        return solve, g, diag_max

    return make_step
