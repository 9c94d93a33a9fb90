"""Rigid-hypothesis refinement: model selection against the general solve.

The reference's committed sweeps show its refinement taking exactly-rigid
scenes from ~2.5 mm initial error to 0.84-1.7 mm final (``Data/Excels/
Synthetic/Depth uncertainty/Errors 3.csv`` rigid rows) because its two-sided
log^2 pixel-sigma objective (``nloptOptimization.cc:29-31``) keeps optimizing
below the observation-noise floor and the high-ARAP solutions it lands on
average the depth noise away. The framework's one-sided Morozov objective
(``models/outer.py``) deliberately stops at the floor -- correct on deforming
scenes (where the reference's objective collapses the map, e.g. 2.9 -> 44 mm
on committed non-rigid cells) but it forfeits the denoising on rigid ones.

This module closes that gap the principled way: an explicit RIGID-SCENE
HYPOTHESIS, solved to optimality and accepted by the discrepancy principle.

    state   (p1[N,3], s1, s2, Rr[3,3], tr[3])   with p2 := Rr p1 + tr
    cost    sum_i Huber(||kp1_i - proj(T1w p1_i)||^2_Omega)
          + sum_i Huber(||kp2_i - proj(T2w (Rr p1_i + tr))||^2_Omega)
          + depth terms of the active model family on both sets

i.e. the SAME measurement model as the general solve (``models/deformable``)
with the deformation field constrained to a single SE3 -- the "infinite ARAP
weight" end of the regularization ladder, parametrized exactly instead of
approximated by a large weight. On a truly rigid scene this is the maximum-
likelihood estimator: both views' reprojection cones intersect at the true
points (the scene motion is re-estimated jointly, so the pair behaves like a
calibrated two-view triangulation with 2N depth measurements pinning the
scale gauge), and the remaining error is O(sigma_d / sqrt(N)) -- far below
the per-point depth noise that bounds any pointwise estimator.

Acceptance (Morozov / discrepancy-principle model selection, see
``outer.deformation_optimization``): the rigid candidate replaces the
general solution only when its residual pixel sigma does not exceed the
noise floor where the general one stayed under it, AND its physical depth
discrepancy stays at the noise level. On a deforming scene the rigid fit
must absorb millimeters of true deformation into pixels of reprojection
error (f * delta / z ~ several px at the benchmark geometry), so it is
vetoed by the first test; depth-directed deformation invisible to the
cameras is caught by the second.

No counterpart exists in the reference (its rigid-cell denoising is an
emergent side effect of an objective that destroys deforming scenes); cited
anchors are the behavior being matched, not code being ported.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import lie
from ..ops import lm as lm_ops
from ..ops import camera as cam_ops
from ..precision import MATMUL_PRECISION, TINY
from . import deformable


class RigidState(NamedTuple):
    p1: jnp.ndarray  # [N, 3]
    s1: jnp.ndarray  # scalar depth scale KF1
    s2: jnp.ndarray
    Rr: jnp.ndarray  # [3, 3] scene motion: p2 = Rr p1 + tr
    tr: jnp.ndarray  # [3]


def _rigid_tangent_dim(n: int) -> int:
    return 3 * n + 8


def apply_delta_rigid(state: RigidState, delta: jnp.ndarray) -> RigidState:
    n = state.p1.shape[0]
    dp1 = delta[: 3 * n].reshape(n, 3)
    ds1 = delta[3 * n]
    ds2 = delta[3 * n + 1]
    dR, dt = lie.se3_exp(delta[3 * n + 2 : 3 * n + 8])
    Rr, tr = lie.compose(dR, dt, state.Rr, state.tr)
    return RigidState(p1=state.p1 + dp1, s1=state.s1 + ds1, s2=state.s2 + ds2, Rr=Rr, tr=tr)


def _p2_of(state: RigidState) -> jnp.ndarray:
    return jnp.matmul(state.p1, state.Rr.T, precision=MATMUL_PRECISION) + state.tr


def residual_vector_rigid(
    cam_kind: str,
    data: deformable.PairData,
    hyper: deformable.Hyper,
    state: RigidState,
    spec: deformable.ModelSpec = deformable.ModelSpec(),
):
    """Weighted residual vector with sum(r^2) == robust chi2.

    Same edge families and weights as ``deformable.residual_vector`` minus
    the mesh energies (local rigidity holds exactly by construction, so the
    ARAP/Elastic/Ogden term is identically zero at every rigid state) and
    minus the global-SE3 vertex (Rr, tr IS the global alignment).
    """
    vm = data.valid.astype(state.p1.dtype)
    p2 = _p2_of(state)

    def rep_block(p, R, t, kp, inv_s2):
        e = kp - cam_ops.project(cam_kind, data.cam_params, lie.apply(R, t, p))
        chi2 = jax.lax.stop_gradient(jnp.sum(e * e, axis=-1)) * inv_s2 * hyper.rep_w
        _, drho = deformable._huber_rho(chi2)
        w = jnp.sqrt(drho * inv_s2 * hyper.rep_w) * vm
        return (w[:, None] * e).reshape(-1)

    r_rep1 = rep_block(state.p1, data.R1w, data.t1w, data.kp1, data.inv_sigma2_1)
    r_rep2 = rep_block(p2, data.R2w, data.t2w, data.kp2, data.inv_sigma2_2)

    inv_sigma_d = 1.0 / hyper.depth_sigma
    rd1 = vm * inv_sigma_d * deformable._depth_errors(
        data, state.p1, state.s1, data.R1w, data.t1w, data.depth1, spec.depth
    )
    rd2 = vm * inv_sigma_d * deformable._depth_errors(
        data, p2, state.s2, data.R2w, data.t2w, data.depth2, spec.depth
    )

    # Depth-scale prior edges. The rigid model has an EXACT similarity
    # gauge (scale p1 about camera-1's center and p2 about camera-2's by a
    # common lambda; the pair stays rigid with the same Rr and a modified
    # tr, every reprojection is untouched, and the depth chi2 scales by
    # lambda^2 with s -> s/lambda -- i.e. unanchored scales strictly favor
    # collapsing the cloud into the camera centers). The s-priors are the
    # anchor; solve_rigid re-derives them UNBIASED from the refined state's
    # own depths (the pipeline's initial mean(d/z) is seed-biased for
    # TwoPoints/FarPoints, which would leak a coherent radial error of
    # millimeters into the rigid solution).
    # The anchors stay on for EVERY spec.depth: with depth="fixed"/"none"
    # the depth chi2 carries no (or no s-dependent) term, so without the
    # prior the rigid solve would leave s1/s2 at whatever LM damping left
    # them and the depth-discrepancy acceptance quantity rms(d/s - z) used
    # by outer.rigid_select would be evaluated at an arbitrary gauge
    # (ADVICE r4). Anchoring costs nothing for the scaled models (already
    # on) and pins the gauge for the rest.
    r_sprior = jnp.stack(
        [
            jnp.sqrt(data.s1_info) * (state.s1 - data.s1_prior),
            jnp.sqrt(data.s2_info) * (state.s2 - data.s2_prior),
        ]
    )
    return jnp.concatenate([r_rep1, r_rep2, rd1, rd2, r_sprior])


def robust_cost_rigid(cam_kind, data, hyper, state, spec=deformable.ModelSpec()):
    """Robustified chi2 of the rigid model -- the LM accept/reject merit.

    Uses the true Huber rho(chi2) on the reprojection edges exactly like
    ``deformable.robust_cost`` (g2o's RobustKernelHuber semantics), NOT the
    sum of squared IRLS-weighted residuals (which equals drho*chi2 and
    under-counts outliers past the Huber threshold; ADVICE r4). The gain
    ratio in ``lm_optimize`` therefore shares one merit function with the
    rest of the framework.
    """
    vm = data.valid.astype(state.p1.dtype)
    p2 = _p2_of(state)

    def rep_cost(p, R, t, kp, inv_s2):
        e = kp - cam_ops.project(cam_kind, data.cam_params, lie.apply(R, t, p))
        chi2 = jnp.sum(e * e, axis=-1) * inv_s2 * hyper.rep_w
        rho, _ = deformable._huber_rho(chi2)
        return jnp.sum(vm * rho)

    cost = rep_cost(state.p1, data.R1w, data.t1w, data.kp1, data.inv_sigma2_1)
    cost += rep_cost(p2, data.R2w, data.t2w, data.kp2, data.inv_sigma2_2)

    info_d = 1.0 / (hyper.depth_sigma * hyper.depth_sigma)
    ed1 = deformable._depth_errors(
        data, state.p1, state.s1, data.R1w, data.t1w, data.depth1, spec.depth
    )
    ed2 = deformable._depth_errors(
        data, p2, state.s2, data.R2w, data.t2w, data.depth2, spec.depth
    )
    cost += jnp.sum(vm * info_d * (ed1 * ed1 + ed2 * ed2))

    cost += data.s1_info * (state.s1 - data.s1_prior) ** 2
    cost += data.s2_info * (state.s2 - data.s2_prior) ** 2
    return cost


def build_system_rigid(cam_kind, data, hyper, state, spec=deformable.ModelSpec()):
    """Dense Gauss-Newton normal equations, [3N+8]^2 via jacfwd + one
    full-f32 matmul."""
    n = state.p1.shape[0]
    dim = _rigid_tangent_dim(n)

    def f(delta):
        return residual_vector_rigid(cam_kind, data, hyper, apply_delta_rigid(state, delta), spec)

    zero = jnp.zeros((dim,), dtype=state.p1.dtype)
    r = f(zero)
    J = jax.jacfwd(f)(zero)
    return (
        jnp.matmul(J.T, J, precision=MATMUL_PRECISION),
        jnp.matmul(J.T, r, precision=MATMUL_PRECISION),
    )


class RigidDiagnostics(NamedTuple):
    sigma1: jnp.ndarray  # residual pixel sigma, camera 1 ("standard desv")
    sigma2: jnp.ndarray
    depth_rms1: jnp.ndarray  # physical depth discrepancy rms, d/s - z (m)
    depth_rms2: jnp.ndarray
    rigid_fit_rms: jnp.ndarray  # Kabsch residual of the INPUT state (m)


def _pixel_sigmas(cam_kind, data, p1, p2):
    vm = data.valid.astype(p1.dtype)
    n = jnp.maximum(jnp.sum(vm), 1.0)

    def desv(p, R, t, kp):
        e = kp - cam_ops.project(cam_kind, data.cam_params, lie.apply(R, t, p))
        rms = jnp.sqrt(jnp.sum(vm[:, None] * e * e, axis=0) / n)
        return jnp.mean(rms)

    return (
        desv(p1, data.R1w, data.t1w, data.kp1),
        desv(p2, data.R2w, data.t2w, data.kp2),
    )


def depth_discrepancy(data, p1, p2, s1, s2):
    """Physical depth residual rms per camera, rms_i(d_i/s - z_i) over valid
    points (meters, linear regardless of the model family's edge shape --
    this is the measurement-space quantity the Morozov test compares against
    sigma_d)."""
    vm = data.valid.astype(p1.dtype)
    n = jnp.maximum(jnp.sum(vm), 1.0)

    def rms(p, s, R, t, d):
        z = lie.apply(R, t, p)[..., 2]
        e = d / jnp.maximum(s, TINY) - z
        return jnp.sqrt(jnp.sum(vm * e * e) / n)

    return (
        rms(p1, s1, data.R1w, data.t1w, data.depth1),
        rms(p2, s2, data.R2w, data.t2w, data.depth2),
    )


def _midpoint_p1(cam_kind, data: deformable.PairData, Rr, tr, p1_fallback):
    """Closed-form two-view triangulation of p1 GIVEN the scene motion.

    With (Rr, tr) fixed, camera 2 observes Rr p1 + tr, i.e. p1 through the
    effective pose T2w' = (R2w Rr, R2w tr + t2w); each p1_i is then the
    least-squares intersection of its two world rays (the symmetric
    midpoint: p = (sum_k (I - d_k d_k^T))^-1 sum_k (I - d_k d_k^T) c_k).
    Low-parallax pairs (near-singular 3x3) fall back to ``p1_fallback``.
    """
    dtype = p1_fallback.dtype

    def ray(R, t, kp):
        xn = cam_ops.unproject(cam_kind, data.cam_params, kp)
        d = xn / jnp.linalg.norm(xn, axis=-1, keepdims=True)
        Rt = R.T
        return (  # world center [3], world dirs [N, 3]
            -jnp.matmul(Rt, t, precision=MATMUL_PRECISION),
            jnp.matmul(d, R, precision=MATMUL_PRECISION),
        )

    c1, d1 = ray(data.R1w, data.t1w, data.kp1)
    R2e = jnp.matmul(data.R2w, Rr, precision=MATMUL_PRECISION)
    t2e = jnp.matmul(data.R2w, tr, precision=MATMUL_PRECISION) + data.t2w
    c2, d2 = ray(R2e, t2e, data.kp2)

    eye = jnp.eye(3, dtype=dtype)
    A1 = eye[None] - d1[:, :, None] * d1[:, None, :]  # [N, 3, 3]
    A2 = eye[None] - d2[:, :, None] * d2[:, None, :]
    A = A1 + A2
    b = jnp.matmul(A1, c1, precision=MATMUL_PRECISION) + jnp.matmul(
        A2, c2, precision=MATMUL_PRECISION
    )
    # Parallax conditioning: the smallest eigenvalue of A is
    # 1 - cos(angle between rays); damp and gate on it.
    cosang = jnp.sum(d1 * d2, axis=-1)
    ok = cosang < 0.9999
    p = jnp.linalg.solve(A + 1e-6 * eye[None], b[..., None]).squeeze(-1)
    finite = jnp.all(jnp.isfinite(p), axis=-1)
    use = (ok & finite & data.valid)[:, None]
    return jnp.where(use, p, p1_fallback)


@functools.partial(jax.jit, static_argnames=("cam_kind", "n_iterations", "spec"))
def _solve_core(cam_kind, data, hyper, rstate0, n_iterations, spec):
    res = lm_ops.lm_optimize(
        build_system=lambda s: build_system_rigid(cam_kind, data, hyper, s, spec),
        robust_cost=lambda s: robust_cost_rigid(cam_kind, data, hyper, s, spec),
        apply_delta=apply_delta_rigid,
        state0=rstate0,
        n_iterations=n_iterations,
    )
    return res.state, res.cost


def _one_rigid_round(cam_kind, data, hyper, state, n_iterations, spec):
    """One restart round: derive (Rr, tr) + scale anchors from ``state``,
    LM from two inits (state's own p1; motion-compensated midpoint
    re-triangulation), return the lower-cost solution as a PairState plus
    diagnostics."""
    vm = data.valid.astype(state.p1.dtype)
    R, _ = lie.kabsch(state.p1, state.p2, weights=vm)
    wsum = jnp.maximum(jnp.sum(vm), 1.0)
    c1 = jnp.sum(vm[:, None] * state.p1, axis=0) / wsum
    c2 = jnp.sum(vm[:, None] * state.p2, axis=0) / wsum
    tr = c2 - jnp.matmul(R, c1, precision=MATMUL_PRECISION)
    fit = jnp.matmul(state.p1, R.T, precision=MATMUL_PRECISION) + tr - state.p2
    fit_rms = jnp.sqrt(jnp.sum(vm * jnp.sum(fit * fit, axis=-1)) / wsum)

    # Unbiased scale anchors from the current state's own camera depths
    # (see residual_vector_rigid: these pin the similarity collapse gauge).
    def scale_anchor(p, Rw, t, d):
        z = lie.apply(Rw, t, p)[..., 2]
        ratio = d / jnp.maximum(z, TINY)
        m = jnp.sum(vm * ratio) / wsum
        var = jnp.sum(vm * (ratio - m) ** 2) / wsum
        se = jnp.sqrt(jnp.maximum(var / wsum, 1e-12))
        return m, 1.0 / (se * se)

    s1p, s1i = scale_anchor(state.p1, data.R1w, data.t1w, data.depth1)
    s2p, s2i = scale_anchor(state.p2, data.R2w, data.t2w, data.depth2)
    data = data._replace(s1_prior=s1p, s1_info=s1i, s2_prior=s2p, s2_info=s2i)

    inits = [
        RigidState(p1=state.p1, s1=s1p, s2=s2p, Rr=R, tr=tr),
        RigidState(
            p1=_midpoint_p1(cam_kind, data, R, tr, state.p1),
            s1=s1p, s2=s2p, Rr=R, tr=tr,
        ),
    ]
    best, best_cost = None, jnp.inf
    for r0 in inits:
        rs, cost = _solve_core(cam_kind, data, hyper, r0, n_iterations, spec)
        if best is None or bool(cost < best_cost):
            best, best_cost = rs, cost

    rs = best
    p2 = _p2_of(rs)
    # Global-vertex convention of the ARAP edge (g2oTypes.h:300-349):
    # residual Rg p2 - tg - p1 ~ 0  =>  Rg = Rr^-1, tg = Rg tr.
    Rg = rs.Rr.T
    cand = deformable.PairState(
        p1=rs.p1, p2=p2, s1=rs.s1, s2=rs.s2, Rg=Rg, tg=jnp.matmul(Rg, rs.tr, precision=MATMUL_PRECISION)
    )
    s1px, s2px = _pixel_sigmas(cam_kind, data, rs.p1, p2)
    dr1, dr2 = depth_discrepancy(data, rs.p1, p2, rs.s1, rs.s2)
    return cand, RigidDiagnostics(
        sigma1=s1px, sigma2=s2px, depth_rms1=dr1, depth_rms2=dr2, rigid_fit_rms=fit_rms
    )


def solve_rigid(
    cam_kind: str,
    data: deformable.PairData,
    hyper: deformable.Hyper,
    state0: deformable.PairState,
    n_iterations: int,
    spec: deformable.ModelSpec = deformable.ModelSpec(),
    max_restarts: int = 5,
):
    """Solve the rigid hypothesis from a (refined) general state.

    Restarted multi-start LM: each round re-derives (Rr, tr) by weighted
    Kabsch and the scale anchors from the current best state, runs LM from
    two inits (the state's own shape; the motion-compensated closed-form
    midpoint triangulation, which re-derives the shape from the
    observations alone -- the far-from-rigid seeds TwoPoints/FarPoints
    leave refined states whose shape is a poor rigid init), and keeps the
    round's lower-cost solution. Restarting matters: the inner LM inherits
    g2o's stop-on-failed-iteration semantics (ops/lm.py), so a stalled
    damping schedule ends a round early; re-linearizing motion + anchors
    from the stalled point recovers it (observed: 2.1 -> 1.0 mm over 3
    restarts on TwoPoints-seeded cells). Rounds stop when the
    restart-comparable score (pixel sigmas + depth discrepancies in their
    noise units) stops improving.

    Returns (PairState candidate with p2 = Rr p1 + tr and the global
    vertex set consistently, diagnostics).
    """
    sigma_d = jnp.maximum(hyper.depth_sigma, TINY)

    def score(diag: RigidDiagnostics) -> float:
        return float(
            diag.sigma1**2 + diag.sigma2**2
            + (diag.depth_rms1**2 + diag.depth_rms2**2) / (sigma_d * sigma_d)
        )

    cur = state0
    best = None
    best_score = np.inf
    for _ in range(max_restarts):
        cand, diag = _one_rigid_round(cam_kind, data, hyper, cur, n_iterations, spec)
        s = score(diag)
        if not np.isfinite(s) or s >= best_score - 1e-9:
            break
        best, best_score = (cand, diag), s
        cur = cand
    if best is None:
        best = (cand, diag)
    return best
