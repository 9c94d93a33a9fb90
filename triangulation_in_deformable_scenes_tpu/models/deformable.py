"""Deformation-regularized dual-point refinement: the framework's heart.

Replaces the reference's g2o problem ``arapOptimization``
(``Modules/Optimization/g2oBundleAdjustment.cc:608-1008``) with a fixed-shape
batched nonlinear least squares over one keyframe pair:

state  theta = (p1[N,3], p2[N,3], s1, s2, T_global in SE3)
edges  per match i (``g2oBundleAdjustment.cc:762-868``):
         2 reprojection edges, Huber delta = sqrt(100.991), info =
           invSigma2 * rep_weight   (``EdgeSE3ProjectXYZPerKeyFrameOnlyPoints``)
         2 depth edges, residual (d/s - z_cam)^2 (x500 when s <= 0), info =
           1/depth_sigma^2          (``EdgeDepthCorrection``, g2oTypes.h:390-421)
       per directed mesh edge (i, j) (``g2oBundleAdjustment.cc:883-953``):
         1 ARAP edge whose scalar energy couples both point sets and the
           global SE3, info = arap_weight * n_triangles^2 (``EdgeARAP``,
           g2oTypes.h:300-349)

The mesh (Delaunay adjacency, cot weights) and the per-vertex ARAP rotations
R_i are computed once per solve from the current positions and FROZEN during
the LM iterations, exactly like the reference (mesh at
``g2oBundleAdjustment.cc:652-688``; note ``globalBalanceWeight`` is accepted
but unused by the inner solve there -- the global term lives inside EdgeARAP
with the ARAP information; we keep that behavior and signature).

Design notes: the normal equations are assembled directly from per-edge
local Jacobian blocks (forward-mode AD, vmapped over edges) scattered into a
dense H -- never by materializing the big J. All shapes are static in
(N, K); the LM loop is a ``lax.scan`` (see ``ops/lm.py``). One jit
compilation serves every weight candidate the outer search tries.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import arap as arap_ops
from ..ops import camera as cam_ops
from ..ops import lie
from ..ops import lm as lm_ops
from ..ops import mesh as mesh_ops
from ..precision import FP, MATMUL_PRECISION, TINY

HUBER_DELTA = float(np.sqrt(100.991))  # deltaMono, g2oBundleAdjustment.cc:631


class ModelSpec(NamedTuple):
    """Static structure of the deformation model (resolved at trace time).

    The reference's experiment sweeps exercise a family of models (the
    committed results under ``Data/Experiments/{ARAP, ARAP_NoGlobal,
    ARAP_OneSet, ARAP_depth_*, ARAP_not_scaled_depth, ARAP_depth_onlyTriang,
    Elastic, HyperElasticOdgen}``); the shipped C++ retains only the ARAP
    energy (``g2oTypes.h:300-349``) plus both depth-edge variants
    (``EdgeDepthCorrection`` / ``EdgeDepthWithoutScaleCorrection``,
    ``g2oTypes.h:390-448``). This spec reconstructs the full family:

    - energy "ARAP": cotangent-weighted local-rigidity residual with the
      frozen per-vertex rotations;
      "Elastic": spring energy on edge-length change;
      "Ogden": one-term Ogden hyperelastic energy on the edge stretch, with
      the (alpha, beta) bulk/shear parameters the ARAP edge carries but never
      uses in the reference (``g2oTypes.h:343-348``).
    - depth "scaled": linear residual (d/s - z) with optimizable scale (the
      statistically consistent form -- see ``_depth_errors`` for why the
      reference's squared variant is kept only as "scaled_squared");
      "fixed": LINEAR residual (d - z * s) with the scale frozen at its
      initial estimate -- the same consistent-likelihood deviation as
      "scaled" applied to ``EdgeDepthWithoutScaleCorrection`` (the
      reference squares the metric error, g2oTypes.h:440, making the chi2
      quartic with a multi-millimeter dead zone; measured r5 on the
      committed ARAP_not_scaled_depth cells, the quartic form let the
      FarPoints gaussian finals explode 9 -> 25 mm where the linear form
      reaches 2-4 mm). "fixed_squared": exact reference parity;
      "none": depth used only for triangulation.
    - one_set: the FIRST point set is frozen at its initialization and only
      the second set (plus scales/global-T) is optimized. Evidence from the
      committed ``ARAP_OneSet`` traces: C1's reprojection std is EXACTLY
      constant across every optimization iteration (e.g.
      ``Data/Experiments/ARAP_OneSet/InRays/20cm Depth/Planar/10 mm
      rigid/1/Experiment.txt`` holds 1,00446 from INITIAL through FINAL)
      while C2's evolves -- set 1 never moves. The variant's code is not in
      the shipped C++; its constant C1 std equals the injected pixel-noise
      sigma, i.e. the committed runs froze a noise-free-projection
      (ground-truth-anchored) first set. This framework freezes set 1 at
      its standard triangulated initialization instead (no ground-truth
      leakage at solve time), so one-set initials match the common regime.
      An earlier r4 reading ("both reprojection edges act on one shared
      point") is refuted by the same traces: a shared set would change
      C1's std and cannot reproduce a constant one.
    - use_global: include the global-SE3 alignment term inside the mesh-edge
      energy (off for ARAP_NoGlobal).
    """

    energy: str = "ARAP"
    depth: str = "scaled"
    one_set: bool = False
    use_global: bool = True


MODELS = {
    "ARAP": ModelSpec(),
    "ARAP_NoGlobal": ModelSpec(use_global=False),
    "ARAP_OneSet": ModelSpec(one_set=True),
    "ARAP_not_scaled_depth": ModelSpec(depth="fixed"),
    "ARAP_depth_onlyTriang": ModelSpec(depth="none"),
    "ARAP_depth_1mm": ModelSpec(),
    "ARAP_depth_3mm": ModelSpec(),
    "ARAP_depth_8mm": ModelSpec(),
    # Exact-parity variants of the reference's quartic depth edges.
    "ARAP_squared_depth": ModelSpec(depth="scaled_squared"),
    "ARAP_not_scaled_depth_squared": ModelSpec(depth="fixed_squared"),
    "Elastic": ModelSpec(energy="Elastic"),
    "HyperElasticOdgen": ModelSpec(energy="Ogden"),
}


def model_depth_sigma(name: str):
    """Depth-uncertainty override (meters) for the ARAP_depth_<x>mm models."""
    if name.startswith("ARAP_depth_") and name.endswith("mm"):
        return float(name[len("ARAP_depth_") : -2]) / 1000.0
    return None


class PairData(NamedTuple):
    """Fixed observations for one keyframe pair (padded to N)."""

    kp1: jnp.ndarray  # [N, 2] observed pixels in KF1
    kp2: jnp.ndarray  # [N, 2]
    inv_sigma2_1: jnp.ndarray  # [N] pyramid information (1.0 at octave 0)
    inv_sigma2_2: jnp.ndarray  # [N]
    depth1: jnp.ndarray  # [N] depth measurements (sensor scale)
    depth2: jnp.ndarray  # [N]
    valid: jnp.ndarray  # [N] bool
    cam_params: jnp.ndarray  # [8] KB8 params (or first 4 for pinhole)
    R1w: jnp.ndarray
    t1w: jnp.ndarray
    R2w: jnp.ndarray
    t2w: jnp.ndarray
    nbr: jnp.ndarray  # [N, K] mesh adjacency, -1 padded
    nbr_mask: jnp.ndarray  # [N, K]
    wcot: jnp.ndarray  # [N, K]
    Ri: jnp.ndarray  # [N, 3, 3] frozen ARAP rotations
    area: jnp.ndarray  # scalar mesh surface area
    ntri: jnp.ndarray  # scalar triangle count
    # Depth-scale prior edges (deviation from the reference, documented):
    # the initial per-keyframe scale estimate s0 = mean(d_i / z_i) is itself a
    # measurement whose standard error is computable from the d/z scatter.
    # The reference leaves the scale vertices unconstrained
    # (g2oTypes.h:390-421), which leaves a per-camera radial-scaling gauge
    # mode that reprojection cannot see; the sigma~1px weight-search
    # objective actively rewards sliding along it (the reference's own
    # committed FarPoints finals degrade the same way, e.g. 11.5 -> 28.85 mm).
    # info = 1 / SE(s0)^2; zero info disables the edge (reference behavior).
    s1_prior: jnp.ndarray = 0.0  # scalar
    s2_prior: jnp.ndarray = 0.0
    s1_info: jnp.ndarray = 0.0
    s2_info: jnp.ndarray = 0.0


class PairState(NamedTuple):
    p1: jnp.ndarray  # [N, 3]
    p2: jnp.ndarray
    s1: jnp.ndarray  # scalar depth scale KF1
    s2: jnp.ndarray
    Rg: jnp.ndarray  # [3, 3] global alignment rotation
    tg: jnp.ndarray  # [3]


class Hyper(NamedTuple):
    rep_w: jnp.ndarray
    arap_w: jnp.ndarray
    depth_sigma: jnp.ndarray
    # Kept for signature parity with the reference inner solve, where the
    # global weight is accepted but unused (g2oBundleAdjustment.cc:608,699).
    global_w: jnp.ndarray
    # Bulk/shear parameters of the hyperelastic energy (Optimization.alpha /
    # .beta; carried-but-unused by the reference's ARAP edge).
    alpha: float = 1.0
    beta: float = 1.0


def _tangent_dim(n: int) -> int:
    return 6 * n + 8


def apply_delta(state: PairState, delta: jnp.ndarray) -> PairState:
    n = state.p1.shape[0]
    dp1 = delta[: 3 * n].reshape(n, 3)
    dp2 = delta[3 * n : 6 * n].reshape(n, 3)
    ds1 = delta[6 * n]
    ds2 = delta[6 * n + 1]
    dxi = delta[6 * n + 2 : 6 * n + 8]
    dR, dt = lie.se3_exp(dxi)
    Rg, tg = lie.compose(dR, dt, state.Rg, state.tg)
    return PairState(
        p1=state.p1 + dp1,
        p2=state.p2 + dp2,
        s1=state.s1 + ds1,
        s2=state.s2 + ds2,
        Rg=Rg,
        tg=tg,
    )


# ---------------------------------------------------------------------------
# Edge residuals (weighted so that sum(r^2) equals g2o's chi2)
# ---------------------------------------------------------------------------


def _rep_errors(cam_kind, data: PairData, p, R, t, kp):
    """Unweighted reprojection error e = obs - proj(T p) per point, [N, 2]."""
    pc = lie.apply(R, t, p)
    proj = cam_ops.project(cam_kind, data.cam_params, pc)
    return kp - proj


def _canon_state(spec: ModelSpec, state: PairState) -> PairState:
    """Identity hook (kept for call-site stability).

    one_set no longer rewrites the state: its semantics are a FROZEN first
    set (see ModelSpec), implemented by masking the p1 tangent out of the
    retraction (``apply_delta_spec``) and zeroing p1's rows/columns of the
    normal equations -- not by tying p2 to p1.
    """
    return state


def apply_delta_spec(spec: ModelSpec):
    """Spec-aware retraction: one_set masks the p1 block of the tangent,
    freezing the first set (its H rows/cols and gradient entries then
    vanish identically, so every solver backend keeps delta_p1 = 0)."""
    if not spec.one_set:
        return apply_delta

    def apply(state, delta):
        n = state.p1.shape[0]
        return apply_delta(state, delta.at[: 3 * n].set(0.0))

    return apply


def _depth_errors(data: PairData, p, s, R, t, d, mode: str = "scaled"):
    """Depth-edge error per point, [N].

    mode "scaled" (default): LINEAR residual (d/s - z), chi2 =
    (d/s - z)^2 / sigma^2 -- the statistically consistent Gaussian
    depth-measurement model. This deviates from the reference deliberately:
    ``EdgeDepthCorrection`` SQUARES the metric error inside the residual
    (g2oTypes.h:400-415), making the chi2 quartic -- a 1-sigma (3 mm) depth
    deviation costs ~1e-5 while a 1 px reprojection deviation costs ~1, so
    the depth term only bites tens of millimeters out. That dead zone is what
    lets the per-camera scale/depth gauge mode slide during the weight
    search (the reference's own committed finals degrade the same way, e.g.
    FarPoints 11.5 -> 28.85 mm on the 20.9 mm Gradual condition).
    mode "scaled_squared": exact reference parity (the quartic edge), with
    the x500 penalty at s <= 0; "fixed": EdgeDepthWithoutScaleCorrection
    (d - z*s)^2 with the scale frozen (g2oTypes.h:423-448, parity incl. the
    squaring); "none": 0.
    """
    if mode == "none":
        return jnp.zeros_like(d)
    z = lie.apply(R, t, p)[..., 2]
    if mode == "fixed":
        s0 = jax.lax.stop_gradient(s)
        return d - z * s0
    if mode == "fixed_squared":
        s0 = jax.lax.stop_gradient(s)
        return (d - z * s0) ** 2
    if mode == "scaled_squared":
        e = (d / s - z) ** 2
        return jnp.where(s <= 0.0, 500.0 * e, e)
    e = d / s - z
    # s <= 0 penalty preserved on the chi2 scale (x500).
    return jnp.where(s <= 0.0, jnp.sqrt(500.0) * e, e)


def _sq(v):
    """Squared norm v . v of a 3-vector."""
    return jnp.dot(v, v, precision=MATMUL_PRECISION)


def _mesh_edge_energy_scalar(spec: ModelSpec, p1i, p2i, p1j, p2j, Ri, Rj, w, area, Rg, tg, alpha, beta):
    """Scalar mesh-edge energy for one directed edge (see ModelSpec)."""
    d1 = p1i - p1j
    d2 = p2i - p2j
    if spec.energy == "ARAP":
        first = (d2 - jnp.matmul(Ri, d1, precision=MATMUL_PRECISION)) / area
        second = (-d2 - jnp.matmul(Rj, -d1, precision=MATMUL_PRECISION)) / area
        e = w * (_sq(first) + _sq(second))
    elif spec.energy == "Elastic":
        l1 = jnp.sqrt(_sq(d1) + TINY)
        l2 = jnp.sqrt(_sq(d2) + TINY)
        # Spring energy on edge-length change; the factor 2 mirrors the ARAP
        # edge's two (i and j) half-terms.
        e = 2.0 * w * ((l2 - l1) / area) ** 2
    else:  # Ogden
        l1 = jnp.sqrt(_sq(d1) + TINY)
        l2 = jnp.sqrt(_sq(d2) + TINY)
        lam = l2 / l1
        W = (lam**alpha + lam ** (-alpha * beta) - 2.0) / jnp.maximum(alpha, 1e-6)
        e = w * W * (l1 / area) ** 2
    if spec.use_global:
        g = (jnp.matmul(Rg, p2i, precision=MATMUL_PRECISION) - tg - p1i) + (
            jnp.matmul(Rg, p2j, precision=MATMUL_PRECISION) - tg - p1j
        )
        e = e + _sq(g)
    return e


def _arap_energies(data: PairData, state: PairState, spec: ModelSpec = ModelSpec(), hyper: Hyper = None):
    """Mesh-edge energies per directed edge, [N, K] (masked).

    For the ARAP energy this equals ``arap_ops.arap_edge_energy``
    (EdgeARAP::computeError); other members of the model family share the
    same [N, K] layout.
    """
    alpha = hyper.alpha if hyper is not None else 1.0
    beta = hyper.beta if hyper is not None else 1.0
    if spec == ModelSpec() or (spec.energy == "ARAP" and spec.use_global and not spec.one_set):
        return arap_ops.arap_edge_energy(
            state.p1, state.p2, data.Ri, data.nbr, data.nbr_mask, data.wcot,
            data.area, state.Rg, state.tg,
        )
    n, K = data.nbr.shape
    j_safe = jnp.maximum(data.nbr, 0).reshape(-1)
    i_ids = jnp.broadcast_to(jnp.arange(n)[:, None], (n, K)).reshape(-1)
    E = jax.vmap(
        lambda p1i, p2i, p1j, p2j, Ri, Rj, w: _mesh_edge_energy_scalar(
            spec, p1i, p2i, p1j, p2j, Ri, Rj, w, data.area, state.Rg, state.tg, alpha, beta
        )
    )(
        state.p1[i_ids],
        state.p2[i_ids],
        state.p1[j_safe],
        state.p2[j_safe],
        data.Ri[i_ids],
        data.Ri[j_safe],
        data.wcot.reshape(-1),
    ).reshape(n, K)
    return jnp.where(data.nbr_mask, E, 0.0)


def _huber_rho(chi2, delta=HUBER_DELTA):
    """g2o RobustKernelHuber: rho(s) and rho'(s) on the chi2 scale."""
    d2 = delta * delta
    sqrt_c = jnp.sqrt(jnp.maximum(chi2, TINY))
    rho = jnp.where(chi2 <= d2, chi2, 2.0 * delta * sqrt_c - d2)
    drho = jnp.where(chi2 <= d2, 1.0, delta / sqrt_c)
    return rho, drho


def robust_cost(
    cam_kind: str,
    data: PairData,
    hyper: Hyper,
    state: PairState,
    spec: ModelSpec = ModelSpec(),
):
    """Total robustified chi2 (the quantity g2o's LM accept/reject uses)."""
    state = _canon_state(spec, state)
    vm = data.valid.astype(state.p1.dtype)

    omega1 = data.inv_sigma2_1 * hyper.rep_w
    omega2 = data.inv_sigma2_2 * hyper.rep_w
    e1 = _rep_errors(cam_kind, data, state.p1, data.R1w, data.t1w, data.kp1)
    e2 = _rep_errors(cam_kind, data, state.p2, data.R2w, data.t2w, data.kp2)
    chi2_1 = jnp.sum(e1 * e1, axis=-1) * omega1
    chi2_2 = jnp.sum(e2 * e2, axis=-1) * omega2
    rho1, _ = _huber_rho(chi2_1)
    rho2, _ = _huber_rho(chi2_2)
    cost_rep = jnp.sum(vm * (rho1 + rho2))

    info_d = 1.0 / (hyper.depth_sigma * hyper.depth_sigma)
    ed1 = _depth_errors(data, state.p1, state.s1, data.R1w, data.t1w, data.depth1, spec.depth)
    ed2 = _depth_errors(data, state.p2, state.s2, data.R2w, data.t2w, data.depth2, spec.depth)
    cost_depth = jnp.sum(vm * info_d * (ed1 * ed1 + ed2 * ed2))

    # ARAP info = arap_w * n_triangles^2 (g2oBundleAdjustment.cc:945-948).
    # The reference also computes a per-vertex depth-based inverse uncertainty
    # (getInvUncertainty, g2oBundleAdjustment.cc:887,1106-1135) but its
    # multiplication into the info is commented out at :948 -- dead
    # computation, intentionally not ported.
    info_a = hyper.arap_w * data.ntri * data.ntri
    E = _arap_energies(data, state, spec, hyper)
    cost_arap = jnp.sum(info_a * E * E)

    cost_sprior = 0.0
    if spec.depth in ("scaled", "scaled_squared"):
        cost_sprior = data.s1_info * (state.s1 - data.s1_prior) ** 2 + data.s2_info * (
            state.s2 - data.s2_prior
        ) ** 2

    return cost_rep + cost_depth + cost_arap + cost_sprior


def residual_vector(
    cam_kind: str,
    data: PairData,
    hyper: Hyper,
    state: PairState,
    spec: ModelSpec = ModelSpec(),
):
    """Weighted residual vector r with sum(r^2) == robust chi2 (Huber via
    IRLS weights evaluated at ``state``). Layout: [rep1 (N*2), rep2 (N*2),
    depth1 (N), depth2 (N), arap (N*K)].

    Used by the matrix-free (CG) solve path: J v and J^T u come from
    jvp/vjp of this function composed with ``apply_delta``, which is how the
    landmark-sharded multi-chip solver avoids materializing H.
    """
    state = _canon_state(spec, state)
    vm = data.valid.astype(state.p1.dtype)

    def rep_block(p, R, t, kp, inv_s2):
        e = kp - cam_ops.project(cam_kind, data.cam_params, lie.apply(R, t, p))
        # Huber IRLS weight frozen at the linearization point (stop_gradient
        # keeps jvp/vjp from differentiating through rho', matching g2o's
        # robustified information matrix).
        chi2 = jax.lax.stop_gradient(jnp.sum(e * e, axis=-1)) * inv_s2 * hyper.rep_w
        _, drho = _huber_rho(chi2)
        w = jnp.sqrt(drho * inv_s2 * hyper.rep_w) * vm
        return (w[:, None] * e).reshape(-1)

    r_rep1 = rep_block(state.p1, data.R1w, data.t1w, data.kp1, data.inv_sigma2_1)
    r_rep2 = rep_block(state.p2, data.R2w, data.t2w, data.kp2, data.inv_sigma2_2)

    inv_sigma_d = 1.0 / hyper.depth_sigma
    rd1 = vm * inv_sigma_d * _depth_errors(
        data, state.p1, state.s1, data.R1w, data.t1w, data.depth1, spec.depth
    )
    rd2 = vm * inv_sigma_d * _depth_errors(
        data, state.p2, state.s2, data.R2w, data.t2w, data.depth2, spec.depth
    )

    j_safe = jnp.maximum(data.nbr, 0)
    edge_ok = (data.nbr_mask & data.valid[:, None] & data.valid[j_safe]).astype(state.p1.dtype)
    sqrt_info_a = jnp.sqrt(hyper.arap_w) * data.ntri
    r_arap = (edge_ok * sqrt_info_a * _arap_energies(data, state, spec, hyper)).reshape(-1)

    # Depth-scale prior edges (see PairData; zero info => inert).
    sgate = 1.0 if spec.depth in ("scaled", "scaled_squared") else 0.0
    r_sprior = jnp.stack(
        [
            sgate * jnp.sqrt(data.s1_info) * (state.s1 - data.s1_prior),
            sgate * jnp.sqrt(data.s2_info) * (state.s2 - data.s2_prior),
        ]
    )

    return jnp.concatenate([r_rep1, r_rep2, rd1, rd2, r_arap, r_sprior])


# ---------------------------------------------------------------------------
# Normal-equation assembly from per-edge local Jacobians
# ---------------------------------------------------------------------------


def _scatter_system(H, g, L, r, idx):
    """Accumulate L^T L and L^T r of a batch of edges into (H, g).

    L: [M, rdim, d] local Jacobians; r: [M, rdim]; idx: [M, d] tangent
    indices. Padded/invalid edges must have L == 0 and r == 0.
    """
    Hblk = jnp.einsum("mri,mrj->mij", L, L, precision=MATMUL_PRECISION)
    gblk = jnp.einsum("mri,mr->mi", L, r, precision=MATMUL_PRECISION)
    H = H.at[idx[:, :, None], idx[:, None, :]].add(Hblk)
    g = g.at[idx].add(gblk)
    return H, g


def _edge_blocks(
    cam_kind: str,
    data: PairData,
    hyper: Hyper,
    state: PairState,
    spec: ModelSpec = ModelSpec(),
):
    """Per-edge local Jacobians for every edge family.

    Returns a list of (L [M, rdim, d], r [M, rdim], idx [M, d]) triples;
    padded/invalid edges carry zero weights so their blocks vanish.
    """
    state = _canon_state(spec, state)
    n = state.p1.shape[0]
    dtype = state.p1.dtype
    blocks = []

    vm = data.valid.astype(dtype)
    idx_p1 = 3 * jnp.arange(n)[:, None] + jnp.arange(3)[None, :]
    idx_p2 = 3 * n + idx_p1
    i_s1 = 6 * n
    i_s2 = 6 * n + 1
    idx_xi = 6 * n + 2 + jnp.arange(6)

    # --- reprojection edges (Huber-reweighted at linearization point) ---
    def rep_weights(e, inv_sigma2):
        chi2 = jnp.sum(e * e, axis=-1) * inv_sigma2 * hyper.rep_w
        _, drho = _huber_rho(chi2)
        return jnp.sqrt(drho * inv_sigma2 * hyper.rep_w) * vm

    # Closed-form Jacobian de/dp = -(dproj/dpc) R (analytic camera Jacobian,
    # ops/camera.project_jac; parity-tested vs jacfwd) -- the per-edge
    # vmapped jacfwd blocked XLA fusion across the assembly (see
    # block_system.build_block_system).
    for (p, R, t, kp, inv_s2, idx_p) in (
        (state.p1, data.R1w, data.t1w, data.kp1, data.inv_sigma2_1, idx_p1),
        (state.p2, data.R2w, data.t2w, data.kp2, data.inv_sigma2_2, idx_p2),
    ):
        pc = lie.apply(R, t, p)
        e = kp - cam_ops.project(cam_kind, data.cam_params, pc)
        w = rep_weights(e, inv_s2)  # [N]
        Jpi = cam_ops.project_jac(cam_kind, data.cam_params, pc)  # [N, 2, 3]
        L = -w[:, None, None] * jnp.einsum("nab,bc->nac", Jpi, R, precision=MATMUL_PRECISION)
        r = w[:, None] * e
        blocks.append((L, r, idx_p))

    # --- depth edges ---
    if spec.depth != "none":
        inv_sigma_d = 1.0 / hyper.depth_sigma
        # Closed-form residual/Jacobian (see block_system.build_block_system:
        # every depth mode's e depends on p only through z = (R p + t)[2]).
        for (p, s, R, t, d, idx_p, i_s) in (
            (state.p1, state.s1, data.R1w, data.t1w, data.depth1, idx_p1, i_s1),
            (state.p2, state.s2, data.R2w, data.t2w, data.depth2, idx_p2, i_s2),
        ):
            w = vm * inv_sigma_d
            z = (jnp.matmul(p, R.T, precision=MATMUL_PRECISION) + t)[:, 2]
            if spec.depth == "fixed":
                s0 = jax.lax.stop_gradient(s)
                e = d - z * s0
                de_dz = jnp.full_like(e, -s0)
                de_ds = jnp.zeros_like(e)
            elif spec.depth == "fixed_squared":
                s0 = jax.lax.stop_gradient(s)
                u_ = d - z * s0
                e = u_ * u_
                de_dz = -2.0 * u_ * s0
                de_ds = jnp.zeros_like(e)
            elif spec.depth == "scaled_squared":
                u_ = d / s - z
                pen = jnp.where(s <= 0.0, 500.0, 1.0)
                e = pen * u_ * u_
                de_dz = pen * (-2.0 * u_)
                de_ds = pen * (-2.0 * u_ * d / (s * s))
            else:
                pen = jnp.where(s <= 0.0, jnp.sqrt(500.0), 1.0)
                e = pen * (d / s - z)
                de_dz = jnp.full_like(e, -pen)
                de_ds = pen * (-d / (s * s))
            L = jnp.concatenate(
                [
                    (w * de_dz)[:, None] * R[2, :][None, :],
                    (w * de_ds)[:, None],
                ],
                axis=-1,
            )[:, None, :]  # [N, 1, 4]
            r = (w * e)[:, None]  # [N, 1]
            idx = jnp.concatenate([idx_p, jnp.full((n, 1), i_s, dtype=idx_p.dtype)], axis=-1)
            blocks.append((L, r, idx))

    # --- ARAP edges (flattened [N*K]) ---
    K = data.nbr.shape[1]
    j_safe = jnp.maximum(data.nbr, 0)  # [N, K]
    i_ids = jnp.broadcast_to(jnp.arange(n)[:, None], (n, K))
    sqrt_info_a = jnp.sqrt(hyper.arap_w) * data.ntri
    w_edge = (data.nbr_mask & data.valid[:, None] & data.valid[j_safe]).astype(
        dtype
    ) * sqrt_info_a  # [N, K]

    Rg0, tg0 = state.Rg, state.tg

    def arap_local(x, Ri, Rj, wcot, we):
        p1i, p2i, p1j, p2j = x[0:3], x[3:6], x[6:9], x[9:12]
        xi = x[12:18]
        dR, dt = lie.se3_exp(xi)
        Rg, tg = lie.compose(dR, dt, Rg0, tg0)
        energy = _mesh_edge_energy_scalar(
            spec, p1i, p2i, p1j, p2j, Ri, Rj, wcot, data.area, Rg, tg,
            hyper.alpha, hyper.beta,
        )
        return (we * energy)[None]

    x_edges = jnp.concatenate(
        [
            state.p1[i_ids.reshape(-1)],
            state.p2[i_ids.reshape(-1)],
            state.p1[j_safe.reshape(-1)],
            state.p2[j_safe.reshape(-1)],
            jnp.zeros((n * K, 6), dtype=dtype),
        ],
        axis=-1,
    )  # [N*K, 18]
    Ri_e = data.Ri[i_ids.reshape(-1)]
    Rj_e = data.Ri[j_safe.reshape(-1)]
    L = jax.vmap(jax.jacfwd(arap_local), in_axes=(0, 0, 0, 0, 0))(
        x_edges, Ri_e, Rj_e, data.wcot.reshape(-1), w_edge.reshape(-1)
    )  # [NK, 1, 18]
    r = jax.vmap(arap_local)(x_edges, Ri_e, Rj_e, data.wcot.reshape(-1), w_edge.reshape(-1))
    idx = jnp.concatenate(
        [
            idx_p1[i_ids.reshape(-1)],
            idx_p2[i_ids.reshape(-1)],
            idx_p1[j_safe.reshape(-1)],
            idx_p2[j_safe.reshape(-1)],
            jnp.broadcast_to(idx_xi, (n * K, 6)),
        ],
        axis=-1,
    )  # [NK, 18]
    blocks.append((L, r, idx))

    # --- depth-scale prior edges (see PairData; unit edges on s1, s2) ---
    if spec.depth in ("scaled", "scaled_squared"):
        sqrt_i = jnp.stack(
            [jnp.sqrt(data.s1_info), jnp.sqrt(data.s2_info)]
        ).astype(dtype)
        r_s = (
            sqrt_i
            * jnp.stack([state.s1 - data.s1_prior, state.s2 - data.s2_prior]).astype(dtype)
        ).reshape(2, 1)
        L_s = sqrt_i.reshape(2, 1, 1)
        idx_s = jnp.array([[i_s1], [i_s2]], dtype=jnp.int32)
        blocks.append((L_s, r_s, idx_s))

    if spec.one_set:
        # Frozen first set: zero every local-Jacobian entry that lands on a
        # p1 coordinate (residuals keep their values -- the cost still sees
        # set 1 -- but the solver cannot move it).
        blocks = [
            (L * (idx[:, None, :] >= 3 * n).astype(L.dtype), r, idx)
            for L, r, idx in blocks
        ]
    return blocks


def build_system_jacfwd(
    cam_kind: str,
    data: PairData,
    hyper: Hyper,
    state: PairState,
    spec: ModelSpec = ModelSpec(),
):
    """Gauss-Newton (H, g) via a [dim]-wide batched JVP of the full weighted
    residual vector. Reference implementation for build_system (exact to
    1e-12 relative against the block assembly in f64, tests/test_deformable)
    -- the dim-wide forward sweep re-evaluates every camera/Lie/mesh
    intermediate with a full-width tangent batch, which measures ~35%
    slower per LM iteration than the per-edge local-Jacobian route at the
    fixture size; kept as the independent oracle."""
    n = state.p1.shape[0]
    dim = _tangent_dim(n)
    dtype = state.p1.dtype

    apply = apply_delta_spec(spec)

    def f(delta):
        return residual_vector(cam_kind, data, hyper, apply(state, delta), spec)

    zero = jnp.zeros((dim,), dtype=dtype)
    r = f(zero)
    J = jax.jacfwd(f)(zero)  # [R, dim]
    H = jnp.matmul(J.T, J, precision=MATMUL_PRECISION)
    g = jnp.matmul(J.T, r, precision=MATMUL_PRECISION)
    return H, g


def build_system(
    cam_kind: str,
    data: PairData,
    hyper: Hyper,
    state: PairState,
    spec: ModelSpec = ModelSpec(),
):
    """Gauss-Newton H, g at ``state`` with robust weights frozen there.

    Assembly from per-edge LOCAL Jacobians (``_edge_blocks``: tiny jacfwds
    over each edge family's own <=18 coordinates, vmapped over edges)
    scattered row-wise into the dense J -- a scatter-SET with unique
    destinations per row, one scatter per family, unlike the per-edge H
    block scatter-ADD (`_scatter_system`, kept for ``assemble_diag``) whose
    duplicate destinations serialize. H = J^T J and g = J^T r are single
    full-f32 matmuls. Equivalent to ``build_system_jacfwd`` (1e-12 relative
    in f64) with less work: the full-width JVP re-evaluates every
    intermediate with a [dim]-wide tangent batch, while the local blocks
    differentiate each edge only along the coordinates it actually touches.
    J is [R, dim] with R = O(N*(4+2+K)): ~40 MB at the fixture size, and
    the dense backend hands off to CG above DENSE_DIM_LIMIT anyway.
    """
    if spec.one_set:
        # One-set models freeze the p1 tangent (apply_delta_spec masks it);
        # the full-width JVP realizes the zero p1 columns naturally, and the
        # one-set dense problem is small, so the oracle path serves it.
        return build_system_jacfwd(cam_kind, data, hyper, state, spec)
    n = state.p1.shape[0]
    dim = _tangent_dim(n)
    Js, rs = [], []
    # INVARIANT (scatter-set correctness): masked mesh-edge rows must carry
    # IDENTICALLY-ZERO local Jacobians and residuals. _edge_blocks clamps a
    # padded neighbor (nbr == -1) to column 0, so a masked slot of point i
    # scatters both p_i's and p_0's column indices; with scatter-SET
    # semantics a nonzero value there would silently overwrite (not add to)
    # a real entry. The w_edge mask factor inside _edge_blocks guarantees
    # the zeros today; test_deformable.py::test_masked_edge_rows_are_zero
    # pins the invariant for future edge families.
    for L, r_, idx in _edge_blocks(cam_kind, data, hyper, state, spec):
        M, rr, dd = L.shape
        Jf = jnp.zeros((M, rr, dim), L.dtype)
        Jf = Jf.at[
            jnp.arange(M)[:, None, None],
            jnp.arange(rr)[None, :, None],
            jnp.broadcast_to(idx[:, None, :], (M, rr, dd)),
        ].set(L)
        Js.append(Jf.reshape(M * rr, dim))
        rs.append(r_.reshape(-1))
    J = jnp.concatenate(Js)
    r = jnp.concatenate(rs)
    return (
        jnp.matmul(J.T, J, precision=MATMUL_PRECISION),
        jnp.matmul(J.T, r, precision=MATMUL_PRECISION),
    )


def assemble_diag(
    cam_kind: str,
    data: PairData,
    hyper: Hyper,
    state: PairState,
    spec: ModelSpec = ModelSpec(),
):
    """diag(J^T J) without materializing H, from per-edge scatter blocks.

    Retained as an independent oracle for the assembled operator (the live
    large-N path gets its diagonal from ``block_system.diag_of``, whose
    block assembly is structurally different; the two are cross-checked in
    tests/test_parallel.py and tests/test_block_system.py)."""
    n = state.p1.shape[0]
    dim = _tangent_dim(n)
    diag = jnp.zeros((dim,), dtype=state.p1.dtype)
    for L, _, idx in _edge_blocks(cam_kind, data, hyper, state, spec):
        contrib = jnp.einsum("mri,mri->mi", L, L, precision=MATMUL_PRECISION)
        diag = diag.at[idx].add(contrib)
    return diag


# ---------------------------------------------------------------------------
# Solve driver
# ---------------------------------------------------------------------------


# Above this tangent dimension the dense normal equations are not worth
# materializing (dim^2 f32 for H: 4096 -> 67 MB per instance, and the
# Cholesky stops fitting comfortably once the weight search vmaps several
# candidates); the matrix-free CG backend takes over automatically. The
# reference's committed problem size (5174-dim, debug.txt:1-5) lands on the
# CG side.
DENSE_DIM_LIMIT = 4096

# CG iteration cap for the block-sparse PCG path. Block-Jacobi
# preconditioning plus the early tolerance exit (models/block_system.pcg_flex)
# means typical damped trials converge well under the cap.
CG_ITERS = 64
CG_RTOL = 1e-2

# Dense-backend Jacobian budget across a vmapped pair batch. The dense path
# materializes J [R, dim] per pair instance (R = N*(6+K)); vmap multiplies
# that by the batch size, so a batch of large-but-under-DENSE_DIM_LIMIT pairs
# can exceed device memory long before a single pair would. Both limits
# await a sweep on the H100 (ROADMAP, speed item 8).
DENSE_J_BUDGET_BYTES = 2 << 30


def use_dense_backend(n: int, K: int, batch: int = 1) -> bool:
    """Static backend dispatch: dense equilibrated Cholesky vs block-PCG.

    Dense requires BOTH the single-instance tangent dim under
    ``DENSE_DIM_LIMIT`` and the batch-wide Jacobian footprint under
    ``DENSE_J_BUDGET_BYTES`` (the vmapped-serving OOM guard).
    """
    dim = _tangent_dim(n)
    if dim > DENSE_DIM_LIMIT:
        return False
    rows = n * (6 + K) + 2
    return batch * rows * dim * 4 <= DENSE_J_BUDGET_BYTES


@functools.partial(
    jax.jit, static_argnames=("cam_kind", "n_iterations", "spec", "batch_hint")
)
def solve_pair(
    cam_kind: str,
    data: PairData,
    hyper: Hyper,
    state0: PairState,
    n_iterations: int,
    spec: ModelSpec = ModelSpec(),
    batch_hint: int = 1,
) -> lm_ops.LMResult:
    """One ``arapOptimization`` inner solve: n_iterations of LM.

    Backend dispatch is automatic on the (static) problem size: dense
    equilibrated Cholesky while ``use_dense_backend`` holds (tangent dim
    under ``DENSE_DIM_LIMIT`` AND the batch-wide Jacobian under the memory
    budget — ``batch_hint`` is the vmapped batch size when called through
    ``solve_pairs``), block-sparse ELLPACK assembly + block-Jacobi PCG
    otherwise (same damping loop either way, ``ops/lm.py``; system assembly
    in ``models/block_system.py``).
    """
    from . import block_system as bs_

    n = state0.p1.shape[0]
    apply = apply_delta_spec(spec)
    if not use_dense_backend(n, int(data.nbr.shape[-1]), batch_hint):
        make_step = bs_.make_block_step(cam_kind, data, hyper, spec, CG_ITERS, CG_RTOL)
        res = lm_ops.lm_optimize_general(
            make_step,
            robust_cost=lambda s: robust_cost(cam_kind, data, hyper, s, spec),
            apply_delta=apply,
            state0=state0,
            n_iterations=n_iterations,
        )
    else:
        res = lm_ops.lm_optimize(
            build_system=lambda s: build_system(cam_kind, data, hyper, s, spec),
            robust_cost=lambda s: robust_cost(cam_kind, data, hyper, s, spec),
            apply_delta=apply,
            state0=state0,
            n_iterations=n_iterations,
        )
    return res


@functools.partial(jax.jit, static_argnames=("cam_kind", "n_iterations", "spec"))
def solve_pairs(
    cam_kind: str,
    data: PairData,
    hyper: Hyper,
    state0: PairState,
    n_iterations: int,
    spec: ModelSpec = ModelSpec(),
) -> lm_ops.LMResult:
    """Batched multi-pair refinement: every array carries a leading pair axis.

    The reference processes exactly one keyframe pair per run
    (``g2oBundleAdjustment.cc:640-641`` loops over pairs sequentially); a
    serving deployment refines many pairs (e.g. many endoscopy sequences)
    concurrently, so the whole LM solve -- including its sequential trial loop
    (lockstep across the batch under vmap) -- is vmapped over the pair axis. Pairs must share the padded
    shapes (N, K); pad ``valid``/``nbr_mask`` to batch heterogeneous pairs.
    ``hyper`` may be a single Hyper (shared weights) or carry a leading pair
    axis as well.

    Memory: the dense backend materializes the Jacobian J [R, 6N+8] per pair
    (R = N*(6+K); ~40 MB f32 at N=240, K=32 -- see ``build_system``) and
    the batch multiplies that by the batch size, so the backend dispatch here
    is batch-aware: ``use_dense_backend(n, K, batch)`` falls over to the
    block-sparse PCG backend once the batch-wide J footprint would exceed
    ``DENSE_J_BUDGET_BYTES`` (e.g. 16 pairs at N~680 -> ~6 GB dense, so the
    batch runs on PCG instead of OOMing).

    Scheduling: the batch runs under ``lm_optimize_flat_batched``, NOT
    ``vmap(solve_pair)`` -- vmapping the sequential trial while_loop runs it
    in lockstep, charging every pair the batch-max trial count of every
    iteration. The flat driver does one batched damped solve per global step
    with per-pair accept/damping, which reproduces each pair's exact
    sequential (lam, nu, accept) schedule while keeping every solve fully
    batched.
    """
    from . import block_system as bs_

    hyper_axis = None if jnp.ndim(hyper.rep_w) == 0 else 0
    batch = int(data.kp1.shape[0])
    n = int(state0.p1.shape[1])
    K = int(data.nbr.shape[-1])

    cost_b = jax.vmap(
        lambda d, h, s: robust_cost(cam_kind, d, h, s, spec),
        in_axes=(0, hyper_axis, 0),
    )

    if use_dense_backend(n, K, batch):
        build_b = jax.vmap(
            lambda d, h, s: build_system(cam_kind, d, h, s, spec),
            in_axes=(0, hyper_axis, 0),
        )

        def make_step_b(state_b):
            H, g = build_b(data, hyper, state_b)
            diag = jnp.diagonal(H, axis1=-2, axis2=-1)
            solve_b = jax.vmap(lm_ops.solve_damped_cholesky)
            return (lambda lam_b: solve_b(H, g, lam_b)), g, jnp.max(diag, axis=-1)

    else:
        build_b = jax.vmap(
            lambda d, h, s: bs_.build_block_system(cam_kind, d, h, s, spec),
            in_axes=(0, hyper_axis, 0),
        )

        def make_step_b(state_b):
            sys_b = build_b(data, hyper, state_b)
            g = jax.vmap(bs_.flat_gradient)(sys_b)
            diag_max = jax.vmap(lambda s: jnp.max(bs_.diag_of(s)))(sys_b)

            def solve_b(lam_b):
                def one(sys, nbr, gg, lam):
                    mv = lambda v: bs_.block_matvec(sys, nbr, v, lam)
                    return bs_.pcg_flex(
                        mv, -gg, bs_.block_jacobi_apply(sys, lam), CG_ITERS, CG_RTOL
                    )

                return jax.vmap(one)(sys_b, data.nbr, g, lam_b)

            return solve_b, g, diag_max

    res = lm_ops.lm_optimize_flat_batched(
        make_step_b,
        lambda s: cost_b(data, hyper, s),
        apply_delta_spec(spec),
        state0,
        batch,
        n_iterations,
    )
    return res


def solve_pairs_pipelined(
    cam_kind: str,
    datas,
    hyper: Hyper,
    states,
    n_iterations: int,
    spec: ModelSpec = ModelSpec(),
):
    """Host-level serving scheduler: dispatch independent per-pair solves
    back-to-back through the device's in-order queue and let the caller
    sync once. Returns a list of LMResult (one per pair, same order).

    Independent dispatches keep every pair's control flow free (early stop,
    its own trial ladder) and the queue overlaps one pair's host work with
    the next pair's compute. ``solve_pairs`` (flat-batched) is the form
    for a batch that must live inside ONE jit (e.g. under shard_map/pjit
    over a pair axis, or inside a larger compiled graph); its flat driver
    re-linearizes every global step, so each rejection costs a full
    batched assembly. Which of the two serves faster on a given device is
    a benchmark question (ROADMAP, speed item 4).
    """
    return [
        solve_pair(cam_kind, d, hyper, s, n_iterations, spec)
        for d, s in zip(datas, states)
    ]


def make_pair_data(
    kp1,
    kp2,
    depth1,
    depth2,
    valid,
    cam_params,
    T1w,
    T2w,
    p1,
    p2,
    inv_sigma2_1=None,
    inv_sigma2_2=None,
    mesh_backend: str = "auto",
    degree_bucket: int = 32,
    scale_priors=None,
):
    """Host-side assembly: mesh the CURRENT p1 cloud, freeze ARAP rotations.

    Mirrors the per-solve preamble of ``arapOptimization``
    (``g2oBundleAdjustment.cc:652-688``): Delaunay over keyframe-1 positions,
    cot weights, per-vertex rotations from the current two clouds.

    ``scale_priors``: optional (s1_0, info1, s2_0, info2) anchoring the depth
    scales to their round-0 estimates (see the PairData field docs); None
    keeps the reference's unconstrained scale vertices.
    """
    n = len(kp1)
    valid_np = np.asarray(valid, dtype=bool)
    p1_np = np.asarray(p1, dtype=np.float64)
    p2_np = np.asarray(p2, dtype=np.float64)

    # Mesh over valid points only (invalid pairs never enter the reference's
    # map); indices are remapped back to the full padded arrays.
    # K is bucketed so the jitted solver compiles once per bucket, not once
    # per outer round (the mesh max-degree jitters as points move).
    vidx = np.nonzero(valid_np)[0]
    ctx = mesh_ops.build_mesh_context(
        p1_np[vidx], backend=mesh_backend, degree_multiple=degree_bucket
    )
    K = ctx.max_degree
    nbr = np.full((n, K), -1, dtype=np.int32)
    wcot = np.zeros((n, K), dtype=np.float64)
    remap = vidx.astype(np.int32)
    nbr_valid = np.where(ctx.nbr >= 0, remap[np.maximum(ctx.nbr, 0)], -1)
    nbr[vidx] = nbr_valid
    wcot[vidx] = ctx.weights

    nbr_j = jnp.asarray(nbr)
    mask = jnp.asarray(nbr >= 0)
    R = jnp.asarray(arap_ops.compute_rotations_host(p1_np, p2_np, nbr, nbr >= 0, wcot), FP)

    ones = np.ones(n)
    return PairData(
        kp1=jnp.asarray(kp1, dtype=FP),
        kp2=jnp.asarray(kp2, dtype=FP),
        inv_sigma2_1=jnp.asarray(ones if inv_sigma2_1 is None else inv_sigma2_1),
        inv_sigma2_2=jnp.asarray(ones if inv_sigma2_2 is None else inv_sigma2_2),
        depth1=jnp.asarray(depth1, dtype=FP),
        depth2=jnp.asarray(depth2, dtype=FP),
        valid=jnp.asarray(valid_np),
        cam_params=jnp.asarray(cam_params, dtype=FP),
        R1w=jnp.asarray(T1w[0], dtype=FP),
        t1w=jnp.asarray(T1w[1], dtype=FP),
        R2w=jnp.asarray(T2w[0], dtype=FP),
        t2w=jnp.asarray(T2w[1], dtype=FP),
        nbr=nbr_j,
        nbr_mask=mask,
        wcot=jnp.asarray(wcot),
        Ri=R,
        area=jnp.asarray(ctx.surface_area, dtype=FP),
        ntri=jnp.asarray(float(ctx.n_triangles), dtype=FP),
        s1_prior=jnp.asarray(0.0 if scale_priors is None else float(scale_priors[0]), dtype=FP),
        s1_info=jnp.asarray(0.0 if scale_priors is None else float(scale_priors[1]), dtype=FP),
        s2_prior=jnp.asarray(0.0 if scale_priors is None else float(scale_priors[2]), dtype=FP),
        s2_info=jnp.asarray(0.0 if scale_priors is None else float(scale_priors[3]), dtype=FP),
    )
