"""Classic bundle adjustment: full BA, pose-only, and local BA.

The reference retains these Mini-SLAM optimizers alongside the deformable
solver (``Modules/Optimization/g2oBundleAdjustment.cc:38-444``; they have no
call sites in the shipped pipelines but are part of the optimization module's
surface). Rebuilt here on the same batched LM core as the deformable solver:

- ``bundle_adjustment``: joint poses+points, Huber delta = sqrt(5.99)
  (``:57``), keyframe 0 fixed (``:69-71``), 20 LM iterations (``:123``);
- ``pose_only_optimization``: 4 rounds of 10 iterations with chi2 > 5.991
  outlier deactivation between rounds (``:140-243``), returns the pose and
  the inlier count;
- ``local_bundle_adjustment``: BA over a keyframe's covisibility
  neighborhood with boundary keyframes fixed, followed by removal of
  observations with chi2 > 5.991 (``:245-444``).

Observations are fixed-shape arrays (kf index, point index, pixel,
information, validity mask); the tangent is [poses (6K), points (3M)] with
fixed poses masked out of the linearization.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import camera as cam_ops
from ..ops import lie
from ..ops import lm as lm_ops
from ..precision import FP, MATMUL_PRECISION, TINY

HUBER_BA = float(np.sqrt(5.99))  # thHuber2D (g2oBundleAdjustment.cc:57)
CHI2_OUTLIER = 5.991


class BAData(NamedTuple):
    obs_kf: jnp.ndarray  # [E] int32 keyframe index per observation
    obs_mp: jnp.ndarray  # [E] int32 point index
    obs_uv: jnp.ndarray  # [E, 2]
    obs_info: jnp.ndarray  # [E] invSigma2
    obs_valid: jnp.ndarray  # [E] bool
    cam_params: jnp.ndarray
    fixed_pose: jnp.ndarray  # [K] bool


class BAState(NamedTuple):
    R: jnp.ndarray  # [K, 3, 3] world-to-camera
    t: jnp.ndarray  # [K, 3]
    points: jnp.ndarray  # [M, 3]


def _apply_delta(state: BAState, delta: jnp.ndarray) -> BAState:
    K = state.R.shape[0]
    M = state.points.shape[0]
    dxi = delta[: 6 * K].reshape(K, 6)
    dp = delta[6 * K : 6 * K + 3 * M].reshape(M, 3)
    dR, dt = lie.se3_exp(dxi)
    R = jnp.matmul(dR, state.R, precision=MATMUL_PRECISION)
    t = jnp.einsum("kij,kj->ki", dR, state.t, precision=MATMUL_PRECISION) + dt
    return BAState(R=R, t=t, points=state.points + dp)


def _errors(cam_kind, data: BAData, state: BAState):
    p = state.points[data.obs_mp]
    R = state.R[data.obs_kf]
    t = state.t[data.obs_kf]
    pc = jnp.einsum("eij,ej->ei", R, p, precision=MATMUL_PRECISION) + t
    proj = cam_ops.project(cam_kind, data.cam_params, pc)
    return data.obs_uv - proj


def _chi2(cam_kind, data, state):
    e = _errors(cam_kind, data, state)
    return jnp.sum(e * e, axis=-1) * data.obs_info


def _huber(chi2, delta):
    d2 = delta * delta
    sqrt_c = jnp.sqrt(jnp.maximum(chi2, TINY))
    rho = jnp.where(chi2 <= d2, chi2, 2.0 * delta * sqrt_c - d2)
    drho = jnp.where(chi2 <= d2, 1.0, delta / sqrt_c)
    return rho, drho


def _cost(cam_kind, data, state, robust):
    chi2 = _chi2(cam_kind, data, state)
    vm = data.obs_valid
    if robust:
        rho, _ = _huber(chi2, HUBER_BA)
        return jnp.sum(jnp.where(vm, rho, 0.0))
    return jnp.sum(jnp.where(vm, chi2, 0.0))


def _build_system(cam_kind, data: BAData, state: BAState, robust):
    K = state.R.shape[0]
    M = state.points.shape[0]
    dim = 6 * K + 3 * M
    E = data.obs_kf.shape[0]
    dtype = state.points.dtype

    chi2 = _chi2(cam_kind, data, state)
    if robust:
        _, drho = _huber(chi2, HUBER_BA)
    else:
        drho = jnp.ones_like(chi2)
    w = jnp.sqrt(drho * data.obs_info) * data.obs_valid.astype(dtype)
    # Fixed poses contribute no pose derivative.
    pose_free = (~data.fixed_pose[data.obs_kf]).astype(dtype)

    R0 = state.R[data.obs_kf]
    t0 = state.t[data.obs_kf]
    p0 = state.points[data.obs_mp]

    def local(x, R, t, p, uv, wi, pf):
        xi, dp = x[:6], x[6:9]
        dR, dt = lie.se3_exp(xi * pf)
        Rk = jnp.matmul(dR, R, precision=MATMUL_PRECISION)
        tk = jnp.matmul(dR, t, precision=MATMUL_PRECISION) + dt
        pc = jnp.matmul(Rk, p + dp, precision=MATMUL_PRECISION) + tk
        return wi * (uv - cam_ops.project(cam_kind, data.cam_params, pc))

    x0 = jnp.zeros((E, 9), dtype=dtype)
    L = jax.vmap(jax.jacfwd(local), in_axes=(0, 0, 0, 0, 0, 0, 0))(
        x0, R0, t0, p0, data.obs_uv, w, pose_free
    )  # [E, 2, 9]
    r = jax.vmap(local)(x0, R0, t0, p0, data.obs_uv, w, pose_free)

    idx_pose = 6 * data.obs_kf[:, None] + jnp.arange(6)[None, :]
    idx_pt = 6 * K + 3 * data.obs_mp[:, None] + jnp.arange(3)[None, :]
    idx = jnp.concatenate([idx_pose, idx_pt], axis=-1)  # [E, 9]

    H = jnp.zeros((dim, dim), dtype=dtype)
    g = jnp.zeros((dim,), dtype=dtype)
    Hblk = jnp.einsum("eri,erj->eij", L, L, precision=MATMUL_PRECISION)
    gblk = jnp.einsum("eri,er->ei", L, r, precision=MATMUL_PRECISION)
    H = H.at[idx[:, :, None], idx[:, None, :]].add(Hblk)
    g = g.at[idx].add(gblk)
    return H, g


@functools.partial(jax.jit, static_argnames=("cam_kind", "n_iterations", "robust"))
def bundle_adjustment(
    cam_kind: str,
    data: BAData,
    state0: BAState,
    n_iterations: int = 20,
    robust: bool = True,
) -> lm_ops.LMResult:
    """Full BA (``bundleAdjustment``, g2oBundleAdjustment.cc:38-138)."""
    return lm_ops.lm_optimize(
        build_system=lambda s: _build_system(cam_kind, data, s, robust),
        robust_cost=lambda s: _cost(cam_kind, data, s, robust),
        apply_delta=_apply_delta,
        state0=state0,
        n_iterations=n_iterations,
    )


def pose_only_optimization(cam_kind, cam_params, points, kps, inv_sigma2, R0, t0, valid=None):
    """``poseOnlyOptimization`` (g2oBundleAdjustment.cc:140-243): optimize one
    camera pose against fixed points; 4 rounds of 10 iterations with chi2
    culling at 5.991 between rounds. Returns (R, t, inlier_mask)."""
    n = len(points)
    valid = np.ones(n, dtype=bool) if valid is None else np.asarray(valid, dtype=bool)
    inliers = jnp.asarray(valid)

    data = BAData(
        obs_kf=jnp.zeros(n, dtype=jnp.int32),
        obs_mp=jnp.arange(n, dtype=jnp.int32),
        obs_uv=jnp.asarray(kps, dtype=FP),
        obs_info=jnp.asarray(inv_sigma2, dtype=FP),
        obs_valid=inliers,
        cam_params=jnp.asarray(cam_params, dtype=FP),
        fixed_pose=jnp.zeros(1, dtype=bool),
    )
    state = BAState(
        R=jnp.asarray(R0, dtype=FP)[None],
        t=jnp.asarray(t0, dtype=FP)[None],
        points=jnp.asarray(points, dtype=FP),
    )

    for round_i in range(4):
        # Points stay fixed: zero their tangent by marking every observation's
        # point... points are per-observation unique here, so freeze them by
        # running BA with a point-fixing trick: huge prior would change H; we
        # instead rebuild the system with the point block dropped via a wrapped
        # state where points are constants.
        def build(s):
            H, g = _build_system(cam_kind, data._replace(obs_valid=inliers), s, robust=True)
            # keep only the 6x6 pose block (points frozen)
            return H[:6, :6], g[:6]

        def cost(s):
            return _cost(cam_kind, data._replace(obs_valid=inliers), s, robust=True)

        def apply(s, delta6):
            full = jnp.concatenate([delta6, jnp.zeros(3 * n, dtype=delta6.dtype)])
            return _apply_delta(s, full)

        res = lm_ops.lm_optimize(build, cost, apply, state, n_iterations=10)
        state = res.state
        chi2 = np.asarray(_chi2(cam_kind, data, state))
        inliers = jnp.asarray(valid & (chi2 <= CHI2_OUTLIER))

    return np.asarray(state.R[0]), np.asarray(state.t[0]), np.asarray(inliers)


def local_bundle_adjustment(world_map, kf_id: int, cam_kind: str, cam_params, n_iterations=20):
    """``localBundleAdjustment`` (g2oBundleAdjustment.cc:245-444): BA over the
    covisibility neighborhood of ``kf_id`` with boundary keyframes fixed,
    then removal of observations whose chi2 exceeds 5.991.

    Mutates ``world_map`` (poses, point positions, culled observations).
    Returns (n_edges, n_removed).
    """
    local_mps, local_kfs, fixed_kfs = world_map.local_map_of_keyframe(kf_id)
    kf_ids = sorted(local_kfs) + sorted(fixed_kfs)
    kf_index = {k: i for i, k in enumerate(kf_ids)}
    mp_ids = sorted(local_mps)
    mp_index = {m: i for i, m in enumerate(mp_ids)}

    obs = []
    for m in mp_ids:
        for k, feat_idx in world_map.mp_obs[m].items():
            if k in kf_index:
                obs.append((kf_index[k], mp_index[m], k, m, feat_idx))
    if not obs:
        return 0, 0

    kfs = [world_map.keyframes[k] for k in kf_ids]
    sf = kfs[0].scale_factor
    uv = np.array([kfs[o[0]].kp[o[4]] for o in obs])
    info = np.array([1.0 / sf ** (2 * int(kfs[o[0]].octave[o[4]])) for o in obs])

    data = BAData(
        obs_kf=jnp.asarray([o[0] for o in obs], dtype=jnp.int32),
        obs_mp=jnp.asarray([o[1] for o in obs], dtype=jnp.int32),
        obs_uv=jnp.asarray(uv, dtype=FP),
        obs_info=jnp.asarray(info, dtype=FP),
        obs_valid=jnp.ones(len(obs), dtype=bool),
        cam_params=jnp.asarray(cam_params, dtype=FP),
        # Fix boundary KFs and keyframe 0 (the reference fixes both).
        fixed_pose=jnp.asarray([(k in fixed_kfs) or (k == 0) for k in kf_ids]),
    )
    state0 = BAState(
        R=jnp.asarray(np.stack([kf.R_cw for kf in kfs])),
        t=jnp.asarray(np.stack([kf.t_cw for kf in kfs])),
        points=jnp.asarray(np.stack([world_map.map_points[m].position for m in mp_ids])),
    )
    res = bundle_adjustment(cam_kind, data, state0, n_iterations=n_iterations)

    # Write back + outlier removal.
    for i, k in enumerate(kf_ids):
        if not bool(data.fixed_pose[i]):
            world_map.keyframes[k].R_cw = np.asarray(res.state.R[i])
            world_map.keyframes[k].t_cw = np.asarray(res.state.t[i])
    for m, i in mp_index.items():
        world_map.map_points[m].position = np.asarray(res.state.points[i])

    chi2 = np.asarray(_chi2(cam_kind, data, res.state))
    n_removed = 0
    for o, c in zip(obs, chi2):
        if c > CHI2_OUTLIER:
            world_map.remove_observation(o[2], o[3])
            n_removed += 1
    return len(obs), n_removed
