"""Pose-unknown two-view initialization: batched 8-point + RANSAC + E decomposition.

The reference keeps a full pose-recovery path in ``MonocularMapInitializer``
(``Modules/Mapping/MonocularMapInitializer.cc:119-279``) even though its live
dataset pipelines feed ground-truth poses: 8-point ``computeE`` (:180-203),
``decomposeE`` (:264-279), ``reconstructCameras`` with a cheirality-voted
translation sign (:246-262), and a cluster-sampled RANSAC consensus loop
(:119-178, one sample per kmeans cluster of the reference keypoints).

Array design: every RANSAC hypothesis is materialized up front -- cluster
assignment is a fixed-iteration Lloyd k-means (batched), per-hypothesis
8-point minimal sets are gathered with ``jax.random.categorical`` over the
cluster masks, the 8-point solve is a vmapped [B, 8, 9] SVD, and all
hypotheses are scored against all matches in one [B, N] angular-epipolar
evaluation followed by an argmax -- no data-dependent loop, no early exit
(the reference's ``computeMaxTries(0.8, 0.95)`` = 17 iterations bounds B).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..precision import FP, MATMUL_PRECISION, TINY
from . import lie
from .matching import epipolar_inliers


def compute_essential_8pt(ref_rays, cur_rays):
    """Batched 8-point algorithm on bearing rays.

    ``ref_rays``/``cur_rays``: [..., 8, 3] unit rays. Returns E [..., 3, 3].
    Parity with ``computeE`` (MonocularMapInitializer.cc:180-203): rows of A
    are ``ref_i * cur_i[c]`` for c in (0, 1, 2), the singular vector of the
    smallest singular value reshaped ROW-major, rank-2 projection via
    diag(1, 1, 0), and the reference's trailing negation.
    """
    A = jnp.concatenate(
        [ref_rays * cur_rays[..., 0:1], ref_rays * cur_rays[..., 1:2], ref_rays * cur_rays[..., 2:3]],
        axis=-1,
    )  # [..., 8, 9]
    _, _, Vt = jnp.linalg.svd(A, full_matrices=True)
    E = Vt[..., 8, :].reshape(*A.shape[:-2], 3, 3)
    U, s, Vt3 = jnp.linalg.svd(E)
    s2 = jnp.stack([jnp.ones_like(s[..., 0]), jnp.ones_like(s[..., 0]), jnp.zeros_like(s[..., 0])], axis=-1)
    Ef = jnp.matmul(U, s2[..., :, None] * Vt3, precision=MATMUL_PRECISION)
    return -Ef


def decompose_essential(E):
    """E -> (R1, R2, t), parity with ``decomposeE`` (:264-279).

    Both rotations are det-fixed; t is U's third column, normalized.
    """
    U, _, Vt = jnp.linalg.svd(E)
    W = jnp.asarray([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], dtype=E.dtype)
    R1 = jnp.matmul(jnp.matmul(U, W.T, precision=MATMUL_PRECISION), Vt, precision=MATMUL_PRECISION)
    R2 = jnp.matmul(jnp.matmul(U, W, precision=MATMUL_PRECISION), Vt, precision=MATMUL_PRECISION)
    det1 = jnp.linalg.det(R1)
    det2 = jnp.linalg.det(R2)
    R1 = R1 * jnp.where(det1 < 0, -1.0, 1.0)[..., None, None]
    R2 = R2 * jnp.where(det2 < 0, -1.0, 1.0)[..., None, None]
    t = U[..., :, 2]
    t = t / jnp.maximum(jnp.linalg.norm(t, axis=-1, keepdims=True), TINY)
    return R1, R2, t


def reconstruct_cameras(E, rays1, rays2):
    """Recover the relative pose (R, t) of camera 2 from E + the matched rays.

    Parity with ``reconstructCameras`` (:246-262): of the two rotations keep
    the smaller one (larger trace); resolve the translation sign with the
    reference's vectorized cheirality vote
    ``sum(sign((R r1 - r2) . (r2 - t)))`` -- negative vote flips t.
    """
    R1, R2, t = decompose_essential(E)
    tr1 = jnp.trace(R1, axis1=-2, axis2=-1)
    tr2 = jnp.trace(R2, axis1=-2, axis2=-1)
    R = jnp.where((tr2 > tr1)[..., None, None], R2, R1)
    moved = jnp.einsum("...ij,...nj->...ni", R, rays1, precision=MATMUL_PRECISION) - rays2
    away = jnp.sum(jnp.sign(jnp.sum(moved * (rays2 - t[..., None, :]), axis=-1)), axis=-1)
    t = jnp.where((away < 0)[..., None], -t, t)
    return R, t


def _kmeans(xy, valid, k, iters, key):
    """Fixed-iteration Lloyd k-means over valid keypoint positions [N, 2].

    Replaces ``cv::kmeans`` in the RANSAC sampler (:130-136): exact
    replication of OpenCV's clustering is not needed -- any spatially
    stratified partition serves the sampler's purpose (minimal sets spread
    across the image). Invalid points get a label but never contribute to
    the center updates.
    """
    n = xy.shape[0]
    vm = valid.astype(xy.dtype)
    p = vm / jnp.maximum(jnp.sum(vm), 1.0)
    init_idx = jax.random.choice(key, n, shape=(k,), replace=False, p=p)
    centers = xy[init_idx]

    def step(centers, _):
        d2 = jnp.sum((xy[:, None, :] - centers[None, :, :]) ** 2, axis=-1)  # [N, k]
        labels = jnp.argmin(d2, axis=-1)
        onehot = jax.nn.one_hot(labels, k, dtype=xy.dtype) * vm[:, None]  # [N, k]
        counts = jnp.sum(onehot, axis=0)
        sums = jnp.matmul(onehot.T, xy, precision=MATMUL_PRECISION)  # [k, 2]
        new_centers = jnp.where(counts[:, None] > 0, sums / jnp.maximum(counts, 1.0)[:, None], centers)
        return new_centers, None

    centers, _ = jax.lax.scan(step, centers, None, length=iters)
    d2 = jnp.sum((xy[:, None, :] - centers[None, :, :]) ** 2, axis=-1)
    return jnp.argmin(d2, axis=-1)  # [N]


@functools.partial(jax.jit, static_argnames=("n_hypotheses", "k_clusters"))
def ransac_essential(
    kp_ref,
    ref_rays,
    cur_rays,
    valid,
    key,
    epipolar_th: float = 0.01,
    n_hypotheses: int = 17,
    k_clusters: int = 8,
):
    """Cluster-sampled RANSAC over batched 8-point hypotheses.

    ``kp_ref`` [N, 2] pixel positions (for spatial clustering), rays [N, 3]
    unit bearing vectors, ``valid`` [N] bool. Returns (E [3, 3],
    inliers [N] bool, n_inliers). ``n_hypotheses`` defaults to the
    reference's ``computeMaxTries(0.8, 0.95)`` = 17 (:115-118,141).
    """
    n = kp_ref.shape[0]
    k_key, s_key = jax.random.split(key)
    labels = _kmeans(kp_ref.astype(FP), valid, k_clusters, 8, k_key)

    # One sample per cluster per hypothesis (uniform over the cluster's valid
    # members; empty clusters fall back to a uniform valid draw).
    member = (labels[None, :] == jnp.arange(k_clusters)[:, None]) & valid[None, :]  # [k, N]
    logits = jnp.where(member, 0.0, -jnp.inf)
    logits = jnp.where(
        jnp.any(member, axis=1, keepdims=True), logits, jnp.where(valid[None, :], 0.0, -jnp.inf)
    )
    idx = jax.random.categorical(
        s_key, jnp.broadcast_to(logits, (n_hypotheses, k_clusters, n)), axis=-1
    )  # [B, k]

    E = compute_essential_8pt(ref_rays[idx], cur_rays[idx])  # [B, 3, 3]

    def score(Eb):
        inl = epipolar_inliers(Eb, ref_rays, cur_rays, epipolar_th) & valid
        return jnp.sum(inl.astype(jnp.int32)), inl

    scores, inliers = jax.vmap(score)(E)
    best = jnp.argmax(scores)
    return E[best], inliers[best], scores[best]


def initialize_pose_free(kp_ref, ref_rays, cur_rays, valid, key, epipolar_th: float = 0.01):
    """Full pose-unknown bootstrap: RANSAC E -> (R21, t21) + inlier mask.

    The returned pose maps camera-1 coordinates to camera-2 coordinates
    (T21), defined up to the monocular scale of ``t``. Mirrors the
    ``reconstructEnvironment`` flow (MonocularMapInitializer.cc:225-244).
    """
    E, inliers, n_inliers = ransac_essential(
        kp_ref, ref_rays, cur_rays, valid, key, epipolar_th=epipolar_th
    )
    w = inliers.astype(ref_rays.dtype)[:, None]
    # Cheirality vote over inliers only (the reference recomputes rays for
    # inliers; masking is the fixed-shape equivalent).
    R, t = reconstruct_cameras(E, ref_rays * w, cur_rays * w)
    return R, t, inliers, n_inliers
