"""Descriptor matching as dense masked matrix ops.

Rebuilds ``Modules/Matching/DescriptorMatching.cc`` as array ops: instead
of per-keypoint windowed candidate loops with popcount Hamming
(``DescriptorMatching.cc:22-99``), the full N1 x N2 Hamming matrix is one
matmul over 0/1 bit vectors (a GEMM the BLAS library runs), and the
grid-window / octave constraints become additive masks.

``search_for_initialization`` mirrors the live matcher
(``searchForInitializaion``): finest-octave reference keys, a radius
window scaled by the key's octave, best/second-best ratio 0.9, absolute
threshold, plus the reference's implicit one-to-one constraint (a current
key can win at most one reference key; ties resolved by distance).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..precision import MATMUL_PRECISION

BIG = 1_000_000.0


def hamming_matrix(bits_a, bits_b):
    """[N1, 256] x [N2, 256] 0/1 bits -> [N1, N2] Hamming distances.

    H(a, b) = sum(a) + sum(b) - 2 a.b : a single matmul plus rank-1
    corrections. The operands are 0/1 and the 256-bit dot is an integer
    <= 256, so bf16 inputs with f32 accumulation are EXACT whatever the
    matmul route, and run at the bf16 tensor-core rate.
    """
    a = bits_a.astype(jnp.bfloat16)
    b = bits_b.astype(jnp.bfloat16)
    dots = jax.lax.dot_general(
        a, b, (((1,), (1,)), ((), ())), preferred_element_type=jnp.float32
    )
    sa = jnp.sum(a.astype(jnp.float32), axis=-1)
    sb = jnp.sum(b.astype(jnp.float32), axis=-1)
    return sa[:, None] + sb[None, :] - 2.0 * dots


def search_for_initialization(
    kp_ref,
    desc_ref,
    octave_ref,
    valid_ref,
    kp_cur,
    desc_cur,
    octave_cur,
    valid_cur,
    scale_factors,
    th: float = 50.0,
    window_factor: float = 50.0,
    ratio: float = 0.9,
    max_octave: int = 0,
):
    """Returns (matches [N1] int32 with -1 for unmatched, n_matches).

    Parity with ``searchForInitializaion`` (DescriptorMatching.cc:39-99):
    only reference keys with octave <= max_octave participate; candidates
    must lie within ``window_factor * scale_factor[octave]`` pixels and in
    octave [o-1, o+1].
    """
    D = hamming_matrix(desc_ref, desc_cur)  # [N1, N2]

    oct_r = octave_ref
    radius = window_factor * scale_factors[jnp.clip(oct_r, 0, len(scale_factors) - 1)]
    d2 = jnp.sum((kp_ref[:, None, :] - kp_cur[None, :, :]) ** 2, axis=-1)
    in_window = d2 <= (radius**2)[:, None]
    oct_ok = (octave_cur[None, :] >= (oct_r - 1)[:, None]) & (
        octave_cur[None, :] <= (oct_r + 1)[:, None]
    )
    row_ok = (oct_r <= max_octave) & valid_ref
    allowed = in_window & oct_ok & row_ok[:, None] & valid_cur[None, :]

    Dm = jnp.where(allowed, D, BIG)
    best, best_d, second_d = _best_second_best(Dm)
    ok = (best_d <= th) & (best_d < second_d * ratio)
    return _one_to_one(best, best_d, ok, Dm.shape[1])


def _best_second_best(Dm):
    """Per-row best index/distance and second-best distance of a masked
    distance matrix (BIG on disallowed entries)."""
    best = jnp.argmin(Dm, axis=1)
    best_d = jnp.min(Dm, axis=1)
    second_d = jnp.min(
        jnp.where(jnp.arange(Dm.shape[1])[None, :] == best[:, None], BIG, Dm), axis=1
    )
    return best, best_d, second_d


def _one_to_one(best, best_d, ok, n2):
    """Resolve row->column conflicts by keeping the smallest distance (the
    C++ matchers' vnMatches21 bookkeeping).

    Implemented as a one-hot masked min-reduce over [N1, N2+1] rather than
    a scatter-min with duplicate indices: one bandwidth-bound pass, and the
    result does not depend on the order in which duplicates are combined.
    """
    best_safe = jnp.where(ok, best, n2)  # park invalid rows on a dummy column
    onehot = jnp.arange(n2 + 1)[None, :] == best_safe[:, None]  # [n1, n2+1]
    col_min = jnp.min(
        jnp.where(onehot, jnp.where(ok, best_d, BIG)[:, None], BIG), axis=0
    )
    keep = ok & (best_d <= col_min[best_safe])
    return jnp.where(keep, best, -1).astype(jnp.int32), jnp.sum(keep.astype(jnp.int32))


def guided_matching(
    proj_uv,
    mp_desc,
    mp_octave,
    mp_valid,
    kp_cur,
    desc_cur,
    octave_cur,
    valid_cur,
    scale_factors,
    th: float = 50.0,
    window_factor: float = 1.0,
    ratio: float = 0.9,
):
    """``guidedMatching`` (DescriptorMatching.cc:101-162), batched.

    ``proj_uv`` are the map points projected into the current frame; the
    search radius is 15 * window_factor * scale_factor[octave] and candidates
    must lie within one octave of the point's last observation.
    """
    D = hamming_matrix(mp_desc, desc_cur)
    radius = 15.0 * window_factor * scale_factors[jnp.clip(mp_octave, 0, len(scale_factors) - 1)]
    d2 = jnp.sum((proj_uv[:, None, :] - kp_cur[None, :, :]) ** 2, axis=-1)
    oct_ok = (octave_cur[None, :] >= (mp_octave - 1)[:, None]) & (
        octave_cur[None, :] <= (mp_octave + 1)[:, None]
    )
    allowed = (
        (d2 <= (radius**2)[:, None]) & oct_ok & mp_valid[:, None] & valid_cur[None, :]
    )
    Dm = jnp.where(allowed, D, BIG)
    best, best_d, second_d = _best_second_best(Dm)
    ok = (best_d <= th) & (best_d < second_d * ratio)
    return _one_to_one(best, best_d, ok, Dm.shape[1])


def search_with_projection(
    proj_uv,
    mp_desc,
    mp_valid,
    view_cos,
    dist,
    min_dist_inv,
    max_dist_inv,
    kp_cur,
    desc_cur,
    octave_cur,
    valid_cur,
    scale_factors,
    th: float = 100.0,
    ratio: float = 0.9,
):
    """``searchWithProjection`` (DescriptorMatching.cc:164-254), batched.

    Local-map tracking matcher: view-angle gate (cos >= 0.5), distance within
    the point's scale-invariance range, octave predicted from the distance,
    and a view-angle-dependent radius (2.5x when nearly frontal, 4x else).
    """
    n_scales = len(scale_factors)
    log_sf = jnp.log(scale_factors[1]) if n_scales > 1 else jnp.asarray(1.0)
    pred_octave = jnp.clip(
        jnp.ceil(jnp.log(max_dist_inv / jnp.maximum(dist, 1e-12)) / log_sf), 0, n_scales - 1
    ).astype(jnp.int32)
    radius = scale_factors[pred_octave] * jnp.where(view_cos > 0.998, 2.5, 4.0)

    gate = (
        mp_valid
        & (view_cos >= 0.5)
        & (dist >= min_dist_inv)
        & (dist <= max_dist_inv)
    )
    D = hamming_matrix(mp_desc, desc_cur)
    d2 = jnp.sum((proj_uv[:, None, :] - kp_cur[None, :, :]) ** 2, axis=-1)
    oct_ok = (octave_cur[None, :] >= (pred_octave - 1)[:, None]) & (
        octave_cur[None, :] <= (pred_octave + 1)[:, None]
    )
    allowed = (d2 <= (radius**2)[:, None]) & oct_ok & gate[:, None] & valid_cur[None, :]
    Dm = jnp.where(allowed, D, BIG)
    best, best_d, second_d = _best_second_best(Dm)
    ok = (best_d <= th) & (best_d < second_d * ratio)
    return _one_to_one(best, best_d, ok, Dm.shape[1])


def search_for_triangulation(
    desc1,
    desc2,
    rays1,
    rays2,
    E,
    free1,
    free2,
    th: float = 50.0,
    epipolar_th: float = 0.002,
):
    """``searchForTriangulation`` (DescriptorMatching.cc:255-328), batched.

    Epipolar-constrained matching between two keyframes over features not yet
    associated with a map point (``free`` masks). The reference applies a
    hard 50 cap before its threshold and keeps best-per-row under the
    epipolar gate; its one-to-one bookkeeping is replicated by the
    column-minimum pass (the C++ version's ``vbMatched2[bestDist]`` index bug
    is NOT reproduced).
    """
    D = hamming_matrix(desc1, desc2)
    r1h = jnp.matmul(rays1, E.T, precision=MATMUL_PRECISION)
    r1h = r1h / jnp.linalg.norm(r1h, axis=-1, keepdims=True)
    r2n = rays2 / jnp.linalg.norm(rays2, axis=-1, keepdims=True)
    ang = jnp.arccos(jnp.clip(jnp.matmul(r1h, r2n.T, precision=MATMUL_PRECISION), -1.0, 1.0))
    epi_ok = jnp.abs(jnp.pi / 2 - ang) < epipolar_th
    allowed = (D <= 50.0) & epi_ok & free1[:, None] & free2[None, :]
    Dm = jnp.where(allowed, D, BIG)
    best, best_d, _ = _best_second_best(Dm)
    ok = best_d < th
    return _one_to_one(best, best_d, ok, Dm.shape[1])


def fuse_matching(
    proj_uv,
    mp_desc,
    mp_octave,
    mp_valid,
    kp_kf,
    desc_kf,
    octave_kf,
    valid_kf,
    scale_factors,
    th: float = 50.0,
    ratio: float = 0.9,
):
    """Matching stage of ``fuse`` (DescriptorMatching.cc:330-427): project
    candidate map points into a keyframe, radius 2.5 * scale_factor[octave].
    The caller merges/adds observations via WorldMap.fuse_map_points."""
    D = hamming_matrix(mp_desc, desc_kf)
    radius = 2.5 * scale_factors[jnp.clip(mp_octave, 0, len(scale_factors) - 1)]
    d2 = jnp.sum((proj_uv[:, None, :] - kp_kf[None, :, :]) ** 2, axis=-1)
    oct_ok = (octave_kf[None, :] >= (mp_octave - 1)[:, None]) & (
        octave_kf[None, :] <= (mp_octave + 1)[:, None]
    )
    allowed = (d2 <= (radius**2)[:, None]) & oct_ok & mp_valid[:, None] & valid_kf[None, :]
    Dm = jnp.where(allowed, D, BIG)
    best, best_d, second_d = _best_second_best(Dm)
    ok = (best_d <= th) & (best_d < second_d * ratio)
    return jnp.where(ok, best, -1).astype(jnp.int32), jnp.sum(ok.astype(jnp.int32))


def essential_from_pose(R12, t12):
    """E = [t]x R for the relative transform T12 (``Geometry.cc:239-256``)."""
    tx = jnp.array(
        [
            [0.0, -t12[2], t12[1]],
            [t12[2], 0.0, -t12[0]],
            [-t12[1], t12[0], 0.0],
        ],
        dtype=R12.dtype,
    )
    return jnp.matmul(tx, R12, precision=MATMUL_PRECISION)


def epipolar_inliers(E, rays_ref, rays_cur, th):
    """Angular epipolar test (``MonocularMapInitializer::computeScoreAndInliers``):
    |pi/2 - angle(E r1, r2)| < th."""
    r1h = jnp.matmul(rays_ref, E.T, precision=MATMUL_PRECISION)
    r1h = r1h / jnp.linalg.norm(r1h, axis=-1, keepdims=True)
    r2n = rays_cur / jnp.linalg.norm(rays_cur, axis=-1, keepdims=True)
    ang = jnp.arccos(jnp.clip(jnp.sum(r1h * r2n, axis=-1), -1.0, 1.0))
    return jnp.abs(jnp.pi / 2 - ang) < th
