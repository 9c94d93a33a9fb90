"""Dual-point non-rigid two-view triangulation, batched over all matches.

The reference's core contribution: each 2D match yields TWO 3D points -- the
landmark's position as seen from keyframe 1 and its deformed position at
keyframe 2 (``Modules/Utils/Geometry.cc:62-230``). Four methods are selected by
config (``useTriangulationMethod``, ``Geometry.cc:216-230``), each with a seed
"location" mode (``inRays`` / ``TwoPoints`` / ``FarPoints``).

Array design: one call triangulates all N matches at once (arrays xn1/xn2 of
shape [N, 3]); the method/location strings are static so the traced graph
contains only the selected branch. Gating (parallax/positive depth) is a
separate mask function, mirroring ``Mapping::isValidParallax``
(``Modules/Mapping/Mapping.cc:351-364``).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..precision import MATMUL_PRECISION
from . import lie

CLASSIC = "Classic"
NRSLAM = "NRSLAM"
ORBSLAM = "ORBSLAM"
DEPTH = "DepthMeasurement"

IN_RAYS = "inRays"
TWO_POINTS = "TwoPoints"
FAR_POINTS = "FarPoints"


def _relative(T1w, T2w):
    """T21 = T2w * T1w^-1 with T = (R, t)."""
    R1, t1 = T1w
    R2, t2 = T2w
    R1i, t1i = lie.inverse(R1, t1)
    return lie.compose(R2, t2, R1i, t1i)


def cos_ray_parallax(a, b):
    """``cosRayParallax`` (``Geometry.cc:30-32``), batched."""
    num = jnp.sum(a * b, axis=-1)
    return num / (jnp.linalg.norm(a, axis=-1) * jnp.linalg.norm(b, axis=-1))


def triangulate_classic(xn1, xn2, T1w, T2w, location):
    """SVD mid-point triangulation (``triangulateClassic``, Geometry.cc:62-101).

    Projects both rays onto the plane orthogonal to the second-smallest
    singular direction of A = M^T (I - t t^T), intersects, and seeds the two
    points per the location mode. Note the reference's TwoPoints branch sets
    BOTH outputs to the camera-1 ray point (``Geometry.cc:89-92``).
    """
    R21, t21 = _relative(T1w, T2w)
    m0 = jnp.einsum("ij,nj->ni", R21, xn1, precision=MATMUL_PRECISION)
    m1 = xn2
    tn = t21 / jnp.linalg.norm(t21)

    m0n = m0 / jnp.linalg.norm(m0, axis=-1, keepdims=True)
    m1n = m1 / jnp.linalg.norm(m1, axis=-1, keepdims=True)
    P = jnp.eye(3, dtype=xn1.dtype) - jnp.outer(tn, tn)
    # A[n] = [m0n; m1n] @ P, shape [N, 2, 3]; smallest-but-one right singular
    # vector == eigvector of A^T A with middle eigenvalue. Use SVD (batched).
    A = jnp.stack(
        [jnp.matmul(m0n, P, precision=MATMUL_PRECISION),
         jnp.matmul(m1n, P, precision=MATMUL_PRECISION)],
        axis=-2,
    )
    _, _, Vt = jnp.linalg.svd(A, full_matrices=True)
    n = Vt[..., 1, :]

    m0p = m0 - jnp.sum(m0 * n, axis=-1, keepdims=True) * n
    m1p = m1 - jnp.sum(m1 * n, axis=-1, keepdims=True) * n

    z = jnp.cross(m1p, m0p)
    z2 = jnp.sum(z * z, axis=-1)
    lam0 = jnp.sum(z * jnp.cross(t21, m1p), axis=-1) / z2
    lam1 = jnp.sum(z * jnp.cross(t21, m0p), axis=-1) / z2

    if location == TWO_POINTS:
        p1 = t21 + lam0[..., None] * m0p
        p2 = p1
    else:
        p1 = t21 + lam0[..., None] * m0
        p2 = lam1[..., None] * m1

    R2i, t2i = lie.inverse(*T2w)
    return lie.apply(R2i, t2i, p1), lie.apply(R2i, t2i, p2)


def triangulate_nrslam(xn1, xn2, T1w, T2w, location):
    """Inverse-depth-weighted midpoint (``triangulateNRSLAM``, Geometry.cc:103-153)."""
    f0 = xn1 / jnp.linalg.norm(xn1, axis=-1, keepdims=True)
    f1 = xn2 / jnp.linalg.norm(xn2, axis=-1, keepdims=True)
    R21, t21 = _relative(T1w, T2w)

    Rf0 = jnp.einsum("ij,nj->ni", R21, f0, precision=MATMUL_PRECISION)
    p = jnp.cross(Rf0, f1)
    q = jnp.cross(Rf0, jnp.broadcast_to(t21, Rf0.shape))
    r = jnp.cross(f1, jnp.broadcast_to(t21, f1.shape))

    pn = jnp.linalg.norm(p, axis=-1)
    qn = jnp.linalg.norm(q, axis=-1)
    rn = jnp.linalg.norm(r, axis=-1)

    lam0 = rn / pn
    lam1 = qn / pn

    point0 = lam0[..., None] * Rf0
    point1 = lam1[..., None] * f1

    # Inverse-depth-weighted midpoint (Geometry.cc:134).
    x1 = (qn / (qn + rn))[..., None] * (t21 + (rn / pn)[..., None] * (Rf0 + f1))

    if location == TWO_POINTS:
        p1 = x1
        p2 = x1
    elif location == FAR_POINTS:
        pt0 = t21 + point0
        p1 = pt0 + (pt0 - x1)
        p2 = point1 + (point1 - x1)
    else:  # inRays
        p1 = t21 + point0
        p2 = point1

    R2i, t2i = lie.inverse(*T2w)
    return lie.apply(R2i, t2i, p1), lie.apply(R2i, t2i, p2)


def triangulate_depth(xn1, xn2, T1w, T2w, location):
    """Back-projection midpoint (``triangulateDepth``, Geometry.cc:189-214).

    Expects xn1/xn2 scaled to metric camera-frame points (ray * depth).
    """
    R21, t21 = _relative(T1w, T2w)
    point0 = lie.apply(R21, t21, xn1)
    point1 = xn2
    x1 = (point0 + point1) / 2.0

    if location == TWO_POINTS:
        p1 = x1
        p2 = x1
    elif location == FAR_POINTS:
        p1 = point0 + (point0 - x1)
        p2 = point1 + (point1 - x1)
    else:
        p1 = point0
        p2 = point1

    R2i, t2i = lie.inverse(*T2w)
    return lie.apply(R2i, t2i, p1), lie.apply(R2i, t2i, p2)


def triangulate_orbslam(xn1, xn2, T1w, T2w, location):
    """DLT triangulation (``triangulateORBSLAM``, Geometry.cc:155-186).

    NOTE: the reference version never writes its outputs and feeds unit rays
    where the DLT rows assume z-normalized coordinates (latent bugs of a dead
    code path we do not replicate); this implementation z-normalizes the rays
    and returns the dehomogenized DLT point for both outputs, which is what
    the surrounding code clearly intends.
    """
    del location
    xn1 = xn1 / xn1[..., 2:3]
    xn2 = xn2 / xn2[..., 2:3]
    R1, t1 = T1w
    R2, t2 = T2w
    P1 = jnp.concatenate([R1, t1[:, None]], axis=1)  # [3, 4]
    P2 = jnp.concatenate([R2, t2[:, None]], axis=1)

    def rows(xn, P):
        return jnp.stack(
            [
                xn[..., 0, None] * P[2] - P[0],
                xn[..., 1, None] * P[2] - P[1],
            ],
            axis=-2,
        )

    A = jnp.concatenate([rows(xn1, P1), rows(xn2, P2)], axis=-2)  # [N, 4, 4]
    _, _, Vt = jnp.linalg.svd(A)
    X = Vt[..., 3, :]
    w = X[..., 3]
    pt = jnp.where(jnp.abs(w)[..., None] > 0, X[..., :3] / jnp.where(w == 0, 1.0, w)[..., None], 0.0)
    return pt, pt


_METHODS = {
    CLASSIC: triangulate_classic,
    NRSLAM: triangulate_nrslam,
    ORBSLAM: triangulate_orbslam,
    DEPTH: triangulate_depth,
}


@functools.partial(jax.jit, static_argnames=("method", "location"))
def triangulate(xn1, xn2, T1w, T2w, method=NRSLAM, location=IN_RAYS):
    """Dispatch mirroring ``useTriangulationMethod`` (Geometry.cc:216-230).

    Jitted with static method/location, so the whole batch triangulation is
    one dispatch instead of one per eager primitive."""
    fn = _METHODS.get(method, triangulate_nrslam)
    return fn(xn1, xn2, T1w, T2w, location)


@jax.jit
def valid_parallax_mask(xn1, xn2, T1w, T2w, x3d_1, x3d_2, min_cos):
    """``Mapping::isValidParallax`` (Mapping.cc:351-364) as a batched mask.

    Requires positive depth of each point in its own camera and
    cos(parallax) <= min_cos (i.e. ENOUGH parallax between the two rays).
    """
    z1 = lie.apply(*T1w, x3d_1)[..., 2]
    z2 = lie.apply(*T2w, x3d_2)[..., 2]
    R1i, _ = lie.inverse(*T1w)
    R2i, _ = lie.inverse(*T2w)
    ray1 = jnp.einsum("ij,nj->ni", R1i, xn1, precision=MATMUL_PRECISION)
    ray2 = jnp.einsum("ij,nj->ni", R2i, xn2, precision=MATMUL_PRECISION)
    cosp = cos_ray_parallax(ray1, ray2)
    return (z1 >= 0.0) & (z2 >= 0.0) & (cosp <= min_cos)
