"""SO(3)/SE(3) operations on batched arrays.

The reference uses Sophus SE3f/SO3d objects threaded through an object graph
(``Modules/Mapping/Frame.h:33``, ``Modules/Optimization/g2oTypes.h:96-124``).
Here a rigid transform is a plain pair of arrays ``(R[..., 3, 3], t[..., 3])``
so every operation vmaps/shards trivially. ``exp``/``log`` follow the usual
(omega, upsilon) tangent ordering used by g2o's ``SE3Quat::exp`` (rotation
first), which is the retraction of the global-alignment vertex
(``g2oBundleAdjustment.cc:701-706``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..precision import MATMUL_PRECISION

# Numerically-safe threshold for small-angle series expansions.
_EPS = 1e-12


def _mm(a, b):
    return jnp.matmul(a, b, precision=MATMUL_PRECISION)


def _mv(M, v):
    """Batched matrix-vector product M[..., i, j] v[..., j]."""
    return jnp.einsum("...ij,...j->...i", M, v, precision=MATMUL_PRECISION)


def hat(w):
    """so(3) hat operator: w[..., 3] -> skew-symmetric [..., 3, 3]."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zeros = jnp.zeros_like(wx)
    return jnp.stack(
        [
            jnp.stack([zeros, -wz, wy], axis=-1),
            jnp.stack([wz, zeros, -wx], axis=-1),
            jnp.stack([-wy, wx, zeros], axis=-1),
        ],
        axis=-2,
    )


def so3_exp(w):
    """Rodrigues formula, w[..., 3] -> R[..., 3, 3]; stable at theta ~ 0."""
    theta2 = jnp.sum(w * w, axis=-1)
    theta = jnp.sqrt(theta2 + _EPS)
    # sin(t)/t and (1-cos(t))/t^2 with series fallback near zero.
    use_series = theta2 < 1e-8
    a = jnp.where(use_series, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    b = jnp.where(use_series, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / (theta2 + _EPS))
    W = hat(w)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + a[..., None, None] * W + b[..., None, None] * _mm(W, W)


def so3_log(R):
    """R[..., 3, 3] -> w[..., 3]. Standard log map, stable near identity."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = jnp.clip((trace - 1.0) / 2.0, -1.0, 1.0)
    theta = jnp.arccos(cos_t)
    vee = jnp.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        axis=-1,
    )
    small = theta < 1e-6
    scale = jnp.where(small, 0.5 + theta**2 / 12.0, theta / (2.0 * jnp.sin(jnp.where(small, 1.0, theta))))
    return scale[..., None] * vee


def se3_exp(xi):
    """se(3) exp with tangent xi = (omega[3], upsilon[3]) -> (R, t).

    Rotation-first ordering matches g2o's ``SE3Quat::exp`` used by the
    ``VertexSE3Expmap`` retraction in the reference optimizer.
    """
    w, v = xi[..., :3], xi[..., 3:]
    theta2 = jnp.sum(w * w, axis=-1)
    theta = jnp.sqrt(theta2 + _EPS)
    use_series = theta2 < 1e-8
    R = so3_exp(w)
    W = hat(w)
    # V = I + (1-cos)/t^2 W + (t - sin t)/t^3 W^2
    b = jnp.where(use_series, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / (theta2 + _EPS))
    c = jnp.where(
        use_series, 1.0 / 6.0 - theta2 / 120.0, (theta - jnp.sin(theta)) / (theta2 * theta + _EPS)
    )
    eye = jnp.broadcast_to(jnp.eye(3, dtype=xi.dtype), R.shape)
    V = eye + b[..., None, None] * W + c[..., None, None] * _mm(W, W)
    t = _mv(V, v)
    return R, t


def compose(Ra, ta, Rb, tb):
    """(Ra, ta) * (Rb, tb): apply b first, then a."""
    return _mm(Ra, Rb), _mv(Ra, tb) + ta


def inverse(R, t):
    Rt = jnp.swapaxes(R, -1, -2)
    return Rt, -_mv(Rt, t)


def apply(R, t, p):
    """Transform points p[..., 3]."""
    return _mv(R, p) + t


def look_at(camera_pos, target_pos, up=None):
    """Rotation whose columns are (right, up, forward) world-frame axes.

    Behavioral parity with ``SLAM::lookAt`` (``Modules/System/SLAM.cc:340-351``),
    which the simulation uses to orient the second camera at the first moved
    point; the resulting matrix is used directly as the world-to-camera
    rotation of T2w (``SLAM.cc:229-231``) -- a reference convention we keep.
    """
    if up is None:
        # Reference default: +Y unit vector (``SLAM.h:96``).
        up = jnp.array([0.0, 1.0, 0.0], dtype=camera_pos.dtype)
    forward = target_pos - camera_pos
    forward = forward / jnp.linalg.norm(forward)
    right = jnp.cross(up, forward)
    right = right / jnp.linalg.norm(right)
    up2 = jnp.cross(forward, right)
    up2 = up2 / jnp.linalg.norm(up2)
    return jnp.stack([right, up2, forward], axis=-1)


def kabsch(p_src, p_dst, weights=None):
    """Best-fit rotation/translation between point sets (batched-safe).

    Mirrors ``EstimateRotationAndTranslation`` (``Geometry.cc:510-547``):
    H = sum centered_src . centered_dst^T, R = V U^T with det fix, and the
    reference's (unusual) translation convention t = R.c_dst - c_src.
    """
    if weights is None:
        weights = jnp.ones(p_src.shape[:-1], dtype=p_src.dtype)
    wsum = jnp.sum(weights, axis=-1, keepdims=True)
    c_src = jnp.sum(weights[..., None] * p_src, axis=-2) / wsum
    c_dst = jnp.sum(weights[..., None] * p_dst, axis=-2) / wsum
    a = p_src - c_src[..., None, :]
    b = p_dst - c_dst[..., None, :]
    H = jnp.einsum("...n,...ni,...nj->...ij", weights, a, b, precision=MATMUL_PRECISION)
    R = fit_rotation(H)
    t = _mv(R, c_dst) - c_src
    return R, t


def fit_rotation(H):
    """Closest rotation (polar factor) of H[..., 3, 3] via SVD: R = V U^T.

    Shared by Kabsch and the per-vertex ARAP rotations ``computeR``
    (``Geometry.cc:549-604``), including the det<0 column flip.
    """
    U, _, Vt = jnp.linalg.svd(H)
    V = jnp.swapaxes(Vt, -1, -2)
    R = _mm(V, jnp.swapaxes(U, -1, -2))
    det = jnp.linalg.det(R)
    # Flip last column of U when improper (reference flips U.col(2)).
    U_fix = U.at[..., :, 2].multiply(jnp.where(det < 0, -1.0, 1.0)[..., None])
    return _mm(V, jnp.swapaxes(U_fix, -1, -2))


def quat_to_matrix(q):
    """Unit quaternion (x, y, z, w) -> rotation matrix (dataset loaders)."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    n = x * x + y * y + z * z + w * w
    s = jnp.where(n > 0, 2.0 / n, 0.0)
    xx, yy, zz = x * x * s, y * y * s, z * z * s
    xy, xz, yz = x * y * s, x * z * s, y * z * s
    wx, wy, wz = w * x * s, w * y * s, w * z * s
    return jnp.stack(
        [
            jnp.stack([1.0 - (yy + zz), xy - wz, xz + wy], axis=-1),
            jnp.stack([xy + wz, 1.0 - (xx + zz), yz - wx], axis=-1),
            jnp.stack([xz - wy, yz + wx, 1.0 - (xx + yy)], axis=-1),
        ],
        axis=-2,
    )
