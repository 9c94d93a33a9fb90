"""Batched camera models: Kannala-Brandt fisheye (KB8) and pinhole.

Reference: ``Modules/Calibration/KannalaBrandt8.cc`` and ``PinHole.cc``. Both
are rebuilt as pure functions over parameter arrays so projection of N points
is one fused vectorized op instead of N virtual calls. The reference always
constructs KB8 as the primary model (``Modules/System/Settings.cc:50``) from
``Camera.d0..d3`` (which default to 0 when absent from the YAML, making the
model an equidistant fisheye), with a pinhole secondary for metric helpers.

Parameters layout (matching ``Settings.cc:47``): [fx, fy, cx, cy, k0..k3];
pinhole uses the first four entries.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

_KB8_NEWTON_ITERS = 10  # reference uses 10 Newton steps (KannalaBrandt8.cc:64)


def kb8_project(params, p3d):
    """KB8 projection of camera-frame points p3d[..., 3] -> pixels [..., 2].

    Parity with ``KannalaBrandt8::project`` (``KannalaBrandt8.cc:32-49``):
    theta = atan2(r, z), radial poly theta + k0 t^3 + k1 t^5 + k2 t^7 + k3 t^9.
    """
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    k = params[4:8]
    x, y, z = p3d[..., 0], p3d[..., 1], p3d[..., 2]
    r2 = x * x + y * y
    r = jnp.sqrt(r2)
    theta = jnp.arctan2(r, z)
    t2 = theta * theta
    d = theta * (1.0 + t2 * (k[0] + t2 * (k[1] + t2 * (k[2] + t2 * k[3]))))
    # d * cos(psi) = d * x / r; guard r ~ 0 (principal ray).
    safe_r = jnp.where(r > 0, r, 1.0)
    u = fx * d * jnp.where(r > 0, x / safe_r, 0.0) + cx
    v = fy * d * jnp.where(r > 0, y / safe_r, 0.0) + cy
    return jnp.stack([u, v], axis=-1)


def kb8_unproject(params, pix):
    """KB8 unprojection to unit-ish rays [..., 3] (z = cos(theta)).

    Parity with ``KannalaBrandt8::unproject`` (``KannalaBrandt8.cc:51-83``):
    Newton iterations invert the radial polynomial; the returned ray is
    (sin(t) x/td, sin(t) y/td, cos(t)), already unit-norm.
    """
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    k = params[4:8]
    mx = (pix[..., 0] - cx) / fx
    my = (pix[..., 1] - cy) / fy
    theta_d = jnp.sqrt(mx * mx + my * my)

    def newton_step(_, theta):
        t2 = theta * theta
        t4, t6, t8 = t2 * t2, t2 * t2 * t2, t2 * t2 * t2 * t2
        f = theta * (1 + k[0] * t2 + k[1] * t4 + k[2] * t6 + k[3] * t8) - theta_d
        fp = 1 + 3 * k[0] * t2 + 5 * k[1] * t4 + 7 * k[2] * t6 + 9 * k[3] * t8
        return theta - f / fp

    theta = jax.lax.fori_loop(0, _KB8_NEWTON_ITERS, newton_step, theta_d)
    safe_td = jnp.where(theta_d > 1e-8, theta_d, 1.0)
    sin_t = jnp.sin(theta)
    rx = jnp.where(theta_d > 1e-8, sin_t * mx / safe_td, 0.0)
    ry = jnp.where(theta_d > 1e-8, sin_t * my / safe_td, 0.0)
    rz = jnp.where(theta_d > 1e-8, jnp.cos(theta), 1.0)
    return jnp.stack([rx, ry, rz], axis=-1)


def pinhole_project(params, p3d):
    """``PinHole::project``: u = fx x/z + cx."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    z = p3d[..., 2]
    u = fx * p3d[..., 0] / z + cx
    v = fy * p3d[..., 1] / z + cy
    return jnp.stack([u, v], axis=-1)


def pinhole_unproject(params, pix):
    """``PinHole::unproject``: ray ((u-cx)/fx, (v-cy)/fy, 1)."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    rx = (pix[..., 0] - cx) / fx
    ry = (pix[..., 1] - cy) / fy
    return jnp.stack([rx, ry, jnp.ones_like(rx)], axis=-1)


def kb8_project_jac(params, p3d):
    """Analytic d(projection)/d(camera point): [..., 2, 3].

    Parity with ``KannalaBrandt8::projectJac`` (``KannalaBrandt8.cc:85-114``)
    and bit-parity-tested against ``jax.jacfwd(kb8_project)``
    (tests/test_camera.py). Exists because the vmapped 3-wide jacfwd of the
    projection inside the Hessian assembly blocked XLA fusion across the
    whole assembly graph.
    """
    fx, fy = params[0], params[1]
    k = params[4:8]
    x, y, z = p3d[..., 0], p3d[..., 1], p3d[..., 2]
    r2 = x * x + y * y
    r = jnp.sqrt(r2)
    R2 = r2 + z * z
    theta = jnp.arctan2(r, z)
    t2 = theta * theta
    d = theta * (1.0 + t2 * (k[0] + t2 * (k[1] + t2 * (k[2] + t2 * k[3]))))
    dp = 1.0 + t2 * (3.0 * k[0] + t2 * (5.0 * k[1] + t2 * (7.0 * k[2] + t2 * 9.0 * k[3])))
    pos = r > 0
    safe_r = jnp.where(pos, r, 1.0)
    safe_r3 = safe_r * safe_r * safe_r
    cx_ = jnp.where(pos, x / safe_r, 0.0)  # cos(psi)
    cy_ = jnp.where(pos, y / safe_r, 0.0)  # sin(psi)
    # dtheta/d(x, y, z)
    th_x = jnp.where(pos, z * x / (safe_r * R2), 0.0)
    th_y = jnp.where(pos, z * y / (safe_r * R2), 0.0)
    th_z = -r / R2
    # d(x/r)/dx = y^2/r^3, d(x/r)/dy = -xy/r^3 (and symmetrically for y/r)
    g_xx = jnp.where(pos, y * y / safe_r3, 0.0)
    g_xy = jnp.where(pos, -x * y / safe_r3, 0.0)
    g_yy = jnp.where(pos, x * x / safe_r3, 0.0)
    du_dx = fx * (dp * th_x * cx_ + d * g_xx)
    du_dy = fx * (dp * th_y * cx_ + d * g_xy)
    du_dz = fx * (dp * th_z * cx_)
    dv_dx = fy * (dp * th_x * cy_ + d * g_xy)
    dv_dy = fy * (dp * th_y * cy_ + d * g_yy)
    dv_dz = fy * (dp * th_z * cy_)
    row_u = jnp.stack([du_dx, du_dy, du_dz], axis=-1)
    row_v = jnp.stack([dv_dx, dv_dy, dv_dz], axis=-1)
    return jnp.stack([row_u, row_v], axis=-2)


def pinhole_project_jac(params, p3d):
    """Analytic pinhole projection Jacobian (``PinHole.cc:25-70``)."""
    fx, fy = params[0], params[1]
    x, y, z = p3d[..., 0], p3d[..., 1], p3d[..., 2]
    inv_z = 1.0 / z
    zero = jnp.zeros_like(x)
    row_u = jnp.stack([fx * inv_z, zero, -fx * x * inv_z * inv_z], axis=-1)
    row_v = jnp.stack([zero, fy * inv_z, -fy * y * inv_z * inv_z], axis=-1)
    return jnp.stack([row_u, row_v], axis=-2)


# Camera model dispatch kept static (resolved at trace time): the model kind
# is a config constant, never data-dependent.
KB8 = "KB8"
PINHOLE = "PinHole"

_PROJECT = {KB8: kb8_project, PINHOLE: pinhole_project}
_UNPROJECT = {KB8: kb8_unproject, PINHOLE: pinhole_unproject}
_PROJECT_JAC = {KB8: kb8_project_jac, PINHOLE: pinhole_project_jac}


@functools.partial(jax.jit, static_argnames=("kind",))
def project(kind, params, p3d):
    return _PROJECT[kind](params, p3d)


@functools.partial(jax.jit, static_argnames=("kind",))
def unproject(kind, params, pix):
    return _UNPROJECT[kind](params, pix)


@functools.partial(jax.jit, static_argnames=("kind",))
def project_jac(kind, params, p3d):
    """Analytic d(project)/d(camera point), [..., 2, 3]."""
    return _PROJECT_JAC[kind](params, p3d)


def undistort_points(params, distortion, pix, iters: int = 5):
    """Radial-tangential keypoint undistortion, ``cv::undistortPoints``
    semantics with P = K (``Frame::undistortKeys``, Frame.cc:252-277).

    ``distortion`` = (k1, k2, p1, p2[, k3]); the inverse distortion is the
    standard fixed-point compensation iteration (OpenCV runs 5 rounds under
    its default termination criteria). Returns undistorted pixels, same
    shape as ``pix``.
    """
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    k1, k2, p1, p2 = distortion[0], distortion[1], distortion[2], distortion[3]
    k3 = distortion[4] if len(distortion) > 4 else 0.0

    x0 = (pix[..., 0] - cx) / fx
    y0 = (pix[..., 1] - cy) / fy
    x, y = x0, y0
    for _ in range(iters):  # static trip count: unrolled under jit
        r2 = x * x + y * y
        icdist = 1.0 / (1.0 + ((k3 * r2 + k2) * r2 + k1) * r2)
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x = (x0 - dx) * icdist
        y = (y0 - dy) * icdist
    return jnp.stack([x * fx + cx, y * fy + cy], axis=-1)
