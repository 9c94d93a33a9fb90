import jax.numpy as jnp
import numpy as np

from triangulation_in_deformable_scenes_tpu.ops import arap, lie, mesh


def make_surface(n_side=6, seed=0):
    rng = np.random.default_rng(seed)
    xs, ys = np.meshgrid(np.linspace(0, 0.1, n_side), np.linspace(0, 0.1, n_side))
    xy = np.stack([xs.ravel(), ys.ravel()], axis=-1)
    xy += rng.normal(scale=0.002, size=xy.shape)
    z = 0.2 + 0.01 * np.sin(xy[:, 0] * 40)
    return np.concatenate([xy, z[:, None]], axis=-1)


def test_compute_rotations_identity_when_rigid_translation():
    p1 = make_surface()
    p2 = p1 + np.array([0.01, -0.02, 0.005])
    ctx = mesh.build_mesh_context(p1)
    R = arap.compute_rotations(
        jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(ctx.nbr), jnp.asarray(ctx.nbr_mask), jnp.asarray(ctx.weights)
    )
    np.testing.assert_allclose(np.asarray(R), np.broadcast_to(np.eye(3), R.shape), atol=2e-5)


def test_compute_rotations_recovers_global_rotation():
    p1 = make_surface(seed=1)
    w = np.array([0.2, -0.1, 0.3])
    Q = np.asarray(lie.so3_exp(jnp.asarray(w)))
    p2 = p1 @ Q.T
    ctx = mesh.build_mesh_context(p1)
    R = arap.compute_rotations(
        jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(ctx.nbr), jnp.asarray(ctx.nbr_mask), jnp.asarray(ctx.weights)
    )
    np.testing.assert_allclose(np.asarray(R), np.broadcast_to(Q, R.shape), atol=2e-5)


def test_arap_energy_zero_for_rigid_motion_with_matching_global():
    """A rigid motion p2 = Q p1 + c has zero ARAP deformation energy, and the
    global term vanishes when (Rg, tg) satisfies Rg p2 - tg = p1."""
    p1 = make_surface(seed=2)
    w = np.array([0.05, 0.02, -0.04])
    Q = np.asarray(lie.so3_exp(jnp.asarray(w)))
    c = np.array([0.01, 0.0, -0.02])
    p2 = p1 @ Q.T + c
    ctx = mesh.build_mesh_context(p1)
    R = arap.compute_rotations(
        jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(ctx.nbr), jnp.asarray(ctx.nbr_mask), jnp.asarray(ctx.weights)
    )
    # Global alignment: p1 = Q^T p2 - Q^T c -> Rg = Q^T, tg = Q^T c.
    Rg = Q.T
    tg = Q.T @ c
    E = arap.arap_edge_energy(
        jnp.asarray(p1),
        jnp.asarray(p2),
        R,
        jnp.asarray(ctx.nbr),
        jnp.asarray(ctx.nbr_mask),
        jnp.asarray(ctx.weights),
        ctx.surface_area,
        jnp.asarray(Rg),
        jnp.asarray(tg),
    )
    np.testing.assert_allclose(np.asarray(E), 0.0, atol=2e-5)


def test_arap_energy_positive_for_nonrigid():
    p1 = make_surface(seed=3)
    p2 = p1.copy()
    p2[:, 2] += 0.01 * np.sin(p1[:, 0] * 120)  # non-rigid wobble
    ctx = mesh.build_mesh_context(p1)
    R = arap.compute_rotations(
        jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(ctx.nbr), jnp.asarray(ctx.nbr_mask), jnp.asarray(ctx.weights)
    )
    E = arap.arap_edge_energy(
        jnp.asarray(p1),
        jnp.asarray(p2),
        R,
        jnp.asarray(ctx.nbr),
        jnp.asarray(ctx.nbr_mask),
        jnp.asarray(ctx.weights),
        ctx.surface_area,
        jnp.eye(3),
        jnp.zeros(3),
    )
    assert float(jnp.sum(E)) > 0
    # padding slots contribute exactly zero
    assert float(jnp.sum(jnp.where(jnp.asarray(ctx.nbr_mask), 0.0, E))) == 0.0


def test_relative_edge_errors_zero_for_translation():
    p1 = make_surface(seed=4)
    p2 = p1 + np.array([0.0, 0.01, 0.0])
    ctx = mesh.build_mesh_context(p1)
    err = arap.relative_edge_errors(
        jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(ctx.nbr), jnp.asarray(ctx.nbr_mask)
    )
    np.testing.assert_allclose(np.asarray(err), 0.0, atol=2e-5)


def test_host_rotations_match_device_rotations():
    """The float64 host snapshot and the f32 device kernel agree wherever
    the neighbourhood determines the rotation."""
    p1 = make_surface(seed=3)
    w = np.array([0.1, -0.2, 0.05])
    Q = np.asarray(lie.so3_exp(jnp.asarray(w)))
    rng = np.random.default_rng(3)
    p2 = p1 @ Q.T + rng.normal(scale=5e-4, size=p1.shape)
    ctx = mesh.build_mesh_context(p1)
    R_dev = np.asarray(arap.compute_rotations(
        jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(ctx.nbr), jnp.asarray(ctx.nbr_mask),
        jnp.asarray(ctx.weights)))
    R_host = arap.compute_rotations_host(p1, p2, ctx.nbr, ctx.nbr_mask, ctx.weights)
    np.testing.assert_allclose(R_host, R_dev, atol=1e-4)
    np.testing.assert_allclose(np.linalg.det(R_host), 1.0, atol=1e-12)


def test_host_rotations_identity_without_neighbours():
    p1 = make_surface(seed=4)
    ctx = mesh.build_mesh_context(p1)
    mask = np.asarray(ctx.nbr_mask).copy()
    mask[0] = False
    R = arap.compute_rotations_host(p1, p1 + 0.01, ctx.nbr, mask, ctx.weights)
    np.testing.assert_array_equal(R[0], np.eye(3))
