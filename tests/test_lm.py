import jax
import jax.numpy as jnp
import numpy as np
import pytest

from triangulation_in_deformable_scenes_tpu.ops import lm


def test_lm_solves_linear_least_squares():
    """On a linear problem LM must land on the normal-equation solution."""
    rng = np.random.default_rng(0)
    A = jnp.asarray(rng.normal(size=(30, 8)))
    b = jnp.asarray(rng.normal(size=30))
    x_star = np.linalg.lstsq(np.asarray(A), np.asarray(b), rcond=None)[0]

    def build_system(x):
        r = A @ x - b
        return A.T @ A, A.T @ r

    def cost(x):
        r = A @ x - b
        return r @ r

    res = lm.lm_optimize(build_system, cost, lambda x, d: x + d, jnp.zeros(8), n_iterations=10)
    np.testing.assert_allclose(np.asarray(res.state), x_star, atol=2e-5)
    assert float(res.cost) <= float(res.initial_cost)
    assert int(res.n_accepted) >= 1


def test_lm_rosenbrock_descends():
    """Non-convex smoke test: cost strictly decreases and stays finite."""

    def residuals(x):
        return jnp.array([10.0 * (x[1] - x[0] ** 2), 1.0 - x[0]])

    J = jax.jacfwd(residuals)

    def build_system(x):
        r = residuals(x)
        Jx = J(x)
        return Jx.T @ Jx, Jx.T @ r

    def cost(x):
        r = residuals(x)
        return r @ r

    x0 = jnp.array([-1.2, 1.0])
    res = lm.lm_optimize(build_system, cost, lambda x, d: x + d, x0, n_iterations=50)
    assert float(res.cost) < 1e-10  # converges to (1, 1)
    np.testing.assert_allclose(np.asarray(res.state), [1.0, 1.0], atol=1e-5)


def test_lm_jit_compatible():
    A = jnp.asarray(np.random.default_rng(1).normal(size=(10, 3)))
    b = jnp.asarray(np.random.default_rng(2).normal(size=10))

    @jax.jit
    def solve():
        return lm.lm_optimize(
            lambda x: (A.T @ A, A.T @ (A @ x - b)),
            lambda x: jnp.sum((A @ x - b) ** 2),
            lambda x, d: x + d,
            jnp.zeros(3),
            n_iterations=5,
        )

    res = solve()
    assert np.isfinite(float(res.cost))


def test_speculative_trials_match_sequential_policy():
    """The dense backend's speculative trial batch must follow the same
    accept/damping policy as the sequential loop (lm_optimize_general with
    the dense make_step)."""
    rng = np.random.default_rng(3)
    A = rng.normal(size=(30, 8))
    b = rng.normal(size=(30,))

    def build_system(x):
        r = jnp.asarray(A) @ x - jnp.asarray(b)
        J = jnp.asarray(A)
        return J.T @ J, J.T @ r

    def cost(x):
        r = jnp.asarray(A) @ x - jnp.asarray(b)
        return jnp.dot(r, r)

    x0 = jnp.zeros(8)
    spec = lm.lm_optimize_speculative(
        build_system, cost, lambda x, d: x + d, x0, n_iterations=12
    )

    def make_step(state):
        H, g = build_system(state)
        return (lambda l: lm.solve_damped_cholesky(H, g, l)), g, jnp.max(jnp.diag(H))

    seq = lm.lm_optimize_general(make_step, cost, lambda x, d: x + d, x0, n_iterations=12)
    np.testing.assert_allclose(float(spec.cost), float(seq.cost), rtol=1e-4, atol=1e-6)
    assert int(spec.n_accepted) == int(seq.n_accepted)
    np.testing.assert_allclose(np.asarray(spec.state), np.asarray(seq.state), rtol=1e-3, atol=1e-5)


def test_flat_batched_matches_per_pair_sequential_policy():
    """lm_optimize_flat_batched must reproduce EACH pair's sequential
    (lam, accept-count, optimum) schedule exactly: a rejection is one
    global step where that pair's state holds while its damping grows --
    the same trial ladder lm_optimize_general walks per pair. Uses
    nonlinear per-pair problems with different conditioning so trial
    counts genuinely differ across the batch."""
    rng = np.random.default_rng(5)
    batch, m, d = 4, 20, 6
    As = jnp.asarray(rng.normal(size=(batch, m, d)) * (10.0 ** rng.uniform(-1, 1, size=(batch, 1, 1))))
    bs = jnp.asarray(rng.normal(size=(batch, m)))

    def resid(A, b, x):
        return A @ x + 0.3 * jnp.sin(x).sum() - b

    def cost_one(A, b, x):
        r = resid(A, b, x)
        return jnp.dot(r, r)

    def build_one(A, b, x):
        J = jax.jacfwd(lambda y: resid(A, b, y))(x)
        r = resid(A, b, x)
        return J.T @ J, J.T @ r

    x0 = jnp.zeros((batch, d))

    def make_step_b(xb):
        Hg = [build_one(As[i], bs[i], xb[i]) for i in range(batch)]
        H = jnp.stack([h for h, _ in Hg])
        g = jnp.stack([gg for _, gg in Hg])
        solve_b = jax.vmap(lm.solve_damped_cholesky)
        return (lambda lam_b: solve_b(H, g, lam_b)), g, jnp.max(
            jnp.diagonal(H, axis1=-2, axis2=-1), axis=-1)

    res_b = lm.lm_optimize_flat_batched(
        make_step_b,
        lambda xb: jnp.stack([cost_one(As[i], bs[i], xb[i]) for i in range(batch)]),
        lambda x, dd: x + dd,
        x0, batch, n_iterations=10,
    )

    for i in range(batch):
        def make_step(x, i=i):
            H, g = build_one(As[i], bs[i], x)
            return (lambda l: lm.solve_damped_cholesky(H, g, l)), g, jnp.max(jnp.diag(H))

        seq = lm.lm_optimize_general(
            make_step, lambda x, i=i: cost_one(As[i], bs[i], x),
            lambda x, dd: x + dd, x0[i], n_iterations=10,
        )
        assert int(res_b.n_accepted[i]) == int(seq.n_accepted), i
        np.testing.assert_allclose(float(res_b.cost[i]), float(seq.cost), rtol=1e-5, atol=1e-8)
        np.testing.assert_allclose(float(res_b.lam[i]), float(seq.lam), rtol=1e-4)
        np.testing.assert_allclose(np.asarray(res_b.state[i]), np.asarray(seq.state), rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("dim", [300, 728])
def test_damped_cholesky_matches_float64_solve(dim):
    """The equilibrated f32 Cholesky + one refinement step against numpy's
    f64 solve of the same damped system, with diagonal scales spread over
    eight decades so the equilibration has to engage."""
    from triangulation_in_deformable_scenes_tpu.ops.lm import solve_damped_cholesky

    rng = np.random.default_rng(0)
    A = rng.normal(size=(dim, dim)).astype(np.float32)
    H = A @ A.T + dim * np.eye(dim, dtype=np.float32)
    d = 10.0 ** rng.uniform(-3, 5, size=dim).astype(np.float32)
    H = (H * d[:, None] * d[None, :]).astype(np.float32)
    g = (rng.normal(size=dim) * d).astype(np.float32)
    lam = np.float32(H.diagonal().max() * 1e-6)

    x = np.asarray(solve_damped_cholesky(jnp.asarray(H), jnp.asarray(g), lam), np.float64)
    A64 = H.astype(np.float64) + np.float64(lam) * np.eye(dim)
    want = np.linalg.solve(A64, -g.astype(np.float64))
    # Per-coordinate relative error: the scales span eight decades, so a
    # norm-wise bound would only see the largest coordinates.
    assert np.max(np.abs(x - want) / np.abs(want).clip(1e-30)) < 1e-3
    assert np.linalg.norm(x - want) / np.linalg.norm(want) < 1e-5
