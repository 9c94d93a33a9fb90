"""Block-sparse Gauss-Newton assembly vs the dense reference operator.

``models/block_system.py`` assembles H = J^T J in ELLPACK block form using
the (i, j)-symmetry of the mesh-edge energies; these tests pin it against the
dense ``deformable.build_system`` H (itself pinned against g2o semantics by
the solver e2e tests) for every model spec in the family.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from tests.test_deformable import make_problem
from triangulation_in_deformable_scenes_tpu.models import block_system, deformable


SPECS = [
    ("ARAP", deformable.MODELS["ARAP"]),
    ("ARAP_NoGlobal", deformable.MODELS["ARAP_NoGlobal"]),
    ("ARAP_OneSet", deformable.MODELS["ARAP_OneSet"]),
    ("ARAP_not_scaled_depth", deformable.MODELS["ARAP_not_scaled_depth"]),
    ("ARAP_depth_onlyTriang", deformable.MODELS["ARAP_depth_onlyTriang"]),
    ("ARAP_squared_depth", deformable.MODELS["ARAP_squared_depth"]),
    ("Elastic", deformable.MODELS["Elastic"]),
    ("HyperElasticOdgen", deformable.MODELS["HyperElasticOdgen"]),
]


@pytest.mark.parametrize("name,spec", SPECS, ids=[s[0] for s in SPECS])
def test_block_matvec_matches_dense(name, spec):
    data, state0, hyper, _ = make_problem(n_side=4)
    n = state0.p1.shape[0]
    dim = 6 * n + 8

    H, g = deformable.build_system("KB8", data, hyper, state0, spec)
    sys = block_system.build_block_system("KB8", data, hyper, state0, spec)

    np.testing.assert_allclose(
        np.asarray(block_system.flat_gradient(sys)), np.asarray(g), rtol=2e-4, atol=1e-7
    )
    np.testing.assert_allclose(
        np.asarray(block_system.diag_of(sys)), np.asarray(jnp.diag(H)), rtol=2e-4, atol=1e-7
    )

    rng = np.random.default_rng(0)
    scale = max(float(jnp.max(jnp.abs(H))), 1.0)
    for _ in range(3):
        v = jnp.asarray(rng.normal(size=(dim,)).astype(np.float32))
        hv_dense = H @ v + 0.5 * v
        hv_block = block_system.block_matvec(sys, data.nbr, v, 0.5)
        np.testing.assert_allclose(
            np.asarray(hv_block), np.asarray(hv_dense), rtol=2e-4, atol=2e-5 * scale
        )


def test_block_jacobi_is_exact_on_decoupled_dims():
    """On the global 8x8 block the preconditioner must invert exactly."""
    data, state0, hyper, _ = make_problem(n_side=4)
    sys = block_system.build_block_system("KB8", data, hyper, state0)
    n = state0.p1.shape[0]
    lam = 0.1
    apply_m = block_system.block_jacobi_apply(sys, lam)
    r = jnp.zeros((6 * n + 8,)).at[6 * n :].set(jnp.arange(1.0, 9.0))
    x = apply_m(r)
    expect = np.linalg.solve(np.asarray(sys.Hg) + lam * np.eye(8), np.arange(1.0, 9.0))
    np.testing.assert_allclose(np.asarray(x[6 * n :]), expect, rtol=1e-5)
    assert float(jnp.abs(x[: 6 * n]).max()) == 0.0


def test_pcg_flex_solves_spd_system():
    rng = np.random.default_rng(1)
    A0 = rng.normal(size=(40, 40))
    A = jnp.asarray(A0 @ A0.T + 40 * np.eye(40), jnp.float32)
    b = jnp.asarray(rng.normal(size=(40,)), jnp.float32)
    x = block_system.pcg_flex(lambda v: A @ v, b, lambda r: r / jnp.diag(A), 100, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(A @ x), np.asarray(b), rtol=1e-3, atol=1e-3)


def test_batch_aware_backend_dispatch(monkeypatch):
    """Dense Cholesky only while the BATCH-wide Jacobian fits the budget;
    big batches of large pairs fall over to the block-PCG backend instead of
    materializing batch x [R, dim] (the vmapped-serving OOM guard)."""
    assert deformable.use_dense_backend(240, 32, batch=1)
    assert deformable.use_dense_backend(240, 32, batch=16)
    # N~680 is under DENSE_DIM_LIMIT alone but ~6 GB of J across 16 pairs.
    assert not deformable.use_dense_backend(680, 32, batch=16)
    assert not deformable.use_dense_backend(1000, 32, batch=1)  # dim limit

    # Functional: force the budget low so a small batch dispatches to PCG,
    # and check the batched solve still descends.
    from tests.test_deformable import make_problem

    data, state0, hyper, _ = make_problem(n_side=4)
    import jax.numpy as jnp
    import jax

    stack = lambda x: jnp.broadcast_to(jnp.asarray(x)[None], (2,) + jnp.shape(jnp.asarray(x)))
    bd = jax.tree_util.tree_map(stack, data)
    bs0 = jax.tree_util.tree_map(stack, state0)
    monkeypatch.setattr(deformable, "DENSE_J_BUDGET_BYTES", 1)
    n = int(data.kp1.shape[0])
    assert not deformable.use_dense_backend(n, int(data.nbr.shape[1]), batch=2)
    res = deformable.solve_pairs("KB8", bd, hyper, bs0, n_iterations=3)
    costs = np.asarray(res.cost)
    assert np.all(np.isfinite(costs))
    assert np.all(costs <= np.asarray(res.initial_cost) * 1.01)


def test_inv6_spd_matches_linalg_inv():
    """Closed-form blocked 6x6 SPD inverse == jnp.linalg.inv on damped SPD
    blocks across a wide dynamic range of scales and dampings."""
    import numpy as np
    import jax.numpy as jnp
    from triangulation_in_deformable_scenes_tpu.models import block_system as bs

    rng = np.random.default_rng(0)
    for scale in (1e-3, 1.0, 1e5):
        J = rng.normal(size=(64, 9, 6)) * scale
        M = jnp.asarray(np.einsum("nra,nrb->nab", J, J))
        for lam in (1e-6 * scale**2, 1.0, 1e3 * scale**2):
            A = M + lam * jnp.eye(6)[None]
            got = np.asarray(bs.inv6_spd(A))
            want = np.linalg.inv(np.asarray(A, np.float64))
            # identity check is scale-free
            eye = np.einsum("nab,nbc->nac", got, np.asarray(A, np.float64))
            err = np.abs(eye - np.eye(6)).max()
            assert err < 5e-4, (scale, lam, err)
            assert np.allclose(got, want, rtol=2e-3, atol=1e-6 / scale**2), (scale, lam)


def _fixture_system(n_side):
    data, state0, hyper, _ = make_problem(n_side=n_side)
    sys_ = block_system.build_block_system("KB8", data, hyper, state0)
    g = block_system.flat_gradient(sys_)
    lam = 1e-4 * float(jnp.max(block_system.diag_of(sys_)))
    return data, state0, hyper, sys_, g, lam


def test_pcg_flex_matches_dense_solve_on_fixture():
    """Block-Jacobi PCG on the assembled fixture operator lands on the
    dense damped solve (numpy f64 of the dense f32 H)."""
    data, state0, hyper, sys_, g, lam = _fixture_system(6)
    mv = lambda v: block_system.block_matvec(sys_, data.nbr, v, lam)
    x = block_system.pcg_flex(mv, -g, block_system.block_jacobi_apply(sys_, lam), 200, rtol=1e-6)
    H, _ = deformable.build_system("KB8", data, hyper, state0)
    A = np.asarray(H, np.float64) + lam * np.eye(H.shape[0])
    want = np.linalg.solve(A, -np.asarray(g, np.float64))
    assert np.linalg.norm(np.asarray(x) - want) / np.linalg.norm(want) < 1e-3
    r = np.asarray(mv(x) + g)
    assert np.linalg.norm(r) <= 1e-4 * float(np.linalg.norm(np.asarray(g)))


def test_pcg_flex_iteration_cap():
    """``iters`` is a hard cap: one iteration is exactly one preconditioned
    steepest-descent step from zero, and zero iterations return zero."""
    data, _, _, sys_, g, lam = _fixture_system(5)
    mv = lambda v: block_system.block_matvec(sys_, data.nbr, v, lam)
    pre = block_system.block_jacobi_apply(sys_, lam)
    b = -g
    x0 = block_system.pcg_flex(mv, b, pre, 0, rtol=1e-12)
    assert float(jnp.max(jnp.abs(x0))) == 0.0
    x1 = block_system.pcg_flex(mv, b, pre, 1, rtol=1e-12)
    z = pre(b)
    step = jnp.dot(b, z) / jnp.dot(z, mv(z))
    np.testing.assert_allclose(np.asarray(x1), np.asarray(step * z), rtol=1e-5, atol=1e-12)
    x64 = block_system.pcg_flex(mv, b, pre, 64, rtol=1e-12)
    assert float(jnp.linalg.norm(mv(x64) - b)) < float(jnp.linalg.norm(mv(x1) - b))
