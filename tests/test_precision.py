"""Every float32 matrix product on the solver and descriptor paths is pinned
to ``precision.MATMUL_PRECISION`` (HIGHEST).

Without it a GPU may run float32 products in TF32 (about three decimal
digits): the refinement step of the damped solve would then undo its own
purpose, and the one-hot descriptor tap select would round the pixel
operand and flip descriptor bits. The check reads the traced program, so it
holds whatever backend the tests run on.
"""

import jax
import jax.extend.core as jex
import jax.numpy as jnp
import numpy as np
import pytest

from tests.test_deformable import make_problem
from tests.test_rigid import HYPER, make_rigid_problem
from triangulation_in_deformable_scenes_tpu.models import block_system as bs
from triangulation_in_deformable_scenes_tpu.models import deformable, rigid
from triangulation_in_deformable_scenes_tpu.ops import features, lm
from triangulation_in_deformable_scenes_tpu.precision import MATMUL_PRECISION


def _sub_jaxprs(value):
    if isinstance(value, jex.ClosedJaxpr):
        yield value.jaxpr
    elif isinstance(value, jex.Jaxpr):
        yield value
    elif isinstance(value, (tuple, list)):
        for v in value:
            yield from _sub_jaxprs(v)


def float32_dot_precisions(jaxpr):
    """(precision, operand shapes) of every float32 dot_general, nested
    jaxprs (jit, scan, while, cond, custom rules) included."""
    found = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            dtypes = {v.aval.dtype for v in eqn.invars}
            if jnp.dtype(jnp.float32) in dtypes:
                found.append((eqn.params["precision"], [v.aval.shape for v in eqn.invars]))
        for value in eqn.params.values():
            for sub in _sub_jaxprs(value):
                found.extend(float32_dot_precisions(sub))
    return found


def assert_all_highest(fn, *args):
    jaxpr = jax.make_jaxpr(fn)(*args).jaxpr
    dots = float32_dot_precisions(jaxpr)
    assert dots, "expected float32 matrix products in the traced program"
    pinned = (MATMUL_PRECISION, MATMUL_PRECISION)
    loose = [(p, shapes) for p, shapes in dots if p != pinned]
    assert not loose, f"{len(loose)} of {len(dots)} float32 products not pinned: {loose[:5]}"


def _f32(tree):
    return jax.tree_util.tree_map(
        lambda x: jnp.asarray(x, jnp.float32) if jnp.issubdtype(jnp.asarray(x).dtype, jnp.floating) else x,
        tree,
    )


@pytest.fixture(scope="module")
def problem():
    data, state0, hyper, _ = make_problem(n_side=4)
    return _f32(data), _f32(state0), _f32(hyper)


def test_dense_build_system_pinned(problem):
    data, state, hyper = problem
    fn = jax.jit(lambda s: deformable.build_system("KB8", data, hyper, s))
    assert_all_highest(fn, state)


def test_build_block_system_pinned(problem):
    data, state, hyper = problem
    fn = jax.jit(lambda s: bs.build_block_system("KB8", data, hyper, s))
    assert_all_highest(fn, state)


def test_block_matvec_pinned(problem):
    data, state, hyper = problem
    sys_ = bs.build_block_system("KB8", data, hyper, state)
    v = jnp.ones((6 * state.p1.shape[0] + 8,), jnp.float32)
    fn = jax.jit(lambda v: bs.block_matvec(sys_, data.nbr, v, 0.5))
    assert_all_highest(fn, v)


def test_solve_damped_cholesky_pinned():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(40, 40)).astype(np.float32)
    H = jnp.asarray(a @ a.T + 40 * np.eye(40, dtype=np.float32))
    g = jnp.asarray(rng.normal(size=40).astype(np.float32))
    assert_all_highest(jax.jit(lm.solve_damped_cholesky), H, g, jnp.float32(1e-3))


def test_orb_descriptors_from_patches_pinned():
    rng = np.random.default_rng(1)
    side = 2 * features.TAP_R + 1
    patches = jnp.asarray(rng.uniform(0, 255, size=(8, side, side)).astype(np.float32))
    angle = jnp.asarray(rng.uniform(0, 360, size=8).astype(np.float32))
    valid = jnp.ones((8,), bool)
    assert_all_highest(jax.jit(features.orb_descriptors_from_patches), patches, angle, valid)


def test_rigid_build_system_pinned():
    data, state, *_ = make_rigid_problem(n_side=4)
    data, hyper = _f32(data), _f32(HYPER)
    rstate = _f32(rigid.RigidState(
        p1=state.p1, s1=state.s1, s2=state.s2, Rr=jnp.eye(3), tr=jnp.zeros(3)))
    fn = jax.jit(lambda s: rigid.build_system_rigid("KB8", data, hyper, s))
    assert_all_highest(fn, rstate)


def test_solve_pair_dense_pinned(problem):
    data, state, hyper = problem
    fn = lambda s: deformable.solve_pair("KB8", data, hyper, s, 2)
    assert_all_highest(fn, state)


def test_block_pcg_solve_pinned(problem):
    data, state, hyper = problem
    step = bs.make_block_step("KB8", data, hyper, deformable.ModelSpec(), 8, 1e-2)

    def fn(s):
        return lm.lm_optimize_general(
            step, lambda x: deformable.robust_cost("KB8", data, hyper, x),
            deformable.apply_delta, s, 2,
        ).cost

    assert_all_highest(fn, state)


@pytest.mark.parametrize("method", ["NRSLAM", "Classic", "DepthMeasurement"])
def test_triangulation_pinned(problem, method):
    from triangulation_in_deformable_scenes_tpu.ops import triangulation as tri

    data, _, _ = problem
    rng = np.random.default_rng(2)
    xn1 = jnp.asarray(np.c_[rng.normal(size=(9, 2)) * 0.1, np.ones(9)].astype(np.float32))
    xn2 = jnp.asarray(np.c_[rng.normal(size=(9, 2)) * 0.1, np.ones(9)].astype(np.float32))
    T1w, T2w = (data.R1w, data.t1w), (data.R2w, data.t2w)
    assert_all_highest(lambda a, b: tri.triangulate(a, b, T1w, T2w, method=method), xn1, xn2)
