"""Batched Levenberg-Marquardt with g2o-parity damping semantics.

Replaces the reference's ``g2o::OptimizationAlgorithmLevenberg`` +
``BlockSolverX`` + ``LinearSolverEigen`` stack
(``Modules/Optimization/g2oBundleAdjustment.cc:618-630``) with a fixed-shape,
jittable solver:

- damping: lambda0 = tau * max(diag(H)) with tau = 1e-5 (g2o default),
  accept => lambda *= max(1/3, 1 - (2 rho - 1)^3), nu = 2,
  reject => lambda *= nu, nu *= 2, up to ``max_trials`` retries per iteration
  (g2o's ``maxTrialsAfterFailure``); an iteration whose trials all fail ends
  the optimization, like g2o's LM loop.
- gain ratio rho = (F0 - F1) / (delta . (lambda delta - g)).
- the normal equations are solved densely in f32: the damped system is
  Jacobi-equilibrated to unit diagonal before the Cholesky factorization and
  the solution is polished with one iterative-refinement step, whose
  residual ``A x`` is computed in full f32 (``precision.MATMUL_PRECISION``;
  a TF32 residual would undo the refinement). The equilibrated + refined
  f32 solve recovers the accuracy an unscaled f64 factorization gives at
  these condition numbers; whether a plain f64 solve should replace it is
  an open design question (see ``precision.py``). The block-sparse PCG backend for
  large problems lives in ``models/block_system.py``; the sharded wiring in
  ``parallel/``.

The caller provides three pure functions over an opaque state pytree, so this
file knows nothing about cameras or ARAP:

- build_system(state) -> (H, g): the Gauss-Newton normal equations at
  ``state`` with robust weights frozen at the linearization point (g2o
  robustifies the information matrix with rho'(chi2) the same way);
- robust_cost(state) -> scalar: the full robustified chi2 (for accept/reject);
- apply_delta(state, delta) -> state: the retraction.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from ..precision import FP, MATMUL_PRECISION, TINY


def solve_damped_cholesky(H, g, lam):
    """Solve (H + lam I) x = -g by equilibrated Cholesky + one refinement.

    Padded tangent coordinates (all-zero rows of H) stay well-posed because
    the damping puts ``lam`` on their diagonal.
    """
    A = H + lam * jnp.eye(H.shape[0], dtype=H.dtype)
    s = jax.lax.rsqrt(jnp.maximum(jnp.diagonal(A), TINY))
    As = A * s[:, None] * s[None, :]
    L, low = jax.scipy.linalg.cho_factor(As, lower=True)

    def solve(rhs):
        return s * jax.scipy.linalg.cho_solve((L, low), rhs * s)

    x = solve(-g)
    # One iterative-refinement step against the unfactored A.
    x = x + solve(-g - jnp.matmul(A, x, precision=MATMUL_PRECISION))
    return x


class LMResult(NamedTuple):
    state: object
    cost: jnp.ndarray
    initial_cost: jnp.ndarray
    lam: jnp.ndarray
    n_accepted: jnp.ndarray


def lm_optimize_general(
    make_step: Callable,
    robust_cost: Callable,
    apply_delta: Callable,
    state0,
    n_iterations: int,
    tau: float = 1e-5,
    max_trials: int = 10,
) -> LMResult:
    """The one LM damping loop shared by every solver backend.

    ``make_step(state) -> (solve, g, diag_max)`` linearizes at ``state`` and
    returns ``solve(lam) -> delta`` (the damped-system solve), the gradient
    ``g`` (for the gain ratio), and ``diag_max`` (for g2o's initial-lambda
    rule lambda0 = tau * max diag H). Dense-Cholesky and matrix-free-CG
    backends plug in here (``lm_optimize`` /
    ``models/block_system.make_block_step``).
    """
    F0_init = robust_cost(state0)

    def iteration(carry, _):
        state, lam, nu, F, stop = carry

        def run(operand):
            state, lam, nu, F = operand
            solve, g, diag_max = make_step(state)
            lam0 = jnp.where(lam < 0, tau * diag_max, lam)

            def trial_cond(tc):
                _, _, k, accepted, *_ = tc
                return jnp.logical_and(jnp.logical_not(accepted), k < max_trials)

            def trial_body(tc):
                lam, nu, k, _, cur_state, curF = tc
                delta = solve(lam)
                cand = apply_delta(state, delta)
                F1 = robust_cost(cand)
                scale = jnp.dot(delta, lam * delta - g, precision=MATMUL_PRECISION) + TINY
                rho = (F - F1) / scale
                ok = jnp.logical_and(rho > 0, jnp.isfinite(F1))
                factor = jnp.maximum(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3)
                lam_next = jnp.where(ok, lam * factor, lam * nu)
                nu_next = jnp.where(ok, 2.0, 2.0 * nu)
                new_state = jax.tree_util.tree_map(
                    lambda a, b: jnp.where(ok, b, a), cur_state, cand
                )
                newF = jnp.where(ok, F1, curF)
                return (lam_next, nu_next, k + 1, ok, new_state, newF)

            lam1, nu1, _, accepted, state1, F1 = jax.lax.while_loop(
                trial_cond, trial_body, (lam0, nu, jnp.int32(0), jnp.bool_(False), state, F)
            )
            # g2o ends the optimization when an iteration cannot find any
            # accepted step.
            return state1, lam1, nu1, F1, jnp.logical_not(accepted), accepted

        def skip(operand):
            state, lam, nu, F = operand
            return state, lam, nu, F, jnp.bool_(True), jnp.bool_(False)

        state1, lam1, nu1, F1, stop1, accepted = jax.lax.cond(
            stop, skip, run, (state, lam, nu, F)
        )
        return (state1, lam1, nu1, F1, jnp.logical_or(stop, stop1)), accepted

    init = (
        state0,
        jnp.array(-1.0, dtype=FP),
        jnp.array(2.0, dtype=FP),
        F0_init,
        jnp.bool_(False),
    )
    (state, lam, _, F, _), accepted = jax.lax.scan(iteration, init, None, length=n_iterations)
    return LMResult(
        state=state,
        cost=F,
        initial_cost=F0_init,
        lam=lam,
        n_accepted=jnp.sum(accepted.astype(jnp.int32)),
    )


def lm_optimize(
    build_system: Callable,
    robust_cost: Callable,
    apply_delta: Callable,
    state0,
    n_iterations: int,
    tau: float = 1e-5,
    max_trials: int = 10,
) -> LMResult:
    """Dense-normal-equation LM: ``build_system(state) -> (H, g)``.

    Sequential trial evaluation via the shared damping loop
    (``lm_optimize_general``): each iteration linearizes once and runs
    g2o's accept/reject while-loop, so an iteration whose FIRST trial
    accepts (the overwhelmingly common case) pays exactly one damped
    Cholesky + one cost evaluation. The speculative all-trials-batched
    variant (``lm_optimize_speculative``, same accept decisions) runs all
    ten trial Choleskys of every iteration instead.
    """

    def make_step(state):
        H, g = build_system(state)
        return (lambda lam: solve_damped_cholesky(H, g, lam)), g, jnp.max(jnp.diag(H))

    return lm_optimize_general(
        make_step, robust_cost, apply_delta, state0, n_iterations,
        tau=tau, max_trials=max_trials,
    )


def lm_optimize_flat_batched(
    make_step_batched: Callable,
    robust_cost_batched: Callable,
    apply_delta: Callable,
    state0,
    batch: int,
    n_iterations: int,
    tau: float = 1e-5,
    max_trials: int = 10,
) -> LMResult:
    """Per-pair-asynchronous LM for a BATCH of independent problems.

    ``vmap(lm_optimize_general)`` runs the inner trial while_loop in
    lockstep: every pair pays the batch-MAX trial count of every iteration.
    This driver flattens the trial loop away: each
    global step performs exactly ONE batched damped solve + ONE batched
    cost evaluation, and acceptance/damping evolve PER PAIR -- a rejection
    simply means that pair's state doesn't move this step while its lambda
    grows. Per pair, the (lam, nu, accept) sequence is IDENTICAL to
    ``lm_optimize_general``'s (g2o semantics: an iteration retries with
    growing damping until acceptance, ``max_trials`` consecutive rejections
    end that pair's optimization; relinearizing at an unmoved state after a
    rejection reproduces the same linear system the sequential trial loop
    reuses). Total steps = n_iterations + the batch-max number of
    rejections, instead of n_iterations * batch-max-trials-per-iteration.

    ``make_step_batched(state_b) -> (solve_b, g_b, diag_max_b)`` where
    ``solve_b(lam_b [B]) -> delta_b`` solves every pair's damped system at
    its own lambda; ``robust_cost_batched(state_b) -> [B]``;
    ``apply_delta`` maps per pair (vmapped here).
    """
    F0_init = robust_cost_batched(state0)
    apply_b = jax.vmap(apply_delta)
    max_steps = n_iterations * max_trials

    def cond(carry):
        _state, _lam, _nu, _F, n_acc, _streak, stop, k = carry
        alive = jnp.logical_and(jnp.logical_not(stop), n_acc < n_iterations)
        return jnp.logical_and(jnp.any(alive), k < max_steps)

    def body(carry):
        state, lam, nu, F, n_acc, streak, stop, k = carry
        solve_b, g_b, diag_max_b = make_step_batched(state)
        lam0 = jnp.where(lam < 0, tau * diag_max_b, lam)
        delta = solve_b(lam0)
        cand = apply_b(state, delta)
        F1 = robust_cost_batched(cand)
        scale = jnp.einsum(
            "bd,bd->b", delta, lam0[:, None] * delta - g_b, precision=MATMUL_PRECISION
        ) + TINY
        rho = (F - F1) / scale
        alive = jnp.logical_and(jnp.logical_not(stop), n_acc < n_iterations)
        ok = jnp.logical_and(jnp.logical_and(rho > 0, jnp.isfinite(F1)), alive)
        factor = jnp.maximum(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3)
        lam1 = jnp.where(ok, lam0 * factor, jnp.where(alive, lam0 * nu, lam))
        nu1 = jnp.where(ok, 2.0, jnp.where(alive, 2.0 * nu, nu))
        state1 = jax.tree_util.tree_map(
            lambda a, b: jnp.where(
                ok.reshape((batch,) + (1,) * (a.ndim - 1)), b, a
            ),
            state, cand,
        )
        F2 = jnp.where(ok, F1, F)
        n_acc1 = n_acc + ok.astype(jnp.int32)
        streak1 = jnp.where(ok, 0, jnp.where(alive, streak + 1, streak))
        stop1 = jnp.logical_or(stop, streak1 >= max_trials)
        return (state1, lam1, nu1, F2, n_acc1, streak1, stop1, k + 1)

    init = (
        state0,
        jnp.full((batch,), -1.0, dtype=FP),
        jnp.full((batch,), 2.0, dtype=FP),
        F0_init,
        jnp.zeros((batch,), jnp.int32),
        jnp.zeros((batch,), jnp.int32),
        jnp.zeros((batch,), bool),
        jnp.int32(0),
    )
    state, lam, _, F, n_acc, _, _, _ = jax.lax.while_loop(cond, body, init)
    return LMResult(
        state=state, cost=F, initial_cost=F0_init, lam=lam, n_accepted=n_acc
    )


def lm_optimize_speculative(
    build_system: Callable,
    robust_cost: Callable,
    apply_delta: Callable,
    state0,
    n_iterations: int,
    tau: float = 1e-5,
    max_trials: int = 10,
) -> LMResult:
    """Speculative-trial dense LM (retained alternative; see lm_optimize).

    g2o's rejection schedule is deterministic given (lam, nu) -- trial k
    uses lam_k = lam * nu^k * 2^(k(k-1)/2) -- so ALL candidate damped
    solves and their costs can run as one vmapped batch per iteration with
    the first accepted trial selected: the same accept decisions and
    lambda evolution as the sequential loop. Useful when the workload is
    genuinely trial-heavy (most iterations reject several times) or when
    per-step dispatch overhead dominates (e.g. eager/step-wise execution);
    when trials rarely reject the sequential form does less work
    (tests/test_lm.py pins the policy equivalence).
    """
    F0_init = robust_cost(state0)
    k = jnp.arange(max_trials)
    ladder_pow = 2.0 ** (k * (k - 1) / 2.0)  # [T]: 1, 1, 2, 8, 64, ...

    def iteration(carry, _):
        state, lam, nu, F, stop = carry

        def run(operand):
            state, lam, nu, F = operand
            H, g = build_system(state)
            lam0 = jnp.where(lam < 0, tau * jnp.max(jnp.diag(H)), lam)
            # trial k's damping: k==0 -> lam0; k rejections multiply by
            # nu, 2nu, 4nu, ... -> lam0 * nu^k * 2^(k(k-1)/2).
            lams = lam0 * (nu**k) * ladder_pow

            deltas = jax.vmap(lambda l: solve_damped_cholesky(H, g, l))(lams)  # [T, dim]
            cands = jax.vmap(lambda d: apply_delta(state, d))(deltas)
            F1s = jax.vmap(robust_cost)(cands)  # [T]
            scales = jnp.einsum(
                "td,td->t", deltas, lams[:, None] * deltas - g[None, :],
                precision=MATMUL_PRECISION,
            ) + TINY
            rhos = (F - F1s) / scales
            oks = (rhos > 0) & jnp.isfinite(F1s)

            any_ok = jnp.any(oks)
            first = jnp.argmax(oks)  # first accepted trial (argmax of bool)
            rho = rhos[first]
            factor = jnp.maximum(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3)
            # Sequential-equivalent (lam, nu) evolution: k rejections then an
            # acceptance leave lam = lams[k] * factor and nu = 2; a full
            # failure leaves lam = lams[T-1] * nu_final (irrelevant: stop).
            lam1 = jnp.where(any_ok, lams[first] * factor, lams[max_trials - 1] * nu * 2.0 ** (max_trials - 1))
            nu1 = jnp.where(any_ok, 2.0, nu * 2.0**max_trials)
            state1 = jax.tree_util.tree_map(
                lambda a, b: jnp.where(any_ok, b[first], a), state, cands
            )
            F1 = jnp.where(any_ok, F1s[first], F)
            # g2o ends the optimization when an iteration cannot find any
            # accepted step.
            return state1, lam1, nu1, F1, jnp.logical_not(any_ok), any_ok

        def skip(operand):
            state, lam, nu, F = operand
            return state, lam, nu, F, jnp.bool_(True), jnp.bool_(False)

        state1, lam1, nu1, F1, stop1, accepted = jax.lax.cond(
            stop, skip, run, (state, lam, nu, F)
        )
        return (state1, lam1, nu1, F1, jnp.logical_or(stop, stop1)), accepted

    init = (
        state0,
        jnp.array(-1.0, dtype=FP),
        jnp.array(2.0, dtype=FP),
        F0_init,
        jnp.bool_(False),
    )
    (state, lam, _, F, _), accepted = jax.lax.scan(iteration, init, None, length=n_iterations)
    return LMResult(
        state=state,
        cost=F,
        initial_cost=F0_init,
        lam=lam,
        n_accepted=jnp.sum(accepted.astype(jnp.int32)),
    )
