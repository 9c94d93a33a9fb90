"""Landmark-sharded deformable refinement over a device mesh.

The reference is a single-threaded C++ process; scaling out is a NEW
capability of this framework (SURVEY.md section 7 step 7). Design:

- the match/landmark axis N is sharded over a 1-D ``jax.sharding.Mesh``
  ("points" axis); every per-point array of ``PairData``/``PairState`` is
  placed with ``NamedSharding(P("points"))``, scalars/poses replicated;
- the inner solve assembles the Gauss-Newton system in block-sparse ELLPACK
  form (``models/block_system.py``): per-point 6x6 diagonal blocks, per-mesh-
  neighbor 6x6 coupling blocks aligned with ``data.nbr``, and an 8-dim global
  column. Every assembly product is point-local except the neighbor reads;
  CG runs on the assembled operator, so one H v is a single packed [N, 6]
  neighbor exchange plus batched 6x6 einsums -- no scatter, no AD transpose;
- communication per matvec: the [N, 6] packed-tangent exchange for the
  unstructured mesh-neighbor reads (XLA lowers it as an all-gather — the
  partitioner cannot prove locality of an unpartitioned adjacency), psums
  for the CG dot products and the shared 8-dim (scales + global SE3) block.
  The production path is ``parallel/halo.py``, which Morton-partitions the
  mesh and runs the PCG inside ``shard_map`` exchanging only the O(sqrt(N))
  boundary rows. This module stays as the partitioner-lowered baseline (and the single-
  device CG backend);
- preconditioning: block-Jacobi from the assembled 6x6/8x8 diagonal blocks.

``solve_pair_distributed`` runs the shared LM damping loop
(``ops/lm.lm_optimize_general``) with the block-sparse PCG backend. On a
single device the math matches the dense solver up to CG tolerance.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models import deformable
from ..ops import lm as lm_ops

POINTS_AXIS = "points"
PAIRS_AXIS = "pairs"


def make_mesh(devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (POINTS_AXIS,))


def make_serving_mesh(devices=None) -> Mesh:
    """1-D mesh over the keyframe-PAIR axis (data-parallel serving)."""
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (PAIRS_AXIS,))


def shard_pairs(mesh: Mesh, data: deformable.PairData, state: deformable.PairState,
                hyper: deformable.Hyper | None = None):
    """Place a BATCH of pairs (leading pair axis on every array) over the
    mesh's pairs axis; each device refines its own pairs independently.

    This is the scale-out path for serving many sequences at once: the
    batched solve (``deformable.solve_pairs``) is embarrassingly parallel
    along the pair axis, so XLA partitions it with zero inter-device
    collectives -- linear scaling by construction (the reference runs one
    pair per OS process instead, run_real_experiments.py:43-76).
    ``hyper`` is sharded too when it carries a leading pair axis (per-pair
    weights), otherwise pass it separately / replicated.

    Contract (validated): every leaf of ``data`` and ``state`` must carry the
    leading pair axis of size b, and b must divide evenly over the mesh's
    pairs axis (pad the batch by repeating a pair and masking its result if
    it doesn't). ``hyper`` leaves are per-pair iff 1-D of length b; scalars
    are replicated.
    """
    b = data.kp1.shape[0]
    n_dev = mesh.devices.size
    if b % n_dev != 0:
        raise ValueError(
            f"pair batch size {b} is not divisible by the {n_dev}-device "
            f"'{PAIRS_AXIS}' mesh axis; pad the pair batch to a multiple"
        )

    def place_batched(path, x):
        x = jnp.asarray(x)
        if x.ndim < 1 or x.shape[0] != b:
            raise ValueError(
                f"shard_pairs: leaf {jax.tree_util.keystr(path)} has shape "
                f"{x.shape}; every data/state leaf must carry the leading "
                f"pair axis of size {b} (stack the per-pair values)"
            )
        return jax.device_put(
            x, NamedSharding(mesh, P(PAIRS_AXIS, *([None] * (x.ndim - 1))))
        )

    out = (
        jax.tree_util.tree_map_with_path(place_batched, data),
        jax.tree_util.tree_map_with_path(place_batched, state),
    )
    if hyper is not None:
        def place_hyper(x):
            x = jnp.asarray(x)
            spec = P(PAIRS_AXIS) if (x.ndim == 1 and x.shape[0] == b) else P()
            return jax.device_put(x, NamedSharding(mesh, spec))

        out = out + (jax.tree_util.tree_map(place_hyper, hyper),)
    return out


def _pointwise_spec(ndim: int) -> P:
    return P(POINTS_AXIS, *([None] * (ndim - 1)))


def shard_pair(mesh: Mesh, data: deformable.PairData, state: deformable.PairState):
    """Place per-point arrays on the mesh's points axis, replicate the rest."""
    n = data.kp1.shape[0]

    def place(x):
        x = jnp.asarray(x)
        if x.ndim >= 1 and x.shape[0] == n:
            spec = _pointwise_spec(x.ndim)
        else:
            spec = P()
        return jax.device_put(x, NamedSharding(mesh, spec))

    return jax.tree_util.tree_map(place, data), jax.tree_util.tree_map(place, state)


def hessian_diag(cam_kind, data, hyper, state):
    """Exact diag(J^T J) from per-edge blocks (no dense H materialized)."""
    return deformable.assemble_diag(cam_kind, data, hyper, state)


# The distributed result is the shared LMResult (one damping loop for every
# backend lives in ops/lm.py; this module only provides the sharded wiring).
DistLMResult = lm_ops.LMResult


@functools.partial(
    jax.jit, static_argnames=("cam_kind", "n_iterations", "cg_iters", "max_trials", "spec")
)
def solve_pair_distributed(
    cam_kind: str,
    data: deformable.PairData,
    hyper: deformable.Hyper,
    state0: deformable.PairState,
    n_iterations: int,
    cg_iters: int = 50,
    max_trials: int = 6,
    tau: float = 1e-5,
    spec: deformable.ModelSpec = deformable.ModelSpec(),
) -> DistLMResult:
    """LM with block-sparse PCG inner solves; the damping loop is the shared
    ``ops/lm.lm_optimize_general`` (one policy, one implementation).

    Works on replicated arrays (single device) or landmark-sharded inputs
    placed by ``shard_pair`` -- the jitted computation is identical, XLA
    partitions it according to the argument shardings. Under landmark
    sharding the block system's per-point arrays (D, Bt, C, g_p) inherit the
    points partition; the per-matvec communication is the [N, 6] packed
    tangent all-gather for the neighbor reads plus scalar psums for the CG
    dots and the 8-dim global block.
    """
    from ..models import block_system as bs_

    make_step = bs_.make_block_step(
        cam_kind, data, hyper, spec, cg_iters, deformable.CG_RTOL
    )
    return lm_ops.lm_optimize_general(
        make_step,
        robust_cost=lambda s: deformable.robust_cost(cam_kind, data, hyper, s, spec),
        apply_delta=deformable.apply_delta,
        state0=state0,
        n_iterations=n_iterations,
        tau=tau,
        max_trials=max_trials,
    )
