"""Numeric policy of the device compute path.

The reference optimizer runs in f64 throughout (g2o's ``number_t`` is
``double``; ``Modules/Optimization/g2oBundleAdjustment.cc:618-630``). This
framework keeps the device compute path in f32 and makes the two places
that need more headroom robust by construction:

- the damped normal-equation solve is Jacobi-equilibrated (unit diagonal)
  before the f32 Cholesky and polished with one iterative-refinement step
  (``ops/lm.py``), which recovers the accuracy an unscaled f64 factorization
  would give for the condition numbers seen in these problems;
- LM accept/reject compares robust costs whose per-edge terms are f32 but
  whose reduction is performed in a numerically stable order (masked sums of
  same-magnitude nonnegative terms).

Whether a plain f64 solve should replace the equilibrated f32 one is an
open design question; until a measurement settles it, the f32 numerics
stay as they are.

Matrix products: a GPU may run an f32 product in TF32, which keeps about
three decimal digits. That would undo the refinement step of the damped
solve and round the pixel operand of the one-hot descriptor tap select.
Every f32 product on the solver and descriptor paths therefore passes
``precision=MATMUL_PRECISION`` (full f32), and ``tests/test_precision.py``
checks the traced programs for it.

Host-side preparation (Delaunay meshing, cotangent weights, metrics,
journaling) stays in numpy f64 -- it is free on the host and keeps the
experiment-journal numbers deterministic.

``TIDS_X64=1`` re-enables global f64 for debugging numerical regressions on
CPU (see ``__init__``).
"""

import jax
import jax.numpy as jnp

# Device floating-point dtype for the solver/compute path.
FP = jnp.float32

# Precision of every f32 matrix product: full f32, never TF32.
MATMUL_PRECISION = jax.lax.Precision.HIGHEST

# Smallest safe additive guard: representable (normal) in f32, negligible
# against any quantity it guards in either precision.
TINY = 1e-30
