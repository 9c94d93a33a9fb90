"""Deformable-scene 3D reconstruction in JAX.

Capability-parity rebuild of ``luicalrob/Triangulation-in-Deformable-Scenes``
(a C++17/g2o research system) as array programs for an accelerator:

- dense, fixed-shape, batched geometry kernels under ``jax.jit`` (ops/)
- a batched Levenberg-Marquardt deformable refinement replacing g2o's sparse
  solver (models/), with ARAP smoothness over a Delaunay mesh, optimizable
  per-keyframe depth scales and a global SE3 alignment
- landmark-sharded multi-device execution via ``jax.sharding`` (parallel/)
- host-side orchestration, dataset loaders, metrics and experiment journals
  with the reference's file formats (pipeline/, datasets/, utils/)

The reference implementation is cited throughout as ``file:line`` under the
upstream repo (e.g. ``Modules/Utils/Geometry.cc:103``); no code is ported --
the citations document behavioral parity only.

Precision: the device compute path is f32 with every matrix product pinned
to full f32 (see ``precision.py`` for the policy and the equilibrated/refined
linear solves that make f32 sufficient). Host-side prep and metrics stay
numpy f64. Set ``TIDS_X64=1`` before import to re-enable global f64 for
debugging.
"""

import os as _os

import jax as _jax

if _os.environ.get("TIDS_X64"):
    _jax.config.update("jax_enable_x64", True)

# Persistent compilation cache: the solver's jits compile once per problem
# shape, and the cache carries that across processes (sweeps, benches,
# repeated CLI runs). JAX reads JAX_COMPILATION_CACHE_DIR itself when it is
# set; otherwise the cache lives at a fixed path inside the checkout (the
# path is part of the cache key, so it must not move between runs).
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update(
        "jax_compilation_cache_dir",
        _os.path.join(_os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))), ".jax_cache"),
    )

__version__ = "0.1.0"
