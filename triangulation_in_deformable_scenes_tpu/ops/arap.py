"""ARAP (As-Rigid-As-Possible) kernels: per-vertex rotations and edge energies.

Mirrors the reference's ARAP machinery in fixed-shape batched form:

- ``compute_rotations`` == ``computeR`` (``Modules/Utils/Geometry.cc:549-604``):
  per vertex i, S_i = sum_j w_ij (p1_i - p1_j)(p2_i - p2_j)^T over mesh
  neighbors, then the polar rotation via SVD with the det<0 fix. One batched
  3x3 SVD over all vertices instead of N host SVDs.
- ``arap_edge_energy`` == ``EdgeARAP::computeError``
  (``Modules/Optimization/g2oTypes.h:300-349``): per directed edge (i, j), the
  scalar energy
      w_ij (||(d2_i - R_i d1_i)/A||^2 + ||(d2_j - R_j d1_j)/A||^2)
      + ||((Rg p2_i - t) - p1_i) + ((Rg p2_j - t) - p1_j)||^2
  where d1_i = p1_i - p1_j, d2_i = p2_i - p2_j, A is the mesh surface area and
  (Rg, t) the global alignment. The g2o edge's residual is this energy minus a
  zero measurement; its information is arap_weight * n_triangles^2
  (``g2oBundleAdjustment.cc:939-950``).

Gather convention: padded neighbor array ``nbr[N, K]`` with -1 padding;
padded slots gather row 0 and are masked out downstream.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..precision import MATMUL_PRECISION
from . import lie


def _gather_nbr(p, nbr):
    """p[N, 3], nbr[N, K] -> p[nbr][N, K, 3] with pad-safe indices."""
    safe = jnp.maximum(nbr, 0)
    return p[safe]


@jax.jit
def compute_rotations(p1, p2, nbr, nbr_mask, weights):
    """Batched ``computeR``: best-fit rotation p1-neighborhood -> p2.

    p1, p2: [N, 3] world positions (undeformed / deformed).
    Returns R[N, 3, 3].
    """
    p1j = _gather_nbr(p1, nbr)  # [N, K, 3]
    p2j = _gather_nbr(p2, nbr)
    e1 = p1[:, None, :] - p1j  # undeformed edges
    e2 = p2[:, None, :] - p2j  # deformed edges
    w = jnp.where(nbr_mask, weights, 0.0)
    S = jnp.einsum("nk,nki,nkj->nij", w, e1, e2, precision=MATMUL_PRECISION)
    # Vertices with no neighbors keep identity (S = 0 -> SVD gives arbitrary
    # rotation; mask afterwards).
    R = lie.fit_rotation(S)
    has_nbr = jnp.any(nbr_mask, axis=-1)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=p1.dtype), R.shape)
    return jnp.where(has_nbr[:, None, None], R, eye)


def compute_rotations_host(p1, p2, nbr, nbr_mask, weights):
    """``compute_rotations`` in numpy float64 on the host, for the per-round
    mesh snapshot (``deformable.make_pair_data``), which freezes these
    rotations next to the host-side Delaunay mesh and cotangent weights.

    A vertex whose weighted neighbourhood is degenerate (S of rank < 2, e.g.
    a hull vertex whose other cot weights clamp to zero) has no unique best
    rotation: an f32 SVD on one device and on another pick different ones,
    and the deformation model would then differ between them. Computing the
    snapshot here keeps it the same whichever device solves.
    """
    p1 = np.asarray(p1, np.float64)
    p2 = np.asarray(p2, np.float64)
    nbr = np.asarray(nbr)
    mask = np.asarray(nbr_mask, bool)
    j = np.maximum(nbr, 0)
    w = np.where(mask, np.asarray(weights, np.float64), 0.0)
    S = np.einsum("nk,nki,nkj->nij", w, p1[:, None, :] - p1[j], p2[:, None, :] - p2[j])
    U, _, Vt = np.linalg.svd(S)
    V = np.swapaxes(Vt, -1, -2)
    # Flip U's last column where V U^T is improper (reference: U.col(2)).
    U[:, :, 2] *= np.where(np.linalg.det(V @ np.swapaxes(U, -1, -2)) < 0, -1.0, 1.0)[:, None]
    R = V @ np.swapaxes(U, -1, -2)
    R[~mask.any(axis=-1)] = np.eye(3)
    return R


def arap_edge_energy(p1, p2, R, nbr, nbr_mask, weights, area, Rg, tg):
    """Energy of every directed mesh edge; [N, K] with zeros on padding.

    Padding yields j == i after the safe gather, making d1 = d2 = 0 and the
    global term finite; the mask zeroes it regardless.
    """
    p1j = _gather_nbr(p1, nbr)
    p2j = _gather_nbr(p2, nbr)
    Rj = R[jnp.maximum(nbr, 0)]  # [N, K, 3, 3]

    d1i = p1[:, None, :] - p1j  # p1_i - p1_j
    d2i = p2[:, None, :] - p2j
    # d1j = -d1i, d2j = -d2i per the reference's definition.

    Ri_d1i = jnp.einsum("nab,nkb->nka", R, d1i, precision=MATMUL_PRECISION)
    Rj_d1j = jnp.einsum("nkab,nkb->nka", Rj, -d1i, precision=MATMUL_PRECISION)

    first = (d2i - Ri_d1i) / area
    second = (-d2i - Rj_d1j) / area

    g_i = jnp.einsum("ab,nb->na", Rg, p2, precision=MATMUL_PRECISION) - tg - p1  # [N, 3]
    g_j = jnp.einsum("ab,nkb->nka", Rg, p2j, precision=MATMUL_PRECISION) - tg - p1j
    diff_global = g_i[:, None, :] + g_j
    energy_global = jnp.sum(diff_global * diff_global, axis=-1)

    energy = (
        weights * (jnp.sum(first * first, axis=-1) + jnp.sum(second * second, axis=-1))
        + energy_global
    )
    return jnp.where(nbr_mask, energy, 0.0)


def arap_deform(
    p_rest,
    nbr,
    nbr_mask,
    weights,
    constraint_idx,
    constraint_pos,
    iters: int = 50,
    p_init=None,
):
    """Classic local-global ARAP surface deformation (Sorkine-Alexa).

    Serves the reference's "open3DArap" optimizer selection, which calls
    Open3D's ``DeformAsRigidAsPossible`` with the Spokes energy
    (``g2oBundleAdjustment.cc:1058-1061``): minimize
    sum_ij w_ij || (p'_i - p'_j) - R_i (p_i - p_j) ||^2 subject to hard
    position constraints, alternating the per-vertex rotation fit (local
    step, batched SVD) with a linear Laplacian solve (global step). The
    Laplacian is constant, so it is factorized once and reused across the
    ``lax.fori_loop`` iterations.

    NOTE: the reference passes a zero-initialized constraint index list --
    effectively pinning only vertex 0 -- a quirk the caller may reproduce by
    passing ``constraint_idx=[0]``.
    """
    n = p_rest.shape[0]
    dtype = p_rest.dtype
    w = jnp.where(nbr_mask, weights, 0.0)
    j_safe = jnp.maximum(nbr, 0)

    # Uniform Laplacian of the cot-weighted graph: L[i,i] = sum_j w_ij,
    # L[i,j] = -w_ij.
    L = jnp.zeros((n, n), dtype=dtype)
    rows = jnp.broadcast_to(jnp.arange(n)[:, None], nbr.shape)
    L = L.at[rows, j_safe].add(-w)
    L = L.at[jnp.arange(n), jnp.arange(n)].add(jnp.sum(w, axis=1))

    # Hard constraints: replace the constrained rows by identity rows.
    cmask = jnp.zeros((n,), dtype=bool).at[constraint_idx].set(True)
    L = jnp.where(cmask[:, None], jnp.eye(n, dtype=dtype), L)
    # Small regularization keeps unconstrained components well-posed.
    L = L + 1e-12 * jnp.eye(n, dtype=dtype)
    lu, piv = jax.scipy.linalg.lu_factor(L)

    cpos = jnp.zeros((n, 3), dtype=dtype).at[constraint_idx].set(constraint_pos)
    p0 = p_rest if p_init is None else p_init

    def body(_, p):
        R = compute_rotations(p_rest, p, nbr, nbr_mask, weights)
        Rj = R[j_safe]
        rest_edges = p_rest[:, None, :] - p_rest[j_safe]
        rhs_edges = 0.5 * jnp.einsum(
            "nk,nkab,nkb->na", w, (R[:, None] + Rj), rest_edges,
            precision=MATMUL_PRECISION,
        )
        b = jnp.where(cmask[:, None], cpos, rhs_edges)
        return jax.scipy.linalg.lu_solve((lu, piv), b)

    return jax.lax.fori_loop(0, iters, body, p0)


def relative_edge_errors(p1, p2, nbr, nbr_mask):
    """Per directed edge ||(p2_i - p2_j) - (p1_i - p1_j)||^2, for metrics.

    Parity with the ARAP relative-error accumulation in
    ``measureRelativeMapErrors`` (``Modules/Utils/Measurements.cc:457-473``).
    """
    p1j = _gather_nbr(p1, nbr)
    p2j = _gather_nbr(p2, nbr)
    d1 = p1[:, None, :] - p1j
    d2 = p2[:, None, :] - p2j
    diff = d2 - d1
    return jnp.where(nbr_mask, jnp.sum(diff * diff, axis=-1), 0.0)


def global_edge_errors(p1, p2, nbr, nbr_mask, Rg, tg):
    """Per directed edge global-alignment error (Measurements.cc:476)."""
    p1j = _gather_nbr(p1, nbr)
    p2j = _gather_nbr(p2, nbr)
    g_i = jnp.einsum("ab,nb->na", Rg, p2, precision=MATMUL_PRECISION) - tg - p1
    g_j = jnp.einsum("ab,nkb->nka", Rg, p2j, precision=MATMUL_PRECISION) - tg - p1j
    diff = g_i[:, None, :] + g_j
    return jnp.where(nbr_mask, jnp.sum(diff * diff, axis=-1), 0.0)
