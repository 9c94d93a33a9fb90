"""Synthetic two-camera simulation pipeline (the reference's CPU-runnable fixture).

End-to-end parity with ``Execution/simulation.cc`` + the simulation paths of
``SLAM`` (``Modules/System/SLAM.cc:133-148, 223-351``) and ``Mapping``
(``Modules/Mapping/Mapping.cc:280-349``):

1. load ground-truth point pairs from csv;
2. camera 1 at ``Camera.FirstPose`` with identity rotation; camera 2 at
   ``Camera.SecondPose`` oriented by look-at toward the first moved point
   (the reference uses the look-at matrix directly as the world-to-camera
   rotation -- a convention we keep, ``SLAM.cc:223-235``);
3. simulate depth measurements d = z * scale_corruption + N(0, sigma_d/1000)
   (``SLAM.cc:321-338``) and pixel observations proj(GT) + N(0, sigma_px)
   rounded to ``Keypoints.decimalsApproximation`` (``SLAM.cc:281-309``);
4. batched dual-point triangulation with the configured method/seed and
   parallax/positive-depth gating;
5. initial per-keyframe depth scales = mean(d / z) over valid points
   (``KeyFrame::setInitialDepthScaleInSimulationImages``, KeyFrame.cc:131-153);
6. deformation-regularized refinement with the outer weight search;
7. metric journal in the reference's Experiment.txt format.

Depth-uncertainty quirk: the reference passes
``Measurements.DepthWeight / 1000`` to the optimizer
(``g2oBundleAdjustment.cc:449``); that key is absent from the shipped
Simulation.yaml, which makes the C++ read 0 and the depth information
infinite. We fall back to ``Measurements.DepthError`` (the value the noise
was actually drawn with) when DepthWeight is unset -- documented deviation.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax.numpy as jnp
import numpy as np

from ..config import Config
from ..models import deformable, outer
from ..ops import camera as cam_ops
from ..ops import lie
from ..ops import triangulation as tri
from ..utils import csvio, metrics as metrics_mod
from ..utils.journal import ExperimentJournal
from ..viz import MapVisualizer
from ..precision import FP
from .worldmap import build_pair_map


@dataclasses.dataclass
class SimulationResult:
    state: deformable.PairState
    valid: np.ndarray
    initial: metrics_mod.AbsoluteErrors
    final: metrics_mod.AbsoluteErrors
    initial_pix: metrics_mod.PixelsError
    final_pix: metrics_mod.PixelsError
    weights: np.ndarray
    rounds: int
    n_matches: int
    n_map_points: int
    parallax_deg: float
    # Populated map layer: dual points + observations + refined global SE3
    # (Mapping.cc:183-247, Map.cc:323-343).
    world_map: object = None
    # Whether the rigid-scene hypothesis replaced the deformable solution
    # (models/rigid.py via outer.deformation_optimization).
    rigid_accepted: bool = False


class SimulationPipeline:
    def __init__(self, cfg: Config, seed: int = 0, mesh_backend: str = "auto"):
        self.cfg = cfg
        self.seed = seed
        self.mesh_backend = mesh_backend
        self.cam_kind = cam_ops.KB8
        self.cam_params = cfg.kb8_params

    # ------------------------------------------------------------------
    def _poses(self, moved0):
        c1 = jnp.asarray(np.asarray(self.cfg.c1_pose, dtype=np.float64))
        c2 = jnp.asarray(np.asarray(self.cfg.c2_pose, dtype=np.float64))
        T1w = (jnp.eye(3, dtype=FP), c1)
        T2w = (lie.look_at(c2, jnp.asarray(moved0)), c2)
        return T1w, T2w

    def _simulate_observations(self, orig, moved, T1w, T2w, rng):
        """Noisy pixels + corrupted depths (SLAM.cc:281-338)."""
        cfg = self.cfg
        p1c = lie.apply(*T1w, jnp.asarray(orig))
        p2c = lie.apply(*T2w, jnp.asarray(moved))
        kp1 = np.asarray(cam_ops.project(self.cam_kind, jnp.asarray(self.cam_params), p1c))
        kp2 = np.asarray(cam_ops.project(self.cam_kind, jnp.asarray(self.cam_params), p2c))
        kp1 = kp1 + rng.normal(scale=max(cfg.sim_rep_error, 1e-300), size=kp1.shape)
        kp2 = kp2 + rng.normal(scale=max(cfg.sim_rep_error, 1e-300), size=kp2.shape)
        dec = cfg.decimals_rep_error
        kp1 = np.round(kp1, dec)
        kp2 = np.round(kp2, dec)

        sigma_d = cfg.sim_depth_error / 1000.0
        d1 = np.asarray(p1c)[:, 2] * cfg.sim_depth_scale_c1 + rng.normal(
            scale=max(sigma_d, 1e-300), size=len(orig)
        )
        d2 = np.asarray(p2c)[:, 2] * cfg.sim_depth_scale_c2 + rng.normal(
            scale=max(sigma_d, 1e-300), size=len(orig)
        )
        return kp1, kp2, d1, d2

    def _triangulate(self, kp1, kp2, T1w, T2w, d1, d2):
        """Mapping::triangulateSimulatedMapPoints (Mapping.cc:280-349)."""
        cfg = self.cfg
        params = jnp.asarray(self.cam_params)
        xn1 = cam_ops.unproject(self.cam_kind, params, jnp.asarray(kp1))
        xn2 = cam_ops.unproject(self.cam_kind, params, jnp.asarray(kp2))
        xn1 = xn1 / jnp.linalg.norm(xn1, axis=-1, keepdims=True)
        xn2 = xn2 / jnp.linalg.norm(xn2, axis=-1, keepdims=True)

        if cfg.triangulation_method == tri.DEPTH:
            # DepthMeasurement feeds metric camera points: ray scaled so that
            # z equals the measured depth (CameraModel::unproject(pt, z)).
            xn1 = xn1 / xn1[:, 2:3] * jnp.asarray(d1)[:, None]
            xn2 = xn2 / xn2[:, 2:3] * jnp.asarray(d2)[:, None]

        x1, x2 = tri.triangulate(
            xn1, xn2, T1w, T2w, method=cfg.triangulation_method, location=cfg.triangulation_location
        )
        valid = tri.valid_parallax_mask(xn1, xn2, T1w, T2w, x1, x2, cfg.min_cos)
        return np.asarray(x1), np.asarray(x2), np.asarray(valid), xn1, xn2

    @staticmethod
    def _initial_depth_scale(p, T, d, valid):
        """Initial scale estimate s0 = mean(d/z) plus its standard error.

        The mean mirrors ``KeyFrame::setInitialDepthScaleInSimulationImages``
        (KeyFrame.cc:131-153); the standard error (scatter / sqrt(n)) is this
        framework's addition -- it quantifies the estimate so the optimizer
        can anchor the scale vertex with a statistically-derived information
        (see deformable.PairData scale-prior docs).
        """
        z = np.asarray(lie.apply(jnp.asarray(T[0]), jnp.asarray(T[1]), jnp.asarray(p)))[:, 2]
        v = np.asarray(valid, dtype=bool) & (np.asarray(d) != 0)
        ratios = np.asarray(d)[v] / z[v]
        se = float(ratios.std() / max(np.sqrt(len(ratios)), 1.0))
        return float(ratios.mean()), se

    # ------------------------------------------------------------------
    def run(
        self,
        original_file: str,
        moved_file: str,
        journal_path: Optional[str] = None,
        echo: bool = False,
    ) -> SimulationResult:
        orig, moved = csvio.load_point_pairs(original_file, moved_file)
        return self.run_points(orig, moved, journal_path=journal_path, echo=echo)

    def run_points(
        self,
        orig: np.ndarray,
        moved: np.ndarray,
        journal_path: Optional[str] = None,
        echo: bool = False,
    ) -> SimulationResult:
        """``run`` on ground-truth point pairs already in memory ([N, 3] each,
        e.g. from ``harness.create_data.generate_points``)."""
        cfg = self.cfg
        rng = np.random.default_rng(self.seed)
        orig = np.asarray(orig, dtype=np.float64)
        moved = np.asarray(moved, dtype=np.float64)
        T1w, T2w = self._poses(moved[0])

        kp1, kp2, d1, d2 = self._simulate_observations(orig, moved, T1w, T2w, rng)
        p1, p2, valid, xn1, xn2 = self._triangulate(kp1, kp2, T1w, T2w, d1, d2)
        n_valid = int(valid.sum())

        # ARAP_OneSet protocol (committed-trace parity): the variant's first
        # point set is ANCHORED AT THE GROUND-TRUTH original positions and
        # frozen -- its committed journals hold C1's reprojection std exactly
        # constant at the injected pixel-noise sigma (noise-free projections)
        # through every iteration (see deformable.ModelSpec). The simulation
        # knows the ground truth, so it reproduces that protocol; the solver
        # itself only ever freezes p1, it never reads GT.
        spec = deformable.MODELS.get(cfg.opt_model, deformable.ModelSpec())
        if spec.one_set:
            p1 = jnp.asarray(orig, dtype=jnp.asarray(p1).dtype)

        s1, se1 = self._initial_depth_scale(p1, T1w, d1, valid)
        s2, se2 = self._initial_depth_scale(p2, T2w, d2, valid)
        # SE floor keeps the prior information f32-safe when depths are exact.
        scale_priors = (s1, 1.0 / max(se1, 1e-6) ** 2, s2, 1.0 / max(se2, 1e-6) ** 2)

        state = deformable.PairState(
            p1=jnp.asarray(p1),
            p2=jnp.asarray(p2),
            s1=jnp.asarray(s1),
            s2=jnp.asarray(s2),
            Rg=jnp.eye(3, dtype=FP),
            tg=jnp.zeros(3, dtype=FP),
        )

        journal = ExperimentJournal(journal_path or cfg.exp_file_path, echo=echo)
        baseline = float(np.linalg.norm(np.asarray(T2w[1]) - np.asarray(T1w[1])))
        parallax = metrics_mod.mean_parallax_degrees(xn1, xn2, T1w, T2w, valid)
        journal.header(baseline, parallax, len(orig), 2 * n_valid)

        gt_index = np.arange(len(orig))

        def measure(state):
            pix = metrics_mod.pixels_stand_dev(
                self.cam_kind, self.cam_params, T1w, T2w, state.p1, state.p2, kp1, kp2, valid
            )
            rel = metrics_mod.relative_map_errors(
                T1w, T2w, state.p1, state.p2, float(state.s1), float(state.s2), d1, d2, valid,
                state.Rg, state.tg,
            )
            abs_err = metrics_mod.sim_absolute_errors(state.p1, state.p2, valid, gt_index, orig, moved)
            return pix, rel, abs_err

        pix0, rel0, abs0 = measure(state)
        journal.block_header("INITIAL MEASUREMENTS:")
        journal.relative(pix0, rel0)
        journal.sim_absolute(abs0)

        # Depth-uncertainty quirk fallback (see module docstring).
        depth_w = cfg.sim_depth_weight if cfg.sim_depth_weight > 0 else cfg.sim_depth_error
        ocfg = outer.OuterConfig(
            rep_w=cfg.opt_rep_weight,
            global_w=cfg.opt_global_weight,
            arap_w=cfg.opt_arap_weight,
            alpha=cfg.opt_alpha_weight,
            beta=cfg.opt_beta_weight,
            depth_sigma=depth_w / 1000.0,
            n_optimizations=cfg.n_optimizations,
            n_opt_iterations=cfg.n_opt_iterations,
            opt_selection=cfg.opt_selection,
            weights_selection=cfg.opt_weights_selection,
            nlopt_max_eval=cfg.nlopt_n_optimizations,
            nlopt_rel_tol=cfg.nlopt_rel_tolerance,
            nlopt_abs_tol=cfg.nlopt_abs_tolerance,
            lower_bounds=(cfg.nlopt_rep_lower, cfg.nlopt_global_lower, cfg.nlopt_arap_lower),
            upper_bounds=(cfg.nlopt_rep_upper, cfg.nlopt_global_upper, cfg.nlopt_arap_upper),
            model=cfg.opt_model,
        )

        def on_round(i, state_i, weights_i):
            journal.block_header(f"{i} / {ocfg.n_optimizations} MEASUREMENTS:")
            pix, rel, abs_err = measure(state_i)
            journal.relative(pix, rel)
            journal.sim_absolute(abs_err)

        result = outer.deformation_optimization(
            self.cam_kind,
            self.cam_params,
            T1w,
            T2w,
            kp1,
            kp2,
            d1,
            d2,
            valid,
            state,
            ocfg,
            on_round=on_round,
            mesh_backend=self.mesh_backend,
            scale_priors=scale_priors,
        )

        journal.block_header("FINAL MEASUREMENTS:")
        pix1, rel1, abs1 = measure(result.state)
        journal.relative(pix1, rel1)
        journal.sim_absolute(abs1)

        # Solution visualization (gated like SLAM::viusualizeSolution /
        # MapVisualizer.showScene, Settings.cc:155-189) -- headless PNG + PLY.
        if cfg.show_scene or cfg.show_solution:
            import os

            out_dir = os.path.join(
                os.path.dirname(os.path.abspath(journal_path or cfg.exp_file_path)), "viz"
            )
            mviz = MapVisualizer(enabled=True, out_dir=out_dir, draw_rays=cfg.draw_rays)
            cam_centers = [
                (np.asarray(R).T, -np.asarray(R).T @ np.asarray(t)) for R, t in (T1w, T2w)
            ]
            v = valid
            mviz.update(np.asarray(result.state.p1)[v], np.asarray(result.state.p2)[v], cam_centers)
            mviz.snapshot()
            mviz.export_ply()

        # Map-layer insertion: dual points per match + observations +
        # refined global SE3 (the reference's Mapping.cc:183-247 inserts
        # into Map; the simulated keypoints carry no descriptors).
        wmap = build_pair_map(
            T1w, T2w, kp1, kp2, None, None, None, None, d1, d2,
            result.state, valid,
            scale_factor=cfg.scale_factor, n_scales=cfg.n_scales,
        )

        return SimulationResult(
            state=result.state,
            valid=valid,
            initial=abs0,
            final=abs1,
            initial_pix=pix0,
            final_pix=pix1,
            weights=result.weights,
            rounds=result.rounds,
            n_matches=len(orig),
            n_map_points=2 * n_valid,
            parallax_deg=parallax,
            world_map=wmap,
            rigid_accepted=bool(result.rigid_accepted),
        )
