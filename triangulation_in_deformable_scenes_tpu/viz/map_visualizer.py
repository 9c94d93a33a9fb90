"""Map visualizer: dual point clouds + keyframe frusta + rays, headless.

Rebuilds ``Modules/Visualization/MapVisualizer.{h,cc}`` without
Pangolin/OpenGL: the same scene content -- the two point sets (red = the
keyframe-1 positions, black = the keyframe-2/deformed positions, as drawn at
``MapVisualizer.cc:214-219``), keyframe camera frusta, and optional
camera-to-point rays (``MapVisualizer::drawRays``) -- is exported as

- a PLY point/edge cloud any external viewer opens (``export_ply``), and
- an orthographic PNG snapshot rendered with the stdlib rasterizer
  (``snapshot``), matplotlib-free so it runs on headless hosts.

Disabled instances are no-ops, mirroring the ``MapVisualizer.showScene``
flag (``Settings.cc:155-189``).
"""

from __future__ import annotations

import os

import numpy as np

from . import draw


def _frustum_segments(Rwc, twc, scale: float):
    """Camera frustum wireframe segments in world coordinates
    (the GL pyramid of ``MapVisualizer::drawKeyFrames``)."""
    w = scale
    h = scale * 0.75
    z = scale * 0.6
    corners = np.array(
        [[0, 0, 0], [w, h, z], [w, -h, z], [-w, -h, z], [-w, h, z]], dtype=np.float64
    )
    pts = corners @ np.asarray(Rwc).T + np.asarray(twc)
    idx = [(0, 1), (0, 2), (0, 3), (0, 4), (1, 2), (2, 3), (3, 4), (4, 1)]
    return [(pts[i], pts[j]) for i, j in idx]


class MapVisualizer:
    """Accumulates the scene each ``update`` and serializes on demand."""

    def __init__(self, enabled: bool = True, out_dir: str = "./viz", draw_rays: bool = False):
        self.enabled = bool(enabled)
        self.out_dir = out_dir
        self.draw_rays = bool(draw_rays)
        self._p1 = np.zeros((0, 3))
        self._p2 = np.zeros((0, 3))
        self._cams = []  # list of (Rwc, twc)
        self._serial = 0
        if self.enabled:
            os.makedirs(out_dir, exist_ok=True)

    def update(self, p1, p2, keyframe_poses=()):
        """Set the current dual point sets and keyframe world poses
        (``MapVisualizer::update``). ``keyframe_poses`` are (Rwc, twc)."""
        if not self.enabled:
            return
        self._p1 = np.asarray(p1, dtype=np.float64).reshape(-1, 3)
        self._p2 = np.asarray(p2, dtype=np.float64).reshape(-1, 3)
        self._cams = [(np.asarray(R, dtype=np.float64), np.asarray(t, dtype=np.float64))
                      for R, t in keyframe_poses]

    # ------------------------------------------------------------------ PLY

    def export_ply(self, path: str | None = None) -> str | None:
        """ASCII PLY with per-vertex colors: red = KF1 set, black = KF2 set,
        blue = camera centers."""
        if not self.enabled:
            return None
        if path is None:
            path = os.path.join(self.out_dir, f"map_{self._serial:05d}.ply")
        cams = np.array([t for _, t in self._cams]).reshape(-1, 3)
        pts = np.concatenate([self._p1, self._p2, cams], axis=0)
        colors = np.concatenate(
            [
                np.tile([255, 0, 0], (len(self._p1), 1)),
                np.tile([0, 0, 0], (len(self._p2), 1)),
                np.tile([0, 0, 255], (len(cams), 1)),
            ],
            axis=0,
        ).astype(int)
        lines = [
            "ply",
            "format ascii 1.0",
            f"element vertex {len(pts)}",
            "property float x",
            "property float y",
            "property float z",
            "property uchar red",
            "property uchar green",
            "property uchar blue",
            "end_header",
        ]
        for p, c in zip(pts, colors):
            lines.append(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f} {c[0]} {c[1]} {c[2]}")
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
        return path

    # ------------------------------------------------------------- snapshot

    def snapshot(self, path: str | None = None, size: int = 800, axes=(0, 1)) -> str | None:
        """Orthographic projection of the scene onto two world axes
        (default XY), rendered to PNG. The scene framing auto-fits all
        content like the reference's initial Pangolin view."""
        if not self.enabled:
            return None
        if path is None:
            path = os.path.join(self.out_dir, f"map_{self._serial:05d}.png")
            self._serial += 1

        cams = np.array([t for _, t in self._cams]).reshape(-1, 3)
        all_pts = np.concatenate([self._p1, self._p2, cams], axis=0)
        if len(all_pts) == 0:
            draw.write_png(path, np.full((size, size, 3), 255, dtype=np.uint8))
            return path
        a0, a1 = axes
        lo = all_pts[:, [a0, a1]].min(axis=0)
        hi = all_pts[:, [a0, a1]].max(axis=0)
        span = max((hi - lo).max(), 1e-9) * 1.1
        mid = (lo + hi) / 2

        def to_px(p):
            q = (p[[a0, a1]] - mid) / span + 0.5
            return q[0] * (size - 1), (1.0 - q[1]) * (size - 1)

        canvas = np.full((size, size, 3), 255, dtype=np.uint8)
        scene_scale = span * 0.05

        if self.draw_rays:
            for _, t in self._cams:
                for p in self._p1[:: max(len(self._p1) // 200, 1)]:
                    x0, y0 = to_px(t)
                    x1, y1 = to_px(p)
                    draw.draw_line(canvas, x0, y0, x1, y1, (220, 220, 220))
        for p in self._p1:
            x, y = to_px(p)
            draw.draw_circle(canvas, x, y, 2, draw.RED, thickness=-1)
        for p in self._p2:
            x, y = to_px(p)
            draw.draw_circle(canvas, x, y, 2, draw.BLACK, thickness=-1)
        for Rwc, twc in self._cams:
            for a, b in _frustum_segments(Rwc, twc, scene_scale):
                xa, ya = to_px(a)
                xb, yb = to_px(b)
                draw.draw_line(canvas, xa, ya, xb, yb, draw.BLUE)
        draw.write_png(path, canvas)
        return path
