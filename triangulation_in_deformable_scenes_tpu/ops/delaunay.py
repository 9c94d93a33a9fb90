"""Host-side 2D Delaunay triangulation of the landmark cloud.

The reference lifts the landmarks' (x, y) world coordinates into Qhull's 2D
Delaunay ("d Qbb Qt") and keeps the 3D points as mesh vertices
(``Modules/Utils/Geometry.cc:317-368``). Triangulation is inherently
data-dependent host work -- it runs once per outer refinement iteration, never
inside ``jit`` (the device consumes only the padded neighbor arrays built in
``mesh.py``).

Two interchangeable backends:

- native C++ Bowyer-Watson (``native/delaunay.cc``, loaded via ctypes) -- the
  production runtime path, no Python in the loop. The library is built from
  source with ``make -C native`` at first use when a C++ compiler is present;
- ``scipy.spatial.Delaunay`` (Qhull, same engine as the reference) -- fallback
  and cross-validation oracle in tests.

``CALLS`` counts the triangulations each backend produced in this process,
so a run can report which one meshed it.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import shutil
import subprocess

import numpy as np

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "native"
)
_LIB_PATH = os.path.join(_NATIVE_DIR, "libtids_native.so")
_NATIVE = None
_NATIVE_TRIED = False

CALLS = {"native": 0, "scipy": 0}


def _build_native() -> bool:
    """``make -C native`` under a file lock (parallel test workers may all
    reach the first mesh at once). Returns whether the library exists."""
    if os.path.exists(_LIB_PATH):
        return True
    if not (os.path.isdir(_NATIVE_DIR) and shutil.which("make") and shutil.which("g++")):
        return False
    with open(os.path.join(_NATIVE_DIR, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(_LIB_PATH):
            subprocess.run(
                ["make", "-s", "-C", _NATIVE_DIR],
                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL, check=False,
            )
    return os.path.exists(_LIB_PATH)


def _load_native():
    global _NATIVE, _NATIVE_TRIED
    if _NATIVE_TRIED:
        return _NATIVE
    _NATIVE_TRIED = True
    if _build_native():
        lib = ctypes.CDLL(_LIB_PATH)
        lib.tids_delaunay2d.restype = ctypes.c_int
        lib.tids_delaunay2d.argtypes = [
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        _NATIVE = lib
    return _NATIVE


def delaunay_triangles(xy: np.ndarray, backend: str = "auto") -> np.ndarray:
    """Triangulate 2D points; returns int32 triangle indices [T, 3].

    backend: "auto" (native if built, else scipy), "native", or "scipy".
    """
    xy = np.ascontiguousarray(xy, dtype=np.float64)
    n = len(xy)
    if n < 3:
        raise ValueError("Not enough points to create a triangular mesh.")

    if backend in ("auto", "native"):
        lib = _load_native()
        if lib is not None:
            cap = 2 * n + 16
            tri = np.empty((cap, 3), dtype=np.int32)
            ntri = ctypes.c_int(0)
            rc = lib.tids_delaunay2d(
                xy.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                n,
                tri.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
                ctypes.byref(ntri),
            )
            if rc == 0:
                CALLS["native"] += 1
                return np.ascontiguousarray(tri[: ntri.value])
            if backend == "native":
                raise RuntimeError(f"native delaunay failed with rc={rc}")
        elif backend == "native":
            raise RuntimeError("native delaunay library not built")

    from scipy.spatial import Delaunay

    # Qhull options mirror the reference's "d Qbb Qt" (Geometry.cc:339).
    CALLS["scipy"] += 1
    return Delaunay(xy, qhull_options="Qbb Qt").simplices.astype(np.int32)
