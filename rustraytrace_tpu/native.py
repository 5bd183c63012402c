"""ctypes bindings for the native C++ runtime components (native/).

The reference's runtime is fully native (Rust); this build keeps the
compute path in JAX/Pallas and implements the host-side runtime pieces in
C++ (``native/src``): the PPM output formatter (render_io.rs analog) and the
SAH BVH builder / sphere clusterer (bvh.rs analog; no render path consumes
it yet).

The library is a build output, not a tracked file.

The shared library is built on demand with ``make -C native`` on first use;
every entry point has a NumPy fallback with identical semantics, so the
package works without a toolchain (the fallbacks are also the test oracles
for the C++ code).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_LIB_PATH = os.path.join(_REPO, "native", "librtt_native.so")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if not os.path.exists(_LIB_PATH):
            try:
                subprocess.run(
                    ["make", "-C", os.path.join(_REPO, "native")],
                    capture_output=True, timeout=120, check=True,
                )
            except Exception:
                return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            return None
        lib.rtt_finalize_ppm_p3.restype = ctypes.c_longlong
        lib.rtt_u8_ppm_p3.restype = ctypes.c_longlong
        lib.rtt_cluster_spheres.restype = ctypes.c_int
        # AABB-primitive entry point (box clustering); guarded at call sites.
        # (The flattened-tree builders rtt_build_bvh/rtt_build_bvh_aabb
        # exist in the C++ lib as the clusterers' internal foundation; they
        # have no Python surface.)
        if hasattr(lib, "rtt_cluster_aabbs"):
            lib.rtt_cluster_aabbs.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _cptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


# ---------------------------------------------------------------------------
# PPM output
# ---------------------------------------------------------------------------


def ppm_p3_from_u8(img_u8: np.ndarray) -> bytes:
    """P3 text from an 8-bit image; C++ fast path, NumPy fallback."""
    img_u8 = np.ascontiguousarray(img_u8, np.uint8)
    h, w, _ = img_u8.shape
    lib = _load()
    if lib is not None:
        buf = ctypes.create_string_buffer(64 + h * w * 12)
        n = lib.rtt_u8_ppm_p3(_cptr(img_u8, ctypes.c_ubyte), h, w, buf)
        return ctypes.string_at(buf, n)
    import io

    out = io.StringIO()
    out.write(f"P3\n{w} {h}\n255\n")
    np.savetxt(out, img_u8.reshape(-1, 3), fmt="%d", delimiter=" ")
    return out.getvalue().encode()


def finalize_ppm_p3(accum: np.ndarray, spp: int) -> bytes:
    """(radiance sum, spp) -> P3 text, finalization fused in C++
    (render_io.rs:3-31 semantics)."""
    accum = np.ascontiguousarray(accum, np.float32)
    h, w, _ = accum.shape
    lib = _load()
    if lib is not None:
        buf = ctypes.create_string_buffer(64 + h * w * 12)
        n = lib.rtt_finalize_ppm_p3(
            _cptr(accum, ctypes.c_float), h, w, spp, buf)
        return ctypes.string_at(buf, n)
    from .render import finalize_image

    return ppm_p3_from_u8(finalize_image(accum, spp))


# ---------------------------------------------------------------------------
# SAH BVH / clustering
# ---------------------------------------------------------------------------


def build_sphere_clusters(centers: np.ndarray, radii: np.ndarray,
                          max_leaf: int = 16,
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                     np.ndarray]:
    """SAH treelet cut into clusters of <= max_leaf spheres.

    Returns (order [N] primitive permutation, cluster_start [C+1],
    cluster_min [C,3], cluster_max [C,3]).
    """
    centers = np.ascontiguousarray(centers, np.float32)
    radii = np.ascontiguousarray(radii, np.float32)
    n = centers.shape[0]
    lib = _load()
    if lib is not None:
        order = np.empty(n, np.int32)
        start = np.empty(n + 1, np.int32)
        cmin = np.empty((n, 3), np.float32)
        cmax = np.empty((n, 3), np.float32)
        nc = lib.rtt_cluster_spheres(
            _cptr(centers, ctypes.c_float), _cptr(radii, ctypes.c_float),
            n, max_leaf, _cptr(order, ctypes.c_int),
            _cptr(start, ctypes.c_int), _cptr(cmin, ctypes.c_float),
            _cptr(cmax, ctypes.c_float))
        if nc > 0:
            return order, start[: nc + 1].copy(), cmin[:nc].copy(), cmax[:nc].copy()
    from .ops.bvh import cluster_spheres_numpy

    return cluster_spheres_numpy(centers, radii, max_leaf)


def build_aabb_clusters(pmin: np.ndarray, pmax: np.ndarray,
                        max_leaf: int = 16,
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                   np.ndarray]:
    """SAH treelet cut over arbitrary primitive AABBs (box primitives get
    tight cluster bounds).  Same contract as :func:`build_sphere_clusters`."""
    pmin = np.ascontiguousarray(pmin, np.float32)
    pmax = np.ascontiguousarray(pmax, np.float32)
    n = pmin.shape[0]
    lib = _load()
    if lib is not None and hasattr(lib, "rtt_cluster_aabbs"):
        order = np.empty(n, np.int32)
        start = np.empty(n + 1, np.int32)
        cmin = np.empty((n, 3), np.float32)
        cmax = np.empty((n, 3), np.float32)
        nc = lib.rtt_cluster_aabbs(
            _cptr(pmin, ctypes.c_float), _cptr(pmax, ctypes.c_float),
            n, max_leaf, _cptr(order, ctypes.c_int),
            _cptr(start, ctypes.c_int), _cptr(cmin, ctypes.c_float),
            _cptr(cmax, ctypes.c_float))
        if nc > 0:
            return order, start[: nc + 1].copy(), cmin[:nc].copy(), cmax[:nc].copy()
    from .ops.bvh import cluster_aabbs_numpy

    return cluster_aabbs_numpy(pmin, pmax, max_leaf)


