"""ctypes bindings for the native polylp engine (native/polylp.cpp).

Loads the repository's prebuilt native/libpolylp.so; when that library does
not load on this machine, compiles native/polylp.cpp with g++ into
build/lbmpc_tpu_torch/ (never over the prebuilt file). Without a working
library, callers keep the scipy path (`available()` is False).
"""

from __future__ import annotations

import ctypes
import pathlib
import subprocess

import numpy as np

_ROOT = pathlib.Path(__file__).resolve().parent.parent.parent
_PREBUILT = _ROOT / "native" / "libpolylp.so"
_SRC = _ROOT / "native" / "polylp.cpp"
_BUILT = _ROOT / "build" / "lbmpc_tpu_torch" / "libpolylp.so"

_lib = None
_tried = False


def _load(path: pathlib.Path):
    try:
        return ctypes.CDLL(str(path))
    except OSError:
        return None


def _build() -> bool:
    _BUILT.parent.mkdir(parents=True, exist_ok=True)
    try:
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-o", str(_BUILT), str(_SRC)],
            check=True, capture_output=True, timeout=240,
        )
    except (OSError, subprocess.SubprocessError):
        return False
    return True


def get_lib():
    """Load the native library (building a local copy if needed), or None."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    lib = _load(_PREBUILT) if _PREBUILT.exists() else None
    if lib is None and _SRC.exists() and (_BUILT.exists() or _build()):
        lib = _load(_BUILT)
    if lib is None:
        return None
    dp = ctypes.POINTER(ctypes.c_double)
    lib.polylp_support.restype = ctypes.c_int
    lib.polylp_support.argtypes = [ctypes.c_int, ctypes.c_int, dp, dp, dp, dp, dp]
    lib.polylp_support_batch.restype = ctypes.c_int
    lib.polylp_support_batch.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, dp, dp, dp, dp]
    lib.polylp_min_hrep.restype = ctypes.c_int
    lib.polylp_min_hrep.argtypes = [
        ctypes.c_int, ctypes.c_int, dp, dp,
        ctypes.POINTER(ctypes.c_ubyte), ctypes.c_double,
    ]
    lib.polylp_vertices.restype = ctypes.c_int
    lib.polylp_vertices.argtypes = [
        ctypes.c_int, ctypes.c_int, dp, dp,
        ctypes.c_double, ctypes.c_double, ctypes.c_int, dp,
    ]
    _lib = lib
    return _lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def support(c: np.ndarray, F: np.ndarray, h: np.ndarray) -> float:
    """max c'x s.t. Fx <= h via the native IPM. Raises on failure; returns
    +inf for unbounded directions (matching the scipy path's convention)."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native polylp unavailable")
    c = np.ascontiguousarray(c, float)
    F = np.ascontiguousarray(F, float)
    h = np.ascontiguousarray(h, float)
    m, n = F.shape
    x = np.empty(n)
    val = ctypes.c_double()
    st = lib.polylp_support(n, m, _ptr(c), _ptr(F), _ptr(h), _ptr(x), ctypes.byref(val))
    if st == 2:
        return np.inf
    if st != 0:
        raise RuntimeError(f"polylp_support failed (status {st})")
    return float(val.value)


def support_batch(C: np.ndarray, F: np.ndarray, h: np.ndarray) -> np.ndarray:
    """max c'x s.t. Fx <= h for each row c of C (K, n) via the native IPM,
    one call for the K directions: (K,)."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native polylp unavailable")
    C = np.ascontiguousarray(C, float)
    F = np.ascontiguousarray(F, float)
    h = np.ascontiguousarray(h, float)
    K, n = C.shape
    m = F.shape[0]
    if F.shape != (m, n) or h.shape != (m,):
        raise ValueError(f"support_batch: C {C.shape}, F {F.shape} and h {h.shape} disagree")
    vals = np.empty(K)
    lib.polylp_support_batch(n, m, K, _ptr(C), _ptr(F), _ptr(h), _ptr(vals))
    return vals


def min_hrep_mask(F: np.ndarray, h: np.ndarray, tol: float = 1e-9) -> np.ndarray:
    """Boolean keep-mask of irredundant rows, computed natively."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native polylp unavailable")
    F = np.ascontiguousarray(F, float)
    h = np.ascontiguousarray(h, float)
    m, n = F.shape
    keep = np.zeros(m, np.uint8)
    kept = lib.polylp_min_hrep(
        n, m, _ptr(F), _ptr(h), keep.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), tol
    )
    if kept < 0:
        raise RuntimeError("polylp_min_hrep failed")
    return keep.astype(bool)


def vertices(F: np.ndarray, h: np.ndarray, feas_tol: float = 1e-9,
             dedup_tol: float = 1e-8, max_out: int = 8192) -> np.ndarray | None:
    """Vertex enumeration of {Fx<=h} via the native basic-solution core.

    Returns (V, n) vertices, or None when the instance is out of the native
    budget (too many row combinations / vertices) so the caller should fall
    back to qhull.
    """
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native polylp unavailable")
    F = np.ascontiguousarray(F, float)
    h = np.ascontiguousarray(h, float)
    m, n = F.shape
    V = np.empty((max_out, n))
    cnt = lib.polylp_vertices(n, m, _ptr(F), _ptr(h), feas_tol, dedup_tol,
                              max_out, _ptr(V))
    if cnt < 0:
        return None
    return V[:cnt].copy()


def available() -> bool:
    return get_lib() is not None
