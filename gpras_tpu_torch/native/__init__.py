"""ctypes loader for the native geometry engine (libgprasgeom.so).

Compiled lazily from ``geometry.cpp`` on first use (g++ is part of the
toolchain); falls back cleanly when no compiler is available — callers check
``available()`` and use the pure-Python approximations otherwise.

A copy of ``gpras_tpu/native/`` (host C++, not a device kernel). The library
is built into ``build/gpras_tpu_torch/`` beside the package, as the CUDA
kernels are, never into the package directory; its file name carries a hash
of ``geometry.cpp``, so an edited source is rebuilt. A build is written to a
temporary name and renamed, so processes that build at once do not load a
half-written file.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
from pathlib import Path

import numpy as np

log = logging.getLogger("gpras_tpu_torch.native")

_HERE = Path(__file__).resolve().parent
_SOURCE = _HERE / "geometry.cpp"
BUILD_DIR = _HERE.parents[1] / "build" / "gpras_tpu_torch"
_SO = BUILD_DIR / f"libgprasgeom-{hashlib.sha256(_SOURCE.read_bytes()).hexdigest()[:16]}.so"
_LIB: ctypes.CDLL | None = None
_TRIED = False


def _build() -> bool:
    tmp = _SO.with_name(f"{_SO.stem}.{os.getpid()}.tmp.so")
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", str(_SOURCE), "-o", str(tmp)],
            check=True, capture_output=True, timeout=120)
        os.replace(tmp, _SO)
        return True
    except Exception as e:  # no compiler / failure -> fallback path
        log.warning("native geometry build failed: %s", e)
        return False


def _load() -> ctypes.CDLL | None:
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    if not _SO.exists() and not _build():
        return None
    try:
        lib = ctypes.CDLL(str(_SO))
    except OSError as e:
        # A stale or foreign-platform .so (e.g. built on another arch/glibc).
        # Rebuild once for this platform and retry; degrade to the pure-Python
        # fallback if that also fails.
        log.warning("native geometry load failed (%s); rebuilding", e)
        if not _build():
            return None
        try:
            lib = ctypes.CDLL(str(_SO))
        except OSError as e2:
            log.warning("native geometry load failed after rebuild: %s", e2)
            return None
    dptr = ctypes.POINTER(ctypes.c_double)
    iptr = ctypes.POINTER(ctypes.c_int)
    u8ptr = ctypes.POINTER(ctypes.c_uint8)
    lib.pip_batch.argtypes = [dptr, ctypes.c_int, dptr, ctypes.c_int, u8ptr]
    lib.clip_area_convex.restype = ctypes.c_double
    lib.clip_area_convex.argtypes = [dptr, ctypes.c_int, dptr, ctypes.c_int]
    lib.best_overlap_batch.argtypes = [
        dptr, iptr, ctypes.c_int, ctypes.c_int, dptr, iptr, ctypes.c_int,
        ctypes.c_int, iptr, ctypes.c_int, iptr, dptr]
    lib.polyline_touches_poly.restype = ctypes.c_int
    lib.polyline_touches_poly.argtypes = [dptr, ctypes.c_int, dptr, ctypes.c_int]
    _LIB = lib
    return _LIB


def available() -> bool:
    return _load() is not None


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(
            "native geometry engine unavailable (no g++ / build failed); "
            "check native.available() and use the pure-Python fallback")
    return lib


def _dp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _ip(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))


def pip_batch(ring: np.ndarray, pts: np.ndarray) -> np.ndarray:
    lib = _require()
    ring = np.ascontiguousarray(ring, dtype=np.float64)
    pts = np.ascontiguousarray(pts, dtype=np.float64)
    out = np.zeros(len(pts), dtype=np.uint8)
    lib.pip_batch(_dp(ring), len(ring), _dp(pts), len(pts),
                  out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out.astype(bool)


def clip_area_convex(subject: np.ndarray, clip: np.ndarray) -> float:
    lib = _require()
    subject = np.ascontiguousarray(subject, dtype=np.float64)
    clip = np.ascontiguousarray(clip, dtype=np.float64)
    return float(lib.clip_area_convex(_dp(subject), len(subject),
                                      _dp(clip), len(clip)))


def best_overlap_batch(q_verts: np.ndarray, q_counts: np.ndarray,
                       c_verts: np.ndarray, c_counts: np.ndarray,
                       cand_idx: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Exact max-overlap pairing. Shapes: q_verts (nq, max_qv, 2),
    c_verts (nc, max_cv, 2) (padding repeats the first vertex), cand_idx
    (nq, max_cand) int32 -1-padded."""
    lib = _require()
    q_verts = np.ascontiguousarray(q_verts, dtype=np.float64)
    c_verts = np.ascontiguousarray(c_verts, dtype=np.float64)
    q_counts = np.ascontiguousarray(q_counts, dtype=np.int32)
    c_counts = np.ascontiguousarray(c_counts, dtype=np.int32)
    cand_idx = np.ascontiguousarray(cand_idx, dtype=np.int32)
    nq, max_qv = q_verts.shape[:2]
    nc, max_cv = c_verts.shape[:2]
    out_best = np.full(nq, -1, dtype=np.int32)
    out_area = np.zeros(nq, dtype=np.float64)
    lib.best_overlap_batch(_dp(q_verts), _ip(q_counts), nq, max_qv,
                           _dp(c_verts), _ip(c_counts), nc, max_cv,
                           _ip(cand_idx), cand_idx.shape[1],
                           _ip(out_best), _dp(out_area))
    return out_best, out_area


def polyline_touches_poly(line: np.ndarray, ring: np.ndarray) -> bool:
    lib = _require()
    line = np.ascontiguousarray(line, dtype=np.float64)
    ring = np.ascontiguousarray(ring, dtype=np.float64)
    return bool(lib.polyline_touches_poly(_dp(line), len(line),
                                          _dp(ring), len(ring)))
