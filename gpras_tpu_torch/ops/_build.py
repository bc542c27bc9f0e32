"""Build and load the package's CUDA kernels (``csrc/*.cu``).

nvcc compiles the sources into one shared library with a plain C interface
for ``sm_90a`` (Hopper), at first use, into ``build/gpras_tpu_torch/`` beside
the package (git-ignored): one nvcc process per source, all started together,
then one link. The library's file name carries a hash of the
sources and flags, so an edited source is rebuilt and a stale library is
never loaded. A failed build raises: nothing falls back.

nvcc is taken from ``$CUDA_HOME/bin``, then ``PATH``, then
``/usr/local/cuda/bin``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "gpras_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# the hyperparameters every kernel entry point takes (csrc/hyper.cuh): log
# variance, log lengthscales and their stride, then a scalar as a device
# pointer (or null) and by value: the noise, or kgrad's cotangent scale
_HYPER = [_P, _P, _I, _P, _F]
# argtypes of every C entry point: pointers and the stream as void*, sizes as int
# (gpras_kmv_sym also writes its count of launched grids to an int*)
_SIGNATURES = {
    "gpras_kmv_dense": [_I, _P, _P, _P, _P, _P, *_HYPER, _I, _I, _I, _I, _I, _I, _I, _P],
    "gpras_kmv_sym": [_I, _P, _P, _P, _P, _P, _P, _P, *_HYPER, _I, _I, _I, _I, _I, _I, _I, _I,
                      ctypes.POINTER(_I), _P],
    "gpras_gram": [_I, _P, _P, _P, _P, *_HYPER, _I, _I, _I, _I, _I, _I, _I, _P],
    "gpras_kgrad": [_I, _P, _P, _P, _P, *_HYPER, _F, _P, _P, _I, _I, _I, _I, _P],
    "gpras_kgrad_sym": [_I, _P, _P, _P, _P, *_HYPER, _F, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "gpras_kgrad_dense": [_I, _P, _P, _P, _P, *_HYPER, _F, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                          _P],
    "gpras_sqrt_rn": [_P, _P, ctypes.c_size_t, _P],
}


def _nvcc() -> str:
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(str(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc"))
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and Path(c).is_file():
            return c
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, PATH and "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be built")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libgpras_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds: list[list[str]]) -> str:
    """Start every command at once, wait for all; their joined output.
    Raises if any failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [proc.communicate()[0] for proc in procs]
    failed = [f"nvcc failed ({proc.returncode}):\n{' '.join(c)}\n{out}"
              for c, proc, out in zip(cmds, procs, outs) if proc.returncode != 0]
    if failed:
        raise RuntimeError("\n".join(failed))
    return "".join(outs)


def build() -> tuple[Path, str]:
    """Compile the sources if their library is missing. Returns (path, the
    compiler's output, which carries ptxas' register and spill report; empty
    when the library was already built)."""
    path = library_path()
    if path.is_file():
        return path, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    objs = [tmp.with_suffix(f".{src.stem}.o") for src in _sources()]
    try:
        log = _run_all([[_nvcc(), *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
                        for src, obj in zip(_sources(), objs)])
        log += _run_all([[_nvcc(), *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
                          *map(str, objs)]])
        os.replace(tmp, path)  # atomic: a concurrent loader never sees a partial file
    finally:
        for f in [tmp, *objs]:
            f.unlink(missing_ok=True)
    path.with_suffix(".log").write_text(log)
    return path, log


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call), with typed entry points."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
