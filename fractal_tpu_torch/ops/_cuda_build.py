"""Build and load the port's CUDA kernels.

``nvcc`` compiles every ``csrc/*.cu`` at first use into one shared library
with a plain C interface, ``build/fractal_tpu_torch/lib<hash>.so`` at the
root of the checkout, keyed by a hash of the sources and the flags; it is
loaded with ctypes.  ``-fmad=false`` keeps nvcc from contracting a*b + c
into an FMA, so the kernels round like their plain torch versions; the
kernels call ``__fmaf_rn`` themselves where the reference calls an FMA.
A missing ``nvcc`` or a failed build raises with nvcc's own message.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "fractal_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC")

_LIB = None
#: What the last ``load()`` did: library path, build seconds (0 when the
#: library was already built) and ptxas's register/spill report.
BUILD_INFO: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (neither on PATH nor under CUDA_HOME)")
    return path


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                  + glob.glob(os.path.join(CSRC, "*.cuh")))


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the kernels unless the library for these sources exists."""
    out = library_path()
    if os.path.exists(out):
        BUILD_INFO.update(path=out, seconds=0.0, log="")
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *[s for s in _sources() if s.endswith(".cu")]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stderr}{proc.stdout}")
    os.replace(tmp, out)
    BUILD_INFO.update(path=out, seconds=seconds, log=proc.stderr + proc.stdout)
    return out


def load() -> ctypes.CDLL:
    """The kernel library, built on first use, with its C signatures set."""
    global _LIB
    if _LIB is None:
        from fractal_tpu_torch.ops import escape_cuda, perturb_cuda

        lib = ctypes.CDLL(build())
        escape_cuda.bind(lib)
        perturb_cuda.bind(lib)
        lib.fractal_error_string.argtypes = [ctypes.c_int]
        lib.fractal_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def error_string(err: int) -> str:
    return f"{load().fractal_error_string(err).decode()} (cudaError {err})"
