"""Build and load the port's CUDA kernels.

``nvcc`` compiles every ``csrc/*.cu`` at first use, one process per
source, all started together, and links the objects into one shared
library with a plain C interface, ``build/fractal_tpu_torch/lib<hash>.so``
at the root of the checkout, keyed by a hash of the sources and the flags;
it is loaded with ctypes.  ``-fmad=false`` keeps nvcc from contracting a*b + c
into an FMA, so the kernels round like their plain torch versions; the
kernels call ``__fmaf_rn`` themselves where the reference calls an FMA.
A missing ``nvcc`` or a failed build raises with nvcc's own message.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "fractal_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xptxas=-v", "-Xcompiler", "-fPIC")

_LIB = None
# Held while ``load()`` builds, so threads that render at once (the viewer's
# worker and its screenshot) build one library, not one each into one file.
_LOAD_LOCK = threading.Lock()
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
    nvcc = _nvcc()
    tag = f"{out}.{os.getpid()}"
    t0 = time.perf_counter()
    jobs = []
    for src in _sources():
        if src.endswith(".cu"):
            obj = f"{tag}.{os.path.basename(src)}.o"
            cmd = [nvcc, *NVCC_FLAGS, "-c", src, "-o", obj]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log = []
    failed = None
    for cmd, _, proc in jobs:
        text = proc.communicate()[0]
        log.append(text)
        if proc.returncode != 0 and failed is None:
            failed = (cmd, proc.returncode, text)
    if failed is None:
        cmd = [nvcc, "-shared", "-o", f"{tag}.tmp", *[obj for _, obj, _ in jobs]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log.append(proc.stderr + proc.stdout)
        if proc.returncode != 0:
            failed = (cmd, proc.returncode, proc.stderr + proc.stdout)
    for _, obj, _ in jobs:
        if os.path.exists(obj):
            os.remove(obj)
    if failed is not None:
        cmd, rc, text = failed
        raise RuntimeError(f"nvcc failed (exit {rc}): {' '.join(cmd)}\n{text}")
    os.replace(f"{tag}.tmp", out)
    BUILD_INFO.update(path=out, seconds=time.perf_counter() - t0, log="".join(log))
    return out


def load() -> ctypes.CDLL:
    """The kernel library, built on first use, with its C signatures set."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LOAD_LOCK:
        if _LIB is None:
            from fractal_tpu_torch.ops import (escape, escape_cuda, hist_cuda, perturb_cuda,
                                               probe_cuda)

            lib = ctypes.CDLL(build())
            for module in (escape, escape_cuda, perturb_cuda, hist_cuda, probe_cuda):
                module.bind(lib)
            lib.fractal_error_string.argtypes = [ctypes.c_int]
            lib.fractal_error_string.restype = ctypes.c_char_p
            lib.fractal_smem_limits.argtypes = [ctypes.POINTER(ctypes.c_int)] * 4
            lib.fractal_smem_limits.restype = ctypes.c_int
            _LIB = lib
    return _LIB


_LIMITS: dict = {}


def smem_limits(device) -> tuple:
    """(shared memory a block may opt in to, what one SM holds, SMs, what
    the card keeps back for each block) of the CUDA ``device`` (an index or a
    torch device), in bytes, read once from the runtime."""
    import torch

    device = torch.device("cuda", device) if isinstance(device, int) else torch.device(device)
    key = device.index if device.index is not None else torch.cuda.current_device()
    if key not in _LIMITS:
        vals = [ctypes.c_int() for _ in range(4)]
        with torch.cuda.device(key):
            err = load().fractal_smem_limits(*vals)
        if err != 0:
            raise RuntimeError(f"cudaDeviceGetAttribute failed: {error_string(err)}")
        _LIMITS[key] = tuple(v.value for v in vals)
    return _LIMITS[key]


def kernel_resources(log: str):
    """[(kernel, registers, spill-store bytes)] from ptxas's ``-v`` report,
    names demangled by ``c++filt`` where the toolkit's host has it."""
    rows = []
    for chunk in log.split("Compiling entry function '")[1:]:
        name = chunk.split("'", 1)[0]
        regs = re.search(r"Used (\d+) registers", chunk)
        spill = re.search(r"(\d+) bytes spill stores", chunk)
        rows.append([name, int(regs.group(1)) if regs else -1,
                     int(spill.group(1)) if spill else 0])
    if rows and shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(r[0] for r in rows),
                               capture_output=True, text=True).stdout.splitlines()
        if len(names) == len(rows):
            for r, n in zip(rows, names):
                r[0] = n
    return [tuple(r) for r in rows]


def error_string(err: int) -> str:
    return f"{load().fractal_error_string(err).decode()} (cudaError {err})"
