"""ctypes binding of the native high-precision orbit walker
(``native/orbitwalk.cpp``), with the port's own loader.

Port of ``fractal_tpu/ops/native_walk.py``.  ``orbitwalk.cpp`` replicates
mpmath's arbitrary-precision arithmetic bit for bit (same raw-mpf rounding,
same per-algo op sequence as ``perturb._host_step``) and runs the reference
walk natively.  At first use it is compiled with ``g++ -O3 -fPIC -shared``
into ``build/fractal_tpu_torch/liborbitwalk_<hash>.so`` at the root of the
checkout, keyed by a hash of the source; ``native/`` is only read.  A failed
compile raises with g++'s stderr, and a missing library is an error.

``walk()`` and ``direct()`` keep the reference's contract: ``None`` means
the walker declined this input (it would leave the replicated mpmath fast
paths), and the caller then runs the mpmath loop, which gives the same
rows bit for bit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Optional, Tuple

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOURCE = os.path.join(_ROOT, "native", "orbitwalk.cpp")
BUILD_DIR = os.path.join(_ROOT, "build", "fractal_tpu_torch")
CXX_FLAGS = ("-O3", "-fPIC", "-shared")
ABI_VERSION = 1

_ALGO_IDS = {"zsq": 0, "zpow": 1, "burningship": 2, "tricorn": 3}

_LIB = None
# Held while ``_load()`` builds, so threads that render at once build one
# library, not one each into one file.
_LOAD_LOCK = threading.Lock()
#: What the last build did: library path and g++ seconds (0 when it existed).
BUILD_INFO: dict = {}
#: Walks the native library finished (``walk`` and ``direct``); a declined
#: input is not counted.
WALKS = {"walk": 0, "direct": 0}


def library_path() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"liborbitwalk_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile ``native/orbitwalk.cpp`` unless the library for this source
    exists; raises with g++'s stderr when the compile fails."""
    out = library_path()
    if os.path.exists(out):
        BUILD_INFO.update(path=out, seconds=0.0)
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native orbit walker cannot be built")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [cxx, *CXX_FLAGS, SOURCE, "-o", tmp]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed (exit {proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stderr}{proc.stdout}")
    os.replace(tmp, out)
    BUILD_INFO.update(path=out, seconds=seconds)
    return out


def _load() -> ctypes.CDLL:
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LOAD_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build())
            if lib.orbitwalk_abi_version() != ABI_VERSION:
                raise RuntimeError(f"orbitwalk ABI {lib.orbitwalk_abi_version()}, "
                                   f"want {ABI_VERSION}")
            u8p = ctypes.POINTER(ctypes.c_uint8)
            lib.orbitwalk_run.argtypes = (
                [ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong]
                + [ctypes.c_int, ctypes.c_longlong, u8p, ctypes.c_longlong] * 4
                + [ctypes.c_longlong, ctypes.c_double, ctypes.POINTER(ctypes.c_double)])
            lib.orbitwalk_run.restype = ctypes.c_longlong
            lib.orbitwalk_direct.argtypes = lib.orbitwalk_run.argtypes
            lib.orbitwalk_direct.restype = ctypes.c_longlong
            _LIB = lib
    return _LIB


def available() -> bool:
    """Whether the walker builds and loads here (g++ present, ABI matches)."""
    try:
        _load()
    except (RuntimeError, OSError):
        return False
    return True


def _mpf_args(raw):
    """(sign, exp, man_bytes, len, keep-alive buffer) ctypes args from an
    mpmath raw mpf tuple, or None for a non-finite special."""
    sign, man, exp, bc = raw
    if man == 0 and exp != 0:  # inf/nan
        return None
    buf = int(man).to_bytes((int(bc) + 7) // 8, "little") if man else b""
    arr = (ctypes.c_uint8 * max(len(buf), 1)).from_buffer_copy(buf or b"\0")
    return (ctypes.c_int(int(sign)), ctypes.c_longlong(int(exp)),
            ctypes.cast(arr, ctypes.POINTER(ctypes.c_uint8)),
            ctypes.c_longlong(len(buf)), arr)


def _call(fn_name: str, algo: str, power: int, prec: int, z0, c,
          iters: int, limit_sq: float, out: np.ndarray):
    """Shared argument packing of the two entry points: the break index n,
    or None when the walker declines the input."""
    if algo in ("mandelbrot", "julia", "multibrot"):
        kind = "zsq" if power == 2 else "zpow"
    elif algo in ("burningship", "tricorn"):
        kind = algo
    else:
        return None
    packed = []
    for raw in (z0._mpc_[0], z0._mpc_[1], c._mpc_[0], c._mpc_[1]):
        a = _mpf_args(raw)
        if a is None:
            return None
        packed.append(a)
    lib = _load()
    args = [ctypes.c_int(_ALGO_IDS[kind]), ctypes.c_longlong(int(power)),
            ctypes.c_longlong(int(prec))]
    for a in packed:
        args.extend(a[:4])  # a[4] keeps the byte buffer alive
    args.extend([ctypes.c_longlong(int(iters)), ctypes.c_double(limit_sq),
                 out.ctypes.data_as(ctypes.POINTER(ctypes.c_double))])
    n = getattr(lib, fn_name)(*args)
    return None if n < 0 else int(n)


def walk(algo: str, power: int, prec: int, z0, c, iters: int,
         limit_sq: float) -> Optional[Tuple[np.ndarray, int]]:
    """Native replica of the mpmath loop of ``perturb.reference_orbit``:
    ``(zs, n)`` with ``zs`` the (iters+1, 2) f64 rows 0..n (rows past n
    uninitialized, like the loop's ``np.empty`` buffer), or None."""
    zs = np.empty((iters + 1, 2), np.float64)
    n = _call("orbitwalk_run", algo, power, prec, z0, c, iters, limit_sq, zs)
    if n is None:
        return None
    WALKS["walk"] += 1
    return zs, n


def direct(algo: str, power: int, prec: int, z0, c, iters: int,
           limit_sq: float) -> Optional[Tuple[float, float, int]]:
    """Native replica of ``perturb._direct_resolve``'s per-pixel loop
    (mpf-exact escape test, escaping step not counted): (zr, zi, n), or None."""
    out = np.empty(2, np.float64)
    n = _call("orbitwalk_direct", algo, power, prec, z0, c, iters, limit_sq, out)
    if n is None:
        return None
    WALKS["direct"] += 1
    return float(out[0]), float(out[1]), n
