"""Kernel H, the fern's hit histogram: the plain torch version and the
wrapper over ``csrc/hist.cu``.

Replaces ``tools/fern_hist_pallas.py::hist_pallas``: the count of each
flat bin index in [0, n_bins), indices outside dropped (the walk's drop
sentinel is n_bins).  Unlike the TPU kernel it adds into a histogram the
caller owns, so the fern hands it one batch of steps after another.  The
wrapper runs the plain version only for CPU tensors and launches the
kernel for CUDA tensors.
"""

from __future__ import annotations

import ctypes

import torch

from fractal_tpu_torch.ops import _cuda_build

#: Kernel launches made by ``hist_accumulate`` (plain-version calls excluded).
LAUNCHES = 0


def hist_accumulate_plain(idx, hist):
    """Plain torch version: ``hist[v] += 1`` for every ``v`` of ``idx`` in
    [0, hist.numel()), in place; returns ``hist``."""
    n_bins = hist.numel()
    flat = idx.reshape(-1)
    kept = flat[(flat >= 0) & (flat < n_bins)].long()
    hist += torch.bincount(kept, minlength=n_bins).to(hist.dtype)
    return hist


def hist_accumulate(idx, hist):
    """Kernel H on ``hist``'s device: add the histogram of the int32 bin
    indices ``idx`` (any shape) to the int32 ``hist`` (n_bins,), in place;
    indices outside [0, n_bins) are dropped.  Returns ``hist``."""
    if idx.device.type == "cpu" and hist.device.type == "cpu":
        return hist_accumulate_plain(idx, hist)
    for name, t in (("idx", idx), ("hist", hist)):
        if t.device.type != "cuda" or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32 CUDA tensor, got "
                             f"{(t.dtype, t.device)}")
    if idx.device != hist.device:
        raise ValueError(f"idx on {idx.device} but hist on {hist.device}")
    if hist.dim() != 1 or hist.numel() == 0 or idx.numel() == 0:
        raise ValueError(f"want hist (n_bins,) and a non-empty idx, got "
                         f"{tuple(hist.shape)} and {tuple(idx.shape)}")
    err = _cuda_build.load().fractal_hist_accumulate(
        idx.data_ptr(), idx.numel(), hist.data_ptr(), hist.numel(),
        torch.cuda.current_stream(hist.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"hist kernel launch failed: {_cuda_build.error_string(err)}")
    global LAUNCHES
    LAUNCHES += 1
    return hist


def bind(lib: ctypes.CDLL) -> None:
    """Declare the C signature of ``csrc/hist.cu``'s entry point."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fractal_hist_accumulate.argtypes = [p, ctypes.c_longlong, p, i, p]
    lib.fractal_hist_accumulate.restype = i
