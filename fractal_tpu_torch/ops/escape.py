"""Escape-time iteration on whole tensors (port of
``fractal_tpu/ops/escape_jnp.py``): the route of the CPU f32 and f64
renders, of explicit ``f64`` on any device, and of f32 under
``backend="jnp"`` (``render.render_u8``).

Count semantics (calc/src/lib.rs:245-257): step i computes
z' = rule(z) + c; if |z'|² > limit² the pixel escapes with count i and
z_final = z'; a pixel that never escapes ends with count = iterations.

``iterate`` is the plain version (``iterate_grid_plain`` on a pixel
grid); ``iterate_grid`` is the wrapper that the renders call on a
``viewport.pixel_grid``: on CPU tensors it runs the plain version, on CUDA
tensors it launches ``csrc/escape_f64.cu``'s loop in their word type, one
thread a pixel: ``escape_time_f64`` on f64, ``escape_time_f32_grid`` on
f32.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from fractal_tpu_torch.models.rules import Rule, get_rule

#: Steps between the whole-image "anything still active?" checks.
CHUNK = 32
#: Launches of ``escape_time_f64`` and of ``escape_time_f32_grid`` by
#: ``iterate_grid`` (plain runs excluded).
F64_LAUNCHES = 0
F32_GRID_LAUNCHES = 0


def iterate(start_r, start_i, cr, ci, iterations: int, limit, rule: Rule):
    """Up to ``iterations`` steps of z ← rule(z) + c per element, frozen
    on escape.  Returns (zr, zi, cnt:int32)."""
    dtype = start_r.dtype
    zr, zi = start_r, start_i
    shape = zr.shape
    limit_sq = torch.tensor(float(limit), dtype=dtype, device=zr.device) ** 2
    cr = torch.broadcast_to(torch.as_tensor(cr, dtype=dtype, device=zr.device), shape)
    ci = torch.broadcast_to(torch.as_tensor(ci, dtype=dtype, device=zr.device), shape)
    cnt = torch.zeros(shape, dtype=torch.int32, device=zr.device)
    esc = torch.zeros(shape, dtype=torch.bool, device=zr.device)
    for step in range(iterations):
        if step % CHUNK == 0 and not bool((~esc & (cnt < iterations)).any()):
            break
        active = ~esc & (cnt < iterations)
        nzr, nzi = rule(zr, zi, cr, ci)
        d = nzr * nzr + nzi * nzi
        esc_now = active & (d > limit_sq)
        zr = torch.where(active, nzr, zr)
        zi = torch.where(active, nzi, zi)
        cnt = cnt + (active & ~esc_now).to(torch.int32)
        esc = esc | esc_now
    return zr, zi, cnt


def iterate_grid_plain(cr, ci, *, algo: str, power: int, iterations: int, limit,
                       julia_set=None):
    """``iterate`` on ``cr``'s device from z = (cr, ci), with c = (cr, ci)
    or, for a julia scene, the constant ``julia_set`` → (zr, zi,
    cnt:int32)."""
    rule = get_rule(algo, power)
    if julia_set is None:
        return iterate(cr, ci, cr, ci, iterations, limit, rule)
    c_r, c_i = (torch.tensor(float(v), dtype=cr.dtype, device=cr.device) for v in julia_set)
    return iterate(cr, ci, c_r, c_i, iterations, limit, rule)


def iterate_grid(cr, ci, *, algo: str, power: int, iterations: int, limit,
                 julia_set=None):
    """``iterate_grid_plain``'s function: CPU tensors (f32 or f64) run it;
    CUDA tensors, both f64 or both f32 and of one shape, launch
    ``escape_time_f64`` or ``escape_time_f32_grid``."""
    if cr.device.type == "cpu":
        return iterate_grid_plain(cr, ci, algo=algo, power=power, iterations=iterations,
                                  limit=limit, julia_set=julia_set)
    if cr.dtype not in (torch.float64, torch.float32):
        raise ValueError(f"cr must be float64 or float32, got {cr.dtype}")
    for name, t in (("cr", cr), ("ci", ci)):
        if t.device != cr.device or t.dtype != cr.dtype or t.shape != cr.shape:
            raise ValueError(f"{name} must be a {cr.dtype} tensor of cr's shape on "
                             f"{cr.device}, got {t.dtype}{tuple(t.shape)} on {t.device}")
    if iterations < 0 or cr.numel() == 0:
        raise ValueError("iterations must be >= 0 and the grid not empty")
    from fractal_tpu_torch.ops import _cuda_build
    from fractal_tpu_torch.ops.escape_cuda import _rule_id

    rule = _rule_id(algo, power)
    cr, ci = cr.contiguous(), ci.contiguous()
    zr, zi = torch.empty_like(cr), torch.empty_like(ci)
    cnt = torch.empty(cr.shape, dtype=torch.int32, device=cr.device)
    f32 = cr.dtype == torch.float32
    word = np.float32 if f32 else float
    # the plain version's constants: julia c and limit rounded to the word
    # type, limit squared in it
    jr, ji = (0.0, 0.0) if julia_set is None else (float(word(v)) for v in julia_set)
    lim = word(limit)
    lib = _cuda_build.load()
    entry = lib.fractal_escape_f32_grid if f32 else lib.fractal_escape_f64
    err = entry(
        cr.data_ptr(), ci.data_ptr(), jr, ji, float(lim * lim), rule,
        int(julia_set is not None), int(power), int(iterations), cr.numel(), zr.data_ptr(),
        zi.data_ptr(), cnt.data_ptr(), torch.cuda.current_stream(cr.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"escape {'f32 grid' if f32 else 'f64'} kernel launch failed: "
                           f"{_cuda_build.error_string(err)}")
    global F64_LAUNCHES, F32_GRID_LAUNCHES
    if f32:
        F32_GRID_LAUNCHES += 1
    else:
        F64_LAUNCHES += 1
    return zr, zi, cnt


def bind(lib: ctypes.CDLL) -> None:
    """Declare the C signatures of ``csrc/escape_f64.cu``'s grid-loop entry
    points (f64 and f32)."""
    p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    for fn in (lib.fractal_escape_f64, lib.fractal_escape_f32_grid):
        fn.argtypes = [p, p, d, d, d, i, i, i, i, ctypes.c_long, p, p, p, p]
        fn.restype = i
