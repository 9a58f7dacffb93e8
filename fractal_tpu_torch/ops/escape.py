"""Escape-time iteration on whole tensors (port of
``fractal_tpu/ops/escape_jnp.py``): the route of the CPU f32 and f64
renders, of explicit ``f64`` on any device, and of f32 under
``backend="jnp"`` (``render.render_u8``).

Count semantics (calc/src/lib.rs:245-257): step i computes
z' = rule(z) + c; if |z'|² > limit² the pixel escapes with count i and
z_final = z'; a pixel that never escapes ends with count = iterations (a
NaN |z'|² is no escape).

``iterate`` is the plain version (``iterate_grid_plain`` on a pixel
grid); ``iterate_grid`` is the wrapper that the renders call on a
``viewport.pixel_grid``: on CPU tensors it runs the plain version, on a
CUDA (rows, W) grid it launches ``csrc/escape_f64.cu``'s loop in its word
type: ``escape_time_f64`` on f64 (one thread a pixel), ``escape_time_f32_grid``
on f32 (carried squares, two steps a pass, 8×4 warp tiles).

``iterate_grid_color`` is the f32 route of a frame in one launch
(``escape_time_f32_grid_color``): the kernel forms each pixel's c as
``pixel_grid`` does, runs the f32 loop and colors the pixel on
``escape_cuda.color_params``' block, 3 B a pixel out; its plain version
``iterate_grid_color_plain`` is ``pixel_grid``, ``iterate_grid_plain`` and
the coloring of ``render._color_and_downsample`` at supersample 1.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from fractal_tpu_torch.models.rules import Rule, get_rule
from fractal_tpu_torch.ops.escape_cuda import COLOR_FIELDS, _rule_id, color_plain
from fractal_tpu_torch.ops.viewport import pixel_grid

#: Steps between the whole-image "anything still active?" checks.
CHUNK = 32
#: Launches of ``escape_time_f64`` and of ``escape_time_f32_grid`` by
#: ``iterate_grid``, and of ``escape_time_f32_grid_color`` by
#: ``iterate_grid_color`` (plain runs excluded).
F64_LAUNCHES = 0
F32_GRID_LAUNCHES = 0
F32_GRID_COLOR_LAUNCHES = 0
#: Steps the f32 grid loop of ``csrc/escape_f64.cu`` takes a pass (one exit test).
F32_GRID_STEPS_PER_PASS = 2


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
    a CUDA (rows, W) grid, cr and ci both f64 or both f32, launches
    ``escape_time_f64`` or ``escape_time_f32_grid``.  Any other type, shape
    or device raises."""
    if cr.device.type == "cpu":
        return iterate_grid_plain(cr, ci, algo=algo, power=power, iterations=iterations,
                                  limit=limit, julia_set=julia_set)
    if cr.dtype not in (torch.float64, torch.float32):
        raise ValueError(f"cr must be float64 or float32, got {cr.dtype}")
    for name, t in (("cr", cr), ("ci", ci)):
        if t.device != cr.device or t.dtype != cr.dtype or t.shape != cr.shape:
            raise ValueError(f"{name} must be a {cr.dtype} tensor of cr's shape on "
                             f"{cr.device}, got {t.dtype}{tuple(t.shape)} on {t.device}")
    if cr.dim() != 2 or cr.numel() == 0:
        raise ValueError(f"the grid must be a non-empty (rows, W) tensor, got "
                         f"{tuple(cr.shape)}")
    if cr.device.type != "cuda":
        raise ValueError(f"the grid kernels run on cuda, not {cr.device}")
    if iterations < 0:
        raise ValueError("iterations must be >= 0")
    from fractal_tpu_torch.ops import _cuda_build

    rule = _rule_id(algo, power)
    cr, ci = cr.contiguous(), ci.contiguous()
    zr, zi = torch.empty_like(cr), torch.empty_like(ci)
    cnt = torch.empty(cr.shape, dtype=torch.int32, device=cr.device)
    f32 = cr.dtype == torch.float32
    word = np.float32 if f32 else float
    jr, ji, limit_sq = _constants(word, limit, julia_set)
    lib = _cuda_build.load()
    stream = torch.cuda.current_stream(cr.device).cuda_stream
    julia = int(julia_set is not None)
    if f32:
        err = lib.fractal_escape_f32_grid(
            cr.data_ptr(), ci.data_ptr(), jr, ji, limit_sq, rule, julia, int(power),
            int(iterations), cr.shape[0], cr.shape[1], zr.data_ptr(), zi.data_ptr(),
            cnt.data_ptr(), stream)
    else:
        err = lib.fractal_escape_f64(
            cr.data_ptr(), ci.data_ptr(), jr, ji, limit_sq, rule, julia, int(power),
            int(iterations), cr.numel(), zr.data_ptr(), zi.data_ptr(), cnt.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"escape {'f32 grid' if f32 else 'f64'} kernel launch failed: "
                           f"{_cuda_build.error_string(err)}")
    global F64_LAUNCHES, F32_GRID_LAUNCHES
    if f32:
        F32_GRID_LAUNCHES += 1
    else:
        F64_LAUNCHES += 1
    return zr, zi, cnt


def _constants(word, limit, julia_set):
    """The plain version's constants in the word type ``word``: julia's c
    (0 for the mandelbrot family) and the limit rounded to it, the limit
    squared in it (inf where it overflows, as ``iterate``'s does)."""
    jr, ji = (0.0, 0.0) if julia_set is None else (float(word(v)) for v in julia_set)
    lim = word(limit)
    with np.errstate(over="ignore"):
        return jr, ji, float(lim * lim)


def _grid_view(width: int, height: int, pos, scale, row0: int):
    """``pixel_grid``'s constants as the colored form takes them: h, off_re,
    scale, pos and row0, each rounded to f32 as ``pixel_grid`` rounds it."""
    vals = (height, (float(width) / float(height)) / 2.0, scale[0], scale[1], pos[0], pos[1],
            row0)
    return (ctypes.c_double * 7)(*(float(np.float32(float(v))) for v in vals))


def grid_c_probe(width: int, height: int, pos, scale, row0: int = 0, rows: int = None,
                 device="cuda"):
    """The (cr, ci) that ``escape_time_f32_grid_color`` forms for rows
    [row0, row0 + rows) of the view, read back from the card (a check of
    the kernel's c against ``pixel_grid``'s)."""
    from fractal_tpu_torch.ops import _cuda_build

    rows = height if rows is None else rows
    cr = torch.empty((rows, width), dtype=torch.float32, device=device)
    ci = torch.empty_like(cr)
    if cr.device.type != "cuda":
        raise ValueError(f"the probe runs on cuda, not {cr.device}")
    err = _cuda_build.load().fractal_grid_c_probe(
        _grid_view(width, height, pos, scale, row0), rows, width, cr.data_ptr(), ci.data_ptr(),
        torch.cuda.current_stream(cr.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"grid c probe launch failed: {_cuda_build.error_string(err)}")
    return cr, ci


def iterate_grid_color_plain(color, *, width: int, height: int, pos, scale, algo: str,
                             power: int, iterations: int, limit, julia_set=None,
                             inside: bool = True, smooth: bool = True, row0: int = 0,
                             rows: int = None):
    """Rows [row0, row0 + rows) (all ``height`` by default) of a width ×
    height view on f32 words, colored on ``color`` (f32[9] from
    ``escape_cuda.color_params``) on its device → (rows, width, 3) uint8:
    ``pixel_grid``, ``iterate_grid_plain``, and the coloring of
    ``render._color_and_downsample`` at supersample 1."""
    cr, ci = pixel_grid(width, height, pos, scale, dtype=torch.float32, device=color.device,
                        row0=row0, rows=rows)
    zr, zi, cnt = iterate_grid_plain(cr, ci, algo=algo, power=power, iterations=iterations,
                                     limit=limit, julia_set=julia_set)
    return color_plain(zr, zi, cnt, color, inside=inside, smooth=smooth)


def iterate_grid_color(color, *, width: int, height: int, pos, scale, algo: str, power: int,
                       iterations: int, limit, julia_set=None, inside: bool = True,
                       smooth: bool = True, row0: int = 0, rows: int = None):
    """``iterate_grid_color_plain``'s function on ``color``'s device: a CPU
    block runs it; a CUDA one (a contiguous float32 (9,) tensor) launches
    ``escape_time_f32_grid_color``, which forms each pixel's c from
    ``pixel_grid``'s constants rounded to f32 here.  Anything else raises."""
    if color.device.type == "cpu":
        return iterate_grid_color_plain(
            color, width=width, height=height, pos=pos, scale=scale, algo=algo, power=power,
            iterations=iterations, limit=limit, julia_set=julia_set, inside=inside,
            smooth=smooth, row0=row0, rows=rows)
    if color.device.type != "cuda" or color.dtype != torch.float32 \
            or color.shape != (COLOR_FIELDS,) or not color.is_contiguous():
        raise ValueError(f"color must be a contiguous float32 tensor of shape "
                         f"({COLOR_FIELDS},) on cuda, got {color.dtype}"
                         f"{tuple(color.shape)} on {color.device}")
    rows = height if rows is None else rows
    if width <= 0 or height <= 0 or rows <= 0 or row0 < 0 or iterations < 0:
        raise ValueError("width, height and rows must be positive, row0 and iterations "
                         ">= 0")
    from fractal_tpu_torch.ops import _cuda_build

    rule = _rule_id(algo, power)
    jr, ji, limit_sq = _constants(np.float32, limit, julia_set)
    out = torch.empty((rows, width, 3), dtype=torch.uint8, device=color.device)
    err = _cuda_build.load().fractal_escape_f32_grid_color(
        _grid_view(width, height, pos, scale, row0), jr, ji, limit_sq, rule,
        int(julia_set is not None), int(power), int(iterations), rows, width, color.data_ptr(), int(bool(inside)), int(bool(smooth)), out.data_ptr(),
        torch.cuda.current_stream(color.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"escape f32 grid color kernel launch failed: "
                           f"{_cuda_build.error_string(err)}")
    global F32_GRID_COLOR_LAUNCHES
    F32_GRID_COLOR_LAUNCHES += 1
    return out


def bind(lib: ctypes.CDLL) -> None:
    """Declare the C signatures of ``csrc/escape_f64.cu``'s grid-loop entry
    points (f64, f32 and f32 colored)."""
    p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.fractal_escape_f64.argtypes = [p, p, d, d, d, i, i, i, i, ctypes.c_long, p, p, p, p]
    lib.fractal_escape_f32_grid.argtypes = [p, p, d, d, d, i, i, i, i, i, i, p, p, p, p]
    lib.fractal_escape_f32_grid_color.argtypes = [ctypes.POINTER(d), d, d, d, i, i, i, i, i, i,
                                                  p, i, i, p, p]
    lib.fractal_grid_c_probe.argtypes = [ctypes.POINTER(d), i, i, p, p, p]
    for fn in (lib.fractal_escape_f64, lib.fractal_escape_f32_grid,
               lib.fractal_escape_f32_grid_color, lib.fractal_grid_c_probe):
        fn.restype = i
