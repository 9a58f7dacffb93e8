"""Coloring epilogue on torch tensors (port of ``fractal_tpu/ops/coloring.py``).

Semantics of the reference's classify/color tail (calc/src/lib.rs:214-234)
and ``color_multiply`` (calc:133-139): ``stable_limit`` compares against
the SQUARED final distance; the smooth term is log₂-based; inside shading
is secondary · dist; float → u8 follows Rust ``as`` (NaN → 0, truncate,
saturate); the stored g/b channels swap at render time.  Plain torch on
the render's device, as the reference leaves it to XLA, with its constants
in one block (``color_block``); kernel A's colored form
(``escape_cuda.iterate_color``) runs the same epilogue in its threads.
"""

from __future__ import annotations

import torch


def rust_u8_cast(x):
    """Rust ``f64 as u8``: NaN → 0, truncate toward zero, saturate."""
    x = torch.where(torch.isnan(x), torch.zeros_like(x), x)
    return torch.clamp(torch.trunc(x), 0.0, 255.0).to(torch.uint8)


def smooth_iters(cnt, dist, smooth: bool):
    """Fractional iteration count (calc:217-226)."""
    iters_f = cnt.to(dist.dtype)
    if not smooth:
        return iters_f
    log_zn = torch.log2(torch.sqrt(dist)) / 2.0
    nu = torch.log2(log_zn)
    return iters_f + (1.0 - nu)


def color_escape_result(zr, zi, cnt, **kw):
    """Map (zr, zi, cnt) to an (H, W, 3) image; see
    ``color_escape_result_dist`` for the keywords."""
    return color_escape_result_dist(zr * zr + zi * zi, cnt, **kw)


def color_escape_result_dist(dist, cnt, *, iterations: int, stable_limit,
                             exposure, primary_color, secondary_color,
                             inside: bool, smooth: bool,
                             as_float: bool = False):
    """Color from the squared final distance; ``as_float=True`` returns the
    pre-cast float image (NaN zeroed) for the supersample average."""
    block = color_block(iterations=iterations, stable_limit=stable_limit,
                        exposure=exposure, primary_color=primary_color,
                        secondary_color=secondary_color, dtype=dist.dtype,
                        device=dist.device)
    return color_from_block(dist, cnt, block, inside=inside, smooth=smooth,
                            as_float=as_float)


def color_block(*, iterations: int, stable_limit, exposure, primary_color,
                secondary_color, dtype=torch.float32, device="cpu"):
    """The coloring's constants in one (9,) tensor: stable_limit,
    iterations, exposure, then the primary and secondary colors in
    ``color_multiply``'s render-time g/b swap (calc:129, 133-139), each
    (r, b, g)."""
    p, s = primary_color, secondary_color
    return torch.tensor([float(stable_limit), float(iterations), float(exposure),
                         float(p[0]), float(p[2]), float(p[1]),
                         float(s[0]), float(s[2]), float(s[1])],
                        dtype=dtype, device=device)


def color_from_block(dist, cnt, block, *, inside: bool, smooth: bool,
                     as_float: bool = False):
    """``color_escape_result_dist`` with its constants in ``color_block``'s
    layout, a tensor on ``dist``'s device (so no scalar is uploaded)."""
    escaped = dist > block[0]
    iters_f = smooth_iters(cnt, dist, smooth)
    mult = iters_f / block[1] * block[2]

    out_escaped = block[3:6] * mult[..., None]
    if inside:
        out_inside = block[6:9] * dist[..., None]
    else:
        out_inside = torch.zeros_like(out_escaped)
    img = torch.where(escaped[..., None], out_escaped, out_inside)
    if as_float:
        return torch.where(torch.isnan(img), torch.zeros_like(img), img)
    return rust_u8_cast(img)


def downsample_box(img_float, factor: int):
    """k×k box filter for supersampling: average in float, then cast."""
    if factor == 1:
        return rust_u8_cast(img_float)
    h, w, c = img_float.shape
    img = img_float.reshape(h // factor, factor, w // factor, factor, c)
    return rust_u8_cast(img.mean(dim=(1, 3)))
