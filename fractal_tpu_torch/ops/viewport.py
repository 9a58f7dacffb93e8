"""Pixel grid → complex plane (port of ``fractal_tpu/ops/viewport.py``).

Reference transform (calc/src/lib.rs:181-197):
``((coord / height) − offset) / scale + pos``, re offset (width/height)/2,
im offset 0.5, integer pixel indices.  ``pixel_grid`` is the route of the
CPU f32 and f64 renders; the kernels and the p32 host side take the same
transform as exact rationals from ``affine_fractions``.
"""

from __future__ import annotations

from fractions import Fraction

import torch


def affine_fractions(width: int, height: int, pos, scale):
    """c = u·A + C per axis as exact rationals, with A = 1/(h·s) and
    C = p − off/s: [(A_re, C_re), (A_im, C_im)]."""
    out = []
    for axis, (p, s) in enumerate(zip(pos, scale)):
        off = Fraction(width, height * 2) if axis == 0 else Fraction(1, 2)
        a = Fraction(1) / (Fraction(height) * Fraction(float(s)))
        pf = p if isinstance(p, Fraction) else Fraction(float(p))
        c = pf - off / Fraction(float(s))
        out.append((a, c))
    return out


def pixel_grid(width: int, height: int, pos, scale, dtype=torch.float32,
               device="cuda", row0: int = 0, rows: int = None, stride: int = 1):
    """(cr, ci) of shape (rows, width) for global rows row0 + r·stride,
    r < rows, of the full grid (normalised by the full ``height``):
    [row0, row0 + rows) by default, a mesh shard's interleaved stripe with
    ``stride`` the shard count."""
    if rows is None:
        rows = height

    def const(v):
        return torch.tensor(float(v), dtype=dtype, device=device)

    x = torch.arange(width, dtype=dtype, device=device).expand(rows, width)
    r = torch.arange(rows, dtype=dtype, device=device)[:, None]
    if stride != 1:
        r = r * const(stride)  # integer-valued, exact
    y = (r + const(row0)).expand(rows, width)
    h = const(height)
    off_re = const((float(width) / float(height)) / 2.0)
    cr = (x / h - off_re) / const(scale[0]) + const(pos[0])
    ci = (y / h - const(0.5)) / const(scale[1]) + const(pos[1])
    return cr, ci
