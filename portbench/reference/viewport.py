"""Pixel (u, v) -> c, as exact rationals.

The reference renderer's transform (calc/src/lib.rs:181-197):
c = ((coord / height) - offset) / scale + pos, with the real offset
(width / height) / 2 and the imaginary one 1/2, integer pixel indices, row v
of the image at imaginary coordinate v.  So c = u·A + C per axis, with
A = 1 / (height·scale) and C = pos - offset / scale; the scale is the f64
the scene holds, taken exactly.
"""

from __future__ import annotations

from fractions import Fraction


def centre(frame):
    """The view's centre (re, im) as exact rationals."""
    return tuple(Fraction(str(v)) for v in frame["pos_str"])


def affine(frame):
    """[(A_re, C_re), (A_im, C_im)] as Fractions."""
    w, h = frame["width"], frame["height"]
    out = []
    for axis, (p, s) in enumerate(zip(centre(frame), frame["scale"])):
        off = Fraction(w, 2 * h) if axis == 0 else Fraction(1, 2)
        s = Fraction(float(s))
        out.append((1 / (h * s), p - off / s))
    return out
