"""Double-word arithmetic on torch tensors — the port of
``fractal_tpu/ops/dd.py``.

A value is the unevaluated sum ``hi + lo`` of two words: float32 words
("ds32", ~2⁻⁴⁸ relative precision) or float64 words ("dd64", ~2⁻¹⁰⁶).
Every function takes and returns (hi, lo) pairs and keeps the JAX
package's evaluation order operation for operation, so the plain torch
versions here and the CUDA kernels (``csrc/escape.cu`` for ds32,
``csrc/escape_f64.cu`` for dd64, built with ``-fmad=false``) round
identically.  The word type picks the Dekker splitter (2¹²+1 or 2²⁷+1)
and ``_fma``.

``_fma`` has no torch primitive (``torch.fma`` does not exist).  On f32
words it is emulated in float64: ``(a·b + c)`` with the f32 product exact
in f64, then rounded to f32.  Inside ``two_prod`` (c = −fl(a·b)) the f64
sum is exact too, so the emulation is the correctly rounded FMA.  In
``mul_f`` and ``mul`` the f64 sum can round once and the f32 cast again
("double rounding"); that disagrees with a true FMA about once in 2²⁹
calls.  The ds32 kernel calls ``__fmaf_rn`` at exactly these places.

On f64 words there is no wider type to widen to.  ``_fma`` is then the
JAX package's own fallback, ``_fma_dekker``: the exact Dekker product
p + e of a·b, then (p + c) + e, two roundings.  (The JAX package takes
that fallback on every backend: ``jax.lax`` has no ``fma``.)  Inside
``two_prod`` it gives the exact error word, as an FMA would; in ``mul_f``
and ``mul`` it differs from a single-rounded a·b + c in the lo word only,
at ~2⁻¹⁰⁶ relative.  The dd64 kernel writes out the same expression and no
``__fma_rn``.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch

SPLITTER_F32 = 4097.0  # Dekker/Veltkamp splitter 2^12 + 1 for 24-bit mantissas
SPLITTER_F64 = 134217729.0  # 2^27 + 1 for 53-bit mantissas


def _split_const(dtype) -> float:
    return SPLITTER_F64 if dtype == torch.float64 else SPLITTER_F32


def _fma(a, b, c):
    """a·b + c: through float64 on f32 words, ``_fma_dekker`` on f64 words
    (see the module docstring for how each rounds)."""
    if a.dtype == torch.float64:
        return _fma_dekker(a, b, c)
    return (a.double() * b.double() + c.double()).to(a.dtype)


def _fma_dekker(a, b, c):
    """The exact Dekker product p + e of a·b, then (p + c) + e."""
    p, e = _two_prod_dekker(a, b)
    return (p + c) + e


def _two_prod_dekker(a, b):
    """a·b = p + err exactly, by Dekker splits of both factors."""
    s = _split_const(a.dtype)
    aa = a * s
    a_hi = aa - (aa - a)
    a_lo = a - a_hi
    bb = b * s
    b_hi = bb - (bb - b)
    b_lo = b - b_hi
    p = a * b
    err = ((a_hi * b_hi - p) + a_hi * b_lo + a_lo * b_hi) + a_lo * b_lo
    return p, err


def two_sum(a, b):
    """Exact a + b = s + e, branch-free (Knuth)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def fast_two_sum(a, b):
    """Exact a + b = s + e, requires |a| >= |b| (Dekker)."""
    s = a + b
    e = b - (s - a)
    return s, e


def two_prod(a, b):
    """Exact a · b = p + e via FMA."""
    p = a * b
    e = _fma(a, b, -p)
    return p, e


def add(x, y):
    """Double-word + double-word (accurate variant)."""
    xh, xl = x
    yh, yl = y
    sh, sl = two_sum(xh, yh)
    th, tl = two_sum(xl, yl)
    c = sl + th
    vh, vl = fast_two_sum(sh, c)
    w = tl + vl
    return fast_two_sum(vh, w)


def add_f(x, y):
    """Double-word + single word."""
    xh, xl = x
    sh, sl = two_sum(xh, y)
    v = xl + sl
    return fast_two_sum(sh, v)


def neg(x):
    return -x[0], -x[1]


def sub(x, y):
    yh, yl = y
    return add(x, (-yh, -yl))


def mul(x, y):
    """Double-word × double-word."""
    xh, xl = x
    yh, yl = y
    ph, pl = two_prod(xh, yh)
    t = xl * yl
    t = _fma(xh, yl, t)
    t = _fma(xl, yh, t)
    return fast_two_sum(ph, pl + t)


def mul_f(x, y):
    """Double-word × single word."""
    xh, xl = x
    ph, pl = two_prod(xh, y)
    return fast_two_sum(ph, _fma(xl, y, pl))


def sqr(x):
    """Double-word square."""
    xh, xl = x
    ph, pl = two_prod(xh, xh)
    t = _fma(xh + xh, xl, pl)
    return fast_two_sum(ph, t)


def _split(a):
    """Dekker/Veltkamp split a = h + l, both halves multiplying exactly."""
    s = a * _split_const(a.dtype)
    h = s - (s - a)
    return h, a - h


def quad_step(zr, zi, cr, ci, *, cross_sign: float = 1.0):
    """One fused double-word step of z ← z² + c (``cross_sign=-1`` gives
    the tricorn's conjugate square); the JAX package's ``dd.quad_step``
    expression for expression."""
    xh, xl = zr
    yh, yl = zi
    a1, a2 = _split(xh)
    b1, b2 = _split(yh)

    p1 = xh * xh
    e1 = ((a1 * a1 - p1) + (a1 + a1) * a2) + a2 * a2
    p2 = yh * yh
    e2 = ((b1 * b1 - p2) + (b1 + b1) * b2) + b2 * b2
    p3 = xh * yh
    e3 = ((a1 * b1 - p3) + (a1 * b2 + a2 * b1)) + a2 * b2

    l1 = e1 + (xh + xh) * xl
    l2 = e2 + (yh + yh) * yl
    l3 = e3 + (xh * yl + xl * yh)

    s, e = two_sum(p1, -p2)
    s2, e2s = two_sum(s, cr[0])
    lo = ((l1 - l2) + e) + (cr[1] + e2s)
    nzr = fast_two_sum(s2, lo)

    ph = (cross_sign * 2.0) * p3
    pl = (cross_sign * 2.0) * l3
    s3, e3s = two_sum(ph, ci[0])
    nzi = fast_two_sum(s3, pl + (ci[1] + e3s))
    return nzr, nzi


def where(mask, x, y):
    return torch.where(mask, x[0], y[0]), torch.where(mask, x[1], y[1])


def split_str(s: str, dtype=np.float32, parts: int = 2):
    """Split a decimal string into ``parts`` words hi + lo (+ ...) exactly,
    with Python Fractions.  Returns numpy scalars of ``dtype``."""
    v = Fraction(s)
    out = []
    for _ in range(parts):
        f = dtype(float(v))
        out.append(f)
        v = v - Fraction(float(f))
    return tuple(out)
