"""Kernel A's ds32 step forms each exact product error in one FMA where
``ops/dd.py``'s ``quad_step`` (the JAX package's expression) forms it by
Dekker's splits; this file pins, on the CPU, where the two give the same bits.

An f32 × f32 product is exact in float64, and so is its difference from the
rounded f32 product, so ``(a·b − fl(a·b))`` computed in float64 and rounded to
float32 is what ``__fmaf_rn(a, b, -fl(a·b))`` returns.  Dekker's expression
equals it bit for bit for every product of 2^-100 and above (hi words of
2^-50 to 2^17, the loop's range, both signs, zero, powers of two and values
at the split's 12-bit boundary); under ~2^-108 the error reaches below the
smallest subnormal and the two part, which the second test records.  The
third holds a torch mirror of the kernel's ``quad_step`` (the three FMAs, p1
and p2 carried from |z|^2's squares) bit-equal to ``dd.quad_step`` for each
quadratic rule.  The last reads kernel A's ds32 loops out of a ``cuobjdump
-sass`` listing, as ``chip_smoke.py`` does on the card."""

from __future__ import annotations

import subprocess

import numpy as np
import pytest
import torch

from fractal_tpu_torch.ops import dd
from fractal_tpu_torch.tools import escape_bench

N = 1 << 20


def _log_uniform(r, n, lo, hi):
    """float32 values of magnitude 2^lo .. 2^hi, log-uniform, both signs."""
    mag = np.exp2(r.uniform(lo, hi, n))
    return torch.from_numpy((np.where(r.random(n) < 0.5, -mag, mag)).astype(np.float32))


def _boundary_values():
    """Zero, powers of two and values at the 12-bit split's boundary (12, 13
    and 24 significant bits, 2^12 ± 1, 1 ± 2^-12 ...), over the loop's range."""
    m = [0.0, 1.0, 1.5, 4095.0, 4096.0, 4097.0, 8191.0, 8193.0, 1 + 2.0 ** -11,
         1 + 2.0 ** -12, 1 + 2.0 ** -13, 1 - 2.0 ** -12, 1 - 2.0 ** -24, 2 - 2.0 ** -23,
         2 - 2.0 ** -12, 2 - 2.0 ** -11, 0x1FFF / 4096, 0xFFF / 2048, 0x1001 / 4096,
         0xFFFFFF / 2.0 ** 23, 0x800001 / 2.0 ** 23, 0xFFF001 / 2.0 ** 23,
         0x800FFF / 2.0 ** 23]
    scales = 2.0 ** np.arange(-50, 18, 7, dtype=np.float64)
    v = np.concatenate([np.outer(scales, m).ravel(), [0.0]]).astype(np.float32)
    v = np.concatenate([v, -v])
    return torch.from_numpy(v)


def _pairs(r, lo, hi):
    """(xh, yh): seeded log-uniform pairs, then every pair of the boundary values."""
    b = _boundary_values()
    bx, by = torch.meshgrid(b, b, indexing="ij")
    return (torch.cat([_log_uniform(r, N, lo, hi), bx.reshape(-1)]),
            torch.cat([_log_uniform(r, N, lo, hi), by.reshape(-1)]))


def _dekker(kind, xh, yh):
    """e1, e2 or e3 as ``dd.quad_step`` writes it, with the product it corrects."""
    a1, a2 = dd._split(xh)
    b1, b2 = dd._split(yh)
    if kind == "e1":
        p1 = xh * xh
        return ((a1 * a1 - p1) + (a1 + a1) * a2) + a2 * a2, xh, xh, p1
    if kind == "e2":
        p2 = yh * yh
        return ((b1 * b1 - p2) + (b1 + b1) * b2) + b2 * b2, yh, yh, p2
    p3 = xh * yh
    return ((a1 * b1 - p3) + (a1 * b2 + a2 * b1)) + a2 * b2, xh, yh, p3


def _fma_error(a, b, p):
    """a·b − p, exact in float64, rounded once to float32: __fmaf_rn(a, b, -p)."""
    return (a.double() * b.double() - p.double()).float()


def _bits(t):
    return t.view(torch.int32)


@pytest.mark.parametrize("kind", ["e1", "e2", "e3"])
def test_dekker_error_is_the_fma_of_the_product(kind):
    xh, yh = _pairs(np.random.default_rng([20, ord(kind[1])]), -50, 17)
    e, a, b, p = _dekker(kind, xh, yh)
    want = _fma_error(a, b, p)
    differ = _bits(e) != _bits(want)
    assert not bool(differ.any()), (
        f"{int(differ.sum())} of {e.numel()} differ, first at "
        f"({float(a[differ][0])!r}, {float(b[differ][0])!r})")
    # the error is not trivially zero: most products are inexact
    assert float((want != 0).double().mean()) > 0.9


@pytest.mark.parametrize("kind", ["e1", "e2", "e3"])
def test_dekker_and_fma_part_only_under_2_pow_minus_100(kind):
    """Where the product falls under ~2^-108 its error reaches below the
    smallest subnormal: Dekker's partial products then round, and the two
    results part.  Every pair that parts has a product under 2^-100."""
    xh, yh = _pairs(np.random.default_rng([21, ord(kind[1])]), -80, -40)
    e, a, b, p = _dekker(kind, xh, yh)
    differ = _bits(e) != _bits(_fma_error(a, b, p))
    assert int(differ.sum()) > 1000  # the domain is recorded, not assumed
    product = (a.double() * b.double()).abs()
    assert float(product[differ].max()) < 2.0 ** -100
    band = (product >= 2.0 ** -100) & (product < 2.0 ** -90)
    assert int(band.sum()) > 1000 and not bool(differ[band].any())


def _fma_quad_step(zr, zi, p1, p2, cr, ci, cross2):
    """csrc/escape.cu's quad_step in torch: dd._fma is the correctly rounded
    FMA on f32 words; every other expression is dd.quad_step's."""
    xh, xl = zr
    yh, yl = zi
    e1 = dd._fma(xh, xh, -p1)
    e2 = dd._fma(yh, yh, -p2)
    p3 = xh * yh
    e3 = dd._fma(xh, yh, -p3)
    l1 = e1 + (xh + xh) * xl
    l2 = e2 + (yh + yh) * yl
    l3 = e3 + (xh * yl + xl * yh)
    s, e = dd.two_sum(p1, -p2)
    s2, e2s = dd.two_sum(s, cr[0])
    lo = ((l1 - l2) + e) + (cr[1] + e2s)
    nzr = dd.fast_two_sum(s2, lo)
    ph = cross2 * p3
    pl = cross2 * l3
    s3, e3s = dd.two_sum(ph, ci[0])
    nzi = dd.fast_two_sum(s3, pl + (ci[1] + e3s))
    return nzr, nzi


def _ds_word(r, lo, hi):
    """Seeded double-single values: hi log-uniform, |lo| under hi's half ulp."""
    h = _log_uniform(r, N, lo, hi)
    lo_w = (h.double() * 2.0 ** -24 * torch.from_numpy(r.uniform(-1, 1, N))).float()
    return dd.fast_two_sum(h, lo_w)


@pytest.mark.parametrize("rule", ["mandelbrot", "burningship", "tricorn"])
def test_kernel_quad_step_mirror_is_bit_equal_to_dd_quad_step(rule):
    """The kernel's step, from the squares of z's hi words that |z|^2 formed
    (burning ship's from the signed words), equals dd.quad_step bit for bit."""
    r = np.random.default_rng([22, len(rule)])
    zr, zi = _ds_word(r, -50, 2), _ds_word(r, -50, 2)
    cr, ci = _ds_word(r, -30, 1), _ds_word(r, -30, 1)
    p1, p2 = zr[0] * zr[0], zi[0] * zi[0]  # dist_sq's squares, the step before
    if rule == "burningship":
        ar = dd.where(zr[0] < 0, dd.neg(zr), zr)
        ai = dd.where(zi[0] < 0, dd.neg(zi), zi)
        want = dd.quad_step(ar, ai, cr, ci)
        got = _fma_quad_step(ar, ai, p1, p2, cr, ci, 2.0)
    else:
        sign = -1.0 if rule == "tricorn" else 1.0
        want = dd.quad_step(zr, zi, cr, ci, cross_sign=sign)
        got = _fma_quad_step(zr, zi, p1, p2, cr, ci, 2.0 * sign)
    for g, w in zip((*got[0], *got[1]), (*want[0], *want[1])):
        assert torch.equal(_bits(g), _bits(w))


SASS = """
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_113escape_kernelINS_2ZDELi0ELb0ELb1ELb1EEEvPKfS3_iiiiiiPfS4_PiPh
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   FMUL R4, R2, R2 ;
.L_x_1:
        /*0020*/                   FFMA R5, R2, R2, -R4 ;
        /*0030*/                   FADD R6, R5, R3 ;
        /*0040*/                   FSETP.GTU.AND P0, PT, R6, R7, PT ;
        /*0050*/              @!P0 BRA `(.L_x_1) ;
        /*0060*/                   EXIT ;
.L_x_2:
        /*0070*/                   BRA `(.L_x_2);
\t\tFunction : _ZN12_GLOBAL__N_113escape_kernelINS_2ZFELi0ELb0ELb1ELb1EEEvPKfS3_iiiiiiPfS4_PiPh
        /*0000*/                   LDC R1, c[0x0][0x28] ;
.L_x_3:
        /*0010*/                   FMUL R4, R2, R2 ;
        /*0020*/              @!P0 BRA `(.L_x_3) ;
        /*0030*/                   EXIT ;
"""


@pytest.mark.parametrize("word, loops", [("ZD", [4]), ("ZF", [2])])
def test_sass_loops_reads_each_word_of_kernel_a(monkeypatch, word, loops):
    """``sass_loops`` finds kernel A's ds32 (ZD) and f32 (ZF) kernels by their
    mangled names and counts a loop from its target to its backward branch."""
    monkeypatch.setattr(escape_bench, "_tool", lambda name: "/bin/cuobjdump")
    monkeypatch.setattr(subprocess, "run", lambda *a, **k: subprocess.CompletedProcess(
        a[0], 0, stdout=SASS, stderr=""))
    assert escape_bench.sass_loops("lib.so", word=word) == {
        f"escape_kernel<{word}, 0, false, true, true>": loops}
