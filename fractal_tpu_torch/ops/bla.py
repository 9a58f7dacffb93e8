"""Bilinear approximation (BLA) tables: the extended-exponent merge tree of
the mid-zoom and extreme-depth tiers (port of ``fractal_tpu/ops/bla.py``,
numpy host code, bit for bit).

While |δz| is small, δz' = 2·Z_n·δz + δz² + δc is effectively linear in
(δz, δc): l consecutive steps compose into δz_{n+l} ≈ A·δz_n + B·δc, with
(A, B) computed once from the reference orbit.  Level k of a binary merge
tree covers 2^k steps from n = j·2^k; entry (A, B, r) applies while
|δz| < r, where r keeps the dropped δz² terms below ``EPS`` of the linear
term:

  level 0:  r = EPS·|Z_n|
  merge  :  r = min(r_lo, (r_hi − |B_lo|·δc_max) / |A_lo|)   (clamped ≥ 0)

Two tables, one tree:

* ``build_table``, the f32 table of mid-zoom views (above pixel spacing
  1e-30): rows [Ar, Ai, Br, Bi, r², skip, 0, 0] in f32, A and B clamped to
  ±3e38 (stretches past an escape; their r² is 0).  The reference builds it
  only for its CPU route, so the port's CPU renders of quadratic
  mandelbrot and julia views take it (``ops/perturb._perturb_tile_bla``).
* ``build_table_fe``, the extended-exponent table of the extreme-depth
  tier: at zooms past ~1e30× |δc| underflows even f64 after a few merges
  (A = ∏ 2Z overflows, r ~ |δc| underflows), so A, B and r ride as
  (mantissa, exponent) pairs.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np

EPS = 2.0 ** -24  # relative truncation allowed per skipped stretch (f32 ulp)
E_ZERO_HOST = -(1 << 30)  # ops/floatexp.E_ZERO


class BLATable(NamedTuple):
    """Packed table, levels concatenated: ``offsets[k]`` is the row of the
    k-th stored level's entry 0 (entry j covers steps [j·2^k', (j+1)·2^k')
    for that level's k').  Rows whose stretch crosses the orbit's usable end
    carry r² = 0 (never valid)."""

    packed: np.ndarray          # (rows, 8) f32
    offsets: Tuple[int, ...]    # per stored level
    levels: int


def _renorm_c(cr, ci, e):
    """Renormalise a complex (cr + i·ci)·2^e array so max(|cr|, |ci|) ∈
    [0.5, 1); zeros get ``E_ZERO_HOST``."""
    a = np.maximum(np.abs(cr), np.abs(ci))
    zero = a == 0
    _, ex = np.frexp(np.where(zero, 1.0, a))
    cr2 = np.ldexp(cr, -ex)
    ci2 = np.ldexp(ci, -ex)
    e2 = np.where(zero, E_ZERO_HOST, e + ex)
    return np.where(zero, 0.0, cr2), np.where(zero, 0.0, ci2), e2


def _renorm_r(m, e):
    """Renormalise a non-negative real (m·2^e) array to m ∈ [0.5, 1)."""
    zero = m <= 0
    _, ex = np.frexp(np.where(zero, 1.0, m))
    m2 = np.ldexp(m, -ex)
    e2 = np.where(zero, E_ZERO_HOST, e + ex)
    return np.where(zero, 0.0, m2), e2


def build_table_fe(orbit_z: np.ndarray, n_steps: int, iterations: int,
                   dc_max: float, min_level: int = 2) -> BLATable:
    """Extended-exponent merge tree of the orbit ``orbit_z`` ((≥n_steps, 2)
    f32 Z values).

    Row layout (8 f32): [Ar_m, Ai_m, A_e, Br_m, Bi_m, B_e, r²_m, r²_e], the
    complex mantissas normalised so max(|re|, |im|) ∈ [0.5, 1) with one
    shared exact exponent, r² a normalised non-negative (m, e) pair;
    r²_m = 0 marks an invalid row.  ``dc_max`` may be subnormal: it is
    consumed through frexp.  Levels below ``min_level`` are not stored."""
    n_pad = max(iterations, 1)
    m = min(n_steps, n_pad, orbit_z.shape[0])
    zr = np.zeros(n_pad, np.float64)
    zi = np.zeros(n_pad, np.float64)
    zr[:m] = orbit_z[:m, 0]
    zi[:m] = orbit_z[:m, 1]

    dcm_m, dcm_e = np.frexp(np.float64(max(dc_max, 0.0)))
    if dcm_m == 0.0:
        dcm_e = E_ZERO_HOST

    # level 0: A = 2Z, B = 1, r = EPS·|Z|, as (m, e)
    Ar, Ai, Ae = _renorm_c(2.0 * zr, 2.0 * zi, np.zeros(n_pad, np.int64))
    Br = np.ones(n_pad)
    Bi = np.zeros(n_pad)
    Be = np.zeros(n_pad, np.int64)
    rm, re = _renorm_r(EPS * np.hypot(zr, zi), np.zeros(n_pad, np.int64))
    valid = np.arange(n_pad) < m

    tables = []
    level_sizes = []
    k = 0
    while True:
        if k >= min_level:
            n_k = len(Ar)
            rows = np.zeros((n_k, 8), np.float32)
            rows[:, 0] = Ar[:n_k]
            rows[:, 1] = Ai[:n_k]
            rows[:, 2] = np.clip(Ae[:n_k], -1e7, 1e7)
            rows[:, 3] = Br[:n_k]
            rows[:, 4] = Bi[:n_k]
            rows[:, 5] = np.clip(Be[:n_k], -1e7, 1e7)
            r2m, r2e = _renorm_r(np.where(valid[:n_k], rm[:n_k], 0.0) ** 2,
                                 2 * re[:n_k])
            rows[:, 6] = r2m
            rows[:, 7] = np.clip(r2e, -1e7, 1e7)
            tables.append(rows)
            level_sizes.append(n_k)
        if (1 << (k + 1)) > n_pad:
            break
        n_next = len(Ar) // 2
        lo = slice(0, 2 * n_next, 2)
        hi = slice(1, 2 * n_next, 2)
        # A' = A_hi·A_lo (mantissa product, exponent sum)
        nAr = Ar[hi] * Ar[lo] - Ai[hi] * Ai[lo]
        nAi = Ar[hi] * Ai[lo] + Ai[hi] * Ar[lo]
        nAr, nAi, nAe = _renorm_c(nAr, nAi, Ae[hi] + Ae[lo])
        # B' = A_hi·B_lo + B_hi (align exponents, flush >200-bit gaps)
        pr = Ar[hi] * Br[lo] - Ai[hi] * Bi[lo]
        pi = Ar[hi] * Bi[lo] + Ai[hi] * Br[lo]
        pe = Ae[hi] + Be[lo]
        e = np.maximum(pe, Be[hi])
        nBr = (np.ldexp(pr, np.maximum(pe - e, -200))
               + np.ldexp(Br[hi], np.maximum(Be[hi] - e, -200)))
        nBi = (np.ldexp(pi, np.maximum(pe - e, -200))
               + np.ldexp(Bi[hi], np.maximum(Be[hi] - e, -200)))
        nBr, nBi, nBe = _renorm_c(nBr, nBi, e)
        # r' = min(r_lo, max(0, r_hi − |B_lo|·dc_max) / |A_lo|)
        absB = np.hypot(Br[lo], Bi[lo])          # mantissa, exponent Be[lo]
        ue = Be[lo] + dcm_e                      # |B_lo|·dc_max exponent
        um = absB * dcm_m
        ve = np.maximum(re[hi], ue)
        vm = (np.ldexp(rm[hi], np.maximum(re[hi] - ve, -200))
              - np.ldexp(um, np.maximum(ue - ve, -200)))
        vm = np.maximum(vm, 0.0)
        absA = np.maximum(np.hypot(Ar[lo], Ai[lo]), 1e-30)
        wm, we = _renorm_r(vm / absA, ve - Ae[lo])
        # the smaller radius, lexicographic on (e, m); either side 0 ⇒ 0
        zero = (rm[lo] == 0.0) | (wm == 0.0)
        take_w = (we < re[lo]) | ((we == re[lo]) & (wm < rm[lo]))
        nrm = np.where(zero, 0.0, np.where(take_w, wm, rm[lo]))
        nre = np.where(take_w, we, re[lo])
        nvalid = valid[lo] & valid[hi]
        nrm = np.where(nvalid, nrm, 0.0)
        Ar, Ai, Ae = nAr, nAi, nAe
        Br, Bi, Be = nBr, nBi, nBe
        rm, re = nrm, nre
        valid = nvalid
        k += 1
        if Ar.size == 0:
            break

    return _pack(tables, level_sizes)


def build_table(orbit_z: np.ndarray, n_steps: int, iterations: int,
                dc_max: float, min_level: int = 2) -> BLATable:
    """The f32 merge tree of the orbit ``orbit_z`` ((≥n_steps, 2) f32 Z
    values; the device arithmetic sees no more than f32 of it).  Its shape
    depends only on ``iterations``; entries past ``n_steps`` carry r² = 0.
    Levels below ``min_level`` are not stored (skips of 1 or 2 steps save
    nothing over plain steps)."""
    n_pad = max(iterations, 1)
    zr = np.zeros(n_pad, np.float64)
    zi = np.zeros(n_pad, np.float64)
    m = min(n_steps, n_pad, orbit_z.shape[0])
    zr[:m] = orbit_z[:m, 0]
    zi[:m] = orbit_z[:m, 1]

    # level 0: A = 2Z, B = 1, r = EPS·|Z|
    Ar, Ai = 2.0 * zr, 2.0 * zi
    Br = np.ones(n_pad)
    Bi = np.zeros(n_pad)
    r = EPS * np.hypot(zr, zi)
    valid = np.arange(n_pad) < m

    tables = []
    level_sizes = []
    k = 0
    while True:
        if k >= min_level:
            n_k = len(Ar)
            rows = np.zeros((n_k, 8), np.float32)
            # stretches past an escape have huge A and r = 0: clamped for a
            # clean f32 cast, never valid
            f32max = 3.0e38
            rows[:, 0] = np.clip(Ar[:n_k], -f32max, f32max)
            rows[:, 1] = np.clip(Ai[:n_k], -f32max, f32max)
            rows[:, 2] = np.clip(Br[:n_k], -f32max, f32max)
            rows[:, 3] = np.clip(Bi[:n_k], -f32max, f32max)
            rr = np.where(valid[:n_k], np.maximum(r[:n_k], 0.0), 0.0)
            rows[:, 4] = (rr * rr).astype(np.float32)
            rows[:, 5] = float(1 << k)
            tables.append(rows)
            level_sizes.append(n_k)
        if (1 << (k + 1)) > n_pad:
            break
        # merge pairs lo = 2j, hi = 2j + 1; a partnerless entry at the
        # ragged end is dropped (its stretch crosses the orbit's end)
        n_next = len(Ar) // 2
        lo = slice(0, 2 * n_next, 2)
        hi = slice(1, 2 * n_next, 2)
        A_lo_r, A_lo_i = Ar[lo], Ai[lo]
        A_hi_r, A_hi_i = Ar[hi], Ai[hi]
        B_lo_r, B_lo_i = Br[lo], Bi[lo]
        B_hi_r, B_hi_i = Br[hi], Bi[hi]
        nAr = A_hi_r * A_lo_r - A_hi_i * A_lo_i
        nAi = A_hi_r * A_lo_i + A_hi_i * A_lo_r
        nBr = A_hi_r * B_lo_r - A_hi_i * B_lo_i + B_hi_r
        nBi = A_hi_r * B_lo_i + A_hi_i * B_lo_r + B_hi_i
        absA_lo = np.hypot(A_lo_r, A_lo_i)
        absB_lo = np.hypot(B_lo_r, B_lo_i)
        nr = np.minimum(
            r[lo],
            np.maximum(0.0, (r[hi] - absB_lo * dc_max))
            / np.maximum(absA_lo, 1e-300),
        )
        nvalid = valid[lo] & valid[hi]
        Ar, Ai, Br, Bi, r, valid = nAr, nAi, nBr, nBi, nr, nvalid
        k += 1
        if Ar.size == 0:
            break
    return _pack(tables, level_sizes)


def _pack(tables, level_sizes) -> BLATable:
    """Concatenate the stored levels (one dead placeholder row where the
    budget is too small for any) with their offsets."""
    if not tables:
        tables = [np.zeros((1, 8), np.float32)]
        level_sizes = [1]
    offsets = []
    off = 0
    for n_k in level_sizes:
        offsets.append(off)
        off += n_k
    return BLATable(np.concatenate(tables, axis=0), tuple(offsets), len(level_sizes))
