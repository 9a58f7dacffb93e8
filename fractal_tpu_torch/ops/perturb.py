"""Perturbation rendering: the p32 fast tier, the exact ``perturb`` tier
and the ``floatexp`` tier past pixel spacing 1e-30 (port of
``fractal_tpu/ops/perturb.py``).

Host side: one reference orbit Z_{n+1} = rule(Z_n, c0) from the exact
rational pixel coordinate — in f64 above spacing 1e-13, below it in mpmath
precision through the native walker (``ops/native_walk.py``), with the
mpmath loop only where the walker declines — the choice of reference pixel
(view center, or the medoid of the max-count pixels of a coarse ds32 probe
when the center escapes early), the cubic series-approximation skip and the
16-slot ``P`` block, all bit for bit the JAX package's.

Device side: a (rows, 2) table of 2·Z_n and a (rows,) column of the
Pauldelbrot tolerance τ²·|Z_{n+1}|².  p32 runs kernel B's dist-only form,
then the dist coloring.  The exact tier runs kernel B's glitch form, then
resolves the flagged pixels exactly: above spacing 1e-13 by kernel A's
ds32 points form, below it by multi-reference perturbation on kernel C
(cached candidate orbits first, then host medoid rounds), finishing any
residual by direct high-precision iteration, so no pixel keeps a
best-effort value; warm frames of a view reuse the resolved pixels (the
dense fix cache).  Past ``EXTREME_SPACING_LIMIT`` (1e30×, quadratic
mandelbrot and julia only) δc leaves f32's exponent range: every δ-orbit
runs in floatexp (``ops/floatexp.py``) from the fe ``P`` block, on kernel
D's grid form (glitch form in the exact tier) and its points form for the
multiref passes, or, where the view's extended-exponent BLA table
(``ops/bla.py``) has deep valid levels, on the fe BLA route (one launch of
``csrc/perturb_bla_fe.cu`` for every 256-row gate group of the view).
On the CPU, quadratic mandelbrot and julia views above spacing 1e-30 take
the f32 BLA route instead of kernel B, as the reference's CPU route does:
the f32 table (``ops/bla.build_table``) and ``_perturb_tile_bla``, a plain
torch macro-skip loop with no card counterpart (the reference runs it only
where its backend is the CPU; on an accelerator it runs kernel B).
The orchestration takes its δ-orbit functions as one argument
(``DeltaKernels``): ``render_perturb`` passes the CUDA wrappers (which run
their plain versions for CPU tensors), ``PLAIN`` runs the same
orchestration on the plain versions.

``render_perturb_band`` renders one band of rows of a view with the
view's reference orbit, P block and BLA table, addressing global rows
through P[7] and resolving its flagged pixels in global coordinates
(``fractal_tpu_torch.tiled``).
"""

from __future__ import annotations

import math
import time
import warnings
from fractions import Fraction
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from fractal_tpu_torch.config import exact_pos
from fractal_tpu_torch.models.rules import eff_power, perturb_supported
from fractal_tpu_torch.ops import escape_cuda, native_walk, perturb_cuda
from fractal_tpu_torch.ops.bla import BLATable, build_table, build_table_fe
from fractal_tpu_torch.ops.viewport import affine_fractions
from fractal_tpu_torch.utils.timing import span

GLITCH_TOL_SQ = 1e-6  # Pauldelbrot τ² (τ = 1e-3), stored in the packed table

# The JAX package derives these from its loop depths (the largest chunk,
# twice the δ-loop chunk).  The port's loops have no chunks, but the
# orbit table's row count and the series skip must equal the JAX
# package's bit for bit, so the values are kept.
ORBIT_PAD = 256
SERIES_ALIGN = 256
SERIES_MIN_SKIP = 128
SERIES_TOL = 1e-7

F64_ORBIT_SPACING_LIMIT = 1e-13
EXTREME_SPACING_LIMIT = 1e-30
# Below this spacing ds32's double-word viewport collapses pixel
# coordinates, so glitched pixels go to multi-reference perturbation.
DS32_FALLBACK_SPACING_LIMIT = 1e-13

MULTIREF_MAX_ROUNDS = 16
MULTIREF_DRY_ROUNDS = 3
# Residuals that survive every multiref round are always finished exactly
# by direct high-precision iteration; past this projected wall time the
# resolver warns how long it expects to take.
DIRECT_RESOLVE_WARN_S = 30.0

#: The most recent perturbation render: tier, route (which δ-orbit
#: functions ran), glitch-pixel count, the count of pixels no reference
#: resolved (0 whenever a host resolve ran), the host medoid rounds, the
#: pixels finished by direct iteration, and how ``resolve_reference`` found
#: the reference orbit: "memo" (the view's own), "reuse" (a cached orbit
#: whose c lies in the view) or "walk" (a fresh reference).  Set anew by
#: each render.
RENDER_STATS = {"n_glitch": 0, "n_residual": 0, "tier": "", "route": "",
                "multiref_rounds": 0, "n_direct": 0, "reference": ""}
#: Host walks that ran the mpmath loop because the native walker declined
#: the input (``reference_orbit``, ``_direct_resolve``).
MPMATH_WALKS = {"walk": 0, "direct": 0}
#: The render's span sink (``utils/timing.span``): None, or a list to which
#: every step of a render appends (kind, detail, ms); the render driver's
#: steps (``render.py``) go to it too.  A ``timing.Fenced`` list fences each
#: step with ``torch.cuda.synchronize()`` (``--profile``'s, ``chip_smoke.py``'s
#: cold splits), a plain one does not (the benchmark's traced run).
SPLIT = None


def _step(kind: str, detail: str = ""):
    return span(SPLIT, kind, detail)


# ---------------------------------------------------------------------------
# Host side: exact viewport rationals + the reference orbit
# ---------------------------------------------------------------------------


class RefOrbit(NamedTuple):
    packed: np.ndarray   # f32 (rows, 8): [Zr_n, Zi_n, Zr_n+1, Zi_n+1, τ²|Z_n+1|², 0,0,0]
    n_steps: int         # usable δ-steps (the orbit escaped after this)
    ref_px: Tuple[int, int]


_ORBIT_CACHE_MAX = 8
_ORBIT_CACHE: dict = {}
_REF_CACHE: dict = {}
_C_ORBIT_CACHE: dict = {}  # exact-c keyed orbits for cross-view reuse
_SERIES_CACHE: dict = {}
_SLICE_CACHE: dict = {}
_TABLE_CACHE: dict = {}


def _cache_get(cache: dict, key):
    """LRU get: a hit moves to the newest slot."""
    hit = cache.get(key)
    if hit is not None:
        cache[key] = cache.pop(key)
    return hit


def _cache_put(cache: dict, key, val, cap: int = _ORBIT_CACHE_MAX):
    if key in cache:
        cache.pop(key)
    elif len(cache) >= cap:
        cache.pop(next(iter(cache)))  # evict least-recently-used
    cache[key] = val


def _orbit_key(scene, ref_px, width, height):
    return (scene.algo, scene.power, width, height, scene.iterations,
            scene.pos, scene.pos_str, scene.scale, scene.julia_set,
            float(scene.limit), scene.supersample, ref_px)


def _host_step(algo: str, power: int):
    """One host-side step of the reference walk (models/rules.py semantics
    on Python complex scalars)."""
    if algo == "burningship":
        def step(z, c):
            a, b = abs(z.real), abs(z.imag)
            return type(z)(a * a - b * b + c.real, 2 * a * b + c.imag)
        return step
    if algo == "tricorn":
        def step(z, c):
            return type(z)(z.real * z.real - z.imag * z.imag + c.real,
                           -2 * z.real * z.imag + c.imag)
        return step
    d = eff_power(algo, power)
    return lambda z, c: z ** d + c


def _digits(scene) -> int:
    """mpmath working precision of a view: 20 digits past its spacing."""
    spacing = scene.pixel_spacing / scene.supersample
    return int(-math.log10(max(spacing, 1e-300))) + 20


def _mpf_of(fr):
    import mpmath as mp

    return mp.mpf(fr.numerator) / fr.denominator


def reference_orbit(scene, ref_px: Tuple[int, int], width: int,
                    height: int) -> RefOrbit:
    """The reference pixel's orbit, walked on the host — f64 above spacing
    ``F64_ORBIT_SPACING_LIMIT``, mpmath precision below it (the native
    walker first, the mpmath loop where it declines) — and packed into the
    (iterations + ORBIT_PAD, 8) f32 table.  Memoized (small LRU)."""
    key = _orbit_key(scene, ref_px, width, height)
    hit = _cache_get(_ORBIT_CACHE, key)
    if hit is not None:
        return hit
    spacing = scene.pixel_spacing / scene.supersample
    iters = scene.iterations
    (Ar, Cr), (Ai, Ci) = affine_fractions(width, height, exact_pos(scene), scene.scale)
    u0, v0 = ref_px
    c0r_f = Ar * u0 + Cr
    c0i_f = Ai * v0 + Ci
    limit_sq = float(scene.limit) ** 2

    step = _host_step(scene.algo, scene.power)
    if spacing > F64_ORBIT_SPACING_LIMIT:
        with _step("walk", "f64"):
            zs = np.empty((iters + 1, 2), np.float64)
            c0r, c0i = float(c0r_f), float(c0i_f)
            if scene.algo == "julia":
                cr, ci = float(scene.julia_set[0]), float(scene.julia_set[1])
            else:
                cr, ci = c0r, c0i
            z = complex(c0r, c0i)  # z starts at the pixel coord (calc:208-212)
            c = complex(cr, ci)
            n = 0
            zs[0] = (z.real, z.imag)
            while n < iters:
                z = step(z, c)
                n += 1
                zs[n] = (z.real, z.imag)
                if z.real * z.real + z.imag * z.imag > limit_sq:
                    break
    else:
        import mpmath as mp

        with mp.workdps(_digits(scene)):
            c0r_m, c0i_m = _mpf_of(c0r_f), _mpf_of(c0i_f)
            if scene.algo == "julia":
                cr_m = mp.mpf(float(scene.julia_set[0]))
                ci_m = mp.mpf(float(scene.julia_set[1]))
            else:
                cr_m, ci_m = c0r_m, c0i_m
            z_m = mp.mpc(c0r_m, c0i_m)
            c_m = mp.mpc(cr_m, ci_m)
            with _step("walk", "native"):
                res = native_walk.walk(scene.algo, eff_power(scene.algo, scene.power),
                                       mp.mp.prec, z_m, c_m, iters, limit_sq)
            if res is not None:
                zs, n = res
            else:
                MPMATH_WALKS["walk"] += 1
                with _step("walk", "mpmath"):
                    zs = np.empty((iters + 1, 2), np.float64)
                    n = 0
                    zs[0] = (float(z_m.real), float(z_m.imag))
                    while n < iters:
                        z_m = step(z_m, c_m)
                        n += 1
                        zs[n] = (float(z_m.real), float(z_m.imag))
                        if zs[n, 0] ** 2 + zs[n, 1] ** 2 > limit_sq:
                            break

    n_steps = n  # steps 0..n-1 consume Z_n and Z_{n+1}
    rows = iters + ORBIT_PAD
    packed = np.zeros((rows, 8), np.float32)
    z32 = zs[: n + 1].astype(np.float32)
    packed[:n, 0] = z32[:n, 0]
    packed[:n, 1] = z32[:n, 1]
    packed[:n, 2] = z32[1 : n + 1, 0]
    packed[:n, 3] = z32[1 : n + 1, 1]
    packed[:n, 4] = GLITCH_TOL_SQ * (z32[1 : n + 1, 0] ** 2
                                     + z32[1 : n + 1, 1] ** 2)
    orbit = RefOrbit(packed, n_steps, (u0, v0))
    _cache_put(_ORBIT_CACHE, key, orbit)
    # cross-view reuse index: the orbit belongs to its exact c, not the view
    ckey = (scene.algo, scene.power,
            scene.julia_set if scene.algo == "julia" else None,
            float(scene.limit), c0r_f, c0i_f)
    _cache_put(_C_ORBIT_CACHE, ckey, (orbit, iters))
    return orbit


def _sliced_orbit(orbit: RefOrbit, iterations: int) -> RefOrbit:
    """Clip (or zero-pad) a cached orbit to this view's row count, with
    n_steps clipped to the budget.  Memoized per (orbit, budget)."""
    rows = iterations + ORBIT_PAD
    if orbit.packed.shape[0] == rows:
        return orbit
    key = (id(orbit.packed), rows)
    hit = _cache_get(_SLICE_CACHE, key)
    if hit is not None:
        return hit[1]
    if orbit.packed.shape[0] >= rows:
        packed = np.ascontiguousarray(orbit.packed[:rows])
    else:
        packed = np.zeros((rows, 8), np.float32)
        packed[: orbit.packed.shape[0]] = orbit.packed
    sliced = RefOrbit(packed, min(orbit.n_steps, iterations), orbit.ref_px)
    _cache_put(_SLICE_CACHE, key, (orbit.packed, sliced))
    return sliced


def reuse_reference(scene, width: int, height: int):
    """((u, v) float pixel coords, orbit) from a cached full-budget orbit
    whose exact c lies inside this view (the most central one), or None."""
    (Ar, Cr), (Ai, Ci) = affine_fractions(width, height, exact_pos(scene),
                                          scene.scale)
    want = (scene.algo, scene.power,
            scene.julia_set if scene.algo == "julia" else None,
            float(scene.limit))
    best = None  # (distance², key, (u, v))
    for ckey in _C_ORBIT_CACHE.keys():
        algo, power, jl, lim, c0r_f, c0i_f = ckey
        if (algo, power, jl, lim) != want:
            continue
        orbit, iters = _C_ORBIT_CACHE[ckey]
        if iters < scene.iterations or orbit.n_steps < scene.iterations:
            continue
        u = (c0r_f - Cr) / Ar
        v = (c0i_f - Ci) / Ai
        if 0 <= u <= width - 1 and 0 <= v <= height - 1:
            d2 = (float(u) - width // 2) ** 2 + (float(v) - height // 2) ** 2
            if best is None or d2 < best[0]:
                best = (d2, ckey, (float(u), float(v)))
    if best is not None:
        _, ckey, uv = best
        orbit, _ = _C_ORBIT_CACHE[ckey]
        _C_ORBIT_CACHE[ckey] = _C_ORBIT_CACHE.pop(ckey)  # refresh LRU
        return uv, _sliced_orbit(orbit, scene.iterations)
    return None


def choose_reference(scene, width: int, height: int,
                     device="cuda") -> Tuple[int, int]:
    """The view center, unless its orbit escapes before the budget; then
    the medoid of the max-count pixels of a ≤96×96 ds32 probe (kernel A on
    ``device``), mapped back through the exact affines.  Memoized."""
    cu, cv = width // 2, height // 2
    key = _orbit_key(scene, (cu, cv), width, height)
    hit = _cache_get(_REF_CACHE, key)
    if hit is not None:
        return hit
    probe_orbit = reference_orbit(scene, (cu, cv), width, height)
    if probe_orbit.n_steps >= scene.iterations:
        _REF_CACHE[key] = (cu, cv)
        return (cu, cv)

    pw = max(2, min(96, width))
    ph = max(2, min(96, height))
    with _step("probe", f"{pw}x{ph} ds32"):
        params = escape_cuda.scene_params(scene, ph, pw, device=device)
        cnt = escape_cuda.iterate_params(
            params, algo=scene.algo, power=scene.power,
            iterations=scene.iterations, precision="ds32", height=ph,
            width=pw)[2]
        cnt = cnt.cpu().numpy()
    best = cnt == cnt.max()
    ys, xs = np.nonzero(best)
    cy, cx = ys.mean(), xs.mean()
    i = int(np.argmin((ys - cy) ** 2 + (xs - cx) ** 2))
    pv, pu = int(ys[i]), int(xs[i])
    (Arp, Crp), (Aip, Cip) = affine_fractions(pw, ph, exact_pos(scene), scene.scale)
    (Ar, Cr), (Ai, Ci) = affine_fractions(width, height, exact_pos(scene), scene.scale)
    u = int(round(float(((Arp * int(pu) + Crp) - Cr) / Ar)))
    v = int(round(float(((Aip * int(pv) + Cip) - Ci) / Ai)))
    ref = (min(max(u, 0), width - 1), min(max(v, 0), height - 1))
    _cache_put(_REF_CACHE, key, ref)
    return ref


def resolve_reference(scene, width: int, height: int, device="cuda"):
    """(ref_px, orbit): exact-view memo, then cross-view orbit reuse, then
    a fresh ``choose_reference`` and host walk."""
    cu, cv = width // 2, height // 2
    if _cache_get(_REF_CACHE, _orbit_key(scene, (cu, cv), width,
                                         height)) is not None:
        RENDER_STATS["reference"] = "memo"
        ref = choose_reference(scene, width, height, device)
        return ref, reference_orbit(scene, ref, width, height)
    ru = reuse_reference(scene, width, height)
    if ru is not None:
        RENDER_STATS["reference"] = "reuse"
        return ru
    RENDER_STATS["reference"] = "walk"
    ref = choose_reference(scene, width, height, device)
    return ref, reference_orbit(scene, ref, width, height)


# ---------------------------------------------------------------------------
# Series approximation and the P block
# ---------------------------------------------------------------------------


def series_skip(z, n_limit: int, dc_max: float, julia: bool,
                tol: float = SERIES_TOL, align: int = 1,
                esc_radius: float = None):
    """Walk the scaled cubic-SA recurrences along orbit ``z`` ((rows, ≥2)
    [Zr, Zi]); return (n_skip, (A', B', C')) with
    δz_{n_skip} = A'u + B'u² + C'u³, u = δc/dc_max, n_skip a multiple of
    ``align``, and no pixel able to escape in the skipped prefix."""
    A, B, C, D = complex(dc_max), 0j, 0j, 0j
    best, best_abc = 0, (A, B, C)
    step_c = 0.0 if julia else dc_max  # julia: δc enters via δz₀ only
    for n in range(n_limit):
        twoZ = 2.0 * complex(z[n, 0], z[n, 1])
        D = twoZ * D + 2.0 * A * C + B * B
        C = twoZ * C + 2.0 * A * B
        B = twoZ * B + A * A
        A = twoZ * A + step_c
        m = max(abs(A), abs(B), abs(C))
        if not math.isfinite(m) or abs(D) > tol * max(m, 1e-300):
            break
        if esc_radius is not None:
            dz_bound = abs(A) + abs(B) + abs(C)
            if math.hypot(float(z[n + 1, 0]),
                          float(z[n + 1, 1])) + dz_bound > esc_radius:
                break
        if (n + 1) % align == 0:
            best, best_abc = n + 1, (A, B, C)
    return best, best_abc


def _series_for(scene, orbit, ref_px, width, height, dc_max):
    key = _orbit_key(scene, ref_px, width, height)
    hit = _cache_get(_SERIES_CACHE, key)
    if hit is not None:
        return hit
    n_limit = min(orbit.n_steps, scene.iterations,
                  orbit.packed.shape[0] - ORBIT_PAD)
    n, abc = series_skip(orbit.packed[:, :2], max(n_limit, 0), dc_max,
                         scene.algo == "julia", align=SERIES_ALIGN,
                         esc_radius=float(scene.limit))
    if n < SERIES_MIN_SKIP:
        n, abc = 0, None
    val = (n, abc)
    _cache_put(_SERIES_CACHE, key, val)
    return val


def _is_extreme(scene) -> bool:
    return scene.pixel_spacing / scene.supersample < EXTREME_SPACING_LIMIT


def _frexp_fraction(fr):
    """Exact frexp of a Fraction of any magnitude: (m, e) with value m·2^e
    and |m| ∈ [0.5, 1) (``float(fr)`` would under- or overflow past 1e±308)."""
    if fr == 0:
        return 0.0, 0
    e = abs(fr.numerator).bit_length() - fr.denominator.bit_length() + 1
    val = fr / (Fraction(2) ** e)
    if abs(val) < Fraction(1, 2):
        val, e = val * 2, e - 1
    elif abs(val) >= 1:
        val, e = val / 2, e + 1
    return float(val), e


def _pert_params_fe(scene, ref_px, width: int, height: int,
                    device="cpu") -> torch.Tensor:
    """16-slot f32 block for kernel D: ``_pert_params``'s layout where shared
    (u0, v0, limit², dc_gain, row stride and offset in [2:8]); the affine
    gains ride as floatexp pairs, [0] Ar_m, [1] Ai_m, [8] Ar_e, [9] Ai_e
    (exact small integers in f32).  No series slots: the loop starts at 0."""
    (Ar, _), (Ai, _) = affine_fractions(width, height, exact_pos(scene), scene.scale)
    arm, are = _frexp_fraction(Ar)
    aim, aie = _frexp_fraction(Ai)
    dc_gain = 0.0 if scene.algo == "julia" else 1.0
    block = np.asarray(
        [arm, aim, float(ref_px[0]), float(ref_px[1]), float(scene.limit) ** 2,
         dc_gain, 1.0, 0.0, float(are), float(aie), 0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
        np.float32,
    )
    return torch.from_numpy(block).to(device)


def _params_for(scene, ref_px, width: int, height: int, device) -> torch.Tensor:
    """A secondary reference's P: the fe block past 1e30×, else the trivial
    series block."""
    if _is_extreme(scene):
        return _pert_params_fe(scene, ref_px, width, height, device=device)
    return _pert_params(scene, ref_px, width, height, device=device)


def _pert_params(scene, ref_px, width: int, height: int, orbit=None,
                 device="cpu") -> torch.Tensor:
    """16-slot f32 block for kernel B:
      [0:8]  Ar, Ai, u0, v0, limit², dc_gain, row_stride, row_offset
      [8:16] series: n_skip, A'r, A'i, B'r, B'i, C'r, C'i, 1/dc_max —
             the trivial series (0, 1,0, 0,0, 0,0, 1) gives δz₀ = δc."""
    (Ar, Cr), (Ai, Ci) = affine_fractions(width, height, exact_pos(scene), scene.scale)
    dc_gain = 0.0 if scene.algo == "julia" else 1.0
    sa = [0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0]
    if orbit is not None and scene.power == 2 \
            and scene.algo in ("mandelbrot", "julia"):
        dcr_max = max(ref_px[0], width - 1 - ref_px[0]) * abs(float(Ar))
        dci_max = max(ref_px[1], height - 1 - ref_px[1]) * abs(float(Ai))
        dcm = math.hypot(dcr_max, dci_max)
        if dcm > 0.0:
            n_skip, abc = _series_for(scene, orbit, ref_px, width, height, dcm)
            if n_skip > 0:
                A, B, C = abc
                sa = [float(n_skip), A.real, A.imag, B.real, B.imag,
                      C.real, C.imag, 1.0 / dcm]
    block = np.asarray(
        [float(Ar), float(Ai), float(ref_px[0]), float(ref_px[1]),
         float(scene.limit) ** 2, dc_gain, 1.0, 0.0] + sa,
        np.float32,
    )
    return torch.from_numpy(block).to(device)


def orbit_table(orbit: RefOrbit) -> np.ndarray:
    """(rows, 2) f32 table of 2·Z_n — the JAX package's lane-replicated
    ``orbit_planes`` 0 and 1 without the replication.  Row n_steps is
    spliced in from the Z_{n+1} columns, since the last step reads it."""
    z = orbit.packed[:, 0:2].copy()
    n = orbit.n_steps
    if n >= 1:
        z[n] = orbit.packed[n - 1, 2:4]
    return np.ascontiguousarray(2.0 * z)


def glitch_column(orbit: RefOrbit) -> np.ndarray:
    """(rows,) f32 column of τ²·|Z_{n+1}|² — ``orbit_planes`` plane 2 (packed
    column 4) without the lane replication."""
    return np.ascontiguousarray(orbit.packed[:, 4])


def _orbit_tensors(orbit: RefOrbit, device):
    """(orbit table, glitch column) on ``device``, cached by the orbit's
    identity (a pan that reuses the orbit does not upload it again)."""
    device = torch.device(device)
    key = (id(orbit.packed), str(device))
    hit = _cache_get(_TABLE_CACHE, key)
    if hit is not None:
        return hit[1]
    with _step("upload", f"{orbit.packed.shape[0]} rows"):
        pair = (torch.from_numpy(orbit_table(orbit)).to(device),
                torch.from_numpy(glitch_column(orbit)).to(device))
    _cache_put(_TABLE_CACHE, key, (orbit.packed, pair))
    return pair


# ---------------------------------------------------------------------------
# Setup shared by both tiers
# ---------------------------------------------------------------------------


class Setup(NamedTuple):
    height: int
    width: int
    ref_px: tuple
    orbit: RefOrbit
    P: torch.Tensor      # f32 (16,): the fe block past 1e30×
    table: torch.Tensor  # f32 (rows, 2): 2·Z_n
    gtol: torch.Tensor   # f32 (rows,): τ²·|Z_{n+1}|²
    extreme: bool        # past EXTREME_SPACING_LIMIT: floatexp δ-orbits
    # the BLA route's table, else None: past 1e30× the fe table where it is
    # useful, short of it the f32 table of a quadratic view on the CPU
    bla: Optional[BLATable]

    @property
    def n_steps(self) -> int:
        return self.orbit.n_steps


def _check_supported(scene) -> None:
    if not perturb_supported(scene.algo, scene.power):
        raise ValueError(
            f"perturbation supports the z^d+c family (mandelbrot/julia/"
            f"multibrot, d >= 2), burning ship, and tricorn — not "
            f"{scene.algo} (power {scene.power}); use ds32/dd64")
    quad = scene.power == 2 and scene.algo in ("mandelbrot", "julia")
    if _is_extreme(scene) and not quad:
        raise ValueError(
            f"zooms past ~1e30× (floatexp δ-orbits) support quadratic "
            f"mandelbrot/julia only, not {scene.algo}")


def perturb_setup(scene, device, f32_bla: bool = True) -> Setup:
    """Resolve the reference, the P block and the orbit tensors of a
    perturbation render on ``device``; past 1e30× the fe P (no series walk)
    and the gate of the fe BLA route.  Short of 1e30×, a quadratic mandelbrot
    or julia view on the CPU gets the f32 BLA table, where the reference's
    CPU route builds it (``_perturb_setup``); ``f32_bla`` False leaves it
    out (the card's route, kernel B, on the CPU)."""
    _check_supported(scene)
    ss = scene.supersample
    h, w = scene.height * ss, scene.width * ss
    with _step("reference"):
        ref_px, orbit = resolve_reference(scene, w, h, device)
    extreme = _is_extreme(scene)
    bla = None
    if extreme:
        with _step("P block", "floatexp"):
            P = _pert_params_fe(scene, ref_px, w, h, device=device)
        if _fe_bla_useful(scene, orbit, ref_px, w, h):
            bla = _bla_for(scene, orbit, ref_px, w, h, fe=True)
    else:
        with _step("P block", "with the series walk"):
            P = _pert_params(scene, ref_px, w, h, orbit=orbit, device=device)
        if (f32_bla and torch.device(device).type == "cpu" and scene.power == 2
                and scene.algo in ("mandelbrot", "julia")):
            bla = _bla_for(scene, orbit, ref_px, w, h)
    table, gtol = _orbit_tensors(orbit, device)
    return Setup(h, w, ref_px, orbit, P, table, gtol, extreme, bla)


# ---------------------------------------------------------------------------
# The BLA routes: the f32 macro-skip loop (port of _perturb_tile_bla) and
# the extended-exponent one (_perturb_tile_bla_fe, perturb_cuda.perturb_bla_fe)
# ---------------------------------------------------------------------------

BLA_MIN_LEVEL = perturb_cuda.BLA_MIN_LEVEL  # smallest stored skip: 64 steps
# The f32 route's plain steps after each skip attempt: the reference's CPU
# chunk depth.  A skip is tried only every this many steps, so the value
# decides which skips are taken: it is semantics, not tuning.
PERT_CHUNK_CPU = 16
# The fe BLA route runs only where the table has a valid entry at this
# stored level or deeper: skips of fewer than 256 steps do not pay for the
# macro loop's scans.
FE_BLA_MIN_USEFUL_LEVEL = 2
# The JAX package runs the route in bands of this many rows (its
# _render_perturb_jit); the skip gate is a max over a band.
PERT_BAND_ROWS = 256

_BLA_CACHE: dict = {}


def _bla_for(scene, orbit, ref_px, width: int, height: int, fe: bool = False) -> BLATable:
    """The BLA table of this orbit and view (cached): the extended-exponent
    one with ``fe``, else the f32 one."""
    key = _orbit_key(scene, ref_px, width, height) + (fe,)
    hit = _cache_get(_BLA_CACHE, key)
    if hit is not None:
        return hit
    (Ar, _), (Ai, _) = affine_fractions(width, height, exact_pos(scene), scene.scale)
    u0, v0 = ref_px
    if fe:
        # f64 holds |δc| down to ~1e-300; below, dc_max flushes to 0 and the
        # table radii with it (BLA off)
        dcr_max = float(max(u0, width - 1 - u0) * abs(Ar))
        dci_max = float(max(v0, height - 1 - v0) * abs(Ai))
        build = build_table_fe
    else:
        # the gain rounded to f64 first, then the product: the reference's
        # order, which gives its dc_max and so its radii
        dcr_max = max(u0, width - 1 - u0) * abs(float(Ar))
        dci_max = max(v0, height - 1 - v0) * abs(float(Ai))
        build = build_table
    with _step("BLA table", f"{'fe' if fe else 'f32'}, {scene.iterations} iterations"):
        table = build(orbit.packed[:, :2], orbit.n_steps, scene.iterations,
                      math.hypot(dcr_max, dci_max), min_level=BLA_MIN_LEVEL)
    _cache_put(_BLA_CACHE, key, table)
    return table


def _fe_bla_useful(scene, orbit, ref_px, width: int, height: int) -> bool:
    """Whether the view's fe BLA table has valid entries deep enough to
    pay for the macro loop (contracting, minibrot-adjacent orbits; never the
    expanding needle orbits)."""
    table = _bla_for(scene, orbit, ref_px, width, height, fe=True)
    if table.levels <= FE_BLA_MIN_USEFUL_LEVEL:
        return False
    start = table.offsets[FE_BLA_MIN_USEFUL_LEVEL]
    return bool((table.packed[start:, 6] > 0.0).any())


def _packed_tensor(orbit: RefOrbit, device) -> torch.Tensor:
    """The packed orbit's columns [Zr_n, Zi_n, Zr_n+1, Zi_n+1, τ²|Z_n+1|²]
    on ``device``, the rows the reference's BLA twin reads (cached by the
    orbit's identity).  Unlike ``orbit_table``, row n_steps holds Z = 0: a
    skip that lands on the orbit's end reads it there, as the twin does."""
    key = (id(orbit.packed), str(torch.device(device)), "packed")
    hit = _cache_get(_TABLE_CACHE, key)
    if hit is not None:
        return hit[1]
    with _step("upload", f"{orbit.packed.shape[0]} packed rows"):
        pk = torch.from_numpy(np.ascontiguousarray(orbit.packed[:, :5])).to(device)
    _cache_put(_TABLE_CACHE, key, (orbit.packed, pk))
    return pk


def _bla_tensor(bla: BLATable, device) -> BLATable:
    """``bla`` with its packed rows on ``device``, the table the fe BLA
    kernel reads (cached by the table's identity)."""
    key = (id(bla.packed), str(torch.device(device)), "bla")
    hit = _cache_get(_TABLE_CACHE, key)
    if hit is not None:
        return hit[1]
    with _step("upload", f"{bla.packed.shape[0]} BLA rows"):
        dev_bla = bla._replace(packed=torch.from_numpy(np.ascontiguousarray(bla.packed))
                               .to(device))
    _cache_put(_TABLE_CACHE, key, (bla.packed, dev_bla))
    return dev_bla


def _perturb_tile_bla(pk, P, n_steps: int, bla: BLATable, xx, yy, *, iterations: int,
                      glitch: bool = True, stats: Optional[dict] = None):
    """One gate group of the f32 BLA route at pixel coordinates (xx, yy)
    (``_perturb_tile_bla``, fractal_tpu/ops/perturb.py:554-669) → (zr, zi,
    cnt, gl) of their shape.

    ``pk`` is the (rows, 5) packed orbit (Z_n, Z_{n+1}, τ²|Z_{n+1}|²; row
    n_steps holds Z = 0), ``P`` kernel B's block (the series start at
    P[8]), ``bla`` the f32 table (``ops/bla.build_table``; its packed rows
    a host array or a tensor).  The group's pixels share one step index n.
    Each macro step takes the group's max |δz|² over its live pixels and
    jumps them all by the deepest aligned level whose r² exceeds it, δz ←
    A·δz + gain·B·δc with Z_{n+skip} read from the orbit, then runs
    ``PERT_CHUNK_CPU`` plain steps, whether or not it skipped.  Every product is
    rounded on its own, as the reference rounds it unjitted.  ``glitch``
    False is the p32 tier (the reference zeroes the tolerance column).
    ``stats`` (a dict) gains the group's ``macro_steps`` and ``skips``."""
    i32 = torch.int32
    table = torch.as_tensor(bla.packed).to(pk.device)
    limit_sq, gain = P[4], P[5]
    dcr = (xx - P[2]) * P[0]
    dci = (yy - P[3]) * P[1]
    gcr, gci = dcr * gain, dci * gain
    dzr, dzi = perturb_cuda.series_start(P, dcr, dci)
    n = int(P[8].item())
    zfr = pk[n, 0] + dzr
    zfi = pk[n, 1] + dzi
    cnt = torch.full(dzr.shape, n, dtype=i32, device=pk.device)
    gl = torch.zeros_like(cnt)

    def active(m: int):
        return (zfr * zfr + zfi * zfi <= limit_sq) & (cnt == m) & (gl == 0)

    macro = skips = 0
    while n < iterations and n < n_steps and bool(active(n).any()):
        live = active(n)
        m2 = float(torch.where(live, dzr * dzr + dzi * dzi, 0.0).max())
        for lev in range(len(bla.offsets) - 1, -1, -1):
            k = lev + BLA_MIN_LEVEL
            step = 1 << k
            if n & (step - 1) or n + step > n_steps:
                continue
            # in the level's range: n + step <= n_steps <= iterations
            r = table[bla.offsets[lev] + (n >> k)]
            if m2 < float(r[4]):
                ndzr = r[0] * dzr - r[1] * dzi + (r[2] * dcr - r[3] * dci) * gain
                ndzi = r[0] * dzi + r[1] * dzr + (r[2] * dci + r[3] * dcr) * gain
                land = pk[n + step]
                dzr = torch.where(live, ndzr, dzr)
                dzi = torch.where(live, ndzi, dzi)
                zfr = torch.where(live, land[0] + ndzr, zfr)
                zfi = torch.where(live, land[1] + ndzi, zfi)
                cnt = cnt + live.to(i32) * step
                n += step
                skips += 1
                break
        for i in range(min(PERT_CHUNK_CPU, n_steps - n)):  # no pixel is live past the orbit
            live = active(n + i)
            Zr, Zi, Zr1, Zi1, gtol = pk[n + i]
            tr = 2.0 * Zr + dzr
            ti = 2.0 * Zi + dzi
            ndzr = tr * dzr - ti * dzi + gcr
            ndzi = tr * dzi + ti * dzr + gci
            nzfr = Zr1 + ndzr
            nzfi = Zi1 + ndzi
            d = nzfr * nzfr + nzfi * nzfi
            esc_now = d > limit_sq
            gl_now = live & ~esc_now & (d < gtol) if glitch else torch.zeros_like(live)
            dzr = torch.where(live, ndzr, dzr)
            dzi = torch.where(live, ndzi, dzi)
            zfr = torch.where(live, nzfr, zfr)
            zfi = torch.where(live, nzfi, zfi)
            cnt = cnt + (live & ~esc_now & ~gl_now).to(i32)
            gl = gl | gl_now.to(i32)
        n += PERT_CHUNK_CPU
        macro += 1
    if stats is not None:
        stats["macro_steps"] = stats.get("macro_steps", 0) + macro
        stats["skips"] = stats.get("skips", 0) + skips
    ran_out = (zfr * zfr + zfi * zfi <= limit_sq) & (cnt >= n_steps) & (n_steps < iterations)
    return zfr, zfi, cnt, gl | ran_out.to(i32)


def perturb_bla(pk, P, n_steps: int, bla: BLATable, *, iterations: int, height: int,
                width: int, glitch: bool = True, groups: int = 1,
                stats: Optional[dict] = None):
    """The f32 BLA route on ``pk``'s device → (zr, zi, cnt, gl), each
    (groups · height, width): rows y map to the plane as y·P[6] + P[7], and
    each run of ``height`` rows is one gate group (``_perturb_tile_bla``).
    The signature of ``perturb_cuda.perturb_bla_fe``."""
    xx, yy = perturb_cuda.grid_xy(P, groups * height, width, pk.device)
    outs = [_perturb_tile_bla(pk, P, n_steps, bla, xx[j * height:(j + 1) * height],
                              yy[j * height:(j + 1) * height], iterations=iterations,
                              glitch=glitch, stats=stats) for j in range(groups)]
    return tuple(torch.cat(parts, 0) for parts in zip(*outs))


def _bla_route(kernels: DeltaKernels, st: Setup) -> Callable:
    """The function of the view's BLA route: ``kernels.bla_fe`` past 1e30×,
    else the f32 route (plain torch, on the CPU only)."""
    return kernels.bla_fe if st.extreme else perturb_bla


def _render_bla(scene, st: Setup, kernels: DeltaKernels, glitch: bool, start: int = 0,
                rows: Optional[int] = None):
    """The view's BLA route over global rows [start, start + rows) (all of
    the view by default), in the reference's bands of ``PERT_BAND_ROWS``
    rows from row 0 (the last one padded past the image, as there), one
    gate group a band, in one call → (zr, zi, cnt, gl), each (rows, width).
    The skip gate is a max over a whole such band, so a band of a banded
    render runs the bands it overlaps in full and crops them: its rows
    equal the one-shot render's."""
    ss = scene.supersample
    rows = st.height - start if rows is None else rows
    band = min(st.height, max(ss, (PERT_BAND_ROWS // ss) * ss))
    first = start - start % band
    groups = -(-(start + rows - first) // band)
    dev = st.P.device
    out = _bla_route(kernels, st)(_packed_tensor(st.orbit, dev), _band_P(st, first),
                                  st.n_steps, _bla_tensor(st.bla, dev),
                                  iterations=scene.iterations, height=band, width=st.width,
                                  glitch=glitch, groups=groups)
    return tuple(a[start - first:start - first + rows] for a in out)


def _color(scene, zr, zi, cnt):
    from fractal_tpu_torch.render import _color_and_downsample

    with _step("coloring"):
        return _color_and_downsample(scene, zr, zi, cnt)


# ---------------------------------------------------------------------------
# The δ-orbit functions of the exact tier
# ---------------------------------------------------------------------------


class DeltaKernels(NamedTuple):
    """The δ-orbit functions the exact tier's orchestration calls: kernel
    B's full form, kernel C, kernel A's points form, kernel D's grid and
    points forms and the fe BLA route (signatures of
    ``perturb_cuda.perturb_full``, ``perturb_cuda.perturb_points``,
    ``escape_cuda.iterate_points``, ``perturb_cuda.perturb_fe_full``,
    ``perturb_cuda.perturb_fe_points`` and ``perturb_cuda.perturb_bla_fe``)."""
    full: Callable
    points: Callable
    escape_points: Callable
    fe_full: Callable
    fe_points: Callable
    bla_fe: Callable


#: The CUDA wrappers: kernels on CUDA tensors, plain versions on CPU ones.
KERNELS = DeltaKernels(perturb_cuda.perturb_full, perturb_cuda.perturb_points,
                       escape_cuda.iterate_points, perturb_cuda.perturb_fe_full,
                       perturb_cuda.perturb_fe_points, perturb_cuda.perturb_bla_fe)
#: The plain versions on any device (the card-side check of the route).
PLAIN = DeltaKernels(perturb_cuda.perturb_full_plain,
                     perturb_cuda.perturb_points_plain,
                     escape_cuda.iterate_points_plain,
                     perturb_cuda.perturb_fe_full_plain,
                     perturb_cuda.perturb_fe_points_plain,
                     perturb_cuda.perturb_bla_fe_plain)


def _route(kernels: DeltaKernels, device, st: Setup) -> str:
    """The main grid's route: "f32 BLA" (the CPU's route of a quadratic view
    short of 1e30×), "fe BLA kernel (registers)" or "(streaming)" (the state
    form of its last launch) or "fe BLA" (its plain version), "kernel D" or
    "cuda kernels" (kernel B), or "plain"."""
    on_card = kernels is KERNELS and torch.device(device).type == "cuda"
    if st.bla is not None and not st.extreme:
        return "f32 BLA"
    if st.bla is not None:
        return f"fe BLA kernel ({perturb_cuda.BLA_FE_FORM})" if on_card else "fe BLA"
    if on_card:
        return "kernel D" if st.extreme else "cuda kernels"
    return "plain"


def _points_fn(kernels: DeltaKernels, scene) -> Tuple[Callable, str]:
    """The points form the multiref passes launch at this depth, and its
    name in the split."""
    if _is_extreme(scene):
        return kernels.fe_points, "kernel D points"
    return kernels.points, "kernel C"


def _band_P(st: Setup, start: int) -> torch.Tensor:
    """The view's P with the global-row offset P[7] = ``start``."""
    if start == 0:
        return st.P
    P = st.P.clone()
    P[7] = float(start)
    return P


def _main_grid(scene, st: Setup, kernels: DeltaKernels, glitch: bool,
               start: int = 0, rows: Optional[int] = None):
    """(zr, zi, cnt, gl) of global rows [start, start + rows) of the view
    (all of it by default): the view's BLA route where it has one (the fe
    table where it is useful, the f32 table on the CPU), else kernel D past
    1e30×, else kernel B (full or glitch form)."""
    h = st.height if rows is None else rows
    w = st.width
    kw = dict(iterations=scene.iterations, height=h, width=w, algo=scene.algo,
              power=scene.power, glitch=glitch)
    if st.bla is not None:
        with _step("fe BLA" if st.extreme else "f32 BLA", f"{w}x{h}, {st.n_steps} steps"):
            return _render_bla(scene, st, kernels, glitch, start, h)
    P = _band_P(st, start)
    if st.extreme:
        with _step("kernel D", f"{w}x{h}, {st.n_steps} steps"):
            return kernels.fe_full(st.table, st.gtol, P, st.n_steps, **kw)
    # n0 is read off the card only where a sink records the span
    detail = "" if SPLIT is None else f"{w}x{h}, n0 {int(st.P[8].item())}, {st.n_steps} steps"
    with _step("kernel B", detail):
        return kernels.full(st.table, st.gtol, P, st.n_steps, **kw)


def _dist_grid(scene, st: Setup, start: int, rows: int):
    """(|z|², cnt) of global rows [start, start + rows) on kernel B's
    dist-only form (the p32 tier below 1e30×)."""
    return perturb_cuda.perturb_dist(st.table, _band_P(st, start), st.n_steps, height=rows,
                                     width=st.width, algo=scene.algo, power=scene.power)


class Grids(NamedTuple):
    """Where a render's main grid is formed: ``main`` has ``_main_grid``'s
    signature and ``dist`` ``_dist_grid``'s; ``label`` prefixes the route in
    ``RENDER_STATS`` and ``key`` the view's fix-cache entry (a mesh's BLA
    grid is not the one-device grid, ``parallel/sharding``; nor is the card's
    route the CPU's f32 BLA grid).  ``f32_bla``
    lets a render on the CPU take the f32 BLA route where the reference's
    CPU route does; False runs the card's route (kernel B) there."""
    main: Callable
    dist: Callable
    label: str = ""
    key: tuple = ()
    f32_bla: bool = True


#: The main grid on the render's own device.
ONE_DEVICE = Grids(_main_grid, _dist_grid)
#: The card's route on any device: kernel B below 1e30×, never the f32 BLA
#: route (its plain versions on the CPU); its own fix-cache entries.
CARD_ROUTE = ONE_DEVICE._replace(f32_bla=False, key=("card route",))


# ---------------------------------------------------------------------------
# Exact resolution of flagged pixels
# ---------------------------------------------------------------------------


def _candidate_refs(scene, width: int, height: int, limit: int = 4):
    """Cached orbits usable as secondary references for this view (newest
    first): same algo/julia/limit, exact starting c inside the view, and a
    complete walk (full budget, or escaped before its own budget)."""
    (Ar, Cr), (Ai, Ci) = affine_fractions(width, height, exact_pos(scene),
                                          scene.scale)
    want = (scene.algo, scene.power,
            scene.julia_set if scene.algo == "julia" else None,
            float(scene.limit))
    out = []
    for ckey in reversed(list(_C_ORBIT_CACHE.keys())):
        algo, power, jl, lim, c0r_f, c0i_f = ckey
        if (algo, power, jl, lim) != want:
            continue
        orbit, iters = _C_ORBIT_CACHE[ckey]
        complete = iters >= scene.iterations or orbit.n_steps < iters
        if not complete:
            continue
        u = (c0r_f - Cr) / Ar
        v = (c0i_f - Ci) / Ai
        if 0 <= u <= width - 1 and 0 <= v <= height - 1:
            out.append(((float(u), float(v)),
                        _sliced_orbit(orbit, scene.iterations)))
            if len(out) >= limit:
                break
    return out


def _direct_resolve(scene, idx, width: int, height: int, row0: int = 0):
    """(zr, zi, cnt) of flat pixel indices ``idx`` by direct high-precision
    iteration at each pixel's exact-rational c — the native walker first,
    the mpmath loop where it declines.  The escaping step is not counted and
    z freezes at its first beyond-limit value, as in the δ-orbit kernels.
    ``idx`` indexes a slab whose first row is global row ``row0`` of the
    (height, width) grid."""
    import mpmath as mp

    (Ar, Cr), (Ai, Ci) = affine_fractions(width, height, exact_pos(scene),
                                          scene.scale)
    limit_sq = float(scene.limit) ** 2
    step = _host_step(scene.algo, scene.power)
    d = eff_power(scene.algo, scene.power)
    n_px = idx.size
    out_zr = np.empty(n_px, np.float32)
    out_zi = np.empty(n_px, np.float32)
    out_cnt = np.empty(n_px, np.int32)
    t_start = time.perf_counter()
    with mp.workdps(_digits(scene)):
        if scene.algo == "julia":
            c_julia = mp.mpc(mp.mpf(float(scene.julia_set[0])),
                             mp.mpf(float(scene.julia_set[1])))
        for j in range(n_px):
            if j == 1:
                est = (time.perf_counter() - t_start) * n_px
                if est > DIRECT_RESOLVE_WARN_S:
                    warnings.warn(
                        f"direct resolve of {n_px} residual pixel(s) at "
                        f"{scene.iterations} iterations projects to ~{est:.0f} s "
                        f"of host walking (every pixel is finished exactly)",
                        stacklevel=2)
            x = int(idx[j] % width)
            y = int(idx[j] // width) + row0
            z = mp.mpc(_mpf_of(Ar * x + Cr), _mpf_of(Ai * y + Ci))
            c = c_julia if scene.algo == "julia" else z
            res = native_walk.direct(scene.algo, d, mp.mp.prec, z, c,
                                     scene.iterations, limit_sq)
            if res is not None:
                out_zr[j], out_zi[j], out_cnt[j] = res
                continue
            MPMATH_WALKS["direct"] += 1
            n = 0
            while n < scene.iterations:
                z2 = step(z, c)
                if z2.real * z2.real + z2.imag * z2.imag > limit_sq:
                    z = z2
                    break
                z = z2
                n += 1
            out_zr[j] = float(z.real)
            out_zi[j] = float(z.imag)
            out_cnt[j] = n
    return out_zr, out_zi, out_cnt


def _multiref_resolve(scene, idx, width: int, height: int, device,
                      kernels: DeltaKernels = KERNELS,
                      max_refs: int = MULTIREF_MAX_ROUNDS, refs_out: list = None,
                      row0: int = 0):
    """Re-render the flat pixel indices ``idx`` with successive secondary
    reference orbits: cached in-view candidates first, then the medoid of
    the still-glitched pixels, each round a launch of kernel C (kernel D's
    points form past 1e30×; their plain versions on the CPU) over the
    still-flagged pixels.  Pixels still flagged after the rounds are
    finished by ``_direct_resolve``.  Returns (zr, zi, cnt, n_residual = 0)
    as numpy arrays in ``idx`` order; ``refs_out`` collects the (ref_px,
    orbit) pairs that resolved pixels.  ``idx`` indexes a slab whose first
    row is global row ``row0`` of the (height, width) grid: a band of a
    banded render keeps ``height`` the whole grid's."""
    n = idx.size
    out_zr = np.zeros(n, np.float32)
    out_zi = np.zeros(n, np.float32)
    out_cnt = np.zeros(n, np.int32)
    remaining = np.arange(n)
    candidates = _candidate_refs(scene, width, height)
    points, label = _points_fn(kernels, scene)
    medoid_rounds = 0
    dry = 0  # consecutive zero-progress walked rounds
    tried: set = set()  # failed medoids: never re-picked for this resolve
    while remaining.size and medoid_rounds < max_refs \
            and dry < MULTIREF_DRY_ROUNDS:
        xs = (idx[remaining] % width).astype(np.float32)
        ys = (idx[remaining] // width + row0).astype(np.float32)
        if candidates:
            ref, orbit = candidates.pop(0)
            walked = False
        else:
            d2 = (xs - xs.mean()) ** 2 + (ys - ys.mean()) ** 2
            ref = None
            for mi in np.argsort(d2, kind="stable"):
                cand = (int(xs[mi]), int(ys[mi]))
                if cand not in tried:
                    ref = cand
                    break
            if ref is None:
                break  # every remaining pixel already failed as a reference
            tried.add(ref)
            orbit = reference_orbit(scene, ref, width, height)
            medoid_rounds += 1
            walked = True
        P = _params_for(scene, ref, width, height, device)
        table, gtol = _orbit_tensors(orbit, device)
        with _step(label, f"{remaining.size} px"):
            res = points(
                table, gtol, P, orbit.n_steps, torch.from_numpy(xs).to(device),
                torch.from_numpy(ys).to(device), iterations=scene.iterations,
                algo=scene.algo, power=scene.power, glitch=True)
            zr1, zi1, cnt1, gl1 = (t.cpu().numpy() for t in res)
        resolved_any = bool((gl1 == 0).any())
        if walked:
            dry = 0 if resolved_any else dry + 1
        if not (walked or resolved_any):
            continue  # useless cached candidate: no writes, try the next
        if refs_out is not None and resolved_any:
            refs_out.append((ref, orbit))
        out_zr[remaining] = zr1
        out_zi[remaining] = zi1
        out_cnt[remaining] = cnt1
        remaining = remaining[gl1 != 0]
    RENDER_STATS["multiref_rounds"] = medoid_rounds
    RENDER_STATS["n_direct"] = int(remaining.size)
    if remaining.size:
        with _step("direct", f"{remaining.size} px"):
            dzr, dzi, dcnt = _direct_resolve(scene, idx[remaining], width, height,
                                             row0=row0)
        out_zr[remaining] = dzr
        out_zi[remaining] = dzi
        out_cnt[remaining] = dcnt
    return out_zr, out_zi, out_cnt, 0


def _scatter_fixed(zr, zi, cnt, idx, fzr, fzi, fcnt):
    """Copies of (zr, zi, cnt) with the flat indices ``idx`` set to the
    resolved values."""
    with _step("scatter", f"{idx.numel()} px"):
        out = []
        for full, vals in ((zr, fzr), (zi, fzi), (cnt, fcnt)):
            full = full.clone()
            full.view(-1).index_put_((idx,), vals.to(full.device))
            out.append(full)
    return tuple(out)


def _apply_fallback(scene, zr, zi, cnt, gl, width: int, height: int, device,
                    kernels: DeltaKernels = KERNELS, row0: int = 0,
                    full_height: int = None):
    """Resolve the flagged pixels of a (height, width) slab exactly: above
    spacing 1e-13 by kernel A's ds32 points form at the pixels' own
    coordinates, below it by ``_multiref_resolve``.  Returns (zr, zi, cnt,
    n_flagged).  A slab that is a band of a bigger render starts at global
    row ``row0`` of a grid ``full_height`` rows tall (the viewport's
    normaliser); the defaults are the whole image."""
    full_height = height if full_height is None else full_height
    flat = gl.reshape(-1)
    if int(flat.sum()) == 0:
        return zr, zi, cnt, 0
    idx = torch.nonzero(flat).squeeze(1)
    n = idx.numel()
    spacing = scene.pixel_spacing / scene.supersample
    if spacing > DS32_FALLBACK_SPACING_LIMIT:
        xs = (idx % width).to(torch.float32)
        ys = (idx // width + row0).to(torch.float32)
        params16 = escape_cuda.scene_params(scene, full_height, width, device=device)
        with _step("kernel A points", f"{n} px"):
            fzr, fzi, fcnt = kernels.escape_points(
                params16, xs, ys, algo=scene.algo, power=scene.power,
                iterations=scene.iterations, precision="ds32")
    else:
        hzr, hzi, hcnt, nres = _multiref_resolve(
            scene, idx.cpu().numpy(), width, full_height, device, kernels, row0=row0)
        RENDER_STATS["n_residual"] = nres
        fzr, fzi, fcnt = (torch.from_numpy(a) for a in (hzr, hzi, hcnt))
    zr, zi, cnt = _scatter_fixed(zr, zi, cnt, idx, fzr, fzi, fcnt)
    return zr, zi, cnt, n


# Per-view multiref reference packs and the dense warm-frame fix cache:
# the resolved values of a view's flagged pixels are a deterministic
# function of the view, so the cold frame's (mask, zr, zi, cnt) is kept
# and every later frame replaces its flagged pixels with one select pass.
# () marks a view measured glitch-free.  Dense triples are ~108 MB at
# 9 Mpix, so the cap only holds the interactively-current views.
_MULTIREF_CACHE: dict = {}
_FIX_CACHE: dict = {}
_FIX_CACHE_MAX = 2


def _fix_color(scene, zr, zi, cnt, mask, zrF, ziF, cntF):
    return _color(scene, torch.where(mask, zrF, zr), torch.where(mask, ziF, zi),
                  torch.where(mask, cntF, cnt))


def _refs_device_pack(scene, refs, w: int, h: int, device):
    """[(table, gtol, P, n_steps)] on ``device`` for the warm multiref
    pass, from (ref_px, orbit) pairs (P with the trivial series, or the fe
    P past 1e30×)."""
    pack = []
    for ref, orbit in refs:
        orbit = _sliced_orbit(orbit, scene.iterations)
        table, gtol = _orbit_tensors(orbit, device)
        pack.append((table, gtol, _params_for(scene, ref, w, h, device),
                     orbit.n_steps))
    return pack


def _multiref_fallback_color(scene, zr, zi, cnt, gl, pack, *, width: int,
                             kernels: DeltaKernels):
    """Device-resident multi-reference resolution: the flagged pixels
    δ-iterated against each packed reference in turn on kernel C (kernel
    D's points form past 1e30×; the first that de-glitches a pixel wins; the
    last is taken regardless), scattered back and colored.  Returns (image,
    zr, zi, cnt, n_residual), n_residual a device scalar of the pixels no
    reference de-glitched."""
    points, label = _points_fn(kernels, scene)
    idx = torch.nonzero(gl.reshape(-1)).squeeze(1)
    k = idx.numel()
    xs = (idx % width).to(torch.float32)
    ys = (idx // width).to(torch.float32)
    fzr = torch.zeros(k, dtype=torch.float32, device=gl.device)
    fzi = torch.zeros_like(fzr)
    fcnt = torch.zeros(k, dtype=torch.int32, device=gl.device)
    pending = torch.ones(k, dtype=torch.bool, device=gl.device)
    unresolved = torch.ones_like(pending)
    for r, (table, gtol, P, n_steps) in enumerate(pack):
        with _step(label, f"warm ref {r}, {k} px"):
            rzr, rzi, rcnt, rgl = points(
                table, gtol, P, n_steps, xs, ys, iterations=scene.iterations,
                algo=scene.algo, power=scene.power, glitch=True)
        ok = rgl == 0
        take = pending & (ok | (r == len(pack) - 1))
        fzr = torch.where(take, rzr, fzr)
        fzi = torch.where(take, rzi, fzi)
        fcnt = torch.where(take, rcnt, fcnt)
        unresolved = unresolved & ~(pending & ok)
        pending = pending & ~take
    n_residual = unresolved.sum()
    zr, zi, cnt = _scatter_fixed(zr, zi, cnt, idx, fzr, fzi, fcnt)
    return _color(scene, zr, zi, cnt), zr, zi, cnt, n_residual


# ---------------------------------------------------------------------------
# Renders
# ---------------------------------------------------------------------------


def iterate_perturb(scene, height: int, width: int, device="cuda",
                    kernels: DeltaKernels = KERNELS):
    """(zr, zi, cnt, n_glitch) of a (height, width) frame by perturbation
    with kernel B's glitch form (kernel D's past 1e30×) and the exact
    fallback, on ``device``."""
    _check_supported(scene)
    ref_px = choose_reference(scene, width, height, device)
    orbit = reference_orbit(scene, ref_px, width, height)
    table, gtol = _orbit_tensors(orbit, device)
    if _is_extreme(scene):
        P = _pert_params_fe(scene, ref_px, width, height, device=device)
        full = kernels.fe_full
    else:
        P = _pert_params(scene, ref_px, width, height, orbit=orbit, device=device)
        full = kernels.full
    zr, zi, cnt, gl = full(
        table, gtol, P, orbit.n_steps, iterations=scene.iterations, height=height,
        width=width, algo=scene.algo, power=scene.power, glitch=True)
    return _apply_fallback(scene, zr, zi, cnt, gl, width, height, device, kernels)


def render_perturb(scene, device, fast: bool = False, grids: Grids = ONE_DEVICE):
    """Perturbation render → (H, W, 3) uint8 on ``device``: the exact tier
    by default (``render_exact`` on the CUDA wrappers, every glitch
    resolved), or with ``fast=True`` the p32 tier, an explicit opt-in as in
    the reference (no glitch handling; kernel B's dist-only form, or past
    1e30× kernel D's grid form or the fe BLA route; on the CPU a quadratic
    view short of 1e30× takes the f32 BLA route in both tiers).  ``grids``
    forms the main grid (a mesh's, ``parallel/sharding``; ``CARD_ROUTE``
    keeps the CPU on kernel B's plain versions)."""
    if not fast:
        return render_exact(scene, device, KERNELS, grids)
    return render_perturb_band(scene, 0, scene.height * scene.supersample, device,
                               fast=True, grids=grids)


def render_perturb_band(scene, start_row: int, rows: int, device, fast: bool = False,
                        grids: Grids = ONE_DEVICE):
    """Global rows [start_row, start_row + rows) of the supersampled grid of
    a perturbation render → (rows / supersample, W, 3) uint8 on ``device``,
    the band of a banded render (``fractal_tpu_torch.tiled``).

    Every band runs on the view's reference orbit, P block and BLA table
    (the same host caches as the one-shot render), with P[7] = start_row;
    p32 on kernel B's dist-only form (the f32 BLA route without the glitch
    test on the CPU, as the reference's CPU route), the exact tier on its
    glitch form (or kernel D's past 1e30×, or the view's BLA route, whose
    bands of the view are run whole and cropped), then every flagged pixel of
    the band resolved in global coordinates (``_apply_fallback`` with
    ``row0`` and the view's full height).  The band never reads or writes
    the view's fix or multiref caches.  The assembled image equals the
    one-shot render on every pixel the glitch test does not flag; a flagged
    pixel may be resolved against another secondary reference."""
    from fractal_tpu_torch.render import _color_and_downsample_dist

    device = torch.device(device)
    st = perturb_setup(scene, device, grids.f32_bla)
    RENDER_STATS.update(n_glitch=None if fast else 0, n_residual=0,
                        tier="p32" if fast else ("floatexp" if st.extreme else "perturb"),
                        route=grids.label + _route(KERNELS, device, st), multiref_rounds=0,
                        n_direct=0)
    if fast and st.bla is None and not st.extreme:
        with _step("kernel B dist"):
            dist = grids.dist(scene, st, start_row, rows)
        with _step("coloring"):
            return _color_and_downsample_dist(scene, *dist)
    zr, zi, cnt, gl = grids.main(scene, st, KERNELS, glitch=not fast, start=start_row,
                                 rows=rows)
    RENDER_STATS["route"] = grids.label + _route(KERNELS, device, st)  # the launch's form
    if not fast:
        zr, zi, cnt, n = _apply_fallback(scene, zr, zi, cnt, gl, st.width, rows, device,
                                         row0=start_row, full_height=st.height)
        RENDER_STATS["n_glitch"] = n
    return _color(scene, zr, zi, cnt)


def render_exact(scene, device, kernels: DeltaKernels = KERNELS,
                 grids: Grids = ONE_DEVICE):
    """The exact perturbation tier → (H, W, 3) uint8 on ``device``: kernel
    B's glitch form over the view (past 1e30× kernel D's, or the fe BLA
    route where its table is useful; on the CPU the f32 BLA route of a
    quadratic view short of 1e30×), then every flagged pixel resolved
    exactly (the warm fix cache, the ds32 points fallback above spacing
    1e-13, else the candidate-orbit pass on kernel C or kernel D's points
    form and the host resolve), then the coloring.  ``kernels`` are the
    δ-orbit functions it calls; ``grids.main`` forms the main grid, and
    everything after it runs on ``device``."""
    device = torch.device(device)
    st = perturb_setup(scene, device, grids.f32_bla)
    h, w = st.height, st.width
    RENDER_STATS.update(n_glitch=0, n_residual=0,
                        tier="floatexp" if st.extreme else "perturb", multiref_rounds=0,
                        n_direct=0)
    zr, zi, cnt, gl = grids.main(scene, st, kernels, glitch=True)
    RENDER_STATS["route"] = grids.label + _route(kernels, device, st)  # the launch's form
    fkey = _orbit_key(scene, ("fix",) + grids.key + tuple(st.ref_px), w, h)
    fixed = _cache_get(_FIX_CACHE, fkey)
    if fixed is not None:
        if fixed == ():  # the view was measured glitch-free on its cold frame
            return _color(scene, zr, zi, cnt)
        mask, zrF, ziF, cntF, n_cold = fixed
        RENDER_STATS["n_glitch"] = n_cold
        return _fix_color(scene, zr, zi, cnt, mask, zrF, ziF, cntF)
    n = int(gl.sum())
    RENDER_STATS["n_glitch"] = n
    if n == 0:
        _cache_put(_FIX_CACHE, fkey, (), cap=_FIX_CACHE_MAX)
        return _color(scene, zr, zi, cnt)
    if scene.pixel_spacing / scene.supersample > DS32_FALLBACK_SPACING_LIMIT:
        zr, zi, cnt, _ = _apply_fallback(scene, zr, zi, cnt, gl, w, h, device, kernels)
        return _color(scene, zr, zi, cnt)
    # Deeper than ds32's wall: multi-reference perturbation.
    view_key = _orbit_key(scene, ("multiref",), w, h)
    cached = _cache_get(_MULTIREF_CACHE, view_key)
    if cached is None:
        # Pan fast path: the cached in-view orbits, in one device pass.
        cands = _candidate_refs(scene, w, h)
        if cands:
            pack = _refs_device_pack(scene, cands, w, h, device)
            img2, zr2, zi2, cnt2, nres = _multiref_fallback_color(
                scene, zr, zi, cnt, gl, pack, width=w, kernels=kernels)
            RENDER_STATS["n_residual"] = int(nres)
            if int(nres) == 0:
                _cache_put(_MULTIREF_CACHE, view_key, pack)
                _cache_put(_FIX_CACHE, fkey, (gl != 0, zr2, zi2, cnt2, n),
                           cap=_FIX_CACHE_MAX)
                return img2
        refs: list = []
        idx = torch.nonzero(gl.reshape(-1)).squeeze(1)
        hzr, hzi, hcnt, nres = _multiref_resolve(scene, idx.cpu().numpy(), w, h,
                                                 device, kernels, refs_out=refs)
        RENDER_STATS["n_residual"] = nres
        zr, zi, cnt = _scatter_fixed(zr, zi, cnt, idx, *(torch.from_numpy(a) for a in
                                                        (hzr, hzi, hcnt)))
        _cache_put(_FIX_CACHE, fkey, (gl != 0, zr, zi, cnt, n), cap=_FIX_CACHE_MAX)
        if refs:
            _cache_put(_MULTIREF_CACHE, view_key,
                       _refs_device_pack(scene, refs, w, h, device))
        return _color(scene, zr, zi, cnt)
    img2, zr2, zi2, cnt2, nres = _multiref_fallback_color(
        scene, zr, zi, cnt, gl, cached, width=w, kernels=kernels)
    _cache_put(_FIX_CACHE, fkey, (gl != 0, zr2, zi2, cnt2, n), cap=_FIX_CACHE_MAX)
    RENDER_STATS["n_residual"] = nres
    return img2
