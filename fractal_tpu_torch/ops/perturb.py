"""Perturbation rendering, p32 fast tier (port of the f64-orbit, dist-only
path of ``fractal_tpu/ops/perturb.py``).

Host side: one reference orbit Z_{n+1} = Z_n² + c0 in f64 from the exact
rational pixel coordinate, the choice of reference pixel (view center, or
the medoid of the max-count pixels of a coarse ds32 probe when the center
escapes early), the cubic series-approximation skip and the 16-slot ``P``
block — all bit-for-bit the JAX package's.  Device side: kernel B
(``perturb_cuda.perturb_dist``) over a (rows, 2) table of 2·Z_n, then the
dist coloring.

Not ported here (raise ``NotImplementedError``): the exact ``perturb``
tier (glitch detection, fallback, multiref), orbits that need mpmath or the
native walker (pixel spacing ≤ ``F64_ORBIT_SPACING_LIMIT``), floatexp past
``EXTREME_SPACING_LIMIT``, BLA, and the non-quadratic δ-recurrences.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from fractal_tpu_torch.config import exact_pos
from fractal_tpu_torch.models.rules import eff_power, perturb_supported
from fractal_tpu_torch.ops import escape_cuda, perturb_cuda
from fractal_tpu_torch.ops.viewport import affine_fractions

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


# ---------------------------------------------------------------------------
# Host side: exact viewport rationals + f64 reference orbit
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


def reference_orbit(scene, ref_px: Tuple[int, int], width: int,
                    height: int) -> RefOrbit:
    """The reference pixel's orbit, walked in f64 on the host and packed
    into the (iterations + ORBIT_PAD, 8) f32 table.  Memoized (small LRU)."""
    key = _orbit_key(scene, ref_px, width, height)
    hit = _cache_get(_ORBIT_CACHE, key)
    if hit is not None:
        return hit
    spacing = scene.pixel_spacing / scene.supersample
    if spacing <= F64_ORBIT_SPACING_LIMIT:
        raise NotImplementedError(
            f"pixel spacing {spacing:.3g} needs an mpmath or native-walker "
            f"reference orbit: not yet ported (ROADMAP.md queue 1, item 3)")
    iters = scene.iterations
    (Ar, Cr), (Ai, Ci) = affine_fractions(width, height, exact_pos(scene), scene.scale)
    u0, v0 = ref_px
    c0r_f = Ar * u0 + Cr
    c0i_f = Ai * v0 + Ci
    limit_sq = float(scene.limit) ** 2

    step = _host_step(scene.algo, scene.power)
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
                     device="cpu") -> Tuple[int, int]:
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


def resolve_reference(scene, width: int, height: int, device="cpu"):
    """(ref_px, orbit): exact-view memo, then cross-view orbit reuse, then
    a fresh ``choose_reference`` and host walk."""
    cu, cv = width // 2, height // 2
    if _cache_get(_REF_CACHE, _orbit_key(scene, (cu, cv), width,
                                         height)) is not None:
        ref = choose_reference(scene, width, height, device)
        return ref, reference_orbit(scene, ref, width, height)
    ru = reuse_reference(scene, width, height)
    if ru is not None:
        return ru
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


def _table_for(orbit: RefOrbit, device) -> torch.Tensor:
    """The orbit table on ``device``, cached by the orbit's identity (a pan
    that reuses the orbit does not upload it again)."""
    device = torch.device(device)
    key = (id(orbit.packed), str(device))
    hit = _cache_get(_TABLE_CACHE, key)
    if hit is not None:
        return hit[1]
    table = torch.from_numpy(orbit_table(orbit)).to(device)
    _cache_put(_TABLE_CACHE, key, (orbit.packed, table))
    return table


# ---------------------------------------------------------------------------
# p32 render
# ---------------------------------------------------------------------------


def perturb_setup(scene, device):
    """Resolve the reference, the P block and the orbit table for a p32
    render on ``device``: returns (height, width, P, table, n_steps)."""
    if not perturb_supported(scene.algo, scene.power):
        raise ValueError(
            f"perturbation supports the z^d+c family (mandelbrot/julia/"
            f"multibrot, d >= 2), burning ship, and tricorn — not "
            f"{scene.algo} (power {scene.power}); use ds32/dd64")
    if not (scene.power == 2 and scene.algo in ("mandelbrot", "julia")):
        raise NotImplementedError(
            f"the {scene.algo} (power {scene.power}) δ-recurrence is not yet "
            f"ported: only quadratic mandelbrot and julia (ROADMAP.md "
            f"queue 1, item 6)")
    spacing = scene.pixel_spacing / scene.supersample
    if spacing < EXTREME_SPACING_LIMIT:
        raise NotImplementedError(
            "floatexp δ-orbits past 1e30× are not yet ported (ROADMAP.md "
            "queue 1, item 8)")
    ss = scene.supersample
    h, w = scene.height * ss, scene.width * ss
    ref_px, orbit = resolve_reference(scene, w, h, device)
    P = _pert_params(scene, ref_px, w, h, orbit=orbit, device=device)
    return h, w, P, _table_for(orbit, device), orbit.n_steps


def render_perturb(scene, device, fast: bool = True):
    """p32 render → (H, W, 3) uint8 on ``device``: kernel B (its plain
    version for a CPU device), then the dist coloring."""
    if not fast:
        raise NotImplementedError(
            "the exact perturbation tier (glitch detection, fallback, "
            "multiref) is not yet ported (ROADMAP.md queue 1, item 5)")
    from fractal_tpu_torch.render import _color_and_downsample_dist

    h, w, P, table, n_steps = perturb_setup(scene, device)
    d, cnt = perturb_cuda.perturb_dist(table, P, n_steps, height=h, width=w,
                                       julia=scene.algo == "julia")
    return _color_and_downsample_dist(scene, d, cnt)
