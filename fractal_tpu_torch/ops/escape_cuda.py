"""Escape-time kernel A: exact viewport constants, the plain torch version
and the wrapper over ``csrc/escape.cu``.

Replaces ``fractal_tpu/ops/escape_pallas.py::iterate_params``.  Each pixel
iterates z ← rule(z, c) until it escapes (|z|² > limit², the escape step
not counted) or its budget runs out, optionally with Brent periodicity
detection (snapshots at steps n ≥ 1 with n & (n−1) == 0; a return within
eps of the snapshot freezes the pixel with cnt = iterations).

Number representations: ``f32`` and ``ds32`` (double-single pairs,
``ops/dd.py``) on an f32[16] block, and ``dd64`` (double-double pairs of
f64 words, ~2⁻¹⁰⁶) on the f64[16] block of ``scene_params(...,
dtype=torch.float64)``.  ``iterate_whole`` is the plain version:
whole-image lock-step over the same arithmetic as the kernel, in the same
order.  The wrapper ``iterate_params`` runs it only for CPU tensors; for a
CUDA tensor it launches the kernel: ``csrc/escape.cu`` for f32 and ds32,
``csrc/escape_f64.cu`` for dd64 (three outputs only; a dd64 image is
colored in torch).  The points form (``iterate_points``, plain
version ``iterate_points_plain``) runs the same loop over a 1-D pixel
list: it replaces ``perturb.py::_fallback_1d``, the ds32 re-render of a
perturbation frame's flagged pixels.

The colored grid form (``iterate_color``, plain version
``iterate_color_plain``) runs ``ops/coloring.py``'s epilogue on each
pixel's final state in the kernel and returns the (height, width, 3) uint8
image: one launch a frame, 3 B a pixel, its constants in one block
(``color_params``).
"""

from __future__ import annotations

import ctypes
from fractions import Fraction
from typing import Tuple

import numpy as np
import torch

from fractal_tpu_torch.config import exact_pos
from fractal_tpu_torch.models.rules import get_rule
from fractal_tpu_torch.ops import coloring, dd
from fractal_tpu_torch.ops.viewport import affine_fractions

# Periodicity detection radius, squared (absolute): see escape_pallas.py.
PERIOD_EPS_SQ_DS32 = 1e-18
PERIOD_EPS_SQ_F32 = 1e-12
#: Steps between the plain version's whole-image "anything active?" checks.
CHUNK = 32

#: The f32-block precisions (``frame_blocks``, the colored form).  dd64
#: takes ``scene_params``' f64 block and the three-output grid form only.
PRECISIONS = ("f32", "ds32")
DD64 = "dd64"
# rule ids shared with csrc/escape.cu
RULE_SQUARE, RULE_BURNINGSHIP, RULE_TRICORN, RULE_POWER = 0, 1, 2, 3

#: Kernel launches of the grid form, by ``iterate_params`` and
#: ``iterate_color`` (``F32_LAUNCHES``: those in f32; ``COLOR_LAUNCHES``:
#: those of the colored form), and of the points form by ``iterate_points``
#: (plain-version calls excluded); ``DD64_LAUNCHES``: the dd64 grid form's,
#: which ``LAUNCHES`` does not count.
LAUNCHES = 0
DD64_LAUNCHES = 0
F32_LAUNCHES = 0
COLOR_LAUNCHES = 0
POINT_LAUNCHES = 0
#: Width of ``color_params``' block.
COLOR_FIELDS = 9
#: Steps the f32 loop of ``csrc/escape.cu`` takes a pass (one exit test).
F32_STEPS_PER_PASS = 2


# ---------------------------------------------------------------------------
# Host-side exact viewport constants
# ---------------------------------------------------------------------------


def _split_fraction(v: Fraction, dtype=np.float32) -> Tuple:
    hi = dtype(float(v))
    lo = dtype(float(v - Fraction(float(hi))))
    return hi, lo


def viewport_affine(width: int, height: int, pos, scale,
                    dtype=np.float32) -> Tuple:
    """``viewport.affine_fractions`` split into double-word pairs of
    ``dtype``: ((A_re, C_re), (A_im, C_im))."""
    return tuple((_split_fraction(a, dtype), _split_fraction(c, dtype))
                 for a, c in affine_fractions(width, height, pos, scale))


def scene_params(scene, height: int = None, width: int = None,
                 device="cuda", dtype=torch.float32) -> torch.Tensor:
    """The kernel's [16] parameter block, f32 (f32, ds32) or f64 (dd64):
      [0:8]   viewport affine pairs (A_re, C_re, A_im, C_im)
      [8]     limit²
      [9]     spare
      [10:14] julia c pairs (re_hi, re_lo, im_hi, im_lo)
      [14:16] global-row map (stride, offset); identity (1, 0)."""
    ss = scene.supersample
    height = height if height is not None else scene.height * ss
    width = width if width is not None else scene.width * ss
    np_dt = np.float64 if dtype == torch.float64 else np.float32
    (Ar, Cr), (Ai, Ci) = viewport_affine(width, height, exact_pos(scene),
                                         scene.scale, np_dt)
    julia = scene.algo == "julia"
    jr = dd.split_str(repr(float(scene.julia_set[0])), np_dt) if julia else (0.0, 0.0)
    ji = dd.split_str(repr(float(scene.julia_set[1])), np_dt) if julia else (0.0, 0.0)
    limit_sq = np_dt(float(scene.limit)) ** 2
    block = np.asarray(
        [Ar[0], Ar[1], Cr[0], Cr[1], Ai[0], Ai[1], Ci[0], Ci[1],
         limit_sq, 0.0, jr[0], jr[1], ji[0], ji[1], 1.0, 0.0],
        np_dt,
    )
    return torch.from_numpy(block).to(device)


def params_dtype(precision: str) -> torch.dtype:
    """The word type of ``precision``'s parameter block."""
    return torch.float64 if precision == DD64 else torch.float32


def color_params(scene, device="cuda") -> torch.Tensor:
    """The colored form's f32[9] block (``coloring.color_block``):
      [0]   stable_limit (against the squared final distance)
      [1]   iterations, as a float (the epilogue divides by it)
      [2]   exposure
      [3:6] primary color (r, b, g), [6:9] secondary (r, b, g)."""
    return coloring.color_block(
        iterations=scene.iterations, stable_limit=scene.stable_limit,
        exposure=scene.exposure, primary_color=scene.primary_color.as_tuple(),
        secondary_color=scene.secondary_color.as_tuple(), device=device)


def frame_blocks(scenes, device="cuda"):
    """Each scene's ``scene_params`` and ``color_params``, made on the host
    and uploaded in one copy: ((n, 16), (n, 9)) views of one (n, 25) tensor
    on ``device``, whose rows are contiguous."""
    host = torch.stack([torch.cat([scene_params(s, device="cpu"), color_params(s, device="cpu")])
                        for s in scenes])
    block = host.to(device)
    return block[:, :16], block[:, 16:]


# ---------------------------------------------------------------------------
# Plain torch version (the CPU route and the card-side check of the kernel)
# ---------------------------------------------------------------------------


class _F32Rep:
    """Plain float32: z = (zr, zi)."""

    eps_sq = PERIOD_EPS_SQ_F32

    @staticmethod
    def make_c(xx, yy, P):
        cr = xx * (P[0] + P[1]) + (P[2] + P[3])
        ci = yy * (P[4] + P[5]) + (P[6] + P[7])
        return cr, ci

    @staticmethod
    def julia_c(P, like):
        return (torch.full_like(like, float(P[10] + P[11])),
                torch.full_like(like, float(P[12] + P[13])))

    @staticmethod
    def step(rule, z, c):
        return rule(z[0], z[1], c[0], c[1])

    @staticmethod
    def dist(z):
        return z[0] * z[0] + z[1] * z[1]

    @staticmethod
    def select(mask, a, b):
        return tuple(torch.where(mask, x, y) for x, y in zip(a, b))

    @staticmethod
    def diff_dist(a, b):
        dr = a[0] - b[0]
        di = a[1] - b[1]
        return dr * dr + di * di

    @staticmethod
    def collapse(z):
        return z[0], z[1]


class _DS32Rep:
    """Double-word pairs, z = ((zr_hi, zr_lo), (zi_hi, zi_lo)), of f32 words
    (ds32) or f64 words (dd64): ``ops/dd.py`` picks the splitter and
    ``_fma`` by the word type, as ``escape_pallas._DS32Rep`` is one class
    for both."""

    eps_sq = PERIOD_EPS_SQ_DS32

    @staticmethod
    def make_c(xx, yy, P):
        cr = dd.add(dd.mul_f((P[0], P[1]), xx), (P[2], P[3]))
        ci = dd.add(dd.mul_f((P[4], P[5]), yy), (P[6], P[7]))
        return cr, ci

    @staticmethod
    def julia_c(P, like):
        def f(v):
            return torch.full_like(like, float(v))
        return ((f(P[10]), f(P[11])), (f(P[12]), f(P[13])))

    @staticmethod
    def step(rule, z, c):
        name, power = rule
        zr, zi = z
        cr, ci = c
        if name in ("mandelbrot", "julia", "multibrot") and power == 2:
            return dd.quad_step(zr, zi, cr, ci)
        if name == "burningship":
            ar = dd.where(zr[0] < 0, dd.neg(zr), zr)
            ai = dd.where(zi[0] < 0, dd.neg(zi), zi)
            return dd.quad_step(ar, ai, cr, ci)
        if name == "tricorn":
            return dd.quad_step(zr, zi, cr, ci, cross_sign=-1.0)
        if name in ("mandelbrot", "julia", "multibrot"):
            wr, wi = zr, zi
            for _ in range(power - 1):
                nwr = dd.sub(dd.mul(wr, zr), dd.mul(wi, zi))
                nwi = dd.add(dd.mul(wr, zi), dd.mul(wi, zr))
                wr, wi = nwr, nwi
            return dd.add(wr, cr), dd.add(wi, ci)
        raise ValueError(f"no ds32 rule for {name!r}")

    @staticmethod
    def dist(z):
        # hi words only (the escape threshold is >= 2; see escape_pallas.py)
        return z[0][0] * z[0][0] + z[1][0] * z[1][0]

    @staticmethod
    def select(mask, a, b):
        return tuple(dd.where(mask, pa, pb) for pa, pb in zip(a, b))

    @staticmethod
    def diff_dist(a, b):
        dr = (a[0][0] - b[0][0]) + (a[0][1] - b[0][1])
        di = (a[1][0] - b[1][0]) + (a[1][1] - b[1][1])
        return dr * dr + di * di

    @staticmethod
    def collapse(z):
        return z[0][0] + z[0][1], z[1][0] + z[1][1]


def _rep_rule(algo: str, power: int, precision: str):
    if precision not in PRECISIONS + (DD64,):
        raise ValueError(f"kernel A takes f32, ds32 or dd64, not {precision!r}")
    if precision != "f32":
        return _DS32Rep, (algo, power)
    return _F32Rep, get_rule(algo, power)


def iterate_whole(params, *, algo: str, power: int, iterations: int,
                  precision: str, height: int, width: int,
                  periodicity: bool = False):
    """Plain torch version of kernel A on ``params``' device: the whole
    image in lock-step with freeze masks (the twin of
    ``escape_pallas.iterate_whole_jnp``), in ``params``' word type.
    Returns (zr, zi, cnt)."""
    dt = params.dtype
    xx = torch.arange(width, dtype=dt, device=params.device).expand(height, width)
    yy = torch.arange(height, dtype=dt, device=params.device)[:, None].expand(height, width)
    yy = yy * params[14] + params[15]  # global-row map (integer-valued, exact)
    return _iterate(params, xx, yy, algo=algo, power=power, iterations=iterations,
                    precision=precision, periodicity=periodicity)


def iterate_color_plain(params, color, *, algo: str, power: int, iterations: int,
                        precision: str, height: int, width: int,
                        periodicity: bool = False, inside: bool = True,
                        smooth: bool = True):
    """Plain torch version of kernel A's colored form: ``iterate_whole``,
    then ``ops/coloring.py``'s ops on the constants of ``color`` (f32[9]
    from ``color_params``) → (height, width, 3) uint8."""
    zr, zi, cnt = iterate_whole(params, algo=algo, power=power, iterations=iterations,
                                precision=precision, height=height, width=width,
                                periodicity=periodicity)
    return color_plain(zr, zi, cnt, color, inside=inside, smooth=smooth)


def color_plain(zr, zi, cnt, color, *, inside: bool, smooth: bool):
    """The colored form's epilogue in torch on (zr, zi, cnt) of kernel A:
    ``render._color_and_downsample`` at supersample 1."""
    img = coloring.color_from_block(zr * zr + zi * zi, cnt, color, inside=inside,
                                    smooth=smooth, as_float=True)
    return coloring.rust_u8_cast(img)


def iterate_points_plain(params, xs, ys, *, algo: str, power: int,
                         iterations: int, precision: str = "ds32",
                         periodicity: bool = False):
    """Plain torch version of kernel A's points form: the pixels at (xs,
    ys), each (k,) f32, as ``perturb.py::_fallback_1d`` hands them to
    ``_iterate_tile`` (no row map).  Returns (zr, zi, cnt), each (k,)."""
    return _iterate(params, xs, ys, algo=algo, power=power, iterations=iterations,
                    precision=precision, periodicity=periodicity)


def _iterate(params, xx, yy, *, algo: str, power: int, iterations: int,
             precision: str, periodicity: bool):
    rep, rule = _rep_rule(algo, power, precision)
    if params.dtype != params_dtype(precision):
        raise ValueError(f"{precision} takes a {params_dtype(precision)} block, "
                         f"not {params.dtype}")
    device = params.device
    P = [params[i] for i in range(16)]
    limit_sq = P[8]
    eps_sq = torch.tensor(rep.eps_sq, dtype=params.dtype, device=device)

    c = rep.make_c(xx, yy, P)
    z = c
    if algo == "julia":
        c = rep.julia_c(P, xx)
    d = rep.dist(z)
    cnt = torch.zeros(xx.shape, dtype=torch.int32, device=device)
    snap = z
    for n in range(max(iterations, 1) + 1):
        active = (d <= limit_sq) & (cnt < iterations)
        if n % CHUNK == 0 and not bool(active.any()):
            break
        nz = rep.step(rule, z, c)
        nd = rep.dist(nz)
        esc_now = active & (nd > limit_sq)
        z = rep.select(active, nz, z)
        d = torch.where(active, nd, d)
        cnt = cnt + (active & ~esc_now).to(torch.int32)
        if periodicity:
            per_now = active & ~esc_now & (rep.diff_dist(nz, snap) < eps_sq)
            cnt = torch.where(per_now, torch.full_like(cnt, iterations), cnt)
            if n >= 1 and (n & (n - 1)) == 0:
                snap = rep.select(active, z, snap)
    zr, zi = rep.collapse(z)
    return zr, zi, cnt


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------


def _rule_id(algo: str, power: int) -> int:
    if algo == "burningship":
        return RULE_BURNINGSHIP
    if algo == "tricorn":
        return RULE_TRICORN
    if algo in ("mandelbrot", "julia", "multibrot"):
        if power < 2:
            raise ValueError("multibrot power must be >= 2")
        return RULE_SQUARE if power == 2 else RULE_POWER
    raise ValueError(f"no escape-time rule for algo {algo!r}")


def _check_grid(params, precision: str, height: int, width: int, iterations: int):
    if params.device.type != "cuda":
        raise RuntimeError(f"kernel A runs on cuda, not {params.device}")
    if precision not in PRECISIONS + (DD64,):
        raise ValueError(f"kernel A takes f32, ds32 or dd64, not {precision!r}")
    dtype = params_dtype(precision)
    if params.dtype != dtype or params.shape != (16,) or not params.is_contiguous():
        raise ValueError(f"params must be a contiguous {dtype} tensor of shape (16,) "
                         f"for {precision}")
    if height <= 0 or width <= 0 or iterations < 0:
        raise ValueError("height/width must be positive and iterations >= 0")


def _count(precision: str, color: bool) -> None:
    global LAUNCHES, DD64_LAUNCHES, F32_LAUNCHES, COLOR_LAUNCHES
    if precision == DD64:
        DD64_LAUNCHES += 1
        return
    LAUNCHES += 1
    F32_LAUNCHES += precision == "f32"
    COLOR_LAUNCHES += color


def iterate_params(params, *, algo: str, power: int, iterations: int,
                   precision: str, height: int, width: int,
                   periodicity: bool = False):
    """Kernel A on ``params``' device: the [16] block of ``scene_params``
    (f32 for f32 and ds32, f64 for dd64) → (zr, zi, cnt i32), each
    (height, width), zr and zi in the block's word type.  A CPU ``params``
    runs ``iterate_whole``; a CUDA one launches ``csrc/escape.cu``, or
    ``csrc/escape_f64.cu`` for dd64."""
    if params.device.type == "cpu":
        return iterate_whole(params, algo=algo, power=power,
                             iterations=iterations, precision=precision,
                             height=height, width=width,
                             periodicity=periodicity)
    _check_grid(params, precision, height, width, iterations)
    rule = _rule_id(algo, power)
    from fractal_tpu_torch.ops import _cuda_build

    lib = _cuda_build.load()
    zr = torch.empty((height, width), dtype=params.dtype, device=params.device)
    zi = torch.empty_like(zr)
    cnt = torch.empty((height, width), dtype=torch.int32, device=params.device)
    # csrc/escape_f64.cu's dd64 entry takes no word-type flag
    entry, form = ((lib.fractal_escape_dd64, ()) if precision == DD64
                   else (lib.fractal_escape, (int(precision == "ds32"),)))
    err = entry(
        params.data_ptr(), *form, rule,
        int(algo == "julia"), int(bool(periodicity)), int(power),
        int(iterations), int(height), int(width),
        zr.data_ptr(), zi.data_ptr(), cnt.data_ptr(),
        torch.cuda.current_stream(params.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"escape kernel launch failed: "
                           f"{_cuda_build.error_string(err)}")
    _count(precision, False)
    return zr, zi, cnt


def iterate_color(params, color, *, algo: str, power: int, iterations: int,
                  precision: str, height: int, width: int,
                  periodicity: bool = False, inside: bool = True,
                  smooth: bool = True, out=None):
    """Kernel A's colored form on ``params``' device: f32[16] from
    ``scene_params`` and f32[9] from ``color_params`` → the (height, width,
    3) uint8 image, written into ``out`` when given (a contiguous uint8
    tensor of that shape on the same device).  CPU tensors run
    ``iterate_color_plain``; CUDA tensors launch ``csrc/escape.cu``."""
    if params.device.type == "cpu" and color.device.type == "cpu":
        img = iterate_color_plain(params, color, algo=algo, power=power,
                                  iterations=iterations, precision=precision,
                                  height=height, width=width, periodicity=periodicity,
                                  inside=inside, smooth=smooth)
        return img if out is None else out.copy_(img)
    if precision not in PRECISIONS:
        raise ValueError(f"kernel A's colored form takes f32 or ds32, not {precision!r}")
    _check_grid(params, precision, height, width, iterations)
    if color.device != params.device or color.dtype != torch.float32 \
            or color.shape != (COLOR_FIELDS,) or not color.is_contiguous():
        raise ValueError(f"color must be a contiguous float32 tensor of shape "
                         f"({COLOR_FIELDS},) on {params.device}")
    if out is None:
        out = torch.empty((height, width, 3), dtype=torch.uint8, device=params.device)
    elif out.device != params.device or out.dtype != torch.uint8 \
            or out.shape != (height, width, 3) or not out.is_contiguous():
        raise ValueError(f"out must be a contiguous uint8 tensor of shape "
                         f"({height}, {width}, 3) on {params.device}")
    rule = _rule_id(algo, power)
    from fractal_tpu_torch.ops import _cuda_build

    lib = _cuda_build.load()
    err = lib.fractal_escape_color(
        params.data_ptr(), color.data_ptr(), int(precision == "ds32"), rule,
        int(algo == "julia"), int(bool(periodicity)), int(power), int(iterations),
        int(height), int(width), int(bool(inside)), int(bool(smooth)), out.data_ptr(),
        torch.cuda.current_stream(params.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"escape color kernel launch failed: "
                           f"{_cuda_build.error_string(err)}")
    _count(precision, True)
    return out


def math_probe(op: str, x):
    """``log2f`` or ``sqrtf`` of the colored form's epilogue on a CUDA
    float32 tensor (a check of libdevice against torch's own calls)."""
    if x.device.type != "cuda" or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("x must be a contiguous float32 CUDA tensor")
    from fractal_tpu_torch.ops import _cuda_build

    y = torch.empty_like(x)
    err = _cuda_build.load().fractal_math_probe(
        ("log2", "sqrt").index(op), x.data_ptr(), y.data_ptr(), x.numel(),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"math probe launch failed: {_cuda_build.error_string(err)}")
    return y


def iterate_points(params, xs, ys, *, algo: str, power: int, iterations: int,
                   precision: str = "ds32", periodicity: bool = False):
    """Kernel A's points form on ``params``' device: the pixels at (xs, ys),
    each (k,) f32 → (zr f32, zi f32, cnt i32), each (k,).  CPU tensors run
    ``iterate_points_plain``; CUDA tensors launch ``csrc/escape.cu``."""
    if all(t.device.type == "cpu" for t in (params, xs, ys)):
        return iterate_points_plain(params, xs, ys, algo=algo, power=power,
                                    iterations=iterations, precision=precision,
                                    periodicity=periodicity)
    for name, t in (("params", params), ("xs", xs), ("ys", ys)):
        if t.device.type != "cuda" or t.dtype != torch.float32 \
                or not t.is_contiguous() or t.device != params.device:
            raise ValueError(f"{name} must be a contiguous float32 tensor on "
                             f"{params.device}, got {t.dtype} on {t.device}")
    if params.shape != (16,) or xs.dim() != 1 or xs.shape != ys.shape \
            or xs.numel() == 0:
        raise ValueError(f"want params (16,) and xs, ys of one shape (k,), got "
                         f"{tuple(params.shape)}, {tuple(xs.shape)}, {tuple(ys.shape)}")
    if precision not in PRECISIONS:
        raise ValueError(f"kernel A's points form takes f32 or ds32, not {precision!r}")
    if iterations < 0:
        raise ValueError("iterations must be >= 0")
    rule = _rule_id(algo, power)
    from fractal_tpu_torch.ops import _cuda_build

    lib = _cuda_build.load()
    k = xs.numel()
    zr = torch.empty(k, dtype=torch.float32, device=params.device)
    zi = torch.empty_like(zr)
    cnt = torch.empty(k, dtype=torch.int32, device=params.device)
    err = lib.fractal_escape_points(
        params.data_ptr(), int(precision == "ds32"), rule, int(algo == "julia"),
        int(bool(periodicity)), int(power), int(iterations), xs.data_ptr(),
        ys.data_ptr(), k, zr.data_ptr(), zi.data_ptr(), cnt.data_ptr(),
        torch.cuda.current_stream(params.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"escape points kernel launch failed: "
                           f"{_cuda_build.error_string(err)}")
    global POINT_LAUNCHES
    POINT_LAUNCHES += 1
    return zr, zi, cnt


def bind(lib: ctypes.CDLL) -> None:
    """Declare the C signatures of ``csrc/escape.cu``'s entry points."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fractal_escape.argtypes = [p, i, i, i, i, i, i, i, i, p, p, p, p]
    lib.fractal_escape.restype = i
    lib.fractal_escape_color.argtypes = [p, p, i, i, i, i, i, i, i, i, i, i, p, p]
    lib.fractal_escape_color.restype = i
    lib.fractal_escape_points.argtypes = [p, i, i, i, i, i, i, p, p, i, p, p, p, p]
    lib.fractal_escape_points.restype = i
    lib.fractal_math_probe.argtypes = [i, p, p, ctypes.c_long, p]
    lib.fractal_math_probe.restype = i
    lib.fractal_escape_dd64.argtypes = [p, i, i, i, i, i, i, i, p, p, p, p]
    lib.fractal_escape_dd64.restype = i
