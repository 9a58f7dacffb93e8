"""Render driver (port of ``fractal_tpu/render.py``): viewport → escape
iteration → coloring → supersample downsample, on an explicit device.

Routes, as the JAX package takes them (render.py:206-241):
  * p32, perturb              → ``ops/perturb.render_perturb`` (kernel B's
                                dist-only form; the exact tier's glitch
                                form, kernel C, kernel A's points form;
                                past spacing 1e-30 the floatexp tier:
                                kernel D's grid and points forms, or the fe
                                BLA route where its table is useful);
  * f32 / ds32 on cuda        → kernel A (``ops/escape_cuda``): at
                                supersample 1 its colored form, one launch
                                that writes the u8 image; above it the
                                three-output form, colored and
                                box-downsampled in torch;
  * dd64 on cuda              → kernel A's dd64 form (``escape_time_dd64``,
                                an f64[16] block), three outputs at every
                                supersample, colored in torch;
  * ds32, dd64 on cpu         → kernel A's plain version;
  * f32 on cpu, f64 anywhere  → ``ops/viewport.pixel_grid`` +
                                ``ops/escape.iterate_grid``: on cuda the
                                f64 kernel (``escape_time_f64``), on the
                                CPU ``ops/escape.iterate``;
  * the fern                  → ``models/fern.render_fern`` (the chaos game;
                                its histogram is kernel H, ``ops/hist_cuda``).

``backend`` (the JAX package's ``--backend``, render.py:222-241) reaches
the f32 escape route only: "auto" is the ladder above; "jnp" takes the
grid route at f32 on any device (on cuda at supersample 1 the f32 grid
loop's colored form, ``escape_time_f32_grid_color``, one launch that forms
the pixel grid and writes the u8 image; above it ``pixel_grid``, the
three-output ``escape_time_f32_grid`` and torch's coloring); "pallas"
takes kernel A's f32 form at f32 and at f64 (the JAX package's pallas
route reads any precision but ds32 and dd64 as one f32 word,
escape_pallas.py:325-330), on the CPU its plain version.  ds32, dd64,
the perturbation tiers and the fern ignore it.

Sweeps (``animate.py``) render each frame through ``_render_tier`` at one
precision for the whole sweep; banded renders (``tiled.py``) address one
band of global rows through ``_render_grid``'s ``row0``/``rows`` (f64) or
kernel A's global-row map, params[15] (f32, ds32, dd64, on every device).

Precision ladder for "auto" (by pixel spacing 1/(height·scale)): f32 above
2e-5; ``perturb`` at or below 1e-13 for algos with a δ-recurrence;
otherwise ds32 on cuda and f64 on cpu.

Spans (``utils/timing.span``) go to the perturbation module's sink,
``ops/perturb.SPLIT``, so one list holds a frame's steps on every route:
"blocks" (kernel A's parameter blocks and their upload), "kernel A" (its
launch), "coloring" (torch's, above supersample 1) and, in ``render``, "to
host" (the wait for the card and the copy into host memory).
"""

from __future__ import annotations

import torch

from fractal_tpu_torch.config import Scene
from fractal_tpu_torch.models.rules import perturb_supported
from fractal_tpu_torch.ops import coloring, escape_cuda, perturb, viewport
from fractal_tpu_torch.ops.escape import iterate_grid, iterate_grid_color
from fractal_tpu_torch.utils.timing import span

F32_SPACING_LIMIT = 2e-5
F64_SPACING_LIMIT = 1e-13
PERTURB_SPACING_LIMIT = 1e-13

#: The route of the last escape-time image (``--profile`` prints it):
#: "kernel A ...", "f64 kernel" or "f32 grid kernel ..." on cuda, "... plain
#: version" on the CPU.
RENDER_STATS = {"route": ""}
#: ``render_u8``'s ``backend`` values.
BACKENDS = ("auto", "jnp", "pallas")
#: The grid route's kernels on cuda, by word type.
_GRID_KERNELS = {"f64": "f64 kernel (escape_time_f64)",
                 "f32": "f32 grid kernel (escape_time_f32_grid)"}
GRID_COLOR_ROUTE = "f32 grid kernel, colored (escape_time_f32_grid_color)"


def _span(kind: str, detail: str = ""):
    return span(perturb.SPLIT, kind, detail)


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a CUDA device was asked for, but "
                           "torch.cuda.is_available() is False")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


def resolve_precision(scene: Scene, device) -> str:
    """'auto' → a concrete precision for this scene on ``device``."""
    if scene.precision != "auto":
        return scene.precision
    spacing = scene.pixel_spacing / scene.supersample
    if spacing > F32_SPACING_LIMIT:
        return "f32"
    if (perturb_supported(scene.algo, scene.power)
            and spacing <= PERTURB_SPACING_LIMIT):
        return "perturb"
    if torch.device(device).type != "cpu":
        return "ds32"
    return "f64"


def _color_and_downsample_dist(scene: Scene, dist, cnt):
    img_f = coloring.color_escape_result_dist(
        dist, cnt,
        iterations=scene.iterations,
        stable_limit=scene.stable_limit,
        exposure=scene.exposure,
        primary_color=scene.primary_color.as_tuple(),
        secondary_color=scene.secondary_color.as_tuple(),
        inside=scene.inside,
        smooth=scene.smooth,
        as_float=True,
    )
    return coloring.downsample_box(img_f, scene.supersample)


def _color_and_downsample(scene: Scene, zr, zi, cnt):
    return _color_and_downsample_dist(scene, zr * zr + zi * zi, cnt)


def _render_grid(scene: Scene, precision: str, device, row0: int = 0,
                 rows: int = None):
    """The ``pixel_grid`` + ``iterate_grid`` route (CPU f32, f64, and f32
    under ``backend="jnp"``; on cuda the f64 or the f32 grid kernel) over
    global rows [row0, row0 + rows) of the supersampled grid (all of it by
    default).  At f32 on cuda and supersample 1 it is one launch of the
    colored form (``iterate_grid_color``), which forms the grid itself."""
    ss = scene.supersample
    h, w = scene.height * ss, scene.width * ss
    # z starts at the pixel coordinate; c == z0 but for julia (calc/src/lib.rs:208-212)
    kw = dict(algo=scene.algo, power=scene.power, iterations=scene.iterations,
              limit=scene.limit, julia_set=scene.julia_set if scene.algo == "julia" else None)
    on_card = torch.device(device).type != "cpu"
    if precision == "f32" and ss == 1 and on_card:
        RENDER_STATS["route"] = GRID_COLOR_ROUTE
        return iterate_grid_color(escape_cuda.color_params(scene, device=device), width=w,
                                  height=h, pos=scene.pos, scale=scene.scale, row0=row0,
                                  rows=rows, inside=scene.inside, smooth=scene.smooth, **kw)
    dtype = torch.float64 if precision == "f64" else torch.float32
    cr, ci = viewport.pixel_grid(w, h, scene.pos, scene.scale, dtype=dtype,
                                 device=device, row0=row0, rows=rows)
    zr, zi, cnt = iterate_grid(cr, ci, **kw)
    RENDER_STATS["route"] = (_GRID_KERNELS[precision] if on_card else
                             f"{precision} grid, plain version (ops/escape.iterate)")
    return _color_and_downsample(scene, zr, zi, cnt)


def _render_params(scene: Scene, params, precision: str, rows: int, color=None,
                   out=None):
    """Kernel A on ``params``' device over ``rows`` rows of the supersampled
    grid, from the global row params[15], colored and downsampled; into
    ``out`` (a (rows // ss, width, 3) uint8 tensor) when given.

    At supersample 1 the f32 and ds32 forms color each pixel in the kernel
    (``iterate_color``, with ``color`` from ``escape_cuda.color_params``,
    made here when None): one launch, and no coloring pass or scalar upload
    after it.  Above 1, and for dd64 (f64 words; the colored form is f32's
    and ds32's only) at every supersample, the three-output form runs and
    ``_color_and_downsample`` colors and averages in torch: the box's mean
    keeps torch's summation order, which a kernel would have to copy to
    stay bit-equal."""
    kw = dict(algo=scene.algo, power=scene.power, iterations=scene.iterations,
              precision=precision, height=rows, width=scene.width * scene.supersample,
              # interior cycle detection only where interiors render black
              periodicity=not scene.inside)
    colored = scene.supersample == 1 and precision in escape_cuda.PRECISIONS
    RENDER_STATS["route"] = (f"kernel A {precision}{' colored' if colored else ''}"
                             + (" plain version" if params.device.type == "cpu" else ""))
    if colored:
        if color is None:
            color = escape_cuda.color_params(scene, device=params.device)
        with _span("kernel A", RENDER_STATS["route"]):
            return escape_cuda.iterate_color(params, color, inside=scene.inside,
                                             smooth=scene.smooth, out=out, **kw)
    with _span("kernel A", RENDER_STATS["route"]):
        zr, zi, cnt = escape_cuda.iterate_params(params, **kw)
    with _span("coloring"):
        img = _color_and_downsample(scene, zr, zi, cnt)
    return img if out is None else out.copy_(img)


def _render_tier(scene: Scene, precision: str, device, params=None, color=None,
                 out=None):
    """An escape-time image at a resolved f32, ds32, dd64 or f64
    ``precision``: the grid route for f64 and for f32 on the CPU, else
    kernel A on ``params`` and ``color`` (when None: ``scene_params`` and
    ``color_params`` of the scene uploaded together, or dd64's f64 block);
    into ``out`` when given."""
    if precision == "f64" or (precision == "f32" and device.type == "cpu"):
        img = _render_grid(scene, precision, device)
        return img if out is None else out.copy_(img)
    return _render_kernel_a(scene, precision, device, params, color, out)


def _render_kernel_a(scene: Scene, precision: str, device, params=None, color=None,
                     out=None):
    """Kernel A's image at f32, ds32 or dd64 on ``device`` (its plain version
    on the CPU), on ``params`` and ``color`` as ``_render_tier`` makes
    them."""
    if params is None and precision == escape_cuda.DD64:
        with _span("blocks", precision):
            params = escape_cuda.scene_params(scene, device=device, dtype=torch.float64)
    elif params is None:
        with _span("blocks", precision):
            params, color = (b[0] for b in escape_cuda.frame_blocks([scene], device))
    return _render_params(scene, params, precision, scene.height * scene.supersample,
                          color, out)


def _render_escape(scene: Scene, device, backend: str = "auto"):
    precision = resolve_precision(scene, device)
    if precision in ("perturb", "p32"):
        return perturb.render_perturb(scene, device, fast=precision == "p32")
    if backend == "jnp" and precision == "f32":
        return _render_grid(scene, "f32", device)
    if backend == "pallas" and precision in ("f32", "f64"):
        return _render_kernel_a(scene, "f32", device)
    return _render_tier(scene, precision, device)


def render_u8(scene: Scene, device, backend: str = "auto") -> torch.Tensor:
    """Render a scene to an (height, width, 3) uint8 tensor on ``device``;
    ``backend`` (one of ``BACKENDS``) picks the f32 escape route."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (choose from {BACKENDS})")
    device = _device(device)
    if scene.algo == "fern":
        from fractal_tpu_torch.models.fern import render_fern

        return render_fern(scene, device)
    return _render_escape(scene, device, backend)


def render(scene: Scene, device, backend: str = "auto"):
    """Render to a host numpy array (H, W, 3) uint8."""
    img = render_u8(scene, device, backend)
    with _span("to host"):
        return img.cpu().numpy()
