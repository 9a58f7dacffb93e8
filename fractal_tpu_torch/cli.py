"""Command-line frontend, flag for flag the JAX package's (which mirrors the
reference CLI, src/lib.rs:31-234): stills, ``--animate`` sweeps,
``--bands`` renders with ``--checkpoint-dir``, the viewer (``-g``),
``--trace``, ``--backend`` and ``--devices``.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from fractions import Fraction
from typing import List, Optional

from fractal_tpu_torch.config import Scene, normalize_algo, parse_hex_rgb, scene_defaults

CLI_ALGOS = ("mandelbrot", "fern", "julia", "multibrot", "burningship", "tricorn")


@dataclasses.dataclass
class Options:
    """The reference ``Options`` struct (src/lib.rs:236-243) plus extensions."""

    scene: Scene
    filename: str
    open: bool
    gui: bool
    fmt: str = "avif"
    profile: bool = False
    backend: str = "auto"
    trace: str = None
    bands: int = 0
    ckpt_dir: str = None
    animate: int = 0          # frame count; 0 = still render
    sweep: str = "julia"      # julia | zoom
    zoom_from: float = None   # zoom sweep start scale (end is the scene's -s)
    exact_sweep: bool = False  # zoom sweep: still-quality frames
    devices: int = 1          # 1 = single device; N>1 = mesh; 0 = all


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="fractal-renderer",
        description="Set `-d` for a more traditional look.",
    )
    p.add_argument("width", nargs="?", type=int, default=750,
                   help="Easily handles 100MP images.")
    p.add_argument("height", nargs="?", type=int, default=500,
                   help="Easily handles 100MP images.")
    p.add_argument("-i", "--iterations", type=int, default=None,
                   help="Limit of iterations. Default is 50 for Mandelbrot & "
                        "Julia and 10_000_000 for Fern.")
    p.add_argument("-l", "--limit", type=float, default=65536.0,
                   help="Limit where values are treated to escape.")
    p.add_argument("--stable-limit", dest="stable_limit", type=float, default=2.0,
                   help="The limit of points considered inside the fractal.")
    p.add_argument("-x", dest="pos_x", type=str, default=None)
    p.add_argument("-y", dest="pos_y", type=str, default="0")
    p.add_argument("--scale-x", dest="scale_x", type=float, default=None)
    p.add_argument("--scale-y", dest="scale_y", type=float, default=None)
    p.add_argument("-s", "--scale", type=float, default=None)
    p.add_argument("-e", "--exposure", type=float, default=5.0)
    p.add_argument("--primary-color", dest="primary_color", default=None,
                   help="The main color of output (hex RRGGBB).")
    p.add_argument("--secondary-color", dest="secondary_color", default=None,
                   help="The secondary color of output (hex RRGGBB).")
    p.add_argument("-d", "--disable-inside", dest="disable_inside",
                   action="store_true",
                   help="Makes the inside of fractals black.")
    p.add_argument("-u", "--unsmooth", action="store_true",
                   help="Don't smooth the aliasing of the borders.")
    p.add_argument("-o", "--output", default="output")
    p.add_argument("--open", action="store_true",
                   help="Open the image after generation.")
    p.add_argument("-a", "--algorithm", default="mandelbrot",
                   choices=CLI_ALGOS, help="The algorithm to use.")
    p.add_argument("--julia-real", dest="julia_re", type=float, default=None,
                   help="Real part of start point for Julia set.")
    p.add_argument("--julia-imaginary", dest="julia_im", type=float, default=None,
                   help="Imaginary part of start point for Julia set.")
    p.add_argument("-w", "--color-weight", dest="color_weight", type=float,
                   default=0.01, help="Opacity of each hit on the Fern.")
    p.add_argument("-g", "--gui", action="store_true",
                   help="Start the GUI. Use `s` to take a 2x screenshot. "
                        "Use the arrow keys and scroll to move around.")

    ext = p.add_argument_group("framework extensions")
    ext.add_argument("--power", type=int, default=2,
                     help="Exponent d in z^d + c.")
    ext.add_argument("--supersample", type=int, default=1, metavar="K",
                     help="K×K supersampled anti-aliasing.")
    ext.add_argument("--precision", default="auto",
                     choices=("auto", "f32", "f64", "ds32", "dd64", "perturb",
                              "p32"),
                     help="Number representation; 'p32' is the explicit "
                          "fast tier (f32 delta orbits).")
    ext.add_argument("--seed", type=int, default=0,
                     help="PRNG seed for the fern chaos game.")
    ext.add_argument("--fern-replicas", dest="fern_replicas", type=int, default=1)
    ext.add_argument("--format", dest="fmt", default="avif",
                     choices=("avif", "png"), help="Output image format.")
    ext.add_argument("--true-colors", dest="true_colors", action="store_true",
                     help="Fern only: store hex colors as real RRGGBB.")
    ext.add_argument("--animate", type=int, default=0, metavar="N",
                     help="Render an N-frame animation, written as "
                          "OUTPUT_0000.EXT ... See --sweep.")
    ext.add_argument("--sweep", default="julia", choices=("julia", "zoom"),
                     help="What --animate sweeps: 'julia' moves the Julia c "
                          "around a circle, 'zoom' zooms from --zoom-from to -s.")
    ext.add_argument("--zoom-from", dest="zoom_from", type=float, default=None,
                     help="Start scale for --sweep zoom (default: 0.4).")
    ext.add_argument("--exact-sweep", dest="exact_sweep", action="store_true",
                     help="Zoom sweeps only: every frame equals its still.")
    ext.add_argument("--profile", action="store_true",
                     help="Print per-phase timing (render / transfer / encode).")
    ext.add_argument("--trace", default=None, metavar="DIR",
                     help="Write a torch.profiler trace of the render to DIR.")
    ext.add_argument("--backend", default="auto",
                     choices=("auto", "jnp", "pallas"),
                     help="The f32 escape route of a still: 'jnp' the pixel "
                          "grid loop, 'pallas' kernel A.")
    ext.add_argument("--devices", type=int, default=1, metavar="N",
                     help="Render across the first N devices of a mesh "
                          "(on the CPU, of 8 shards). Escape renders "
                          "interleave rows per device; fern slices the walker "
                          "set per device and sums the integer histograms; "
                          "--animate sweeps split the frames; --bands bands "
                          "interleave their rows; -g viewer frames shard when "
                          "the tier supports it — all bit-identical to "
                          "single-device. 0 = all available devices; default "
                          "1 = single device.")
    ext.add_argument("--bands", type=int, default=0, metavar="ROWS",
                     help="Render in horizontal bands of ROWS rows.")
    ext.add_argument("--checkpoint-dir", dest="ckpt_dir", default=None,
                     help="With --bands: save finished bands here and resume "
                          "from them.")
    return p


def parse_options(argv: Optional[List[str]] = None) -> Options:
    args = build_parser().parse_args(argv)
    algo = normalize_algo(args.algorithm)

    # clap default_value_if: -x defaults to 0 for julia, −0.6 otherwise
    # (src/lib.rs:69-71)
    pos_x = args.pos_x if args.pos_x is not None else ("0" if algo == "julia" else "-0.6")
    try:
        Fraction(str(pos_x)), Fraction(str(args.pos_y))
    except (ValueError, ZeroDivisionError):
        sys.exit(f"error: invalid -x/-y value: {pos_x!r} / {args.pos_y!r}")

    # clap ArgGroup (src/lib.rs:80-94): --scale-x, --scale-y and -s exclude
    # each other; each axis falls back to -s (default 0.4)
    if args.scale_x is not None and args.scale_y is not None:
        sys.exit("error: --scale-x cannot be used with --scale-y")
    if args.scale is not None and (args.scale_x is not None or args.scale_y is not None):
        sys.exit("error: --scale cannot be used with --scale-x/--scale-y")
    scale_default = args.scale if args.scale is not None else 0.4
    scale = (
        args.scale_x if args.scale_x is not None else scale_default,
        args.scale_y if args.scale_y is not None else scale_default,
    )

    julia = (0.0, 0.0)
    if algo == "julia":
        if args.julia_re is None or args.julia_im is None:
            sys.exit("error: --algorithm julia requires --julia-real and "
                     "--julia-imaginary")
        julia = (args.julia_re, args.julia_im)

    compat = not (args.true_colors and algo == "fern")
    defaults = scene_defaults(algo)
    primary = (parse_hex_rgb(args.primary_color, compat) if args.primary_color
               else defaults.primary_color)
    secondary = (parse_hex_rgb(args.secondary_color, compat) if args.secondary_color
                 else defaults.secondary_color)

    scene = Scene(
        algo=algo,
        width=args.width,
        height=args.height,
        iterations=(args.iterations if args.iterations is not None
                    else defaults.iterations),
        limit=args.limit,
        stable_limit=args.stable_limit,
        pos_str=(str(pos_x), str(args.pos_y)),
        scale=scale,
        exposure=args.exposure,
        inside=not args.disable_inside,
        smooth=not args.unsmooth,
        primary_color=primary,
        secondary_color=secondary,
        color_weight=args.color_weight,
        julia_set=julia,
        power=args.power,
        supersample=args.supersample,
        precision=args.precision,
        seed=args.seed,
        fern_replicas=args.fern_replicas,
    )
    if args.animate and args.sweep == "julia" and algo != "julia":
        sys.exit("error: --animate with --sweep julia requires -a julia "
                 "(use --sweep zoom for mandelbrot zoom videos)")
    if args.devices < 0:
        sys.exit("error: --devices must be >= 0 (0 = all available)")
    return Options(scene=scene, filename=args.output, open=args.open, gui=args.gui,
                   fmt=args.fmt, profile=args.profile, backend=args.backend,
                   trace=args.trace, bands=args.bands, ckpt_dir=args.ckpt_dir,
                   animate=args.animate, sweep=args.sweep, zoom_from=args.zoom_from,
                   exact_sweep=args.exact_sweep, devices=args.devices)
