"""Scene configuration: the port's copy of ``fractal_tpu/config.py``.

Same fields, defaults, validation and color-storage conventions as the
JAX package (the reference's swapped ``RGB::new`` constructor,
calc/src/lib.rs:129, is replicated at parse time and undone at render
time in ``ops/coloring.py``).  ``Scene`` is a plain frozen dataclass: the
port has no tracer, so nothing is registered as a pytree.
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class RGB:
    """A u8 color triple, stored in true (r, g, b) field order."""

    r: int
    g: int
    b: int

    def __post_init__(self):
        for v in (self.r, self.g, self.b):
            if not (0 <= int(v) <= 255):
                raise ValueError(f"RGB channel out of range: {v}")

    def as_tuple(self) -> Tuple[int, int, int]:
        return (self.r, self.g, self.b)

    @staticmethod
    def reference_new(r: int, b: int, g: int) -> "RGB":
        """The reference's swapped constructor (calc/src/lib.rs:129): the
        2nd argument is BLUE, the 3rd GREEN."""
        return RGB(r, g, b)


BLACK = RGB(0, 0, 0)


def parse_hex_rgb(s: str, compat: bool = True) -> RGB:
    """Parse "RRGGBB" hex.  ``compat=True`` stores the fields as the
    reference does (src/lib.rs:22-28: parsed G in blue, parsed B in
    green); ``compat=False`` stores the literal RRGGBB."""
    s = s.removeprefix("#")
    if len(s) != 6:
        raise ValueError(f"hex color must be 6 digits, got {s!r}")
    r, g, b = (int(s[i : i + 2], 16) for i in (0, 2, 4))
    if compat:
        return RGB.reference_new(r, g, b)
    return RGB(r, g, b)


ESCAPE_ALGOS = ("mandelbrot", "julia", "multibrot", "burningship", "tricorn")
ALGOS = ESCAPE_ALGOS + ("fern",)
PRECISIONS = ("auto", "f32", "f64", "ds32", "dd64", "perturb", "p32")


def normalize_algo(name: str) -> str:
    """Case-insensitive; "barnsleyfern" is the fern (calc/src/lib.rs:166-179)."""
    s = name.lower()
    if s == "barnsleyfern":
        s = "fern"
    if s not in ALGOS:
        raise ValueError(f"invalid algorithm name: {name!r} (choose from {ALGOS})")
    return s


@dataclasses.dataclass(frozen=True)
class Scene:
    """The full render configuration (reference ``Config``,
    calc/src/lib.rs:21-37) plus the framework extensions (power,
    supersample, precision, seed, fern replicas, exact center strings)."""

    algo: str = "mandelbrot"
    width: int = 2000
    height: int = 1000
    iterations: int = 50
    limit: float = 2.0 ** 16
    stable_limit: float = 2.0
    pos: Tuple[float, float] = (0.0, 0.0)          # (re, im)
    scale: Tuple[float, float] = (0.4, 0.4)        # (re, im); larger = deeper zoom
    exposure: float = 2.0
    inside: bool = True
    smooth: bool = True
    primary_color: RGB = RGB(40, 255, 40)
    secondary_color: RGB = RGB(240, 0, 170)
    color_weight: float = 0.01
    julia_set: Tuple[float, float] = (0.0, 0.0)

    pos_str: object = None    # optional exact (re, im) decimal strings
    power: int = 2            # exponent d in z^d + c
    supersample: int = 1      # k×k supersampled anti-aliasing
    precision: str = "auto"   # one of PRECISIONS
    seed: int = 0             # fern chaos-game seed
    fern_replicas: int = 1    # reference-compat N-replica fern mode

    def __post_init__(self):
        object.__setattr__(self, "algo", normalize_algo(self.algo))
        if self.pos_str is not None:
            try:
                fr = tuple(Fraction(str(v)) for v in self.pos_str)
            except (ValueError, ZeroDivisionError) as e:
                raise ValueError(f"invalid pos_str {self.pos_str!r}: {e}")
            object.__setattr__(self, "pos_str",
                               (str(self.pos_str[0]), str(self.pos_str[1])))
            object.__setattr__(self, "pos", (float(fr[0]), float(fr[1])))
        if self.width <= 0 or self.height <= 0:
            raise ValueError("width/height must be positive")
        if self.iterations < 0:
            raise ValueError("iterations must be >= 0")
        if self.supersample < 1:
            raise ValueError("supersample must be >= 1")
        if self.precision not in PRECISIONS:
            raise ValueError(f"unknown precision {self.precision!r}")

    @property
    def pixel_spacing(self) -> float:
        """Complex-plane distance between adjacent pixels
        (calc/src/lib.rs:181-184 divides by height·scale)."""
        return 1.0 / (self.height * min(abs(self.scale[0]), abs(self.scale[1])) + 1e-300)

    def replace(self, **kw) -> "Scene":
        return dataclasses.replace(self, **kw)


def exact_pos(scene: Scene):
    """The view center as exact rationals: the decimal strings when given,
    else the f64 values."""
    if scene.pos_str is not None:
        return (Fraction(scene.pos_str[0]), Fraction(scene.pos_str[1]))
    return (Fraction(float(scene.pos[0])), Fraction(float(scene.pos[1])))


def scene_defaults(algo: str) -> Scene:
    """``Config::new(algo)`` (calc/src/lib.rs:39-69) with the reference's
    stored (post-swap) colors."""
    algo = normalize_algo(algo)
    if algo == "fern":
        return Scene(
            algo=algo,
            iterations=10_000_000,
            primary_color=RGB(4, 3, 100),
            secondary_color=RGB(240, 240, 240),
        )
    return Scene(
        algo=algo,
        iterations=50,
        primary_color=RGB(40, 255, 40),
        secondary_color=RGB(240, 0, 170),
    )
