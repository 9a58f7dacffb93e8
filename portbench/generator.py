"""The traffic generator: a list of frames from a mix's parameters and a seed.

A frame is a dict of scene fields (a configuration's ``scene``, then the
mix's ``scene`` overrides, then what the mix draws for it); the harness
turns it into the program's ``Scene`` and the reference reads it as it is.
Positions are exact rationals written as ``pos_str`` strings, as the viewer
forms them.  One client asks for one frame at a time, so a mix fixes what
each frame shows, not when it is sent.

A mix is a JSON file, ``portbench/traffic/<name>.json``:

    scene      scene fields every frame takes (say, a precision)
    warmup     frames rendered in set-up, drawn first from the same stream
    max_fps    frames generated a second of window (an upper bound)
    centre     {"kind": "fixed"}
               {"kind": "box", "half_width": hw, "half_height": hh,
                "strata": k}: uniform within ±hw view widths and ±hh view
                heights of the configuration's centre, stratified: the box
                is cut into k × k cells and every k² frames visit each cell
                once, in an order drawn anew each round
               {"kind": "arrow_walk", "step": s, "dt": dt, "hold": [a, b],
                "reflect": r}: the viewer's arrow keys, s·dt / scale a frame
                on one or both axes, one of the 8 directions held for a
                drawn a..b frames, each axis turned back where it would
                leave ±r view heights of the centre
    exposure   {"log_uniform": [lo, hi]}, or absent: the configuration's
    colors     {"uniform_rgb": [field, ...]}: each named color drawn
               uniform over RGB, or absent
    draw       {field: {"integers": [lo, hi]}, ...}: each named scene field
               drawn anew for every frame, an integer lo <= x < hi (a
               fern's ``seed``), after the frame's draws above; or absent,
               which takes no random number
"""

from __future__ import annotations

import json
import math
from fractions import Fraction
from pathlib import Path

import numpy as np

DIRECTIONS = [(dx, dy) for dx in (-1, 0, 1) for dy in (-1, 0, 1) if (dx, dy) != (0, 0)]


def rng(seed: int, stream: int = 0) -> np.random.Generator:
    """A generator for ``seed`` (any integer) and a stream number."""
    return np.random.default_rng([seed % 2**64, stream])


def load(path) -> dict:
    with open(path) as f:
        return json.load(f)


def _centres(spec: dict, base: dict, r: np.random.Generator, n: int):
    c = tuple(Fraction(str(v)) for v in base["pos_str"])
    view_w = Fraction(base["width"], base["height"]) / Fraction(float(base["scale"][0]))
    view_h = 1 / Fraction(float(base["scale"][1]))
    kind = spec["kind"]
    if kind == "fixed":
        return [c] * n
    if kind == "box":
        k = int(spec.get("strata", 1))
        out, order = [], []
        for _ in range(n):
            if not order:
                order = list(r.permutation(k * k))
            cell = int(order.pop())
            u = (cell % k + r.random()) / k - 0.5   # in [-1/2, 1/2)
            v = (cell // k + r.random()) / k - 0.5
            out.append((c[0] + Fraction(2 * u) * Fraction(spec["half_width"]) * view_w,
                        c[1] + Fraction(2 * v) * Fraction(spec["half_height"]) * view_h))
        return out
    if kind == "arrow_walk":
        lo, hi = spec["hold"]
        steps = [Fraction(float(spec["step"] * spec["dt"])) / Fraction(float(s))
                 for s in base["scale"]]
        bound = Fraction(spec["reflect"]) * view_h
        pos, out, held, d = list(c), [], 0, (0, 0)
        for _ in range(n):
            out.append(tuple(pos))
            if held == 0:
                d = DIRECTIONS[int(r.integers(len(DIRECTIONS)))]
                held = int(r.integers(lo, hi + 1))
            held -= 1
            d = tuple(-s if abs(p + s * st - o) > bound else s
                      for p, s, st, o in zip(pos, d, steps, c))
            pos = [p + s * st for p, s, st in zip(pos, d, steps)]
        return out
    raise ValueError(f"unknown centre kind {kind!r}")


def _draw(spec: dict, r: np.random.Generator):
    if set(spec) == {"integers"}:
        lo, hi = spec["integers"]
        return int(r.integers(lo, hi))
    raise ValueError(f"unknown draw {spec!r}")


def frames(scene: dict, mix: dict, seed: int, n: int) -> list:
    """``mix["warmup"]`` + ``n`` frames of ``scene`` under ``mix``."""
    base = {**scene, **mix.get("scene", {})}
    total = int(mix.get("warmup", 1)) + n
    r = rng(seed)
    centres = _centres(mix["centre"], base, r, total)
    out = []
    for pos in centres:
        f = dict(base, pos_str=[str(pos[0]), str(pos[1])])
        if "exposure" in mix:
            lo, hi = mix["exposure"]["log_uniform"]
            f["exposure"] = float(math.exp(r.uniform(math.log(lo), math.log(hi))))
        for field in mix.get("colors", {}).get("uniform_rgb", []):
            f[field] = [int(x) for x in r.integers(0, 256, size=3)]
        for field, spec in mix.get("draw", {}).items():
            f[field] = _draw(spec, r)
        out.append(f)
    return out


def frame_count(mix: dict, seconds: float) -> int:
    return int(math.ceil(mix["max_fps"] * seconds)) + 1


def mix_path(root: Path, name: str) -> Path:
    return Path(root) / "portbench" / "traffic" / f"{name}.json"
