"""The check's reference of a Mandelbrot frame (``portbench.compare`` finds
it by the frame's ``algo``): the quadratic mandelbrot at supersample 1,
its counts by perturbation around an exact orbit (``reference.counts``) and
the documented coloring (``reference.image``).

A pixel's distance is the largest of its channels' differences, in levels
of 255:

  * where the reference's pixel escapes, from the reference's color;
  * where it does not escape within the budget, from the nearer of the two
    colors such a pixel can take: the inside color (black, or secondary ·
    |z|^2 with |z|^2 <= stable_limit when ``inside``), or primary · mult with
    the count at the budget, mult within (iterations - 2 .. iterations + 3)
    / iterations · exposure (the smooth term of a final |z|^2 in
    (stable_limit, limit^2]).  Which of the two it takes hangs on the last
    iterate of an orbit that has not escaped, which no tier promises: a
    δ-orbit, a double-single word or Brent's test each leave it elsewhere.
"""

from __future__ import annotations

import torch

from portbench import reference


def key(frame) -> tuple:
    """The fields the counts depend on: frames that differ only in their
    colors or exposure share them."""
    return tuple(tuple(v) if isinstance(v, list) else v for v in
                 (frame[k] for k in ("algo", "width", "height", "iterations", "limit",
                                     "pos_str", "scale")))


def state(frame, device, delta_dtype=None):
    """(cnt, dist) of every pixel; ``delta_dtype``, a torch dtype's name
    such as "bfloat16", rounds the δ-orbits to it (a control)."""
    return reference.counts(frame, device, getattr(torch, delta_dtype) if delta_dtype else None)


def image(frame, state):
    cnt, dist = state
    return reference.image(frame, cnt, dist)


def _band(frame, device, lo_mult: float, hi_mult: float, color: str):
    c = frame[color]
    rbg = torch.tensor([c[0], c[2], c[1]], dtype=torch.float64, device=device)
    return (torch.clamp(torch.trunc(rbg * lo_mult), 0, 255),
            torch.clamp(torch.trunc(rbg * hi_mult), 0, 255))


def distance(img, ref, state, frame):
    """(H, W, 3) float64: each channel's distance from what the reference
    allows at that pixel."""
    cnt = state[0]
    p = img.to(ref.device, torch.float64)
    d = (p - ref.to(torch.float64)).abs()
    inside = cnt >= frame["iterations"]
    if not bool(inside.any()):
        return d
    it, exp = float(frame["iterations"]), float(frame["exposure"])
    lo, hi = _band(frame, ref.device, (it - 2) / it * exp, (it + 3) / it * exp, "primary_color")
    d_out = torch.clamp(torch.maximum(lo - p, p - hi), min=0)
    if frame["inside"]:
        lo_in, hi_in = _band(frame, ref.device, 0.0, float(frame["stable_limit"]),
                             "secondary_color")
        d_in = torch.clamp(torch.maximum(lo_in - p, p - hi_in), min=0)
    else:
        d_in = p
    alt = torch.where((d_in.amax(-1) <= d_out.amax(-1))[..., None], d_in, d_out)
    return torch.where(inside[..., None], alt, d)
