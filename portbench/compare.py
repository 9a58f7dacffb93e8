"""The check: the frames the window produced against the reference.

Each kept frame is rendered again by ``portbench.reference`` from its own
description, at its own size, and the two u8 images are compared pixel by
pixel.  A pixel's distance is the largest of its channels' differences, in
levels of 255:

  * where the reference's pixel escapes, from the reference's color;
  * where it does not escape within the budget, from the nearer of the two
    colors such a pixel can take: the inside color (black, or secondary ·
    |z|^2 with |z|^2 <= stable_limit when ``inside``), or primary · mult with
    the count at the budget, mult within (iterations - 2 .. iterations + 3)
    / iterations · exposure (the smooth term of a final |z|^2 in
    (stable_limit, limit^2]).  Which of the two it takes hangs on the last
    iterate of an orbit that has not escaped, which no tier promises: a
    δ-orbit, a double-single word or Brent's test each leave it elsewhere.

Three numbers, the worst over the kept frames; a cell's check compares
those its ``limits`` name:

  * ``bad_px_pct``: the share of pixels, in %, farther than ``TOL`` levels.
    The smooth coloring moves a channel by well under a level an iteration,
    so rounding in the coloring and an escape a few steps early or late stay
    within it; a wrong count, a pixel wrongly inside or outside, or a wrong
    color does not.
  * ``mean_abs_levels``: the mean of every channel's distance.
  * ``clustered_bad_pct``: the share of pixels, in %, that are bad and have
    at least ``CLUSTER`` bad pixels among their 8 neighbours: a wrong region
    (an unresolved glitch, a band of δ-orbits gone wrong, rows left out, a
    frame of another view) rather than the isolated pixels on chaotic orbits
    whose counts no 64-bit iteration gets right at 1e6x.

A frame that is missing or of another shape reads 100 %, 255 and 100 %.
"""

from __future__ import annotations

import torch

from portbench import reference

TOL = 2
CLUSTER = 4
#: What a missing frame, or one of another shape, reads.
WORST = {"bad_px_pct": 100.0, "mean_abs_levels": 255.0, "clustered_bad_pct": 100.0}


def _band(frame, device, lo_mult: float, hi_mult: float, color: str):
    c = frame[color]
    rbg = torch.tensor([c[0], c[2], c[1]], dtype=torch.float64, device=device)
    return (torch.clamp(torch.trunc(rbg * lo_mult), 0, 255),
            torch.clamp(torch.trunc(rbg * hi_mult), 0, 255))


def distance(img, ref, cnt, frame):
    """(H, W, 3) float64: each channel's distance from what the reference
    allows at that pixel."""
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


def numbers(img, ref, cnt, frame) -> dict:
    img = torch.as_tensor(img)
    if img.shape != ref.shape:
        return dict(WORST)
    d = distance(img, ref, cnt, frame)
    bad = (d.amax(dim=-1) > TOL).to(torch.float32)
    around = torch.nn.functional.conv2d(torch.nn.functional.pad(bad[None, None], (1, 1, 1, 1)),
                                        torch.ones(1, 1, 3, 3, device=bad.device))[0, 0] - bad
    return {"bad_px_pct": 100.0 * float(bad.double().mean()),
            "mean_abs_levels": float(d.mean()),
            "clustered_bad_pct": 100.0 * float(((bad > 0) & (around >= CLUSTER)).double().mean())}


def _view(frame) -> tuple:
    return tuple(tuple(v) if isinstance(v, list) else v for v in
                 (frame[k] for k in ("algo", "width", "height", "iterations", "limit",
                                     "pos_str", "scale")))


def check(items, device="cuda") -> dict:
    """``items``: (frame dict, program image).  Returns the worst of each
    number over them.  The reference's counts of the last view are kept for
    the next frame of the same view (a re-colored one)."""
    worst = dict(WORST) if not items else {k: 0.0 for k in WORST}
    last = (None, None)
    for frame, img in items:
        if last[0] != _view(frame):
            last = (_view(frame), reference.counts(frame, device))
        cnt, dist = last[1]
        got = numbers(img, reference.image(frame, cnt, dist), cnt, frame)
        for k in worst:
            worst[k] = max(worst[k], got[k])
    return worst
