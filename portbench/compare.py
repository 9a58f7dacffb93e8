"""The check: the frames the window produced against the plain reference.

A frame's reference is found by the frame's ``algo``: the module
``<root>/portbench/reference/<algo>.py``, loaded from its path as the
metric readers are.  A cell of another algo brings its reference as that
new file; it gives

    key(frame)                        every field its image depends on:
                                      frames of one key share one state
    state(frame, device, **options)   the costly part (the Mandelbrot's
                                      counts)
    image(frame, state)               the (H, W, 3) uint8 frame
    distance(img, ref, state, frame)  optional: (H, W, 3) float64, each
                                      channel's distance from what the
                                      reference allows there; without it
                                      the plain |img - ref|

Each kept frame is rendered again by its reference from its own
description, at its own size, and the two u8 images are compared pixel by
pixel.  A pixel's distance is the largest of its channels' distances, in
levels of 255.  Three numbers, the worst over the kept frames; a cell's
check compares those its ``limits`` name:

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

from portbench import byname

TOL = 2
CLUSTER = 4
#: What a missing frame, or one of another shape, reads.
WORST = {"bad_px_pct": 100.0, "mean_abs_levels": 255.0, "clustered_bad_pct": 100.0}


def plain_distance(img, ref, state, frame):
    """(H, W, 3) float64: each channel's |img - ref|."""
    return (img.to(ref.device, torch.float64) - ref.to(torch.float64)).abs()


def numbers(img, ref, frame, state=None, distance=plain_distance) -> dict:
    img = torch.as_tensor(img)
    if img.shape != ref.shape:
        return dict(WORST)
    d = distance(img, ref, state, frame)
    bad = (d.amax(dim=-1) > TOL).to(torch.float32)
    around = torch.nn.functional.conv2d(torch.nn.functional.pad(bad[None, None], (1, 1, 1, 1)),
                                        torch.ones(1, 1, 3, 3, device=bad.device))[0, 0] - bad
    return {"bad_px_pct": 100.0 * float(bad.double().mean()),
            "mean_abs_levels": float(d.mean()),
            "clustered_bad_pct": 100.0 * float(((bad > 0) & (around >= CLUSTER)).double().mean())}


def check(items, device="cuda", root=byname.ROOT) -> dict:
    """``items``: (frame dict, program image).  Returns the worst of each
    number over them.  The reference's state of the last frame is kept for
    the next frame of the same algo and key (a re-colored one)."""
    worst = dict(WORST) if not items else {k: 0.0 for k in WORST}
    refs, last = {}, (None, None)
    for frame, img in items:
        algo = frame.get("algo", "mandelbrot")
        if algo not in refs:
            refs[algo] = byname.module(root, "reference", algo)
        ref = refs[algo]
        key = (algo, ref.key(frame))
        if last[0] != key:
            last = (key, ref.state(frame, device))
        state = last[1]
        got = numbers(img, ref.image(frame, state), frame, state,
                      getattr(ref, "distance", plain_distance))
        for k in worst:
            worst[k] = max(worst[k], got[k])
    return worst
