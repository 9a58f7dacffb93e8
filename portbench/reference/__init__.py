"""The benchmark's plain reference: what an escape-time frame should be.

Plain PyTorch and Python integers, written from the frame's description (a
dict of scene fields, ``portbench.generator``) and from the semantics the
renderer documents, not from its code: it imports nothing of the program.

    counts(frame, device)      -> (cnt, dist) of every pixel
    image(frame, cnt, dist)    -> the (H, W, 3) uint8 frame

Count semantics (the reference renderer's, calc/src/lib.rs:245-257): z
starts at the pixel's c; step i computes z' = z^2 + c and, if |z'|^2 >
limit^2, the pixel escapes with count i and final |z'|^2; a pixel that never
escapes has count = iterations and the |z|^2 of its last step.

The counts come from perturbation around an exact orbit of the view's
centre, rebased so no pixel is glitched (``perturb``), at every depth.
"""

from __future__ import annotations

from portbench.reference import coloring, perturb


def counts(frame, device, delta_dtype=None):
    """(cnt int32, dist float64) tensors of shape (H, W) on ``device``;
    ``delta_dtype`` rounds the δ-orbits (a control)."""
    if frame.get("algo", "mandelbrot") != "mandelbrot" or frame.get("power", 2) != 2:
        raise ValueError("the reference computes the quadratic mandelbrot only")
    if frame.get("supersample", 1) != 1:
        raise ValueError("the reference computes supersample 1 only")
    return perturb.counts(frame, device, delta_dtype)


def image(frame, cnt, dist):
    return coloring.image(frame, cnt, dist)


__all__ = ["counts", "image"]
