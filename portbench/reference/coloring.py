"""Count and final |z|^2 -> the u8 pixel, the reference renderer's tail.

calc/src/lib.rs:214-234 and color_multiply (calc:133-139): a pixel whose
final |z|^2 exceeds ``stable_limit`` is colored primary · mult, mult =
(count + 1 - log2(log2(sqrt(|z|^2)) / 2)) / iterations · exposure (the
smooth term only when ``smooth``); any other pixel is secondary · |z|^2
when ``inside``, else black.  A color's stored (r, g, b) is emitted as
(r, b, g) (the reference's swapped constructor, calc:129, undone at render
time).  float -> u8 as Rust's ``as``: NaN -> 0, truncate, saturate.
Computed in float64.
"""

from __future__ import annotations

import torch


def image(frame, cnt, dist):
    dist = dist.to(torch.float64)
    dev = dist.device

    def rbg(c):
        return torch.tensor([c[0], c[2], c[1]], dtype=torch.float64, device=dev)

    escaped = dist > float(frame["stable_limit"])
    iters = cnt.to(torch.float64)
    if frame["smooth"]:
        iters = iters + (1.0 - torch.log2(torch.log2(torch.sqrt(dist)) / 2.0))
    mult = iters / float(frame["iterations"]) * float(frame["exposure"])
    out = rbg(frame["primary_color"]) * mult[..., None]
    if frame["inside"]:
        other = rbg(frame["secondary_color"]) * dist[..., None]
    else:
        other = torch.zeros_like(out)
    img = torch.where(escaped[..., None], out, other)
    img = torch.nan_to_num(img, nan=0.0, posinf=255.0, neginf=0.0)
    return torch.clamp(torch.trunc(img), 0.0, 255.0).to(torch.uint8)
