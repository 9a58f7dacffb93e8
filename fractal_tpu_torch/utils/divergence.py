"""Warp efficiency of a per-pixel loop, from the steps each pixel ran.

A warp of 32 threads issues until its slowest lane is done, so a launch
pays 32 · (the warp's most steps) lane-steps for each warp.  Its warp
efficiency is Σ pixel-steps / Σ over warps of 32 · max steps.  The grid
kernels map a warp onto a tile of the image: ``(32, 1)`` is a row of 32
horizontally adjacent pixels (the 32×8 blocks of ``csrc/perturb.cu``),
``(8, 4)`` a compact 8 wide by 4 tall tile.  Tiles are aligned to the
image's origin; lanes past its right or bottom edge step nothing but count
as the warp's lanes.
"""

from __future__ import annotations

import torch

#: The two warp tilings compared, (width, height) in pixels.
TILES = ((32, 1), (8, 4))


def pixel_steps(zr, zi, cnt, gl, n0: int, n_steps: int, limit: float):
    """Loop steps each pixel of a full or glitch launch of kernels B, C or D
    ran, from its outputs: its count past n0, plus the escape or glitch step
    the epilogue took back out of the count."""
    esc = (zr.double() ** 2 + zi.double() ** 2 > limit ** 2) | ((gl != 0) & (cnt < n_steps))
    return (cnt.long() - n0).clamp(min=0) + esc.long()


def warp_efficiency(steps, tile=(32, 1)) -> float:
    """Σ steps / Σ_warps 32·max(steps in the warp) for a (height, width)
    grid of per-pixel steps and a warp tile (tw, th) with tw·th == 32."""
    tw, th = tile
    if tw * th != 32:
        raise ValueError(f"a warp tile holds 32 pixels, not {tw}x{th}")
    steps = torch.as_tensor(steps).to(torch.int64)
    h, w = steps.shape
    padded = torch.zeros((-(-h // th) * th, -(-w // tw) * tw), dtype=torch.int64,
                         device=steps.device)
    padded[:h, :w] = steps
    hh, ww = padded.shape
    most = padded.reshape(hh // th, th, ww // tw, tw).amax(dim=(1, 3))
    issued = int(most.sum()) * 32
    return int(steps.sum()) / issued if issued else 1.0
