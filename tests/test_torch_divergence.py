"""The warp-efficiency helper against a loop over warps, the per-pixel
steps it reads from kernel B's outputs, and the ptxas report parser that
prints each kernel's registers and spills."""

import numpy as np
import pytest
import torch

from fractal_tpu_torch.ops import _cuda_build
from fractal_tpu_torch.utils import divergence


def _brute(steps, tw, th):
    h, w = steps.shape
    total, issued = 0, 0
    for y0 in range(0, h, th):
        for x0 in range(0, w, tw):
            tile = steps[y0:y0 + th, x0:x0 + tw]
            total += int(tile.sum())
            issued += 32 * int(tile.max())
    return total / issued


@pytest.mark.parametrize("tile", divergence.TILES, ids=lambda t: f"{t[0]}x{t[1]}")
@pytest.mark.parametrize("shape", [(37, 45), (3, 100), (9, 7)])
def test_warp_efficiency_matches_a_loop_over_warps(tile, shape):
    """A seeded count grid whose width and height are not multiples of the
    tile: the partial warps at the right and bottom edges count 32 lanes."""
    rng = np.random.default_rng(sum(shape) + tile[0])
    steps = rng.integers(0, 4000, shape)
    steps[rng.random(shape) < 0.2] = 4000  # interior pixels run the budget
    got = divergence.warp_efficiency(torch.from_numpy(steps), tile)
    assert got == pytest.approx(_brute(steps, *tile), rel=1e-12)
    assert 0 < got < 1


def test_warp_efficiency_bounds():
    flat = torch.full((8, 64), 7)
    assert divergence.warp_efficiency(flat, (32, 1)) == 1.0
    # one slow pixel a warp: 32 lanes pay its steps
    one = torch.zeros((1, 32), dtype=torch.int64)
    one[0, 5] = 10
    assert divergence.warp_efficiency(one, (32, 1)) == pytest.approx(1 / 32)
    # columns that differ favour the tall tile, rows that differ the wide one
    cols = torch.arange(32).repeat(4, 1)
    assert divergence.warp_efficiency(cols, (8, 4)) > divergence.warp_efficiency(cols, (32, 1))
    rows = torch.arange(8)[:, None].repeat(1, 64)
    assert divergence.warp_efficiency(rows, (32, 1)) == 1.0 > \
        divergence.warp_efficiency(rows, (8, 4))
    with pytest.raises(ValueError, match="32 pixels"):
        divergence.warp_efficiency(flat, (8, 8))


def test_pixel_steps_counts_the_terminal_step():
    """A pixel that escaped or glitched ran its count past n0 plus one step;
    one that ran the orbit out ran exactly its count past n0."""
    limit = 2.0
    zr = torch.tensor([3.0, 0.1, 0.1, 0.1])
    zi = torch.zeros(4)
    cnt = torch.tensor([12, 20, 15, 3], dtype=torch.int32)
    gl = torch.tensor([0, 1, 1, 0], dtype=torch.int32)  # ran out, glitched
    got = divergence.pixel_steps(zr, zi, cnt, gl, 5, 20, limit)
    assert got.tolist() == [8, 15, 11, 0]


def test_kernel_resources_parses_the_ptxas_report():
    log = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z3fooPf' for 'sm_90a'
ptxas info    : Function properties for _Z3fooPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 380 bytes cmem[0]
ptxas info    : Compiling entry function '_Z3barv' for 'sm_90a'
ptxas info    : Function properties for _Z3barv
    8 bytes stack frame, 12 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 255 registers, used 0 barriers, 380 bytes cmem[0]
"""
    rows = _cuda_build.kernel_resources(log)
    assert [r[1:] for r in rows] == [(40, 0), (255, 12)]
    assert rows[0][0] in ("_Z3fooPf", "foo(float*)")
    assert _cuda_build.kernel_resources("") == []
