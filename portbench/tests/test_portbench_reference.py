"""The reference against the program's CPU render and against mpmath, and
the controls against the reference, at sizes a CPU holds."""

from __future__ import annotations

import json

import pytest
import torch

from portbench import compare, reference
from portbench.control import readings
from portbench.harness import ROOT, Cell, scene_of
from portbench.reference import perturb as ref_perturb
from portbench.reference.viewport import affine
from portbench.witness import mpmath_count


def scene(config, **kw):
    return dict(json.loads((ROOT / "portbench/configs" / f"{config}.json").read_text())["scene"],
                **kw)


def port_image(frame):
    from fractal_tpu_torch.render import render

    return torch.from_numpy(render(scene_of(frame), "cpu"))


@pytest.mark.parametrize("precision,tol", [
    ("ds32", 0.5),   # kernel A's plain double-single loop
    ("f64", 0.5),    # the plain f64 grid, its c rounded in another order
    ("p32", 2.0),    # f32 δ-orbits, no glitch resolve (the CPU's f32 BLA route)
])
def test_reference_agrees_with_the_program_at_a_shallow_view(precision, tol):
    frame = scene("mandel_1e6x", width=64, height=48, iterations=600, precision=precision)
    cnt, dist = reference.counts(frame, "cpu")
    got = compare.numbers(port_image(frame), reference.image(frame, cnt, dist), cnt, frame)
    assert got["bad_px_pct"] <= tol and got["mean_abs_levels"] <= tol, got


def test_reference_counts_agree_with_60_digit_mpmath_at_the_cells_spacing():
    # a 64-row crop with a 3000-row frame's pixel at 1e6x: a plain float64
    # loop is off at ~4 % of such pixels
    frame = scene("mandel_1e6x", width=64, height=64, scale=[1e6 * 3000 / 64] * 2)
    cnt, _ = reference.counts(frame, "cpu")
    (ar, cr), (ai, ci) = affine(frame)
    pixels = [(x, y) for y in (3, 29, 60) for x in (5, 22, 41, 63)]
    off = [abs(int(cnt[y, x]) - mpmath_count(ar * x + cr, ai * y + ci, 4000, 65536.0))
           for x, y in pixels]
    assert off == [0] * len(off)


def test_the_bfloat16_control_keeps_the_orbit_and_rounds_the_deltas():
    frame = scene("mandel_1e6x", width=24, height=16, iterations=300)
    c64, _ = ref_perturb.counts(frame, "cpu")
    c16, _ = ref_perturb.counts(frame, "cpu", torch.bfloat16)
    assert 0 < float((c64 != c16).double().mean()) < 1


def test_deep_reference_counts_agree_with_60_digit_mpmath():
    frame = scene("seahorse_1e15", width=24, height=14, iterations=10000)
    cnt, _ = reference.counts(frame, "cpu")
    (ar, cr), (ai, ci) = affine(frame)
    pixels = [(x, y) for y in (0, 5, 13) for x in (0, 7, 16, 23)]
    off = [abs(int(cnt[y, x]) - mpmath_count(ar * x + cr, ai * y + ci, 10000, 65536.0))
           for x, y in pixels]
    assert sum(d == 0 for d in off) >= len(off) - 1 and max(off) <= 30, off


@pytest.mark.parametrize("cell_name", ["mandel_1e6x.exact", "mandel_1e6x.p32"])
def test_the_control_fails_the_check(tiny_root, cell_name):
    # a 300-row crop with a 3000-row frame's pixel at 1e6x and its budget
    path = tiny_root / "portbench/configs/mandel_1e6x.json"
    cfg = json.loads(path.read_text())
    cfg["scene"].update(width=300, height=300, iterations=4000, scale=[1e6 * 3000 / 300] * 2)
    path.write_text(json.dumps(cfg))
    got = readings(Cell(cell_name, tiny_root), 2**31 + 5, 1, "cpu")
    assert got["fails"], got


def test_the_control_fails_at_the_cells_own_size_on_the_card(cuda_card):
    got = readings(Cell("mandel_1e6x.exact", ROOT), 7, 1, cuda_card)
    assert got["fails"], got
