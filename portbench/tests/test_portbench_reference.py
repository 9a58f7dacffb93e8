"""The reference against the program's CPU render and against mpmath, and
the controls against the reference, at sizes a CPU holds."""

from __future__ import annotations

import json

import pytest
import torch

from portbench import compare, generator, reference
from portbench.control import readings
from portbench.harness import ROOT, Cell, scene_of
from portbench.reference import mandelbrot
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
    got = compare.numbers(port_image(frame), reference.image(frame, cnt, dist), frame,
                          (cnt, dist), mandelbrot.distance)
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


def crop_300(root):
    """Cut ``root``'s mandel_1e6x to a 300-row crop with a 3000-row frame's
    pixel at 1e6x and its budget."""
    path = root / "portbench/configs/mandel_1e6x.json"
    cfg = json.loads(path.read_text())
    cfg["scene"].update(width=300, height=300, iterations=4000, scale=[1e6 * 3000 / 300] * 2)
    path.write_text(json.dumps(cfg))


def test_the_check_by_the_frames_algo_reads_what_the_mandelbrot_path_read(tiny_root):
    # two stills and a re-colored copy of the first (its counts reused),
    # each image the reference's with every channel moved by -4..4 levels
    crop_300(tiny_root)
    cell = Cell("mandel_1e6x.exact", tiny_root)
    a, b = generator.frames(cell.config["scene"], cell.mix, 2**31 + 9, 2)[1:]
    frames = [a, dict(a, exposure=2.5, primary_color=[200, 30, 90]), b]
    gen = torch.Generator().manual_seed(3)
    want, items, counts = {k: 0.0 for k in compare.WORST}, [], {}
    for f in frames:
        view = mandelbrot.key(f)
        if view not in counts:
            counts[view] = reference.counts(f, "cpu")
        cnt, dist = counts[view]
        ref = reference.image(f, cnt, dist)
        noise = torch.randint(-4, 5, ref.shape, generator=gen)
        img = (ref.to(torch.int32) + noise).clamp(0, 255).to(torch.uint8)
        items.append((f, img))
        got = compare.numbers(img, ref, f, (cnt, dist), mandelbrot.distance)
        want = {k: max(want[k], got[k]) for k in want}
    assert 0 < want["bad_px_pct"] < 100
    assert compare.check(items, "cpu", root=tiny_root) == want


def test_a_frame_of_an_algo_without_a_reference_names_the_missing_file(tiny_root):
    frame = dict(json.loads((ROOT / "portbench/configs/mandel_1e6x.json").read_text())["scene"],
                 algo="julia")
    with pytest.raises(FileNotFoundError, match=r"portbench/reference/julia\.py"):
        compare.check([(frame, torch.zeros(1, 1, 3, dtype=torch.uint8))], "cpu",
                      root=tiny_root)


@pytest.mark.parametrize("cell_name", ["mandel_1e6x.exact", "mandel_1e6x.p32"])
def test_the_control_fails_the_check(tiny_root, cell_name):
    crop_300(tiny_root)
    got = readings(Cell(cell_name, tiny_root), 2**31 + 5, 1, "cpu")
    assert got["fails"], got


def test_the_control_fails_at_the_cells_own_size_on_the_card(cuda_card):
    got = readings(Cell("mandel_1e6x.exact", ROOT), 7, 1, cuda_card)
    assert got["fails"], got
