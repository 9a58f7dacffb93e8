"""The traffic generator: frames from a mix's parameters and a seed."""

from __future__ import annotations

from fractions import Fraction

import pytest

from portbench import generator
from portbench.harness import ROOT, load_json

SEEDS = (0, 7, 2**31 + 12345, 2**40 + 3)
#: (configuration, mix) pairs: the cells' and those kept for later cells
PAIRS = [("mandel_1e6x", "stills_around"), ("mandel_1e6x", "stills_around_p32"),
         ("seahorse_1e15", "recolor"), ("seahorse_1e15", "pan_walk")]


def frames(config, mix, seed, n=130):
    """(the configuration's scene, the frames) of a pair, found by name."""
    scene = load_json(ROOT / "portbench" / "configs" / f"{config}.json")["scene"]
    return scene, generator.frames(scene, generator.load(generator.mix_path(ROOT, mix)),
                                   seed, n)


@pytest.mark.parametrize("config,mix", PAIRS)
def test_same_seed_same_frames_other_seed_other_frames(config, mix):
    for seed in SEEDS:
        assert frames(config, mix, seed)[1] == frames(config, mix, seed)[1]
    assert frames(config, mix, SEEDS[2])[1] != frames(config, mix, SEEDS[2] + 1)[1]


def test_stills_stay_in_the_box_and_visit_every_stratum_each_round():
    s, fs = frames("mandel_1e6x", "stills_around", SEEDS[2], 64 * 3 - 1)
    c = [Fraction(v) for v in s["pos_str"]]
    w = Fraction(s["width"], s["height"]) / Fraction(s["scale"][0])
    h = 1 / Fraction(s["scale"][1])
    cells = []
    for f in fs:
        u = (Fraction(f["pos_str"][0]) - c[0]) / w + Fraction(1, 2)
        v = (Fraction(f["pos_str"][1]) - c[1]) / h + Fraction(1, 2)
        assert 0 <= u < 1 and 0 <= v < 1
        cells.append(int(v * 8) * 8 + int(u * 8))
        assert f["precision"] == "auto"
    for r in range(3):
        assert sorted(cells[64 * r:64 * (r + 1)]) == list(range(64))


def test_p32_mix_takes_the_same_views_in_the_p32_tier():
    _, a = frames("mandel_1e6x", "stills_around", 99)
    _, b = frames("mandel_1e6x", "stills_around_p32", 99)
    assert [f["pos_str"] for f in a] == [f["pos_str"] for f in b]
    assert {f["precision"] for f in b} == {"p32"}


def test_pan_walks_by_the_arrow_step_within_a_view_height():
    s, fs = frames("seahorse_1e15", "pan_walk", SEEDS[3], 3000)
    c = [Fraction(v) for v in s["pos_str"]]
    step = Fraction(0.5 * (1 / 60)) / Fraction(s["scale"][0])
    bound = 1 / Fraction(s["scale"][1])
    pos = [[Fraction(v) for v in f["pos_str"]] for f in fs]
    assert pos[0] == c
    for p, q in zip(pos, pos[1:]):
        d = [(b - a) / step for a, b in zip(p, q)]
        assert all(x in (-1, 0, 1) for x in d) and d != [0, 0]
    assert max(abs(p[k] - c[k]) for p in pos for k in (0, 1)) <= bound + step
    # the walk reaches the box's edge in 3000 frames
    assert max(abs(p[k] - c[k]) for p in pos for k in (0, 1)) > bound / 2


def test_recolor_keeps_the_view_and_draws_exposure_and_colors():
    s, fs = frames("seahorse_1e15", "recolor", SEEDS[1], 500)
    centre = tuple(Fraction(v) for v in s["pos_str"])
    assert {tuple(Fraction(v) for v in f["pos_str"]) for f in fs} == {centre}
    e = [f["exposure"] for f in fs]
    assert 1.0 <= min(e) < 1.3 and 8.0 < max(e) <= 10.0
    colors = [c for f in fs for c in f["primary_color"] + f["secondary_color"]]
    assert min(colors) >= 0 and max(colors) <= 255 and len(set(colors)) > 200
