"""The traffic generator: frames from a mix's parameters and a seed."""

from __future__ import annotations

import hashlib
import json
from fractions import Fraction

import pytest

from portbench import generator
from portbench.harness import ROOT, load_json

SEEDS = (0, 7, 2**31 + 12345, 2**40 + 3)
#: (configuration, mix) pairs: the cells' and those kept for later cells
PAIRS = [("mandel_1e6x", "stills_around"), ("mandel_1e6x", "stills_around_p32"),
         ("seahorse_1e15", "recolor"), ("seahorse_1e15", "pan_walk")]


#: sha256 of each pair's 130 frames (``json.dumps(frames, sort_keys=True)``)
#: at seeds 7 and 2**31 + 12345, taken before the mixes could draw scene
#: fields: a mix without ``draw`` makes the same frames as then.
DIGESTS = {
    "stills_around": ("ad17e1ce14ae16005edb798b047346f6f5a61b3aaf0379495330cc91c0ab07a1",
                      "18dcda9d05f5346ff7959086b866633f1fe59b1c2a8aa98798f1f0819509726a"),
    "stills_around_p32": ("8c0ef459c9b0aa29792a56ffca500243d6f6a076e4cba69510ba9706c9da7d90",
                          "09671841d09d88b8d24e3b2055d04d0fbcb68f450261c3d1a4deee8f0fa95e95"),
    "recolor": ("7ecbd8c0406c2a143e15985784f2fa3235e4f69b3be3b0f0aaf874dd5ea6be96",
                "5fd01a927295df2820809da835750aa6603cfa03d8de8af98b2d750030d09ae4"),
    "pan_walk": ("20538eb2b4bee897b568c15f1bd35b3c7ac3700da014f16af99fa5e71ad0c0da",
                 "44f1e70e51739acf20e1c7d0f6dd220a942341c98ff521688741dbf362f1939a"),
}


def frames(config, mix, seed, n=130, **extra):
    """(the configuration's scene, the frames) of a pair, found by name;
    ``extra`` keys added to the mix."""
    scene = load_json(ROOT / "portbench" / "configs" / f"{config}.json")["scene"]
    spec = dict(generator.load(generator.mix_path(ROOT, mix)), **extra)
    return scene, generator.frames(scene, spec, seed, n)


@pytest.mark.parametrize("config,mix", PAIRS)
def test_same_seed_same_frames_other_seed_other_frames(config, mix):
    for seed in SEEDS:
        assert frames(config, mix, seed)[1] == frames(config, mix, seed)[1]
    assert frames(config, mix, SEEDS[2])[1] != frames(config, mix, SEEDS[2] + 1)[1]


@pytest.mark.parametrize("config,mix", PAIRS)
def test_the_mixes_make_the_frames_they_made_before_draws_existed(config, mix):
    got = tuple(hashlib.sha256(json.dumps(frames(config, mix, seed)[1], sort_keys=True)
                               .encode()).hexdigest() for seed in (7, 2**31 + 12345))
    assert got == DIGESTS[mix]


@pytest.mark.parametrize("config,mix", PAIRS)
def test_a_drawn_field_changes_nothing_else_of_a_mix_without_other_draws(config, mix):
    draw = {"seed": {"integers": [0, 2**31]}}
    per_frame = {"exposure", "colors"} & set(generator.load(generator.mix_path(ROOT, mix)))
    for seed in SEEDS:
        _, plain = frames(config, mix, seed, 300)
        _, drawn = frames(config, mix, seed, 300, draw=draw)
        seeds = [f.pop("seed") for f in drawn]
        assert all(isinstance(x, int) and 0 <= x < 2**31 for x in seeds)
        assert len(set(seeds)) == len(seeds)  # a new seed for every frame
        assert seeds == [f["seed"] for f in frames(config, mix, seed, 300, draw=draw)[1]]
        for a, b in zip(plain, drawn):
            assert a["pos_str"] == b["pos_str"]  # the centres come first
            if not per_frame:
                assert a == b
    with pytest.raises(ValueError, match="unknown draw"):
        frames(config, mix, 1, 2, draw={"seed": {"normal": [0, 1]}})


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
