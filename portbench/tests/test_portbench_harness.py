"""The harness on the CPU: cells, mixes, checks and metrics found by name;
the arithmetic of p95, the idle share and the pixel-steps; the import guard;
and a run's ``correct`` coming out false with the timed path broken."""

from __future__ import annotations

import json
import re

import numpy as np
import pytest
import torch

from portbench import compare, control, run, trace
from portbench.counts import roofline_pct
from portbench.harness import ROOT, Cell, p95, run_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


def test_benchmark_json_keeps_the_contracts_shape():
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"] and 1 <= b["run_seconds"] <= 51
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names)) and "setup_s" in names
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                      "higher")
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"] and len(m["layer"]) <= 200
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in b["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] == 1 and len(w["why"]) <= 200
    for c in b["configs"]:
        assert len(c["source"]) <= 200 and c["file"].startswith("portbench/")
        assert any(w["config"] == c["name"] for w in b["workloads"])


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_finds_its_files_by_name(name):
    cell = Cell(name, ROOT)
    assert cell.config["scene"]["width"] > 0 and "centre" in cell.mix
    assert cell.check["limits"] and set(cell.check["limits"]) <= set(compare.WORST)
    assert cell.check["control"]["kind"] in ("reference", "program")
    assert [m["name"] for m in cell.end_to_end()] == ["frames_per_s", "frame_ms_p95",
                                                       "setup_s"]
    for m in cell.per_layer():
        assert callable(cell.reader(m["name"]))


def add_cell(root, config_name, cell_name, scene, traffic="stills_around"):
    """A configuration and a cell that the harness has never seen, as a later
    change would add them: new files and new entries."""
    cfg = {"name": config_name, "scene": scene, "assumed": [], "reduced": [], "chips": 1}
    (root / "portbench" / "configs" / f"{config_name}.json").write_text(json.dumps(cfg))
    (root / "portbench" / "checks" / f"{cell_name}.json").write_text(json.dumps(
        {"sample_frames": 2, "limits": {"bad_px_pct": 1.0, "mean_abs_levels": 1.0},
         "control": {"kind": "reference", "options": {"delta_dtype": "bfloat16"}}}))
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"].append({"name": config_name, "source": "a test", "reduced": [],
                         "file": f"portbench/configs/{config_name}.json", "why": "a test"})
    b["workloads"].append({"name": cell_name, "config": config_name, "traffic": traffic,
                           "chips": 1, "why": "a test"})
    (root / "BENCHMARK.json").write_text(json.dumps(b))


def test_a_new_configuration_runs_without_an_edit_to_any_file(tiny_root):
    scene = dict(json.loads((tiny_root / "portbench/configs/mandel_1e6x.json").read_text())
                 ["scene"], width=40, height=24, iterations=200,
                 pos_str=["-0.743643135", "0.131825963"], scale=[1e5, 1e5])
    add_cell(tiny_root, "mandel_1e5x", "mandel_1e5x.exact", scene)
    r = run_cell(Cell("mandel_1e5x.exact", tiny_root), 5, 0.2, False, "cpu", log=lambda m: None)
    assert r["correct"] and r["attempted"] >= 1 and set(r["metrics"]) == {
        "frames_per_s", "frame_ms_p95", "setup_s"}


def test_a_new_per_layer_metric_is_read_by_its_own_file(tiny_root):
    (tiny_root / "portbench/metrics/frames_traced.py").write_text(
        "def read(rec):\n    return float(len(rec['frames']))\n")
    b = json.loads((tiny_root / "BENCHMARK.json").read_text())
    b["per_layer"].append({"name": "frames_traced", "unit": "frames", "better": "higher",
                           "source": "program_counter", "layer": "render driver",
                           "moves": "frames_per_s", "workloads": ["mandel_1e6x.exact"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(b))
    r = run_cell(Cell("mandel_1e6x.exact", tiny_root), 6, 0.2, True, "cpu", log=lambda m: None)
    assert r["correct"] and r["metrics"]["frames_traced"]["value"] == r["attempted"]
    assert "kernel_a_roofline" not in r["metrics"]  # no device trace on the CPU: silent
    assert list(r)[-1] == "checks"


def test_p95_is_the_tail_of_every_frame_and_a_stall_moves_it():
    lat = list(np.linspace(50.0, 60.0, 400))
    base = p95(lat)
    assert 59.4 < base < 59.6
    stalled = lat[:]
    for i in range(100, 140):  # a 40-frame stall in the window
        stalled[i] = 90.0
    assert p95(stalled) == 90.0
    assert abs(p95(lat[:390] + [500.0] * 10) - base) < 0.1  # 10 of 400 stay under the 5 %


def test_idle_share_is_one_minus_the_union_of_device_intervals():
    iv = [(0.0, 1.0), (0.5, 1.5), (2.0, 3.0), (2.2, 2.4), (9.0, 11.0)]
    assert trace.union_s(iv) == pytest.approx(1.5 + 1.0 + 2.0)
    assert trace.busy(iv, 0.0, 10.0) == pytest.approx(3.5)  # clipped to the window
    reader = Cell("mandel_1e6x.exact", ROOT).reader("device_idle_share")
    assert reader({"device": {"busy_s": 3.5, "window_s": 10.0}}) == pytest.approx(0.65)
    assert reader({"device": {"busy_s": 0.0, "window_s": 10.0}}) is None


def test_idle_gaps_are_labelled_by_the_span_around_them():
    frames = [{"t0": 0.0, "t1": 1.0, "split": [("walk", "f64", 300.0, 0.5)], "kernels": [
        ("k", 0.6, 0.9)]}]
    b = trace.breakdown(frames, [(0.6, 0.9)], [], 0.0, 1.0)
    assert b["device_ops"] == [["k", pytest.approx(0.3)]]
    labels = dict((n, v) for n, v in b["idle_gaps"])
    assert labels["span walk"] == pytest.approx(0.6)
    assert labels["python in a frame"] == pytest.approx(0.1)


def hand_steps(cr, ci, iterations, limit=65536.0, eps_sq=1e-18):
    """The steps one pixel takes, by hand: z = c, then z*z + c until |z|^2 >
    limit^2, the escaping step included, or the budget; and the same with
    Brent's cycle test (a snapshot at z_0 and after steps 1, 2, 4, ...)."""
    zr, zi = cr, ci
    sr, si, cycle = zr, zi, None
    for n in range(iterations):
        zr, zi = zr * zr - zi * zi + cr, 2 * zr * zi + ci
        if zr * zr + zi * zi > limit * limit:
            return n + 1, min(n + 1, cycle or iterations)
        if cycle is None and (zr - sr) ** 2 + (zi - si) ** 2 < eps_sq:
            cycle = n + 1
        if n >= 1 and n & (n - 1) == 0:
            sr, si = zr, zi
    return iterations, cycle or iterations


def test_pixel_steps_match_a_hand_count_at_a_tiny_view():
    from portbench.reference.perturb import lattice_steps
    from portbench.reference.viewport import affine

    frame = dict(json.loads((ROOT / "portbench/configs/mandel_1e6x.json").read_text())["scene"],
                 width=12, height=8, iterations=300, pos_str=["-0.75", "0.1"], scale=[0.9, 0.9])
    (ar, cr), (ai, ci) = affine(frame)
    for stride in (1, 3):
        hand = [hand_steps(float(ar * u + cr), float(ai * v + ci), 300)
                for v in range(0, 8, stride) for u in range(0, 12, stride)]
        got = lattice_steps([frame, frame], "cpu", stride, 1e-18)
        want = (len(hand), sum(h[0] for h in hand), sum(h[1] for h in hand))
        assert got == [want, want]
    assert sum(h[1] < h[0] for h in hand) > 0  # the cycle test stops some pixels early


def test_roofline_counts_the_named_kernel_in_counted_frames():
    frames = [{"steps": {"to_escape": 2_000_000, "with_cycle": 1_000_000}, "pixels": 100,
               "kernels": [("void escape_kernel<ZD>", 0.0, 4e-6), ("Memcpy DtoH", 4e-6, 9e-6)]},
              {"steps": None, "pixels": 100, "kernels": [("void escape_kernel", 0, 1.0)]}]
    assert roofline_pct(frames, "escape_kernel", "kernel_a_ds32", 3, "with_cycle") == \
        pytest.approx(100 * 1_000_000 * 80 / 3.35e13 / 4e-6)
    assert roofline_pct(frames, "escape_kernel", "kernel_a_ds32", 3, "to_escape") == \
        pytest.approx(100 * 2_000_000 * 80 / 3.35e13 / 4e-6)
    assert roofline_pct(frames, "perturb_dist_kernel", "kernel_b_dist", 8, "to_escape") is None


def test_the_import_guard_compares_whole_top_level_names():
    assert run.loaded_forbidden(["fractal_tpu_torch", "fractal_tpu_torch.ops", "jaxtyping",
                                 "numpy"]) == []
    assert run.loaded_forbidden(["fractal_tpu.ops.perturb", "jax.numpy"]) == ["fractal_tpu",
                                                                              "jax"]
    assert run.loaded_forbidden(["jaxlib", "flax.linen"]) == ["flax", "jaxlib"]


def test_a_run_without_a_card_exits_nonzero_and_prints_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    assert run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"]) == 3
    out, err = capsys.readouterr()
    assert out == "" and "CUDA" in err


def test_the_reference_imports_nothing_of_the_program_nor_of_jax(tmp_path):
    assert run.reference_imports() == {}
    (tmp_path / "bad.py").write_text("import numpy\nfrom fractal_tpu_torch.ops import escape\n")
    assert list(run.reference_imports(tmp_path).values()) == [["fractal_tpu_torch"]]


def broken(kind):
    """The program's entry with one fault planted where the frame is made."""
    from fractal_tpu_torch.render import render

    last = {}

    def wrapped(scene, device):
        img = render(scene, device)
        if kind == "stale":  # the state (the last frame) returned unchanged
            out, last["img"] = last.get("img", img), img
            return out
        img = img.copy()
        if kind == "half":  # half of the rows left out
            img[img.shape[0] // 2:] = 0
        elif kind == "altered":  # the answer altered where it is made
            img[..., 0] = 255 - img[..., 0]
        return img

    return wrapped


@pytest.mark.parametrize("cell_name", CELLS)
@pytest.mark.parametrize("fault", [None, "stale", "half", "altered"])
def test_a_broken_timed_path_makes_the_run_incorrect(tiny_root, cell_name, fault):
    r = run_cell(Cell(cell_name, tiny_root), 2**31 + 17, 0.3, False, "cpu",
                 render=broken(fault) if fault else None, log=lambda m: None)
    assert r["correct"] is (fault is None), r["checks"]


def test_a_frame_that_raises_counts_as_failed(tiny_root):
    from fractal_tpu_torch.render import render

    calls = []

    def flaky(scene, device):
        calls.append(1)
        if len(calls) == 2:  # the window's first frame (the first call warms up)
            raise RuntimeError("lost")
        return render(scene, device)

    r = run_cell(Cell("mandel_1e6x.exact", tiny_root), 3, 0.3, False, "cpu", render=flaky,
                 log=lambda m: None)
    assert r["failed"] == 1 and r["correct"] is False


FERN_SCENE = {"algo": "fern", "width": 64, "height": 64, "iterations": 20000,
              "limit": 65536.0, "stable_limit": 2.0, "pos_str": ["0", "0"], "scale": [0.4, 0.4],
              "exposure": 2.0, "inside": True, "smooth": True, "primary_color": [4, 3, 100],
              "secondary_color": [240, 240, 240], "power": 2, "supersample": 1,
              "precision": "auto", "seed": 0}
#: A stub of a fern's reference: the program's own render, since what it
#: tests is the plumbing and not the fern.  ``band`` zeroes rows 8..15 of its
#: image: the control's option, and with ``BAND`` a fault the check must see.
FERN_REFERENCE = '''
import json

import torch

from portbench.harness import scene_of

BAND = {band}


def key(frame):
    return json.dumps(frame, sort_keys=True)


def state(frame, device, band=BAND):
    from fractal_tpu_torch.render import render

    img = torch.from_numpy(render(scene_of(frame), device))
    if band:
        img[8:16] = 0
    return img


def image(frame, state):
    return state
'''
#: Planted readers: the frames whose work ``counts/fern.py`` counted (a name
#: with "roofline", so the harness counts), and the frames whose spans and
#: ``stats["fern"]`` hold the fern's steps and points.
FERN_READERS = {
    "fern_hist_roofline": '''
def read(rec):
    n = sum(f.get("steps") == {"points": 20000} for f in rec["frames"])
    return float(n) if n else None
''',
    "fern_frames_traced": '''
KINDS = {"key chain", "uniforms", "walk", "plot indices", "histogram", "darkening", "to host"}


def read(rec):
    return float(sum({k for k, _, _, _ in f["split"]} == KINDS
                     and f["stats"]["fern"]["points"] == 20000 for f in rec["frames"]))
''',
}


def add_fern_cell(root, band=False, count=True):
    """A cell of another algo, as its change would add it: a configuration,
    a mix that draws each frame's seed, a check whose control is the algo's
    reference degraded by an option, the algo's reference, work count and
    span sinks, and two readers, all new files, and new entries."""
    pb = root / "portbench"
    (pb / "configs" / "fern_tiny.json").write_text(json.dumps(
        {"name": "fern_tiny", "scene": FERN_SCENE, "assumed": [], "reduced": [], "chips": 1}))
    (pb / "traffic" / "fern_stills.json").write_text(json.dumps(
        {"warmup": 1, "max_fps": 100, "centre": {"kind": "fixed"},
         "draw": {"seed": {"integers": [0, 2**31]}}}))
    (pb / "checks" / "fern_tiny.stills.json").write_text(json.dumps(
        {"sample_frames": 3, "limits": {"bad_px_pct": 0.0, "mean_abs_levels": 0.0},
         "control": {"kind": "reference", "options": {"band": True}}}))
    (pb / "reference" / "fern.py").write_text(FERN_REFERENCE.format(band=band))
    (pb / "sinks").mkdir()
    (pb / "sinks" / "fern.json").write_text(json.dumps(
        {"spans": ["fractal_tpu_torch.models.fern"],
         "stats": {"fern": "fractal_tpu_torch.models.fern"}}))
    if count:
        (pb / "counts" / "fern.py").write_text(
            "def frame_work(frames, device):\n"
            "    return [{'points': f['iterations']} for f in frames]\n")
    for name, src in FERN_READERS.items():
        (pb / "metrics" / f"{name}.py").write_text(src)
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "fern_tiny", "source": "a test", "reduced": [],
                         "file": "portbench/configs/fern_tiny.json", "why": "a test"})
    b["workloads"].append({"name": "fern_tiny.stills", "config": "fern_tiny",
                           "traffic": "fern_stills", "chips": 1, "why": "a test"})
    b["per_layer"] += [{"name": name, "unit": "frames", "better": "higher",
                        "source": "program_counter", "layer": "the fern",
                        "moves": "frames_per_s", "workloads": ["fern_tiny.stills"]}
                       for name in FERN_READERS]
    (root / "BENCHMARK.json").write_text(json.dumps(b))


@pytest.fixture
def no_mandelbrot_count(monkeypatch):
    """The Mandelbrot's count and reference, made to fail if called."""
    import portbench.counts
    import portbench.reference.perturb

    def called(*a, **k):
        raise AssertionError("the Mandelbrot's count or reference was called")

    for mod, name in ((portbench.counts, "frame_steps"), (portbench.reference, "counts"),
                      (portbench.reference.perturb, "lattice_steps")):
        monkeypatch.setattr(mod, name, called)


@pytest.mark.parametrize("fault", [None, "reference band", "program half"])
def test_a_cell_of_another_algo_enters_as_new_files(tiny_root, no_mandelbrot_count, fault):
    add_fern_cell(tiny_root, band=fault == "reference band")
    before = {p: p.read_bytes() for p in (ROOT / "portbench").rglob("*") if p.is_file()}
    render = broken("half") if fault == "program half" else None
    r = run_cell(Cell("fern_tiny.stills", tiny_root), 2**33 + 5, 0.3, True, "cpu",
                 render=render, log=lambda m: None)
    assert r["correct"] is (fault is None), r["checks"]
    n = r["attempted"]
    assert n >= 1 and r["metrics"]["fern_frames_traced"]["value"] == n
    assert r["metrics"]["fern_hist_roofline"]["value"] == min(n, 64)
    assert before == {p: p.read_bytes() for p in (ROOT / "portbench").rglob("*") if p.is_file()}


def test_a_cell_of_another_algo_without_a_work_count_reads_no_roofline(tiny_root,
                                                                      no_mandelbrot_count):
    add_fern_cell(tiny_root, count=False)
    logged = []
    r = run_cell(Cell("fern_tiny.stills", tiny_root), 17, 0.2, True, "cpu", log=logged.append)
    assert r["correct"] and "fern_hist_roofline" not in r["metrics"]
    assert r["metrics"]["fern_frames_traced"]["value"] == r["attempted"]
    assert any(m.startswith("warning: no work count for 'fern'") and "counts/fern.py" in m
               for m in logged), logged


def test_the_control_of_a_cell_of_another_algo_fails_its_check(tiny_root, no_mandelbrot_count):
    add_fern_cell(tiny_root)
    before = {p: p.read_bytes() for p in (ROOT / "portbench").rglob("*") if p.is_file()}
    got = control.readings(Cell("fern_tiny.stills", tiny_root), 2**31 + 3, 3, "cpu")
    assert got["fails"] and got["numbers"]["bad_px_pct"] > 10, got
    assert before == {p: p.read_bytes() for p in (ROOT / "portbench").rglob("*") if p.is_file()}


@pytest.mark.parametrize("name", CELLS)
def test_each_mandelbrot_cell_is_counted_through_its_algos_file(tiny_root, monkeypatch, name):
    # counts/mandelbrot.py takes portbench.counts.frame_steps when the run
    # loads it; a reader counts the traced frames that got its steps
    import portbench.counts

    called = []

    def frame_steps(frames, device):
        called.append(len(frames))
        return [{"to_escape": 1.0, "with_cycle": 1.0} for _ in frames]

    monkeypatch.setattr(portbench.counts, "frame_steps", frame_steps)
    (tiny_root / "portbench/metrics/frames_counted.py").write_text(
        "def read(rec):\n    return float(sum('steps' in f for f in rec['frames']))\n")
    b = json.loads((tiny_root / "BENCHMARK.json").read_text())
    b["per_layer"].append({"name": "frames_counted", "unit": "frames", "better": "higher",
                           "source": "program_counter", "layer": "render driver",
                           "moves": "frames_per_s", "workloads": [name]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(b))
    cell = Cell(name, tiny_root)
    assert any("roofline" in m["name"] for m in cell.per_layer())
    r = run_cell(cell, 2**32 + 11, 0.2, True, "cpu", log=lambda m: None)
    n = min(r["attempted"], 64)
    assert called == [n] and r["metrics"]["frames_counted"]["value"] == n


def test_frames_that_differ_only_in_seed_are_checked_against_their_own_reference(tiny_root):
    from fractal_tpu_torch.render import render

    from portbench.harness import scene_of

    add_fern_cell(tiny_root)
    frames = [dict(FERN_SCENE, seed=s) for s in (1, 2, 2**31 - 1)]
    imgs = [torch.from_numpy(render(scene_of(f), "cpu")) for f in frames]
    assert not torch.equal(imgs[0], imgs[1])
    assert compare.check(list(zip(frames, imgs)), "cpu", root=tiny_root)["bad_px_pct"] == 0
    swapped = compare.check(list(zip(frames, imgs[1:] + imgs[:1])), "cpu", root=tiny_root)
    assert swapped["bad_px_pct"] > 1
