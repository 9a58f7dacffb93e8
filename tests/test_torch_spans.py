"""The port's spans on the CPU: ``utils/timing.span`` and the sink in
``ops/perturb.SPLIT`` through a whole frame (the render driver's ``blocks``,
``kernel A`` and ``to host``; the p32 route's ``kernel B dist`` and
``coloring``), the fence a ``timing.Fenced`` sink asks for and nothing with
no sink, ``RENDER_STATS["reference"]``, ``--profile``'s printout, and the
benchmark's readers of those spans and that counter on hand-made records."""

from __future__ import annotations

import functools
import importlib
import importlib.util
import time
import types
from pathlib import Path

import pytest
import torch

from fractal_tpu_torch.config import Scene
from fractal_tpu_torch.ops import perturb
from fractal_tpu_torch.utils import timing

render = importlib.import_module("fractal_tpu_torch.render")

ROOT = Path(__file__).resolve().parents[1]
VIEW = dict(width=48, height=32, iterations=300, pos=(-0.7436447860, 0.1318252536),
            scale=(1e6, 1e6))


class Stamped(list):
    """A plain sink that stamps each span's end, as the benchmark's does."""

    def append(self, item):
        super().append((*item, time.perf_counter()))


@pytest.fixture
def sink():
    """Empty perturbation caches, and ``perturb.SPLIT`` restored after."""
    for name, val in vars(perturb).items():
        if name.endswith("_CACHE") and isinstance(val, dict):
            val.clear()
    saved = perturb.SPLIT
    yield
    perturb.SPLIT = saved


@pytest.fixture
def card_route(monkeypatch):
    """``render.render``'s p32 frames on kernel B's route (its plain
    version), the card's, instead of the CPU's f32 BLA route."""
    monkeypatch.setattr(perturb, "render_perturb",
                        functools.partial(perturb.render_perturb, grids=perturb.CARD_ROUTE))


def counting(monkeypatch, initialised: bool = True):
    """Count ``torch.cuda.synchronize`` calls and the timing module's clock
    reads, with CUDA available and initialised or not."""
    n = {"sync": 0, "clock": 0}

    def sync():
        n["sync"] += 1

    def clock():
        n["clock"] += 1
        return time.perf_counter()

    monkeypatch.setattr(torch.cuda, "synchronize", sync)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: initialised)
    monkeypatch.setattr(timing, "time", types.SimpleNamespace(perf_counter=clock))
    return n


def in_post_order(spans) -> bool:
    """Each span either encloses every span appended before it that it
    overlaps, or starts after it has ended."""
    iv = [(end - ms / 1e3, end) for _, _, ms, end in spans]
    for j, (sj, ej) in enumerate(iv):
        for si, ei in iv[:j]:
            if not (sj >= ei or (sj <= si and ej >= ei)):
                return False
    return True


@pytest.mark.parametrize("precision", ["ds32", "p32"])
def test_no_sink_appends_nothing_reads_no_clock_and_never_synchronizes(
        sink, card_route, monkeypatch, precision):
    n = counting(monkeypatch)
    perturb.SPLIT = None
    img = render.render(Scene(**VIEW, precision=precision), "cpu")
    assert img.shape == (32, 48, 3)
    assert n == {"sync": 0, "clock": 0}
    assert timing.span(None, "kernel A") is timing.span(None, "to host")  # one shared no-op


@pytest.mark.parametrize("initialised", [True, False])
def test_a_fenced_sink_synchronizes_twice_a_span_only_where_cuda_is_initialised(
        monkeypatch, initialised):
    n = counting(monkeypatch, initialised)
    fenced = timing.Fenced()
    with timing.span(fenced, "outer"):
        with timing.span(fenced, "inner", "a detail"):
            pass
    assert [s[:2] for s in fenced] == [("inner", "a detail"), ("outer", "")]
    assert n == {"sync": 4 if initialised else 0, "clock": 4}
    plain = []
    with timing.span(plain, "unfenced"):
        pass
    assert len(plain) == 1 and n["sync"] == (4 if initialised else 0)  # a list: no fence


def test_a_span_whose_block_raises_appends_nothing():
    spans = []
    with pytest.raises(ValueError):
        with timing.span(spans, "fails"):
            raise ValueError("no")
    assert spans == []


def test_a_ds32_frame_gets_the_render_drivers_spans(sink):
    perturb.SPLIT = Stamped()
    render.render(Scene(**VIEW, precision="ds32"), "cpu")
    assert [s[0] for s in perturb.SPLIT] == ["blocks", "kernel A", "to host"]
    assert perturb.SPLIT[1][1] == render.RENDER_STATS["route"]
    assert in_post_order(perturb.SPLIT)


def test_a_p32_frame_on_kernel_bs_route_gets_its_spans_in_nesting_order(sink, card_route):
    perturb.SPLIT = Stamped()
    img = render.render(Scene(**VIEW, precision="p32"), "cpu")
    assert perturb.RENDER_STATS["route"] == "plain" and img.shape == (32, 48, 3)
    assert [s[0] for s in perturb.SPLIT] == ["walk", "reference", "P block", "upload",
                                             "kernel B dist", "coloring", "to host"]
    assert in_post_order(perturb.SPLIT)
    (_, _, walk_ms, walk_end), (_, _, ref_ms, ref_end) = perturb.SPLIT[:2]
    assert ref_end - ref_ms / 1e3 <= walk_end - walk_ms / 1e3 and walk_end <= ref_end


def test_the_reference_counter_names_how_the_orbit_was_found(sink, card_route):
    scene = Scene(**VIEW, precision="p32")
    seen = []
    for sc in (scene, scene, scene.replace(pos=(VIEW["pos"][0] + 2e-7, VIEW["pos"][1]))):
        render.render(sc, "cpu")
        seen.append(perturb.RENDER_STATS["reference"])
    assert seen == ["walk", "memo", "reuse"]


def test_profile_prints_the_renders_spans(monkeypatch, tmp_path, capsys):
    from fractal_tpu_torch.__main__ import main

    monkeypatch.setenv("FRACTAL_TPU_PLATFORM", "cpu")
    assert main(f"48 32 -s 1e6 -x -.7436447860 -y .1318252536 -i 200 --precision ds32 "
                f"--format png --profile -o {tmp_path / 'e'}".split()) == 0
    out = capsys.readouterr().out
    spans = out[out.index("--- spans ---"):]
    assert "blocks:" in spans and "kernel A:" in spans
    assert perturb.SPLIT is None


def reader(name):
    path = ROOT / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def frame(t0, split, kernels=(), **stats):
    return {"t0": t0, "t1": t0 + 1.0, "split": split, "kernels": list(kernels), "stats": stats}


# (kind, detail, ms, end on the host clock in s)
EXACT = frame(10.0, [("blocks", "", 0.2, 10.0004), ("kernel A", "", 0.1, 10.0010),
                     ("to host", "", 50.0, 10.0510)],
              [("Memcpy HtoD", 10.0003, 10.00031), ("escape_kernel", 10.0011, 10.0480),
               ("Memcpy DtoH (Device -> Pageable)", 10.0481, 10.0505)])
P32 = frame(20.0, [("P block", "", 0.3, 20.0005), ("kernel B dist", "", 0.1, 20.0020),
                   ("coloring", "", 0.8, 20.0030), ("to host", "", 20.0, 20.0230)],
            [("perturb_dist_kernel", 20.0021, 20.0180), ("elementwise_kernel", 20.0181, 20.0184),
             ("Memcpy HtoD", 20.0185, 20.01851), ("reduce_kernel", 20.0186, 20.0190),
             ("Memcpy DtoH (Device -> Pageable)", 20.0200, 20.0225)],
            reference="reuse", tier="p32")


@pytest.mark.parametrize("name,rec,want", [
    ("launch_wait_ms", [EXACT, P32], (1.0 + 2.0) / 2),
    ("launch_wait_ms", [frame(0.0, [("walk", "", 1.0, 0.5)])], None),
    ("to_host_ms", [EXACT, P32], ((10.0510 - 10.0480) + (20.0230 - 20.0190)) * 1e3 / 2),
    ("to_host_ms", [frame(0.0, [("to host", "", 3.0, 0.5)])], 3.0),  # no device operations
    ("to_host_ms", [frame(0.0, [("kernel A", "", 3.0, 0.5)])], None),
    ("coloring_ms", [EXACT, P32], (0.0003 + 0.00001 + 0.0004) * 1e3),
    ("coloring_ms", [EXACT], None),
    ("reference_reuse_share", [P32, frame(1.0, [], reference="walk"),
                               frame(2.0, [], reference="memo"), EXACT], 2 / 3),
    ("reference_reuse_share", [EXACT, frame(1.0, [], reference="")], None),
])
def test_the_new_readers_on_hand_made_records(name, rec, want):
    got = reader(name)({"frames": rec, "device": {}})
    assert got == (None if want is None else pytest.approx(want))
