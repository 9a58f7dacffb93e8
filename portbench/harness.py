"""One run of one cell: set-up, the measured window, the check, the metrics.

A cell of ``BENCHMARK.json`` names a configuration (its ``file``: the
scene fields) and a traffic mix (``portbench/traffic/<traffic>.json``);
its check is ``portbench/checks/<cell>.json`` (how many frames to compare
and the limit of each number compared) and each per-layer metric is read by
``portbench/metrics/<metric>.py``.  What belongs to the scene's algo is
found by the frames' ``algo``:

  * ``portbench/reference/<algo>.py``: the check's reference
    (``compare``); a frame of an algo without one fails the run;
  * ``portbench/counts/<algo>.py``: ``frame_work(frames, device)``, each
    counted frame's work, which the roofline readers take from a traced
    frame's ``steps``; counted only for a cell with a ``*roofline*``
    metric, and not at all where the file is missing (the run logs a
    warning, and those readers read None);
  * ``portbench/sinks/<algo>.json``, optional: {"spans": [module, ...],
    "stats": {key: module}}, the program's modules whose ``SPLIT`` takes a
    traced frame's spans besides ``SINK``, and whose ``RENDER_STATS`` a
    frame's stats copy under ``key`` besides the escape-time route's
    (``ops/perturb.RENDER_STATS``, then ``render.RENDER_STATS["route"]``).

All are found by name, so a new cell, mix, metric or algo is new files and
entries, not an edit.

The window drives ``fractal_tpu_torch.render.render(scene, device)``, the
entry of the CLI and the viewer, which returns the (H, W, 3) uint8 frame on
the host: one client, the next frame asked for when the last arrives.
"""

from __future__ import annotations

import json
import statistics
import sys
import time
from pathlib import Path

import torch

from portbench import byname, compare, generator, trace
from portbench.byname import ROOT
from portbench.counts import COUNT_FRAMES, card

#: The program's span sink on every escape-time route, set where the warm-up
#: loaded it: the render driver's and the perturbation path's.
SINK = "fractal_tpu_torch.ops.perturb"


def load_json(path):
    with open(path) as f:
        return json.load(f)


class Cell:
    """A workload of ``BENCHMARK.json`` with its configuration, mix and check."""

    def __init__(self, name: str, root: Path = ROOT):
        self.root = Path(root)
        self.bench = load_json(self.root / "BENCHMARK.json")
        byname = {w["name"]: w for w in self.bench["workloads"]}
        if name not in byname:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(byname)})")
        self.name = name
        self.workload = byname[name]
        config = next(c for c in self.bench["configs"] if c["name"] == self.workload["config"])
        self.config = load_json(self.root / config["file"])
        self.mix = generator.load(generator.mix_path(self.root, self.workload["traffic"]))
        self.check = load_json(self.root / "portbench" / "checks" / f"{name}.json")

    def end_to_end(self):
        return [m for m in self.bench["end_to_end"] if self.name in m.get("workloads", [self.name])]

    def per_layer(self):
        return [m for m in self.bench["per_layer"] if self.name in m.get("workloads", [self.name])]

    def reader(self, metric: str):
        return byname.module(self.root, "metrics", metric).read


def route_modules(root, algo: str):
    """(the modules whose ``SPLIT`` takes a traced frame's spans, {key: the
    module whose ``RENDER_STATS`` a frame's stats copy under key}) of
    ``algo``'s route: ``SINK`` and ``portbench/sinks/<algo>.json``'s, of
    those loaded."""
    path = byname.path(root, "sinks", algo, ".json")
    extra = load_json(path) if path.is_file() else {}
    names = (SINK, *extra.get("spans", ()))
    sinks = [sys.modules[n] for n in names if hasattr(sys.modules.get(n), "SPLIT")]
    stats = {k: sys.modules[n] for k, n in extra.get("stats", {}).items() if n in sys.modules}
    return sinks, stats


def scene_of(frame: dict):
    """The program's ``Scene`` of a frame dict."""
    from fractal_tpu_torch.config import RGB, Scene

    f = dict(frame)
    for k in ("primary_color", "secondary_color"):
        f[k] = RGB(*f[k])
    for k in ("pos_str", "scale", "julia_set"):
        if k in f:
            f[k] = tuple(f[k])
    return Scene(**f)


def p95(values) -> float:
    """The 95th percentile of every value (``statistics.quantiles``'
    exclusive method, 20 cut points); of one value, that value."""
    return statistics.quantiles(values, n=20)[-1] if len(values) > 1 else values[0]


class Sample:
    """The frames kept for the check: ``k`` drawn uniformly from all that
    the window completes (a reservoir on the seed's own stream), and the
    slowest."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.kept, self.seen, self.slowest = k, generator.rng(seed, 1), [], 0, None

    def offer(self, i: int, img, ms: float):
        self.seen += 1
        if len(self.kept) < self.k:
            self.kept.append((i, img))
        else:
            j = int(self.rng.integers(self.seen))
            if j < self.k:
                self.kept[j] = (i, img)
        if self.slowest is None or ms > self.slowest[1]:
            self.slowest = (i, ms, img)

    def frames(self):
        out = dict(self.kept)
        if self.slowest is not None:
            out[self.slowest[0]] = self.slowest[2]
        return sorted(out.items())


def run_cell(cell: Cell, seed: int, seconds: float, do_trace: bool, device: str = "cuda",
             t_start: float = None, render=None, log=print):
    """Run ``cell`` once; the result dict of the contract's last line.
    ``render`` replaces the program's entry (the fault tests)."""
    t_start = time.perf_counter() if t_start is None else t_start
    on_card = device == "cuda"
    if render is None:
        from fractal_tpu_torch.render import render
    frames = generator.frames(cell.config["scene"], cell.mix, seed,
                              generator.frame_count(cell.mix, seconds))
    scenes = [scene_of(f) for f in frames]
    nwarm = int(cell.mix.get("warmup", 1))
    for s in scenes[:nwarm]:
        render(s, device)
    if on_card:
        torch.cuda.synchronize()
    algo = frames[0].get("algo", "mandelbrot")
    perturb = sys.modules.get("fractal_tpu_torch.ops.perturb")
    render_mod = sys.modules.get("fractal_tpu_torch.render")
    sinks, stat_mods = route_modules(cell.root, algo)

    prof = None
    if do_trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        prof = profile(activities=acts)
        prof.__enter__()
    sample = Sample(int(cell.check["sample_frames"]), seed)
    recs, lat, failed = [], [], 0
    t_w0 = time.perf_counter()
    setup_s = t_w0 - t_start
    i = 0
    while i == 0 or time.perf_counter() - t_w0 < seconds:
        if nwarm + i >= len(scenes):
            log(f"warning: the mix's {len(scenes) - nwarm} frames ran out before the "
                f"window closed")
            break
        spans = trace.Spans()
        if do_trace:
            for m in sinks:
                m.SPLIT = spans
        t0 = time.perf_counter()
        try:
            if do_trace:
                with record_function(trace.FRAME):
                    img = render(scenes[nwarm + i], device)
            else:
                img = render(scenes[nwarm + i], device)
        except Exception as e:  # a frame that fails is counted, and the run goes on
            log(f"frame {i} failed: {type(e).__name__}: {e}")
            img, failed = None, failed + 1
        t1 = time.perf_counter()
        lat.append((t1 - t0) * 1e3)
        if img is not None:
            sample.offer(i, img, lat[-1])
        if do_trace:
            stats = dict(perturb.RENDER_STATS) if perturb is not None else {}
            if render_mod is not None:
                stats["route"] = render_mod.RENDER_STATS.get("route", "")
            for k, m in stat_mods.items():
                stats[k] = dict(m.RENDER_STATS)
            f = frames[nwarm + i]
            recs.append({"t0": t0, "t1": t1, "split": list(spans), "stats": stats,
                         "pixels": f["width"] * f["height"], "iterations": f["iterations"]})
        i += 1
    t_w1 = time.perf_counter()
    for m in sinks:
        m.SPLIT = None
    window_s = t_w1 - t_w0
    mem = int(torch.cuda.max_memory_allocated()) if on_card else 0

    if prof is not None:
        prof.__exit__(None, None, None)
        dev_iv, cpu = trace.records(prof.events(), recs, torch.autograd.DeviceType.CUDA)
        del prof
    kept = sample.frames()
    del img
    if on_card:
        torch.cuda.empty_cache()

    # The check, after the window: the reference on the kept frames.
    t_ref = time.perf_counter()
    numbers = compare.check([(frames[nwarm + k], img) for k, img in kept], device=device,
                            root=cell.root)
    ref_s = time.perf_counter() - t_ref
    if do_trace and any("roofline" in m["name"] for m in cell.per_layer()):
        count_path = byname.path(cell.root, "counts", algo)
        if count_path.is_file():
            n = min(COUNT_FRAMES, i)
            count = byname.module(cell.root, "counts", algo)
            for rec, work in zip(recs, count.frame_work(frames[nwarm:nwarm + n], device)):
                rec["steps"] = work
            log(f"{algo} work counted on the window's first {n} frames in "
                f"{time.perf_counter() - t_ref - ref_s:.3f} s")
        else:
            log(f"warning: no work count for {algo!r} ({count_path} does not exist): "
                f"the roofline metrics read nothing")
    limits = cell.check["limits"]
    correct = (failed == 0 and bool(kept)
               and all(numbers[k] <= limits[k] for k in limits))

    name = torch.cuda.get_device_name(0) if on_card else "cpu"
    result = {"correct": correct, "attempted": i, "failed": failed, "metrics": {},
              "device": {"platform": "gpu" if on_card else "cpu", "kind": name,
                         "count": 1, "memory_peak_bytes": mem}}
    if do_trace:
        busy = trace.busy(dev_iv, t_w0, t_w1)
        result["device"].update(busy_s=busy, window_s=window_s)
        rec = {"frames": recs, "device": {"busy_s": busy, "window_s": window_s}}
        for m in cell.per_layer():
            v = cell.reader(m["name"])(rec)
            if v is not None:
                result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
        result["breakdown"] = trace.breakdown(recs, dev_iv, cpu, t_w0, t_w1)
    else:
        values = {"frames_per_s": i / window_s, "frame_ms_p95": p95(lat), "setup_s": setup_s}
        for m in cell.end_to_end():
            result["metrics"][m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    result["card"] = card() if on_card else "cpu"
    if on_card:
        log(f"after the window: "
            f"{card('clocks.sm,power.draw,temperature.gpu,clocks_throttle_reasons.active')}")
    log(f"{cell.name} seed {seed}: {i} frames in {window_s:.3f} s, set-up {setup_s:.3f} s, "
        f"p50 {statistics.median(lat):.3f} ms, max {max(lat):.3f} ms, first {lat[0]:.3f} ms; "
        f"reference {ref_s:.3f} s on frames {[k for k, _ in kept]}; {result['card']}")
    result["checks"] = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    return result
