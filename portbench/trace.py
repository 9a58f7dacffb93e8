"""The traced run's records: ``torch.profiler`` events and the program's
spans, put on one clock and cut into frames.

Every frame runs inside ``record_function(FRAME)``; the device's events that
start inside a frame's interval are that frame's.  The program's spans (the
(kind, detail, ms) steps appended to the ``SPLIT`` sinks the harness sets)
carry no start, so the list that collects them stamps each with the host
clock when it is appended, at the step's end; the frames' starts on both
clocks give the offset.
"""

from __future__ import annotations

import time
from collections import defaultdict

import numpy as np

FRAME = "portbench.frame"


class Spans(list):
    """``SPLIT``'s list: each (kind, detail, ms) gets its end on the host
    clock (``time.perf_counter`` seconds)."""

    def append(self, item):
        super().append((*item, time.perf_counter()))


def merged(intervals):
    """The union of (start, end) intervals as sorted, disjoint [start, end]."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def union_s(intervals) -> float:
    """Seconds covered by the union of the intervals: the device's busy
    time."""
    return sum(e - s for s, e in merged(intervals))


def records(events, frames, device_type_cuda):
    """Fill each frame dict of ``frames`` (with "t0", the host clock at its
    start, and "split", its spans) with "kernels": [(name, start, end)] on
    the host clock, and return (device intervals, cpu events) over the
    window, all in host seconds."""
    marks = [e for e in events if e.name == FRAME and e.device_type != device_type_cuda]
    marks.sort(key=lambda e: e.time_range.start)
    # the median over the frames, so a mark the profiler dropped late in the
    # window moves the clocks' offset by nothing
    offset = float(np.median([m.time_range.start / 1e6 - f["t0"] for m, f in zip(marks, frames)]))
    dev, cpu = [], []
    for e in events:
        s, t = e.time_range.start / 1e6 - offset, e.time_range.end / 1e6 - offset
        if e.device_type == device_type_cuda:
            if e.name != FRAME:
                dev.append((e.name, s, t))
        elif e.name != FRAME:
            cpu.append((e.name, s, t))
    dev.sort(key=lambda x: x[1])
    starts = np.array([d[1] for d in dev])
    for f in frames:
        lo, hi = np.searchsorted(starts, [f["t0"], f["t1"]])
        f["kernels"] = dev[lo:hi]
    return [(s, t) for _, s, t in dev], cpu


def busy(dev_intervals, t0: float, t1: float) -> float:
    return union_s([(max(s, t0), min(e, t1)) for s, e in dev_intervals if e > t0 and s < t1])


def breakdown(frames, dev_intervals, cpu, t0: float, t1: float, top: int = 10):
    """{"device_ops": the ``top`` device operations by seconds, "idle_gaps":
    idle seconds by what the host was doing: the program's span around the
    gap, else the innermost profiled host call, else python inside a frame
    or between frames}."""
    by_name = defaultdict(float)
    for f in frames:
        for name, s, e in f["kernels"]:
            by_name[name] += e - s
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    spans = [(end - ms / 1e3, end, kind) for f in frames for kind, _, ms, end in f["split"]]
    cs = np.array([c[1] for c in cpu]) if cpu else np.zeros(0)
    ce = np.array([c[2] for c in cpu]) if cpu else np.zeros(0)
    busy_iv = merged([(max(s, t0), min(e, t1)) for s, e in dev_intervals if e > t0 and s < t1])
    edges = [t0] + [x for iv in busy_iv for x in iv] + [t1]
    gaps = sorted(((edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), key=lambda g: g[0] - g[1])[:2000]
    fr = np.array([[f["t0"], f["t1"]] for f in frames])
    idle = defaultdict(float)
    for s, e in gaps:
        m = (s + e) / 2
        label = next((f"span {k}" for a, b, k in spans if a <= m <= b), None)
        if label is None and cs.size:
            inside = np.nonzero((cs <= m) & (ce >= m))[0]
            if inside.size:
                j = inside[np.argmin(ce[inside] - cs[inside])]
                label = cpu[j][0]
        if label is None:
            in_frame = bool(((fr[:, 0] <= m) & (fr[:, 1] >= m)).any())
            label = "python in a frame" if in_frame else "between frames"
        idle[label] += e - s
    gaps_top = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, v] for n, v in ops], "idle_gaps": [[n, v] for n, v in gaps_top]}
