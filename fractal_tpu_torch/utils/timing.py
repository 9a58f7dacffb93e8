"""Timing: the program's spans (``span``, whose sink is a module's
``SPLIT``), ``--profile``'s phases, and the card tools' device times."""

from __future__ import annotations

import contextlib
import subprocess
import time
from collections import defaultdict
from typing import List, Tuple

import torch


class Fenced(list):
    """A span sink whose spans are fenced with ``torch.cuda.synchronize()``
    before and after, where CUDA is initialised: each span then holds the
    device work of its step too (``--profile``'s and ``chip_smoke.py``'s
    cold splits).  A plain list gets unfenced spans: host time, with a
    launch's enqueue but not its run."""

    fenced = True


class _Span:
    """The context manager of one live span (see ``span``)."""

    __slots__ = ("sink", "kind", "detail", "fence", "t0")

    def __init__(self, sink, kind: str, detail: str):
        self.sink, self.kind, self.detail = sink, kind, detail

    def __enter__(self):
        self.fence = (getattr(self.sink, "fenced", False) and torch.cuda.is_available()
                      and torch.cuda.is_initialized())
        if self.fence:
            torch.cuda.synchronize()
        self.t0 = time.perf_counter()

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            return False
        if self.fence:
            torch.cuda.synchronize()
        self.sink.append((self.kind, self.detail, (time.perf_counter() - self.t0) * 1e3))
        return False


_OFF = contextlib.nullcontext()


def span(sink, kind: str, detail: str = ""):
    """A context manager that appends (kind, detail, ms) of the enclosed
    block to ``sink`` when the block ends, timed by ``time.perf_counter``.
    Spans are appended in post-order, so an enclosing span follows the spans
    inside it; a span's parent is the innermost span around it on the
    clock.  The sink fences the span only where it asks to (``Fenced``).
    With ``sink`` None: a shared no-op context, no clock read, no
    synchronisation.  A block that raises appends nothing."""
    if sink is None:
        return _OFF
    return _Span(sink, kind, detail)


def event_ms(fn, reps: int = 3):
    """(mean device ms of ``fn`` over ``reps`` calls after one warm-up, by
    CUDA events; the last output)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def union_length(intervals) -> float:
    """The length covered by the union of (start, end) intervals: a
    device's busy time from its kernels' intervals."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
    return busy


def profile_warm(run_once, top: int = 8):
    """``torch.profiler`` over one call of ``run_once`` on the card: (wall
    ms, fenced with ``torch.cuda.synchronize()``; the device's busy ms, the
    union of its kernels' intervals, or None where the profiler recorded no
    kernel; [(kernel, ms, calls)] of the ``top`` kernels by time)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_once()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        return wall, None, []
    busy = union_length([(k.time_range.start, k.time_range.end) for k in kernels])
    by_name = defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_name[e.name][0] += e.time_range.elapsed_us() / 1e3
        by_name[e.name][1] += 1
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return wall, busy / 1e3, [(name, ms, calls) for name, (ms, calls) in ranked]


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them; raises
    where it gives none, since every measurement is kept with its card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


class Phases:
    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.entries: List[Tuple[str, float]] = []

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.entries.append((name, time.perf_counter() - t0))

    def report(self) -> None:
        if not self.enabled or not self.entries:
            return
        total = sum(dt for _, dt in self.entries)
        print("--- profile ---")
        for name, dt in self.entries:
            print(f"{name:>16s}: {dt * 1e3:9.2f} ms")
        print(f"{'total':>16s}: {total * 1e3:9.2f} ms")
