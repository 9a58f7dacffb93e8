"""Per-phase wall-time profiling for ``--profile``."""

from __future__ import annotations

import contextlib
import subprocess
import time
from typing import List, Tuple


@contextlib.contextmanager
def fenced_step(split, kind: str, detail: str = ""):
    """Append (kind, detail, ms) of the enclosed block to the list ``split``,
    fenced with ``torch.cuda.synchronize()`` when CUDA is in use; with
    ``split`` None, time nothing and add no synchronisation."""
    if split is None:
        yield
        return
    import torch

    fence = torch.cuda.is_available() and torch.cuda.is_initialized()
    if fence:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    yield
    if fence:
        torch.cuda.synchronize()
    split.append((kind, detail, (time.perf_counter() - t0) * 1e3))


def event_ms(fn, reps: int = 3):
    """(mean device ms of ``fn`` over ``reps`` calls after one warm-up, by
    CUDA events; the last output)."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


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
