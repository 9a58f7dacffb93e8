"""Per-phase wall-time profiling for ``--profile``."""

from __future__ import annotations

import contextlib
import time
from typing import List, Tuple


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
