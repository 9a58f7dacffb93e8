"""Files of the benchmark found by name under a root that holds
``portbench/``: a metric's reader, an algo's reference, work count and span
sinks.  Each module is loaded from its path, not imported, so a test's root
can plant one and a later cell brings its own as a new file."""

from __future__ import annotations

import importlib.util
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def path(root, kind: str, name: str, suffix: str = ".py") -> Path:
    """``<root>/portbench/<kind>/<name><suffix>``."""
    return Path(root) / "portbench" / kind / f"{name}{suffix}"


def module(root, kind: str, name: str):
    """The module ``<root>/portbench/<kind>/<name>.py``, loaded afresh;
    FileNotFoundError, naming the path, where there is no such file."""
    p = path(root, kind, name)
    if not p.is_file():
        raise FileNotFoundError(f"no {kind} module for {name!r}: {p} does not exist")
    spec = importlib.util.spec_from_file_location(f"portbench.{kind}.{name}", p)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
