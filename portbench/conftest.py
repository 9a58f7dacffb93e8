"""pytest settings of the benchmark's own tests (``python -m pytest
portbench/tests``): the ``card`` marker, and the fixtures that decide, when a
test runs, whether a CUDA card is there and that build a small copy of the
benchmark."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
#: The tests' sizes: the configurations' views, cut so a CPU renders them in
#: well under a second.
TINY = {"mandel_1e6x": dict(width=32, height=32, iterations=4000),
        "seahorse_1e15": dict(width=48, height=27, iterations=10000)}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")
    import torch

    # one thread a worker: the program's CPU routes stall when several
    # pytest-xdist workers each run torch's threaded kernels on all cores
    torch.set_num_threads(1)


@pytest.fixture
def cuda_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card (torch.cuda.is_available() is False)")
    return "cuda"


@pytest.fixture
def tiny_root(tmp_path):
    """A copy of BENCHMARK.json and portbench/ whose configurations are cut
    to ``TINY``."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for name, sizes in TINY.items():
        path = tmp_path / "portbench" / "configs" / f"{name}.json"
        cfg = json.loads(path.read_text())
        cfg["scene"].update(sizes)
        path.write_text(json.dumps(cfg))
    return tmp_path
