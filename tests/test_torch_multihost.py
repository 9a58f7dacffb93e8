"""Ranks of the port's mesh (``fractal_tpu_torch/parallel/multihost.py``):
two rank processes on the CPU, joined in a gloo process group, render a
4-shard mesh through ``python -m fractal_tpu_torch.tools.dryrun_mesh 4
--ranks 2`` (each rank 2 shards; the stripes all-gathered and the fern's
hits all-reduced over gloo).  Every rank returns the whole image, equal
across ranks and to the one-device render (tests/test_multihost.py on the
port); ``local_row_range`` tiles the image; an explicit coordinator that
cannot be joined raises, and the environment-driven form with no
coordinator is a single-process no-op."""

import hashlib
import json
import os
import socket
import subprocess
import sys

import pytest
import torch

from fractal_tpu_torch import render_u8
from fractal_tpu_torch.config import Scene, scene_defaults
from fractal_tpu_torch.models.fern import render_fern
from fractal_tpu_torch.parallel import multihost

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def cluster():
    env = dict(os.environ, FRACTAL_TPU_PLATFORM="cpu", OMP_NUM_THREADS="2")
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-m", "fractal_tpu_torch.tools.dryrun_mesh", "4",
                          "--ranks", "2"], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [json.loads(s) for s in out.stdout.strip().splitlines()]
    return lines[:-1], lines[-1]


def test_two_rank_cluster_forms(cluster):
    ranks, summary = cluster
    assert summary == {"ranks": 2, "shards": 4, "same_across_ranks": True,
                       "row_ranges_tile": True, "ok": True}
    assert sorted(r["rank"] for r in ranks) == [0, 1]
    assert all(r["status"] == "joined" and r["ranks"] == 2 and r["shards"] == 4
               for r in ranks)


def test_fern_hits_reduce_across_ranks_bit_equal(cluster):
    fern = scene_defaults("fern").replace(width=48, height=48, iterations=20_000)
    want = hashlib.sha256(render_fern(fern, "cpu").numpy().tobytes()).hexdigest()
    assert {r["fern_sha"] for r in cluster[0]} == {want}


def test_escape_stripes_across_ranks_equal_one_device(cluster):
    esc = Scene(width=64, height=44, iterations=96, pos=(-0.6, 0.0), scale=(0.4, 0.4),
                precision="ds32")
    want = int(render_u8(esc, "cpu").to(torch.int64).sum())
    assert {r["escape_sum"] for r in cluster[0]} == {want}
    assert len({r["perturb_sha"] for r in cluster[0]}) == 1
    assert len({r["sweep_sha"] for r in cluster[0]}) == 1


def test_row_ranges_tile_the_image(cluster):
    ranges = sorted(tuple(r["row_range"]) for r in cluster[0])
    assert ranges == [(0, 22), (22, 44)]


def test_single_process_helpers(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    multihost.initialize()
    assert multihost.status().startswith("single-host")
    assert not multihost.is_multihost()
    assert multihost.process_count() == 1 and multihost.process_index() == 0
    assert multihost.local_row_range(37) == (0, 37)


def test_explicit_coordinator_failure_raises():
    """Rank 1 of 2 at a port where no rank 0 listens: the join times out
    and raises, naming the coordinator."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    with pytest.raises(RuntimeError, match=f"coordinator '127.0.0.1:{port}'"):
        multihost.initialize(f"127.0.0.1:{port}", num_processes=2, process_id=1,
                             initialization_timeout=3)
    assert not multihost.is_multihost()
