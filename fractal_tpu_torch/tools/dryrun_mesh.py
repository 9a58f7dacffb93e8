"""A dry run of the mesh: the renders of the JAX package's multi-device
dry run (``__graft_entry__.py``'s ``dryrun_multichip``) on an N-shard
mesh, each held against its one-device render.

    python -m fractal_tpu_torch.tools.dryrun_mesh N [--ranks R]

On one process the mesh is N shards on the device (``FRACTAL_TPU_PLATFORM``
as for the CLI: unset renders on the CUDA card, ``cpu`` on the CPU).  With
``--ranks R`` it starts R rank processes that join a gloo process group on a
free local port, each with N / R shards, and checks that every rank
returns the same images; on the card the kernels are built here first, so
the ranks only load them.  Every rank process has a time limit.  Prints one
JSON line a rank and, last, the run's.  Exits 1 where a check fails.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import socket
import subprocess
import sys

#: Seconds a rank process may take.
RANK_TIMEOUT_S = 120


def _sha(img) -> str:
    return hashlib.sha256(img.cpu().numpy().tobytes()).hexdigest()


def _clear_caches() -> None:
    from fractal_tpu_torch.ops import perturb

    for name, val in vars(perturb).items():
        if name.endswith("_CACHE") and isinstance(val, dict):
            val.clear()


def body(shards: int, device) -> dict:
    """The dry run's renders on a mesh of ``shards`` shards of this process
    (of every rank's, under ranks), each asserted equal to its one-device
    render on ``device``.  Returns what the ranks compare."""
    import numpy as np
    import torch

    from fractal_tpu_torch import animate, tiled
    from fractal_tpu_torch.config import Scene, scene_defaults
    from fractal_tpu_torch.models.fern import render_fern
    from fractal_tpu_torch.parallel import multihost, sharding
    from fractal_tpu_torch.render import render_u8

    device = torch.device(device)
    mesh = sharding.make_mesh(local=(device,) * shards)
    out = {"rank": multihost.process_index(), "ranks": multihost.process_count(),
           "status": multihost.status(), "shards": mesh.size}

    scene = Scene(width=64, height=48, iterations=32, pos=(-0.7436447860, 0.1318252536),
                  scale=(1e6, 1e6))
    img = sharding.render_escape_sharded(scene, mesh, precision="ds32")
    assert tuple(img.shape) == (48, 64, 3) and img.dtype == torch.uint8
    assert torch.equal(img, render_u8(scene.replace(precision="ds32"), device))
    esc = Scene(width=64, height=44, iterations=96, pos=(-0.6, 0.0), scale=(0.4, 0.4),
                precision="ds32")
    img = sharding.render_escape_sharded(esc, mesh)
    assert torch.equal(img, render_u8(esc, device))
    out["escape_sum"] = int(img.to(torch.int64).sum())
    out["row_range"] = list(multihost.local_row_range(esc.height))

    fern = scene_defaults("fern").replace(width=48, height=48, iterations=20_000)
    fimg = sharding.render_fern_sharded(fern, mesh)
    assert tuple(fimg.shape) == (48, 48, 3) and fimg.dtype == torch.uint8
    assert tuple(fimg[0, 0].tolist()) == (240, 240, 240)
    assert torch.equal(fimg, render_fern(fern, device)), "the sharded fern differs"
    out["fern_sha"] = _sha(fimg)

    deep = Scene(width=32, height=24, iterations=100,
                 pos=(-0.74364388703715871, 0.13182590420531198), scale=(1e15, 1e15),
                 precision="perturb")
    for fast in (False, True):
        _clear_caches()
        pimg = sharding.render_perturb_sharded(deep, mesh, fast=fast)
        _clear_caches()
        want = render_u8(deep.replace(precision="p32" if fast else "perturb"), device)
        assert tuple(pimg.shape) == (24, 32, 3) and torch.equal(pimg, want)
        out["p32_sha" if fast else "perturb_sha"] = _sha(pimg)

    cs = animate.julia_c_path(np.linspace(0.0, 1.0, 4, endpoint=False))
    sweep = [Scene(algo="julia", width=32, height=24, iterations=24,
                   julia_set=(float(a), float(b)), pos=(0.0, 0.0), scale=(0.4, 0.4))
             for a, b in cs]
    frames = animate.render_sweep(sweep, mesh=mesh)
    assert frames.shape == (4, 24, 32, 3)
    assert np.array_equal(frames, animate.render_sweep(sweep, device=device))
    out["sweep_sha"] = hashlib.sha256(frames.tobytes()).hexdigest()

    band = Scene(width=48, height=37, iterations=64, pos=(-0.7436447860, 0.1318252536),
                 scale=(1e6, 1e6), precision="ds32")
    banded = tiled.render_tiled(band, 16, mesh=mesh)
    assert np.array_equal(banded, render_u8(band, device).cpu().numpy())
    out["ok"] = True
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(shards: int, ranks: int, device: str) -> dict:
    """R rank processes over gloo; every rank's line, and their agreement."""
    if device == "cuda":
        from fractal_tpu_torch.ops import _cuda_build, native_walk

        _cuda_build.load()
        native_walk.available()
    coordinator = f"127.0.0.1:{_free_port()}"
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "fractal_tpu_torch.tools.dryrun_mesh", str(shards),
         "--ranks", str(ranks), "--rank", str(r), "--coordinator", coordinator],
        cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(ranks)]
    lines, errors = [], []
    try:
        for r, p in enumerate(procs):
            try:
                stdout, stderr = p.communicate(timeout=RANK_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                errors.append(f"rank {r} timed out after {RANK_TIMEOUT_S} s")
                continue
            if p.returncode != 0:
                errors.append(f"rank {r} exited {p.returncode}: {stderr[-2000:]}")
                continue
            lines.append(json.loads(stdout.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for line in lines:
        print(json.dumps(line), flush=True)
    if errors:
        raise RuntimeError("; ".join(errors))
    keys = ("escape_sum", "fern_sha", "perturb_sha", "p32_sha", "sweep_sha")
    same = all(line[k] == lines[0][k] for line in lines for k in keys)
    ranges = sorted(tuple(line["row_range"]) for line in lines)
    tiles = (ranges[0][0] == 0 and ranges[-1][1] == 44
             and all(a[1] == b[0] for a, b in zip(ranges, ranges[1:])))
    return {"ranks": ranks, "shards": shards, "same_across_ranks": same,
            "row_ranges_tile": tiles, "ok": same and tiles}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m fractal_tpu_torch.tools.dryrun_mesh",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("shards", type=int, help="Shards of the mesh, across every rank.")
    p.add_argument("--ranks", type=int, default=1, help="Rank processes (gloo).")
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--coordinator", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.ranks < 1 or args.shards < args.ranks or args.shards % args.ranks:
        p.error("the shards must split evenly over at least one rank")
    from fractal_tpu_torch.__main__ import platform_device

    device = platform_device()
    if args.rank is None and args.ranks > 1:
        result = _launch(args.shards, args.ranks, device)
    else:
        if args.rank is not None:
            from fractal_tpu_torch.parallel import multihost

            multihost.initialize(args.coordinator, args.ranks, args.rank,
                                 initialization_timeout=RANK_TIMEOUT_S)
        result = body(args.shards // args.ranks, device)
    print(json.dumps(result), flush=True)
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
