"""Kernel H on the fern's real point stream, beside PyTorch's own histogram
calls (counterpart of ``tools/fern_hist_pallas.py``).

The stream is the production walk's (``models/fern.walk_stream``): flat bin
indices with the drop sentinel W·H for off-image points, resident on the
device, so every timing weighs the same duplicate structure the renders
meet.  Kernel H (``ops/hist_cuda.hist_accumulate``) is timed against
``torch.bincount`` and ``index_add_`` on the same stream; both are
yardsticks only, the port renders through kernel H.  ``diagnose`` times
kernel H on the batch as walked, on distinct bins and on the batch sorted
by bin.

Run on the card:           python -m fractal_tpu_torch.tools.fern_hist
Correctness on the CPU:    python -m fractal_tpu_torch.tools.fern_hist --check
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from fractal_tpu_torch.config import scene_defaults
from fractal_tpu_torch.models import fern
from fractal_tpu_torch.ops import hist_cuda
from fractal_tpu_torch.utils.timing import card_line, event_ms

FERN_100M = dict(width=2000, height=2000, iterations=100_000_000)


def walk_stream(scene, width: int, height: int, k: int, steps: int, seed: int,
                burn_in: int = 64, *, device="cuda") -> torch.Tensor:
    """(steps, k) int32 plot indices of the production walk's replica 0 on
    ``device``: the stream the render's histogram consumes."""
    return torch.cat(list(fern.walk_stream(scene, width, height, k, steps, seed, burn_in,
                                           device=device)))


def bincount_hist(idx, n_bins: int):
    """``torch.bincount`` over the stream; the sentinel lands in an extra
    bin that is cut off (the stream holds no negative index)."""
    return torch.bincount(idx.reshape(-1), minlength=n_bins + 1)[:n_bins]


def index_add_hist(idx, n_bins: int, ones):
    """``index_add_`` of ones over the stream into n_bins + 1 bins."""
    hist = torch.zeros(n_bins + 1, dtype=torch.int32, device=idx.device)
    return hist.index_add_(0, idx.reshape(-1), ones)[:n_bins]


def check() -> None:
    """Kernel H's plain version == np.bincount on a small real stream with
    the drop sentinel, and with negative indices mixed in."""
    scene = scene_defaults("fern").replace(width=200, height=200, iterations=100_000)
    w, h = scene.width, scene.height
    idx = walk_stream(scene, w, h, 1024, 12, scene.seed,
                      burn_in=fern._burn_in(scene, w, h), device="cpu").reshape(-1)
    idx = torch.cat([idx, torch.tensor([-1, -7, w * h, w * h + 5], dtype=torch.int32)])
    n_bins = w * h
    flat = idx.numpy()
    ref = np.bincount(flat[(flat >= 0) & (flat < n_bins)], minlength=n_bins).astype(np.int32)
    got = hist_cuda.hist_accumulate_plain(idx, torch.zeros(n_bins, dtype=torch.int32)).numpy()
    differ = int((got != ref).sum())
    if differ:
        raise SystemExit(f"plain histogram != np.bincount: {differ} bins differ")
    print(f"plain-version parity: OK ({idx.numel()} points, {n_bins} bins, "
          f"{int((flat == n_bins).sum())} sentinels)")


def duplicate_fraction(idx, n_bins: int, per: int) -> float:
    """Mean share of a batch's in-image points that repeat a bin already hit
    within the batch, over batches of ``per`` points of the stream: what a
    per-batch merge of duplicates could save at most."""
    flat = idx.reshape(-1)
    flat = flat[: (flat.numel() // per) * per].reshape(-1, per)
    fracs = []
    for batch in flat:
        kept = batch[batch < n_bins]
        fracs.append(1.0 - torch.unique(kept).numel() / max(kept.numel(), 1))
    return float(np.mean(fracs))


def fern_stream(steps: int, device="cuda", **scene_kw):
    """(``steps`` steps of the walk's stream of the fern scene
    ``scene_kw``, resident on ``device``; its number of bins, supersampled
    where the scene is)."""
    scene = scene_defaults("fern").replace(**scene_kw)
    w, h = scene.width * scene.supersample, scene.height * scene.supersample
    idx = walk_stream(scene, w, h, fern.DEFAULT_WALKERS, steps, scene.seed,
                      burn_in=fern._burn_in(scene, w, h), device=device)
    return idx, w * h


def fern_100m_stream(steps: int, device="cuda"):
    """(``steps`` steps of the fern_100m walk's stream, resident on
    ``device``; its number of bins)."""
    return fern_stream(steps, device, **FERN_100M)


def diagnose(idx, n_bins: int, seed: int = 0) -> dict:
    """Kernel H on one launch of ``idx`` (the main path's batch) in three
    streams of its point count: (a) the batch as the walk made it, (b)
    distinct bins in a seeded random order (every bin once where the count
    allows: the L2's pure reduction rate), (c) the batch sorted by bin
    (neighbouring threads on one bin: the worst contention).  Beside them
    the duplicate fractions within 32 neighbouring points and within the
    batch."""
    flat = idx.reshape(-1).contiguous()
    n = flat.numel()
    perm = torch.from_numpy(np.random.default_rng(seed).permutation(n) % n_bins)
    streams = {"real": flat, "distinct": perm.to(torch.int32).to(flat.device),
               "sorted": torch.sort(flat).values.contiguous()}
    out = {"card": card_line(), "points": n, "n_bins": n_bins}
    hist = torch.zeros(n_bins, dtype=torch.int32, device=flat.device)
    for name, s in streams.items():
        ms, _ = event_ms(lambda: hist_cuda.hist_accumulate(s, hist), reps=10)
        out[f"{name}_ms"] = ms
    kept = flat[(flat >= 0) & (flat < n_bins)]
    out["dup_fraction_warp"] = duplicate_fraction(flat[: fern.DEFAULT_WALKERS], n_bins, 32)
    out["dup_fraction_batch"] = 1.0 - torch.unique(kept).numel() / max(kept.numel(), 1)
    print(f"# kernel H on {n} points into {n_bins} bins: " + ", ".join(
        f"{k[:-3]} {v:.4f} ms" for k, v in out.items() if k.endswith("_ms")) +
        "; duplicate fraction within 32 neighbouring points "
        f"{out['dup_fraction_warp']:.4f}, within the batch {out['dup_fraction_batch']:.4f}",
        flush=True)
    return out


def measure(idx, n_bins: int) -> dict:
    """Kernel H in the render's launches (one per ``fern.STEP_BATCH`` steps,
    into a histogram that is not zeroed between them), ``torch.bincount``
    and ``index_add_`` on the resident stream ``idx``: ms by CUDA events,
    ns/point, equality with ``torch.bincount``, the bins a launch touches
    (summed over the launches) and the duplicate fractions."""
    n = idx.numel()
    out = {"card": card_line(), "points": n, "n_bins": n_bins}
    batches = list(idx.split(fern.STEP_BATCH))

    def kernel_h(hist):
        for b in batches:
            hist_cuda.hist_accumulate(b, hist)
        return hist

    scratch = torch.zeros(n_bins, dtype=torch.int32, device=idx.device)
    ones = torch.ones(n, dtype=torch.int32, device=idx.device)
    ref = bincount_hist(idx, n_bins)
    for name, fn in (("kernel_h", lambda: kernel_h(scratch)),
                     ("bincount", lambda: bincount_hist(idx, n_bins)),
                     ("index_add", lambda: index_add_hist(idx, n_bins, ones))):
        ms, got = event_ms(fn, reps=10)
        if name == "kernel_h":  # the timed calls piled onto one histogram
            got = kernel_h(torch.zeros_like(scratch))
        out[f"{name}_ms"] = ms
        out[f"{name}_ns_per_point"] = ms * 1e6 / n
        out[f"{name}_parity"] = bool(torch.equal(got.long(), ref.long()))
        print(f"# {name}: {ms:.4f} ms ({ms * 1e6 / n:.4f} ns/point), equal to bincount: "
              f"{out[f'{name}_parity']}", flush=True)
    out["kernel_h_launches"] = len(batches)
    out["bins_touched"] = sum(torch.unique(b[b < n_bins]).numel() for b in batches)
    dup_steps = min(idx.shape[0], fern.STEP_BATCH)
    out["dup_fraction_batch"] = duplicate_fraction(idx[:dup_steps], n_bins,
                                                   idx[:dup_steps].numel())
    out["dup_fraction_warp"] = duplicate_fraction(idx[:1], n_bins, 32)
    print(f"# {out['kernel_h_launches']} launch(es) touch {out['bins_touched']} bins; "
          f"duplicate fraction within a {dup_steps}-step batch: "
          f"{out['dup_fraction_batch']:.4f}; within 32 neighbouring points: "
          f"{out['dup_fraction_warp']:.4f}", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--check", action="store_true",
                    help="hold the plain version against np.bincount on the CPU")
    ap.add_argument("--steps", type=int, default=320,
                    help="walk steps (x65536 walkers) of the resident stream")
    args = ap.parse_args(argv)
    if args.check:
        check()
        return 0
    if not torch.cuda.is_available():
        print("error: the measurement needs a CUDA device", file=sys.stderr)
        return 2
    idx, n_bins = fern_100m_stream(args.steps)
    out = measure(idx, n_bins)
    out["diagnosis"] = diagnose(idx[:fern.STEP_BATCH], n_bins)
    print(json.dumps(out))
    return 0 if all(out[f"{n}_parity"] for n in ("kernel_h", "bincount", "index_add")) else 1


if __name__ == "__main__":
    raise SystemExit(main())
