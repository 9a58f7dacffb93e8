"""The δ-orbit kernels B, C and D at the shapes the main path gives them,
timed by CUDA events, optionally held bit-equal to their plain versions.

    python fractal_tpu_torch/tools/delta_bench.py [--root TREE] [--check]

``--root`` imports ``fractal_tpu_torch`` from another checkout (an unpacked
``git archive`` of a parent commit), so two versions of the kernels are
timed by one script on one card: run parent, change, change, parent on one
machine and compare within that run.  The shapes are ``chip_smoke.py``'s:
kernel B's glitch form over dz1e12 (3000×3000 @1e12×, 4000), kernel C over
dz1e12's flagged list against its first multiref reference and on that
list's longest pixel alone (one thread: the chain's own time, printed in
cycles a step at the SM clock under load), kernel B's dist-only form over
the 3000×3000 p32 headline, kernel D's grid form over fe1e44 (768×512
@1e44×, 2000) and its points form over fe1e44's flagged list against its
first multiref reference, and kernel H at the fern's main-path launch (one
64-step batch of fern_100m's stream, 4,194,304 points into 4,000,000 bins)
and at fern_10m's (the same count into 375,000 bins).  ``--check`` also
compares every output with the plain version and prints the warp
efficiency of the grid launches (``utils/divergence``).  Prints one JSON
line of milliseconds last.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import subprocess
import sys

SEAHORSE = (-0.74364388703715871, 0.13182590420531198)
NEEDLE_X = "-1.999999999999999999999999999999999999999999991"
VIEWS = {
    "headline": dict(width=3000, height=3000, iterations=4000, pos=(-0.7436447860, 0.1318252536),
                     scale=(1e6, 1e6), exposure=5.0, inside=False, precision="p32"),
    "dz1e12": dict(width=3000, height=3000, iterations=4000, pos=SEAHORSE, scale=(1e12, 1e12),
                   inside=False),
    "p1e15": dict(width=1920, height=1080, iterations=5000, pos=SEAHORSE, scale=(1e15, 1e15),
                  inside=False),
    "fe1e44": dict(width=768, height=512, iterations=2000, pos_str=(NEEDLE_X, "0.0"),
                   scale=(1e44, 1e44), inside=False),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), help="checkout to import fractal_tpu_torch from")
    ap.add_argument("--check", action="store_true",
                    help="compare with the plain versions; print warp efficiencies")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("delta_bench needs a CUDA card")
    render = importlib.import_module("fractal_tpu_torch.render")
    from fractal_tpu_torch.config import Scene, scene_defaults
    from fractal_tpu_torch.ops import _cuda_build, perturb, perturb_cuda
    from fractal_tpu_torch.utils.timing import card_line, event_ms

    if args.check:  # the parent commits of the port have no divergence helper
        from fractal_tpu_torch.utils.divergence import TILES, pixel_steps, warp_efficiency
    card = card_line()
    _cuda_build.load()
    print(f"{args.root} on {card}", flush=True)
    if hasattr(_cuda_build, "kernel_resources"):
        for name, regs, spill in _cuda_build.kernel_resources(_cuda_build.BUILD_INFO["log"]):
            if "perturb" in name:
                print(f"ptxas: {name}: {regs} registers, {spill} bytes of spill stores",
                      flush=True)
    dev = "cuda"
    out, eff = {}, {}

    def same(k, p, what):
        torch.cuda.synchronize()
        eq = all(torch.equal(a.view(torch.int32) if a.dtype == torch.float32 else a,
                             b.view(torch.int32) if b.dtype == torch.float32 else b)
                 for a, b in zip(k, p))
        print(f"{what}: bit-equal to the plain version: {eq}", flush=True)
        if not eq:
            raise SystemExit(f"{what} differs from its plain version")

    def efficiency(name, steps):
        eff[name] = {f"{tw}x{th}": warp_efficiency(steps, (tw, th)) for tw, th in TILES}
        print(f"warp efficiency {name}: {eff[name]}", flush=True)

    def first_ref_and_flags(name):
        """A cold render of ``name`` (filling the multiref cache), then its
        setup, the main grid's flags and the first multiref reference."""
        sc = Scene(**VIEWS[name])
        for key, val in vars(perturb).items():
            if key.endswith("_CACHE") and isinstance(val, dict):
                val.clear()
        render.render_u8(sc, dev)
        pack = perturb._MULTIREF_CACHE.get(perturb._orbit_key(sc, ("multiref",), sc.width,
                                                              sc.height))
        return sc, perturb.perturb_setup(sc, dev), pack[0]

    # kernel B's glitch form and kernel C at dz1e12
    sc, st, ref = first_ref_and_flags("dz1e12")
    kw = dict(iterations=sc.iterations, height=st.height, width=st.width)
    ms, k = event_ms(lambda: perturb_cuda.perturb_full(st.table, st.gtol, st.P, st.n_steps, **kw),
                     args.reps)
    out["perturb_full"] = ms
    if args.check:
        same(k, perturb_cuda.perturb_full_plain(st.table, st.gtol, st.P, st.n_steps, **kw),
             "kernel B glitch dz1e12")
        efficiency("B glitch dz1e12",
                   pixel_steps(*k, int(st.P[8].item()), st.n_steps, float(sc.limit)))
    idx = torch.nonzero(k[3].reshape(-1)).squeeze(1)
    xs, ys = (idx % st.width).float(), (idx // st.width).float()
    table, gtol, P, n_steps = ref
    ckw = dict(iterations=sc.iterations)
    ms, k = event_ms(lambda: perturb_cuda.perturb_points(table, gtol, P, n_steps, xs, ys, **ckw),
                     args.reps)
    out["perturb_points"] = ms
    out["c_pixels"] = idx.numel()
    if args.check:
        same(k, perturb_cuda.perturb_points_plain(table, gtol, P, n_steps, xs, ys, **ckw),
             f"kernel C, {idx.numel()} px")
    # the list's longest pixel alone: one thread, nothing to contend with
    n0 = int(P[8].item())
    esc = (k[0].double() ** 2 + k[1].double() ** 2 > float(sc.limit) ** 2) | \
        ((k[3] != 0) & (k[2] < n_steps))
    steps = (k[2].long() - n0).clamp(min=0) + esc.long()
    top = int(steps.argmax())
    ms1, _ = event_ms(lambda: perturb_cuda.perturb_points(table, gtol, P, n_steps,
                                                          xs[top:top + 1], ys[top:top + 1],
                                                          **ckw), args.reps)
    for _ in range(30):
        perturb_cuda.perturb_points(table, gtol, P, n_steps, xs, ys, **ckw)
    mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                                "--format=csv,noheader,nounits"], capture_output=True,
                               text=True, timeout=60).stdout.split()[0])
    torch.cuda.synchronize()
    out["perturb_points_one_pixel"] = ms1
    out["c_longest_steps"] = int(steps[top])
    out["sm_clock_mhz"] = mhz
    cyc = 1e3 * mhz / int(steps[top])
    print(f"kernel C: {idx.numel()} px {ms:.4f} ms = {ms * cyc:.1f} cycles a step of the longest "
          f"pixel ({int(steps[top])} steps from n0 {n0}); that pixel alone {ms1:.4f} ms = "
          f"{ms1 * cyc:.1f} cycles a step at {mhz:.0f} MHz", flush=True)
    if args.check:
        sc = Scene(**VIEWS["p1e15"])
        st = perturb.perturb_setup(sc, dev)
        k = perturb_cuda.perturb_full(st.table, st.gtol, st.P, st.n_steps,
                                      iterations=sc.iterations, height=st.height, width=st.width)
        efficiency("B glitch p1e15",
                   pixel_steps(*k, int(st.P[8].item()), st.n_steps, float(sc.limit)))

    # kernel B's dist-only form at the p32 headline
    sc = Scene(**VIEWS["headline"])
    st = perturb.perturb_setup(sc, dev)
    bkw = dict(height=st.height, width=st.width)
    ms, k = event_ms(lambda: perturb_cuda.perturb_dist(st.table, st.P, st.n_steps, **bkw),
                     args.reps)
    out["perturb_dist"] = ms
    if args.check:
        same(k, perturb_cuda.perturb_dist_plain(st.table, st.P, st.n_steps, **bkw),
             "kernel B dist-only headline")
        d, cnt = k
        esc = (d > float(sc.limit) ** 2).long()
        efficiency("B dist headline p32", (cnt.long() + esc - int(st.P[8].item())).clamp(min=0))

    # kernel D's two forms at fe1e44
    sc, st, ref = first_ref_and_flags("fe1e44")
    kw = dict(iterations=sc.iterations, height=st.height, width=st.width)
    ms, k = event_ms(lambda: perturb_cuda.perturb_fe_full(st.table, st.gtol, st.P, st.n_steps,
                                                          **kw), args.reps)
    out["perturb_fe_full"] = ms
    if args.check:
        same(k, perturb_cuda.perturb_fe_full_plain(st.table, st.gtol, st.P, st.n_steps, **kw),
             "kernel D grid fe1e44")
    idx = torch.nonzero(k[3].reshape(-1)).squeeze(1)
    xs, ys = (idx % st.width).float(), (idx // st.width).float()
    table, gtol, P, n_steps = ref
    ms, k = event_ms(lambda: perturb_cuda.perturb_fe_points(table, gtol, P, n_steps, xs, ys,
                                                            iterations=sc.iterations), args.reps)
    out["perturb_fe_points"] = ms
    out["d_pixels"] = idx.numel()
    if args.check:
        same(k, perturb_cuda.perturb_fe_points_plain(table, gtol, P, n_steps, xs, ys,
                                                     iterations=sc.iterations),
             f"kernel D points, {idx.numel()} px")
    # kernel H at the fern's main-path launch
    from fractal_tpu_torch.models import fern
    from fractal_tpu_torch.ops import hist_cuda
    from fractal_tpu_torch.tools import fern_hist

    s10 = scene_defaults("fern").replace(width=750, height=500, iterations=10_000_000)
    streams = {"hist": fern_hist.fern_100m_stream(fern.STEP_BATCH, dev),
               "hist_fern_10m": (fern_hist.walk_stream(
                   s10, 750, 500, fern.DEFAULT_WALKERS, fern.STEP_BATCH, s10.seed,
                   burn_in=fern._burn_in(s10, 750, 500), device=dev), 750 * 500)}
    for key, (idx, n_bins) in streams.items():
        hist = torch.zeros(n_bins, dtype=torch.int32, device=dev)
        ms, _ = event_ms(lambda: hist_cuda.hist_accumulate(idx, hist), args.reps * 2)
        out[key] = ms
        if args.check:
            same([hist_cuda.hist_accumulate(idx, torch.zeros_like(hist))],
                 [hist_cuda.hist_accumulate_plain(idx, torch.zeros_like(hist))],
                 f"kernel H, {idx.numel()} points into {n_bins} bins")
    print(json.dumps({"root": args.root, "card": card, "ms": out, "warp_efficiency": eff}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
