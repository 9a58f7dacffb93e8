"""How exact the exact perturbation tier is at a deep view and at its pans,
against kernel A's dd64 form and 50-digit mpmath (CUDA only).

    python -m fractal_tpu_torch.tools.exact_check [--pans 3] [--samples 10]

At dz1e12's centre (1920x1080 @1e12x, 4000 iterations, interior black) the
view and each 32-pixel pan after it (one 60 ms arrow-key tick of the
viewer, ``viewer.apply_nav``) render twice through ``render_u8(scene,
"cuda")``, as the viewer's frame and a still after it would.  The exact
tier's counts are read where it colors them (``ops/perturb._color``,
wrapped here) and held against the counts of ``escape_time_dd64`` without
periodicity on the same pixels; pixels where the two renders or a render
and dd64 disagree are sampled against 50-digit mpmath.
"""

from __future__ import annotations

import argparse
import importlib
import sys
import time
from fractions import Fraction

import numpy as np

SEAHORSE = ("-0.74364388703715871", "0.13182590420531198")
PAN = (0.03, 0.0)


def mpmath_count(cr: Fraction, ci: Fraction, iterations: int, limit: float) -> int:
    """The escape count of c = cr + i ci at 50 digits (z starts at c; step i
    escapes with count i when |z|^2 > limit^2)."""
    import mpmath as mp

    with mp.workdps(50):
        c_r = mp.mpf(cr.numerator) / cr.denominator
        c_i = mp.mpf(ci.numerator) / ci.denominator
        zr, zi, lim_sq = c_r, c_i, mp.mpf(limit) ** 2
        for i in range(iterations):
            zr, zi = zr * zr - zi * zi + c_r, 2 * zr * zi + c_i
            if zr * zr + zi * zi > lim_sq:
                return i
        return iterations


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pans", type=int, default=3)
    ap.add_argument("--samples", type=int, default=10)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 1
    from fractal_tpu_torch import viewer
    from fractal_tpu_torch.config import Scene, exact_pos
    from fractal_tpu_torch.ops import escape_cuda, perturb, viewport
    from fractal_tpu_torch.utils.timing import card_line

    render = importlib.import_module("fractal_tpu_torch.render")
    print(card_line(), flush=True)
    seen = {}
    color = perturb._color

    def keep_counts(scene, zr, zi, cnt):
        seen["cnt"] = cnt.cpu().numpy()
        return color(scene, zr, zi, cnt)

    perturb._color = keep_counts
    sc = Scene(width=1920, height=1080, iterations=4000, exposure=5.0, inside=False,
               pos_str=SEAHORSE, scale=(1e12, 1e12))
    rng = np.random.default_rng(10)
    totals = {"first": 0, "second": 0, "dd64": 0, "sampled": 0}
    try:
        for view in range(args.pans + 1):
            if view:
                sc = viewer.apply_nav(sc, pan=PAN)
            runs = []
            for _ in range(2):
                render.render_u8(sc, "cuda")
                runs.append((seen["cnt"], dict(perturb.RENDER_STATS)))
            params = escape_cuda.scene_params(sc, device="cuda", dtype=torch.float64)
            dd = escape_cuda.iterate_params(params, algo=sc.algo, power=sc.power,
                                            iterations=sc.iterations, precision="dd64",
                                            height=sc.height, width=sc.width)[2].cpu().numpy()
            (c1, s1), (c2, s2) = runs
            n = c1.size
            print(f"{'centre' if view == 0 else f'pan {view}'}: glitch {s1['n_glitch']} / "
                  f"{s2['n_glitch']}, residual {int(s1['n_residual'])} / "
                  f"{int(s2['n_residual'])}; counts: first != second {int((c1 != c2).sum())}, "
                  f"first != dd64 {int((c1 != dd).sum())} ({int((abs(c1 - dd) > 1).sum())} by "
                  f"more than 1), second != dd64 {int((c2 != dd).sum())} of {n}", flush=True)
            bad = (c1 != c2) | (c1 != dd) | (c2 != dd)
            ys, xs = np.nonzero(bad)
            if not len(xs):
                continue
            (Ar, Cr), (Ai, Ci) = viewport.affine_fractions(sc.width, sc.height, exact_pos(sc),
                                                           sc.scale)
            t0 = time.perf_counter()
            pick = rng.choice(len(xs), min(args.samples, len(xs)), replace=False)
            rows = []
            for j in pick:
                y, x = int(ys[j]), int(xs[j])
                m = mpmath_count(Ar * x + Cr, Ai * y + Ci, sc.iterations, sc.limit)
                rows.append((y, x, int(c1[y, x]), int(c2[y, x]), int(dd[y, x]), m))
            for key, col in (("first", 2), ("second", 3), ("dd64", 4)):
                totals[key] += sum(r[col] == r[5] for r in rows)
            totals["sampled"] += len(rows)
            print(f"  (y, x, first, second, dd64, mpmath): {rows} "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
    finally:
        perturb._color = color
    print(f"sampled pixels where the counts disagree: {totals['sampled']}; 50-digit mpmath "
          f"equals the first render on {totals['first']}, the second on {totals['second']}, "
          f"dd64 on {totals['dd64']}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
