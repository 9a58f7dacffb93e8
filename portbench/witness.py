"""A second witness where a cell's frames fail the check: the program's other
tiers and 60-digit mpmath, at the frame's own size.

    python3 -m portbench.witness --config <name> --traffic <mix> --seed <n> [--pixels 8]

The configuration and the mix are found by name (``portbench/configs/``,
``portbench/traffic/``), so a cell left out of ``BENCHMARK.json`` can be
looked at.  Renders the seed's first frame after the warm-up through the
program in its
own tier, in ``dd64`` (kernel A's double-double form, no perturbation) and
in ``p32``, and holds each image against the reference as the check does;
then, at ``--pixels`` pixels where the program's own tier and the reference
disagree, prints the reference's count beside 60-digit mpmath's and the
three images' pixels.  Prints JSON lines.
"""

from __future__ import annotations

import argparse
import json
import sys
from fractions import Fraction

import numpy as np
import torch

from portbench import compare, generator, reference
from portbench.harness import ROOT, load_json, scene_of
from portbench.reference import mandelbrot
from portbench.reference.viewport import affine


def mpmath_count(c_re: Fraction, c_im: Fraction, iterations: int, limit: float) -> int:
    """The count of one pixel at 60 digits: z = c, step i escapes with count
    i where |z|^2 > limit^2."""
    import mpmath as mp

    with mp.workdps(60):
        cr = mp.mpf(c_re.numerator) / c_re.denominator
        ci = mp.mpf(c_im.numerator) / c_im.denominator
        zr, zi, lim = cr, ci, mp.mpf(limit) ** 2
        for i in range(iterations):
            zr, zi = zr * zr - zi * zi + cr, 2 * zr * zi + ci
            if zr * zr + zi * zi > lim:
                return i
        return iterations


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--pixels", type=int, default=8)
    args = ap.parse_args(argv)
    device = "cuda" if torch.cuda.is_available() else "cpu"
    from fractal_tpu_torch.render import render

    scene = load_json(ROOT / "portbench" / "configs" / f"{args.config}.json")["scene"]
    mix = generator.load(generator.mix_path(ROOT, args.traffic))
    frame = generator.frames(scene, mix, args.seed, 1)[int(mix.get("warmup", 1))]
    state = reference.counts(frame, device)
    cnt = state[0]
    ref = reference.image(frame, *state)
    imgs = {}
    for tier in (frame["precision"], "dd64", "p32"):
        imgs[tier] = torch.from_numpy(render(scene_of(dict(frame, precision=tier)), device))
        print(json.dumps({"config": args.config, "traffic": args.traffic, "seed": args.seed,
                          "tier": tier,
                          "numbers": compare.numbers(imgs[tier], ref, frame, state,
                                                     mandelbrot.distance)}), flush=True)
    bad = (mandelbrot.distance(imgs[frame["precision"]], ref, state, frame).amax(-1)
           > compare.TOL).cpu()
    ys, xs = np.nonzero(bad.numpy())
    pick = generator.rng(args.seed, 2).permutation(len(ys))[:args.pixels]
    (ar, cr), (ai, ci) = affine(frame)
    for j in pick:
        y, x = int(ys[j]), int(xs[j])
        print(json.dumps({
            "pixel": [x, y], "reference_count": int(cnt[y, x]),
            "mpmath_count": mpmath_count(ar * x + cr, ai * y + ci, frame["iterations"],
                                         frame["limit"]),
            "reference_rgb": ref[y, x].tolist(),
            **{f"{t}_rgb": im[y, x].tolist() for t, im in imgs.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
