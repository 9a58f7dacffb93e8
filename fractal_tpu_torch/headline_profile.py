"""Where the headline's time goes on a CUDA card.

    python -m fractal_tpu_torch.headline_profile

Renders the 3000×3000 @1e6× / 4000-iteration Mandelbrot headline
(``bench.py``'s) through ``render_u8(scene, "cuda")`` in the p32 and the
exact (auto → ds32) tier, and prints:

  * the card's name, power limit and SM clocks (nvidia-smi);
  * the kernel build time;
  * each tier's cold render split into its steps, each fenced with
    ``torch.cuda.synchronize()`` — p32: reference selection (f64 walk and,
    when the center escapes early, the ds32 probe on kernel A), the P
    block with the series walk, the orbit table upload, kernel B,
    coloring; exact: the parameter blocks, kernel A colored form.  A small
    render of another view runs first, so that loading PyTorch's own CUDA
    kernels is not counted as the headline's work;
  * per tier, ``torch.profiler`` over one warm render: its wall time, the
    device's busy time (the union of its kernels' intervals), the idle
    share 1 − busy/wall and the kernels that take the most time;
  * per tier, ``WARM`` further warm renders and their p50.

Needs one CUDA card; exits nonzero without one.
"""

from __future__ import annotations

import statistics
import subprocess
import sys
import time
from collections import defaultdict

import torch

from fractal_tpu_torch.config import Scene

HEADLINE = dict(algo="mandelbrot", width=3000, height=3000, iterations=4000,
                pos=(-0.7436447860, 0.1318252536), scale=(1e6, 1e6),
                exposure=5.0, inside=False)
WARM = 7


def _fenced(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip() or f"nvidia-smi failed: {out.stderr.strip()}"


def cold_split_p32(scene: Scene):
    """The steps of ``perturb.render_perturb`` one by one: (image, [(step, ms)])."""
    from fractal_tpu_torch.ops import perturb, perturb_cuda
    from fractal_tpu_torch.render import _color_and_downsample_dist

    h, w = scene.height * scene.supersample, scene.width * scene.supersample
    (ref_px, orbit), t_ref = _fenced(lambda: perturb.resolve_reference(scene, w, h, "cuda"))
    P, t_p = _fenced(lambda: perturb._pert_params(scene, ref_px, w, h, orbit=orbit,
                                                  device="cuda"))
    (table, _), t_tab = _fenced(lambda: perturb._orbit_tensors(orbit, "cuda"))
    (d, cnt), t_k = _fenced(lambda: perturb_cuda.perturb_dist(
        table, P, orbit.n_steps, height=h, width=w, algo=scene.algo, power=scene.power))
    img, t_col = _fenced(lambda: _color_and_downsample_dist(scene, d, cnt))
    return img, [(f"reference selection (ref {ref_px}, n_steps {orbit.n_steps})", t_ref),
                 (f"P block + series walk (P[8] = {float(P[8])})", t_p),
                 ("orbit table upload", t_tab), ("kernel B", t_k), ("coloring", t_col)]


def cold_split_exact(scene: Scene):
    """The steps of the exact tier's ``render._render_escape``: the blocks'
    upload, then kernel A's colored form (at supersample 1; above it the
    three-output form and the coloring)."""
    from fractal_tpu_torch.ops import escape_cuda
    from fractal_tpu_torch.render import _color_and_downsample, resolve_precision

    prec = resolve_precision(scene, "cuda")
    (params, color), t_p = _fenced(lambda: escape_cuda.frame_blocks([scene], "cuda"))
    kw = dict(algo=scene.algo, power=scene.power, iterations=scene.iterations,
              precision=prec, height=scene.height * scene.supersample,
              width=scene.width * scene.supersample, periodicity=not scene.inside)
    if scene.supersample == 1:
        img, t_k = _fenced(lambda: escape_cuda.iterate_color(
            params[0], color[0], inside=scene.inside, smooth=scene.smooth, **kw))
        return img, [("parameter blocks upload", t_p), (f"kernel A ({prec}, colored)", t_k)]
    (zr, zi, cnt), t_k = _fenced(lambda: escape_cuda.iterate_params(params[0], **kw))
    img, t_col = _fenced(lambda: _color_and_downsample(scene, zr, zi, cnt))
    return img, [("parameter blocks upload", t_p), (f"kernel A ({prec})", t_k),
                 ("coloring", t_col)]


def _union_us(intervals) -> float:
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s >= end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def profile_warm(render_once, top: int = 8):
    """torch.profiler over one warm render: (wall ms, busy ms or None,
    [(kernel, ms, calls)])."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall = _fenced(render_once)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        return wall, None, []
    busy = _union_us([(e.time_range.start, e.time_range.end) for e in kernels]) / 1e3
    by_name = defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_name[e.name][0] += e.time_range.elapsed_us() / 1e3
        by_name[e.name][1] += 1
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return wall, busy, [(name, ms, calls) for name, (ms, calls) in ranked]


def main() -> int:
    if not torch.cuda.is_available():
        print("error: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    from fractal_tpu_torch.ops import _cuda_build
    from fractal_tpu_torch.render import render_u8

    print(_card(), flush=True)
    t0 = time.perf_counter()
    _cuda_build.load()
    print(f"kernel build {time.perf_counter() - t0:.2f} s", flush=True)
    _fenced(lambda: render_u8(Scene(width=64, height=64, iterations=50), "cuda"))

    scenes = {"p32": (Scene(**HEADLINE, precision="p32"), cold_split_p32),
              "exact": (Scene(**HEADLINE), cold_split_exact)}
    for tier, (scene, split) in scenes.items():
        img, steps = split(scene)
        total = sum(ms for _, ms in steps)
        print(f"{tier} cold split, {total:.3f} ms in all: "
              + "; ".join(f"{name} {ms:.3f}" for name, ms in steps), flush=True)
        same = torch.equal(img, render_u8(scene, "cuda"))
        print(f"{tier} split image == render_u8 image: {same}", flush=True)
        if not same:
            return 1

    for tier, (scene, _) in scenes.items():
        wall, busy, top = profile_warm(lambda: render_u8(scene, "cuda"))
        if busy is None:
            print(f"{tier} warm render under the profiler: {wall:.3f} ms wall; "
                  f"device time not measured (the profiler saw no kernels)",
                  flush=True)
        else:
            print(f"{tier} warm render under the profiler: {wall:.3f} ms wall, "
                  f"device busy {busy:.3f} ms, idle share {1 - busy / wall:.4f}",
                  flush=True)
        for name, ms, calls in top:
            print(f"  {ms:9.3f} ms  x{calls:<3d} {name[:100]}", flush=True)
        warm = [_fenced(lambda: render_u8(scene, "cuda"))[1] for _ in range(WARM)]
        print(f"{tier} {WARM} warm renders ms: "
              + " ".join(f"{t:.3f}" for t in warm)
              + f"; p50 {statistics.median(warm):.3f}", flush=True)
    print(_card(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
