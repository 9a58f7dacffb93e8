#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Phases, each of which must pass or the script exits nonzero:
  1. the card's name and power limit (nvidia-smi);
  2. the kernel build (nvcc, ``fractal_tpu_torch/csrc/*.cu``), with its time;
  3. the main path: ``render_u8(scene, "cuda")`` on the 3000×3000 @1e6× /
     4000-iteration headline in p32 and in auto (ds32), cold (empty host
     caches) and warm, with both launch counters > 0 afterwards;
  4. kernel A (escape time, f32 and ds32) against its plain torch version
     on the card: zr, zi and cnt bit-equal;
  5. kernel B (dist-only δ-orbit) against its plain version: d and cnt
     bit-equal, on a view whose series skip fires (P[8] > 0), on the
     headline view and on a julia view;
  6. at the headline's shape (3000×3000, 4000 iterations): each kernel's
     time against its plain version's, with the outputs bit-equal, and
     the main path's u8 images bit-equal to the plain route's in both
     tiers; then the same image check at 1000×1000 of the same view.
The line before the last is the per-kernel JSON record; the last line is
``{"ok": true, "device": {...}}``.  No JAX is imported.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import time

A_SRC = "fractal_tpu_torch/csrc/escape.cu"
B_SRC = "fractal_tpu_torch/csrc/perturb.cu"
A_REPLACES = "fractal_tpu/ops/escape_pallas.py:388"
B_REPLACES = "fractal_tpu/ops/perturb.py:1466"


class SmokeFailure(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def bits_equal(a, b) -> bool:
    """Bit-pattern equality (NaN payloads included)."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return bool(torch.equal(a, b))


def max_abs_err(a, b) -> float:
    import torch

    d = (a.double() - b.double()).abs()
    d = torch.where(torch.isnan(d), torch.zeros_like(d), d)
    return float(d.max())


def sync_time(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def event_ms(fn, reps: int = 3):
    """(mean device ms of ``fn`` over ``reps`` runs after one warm-up,
    the last run's output)."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def compare(label: str, k, p, record: dict, key: str, extra: str = "") -> None:
    """Require the kernel's outputs ``k`` bit-equal to the plain version's
    ``p``; fold their largest difference into ``record[key]``."""
    torch_sync()
    err = max(max_abs_err(a, b) for a, b in zip(k, p))
    record[key] = max(record[key], err)
    eq = all(bits_equal(a, b) for a, b in zip(k, p))
    print(f"{label}: bit-equal={eq} max_abs_err={err!r}{extra}", flush=True)
    check(eq, f"the kernel differs from its plain version: {label}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def phase_kernel_a(Scene, escape_cuda, record):
    """Kernel A against its plain version, bit for bit."""
    cases = [
        ("f32 CLI default view", Scene(width=2000, height=1000, iterations=50,
                                       pos=(-0.6, 0.0), exposure=5.0), "f32", False),
        ("f32 julia", Scene(algo="julia", width=1024, height=768, iterations=300,
                            julia_set=(-0.8, 0.156), scale=(0.6, 0.6)), "f32", False),
        ("f32 burningship", Scene(algo="burningship", width=1024, height=768,
                                  iterations=120, pos=(-0.45, -0.5),
                                  scale=(0.8, 0.8)), "f32", True),
        ("f32 multibrot d=3", Scene(algo="multibrot", power=3, width=768, height=512,
                                    iterations=200), "f32", False),
        ("ds32 @5e5 periodicity on", Scene(width=512, height=384, iterations=1000,
                                           pos=(-0.7436447860, 0.1318252536),
                                           scale=(5e5, 5e5)), "ds32", True),
        ("ds32 @5e5 periodicity off", Scene(width=512, height=384, iterations=1000,
                                            pos=(-0.7436447860, 0.1318252536),
                                            scale=(5e5, 5e5)), "ds32", False),
        ("ds32 tricorn", Scene(algo="tricorn", width=512, height=384, iterations=500,
                               pos=(0.37708333333333327, 0.46875),
                               scale=(2e4, 2e4)), "ds32", True),
    ]
    for label, sc, prec, per in cases:
        params = escape_cuda.scene_params(sc, device="cuda")
        kw = dict(algo=sc.algo, power=sc.power, iterations=sc.iterations,
                  precision=prec, height=sc.height, width=sc.width,
                  periodicity=per)
        k = escape_cuda.iterate_params(params, **kw)
        p = escape_cuda.iterate_whole(params, **kw)
        compare(f"kernel A {label}: {sc.width}x{sc.height}/{sc.iterations}",
                k, p, record, "A_err",
                f" cnt range [{int(k[2].min())}, {int(k[2].max())}]")


def phase_kernel_b(Scene, perturb, perturb_cuda, record, headline):
    """Kernel B against its plain version, bit for bit."""
    cases = [
        ("series skip @1e10", Scene(width=512, height=384, iterations=4000,
                                    pos=(-0.74364388703715871, 0.13182590420531198),
                                    scale=(1e10, 1e10), exposure=5.0, inside=False,
                                    precision="p32"), True),
        ("headline view @1e6", Scene(**{**headline, "width": 512, "height": 384,
                                        "precision": "p32"}), False),
        ("julia @1e5", Scene(algo="julia", width=512, height=384, iterations=2000,
                             julia_set=(-0.4, 0.6),
                             pos=(0.10416666666666666, -0.9374999999999999),
                             scale=(1e5, 1e5), precision="p32"), False),
    ]
    for label, sc, need_skip in cases:
        h, w, P, table, n_steps = perturb.perturb_setup(sc, "cuda")
        n0 = int(P[8].item())
        check(not need_skip or n0 > 0, f"{label}: the series skip did not fire")
        kw = dict(height=h, width=w, julia=sc.algo == "julia")
        k = perturb_cuda.perturb_dist(table, P, n_steps, **kw)
        p = perturb_cuda.perturb_dist_plain(table, P, n_steps, **kw)
        compare(f"kernel B {label}: {w}x{h}/{sc.iterations} P[8]={n0} "
                f"n_steps={n_steps}", k, p, record, "B_err",
                f" cnt range [{int(k[1].min())}, {int(k[1].max())}]")


def phase_main_path(Scene, render, escape_cuda, perturb_cuda, card, headline):
    """The headline in both tiers through ``render_u8``: cold, then 3 warm
    calls; the launch counters are zeroed just before and read just after."""
    import torch

    scenes = {"p32": Scene(**headline, precision="p32"),
              "exact (auto)": Scene(**headline)}
    escape_cuda.LAUNCHES = 0
    perturb_cuda.LAUNCHES = 0
    images = {}
    for tier, sc in scenes.items():
        img, cold = sync_time(lambda: render.render_u8(sc, "cuda"))
        warm = []
        for _ in range(3):
            img, dt = sync_time(lambda: render.render_u8(sc, "cuda"))
            warm.append(dt)
        images[tier] = img
        print(f"headline {tier} on {card}: cold {cold * 1e3:.3f} ms, warm "
              f"{', '.join(f'{t * 1e3:.3f}' for t in warm)} ms, p50 "
              f"{statistics.median(warm) * 1e3:.3f} ms", flush=True)
    launches = {"A": escape_cuda.LAUNCHES, "B": perturb_cuda.LAUNCHES}
    print(f"launch counters after the headline renders: "
          f"escape_cuda.LAUNCHES={launches['A']} "
          f"perturb_cuda.LAUNCHES={launches['B']}", flush=True)
    check(launches["A"] > 0 and launches["B"] > 0, "a kernel of the main path never launched")

    for tier, img in images.items():
        check(tuple(img.shape) == (3000, 3000, 3) and img.dtype == torch.uint8,
              f"{tier}: image {tuple(img.shape)} {img.dtype}")
        check(len(torch.unique(img.reshape(-1, 3), dim=0)) > 16,
              f"{tier}: the image is nearly flat")
    black = {t: (img == 0).all(-1) for t, img in images.items()}
    agree = float((black["p32"] == black["exact (auto)"]).float().mean())
    same = float((images["p32"] == images["exact (auto)"]).all(-1).float().mean())
    print(f"p32 vs exact: interior classification agrees on {agree!r} of pixels, "
          f"identical colour on {same!r}", flush=True)
    check(agree >= 0.99, "p32 and exact tiers disagree on the interior")
    return scenes, images, launches


def plain_route(scene, escape_cuda, perturb, perturb_cuda, render):
    """The main path with each kernel replaced by its plain version."""
    if scene.precision == "p32":
        h, w, P, table, n_steps = perturb.perturb_setup(scene, "cuda")
        d, cnt = perturb_cuda.perturb_dist_plain(table, P, n_steps, height=h,
                                                 width=w, julia=scene.algo == "julia")
        return render._color_and_downsample_dist(scene, d, cnt)
    prec = render.resolve_precision(scene, "cuda")
    check(prec == "ds32", f"auto resolved to {prec}, not ds32")
    params = escape_cuda.scene_params(scene, device="cuda")
    zr, zi, cnt = escape_cuda.iterate_whole(
        params, algo=scene.algo, power=scene.power, iterations=scene.iterations,
        precision=prec, height=scene.height, width=scene.width,
        periodicity=not scene.inside)
    return render._color_and_downsample(scene, zr, zi, cnt)


def torch_sync():
    import torch

    torch.cuda.synchronize()


def main() -> int:
    try:
        import torch
    except ImportError:
        raise SmokeFailure("torch is not installed")
    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is False: this smoke "
                           "test needs a CUDA card")
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    try:
        import importlib

        render = importlib.import_module("fractal_tpu_torch.render")
        from fractal_tpu_torch.config import Scene
        from fractal_tpu_torch.headline_profile import HEADLINE
        from fractal_tpu_torch.ops import _cuda_build, escape_cuda, perturb, perturb_cuda
    except ImportError as e:
        raise SmokeFailure(f"the fractal_tpu_torch package is not beside "
                           f"chip_smoke.py: {e}")
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    card = card_line()
    print(card, flush=True)

    # 2. build
    t0 = time.perf_counter()
    _cuda_build.load()
    info = _cuda_build.BUILD_INFO
    print(f"kernel build: {time.perf_counter() - t0:.2f} s wall "
          f"(nvcc {info['seconds']:.2f} s) -> {os.path.relpath(info['path'], root)}",
          flush=True)
    regs = [int(m) for m in re.findall(r"Used (\d+) registers", info["log"])]
    spills = sum(int(m) for m in re.findall(r"(\d+) bytes spill stores", info["log"]))
    if regs:
        print(f"ptxas: {len(regs)} kernels, {min(regs)}-{max(regs)} registers, "
              f"{spills} bytes of spill stores", flush=True)

    # 3. the main path, through the user's entry point, from empty host
    # caches.  A small render of another view first brings up the CUDA
    # context and loads PyTorch's own kernels (0.6 s on the card), so
    # "cold" is the headline's own first call.
    render.render_u8(Scene(width=64, height=64, iterations=50), "cuda")
    torch_sync()
    scenes, images, launches = phase_main_path(Scene, render, escape_cuda,
                                               perturb_cuda, card, HEADLINE)

    # 4, 5. kernels against their plain versions
    record = {"A_err": 0.0, "B_err": 0.0}
    phase_kernel_a(Scene, escape_cuda, record)
    phase_kernel_b(Scene, perturb, perturb_cuda, record, HEADLINE)

    # each kernel at the main path's shape (3000x3000, 4000 iterations):
    # its time against its plain version's, and the outputs bit-equal
    exact = scenes["exact (auto)"]
    params = escape_cuda.scene_params(exact, device="cuda")
    akw = dict(algo="mandelbrot", power=2, iterations=exact.iterations,
               precision="ds32", height=exact.height, width=exact.width,
               periodicity=True)
    a_ms, a_out = event_ms(lambda: escape_cuda.iterate_params(params, **akw))
    a_ref, a_plain = sync_time(lambda: escape_cuda.iterate_whole(params, **akw))
    print(f"kernel A ds32 3000x3000/4000 on {card}: {a_ms:.3f} ms; plain "
          f"{a_plain * 1e3:.3f} ms", flush=True)
    compare("kernel A ds32 3000x3000/4000, periodicity on", a_out, a_ref,
            record, "A_err")
    del a_out, a_ref
    h, w, P, table, n_steps = perturb.perturb_setup(scenes["p32"], "cuda")
    bkw = dict(height=h, width=w, julia=False)
    b_ms, b_out = event_ms(lambda: perturb_cuda.perturb_dist(table, P, n_steps, **bkw))
    b_ref, b_plain = sync_time(lambda: perturb_cuda.perturb_dist_plain(
        table, P, n_steps, **bkw))
    print(f"kernel B p32 3000x3000/4000 on {card}: {b_ms:.3f} ms; plain "
          f"{b_plain * 1e3:.3f} ms", flush=True)
    compare(f"kernel B p32 3000x3000/4000 P[8]={int(P[8].item())}", b_out, b_ref,
            record, "B_err")
    # each kernel's rate in pixel-steps per second (a pixel's steps are its
    # count plus its escape step; kernel B starts at n0 = P[8]; kernel A is
    # counted without periodicity, whose early freezes hide steps)
    nokw = {**akw, "periodicity": False}
    a_off_ms, a_off = event_ms(lambda: escape_cuda.iterate_params(params, **nokw))
    cnt = a_off[2].long()
    a_steps = int((cnt + (cnt < exact.iterations).long()).sum())
    d, cnt = b_out
    esc = (d > float(exact.limit) ** 2).long()
    b_steps = int((cnt.long() + esc - int(P[8].item())).clamp(min=0).sum())
    print(f"kernel A ds32, periodicity off: {a_steps} pixel-steps in {a_off_ms:.3f} ms "
          f"= {a_steps / a_off_ms / 1e6:.2f} G steps/s; kernel B: {b_steps} "
          f"pixel-steps in {b_ms:.3f} ms = {b_steps / b_ms / 1e6:.2f} G steps/s",
          flush=True)
    for tier, sc in scenes.items():
        p_img, t_plain = sync_time(lambda: plain_route(sc, escape_cuda, perturb,
                                                       perturb_cuda, render))
        eq = bits_equal(images[tier], p_img)
        print(f"headline {tier} plain route on {card}: {t_plain * 1e3:.3f} ms; "
              f"3000x3000 kernel route == plain route: {eq}", flush=True)
        check(eq, f"{tier}: the main path's image differs from the plain route's")

    # kernel route vs plain route, whole image, at 1000x1000 of the same view
    for tier, sc in scenes.items():
        small = sc.replace(width=1000, height=1000)
        k_img = render.render_u8(small, "cuda")
        p_img = plain_route(small, escape_cuda, perturb, perturb_cuda, render)
        eq = bits_equal(k_img, p_img)
        print(f"headline view {tier} 1000x1000: kernel route == plain route: {eq}",
              flush=True)
        check(eq, f"{tier}: the kernel route's image differs from the plain route's")

    check("jax" not in sys.modules, "jax was imported")
    print(json.dumps({"kernels": [
        {"name": "escape_time", "route": "cuda", "source": A_SRC,
         "replaces": A_REPLACES, "launches": launches["A"],
         "max_abs_err": record["A_err"], "ms": a_ms, "plain_ms": a_plain * 1e3},
        {"name": "perturb_dist", "route": "cuda", "source": B_SRC,
         "replaces": B_REPLACES, "launches": launches["B"],
         "max_abs_err": record["B_err"], "ms": b_ms, "plain_ms": b_plain * 1e3},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
