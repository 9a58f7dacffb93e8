"""Kernel A's f32 form and the f32 grid loop at the shapes the main path
gives them, timed on the card, and the machine instructions of their loops.

    python fractal_tpu_torch/tools/escape_bench.py [--root TREE] [--check]

``--root`` imports ``fractal_tpu_torch`` from another checkout (an unpacked
``git archive`` of a parent commit), so two versions are timed by one
script on one card: run parent, change, change, parent in one call and
compare within it.  The shapes are ``chip_smoke.py``'s: frame 100 of
``bench.py``'s jsweep256 (julia, 1920×1080 / 300) and mp100 (mandelbrot,
10000×10000 / 500).  At each, the three-output form (``iterate_params``)
and, where the tree has it, the colored form (``iterate_color``) are timed
by CUDA events and on the device by ``torch.profiler``.  The f32 grid loop
(``csrc/escape_f64.cu``) is timed at ``--backend jnp``'s main path, mp100's
view at 1920×1080 / 500: its three-output form (``escape.iterate_grid``)
and, where the tree has it, its colored form (``escape.iterate_grid_color``)
the same two ways, and ``render_u8(scene, "cuda", "jnp")`` by the host's
clock (warm p50).  The loops' instructions come from ``cuobjdump -sass`` of
the built library: for each f32 grid kernel of the quadratic rule, the
instructions between a backward branch and its target, and per step (kernel
A's loop takes ``escape_cuda.F32_STEPS_PER_PASS`` steps a pass, the grid
loop ``escape.F32_GRID_STEPS_PER_PASS``; 1 where the tree does not say).
``--check`` holds each output against its plain version (at mp100 kernel A's
colored form against the three-output form and torch's coloring).  Prints
one JSON line last.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

JSWEEP_FRAME = 100
MP100 = dict(width=10000, height=10000, iterations=500, exposure=5.0)  # bench.py:292-294
#: The f32 grid loop's kernels (csrc/escape_f64.cu): three-output and colored.
GRID_KERNELS = ("escape_f32_grid_kernel", "escape_f32_grid_color_kernel")


def _tool(name: str):
    """The toolkit program ``name`` on PATH or under CUDA_HOME, or None."""
    path = shutil.which(name) or os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                                              "bin", name)
    return path if os.path.exists(path) else None


def sass_loops(lib_path: str, rule: int = 0, kernel: str = "escape_kernel", word: str = "ZF"):
    """{kernel: [instructions in each loop]} for the grid kernels of ``rule``
    (0: the quadratic rule) in the built library's ``cuobjdump -sass``: a
    loop is a branch to an earlier address (not a kernel's closing branch to
    itself), and its instructions are those from the target to the branch,
    both counted.  Kernels are found by their mangled names (kernel A's
    ``escape_kernel<word, rule, flags...>``, ``word`` "ZF" for its f32 form
    or "ZD" for ds32, or ``kernel<rule, flags...>`` for another ``kernel``,
    such as csrc/escape_f64.cu's ``escape_f32_grid_kernel``), so no
    demangler is needed."""
    cuobjdump = _tool("cuobjdump")
    if cuobjdump is None:
        raise RuntimeError("cuobjdump not found (neither on PATH nor under CUDA_HOME)")
    text = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    chunks = re.split(r"\n\s*Function : (\S+)", text)
    if kernel == "escape_kernel":
        pattern = rf"13escape_kernelI\w*?2{word}ELi(\d+)E((?:Lb[01]E)+)"
        label = f"escape_kernel<{word}, "
    else:
        pattern, label = rf"{len(kernel)}{kernel}ILi(\d+)E((?:Lb[01]E)+)", f"{kernel}<"
    out = {}
    for name, body in zip(chunks[1::2], chunks[2::2]):
        m = re.search(pattern, name)
        if not m or int(m.group(1)) != rule:
            continue
        flags = ", ".join("true" if b == "1" else "false"
                          for b in re.findall(r"Lb([01])E", m.group(2)))
        addrs, labels, branches = [], {}, []
        pending = []
        for line in body.splitlines():
            lab = re.match(r"\s*(\.L_x_\d+):", line)
            if lab:
                pending.append(lab.group(1))
                continue
            ins = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
            if not ins:
                continue
            addr = int(ins.group(1), 16)
            for lab_name in pending:
                labels[lab_name] = addr
            pending = []
            addrs.append(addr)
            op = ins.group(2)
            if re.search(r"\bBRA\b", op):
                tgt = re.search(r"`\((\.L_x_\d+)\)|\b0x([0-9a-f]+)\b", op)
                if tgt:
                    branches.append((addr, tgt.group(1) or int(tgt.group(2), 16)))
        loops = []
        for addr, tgt in branches:
            tgt = labels.get(tgt) if isinstance(tgt, str) else tgt
            if tgt is not None and tgt < addr:
                loops.append(sum(1 for a in addrs if tgt <= a <= addr))
        out[f"{label}{rule}, {flags}>"] = loops
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), help="checkout to import fractal_tpu_torch from")
    ap.add_argument("--check", action="store_true", help="compare with the plain versions")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("escape_bench needs a CUDA card")
    render = importlib.import_module("fractal_tpu_torch.render")
    from fractal_tpu_torch import animate
    from fractal_tpu_torch.config import Scene
    from fractal_tpu_torch.utils.timing import profile_warm
    from fractal_tpu_torch.ops import _cuda_build, escape_cuda
    from fractal_tpu_torch.utils.timing import card_line, event_ms

    card = card_line()
    lib_path = _cuda_build.build()
    _cuda_build.load()
    print(f"{args.root} on {card}", flush=True)
    per_pass = getattr(escape_cuda, "F32_STEPS_PER_PASS", 1)
    sass = sass_loops(lib_path)
    for name, loops in sorted(sass.items()):
        print(f"sass {name}: loops of {loops} instructions; the longest a step "
              f"{max(loops, default=0) / per_pass!r} ({per_pass} steps a pass)", flush=True)
    colored = hasattr(escape_cuda, "iterate_color")
    cs = animate.julia_c_path(np.linspace(0, 1, 256, endpoint=False))[JSWEEP_FRAME]
    views = {"jsweep256 frame": Scene(algo="julia", width=1920, height=1080, iterations=300,
                                      pos=(0.0, 0.0), scale=(0.4, 0.4),
                                      julia_set=(float(cs[0]), float(cs[1]))),
             "mp100": Scene(**MP100)}
    out = {}

    def device_ms(fn, key):
        _, _, top = profile_warm(lambda: [fn() for _ in range(args.reps)], top=8)
        hits = [t / calls for kname, t, calls in top if key in kname]
        return hits[0] if hits else float("nan")

    def same(a, b, what):
        torch.cuda.synchronize()
        eq = all(torch.equal(x.view(torch.int32) if x.dtype == torch.float32 else x,
                             y.view(torch.int32) if y.dtype == torch.float32 else y)
                 for x, y in zip(a, b))
        print(f"{what}: bit-equal: {eq}", flush=True)
        if not eq:
            raise SystemExit(f"{what} differs")

    for label, sc in views.items():
        params = escape_cuda.scene_params(sc, device="cuda")
        kw = dict(algo=sc.algo, power=sc.power, iterations=sc.iterations, precision="f32",
                  height=sc.height, width=sc.width, periodicity=not sc.inside)
        ms, k = event_ms(lambda: escape_cuda.iterate_params(params, **kw), args.reps)
        dev = device_ms(lambda: escape_cuda.iterate_params(params, **kw), "escape_kernel")
        out[f"three-output {label}"] = {"events": ms, "device": dev}
        print(f"kernel A f32 three-output {label}: {ms:.4f} ms by events, {dev!r} ms on the "
              f"device", flush=True)
        if args.check and label.startswith("jsweep"):
            same(k, escape_cuda.iterate_whole(params, **kw), f"three-output {label}")
        if colored:
            color = escape_cuda.color_params(sc, device="cuda")
            ckw = dict(kw, inside=sc.inside, smooth=sc.smooth)
            ms, img = event_ms(lambda: escape_cuda.iterate_color(params, color, **ckw),
                               args.reps)
            dev = device_ms(lambda: escape_cuda.iterate_color(params, color, **ckw),
                            "escape_kernel")
            out[f"colored {label}"] = {"events": ms, "device": dev}
            print(f"kernel A f32 colored {label}: {ms:.4f} ms by events, {dev!r} ms on the "
                  f"device", flush=True)
            if args.check:
                want = (escape_cuda.iterate_color_plain(params, color, **ckw)
                        if label.startswith("jsweep")
                        else render._color_and_downsample(sc, *k))
                same([img], [want], f"colored {label}")
            del img
        del k
    # the f32 grid loop at --backend jnp's main path
    from fractal_tpu_torch.ops import escape, viewport

    sc = Scene(**{**MP100, "width": 1920, "height": 1080}, precision="f32")
    cr, ci = viewport.pixel_grid(sc.width, sc.height, sc.pos, sc.scale, dtype=torch.float32,
                                 device="cuda")
    gkw = dict(algo=sc.algo, power=sc.power, iterations=sc.iterations, limit=sc.limit)
    forms = {"f32 grid three-output": (lambda: escape.iterate_grid(cr, ci, **gkw),
                                       GRID_KERNELS[0])}
    if hasattr(escape, "iterate_grid_color"):
        color = escape_cuda.color_params(sc, device="cuda")
        ckw = dict(gkw, width=sc.width, height=sc.height, pos=sc.pos, scale=sc.scale,
                   inside=sc.inside, smooth=sc.smooth)
        forms["f32 grid colored"] = (lambda: escape.iterate_grid_color(color, **ckw),
                                     GRID_KERNELS[1])
    for label, (fn, kname) in forms.items():
        ms, res = event_ms(fn, args.reps)
        dev = device_ms(fn, kname)
        out[label] = {"events": ms, "device": dev}
        print(f"{label} mp100's view 1920x1080: {ms:.4f} ms by events, {dev!r} ms on the "
              f"device", flush=True)
        if args.check:
            plain = (escape.iterate_grid_plain(cr, ci, **gkw) if label.endswith("output")
                     else [escape.iterate_grid_color_plain(color, **ckw)])
            same(res if label.endswith("output") else [res], plain, label)
        del res
    render.render_u8(sc, "cuda", "jnp")
    warm = []
    for _ in range(args.reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        render.render_u8(sc, "cuda", "jnp")
        torch.cuda.synchronize()
        warm.append((time.perf_counter() - t0) * 1e3)
    out["--backend jnp render"] = {"warm": warm, "p50": statistics.median(warm)}
    print(f"--backend jnp mp100's view 1920x1080: warm {warm} ms, p50 "
          f"{statistics.median(warm)!r} ms; route {render.RENDER_STATS['route']!r}", flush=True)
    grid_pass = getattr(escape, "F32_GRID_STEPS_PER_PASS", 1)
    for kname in GRID_KERNELS:
        loops = sass_loops(lib_path, kernel=kname)
        sass.update(loops)
        for name, ls in sorted(loops.items()):
            print(f"sass {name}: loops of {ls} instructions; the longest a step "
                  f"{max(ls, default=0) / grid_pass!r} ({grid_pass} steps a pass)", flush=True)
    print(json.dumps({"root": args.root, "card": card, "ms": out, "sass": sass,
                      "steps_per_pass": per_pass, "grid_steps_per_pass": grid_pass}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
