"""``python -m fractal_tpu_torch W H [flags]``: render a still (in bands
with ``--bands``), or the frames of a sweep with ``--animate N``, and
encode it; or, with ``-g``, serve the interactive viewer
(``fractal_tpu_torch.viewer``).  ``--trace DIR`` writes a
``torch.profiler`` trace of the render to DIR.  ``--devices N`` renders
across a mesh of N devices (``parallel/sharding``; 0 = all of them).
``--profile`` prints the phases, the route, and the render's spans (kind,
ms, detail), each fenced with ``torch.cuda.synchronize()`` on the card.

The device comes from ``FRACTAL_TPU_PLATFORM``, as for ``python -m
fractal_tpu``: ``cpu`` renders on the CPU, unset (or ``cuda``/``gpu``)
renders on the CUDA device and fails cleanly when there is none.
"""

from __future__ import annotations

import contextlib
import os
import sys

from fractal_tpu_torch.cli import parse_options
from fractal_tpu_torch.utils.timing import Fenced, Phases


def platform_device() -> str:
    plat = os.environ.get("FRACTAL_TPU_PLATFORM", "").strip().lower()
    if plat == "cpu":
        return "cpu"
    if plat not in ("", "cuda", "gpu"):
        sys.exit(f"error: FRACTAL_TPU_PLATFORM={plat!r}: use cpu or cuda")
    import torch

    if not torch.cuda.is_available():
        sys.exit("error: no CUDA device (torch.cuda.is_available() is False); "
                 "set FRACTAL_TPU_PLATFORM=cpu to render on the CPU")
    return "cuda"


def main(argv=None) -> int:
    try:
        return _main(argv)
    except (ValueError, NotImplementedError) as e:
        # configuration errors and paths not yet ported: one line, no traceback
        sys.exit(f"error: {e}")


def _trace(options, device):
    """``--trace DIR``: a ``torch.profiler`` session over the render (the
    CPU's activity, and the card's on cuda) whose trace is written to DIR
    as ``*.pt.trace.json`` when it ends; else no context."""
    if not options.trace:
        return contextlib.nullcontext()
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if device == "cuda":
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities,
                   on_trace_ready=tensorboard_trace_handler(options.trace))


@contextlib.contextmanager
def _spans(split):
    """``split`` as the span sink of the render driver and the perturbation
    route (``ops/perturb.SPLIT``) and of the fern (``models/fern.SPLIT``)
    for the block; None leaves the sinks alone."""
    if split is None:
        yield
        return
    from fractal_tpu_torch.models import fern
    from fractal_tpu_torch.ops import perturb

    saved = perturb.SPLIT, fern.SPLIT
    perturb.SPLIT = fern.SPLIT = split
    try:
        yield
    finally:
        perturb.SPLIT, fern.SPLIT = saved


def _report_spans(split) -> None:
    """The render's spans in the order they ended (an enclosing span after
    the spans inside it)."""
    if not split:
        return
    print("--- spans ---")
    for kind, detail, ms in split:
        print(f"{kind:>16s}: {ms:9.2f} ms  {detail}".rstrip())


def _main(argv=None) -> int:
    options = parse_options(argv)
    device = platform_device()
    if options.gui:
        from fractal_tpu_torch.viewer import start

        start(options, device=device)
        return 0
    import torch

    from fractal_tpu_torch.io.image_out import write_image
    from fractal_tpu_torch.render import render_u8, resolve_precision

    from fractal_tpu_torch.parallel import sharding

    phases = Phases(enabled=options.profile)
    split = Fenced() if options.profile else None
    mesh = sharding.mesh_for_devices(options.devices, device)
    if options.animate:
        return _render_animation(options, phases, device, mesh, split)
    with _trace(options, device), _spans(split):
        if options.bands:
            from fractal_tpu_torch.tiled import render_tiled

            with phases.phase("render (banded)" if mesh is None else
                              f"render (banded, {mesh.size}-device)"):
                img = render_tiled(options.scene, options.bands, options.ckpt_dir,
                                   progress=print if options.profile else None,
                                   mesh=mesh, device=device)
        else:
            with phases.phase("render (device)" if mesh is None else
                              f"render ({mesh.size}-device mesh)"):
                if mesh is None:
                    img_dev = render_u8(options.scene, device, options.backend)
                elif options.scene.algo == "fern":
                    img_dev = sharding.render_fern_sharded(options.scene, mesh)
                else:
                    img_dev = sharding.render_escape_sharded(options.scene, mesh,
                                                             backend=options.backend)
                if device == "cuda":
                    torch.cuda.synchronize()
            with phases.phase("device→host"):
                img = img_dev.cpu().numpy()
    with phases.phase("encode+write"):
        path = write_image(img, options.filename, options.fmt)
    phases.report()
    _report_spans(split)
    if options.profile:
        if options.scene.algo == "fern":
            _report_fern()
        elif resolve_precision(options.scene, device) in ("perturb", "p32"):
            _report_perturbation()
        else:
            _report_escape(options.scene, device)
    if options.trace:
        print(f"trace written to {options.trace}")
    if options.open:
        from fractal_tpu_torch.io.open_file import open_in_viewer

        open_in_viewer(path)
    return 0


def _render_animation(options, phases, device, mesh, split) -> int:
    """``--animate N``: the frames of a julia or zoom sweep, written as
    OUTPUT_0000.EXT, OUTPUT_0001.EXT, ..., across ``mesh`` when given."""
    import numpy as np

    from fractal_tpu_torch.animate import julia_c_path, render_sweep, render_zoom_sweep
    from fractal_tpu_torch.io.image_out import write_image

    scene, n = options.scene, options.animate
    with _trace(options, device), _spans(split), phases.phase("render (sweep)"):
        if options.sweep == "zoom":
            start = options.zoom_from if options.zoom_from is not None else 0.4
            end = max(abs(scene.scale[0]), abs(scene.scale[1]))
            frames = render_zoom_sweep(scene, np.geomspace(start, end, n),
                                       exact=options.exact_sweep, mesh=mesh, device=device)
        else:
            cs = julia_c_path(np.linspace(0.0, 1.0, n, endpoint=False))
            frames = render_sweep([scene.replace(julia_set=(float(a), float(b)))
                                   for a, b in cs], mesh=mesh, device=device)
    with phases.phase("encode+write"):
        paths = [write_image(frames[i], f"{options.filename}_{i:04d}", options.fmt)
                 for i in range(n)]
    phases.report()
    _report_spans(split)
    print(f"wrote {n} frames: {paths[0]} ... {paths[-1]}")
    if options.trace:
        print(f"trace written to {options.trace}")
    if options.open:
        from fractal_tpu_torch.io.open_file import open_in_viewer

        open_in_viewer(paths[0])
    return 0


def _report_fern() -> None:
    """Tier, histogram route, points walked and histogram calls of a fern
    render (``models/fern.RENDER_STATS``)."""
    from fractal_tpu_torch.models.fern import RENDER_STATS

    print(f"{'tier':>16s}: {RENDER_STATS['tier']}")
    print(f"{'histogram route':>16s}: {RENDER_STATS['route']}")
    print(f"{'points':>16s}: {RENDER_STATS['points']} in "
          f"{RENDER_STATS['hist_calls']} histogram call(s)")


def _report_escape(scene, device) -> None:
    """Tier and kernel route of an escape-time render
    (``render.RENDER_STATS``)."""
    from fractal_tpu_torch.render import RENDER_STATS, resolve_precision

    print(f"{'tier':>16s}: {resolve_precision(scene, device)}")
    print(f"{'kernel route':>16s}: {RENDER_STATS['route']}")


def _report_perturbation() -> None:
    """Tier, δ-orbit route, glitch pixels and any unresolved residual of a
    perturbation render (``ops/perturb.RENDER_STATS``)."""
    from fractal_tpu_torch.ops.perturb import RENDER_STATS

    if not RENDER_STATS.get("tier"):
        return
    ng = RENDER_STATS.get("n_glitch")
    nres = RENDER_STATS.get("n_residual", 0)
    print(f"{'tier':>16s}: {RENDER_STATS['tier']}")
    if RENDER_STATS.get("route"):
        print(f"{'kernel route':>16s}: {RENDER_STATS['route']}")
    print(f"{'glitch pixels':>16s}: {'n/a (fast tier)' if ng is None else int(ng)}")
    if nres is not None and int(nres):
        print(f"{'UNRESOLVED':>16s}: {int(nres)} pixel(s) pending exact resolve "
              f"(warm-path transient)")


if __name__ == "__main__":
    sys.exit(main())
