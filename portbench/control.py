"""The check's control: a lower precision in the program's place.

    python3 -m portbench.control --workload <cell> --seeds <n> [<n> ...] [--frames 2]

For each seed, the cell's traffic makes its frames as a run would; the first
``--frames`` frames after the warm-up are rendered by the control named in
``portbench/checks/<cell>.json`` and held against the reference exactly as
``compare.check`` holds a run's frames.  A control must read over a limit
the program stays under:

    {"kind": "program", "scene": {"precision": "p32"}}
                                  the program itself, on its own lower path
    {"kind": "reference", "options": {"delta_dtype": "bfloat16"}}
                                  the frame's reference
                                  (``portbench/reference/<algo>.py``, found
                                  by the frame's ``algo``) with these
                                  options to its ``state``: here the
                                  Mandelbrot's δ-orbits rounded to bfloat16
                                  every step (the orbit float64)

Prints one JSON line a seed: the numbers, the worst frame's and the limits.
Runs on cuda when there is a card, else on the CPU (the tests, at small
sizes).
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from portbench import byname, compare, generator
from portbench.harness import ROOT, Cell, scene_of


def control_image(spec: dict, frame: dict, device: str, root=ROOT):
    kind = spec["kind"]
    if kind == "program":
        from fractal_tpu_torch.render import render

        return torch.from_numpy(render(scene_of(dict(frame, **spec["scene"])), device))
    if kind == "reference":
        ref = byname.module(root, "reference", frame.get("algo", "mandelbrot"))
        return ref.image(frame, ref.state(frame, device, **spec.get("options", {})))
    raise ValueError(f"unknown control {kind!r}")


def readings(cell: Cell, seed: int, nframes: int, device: str) -> dict:
    spec = cell.check["control"]
    frames = generator.frames(cell.config["scene"], cell.mix, seed, nframes)
    nwarm = int(cell.mix.get("warmup", 1))
    items = [(f, control_image(spec, f, device, cell.root)) for f in frames[nwarm:]]
    got = compare.check(items, device=device, root=cell.root)
    return {"workload": cell.name, "seed": seed, "control": spec, "numbers": got,
            "limits": cell.check["limits"],
            "fails": any(got[k] > v for k, v in cell.check["limits"].items())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--frames", type=int, default=2)
    args = ap.parse_args(argv)
    device = "cuda" if torch.cuda.is_available() else "cpu"
    cell = Cell(args.workload, ROOT)
    for seed in args.seeds:
        print(json.dumps(readings(cell, seed, args.frames, device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
