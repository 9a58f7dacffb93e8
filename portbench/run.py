"""Run one cell of the port's benchmark once and print its result.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, ``portbench/`` and
``fractal_tpu_torch/``, on a machine with a CUDA card.  The last line of
standard output is the result (one JSON object); everything else goes to
standard error, whose last lines are the numbers the check compared, each
beside its limit.  With ``--trace 0`` the metrics are the cell's end-to-end
ones, with ``--trace 1`` its per-layer ones, read from ``torch.profiler`` and
the program's spans and counters over the window.

Exits 3, printing no result, without a card or with fewer cards than the
cell asks for, and 4 if a module of the JAX package, or JAX itself, is
loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import ast  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

#: Top-level module names that no run may load: the JAX package and JAX.
FORBIDDEN = ("jax", "jaxlib", "flax", "fractal_tpu")
#: ... and that the reference may not import, with the program itself.
REFERENCE_FORBIDDEN = FORBIDDEN + ("fractal_tpu_torch",)
REFERENCE_DIR = Path(__file__).resolve().parent / "reference"


def loaded_forbidden(modules=None) -> list:
    """The forbidden top-level names among ``modules`` (``sys.modules``),
    each module's name compared whole up to its first dot."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN))


def reference_imports(directory: Path = REFERENCE_DIR) -> dict:
    """{file: forbidden top-level names it imports} over the reference's
    sources, read without running them."""
    found = {}
    for path in sorted(directory.rglob("*.py")):
        names = set()
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
                names.add(node.module.split(".")[0])
        bad = sorted(names & set(REFERENCE_FORBIDDEN))
        if bad:
            found[str(path)] = bad
    return found


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bad = reference_imports()
    if bad:
        print(f"error: the reference imports {bad}", file=sys.stderr)
        return 4
    import torch

    from portbench.harness import Cell, run_cell

    cell = Cell(args.workload)
    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"error: the cell needs {chips} CUDA card(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, {torch.cuda.device_count()} found",
              file=sys.stderr)
        return 3

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    with contextlib.redirect_stdout(sys.stderr):
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                          t_start=T_START, log=log)
    found = loaded_forbidden()
    if found:
        print(f"error: modules loaded in the run: {found}", file=sys.stderr)
        return 4
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
