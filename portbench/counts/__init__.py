"""The yardstick of the kernel rooflines: work counts and the card's peaks.

Frozen here from the port's kernel table (PERF.md §6), so that a change to
the program cannot move them.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates):
  * 67 TFLOP/s in float32 outside the tensor cores counts a fused multiply-add
    as two operations.  The kernels are built with ``-fmad=false``, so every
    add and multiply is an instruction of its own: 132 SMs × 128 lanes ×
    1.98 GHz = 3.35e13 operations a second, half the published rate.
  * 3.35 TB/s of HBM3 bandwidth.
Both assume the card's full 700 W; ``card()`` reads the limit it runs at,
which every run reports beside its shares.

Operations a pixel-step (PERF.md §6, counted from each loop's source):
  * kernel A's ds32 step (double-single z^2 + c and the escape test): 80;
  * kernel B's dist-only step (the f32 δ-recurrence and its escape test): 18.

The Mandelbrot's count (``counts/mandelbrot.py``, which the harness finds
by the frames' algo; another algo brings ``counts/<algo>.py``): a frame's
pixel-steps are counted by the reference's own loop
(``reference.perturb.lattice_steps``) from z = c, whatever the program
does: an escaping pixel takes count + 1 steps (the step that escapes is
taken); one that does not escape takes the budget (kernel B: the p32 tier
has no cycle test), or, on kernel A's route, which runs Brent's cycle test
where interiors render black, the steps until that test stops it, followed
on the reference's orbit with the route's radius (``CYCLE_EPS_SQ``).  No
credit for a series skip.  The count is taken on a lattice, every
``COUNT_STRIDE``-th pixel of every ``COUNT_STRIDE``-th row, and scaled to
the frame's pixels; the frames are the window's first ``COUNT_FRAMES``,
which the stills' stratified centres spread over the whole box for every
seed alike.
"""

from __future__ import annotations

import subprocess

from portbench.reference.perturb import lattice_steps

PEAK_OPS_PER_S = 3.35e13
PEAK_BYTES_PER_S = 3.35e12
OPS_PER_STEP = {"kernel_a_ds32": 80, "kernel_b_dist": 18}
#: Kernel A's cycle test in its ds32 form: a squared distance (csrc/escape.cu
#: PERIOD_EPS_SQ_DS32).
CYCLE_EPS_SQ = 1e-18
COUNT_FRAMES = 64
COUNT_STRIDE = 6


def frame_steps(frames, device, stride: int = COUNT_STRIDE):
    """Each frame's pixel-steps, counted on the lattice and scaled to its
    pixels: [{"to_escape": steps to the escape or the budget, "with_cycle":
    steps to the escape, the cycle test's stop or the budget}]."""
    out = []
    for f, (n, to_escape, with_cycle) in zip(
            frames, lattice_steps(frames, device, stride, CYCLE_EPS_SQ)):
        scale = f["width"] * f["height"] / n
        out.append({"to_escape": to_escape * scale, "with_cycle": with_cycle * scale})
    return out


def least_s(ops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(ops / PEAK_OPS_PER_S, nbytes / PEAK_BYTES_PER_S)


def roofline_pct(frames, kernel: str, step: str, bytes_per_px: float, steps: str):
    """Σ least time ÷ Σ device time of the kernels whose name holds
    ``kernel``, over the frames whose pixel-steps were counted (their
    ``steps[steps]``), in %.  None where no such frame ran the kernel."""
    least = spent = 0.0
    for f in frames:
        if f.get("steps") is None:
            continue
        t = sum(e - s for name, s, e in f.get("kernels", ()) if kernel in name)
        if t <= 0:
            continue
        spent += t
        least += least_s(f["steps"][steps] * OPS_PER_STEP[step], f["pixels"] * bytes_per_px)
    return 100.0 * least / spent if spent else None


def card(fields: str = "name,power.limit") -> str:
    """The card's name and power limit (or other ``fields``), as nvidia-smi
    gives them."""
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        f"nvidia-smi failed: {out.stderr.strip()}"
