"""Kernels G and F on the card, and their plain torch versions: the probes
of the p32 δ-orbit kernel's arithmetic (``tools/lean_probe.py`` in the JAX
package holds their TPU forms; ``fractal_tpu_torch.tools.lean_probe`` runs
them).

  * kernel G (``chain``, ``csrc/chain.cu``): the chain x ← a·x + b as
    written (``fma``), with the product pinned through a traced 1.0
    (``pinned``), as a multiply alone (``mul``), and as an explicit fused
    multiply-add (``fused``);
  * kernel F (``probe``, ``csrc/perturb_probe.cu``): the quadratic
    non-julia δ-orbit of kernel B without the glitch test, in the variants
    ``base`` (zr, zi, cnt, d), ``dout`` (d, cnt), ``every2`` (escape test
    every second step) and ``nofreeze``.
"""

from __future__ import annotations

import ctypes

import torch

from fractal_tpu_torch.ops import _cuda_build, perturb_cuda

CHAIN_MODES = ("fma", "pinned", "mul", "fused")
VARIANTS = ("base", "dout", "every2", "nofreeze")
#: The TPU kernel's loop chunk: the loop starts at the chunk that holds n0,
#: and ``every2`` skips the escape test on the chunk's even steps.
CHUNK = 16

#: Kernel launches made by ``chain`` and ``probe`` (plain-version calls
#: excluded).
CHAIN_LAUNCHES = 0
PROBE_LAUNCHES = 0


# ---------------------------------------------------------------------------
# Kernel G: the multiply-add chain
# ---------------------------------------------------------------------------


def chain_plain(x, a, b, steps: int, mode: str):
    """Plain torch version of kernel G: every product and every sum is one
    rounded float32 operation.  Mode ``fused`` has no float32 counterpart in
    torch; it is formed in float64 (the product exact, the sum rounded to
    53 bits and then to 24), which equals the fused result except where that
    second rounding falls on a tie."""
    if mode not in CHAIN_MODES:
        raise ValueError(f"unknown chain mode {mode!r}")
    pin = torch.ones((), dtype=torch.float32, device=x.device) * 0.0 + 1.0
    if mode == "fused":
        a64, b64 = a.double(), b.double()
    for _ in range(steps):
        if mode == "fma":
            x = a * x + b
        elif mode == "pinned":
            x = (a * x) * pin + b
        elif mode == "mul":
            x = x * a
        else:
            x = (a64 * x.double() + b64).float()
    return x


def chain(x, a, b, steps: int, mode: str):
    """Kernel G on ``x``'s device: the chain of ``mode`` over ``steps``
    steps on float32 tensors of one shape.  CPU tensors run ``chain_plain``;
    CUDA tensors launch ``csrc/chain.cu``."""
    if mode not in CHAIN_MODES:
        raise ValueError(f"unknown chain mode {mode!r}")
    if all(t.device.type == "cpu" for t in (x, a, b)):
        return chain_plain(x, a, b, steps, mode)
    for name, t in (("x", x), ("a", a), ("b", b)):
        if t.device != x.device or t.device.type != "cuda" or t.dtype != torch.float32 \
                or not t.is_contiguous() or t.shape != x.shape:
            raise ValueError(f"{name} must be a contiguous float32 CUDA tensor of x's shape "
                             f"and device, got {(t.dtype, t.device, tuple(t.shape))}")
    if x.numel() == 0 or steps < 0:
        raise ValueError("want a non-empty x and steps >= 0")
    out = torch.empty_like(x)
    one = torch.ones(1, dtype=torch.float32, device=x.device)
    err = _cuda_build.load().fractal_chain(
        one.data_ptr(), x.data_ptr(), a.data_ptr(), b.data_ptr(), out.data_ptr(), x.numel(),
        int(steps), CHAIN_MODES.index(mode), torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"chain kernel launch failed: {_cuda_build.error_string(err)}")
    global CHAIN_LAUNCHES
    CHAIN_LAUNCHES += 1
    return out


# ---------------------------------------------------------------------------
# Kernel F: the probe twins of kernel B
# ---------------------------------------------------------------------------


def probe_plain(table, P, n_steps: int, *, height: int, width: int, variant: str):
    """Plain torch version of kernel F → (zr, zi, cnt, d) for ``base``,
    (d, cnt) for the other variants, each (height, width).  The image runs
    in lock-step with freeze masks; a pixel's z, |z|² and count change only
    while it is live, so it equals the kernel's per-thread loop.  ``nofreeze``
    is ``dout`` here: its |z|² runs on only until its tile leaves the loop,
    and the port's tile is one pixel (see ``csrc/perturb_probe.cu``)."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown probe variant {variant!r}")
    every2 = variant == "every2"
    base = variant == "base"
    dcr, dci = perturb_cuda._grid_dc(P, height, width, table.device)
    limit_sq = P[4]
    rows = table.shape[0]
    n0 = min(max(int(P[8].item()), 0), rows - 1)
    dzr, dzi = perturb_cuda.series_start(P, dcr, dci)
    half = 0.5 * table
    zfr = half[n0, 0] + dzr
    zfi = half[n0, 1] + dzi
    d = zfr * zfr + zfi * zfi
    cnt = torch.full(dcr.shape, n0, dtype=torch.int32, device=table.device)
    per_test = 2 if every2 else 1
    start = (n0 // CHUNK) * CHUNK
    for n in range(start, n_steps):
        live = d <= limit_sq
        if (n - start) % CHUNK == 0 and not bool(live.any()):
            break
        tr = table[n, 0] + dzr
        t2 = table[n, 1] + dzi
        ndzr = tr * dzr - t2 * dzi + dcr
        ndzi = tr * dzi + t2 * dzr + dci
        dzr, dzi = ndzr, ndzi  # δz is never frozen
        if every2 and n % 2 == 0:
            continue  # a step without an escape test
        nzfr = half[n + 1, 0] + ndzr
        nzfi = half[n + 1, 1] + ndzi
        nd = nzfr * nzfr + nzfi * nzfi
        if base:
            zfr = torch.where(live, nzfr, zfr)
            zfi = torch.where(live, nzfi, zfi)
        d = torch.where(live, nd, d)
        cnt = cnt + per_test * live.to(torch.int32)
    escaped = d > limit_sq
    cnt = torch.clamp(cnt - per_test * escaped.to(torch.int32), min=0)
    if base:
        return zfr, zfi, cnt, d
    return d, cnt


def probe(table, P, n_steps: int, *, height: int, width: int, variant: str):
    """Kernel F on ``table``'s device: the (rows, 2) table of 2·Z_n and the
    P block → (zr, zi, cnt, d) for ``base``, (d, cnt) otherwise, each
    (height, width).  CPU tensors run ``probe_plain``; CUDA tensors launch
    ``csrc/perturb_probe.cu``."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown probe variant {variant!r}")
    if table.device.type == "cpu" and P.device.type == "cpu":
        return probe_plain(table, P, n_steps, height=height, width=width, variant=variant)
    rows = perturb_cuda._check(table, None, P, n_steps, False)
    if height <= 0 or width <= 0:
        raise ValueError("height/width must be positive")
    dev = table.device
    d = torch.empty((height, width), dtype=torch.float32, device=dev)
    cnt = torch.empty((height, width), dtype=torch.int32, device=dev)
    zr = zi = None
    if variant == "base":
        zr, zi = torch.empty_like(d), torch.empty_like(d)
    err = _cuda_build.load().fractal_perturb_probe(
        P.data_ptr(), table.data_ptr(), rows, int(n_steps), VARIANTS.index(variant),
        int(height), int(width), perturb_cuda._ptr(zr), perturb_cuda._ptr(zi), d.data_ptr(),
        cnt.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"probe kernel launch failed: {_cuda_build.error_string(err)}")
    global PROBE_LAUNCHES
    PROBE_LAUNCHES += 1
    if variant == "base":
        return zr, zi, cnt, d
    return d, cnt


def bind(lib: ctypes.CDLL) -> None:
    """Declare the C signatures of ``csrc/chain.cu`` and
    ``csrc/perturb_probe.cu``."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fractal_chain.argtypes = [p, p, p, p, p, ctypes.c_longlong, i, i, p]
    lib.fractal_chain.restype = i
    lib.fractal_perturb_probe.argtypes = [p, p, i, i, i, i, i, p, p, p, p, p]
    lib.fractal_perturb_probe.restype = i
