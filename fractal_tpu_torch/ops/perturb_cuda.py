"""δ-orbit kernel B (dist-only form): the plain torch version and the
wrapper over ``csrc/perturb.cu``.

Replaces the ``dist_only`` form of
``fractal_tpu/ops/perturb.py::perturb_pallas_v2`` for the quadratic
mandelbrot and julia recurrences:

    δz' = (2Z_n + δz)·δz + δc        (julia: no + δc)
    z   = Z_{n+1} + δz'               escape when |z|² > limit²

from n0 = P[8] with the cubic series start, against a (rows, 2) float32
table of 2·Z_n (``perturb.orbit_table``).  Outputs the frozen |z|² and the
count with the terminal escape step taken back out.  ``perturb_dist_plain``
is the plain version (whole image in lock-step with freeze masks);
``perturb_dist`` runs it only for CPU tensors and launches the kernel for
CUDA tensors.
"""

from __future__ import annotations

import ctypes

import torch

#: Steps between the plain version's whole-image "anything live?" checks.
CHUNK = 64

#: Kernel launches made by ``perturb_dist`` (plain-version calls excluded).
LAUNCHES = 0


def perturb_dist_plain(table, P, n_steps: int, *, height: int, width: int,
                       julia: bool):
    """Plain torch version of kernel B on ``table``'s device → (d, cnt)."""
    device = table.device
    f32 = torch.float32
    p = [P[i] for i in range(16)]
    xx = torch.arange(width, dtype=f32, device=device).expand(height, width)
    yy = torch.arange(height, dtype=f32, device=device)[:, None].expand(height, width)
    yy = yy * p[6] + p[7]  # global-row map (integer-valued, exact)
    dcr = (xx - p[2]) * p[0]
    dci = (yy - p[3]) * p[1]
    limit_sq = p[4]

    # series start (perturb.py:1262-1270)
    rows = table.shape[0]
    n0 = min(max(int(P[8].item()), 0), rows - 1)
    ur = dcr * p[15]
    ui = dci * p[15]
    t1r = p[13] * ur - p[14] * ui + p[11]
    t1i = p[13] * ui + p[14] * ur + p[12]
    t2r = t1r * ur - t1i * ui + p[9]
    t2i = t1r * ui + t1i * ur + p[10]
    dzr = t2r * ur - t2i * ui
    dzi = t2r * ui + t2i * ur

    half = 0.5 * table  # Z_n, exact
    zfr = half[n0, 0] + dzr
    zfi = half[n0, 1] + dzi
    d = zfr * zfr + zfi * zfi
    cnt = torch.full((height, width), n0, dtype=torch.int32, device=device)
    for n in range(n0, n_steps):
        live = d <= limit_sq
        if (n - n0) % CHUNK == 0 and not bool(live.any()):
            break
        tr = table[n, 0] + dzr
        t2 = table[n, 1] + dzi
        if julia:
            ndzr = tr * dzr - t2 * dzi
            ndzi = tr * dzi + t2 * dzr
        else:
            ndzr = tr * dzr - t2 * dzi + dcr
            ndzi = tr * dzi + t2 * dzr + dci
        nzfr = half[n + 1, 0] + ndzr
        nzfi = half[n + 1, 1] + ndzi
        nd = nzfr * nzfr + nzfi * nzfi
        d = torch.where(live, nd, d)
        cnt = cnt + live.to(torch.int32)
        dzr, dzi = ndzr, ndzi
    escaped = (d > limit_sq).to(torch.int32)
    cnt = torch.clamp(cnt - escaped, min=0)
    return d, cnt


def perturb_dist(table, P, n_steps: int, *, height: int, width: int,
                 julia: bool):
    """Kernel B on ``table``'s device: (d f32, cnt i32), each (height,
    width).  CPU tensors run ``perturb_dist_plain``; CUDA tensors launch
    ``csrc/perturb.cu``."""
    if table.device.type == "cpu" and P.device.type == "cpu":
        return perturb_dist_plain(table, P, n_steps, height=height,
                                  width=width, julia=julia)
    for name, t in (("table", table), ("P", P)):
        if t.device.type != "cuda" or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 CUDA tensor, "
                             f"got {t.dtype} on {t.device}")
    if table.device != P.device:
        raise ValueError(f"table on {table.device} but P on {P.device}")
    if table.dim() != 2 or table.shape[1] != 2 or P.shape != (16,):
        raise ValueError(f"want table (rows, 2) and P (16,), got "
                         f"{tuple(table.shape)} and {tuple(P.shape)}")
    rows = table.shape[0]
    if not 0 <= n_steps < rows:
        raise ValueError(f"n_steps {n_steps} outside the {rows}-row table")
    if height <= 0 or width <= 0:
        raise ValueError("height/width must be positive")
    from fractal_tpu_torch.ops import _cuda_build

    lib = _cuda_build.load()
    d = torch.empty((height, width), dtype=torch.float32, device=table.device)
    cnt = torch.empty((height, width), dtype=torch.int32, device=table.device)
    err = lib.fractal_perturb_dist(
        P.data_ptr(), table.data_ptr(), rows, int(n_steps), int(bool(julia)),
        int(height), int(width), d.data_ptr(), cnt.data_ptr(),
        torch.cuda.current_stream(table.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"perturb kernel launch failed: "
                           f"{_cuda_build.error_string(err)}")
    global LAUNCHES
    LAUNCHES += 1
    return d, cnt


def bind(lib: ctypes.CDLL) -> None:
    """Declare the C signature of ``fractal_perturb_dist`` on ``lib``."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fractal_perturb_dist.argtypes = [p, p, i, i, i, i, i, p, p, p]
    lib.fractal_perturb_dist.restype = i
