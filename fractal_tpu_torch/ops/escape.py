"""Escape-time iteration on whole tensors (port of
``fractal_tpu/ops/escape_jnp.py``): the route of the CPU f32 and f64
renders and of explicit ``f64`` on any device.

Count semantics (calc/src/lib.rs:245-257): step i computes
z' = rule(z) + c; if |z'|² > limit² the pixel escapes with count i and
z_final = z'; a pixel that never escapes ends with count = iterations.
"""

from __future__ import annotations

import torch

from fractal_tpu_torch.models.rules import Rule

#: Steps between the whole-image "anything still active?" checks.
CHUNK = 32


def iterate(start_r, start_i, cr, ci, iterations: int, limit, rule: Rule):
    """Up to ``iterations`` steps of z ← rule(z) + c per element, frozen
    on escape.  Returns (zr, zi, cnt:int32)."""
    dtype = start_r.dtype
    zr, zi = start_r, start_i
    shape = zr.shape
    limit_sq = torch.tensor(float(limit), dtype=dtype, device=zr.device) ** 2
    cr = torch.broadcast_to(torch.as_tensor(cr, dtype=dtype, device=zr.device), shape)
    ci = torch.broadcast_to(torch.as_tensor(ci, dtype=dtype, device=zr.device), shape)
    cnt = torch.zeros(shape, dtype=torch.int32, device=zr.device)
    esc = torch.zeros(shape, dtype=torch.bool, device=zr.device)
    for step in range(iterations):
        if step % CHUNK == 0 and not bool((~esc & (cnt < iterations)).any()):
            break
        active = ~esc & (cnt < iterations)
        nzr, nzi = rule(zr, zi, cr, ci)
        d = nzr * nzr + nzi * nzi
        esc_now = active & (d > limit_sq)
        zr = torch.where(active, nzr, zr)
        zi = torch.where(active, nzi, zi)
        cnt = cnt + (active & ~esc_now).to(torch.int32)
        esc = esc | esc_now
    return zr, zi, cnt
