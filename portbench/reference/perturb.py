"""Perturbation with rebasing: the reference's escape counts at any depth.

The reference orbit W_0 = 0, W_{k+1} = W_k^2 + c0 of the view's centre c0 is
walked in exact binary fixed point (``ORBIT_BITS`` fractional bits, Python
integers) and rounded to float64 once.  A pixel c = c0 + δc follows it as
δ_{k+1} = (2 W_k + δ_k) δ_k + δc in float64; its z = W_k + δ_k.  Where
|z| < |δ|, or where the orbit runs out (the centre escaped), the pixel
restarts at the orbit's start with δ = z (W_0 = 0): rebasing, which leaves no
pixel glitched, so no second reference and no glitch test are needed.  No
error of a float64 orbit grows along the orbit, so at 1e6x this agrees with
60-digit mpmath where a plain float64 loop does not.

z_1 = c is the renderer's start, so step i of the renderer is k = i + 1
here: the pixel escapes with count k - 1.

Several views go through one call: each pixel carries the index of its own
orbit's start (``base``) and end (``last``) in one table of orbits.
"""

from __future__ import annotations

import torch

from portbench.reference.viewport import affine, centre

ORBIT_BITS = 512
CHUNK = 64
F64 = torch.float64


def orbit(c0, iterations: int, limit: float):
    """(Wr, Wi) float64 tensors W_0 .. W_M on the host: M = iterations + 1,
    or the first k at which |W_k|^2 > limit^2."""
    one = 1 << ORBIT_BITS
    cr = (c0[0].numerator * one) // c0[0].denominator
    ci = (c0[1].numerator * one) // c0[1].denominator
    lim_sq = int(float(limit) ** 2) * one * one
    xr = xi = 0
    out_r, out_i = [0.0], [0.0]
    for _ in range(iterations + 1):
        xr, xi = (xr * xr - xi * xi >> ORBIT_BITS) + cr, (2 * xr * xi >> ORBIT_BITS) + ci
        out_r.append(xr / one)
        out_i.append(xi / one)
        if xr * xr + xi * xi > lim_sq:
            break
    return torch.tensor(out_r, dtype=F64), torch.tensor(out_i, dtype=F64)


def delta_grid(frame, device, stride: int = 1):
    """(δcr, δci), flat float64: (u - W/2)·A_re, (v - H/2)·A_im, the offsets
    from the view's centre (its pixel (W/2, H/2)) of every ``stride``-th
    column of every ``stride``-th row, rows first."""
    (ar, _), (ai, _) = affine(frame)
    h, w = frame["height"], frame["width"]
    u = torch.arange(0, w, stride, dtype=F64, device=device) - w / 2
    v = torch.arange(0, h, stride, dtype=F64, device=device) - h / 2
    dcr = (u * float(ar)).expand(v.numel(), u.numel())
    dci = (v * float(ai))[:, None].expand(v.numel(), u.numel())
    return dcr.reshape(-1), dci.reshape(-1)


def iterate(wr, wi, dcr, dci, iterations: int, limit: float, base=None, last=None,
            delta_dtype=None, period_eps_sq=None):
    """(cnt int32, dist float64, cycle int32 or None) of the pixels at δc =
    (dcr, dci), flat; the orbit table (wr, wi) on their device.

    ``base``/``last``: each pixel's orbit's first and last index in the
    table (default: the whole table).  ``delta_dtype``: δ and δc rounded to
    that type after every step (a control; the orbit stays float64).
    ``period_eps_sq``: also follow Brent's cycle test of kernel A's route
    (a snapshot of z at z_0 and after the renderer's steps 1, 2, 4, 8, ...;
    a pixel whose z comes within sqrt(eps) of it before it escapes stops
    there) and return, a pixel, the renderer's step at which it would stop
    (-1 where it never does)."""
    device = dcr.device
    rnd = (lambda x: x) if delta_dtype is None else (lambda x: x.to(delta_dtype).to(F64))
    dcr, dci = rnd(dcr.reshape(-1).to(F64)), rnd(dci.reshape(-1).to(F64))
    n = dcr.numel()
    base = torch.zeros(n, dtype=torch.long, device=device) if base is None else base
    last = torch.full((n,), wr.numel() - 1, dtype=torch.long, device=device) \
        if last is None else last
    limit_sq = float(limit) ** 2
    period = period_eps_sq is not None
    cnt = torch.full((n,), iterations, dtype=torch.int32, device=device)
    dist = torch.empty(n, dtype=F64, device=device)
    cycle = torch.full((n,), -1, dtype=torch.int32, device=device) if period else None
    idx = torch.arange(n, device=device)
    dr = torch.zeros(n, dtype=F64, device=device)
    di = torch.zeros_like(dr)
    ref = base.clone()
    cyc = torch.full((n,), -1, dtype=torch.int32, device=device) if period else None
    zr = zi = sr = si = None
    k = 0
    while k <= iterations and idx.numel():
        m = min(CHUNK, iterations + 1 - k)
        at = torch.full(idx.shape, -1, dtype=torch.int32, device=device)
        d_at = torch.zeros(idx.shape, dtype=F64, device=device)
        for j in range(m):
            s = k + j  # z below is the renderer's z_s
            br, bi = wr[ref], wi[ref]
            tr, ti = br + br + dr, bi + bi + di
            dr, di = rnd(tr * dr - ti * di + dcr), rnd(tr * di + ti * dr + dci)
            ref = ref + 1
            zr, zi = wr[ref] + dr, wi[ref] + di
            d = zr * zr + zi * zi
            if s >= 1:
                new = (d > limit_sq) & (at < 0)
                at = torch.where(new, s - 1, at)
                d_at = torch.where(new, d, d_at)
            if period:
                if s >= 1:
                    er, ei = zr - sr, zi - si
                    hit = (er * er + ei * ei < period_eps_sq) & (at < 0) & (cyc < 0)
                    cyc = torch.where(hit, s - 1, cyc)
                if s == 0 or (s - 1 >= 1 and (s - 1) & (s - 2) == 0):
                    sr, si = zr, zi
            rebase = (d < dr * dr + di * di) | (ref == last)
            dr = rnd(torch.where(rebase, zr, dr))
            di = rnd(torch.where(rebase, zi, di))
            ref = torch.where(rebase, base, ref)
        done = at >= 0
        cnt[idx[done]] = at[done]
        dist[idx[done]] = d_at[done]
        keep = ~done
        if period:
            cycle[idx[done]] = cyc[done]
            cyc, sr, si = cyc[keep], sr[keep], si[keep]
        idx, dr, di, dcr, dci, ref, base, last = (
            t[keep] for t in (idx, dr, di, dcr, dci, ref, base, last))
        zr, zi = zr[keep], zi[keep]
        k += m
    if idx.numel():
        dist[idx] = zr * zr + zi * zi
        if period:
            cycle[idx] = cyc
    return cnt, dist, cycle


def counts(frame, device, delta_dtype=None):
    """(cnt int32, dist float64) of every pixel of ``frame``, (H, W)."""
    wr, wi = orbit(centre(frame), frame["iterations"], frame["limit"])
    dcr, dci = delta_grid(frame, device)
    cnt, dist, _ = iterate(wr.to(device), wi.to(device), dcr, dci, frame["iterations"],
                           frame["limit"], delta_dtype=delta_dtype)
    shape = (frame["height"], frame["width"])
    return cnt.reshape(shape), dist.reshape(shape)


def lattice_steps(frames, device, stride: int, period_eps_sq: float):
    """Each frame's steps from z = c on every ``stride``-th pixel of every
    ``stride``-th row, all frames in one call: a list of (pixels counted,
    Σ steps to the escape or the budget, Σ steps to the escape, the cycle
    test's stop or the budget, whichever comes first)."""
    tables, grids, base, last = [], [], [], []
    at = 0
    for f in frames:
        wr, wi = orbit(centre(f), f["iterations"], f["limit"])
        dcr, dci = delta_grid(f, device, stride)
        tables.append((wr, wi))
        grids.append((dcr, dci))
        base.append(torch.full((dcr.numel(),), at, dtype=torch.long, device=device))
        last.append(torch.full((dcr.numel(),), at + wr.numel() - 1, dtype=torch.long,
                               device=device))
        at += wr.numel()
    iters = {f["iterations"] for f in frames}
    limits = {f["limit"] for f in frames}
    if len(iters) != 1 or len(limits) != 1:
        raise ValueError("lattice_steps takes frames of one budget and one limit")
    cnt, _, cycle = iterate(
        torch.cat([t[0] for t in tables]).to(device), torch.cat([t[1] for t in tables]).to(device),
        torch.cat([g[0] for g in grids]), torch.cat([g[1] for g in grids]),
        iters.pop(), limits.pop(), torch.cat(base), torch.cat(last),
        period_eps_sq=period_eps_sq)
    out, lo = [], 0
    for f, (dcr, _) in zip(frames, grids):
        c = cnt[lo:lo + dcr.numel()].to(torch.int64)
        y = cycle[lo:lo + dcr.numel()].to(torch.int64)
        lo += dcr.numel()
        budget = f["iterations"]
        to_escape = torch.where(c < budget, c + 1, budget)
        with_cycle = torch.where(y >= 0, torch.minimum(to_escape, y + 1), to_escape)
        out.append((dcr.numel(), int(to_escape.sum()), int(with_cycle.sum())))
    return out
