"""δ-orbit kernels B, C, D and E and the fe BLA route: the plain torch
versions and the wrappers over ``csrc/perturb.cu``, ``csrc/perturb_fe.cu``
and ``csrc/perturb_bla_fe.cu``.

Kernel B replaces ``fractal_tpu/ops/perturb.py::perturb_pallas_v2`` in its
three forms: dist-only (the p32 tier: frozen |z|² and count), full (frozen
z, count, flag) and glitch (full, plus the Pauldelbrot test).  Kernel C
replaces ``perturb_pallas_v2_points``: kernel B's body over a 1-D list of
pixels, δc given per pixel (the multiref and pan engine), in a loop of its
own that keeps the orbit in shared memory (``points_plan``,
``points_ring_plain``).  Every δ-recurrence the reference carries runs in
each form:

    quadratic    δz' = (2Z_n + δz)·δz + δc        (julia: no + δc)
    burning ship quadratic real part, diffabs imaginary part, products
                 pinned through the traced 1.0 (perturb.py:1342-1364)
    tricorn      δz'_i = −2(Z_r δz_i + Z_i δz_r + δz_r δz_i) + δc_i
    z^d          binomial Horner, coefficients C(d,j)·Z^(d−j)
    z = Z_{n+1} + δz'    escape when |z|² > limit²

from n0 = P[8] with the cubic series start, against a (rows, 2) float32
table of 2·Z_n (``perturb.orbit_table``) and, for the glitch form, a
(rows,) column of τ²·|Z_{n+1}|² (``perturb.glitch_column``).  The plain
versions run the whole pixel set in lock-step with freeze masks, in the
kernel's operation order; each wrapper runs its plain version only for CPU
tensors and launches the kernel for CUDA tensors.

Kernel D replaces ``perturb_pallas_fe`` (the extreme-depth tier past
pixel spacing 1e-30): the quadratic mandelbrot/julia δ-orbit in floatexp
(``ops/floatexp.py``), from n = 0 with δz₀ = δc and δc = (x − u0)·A formed
from the fe affine of ``perturb._pert_params_fe``, against the same table
and glitch column, in a grid form and a points form over (xs, ys).

The fe BLA route (``perturb_bla_fe``) replaces ``_perturb_tile_bla_fe``,
an XLA program with no Pallas kernel: the extreme-depth δ-orbit of views
whose extended-exponent BLA table is useful, in gate groups that jump all
their live pixels by a table level wherever the group's largest |δz|² lies
inside its radius.  One launch runs every group of a call, in one of two
state forms the wrapper picks from the call's shape (``bla_fe_form``):
registers (each thread keeps its pixels' state in registers for the whole
launch) or streaming (the state passes through device memory each phase);
its plain version decides each skip on the host.

Kernel E replaces ``perturb_pallas``: the quadratic mandelbrot/julia
δ-orbit of ``_perturb_tile`` against the (rows, 8) packed orbit
(``RefOrbit.packed``: Z_n, Z_{n+1}, τ²·|Z_{n+1}|²), which forms 2·Z_n in the
loop, scales δc by the gain P[5] and lets the escape test go before the
glitch test.  Nothing in either package renders through it; the probe
entry point (``tools/lean_probe``) runs it beside kernel B's glitch form.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from fractal_tpu_torch.models.rules import eff_power
from fractal_tpu_torch.ops import _cuda_build
from fractal_tpu_torch.ops import floatexp as fx

#: Steps between the plain versions' whole-set "anything live?" checks.
CHUNK = 64

#: Rows a chunk of kernel C's ring (``points_plan``).
RING_CHUNK = 2048

# rule ids shared with csrc/perturb.cu
RULE_SQUARE, RULE_BURNINGSHIP, RULE_TRICORN, RULE_POWER = 0, 1, 2, 3

#: Kernel launches made by each wrapper (plain-version calls excluded):
#: ``perturb_dist``, ``perturb_full``, ``perturb_points``,
#: ``perturb_fe_full``, ``perturb_fe_points``, ``perturb_bla_fe`` (all
#: forms; and by form, registers and streaming) and ``perturb_packed``.
LAUNCHES = 0
FULL_LAUNCHES = 0
POINT_LAUNCHES = 0
FE_FULL_LAUNCHES = 0
FE_POINT_LAUNCHES = 0
BLA_FE_LAUNCHES = 0
BLA_FE_REGISTER_LAUNCHES = 0
BLA_FE_STREAMING_LAUNCHES = 0
PACKED_LAUNCHES = 0
#: The state form of ``perturb_bla_fe``'s last launch ("registers" or
#: "streaming"; None before the first).
BLA_FE_FORM: Optional[str] = None


def rule_id(algo: str, power: int) -> int:
    if algo == "burningship":
        return RULE_BURNINGSHIP
    if algo == "tricorn":
        return RULE_TRICORN
    if algo in ("mandelbrot", "julia", "multibrot") and power >= 2:
        return RULE_SQUARE if power == 2 else RULE_POWER
    raise ValueError(f"no δ-recurrence for {algo} (power {power})")


def _delta_step(rule: int, julia: bool, br, bi, hbr, hbi, dzr, dzi, dcr, dci,
                pin, power: int):
    """δz' for one step (perturb.py:1342-1405, term for term)."""
    if rule == RULE_BURNINGSHIP:
        ndzr = ((br + dzr) * dzr) * pin - ((bi + dzi) * dzi) * pin + dcr * pin
        X = hbr * hbi
        x = (hbr * dzi) * pin + (hbi * dzr) * pin + (dzr * dzi) * pin
        nx = -x
        s = torch.where(X >= 0.0,
                        torch.where(X >= nx, x, -(2.0 * X + x)),
                        torch.where(X <= nx, -x, 2.0 * X + x))
        return ndzr, (2.0 * s) * pin + dci * pin
    if rule == RULE_TRICORN:
        ndzr = (br + dzr) * dzr - (bi + dzi) * dzi + dcr
        return ndzr, -2.0 * (hbr * dzi + hbi * dzr + dzr * dzi) + dci
    if rule == RULE_SQUARE:
        tr = br + dzr
        t2 = bi + dzi
        ndzr = tr * dzr - t2 * dzi
        ndzi = tr * dzi + t2 * dzr
    else:
        zp = [(hbr, hbi)]  # Z^1 .. Z^(d-1)
        for _ in range(power - 2):
            ar, ai = zp[-1]
            zp.append((ar * hbr - ai * hbi, ar * hbi + ai * hbr))
        accr = torch.ones_like(dzr)
        acci = torch.zeros_like(dzi)
        cj = 1
        for j in range(power - 1, 0, -1):
            cj = cj * (j + 1) // (power - j)  # C(d, j)
            cjr, cji = zp[power - 1 - j]
            tr = accr * dzr - acci * dzi + float(cj) * cjr
            ti = accr * dzi + acci * dzr + float(cj) * cji
            accr, acci = tr, ti
        ndzr = accr * dzr - acci * dzi
        ndzi = accr * dzi + acci * dzr
    if julia:
        return ndzr, ndzi
    return ndzr + dcr, ndzi + dci


def _delta_plain(table, gtol, P, n_steps: int, dcr, dci, *, iterations: int,
                 algo: str, power: int, glitch: bool, dist_only: bool):
    """Plain version of kernels B and C on any shape of δc: (d, cnt) for
    the dist-only form, else (zr, zi, cnt, gl)."""
    power = eff_power(algo, power)
    rule = rule_id(algo, power)
    julia = algo == "julia"
    device = table.device
    p = [P[i] for i in range(16)]
    limit_sq = p[4]

    # series start (perturb.py:1262-1270)
    rows = table.shape[0]
    n0 = min(max(int(P[8].item()), 0), rows - 1)
    dzr, dzi = series_start(P, dcr, dci)
    pin = p[15] * 0.0 + 1.0

    half = 0.5 * table  # Z_n, exact
    zfr = half[n0, 0] + dzr
    zfi = half[n0, 1] + dzi
    d = zfr * zfr + zfi * zfi
    cnt = torch.full(dcr.shape, n0, dtype=torch.int32, device=device)
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=device)
    for n in range(n0, n_steps):
        live = d <= limit_sq
        if (n - n0) % CHUNK == 0 and not bool(live.any()):
            break
        ndzr, ndzi = _delta_step(rule, julia, table[n, 0], table[n, 1],
                                 half[n, 0], half[n, 1], dzr, dzi, dcr, dci,
                                 pin, power)
        nzfr = half[n + 1, 0] + ndzr
        nzfi = half[n + 1, 1] + ndzi
        nd = nzfr * nzfr + nzfi * nzfi
        if glitch:
            nd = torch.where(nd < gtol[n], inf, nd)
        if not dist_only:
            zfr = torch.where(live, nzfr, zfr)
            zfi = torch.where(live, nzfi, zfi)
        d = torch.where(live, nd, d)
        cnt = cnt + live.to(torch.int32)
        dzr, dzi = ndzr, ndzi
    escaped = d > limit_sq
    cnt = torch.clamp(cnt - escaped.to(torch.int32), min=0)
    if dist_only:
        return d, cnt
    ran_out = ~escaped & (cnt >= n_steps) & (n_steps < iterations)
    return zfr, zfi, cnt, ((d == inf) | ran_out).to(torch.int32)


def _grid_dc(P, height: int, width: int, device):
    f32 = torch.float32
    xx = torch.arange(width, dtype=f32, device=device).expand(height, width)
    yy = torch.arange(height, dtype=f32, device=device)[:, None].expand(height, width)
    yy = yy * P[6] + P[7]  # global-row map (integer-valued, exact)
    return (xx - P[2]) * P[0], (yy - P[3]) * P[1]


def points_dc(P, xs, ys):
    """δc of a pixel list, as ``perturb.py:2296-2297`` computes it."""
    return (xs - P[2]) * P[0], (ys - P[3]) * P[1]


def perturb_dist_plain(table, P, n_steps: int, *, height: int, width: int,
                       algo: str = "mandelbrot", power: int = 2):
    """Plain torch version of kernel B's dist-only form → (d, cnt)."""
    dcr, dci = _grid_dc(P, height, width, table.device)
    return _delta_plain(table, None, P, n_steps, dcr, dci, iterations=n_steps,
                        algo=algo, power=power, glitch=False, dist_only=True)


def perturb_full_plain(table, gtol, P, n_steps: int, *, iterations: int,
                       height: int, width: int, algo: str = "mandelbrot",
                       power: int = 2, glitch: bool = True):
    """Plain torch version of kernel B's full (and glitch) form →
    (zr, zi, cnt, gl), each (height, width)."""
    dcr, dci = _grid_dc(P, height, width, table.device)
    return _delta_plain(table, gtol, P, n_steps, dcr, dci, iterations=iterations,
                        algo=algo, power=power, glitch=glitch, dist_only=False)


def perturb_points_plain(table, gtol, P, n_steps: int, xs, ys, *,
                         iterations: int, algo: str = "mandelbrot",
                         power: int = 2, glitch: bool = True):
    """Plain torch version of kernel C on pixel coordinates (xs, ys), each
    (k,) f32 → (zr, zi, cnt, gl), each (k,)."""
    dcr, dci = points_dc(P, xs, ys)
    return _delta_plain(table, gtol, P, n_steps, dcr, dci, iterations=iterations,
                        algo=algo, power=power, glitch=glitch, dist_only=False)


@functools.cache
def points_layout() -> tuple[int, int]:
    """Kernel C's (threads a block, rows a chunk's buffer holds past the
    chunk), as ``csrc/perturb.cu`` defines them."""
    threads, ahead = ctypes.c_int(), ctypes.c_int()
    _cuda_build.load().fractal_points_layout(threads, ahead)
    return threads.value, ahead.value


def points_plan(n_steps: int, k: int, glitch: bool, limits, layout) -> tuple[int, int]:
    """Kernel C's (chunk, nbuf) for k pixels against an n_steps orbit on a
    card with ``limits`` (``_cuda_build.smem_limits``: shared memory a block
    may opt in to, what one SM holds, SMs, what the card keeps back for each
    block; bytes) and the kernel's ``layout`` (``points_layout``).  The
    whole table from n0 (12 B a row with the glitch column, 8 B without) goes
    into one chunk where it fits a block and the list's blocks, spread
    evenly, fit the SMs with it (1 buffer, no barrier in the loop);
    otherwise the rows stream through a double-buffered ring of
    ``RING_CHUNK`` rows a chunk (2 buffers)."""
    per_block, per_sm, sms, reserved = limits
    threads, ahead = layout
    row = 12 if glitch else 8
    whole = (n_steps + ahead) * row
    blocks_per_sm = -(-(-(-k // threads)) // sms)
    if whole <= per_block and blocks_per_sm * (whole + reserved) <= per_sm:
        return n_steps, 1
    return RING_CHUNK, 2


def points_ring_plain(table, gtol, P, n_steps: int, xs, ys, *, iterations: int,
                      chunk: int, nbuf: int, ahead_rows: int, algo: str = "mandelbrot",
                      power: int = 2, glitch: bool = True):
    """Plain mirror of kernel C's own loop → (zr, zi, cnt, gl), each (k,):
    the rows from n0 copied chunk by chunk into a buffer of ``chunk`` +
    ``ahead_rows`` rows (indices clamped to the table's last row; rows
    past n_steps left NaN, so a result that reads one shows), two steps a
    pass, the next pass computed and the rows of the one after it fetched
    before the current pass is tested, a pass keeping its first step when
    that one leaves.  It runs the pixels in lock-step (every live pixel is at
    the same n) and must equal ``perturb_points_plain`` for every plan."""
    if nbuf not in (1, 2) or (chunk < n_steps if nbuf == 1 else chunk < 2 or chunk % 2):
        raise ValueError(f"no such plan: chunk {chunk}, nbuf {nbuf}")
    power = eff_power(algo, power)
    rule = rule_id(algo, power)
    julia = algo == "julia"
    rows = table.shape[0]
    n0 = min(max(int(P[8].item()), 0), rows - 1)
    limit_sq = P[4]
    L = chunk + ahead_rows
    nan = float("nan")

    def copy(base):  # copy_rows
        count = min(L, max(3, n_steps + 1 - base))
        r = torch.arange(base, base + count, device=table.device).clamp(max=rows - 1)
        z = torch.full((L, 2), nan, dtype=torch.float32, device=table.device)
        g = torch.full((L,), nan, dtype=torch.float32, device=table.device)
        z[:count] = table[r]
        if glitch:
            g[:count] = gtol[r]
        return z, g

    dcr, dci = points_dc(P, xs, ys)
    dzr, dzi = series_start(P, dcr, dci)
    pin = P[15] * 0.0 + 1.0
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=table.device)

    def step(b, b1, g, dzr, dzi):  # one_step
        ndzr, ndzi = _delta_step(rule, julia, b[0], b[1], 0.5 * b[0], 0.5 * b[1], dzr, dzi,
                                 dcr, dci, pin, power)
        zr = 0.5 * b1[0] + ndzr
        zi = 0.5 * b1[1] + ndzi
        d = zr * zr + zi * zi
        if glitch:
            d = torch.where(d < g, inf, d)
        return ndzr, ndzi, zr, zi, d

    def run_pass(r, dzr, dzi):  # → ((azr, azi, ad, bzr, bzi, bd), dz after the pass)
        adzr, adzi, azr, azi, ad = step(r[0], r[1], r[3], dzr, dzi)
        bdzr, bdzi, bzr, bzi, bd = step(r[1], r[2], r[4], adzr, adzi)
        return (azr, azi, ad, bzr, bzi, bd), bdzr, bdzi

    def rows_at(zb, gb, j):  # pass_rows
        return (zb[j], zb[j + 1], zb[j + 2]) + ((gb[j], gb[j + 1]) if glitch else (0.0, 0.0))

    bufs = [copy(n0)]
    zfr = 0.5 * bufs[0][0][0, 0] + dzr
    zfi = 0.5 * bufs[0][0][0, 1] + dzi
    d = zfr * zfr + zfi * zfi
    cnt = torch.full(dcr.shape, n0, dtype=torch.int32, device=table.device)
    live = d <= limit_sq

    def take(mask, zr_, zi_, d_, c):  # px = {zr_, zi_, d_, c} where mask
        nonlocal zfr, zfi, d, cnt
        zfr = torch.where(mask, zr_, zfr)
        zfi = torch.where(mask, zi_, zfi)
        d = torch.where(mask, d_, d)
        cnt = torch.where(mask, torch.full_like(cnt, c), cnt)

    n = n0
    cur, dzr, dzi = run_pass(rows_at(*bufs[0], 0), dzr, dzi)
    nxt = rows_at(*bufs[0], 2)
    base, c = n0, 0
    while True:
        zb, gb = bufs[c % nbuf]
        more = base + chunk < n_steps
        if more:
            nxt_buf = copy(base + chunk)
        end = min(base + chunk, n_steps)
        ahead, after, adzr, adzi = cur, nxt, dzr, dzi
        while bool(live.any()):
            j = n - base
            ahead, adzr, adzi = run_pass(nxt, dzr, dzi)
            after = (nxt[2], zb[j + 5], zb[j + 6]) + (
                (gb[j + 4], gb[j + 5]) if glitch else (0.0, 0.0))
            if not n + 3 < end:  # the same for every pixel
                break
            a_ok, b_ok = cur[2] <= limit_sq, cur[5] <= limit_sq
            stop = live & ~(a_ok & b_ok)  # these pixels leave at cur
            take(stop & ~a_ok, cur[0], cur[1], cur[2], n + 1)
            take(stop & a_ok, cur[3], cur[4], cur[5], n + 2)
            live = live & ~stop
            cur, nxt, dzr, dzi = ahead, after, adzr, adzi
            n += 2
        if bool(live.any()):  # every live pixel stopped at cur, the pass at n
            if n + 1 < end:
                a_ok = cur[2] <= limit_sq
                take(live & ~a_ok, cur[0], cur[1], cur[2], n + 1)
                take(live & a_ok, cur[3], cur[4], cur[5], n + 2)
                live = live & a_ok & (cur[5] <= limit_sq)
                n += 2
                cur, nxt, dzr, dzi = ahead, after, adzr, adzi
            if n < end:  # the single last step
                take(live, cur[0], cur[1], cur[2], n + 1)
                live = torch.zeros_like(live)
        if nbuf == 1 or not (more and bool(live.any())):
            break
        if len(bufs) < 2:
            bufs.append(None)
        bufs[(c + 1) % 2] = nxt_buf
        base, c = base + chunk, c + 1
    escaped = d > limit_sq
    cnt = torch.clamp(cnt - escaped.to(torch.int32), min=0)
    ran_out = ~escaped & (cnt >= n_steps) & (n_steps < iterations)
    return zfr, zfi, cnt, ((d == inf) | ran_out).to(torch.int32)


def series_start(P, dcr, dci):
    """The cubic series start δz_{n0} = ((C'u + B')u + A')·u, u = δc·P[15]
    (perturb.py:1075-1086), Horner in the kernels' operation order."""
    ur = dcr * P[15]
    ui = dci * P[15]
    t1r = P[13] * ur - P[14] * ui + P[11]
    t1i = P[13] * ui + P[14] * ur + P[12]
    t2r = t1r * ur - t1i * ui + P[9]
    t2i = t1r * ui + t1i * ur + P[10]
    return t2r * ur - t2i * ui, t2r * ui + t2i * ur


def perturb_packed_plain(packed, P, n_steps: int, *, iterations: int, height: int,
                         width: int):
    """Plain torch version of kernel E → (zr, zi, cnt, gl), each (height,
    width): ``_perturb_tile`` (perturb.py:402-551, power 2) in lock-step
    over the image, a pixel live while it has neither escaped, nor been
    flagged, nor fallen behind the step index."""
    dcr, dci = _grid_dc(P, height, width, packed.device)
    limit_sq = P[4]
    rows = packed.shape[0]
    n0 = min(max(int(P[8].item()), 0), rows - 1)
    dzr, dzi = series_start(P, dcr, dci)
    gcr, gci = dcr * P[5], dci * P[5]
    zfr = packed[n0, 0] + dzr
    zfi = packed[n0, 1] + dzi
    cnt = torch.full(dcr.shape, n0, dtype=torch.int32, device=packed.device)
    gl = torch.zeros_like(cnt)
    for n in range(n0, n_steps):
        live = (zfr * zfr + zfi * zfi <= limit_sq) & (cnt == n) & (gl == 0)
        if (n - n0) % CHUNK == 0 and not bool(live.any()):
            break
        row = packed[n]
        tr = 2.0 * row[0] + dzr
        ti = 2.0 * row[1] + dzi
        ndzr = tr * dzr - ti * dzi + gcr
        ndzi = tr * dzi + ti * dzr + gci
        nzfr = row[2] + ndzr
        nzfi = row[3] + ndzi
        d = nzfr * nzfr + nzfi * nzfi
        esc_now = d > limit_sq
        gl_now = live & ~esc_now & (d < row[4])
        dzr = torch.where(live, ndzr, dzr)
        dzi = torch.where(live, ndzi, dzi)
        zfr = torch.where(live, nzfr, zfr)
        zfi = torch.where(live, nzfi, zfi)
        cnt = cnt + (live & ~esc_now & ~gl_now).to(torch.int32)
        gl = gl | gl_now.to(torch.int32)
    ran_out = (zfr * zfr + zfi * zfi <= limit_sq) & (cnt >= n_steps) & (n_steps < iterations)
    return zfr, zfi, cnt, gl | ran_out.to(torch.int32)


# ---------------------------------------------------------------------------
# Kernel D: the floatexp δ-orbit (plain versions)
# ---------------------------------------------------------------------------


def fe_dc(P, xx, yy):
    """(δc_r, δc_i, gain-folded δc_r, δc_i) as (m, e) pairs from pixel
    coordinates and the fe P (perturb.py:847-853): δc = fe(x − u0)·(A_m,
    A_e); julia's gain 0 folds δc to a true zero (m 0, e ``E_ZERO``)."""
    dcr = fx.mul(fx.fe(xx - P[2]), (P[0], P[8].to(torch.int32)))
    dci = fx.mul(fx.fe(yy - P[3]), (P[1], P[9].to(torch.int32)))
    gain = P[5]

    def fold(a):
        return a[0] * gain, torch.where(gain == 0.0, fx.E_ZERO, a[1])

    return dcr, dci, fold(dcr), fold(dci)


def fe_step(b2r, b2i, zr1, zi1, dzr, dzi, dcr_g, dci_g):
    """One floatexp step (perturb.py:871-878): δz' = (fe(2Z_n) + δz)·δz
    + δc_g, then z = Z_{n+1} + to_float(δz') and |z|².  Returns (δz'_r,
    δz'_i, z_r, z_i, |z|²)."""
    tr = fx.add(fx.fe(b2r), dzr)
    ti = fx.add(fx.fe(b2i), dzi)
    pr, pi = fx.cmul(tr, ti, dzr, dzi)
    ndzr = fx.add(pr, dcr_g)
    ndzi = fx.add(pi, dci_g)
    nzfr = zr1 + fx.to_float(ndzr)
    nzfi = zi1 + fx.to_float(ndzi)
    return ndzr, ndzi, nzfr, nzfi, nzfr * nzfr + nzfi * nzfi


def ring_rows(table, gtol, start: int, count: int):
    """Plain twin of kernel D's shared-memory ring rows ``start`` ..
    ``start + count − 1``: row n is (fe(2Z_n) mantissas, Z_{n+1}, fe(2Z_n)
    exponents, τ²|Z_{n+1}|²) as ``(mr, mi, zr1, zi1, er, ei, g)``, indices
    clamped to the table's last row (the rows a chunk reads past it are
    never stepped), g 0 without a glitch column."""
    last = table.shape[0] - 1
    n = torch.arange(start, start + count, device=table.device)
    i, i1 = n.clamp(max=last), (n + 1).clamp(max=last)
    mr, er = fx.fe(table[i, 0])
    mi, ei = fx.fe(table[i, 1])
    g = torch.zeros(count, dtype=torch.float32, device=table.device) if gtol is None else gtol[i]
    return mr, mi, 0.5 * table[i1, 0], 0.5 * table[i1, 1], er, ei, g


def _check_fe_rule(algo: str, power: int) -> None:
    if algo not in ("mandelbrot", "julia") or eff_power(algo, power) != 2:
        raise ValueError(f"the floatexp δ-orbit is quadratic mandelbrot/julia "
                         f"only, not {algo} (power {power})")


def _delta_fe_plain(table, gtol, P, n_steps: int, xx, yy, *, iterations: int,
                    glitch: bool):
    """Plain version of kernel D on any shape of pixel coordinates →
    (zr, zi, cnt, gl).  Lock-step over the pixel set; a pixel's δz, z, |z|²
    and count change only on its live steps, so it equals the kernel's
    per-thread loop (and no exponent of a stopped pixel keeps doubling)."""
    dcr, dci, dcr_g, dci_g = fe_dc(P, xx, yy)
    limit_sq = P[4]
    half = 0.5 * table  # Z_n, exact
    dzr, dzi = dcr, dci
    zfr = half[0, 0] + fx.to_float(dzr)
    zfi = half[0, 1] + fx.to_float(dzi)
    d = zfr * zfr + zfi * zfi
    cnt = torch.zeros(zfr.shape, dtype=torch.int32, device=table.device)
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=table.device)
    for n in range(n_steps):
        live = d <= limit_sq
        if n % CHUNK == 0 and not bool(live.any()):
            break
        ndzr, ndzi, nzfr, nzfi, nd = fe_step(table[n, 0], table[n, 1], half[n + 1, 0],
                                             half[n + 1, 1], dzr, dzi, dcr_g, dci_g)
        if glitch:
            nd = torch.where(nd < gtol[n], inf, nd)
        dzr = tuple(torch.where(live, a, b) for a, b in zip(ndzr, dzr))
        dzi = tuple(torch.where(live, a, b) for a, b in zip(ndzi, dzi))
        zfr = torch.where(live, nzfr, zfr)
        zfi = torch.where(live, nzfi, zfi)
        d = torch.where(live, nd, d)
        cnt = cnt + live.to(torch.int32)
    escaped = d > limit_sq
    cnt = torch.clamp(cnt - escaped.to(torch.int32), min=0)
    ran_out = ~escaped & (cnt >= n_steps) & (n_steps < iterations)
    return zfr, zfi, cnt, ((d == inf) | ran_out).to(torch.int32)


def grid_xy(P, height: int, width: int, device):
    f32 = torch.float32
    xx = torch.arange(width, dtype=f32, device=device).expand(height, width)
    yy = torch.arange(height, dtype=f32, device=device)[:, None].expand(height, width)
    return xx, yy * P[6] + P[7]  # global-row map (integer-valued, exact)


def perturb_fe_full_plain(table, gtol, P, n_steps: int, *, iterations: int,
                          height: int, width: int, algo: str = "mandelbrot",
                          power: int = 2, glitch: bool = True):
    """Plain torch version of kernel D's grid form (``glitch``: with the
    Pauldelbrot test) → (zr, zi, cnt, gl), each (height, width)."""
    _check_fe_rule(algo, power)
    xx, yy = grid_xy(P, height, width, table.device)
    return _delta_fe_plain(table, gtol, P, n_steps, xx, yy, iterations=iterations,
                           glitch=glitch)


def perturb_fe_points_plain(table, gtol, P, n_steps: int, xs, ys, *,
                            iterations: int, algo: str = "mandelbrot",
                            power: int = 2, glitch: bool = True):
    """Plain torch version of kernel D's points form on pixel coordinates
    (xs, ys), each (k,) f32 → (zr, zi, cnt, gl), each (k,)."""
    _check_fe_rule(algo, power)
    return _delta_fe_plain(table, gtol, P, n_steps, xs, ys, iterations=iterations,
                           glitch=glitch)


# ---------------------------------------------------------------------------
# The fe BLA route: the extended-exponent macro-skip loop
# ---------------------------------------------------------------------------

#: The smallest stored table level (skips of 64 steps and more), the skip
#: attempts before each run of plain steps, and the plain steps of a run.
BLA_MIN_LEVEL = 6
SKIP_SCANS = 4
FE_BLA_CHUNK = 4
#: Most table levels the kernel takes (csrc/perturb_bla_fe.cu MAX_LEVELS).
BLA_MAX_LEVELS = 32


def bla_fe_form(groups: int, height: int, width: int, resident: int, threads: int,
                k: int) -> str:
    """The fe BLA kernel's state form for ``groups`` gate groups of
    ``height`` x ``width`` pixels: "registers" where every group's pixels fit
    blocks of ``threads`` threads holding ``k`` pixels a thread, and those
    blocks fit the ``resident`` blocks of the register form that the card
    holds at once (its occupancy x SMs), else "streaming"."""
    per_group = -(-(height * width) // (threads * k))
    return "registers" if groups * per_group <= resident else "streaming"


_BLA_LAYOUT: dict = {}


def bla_fe_layout(device, glitch: bool) -> tuple[int, int, int]:
    """The register form's (threads a block, pixels a thread, blocks
    co-resident on ``device``) for the kernel instance of ``glitch``, read
    once from the runtime."""
    device = torch.device(device)
    key = (device.index if device.index is not None else torch.cuda.current_device(),
           bool(glitch))
    if key not in _BLA_LAYOUT:
        vals = [ctypes.c_int() for _ in range(3)]
        with torch.cuda.device(key[0]):
            err = _cuda_build.load().fractal_bla_fe_layout(int(key[1]), *vals)
        _raise_on(err, "fractal_bla_fe_layout")
        _BLA_LAYOUT[key] = tuple(v.value for v in vals)
    return _BLA_LAYOUT[key]


def _bla_fe_group(pk, P, n_steps: int, bla, xx, yy, *, iterations: int, glitch: bool,
                  stats: Optional[dict]):
    """One gate group of the fe BLA route at pixel coordinates (xx, yy) →
    (zr, zi, cnt, gl) of their shape; ``stats`` (when not None) gains the
    group's work (``perturb_bla_fe_plain``)."""
    dev = pk.device
    i32 = torch.int32
    dcr, dci, dcr_g, dci_g = fe_dc(P, xx, yy)
    gain, limit_sq = P[5], P[4]
    zfr = pk[0, 0] + fx.to_float(dcr)
    zfi = pk[0, 1] + fx.to_float(dci)
    zero = torch.zeros(zfr.shape, dtype=i32, device=dev)
    state = (dcr, dci, zfr, zfi, zero, zero)
    table = bla.packed
    n_levels = len(bla.offsets)

    def active(state, n):
        _, _, zfr, zfi, cnt, gl = state
        return (zfr * zfr + zfi * zfi <= limit_sq) & (cnt == n) & (gl == 0)

    def one_step(n, state):
        if n >= n_steps:
            return state  # no pixel is live past the orbit
        dzr, dzi, zfr, zfi, cnt, gl = state
        live = active(state, n)
        if stats is not None:
            stats["pixel_steps"] += int(live.sum())
        ndzr, ndzi, nzfr, nzfi, d = fe_step(
            2.0 * pk[n, 0], 2.0 * pk[n, 1], pk[n, 2], pk[n, 3], dzr, dzi, dcr_g, dci_g)
        esc_now = d > limit_sq
        gl_now = live & ~esc_now & (d < pk[n, 4]) if glitch else torch.zeros_like(live)
        dzr = tuple(torch.where(live, a, b) for a, b in zip(ndzr, dzr))
        dzi = tuple(torch.where(live, a, b) for a, b in zip(ndzi, dzi))
        zfr = torch.where(live, nzfr, zfr)
        zfi = torch.where(live, nzfi, zfi)
        cnt = cnt + (live & ~esc_now & ~gl_now).to(i32)
        return dzr, dzi, zfr, zfi, cnt, gl | gl_now.to(i32)

    def scalar(v, dtype):
        return torch.tensor(v, dtype=dtype, device=dev)

    def try_skip(state, n):
        dzr, dzi, zfr, zfi, cnt, gl = state
        live = active(state, n) & (n < n_steps)
        if stats is not None:
            stats["gates"] += int(live.sum())
        m2 = fx.add(fx.mul(dzr, dzr), fx.mul(dzi, dzi))
        has = live & (m2[0] > 0.0)
        maxe = torch.where(has, m2[1], fx.E_ZERO).max()
        maxm = torch.where(has & (m2[1] == maxe), m2[0], 0.0).max()
        maxe, maxm = int(maxe), float(maxm)
        row = None
        for lev in range(n_levels - 1, -1, -1):
            step = 1 << (lev + BLA_MIN_LEVEL)
            # the reference's dynamic_slice clamps the row index
            r = table[min(bla.offsets[lev] + (n >> (lev + BLA_MIN_LEVEL)),
                          table.shape[0] - 1)]
            r2m, r2e = float(r[6]), int(r[7])
            if n & (step - 1) == 0 and n + step <= n_steps and r2m > 0.0 \
                    and (maxe < r2e or (maxe == r2e and maxm < r2m)):
                row = r
                break
        if row is None:
            return state, n
        if stats is not None:
            stats["skips"] += 1
            stats["pixel_skips"] += int(live.sum())
        f32 = torch.float32
        sA = (scalar(float(row[0]), f32), scalar(float(row[1]), f32),
              scalar(int(row[2]), i32))
        sB = (scalar(float(row[3]), f32), scalar(float(row[4]), f32),
              scalar(int(row[5]), i32))
        skr, ski = fx.cmul((sA[0], sA[2]), (sA[1], sA[2]), dzr, dzi)
        tbr, tbi = fx.cmul((sB[0], sB[2]), (sB[1], sB[2]), dcr, dci)
        # δc term gain-folded (julia: a true zero, like δc_g)
        tbr = (tbr[0] * gain, torch.where(gain == 0.0, fx.E_ZERO, tbr[1]))
        tbi = (tbi[0] * gain, torch.where(gain == 0.0, fx.E_ZERO, tbi[1]))
        ndzr = fx.add(skr, tbr)
        ndzi = fx.add(ski, tbi)
        land = n + step
        dzr = tuple(torch.where(live, a, b) for a, b in zip(ndzr, dzr))
        dzi = tuple(torch.where(live, a, b) for a, b in zip(ndzi, dzi))
        zfr = torch.where(live, pk[land, 0] + fx.to_float(ndzr), zfr)
        zfi = torch.where(live, pk[land, 1] + fx.to_float(ndzi), zfi)
        cnt = cnt + live.to(i32) * step
        return (dzr, dzi, zfr, zfi, cnt, gl), land

    n = macro = attempts = 0
    while n < iterations and n < n_steps and bool(active(state, n).any()):
        for _ in range(SKIP_SCANS):
            attempts += 1
            state, land = try_skip(state, n)
            if land == n:  # no level, nothing changed: no later attempt finds one
                break
            n = land
        for i in range(FE_BLA_CHUNK):
            state = one_step(n + i, state)
        n += FE_BLA_CHUNK
        macro += 1
    if stats is not None:
        stats["macro_steps"].append(macro)
        stats["attempts"].append(attempts)
    _, _, zfr, zfi, cnt, gl = state
    ran_out = ((zfr * zfr + zfi * zfi <= limit_sq) & (cnt >= n_steps)
               & (n_steps < iterations))
    return zfr, zfi, cnt, gl | ran_out.to(i32)


def perturb_bla_fe_plain(pk, P, n_steps: int, bla, *, iterations: int, height: int,
                         width: int, glitch: bool = True, groups: int = 1,
                         stats: Optional[dict] = None):
    """Plain torch version of the fe BLA route (``_perturb_tile_bla_fe``,
    fractal_tpu/ops/perturb.py:915-1072) on ``pk``'s device → (zr, zi, cnt,
    gl), each (groups · height, width).

    ``pk`` is the (rows, 5) packed orbit (Z_n, Z_{n+1}, τ²|Z_{n+1}|²; row
    n_steps holds Z = 0), ``P`` the fe P block, ``bla`` the extended-exponent
    ``ops/bla.BLATable`` (its ``packed`` a host array or a tensor).  Rows y of the call map to the plane as
    y·P[6] + P[7]; each run of ``height`` rows is one gate group, the
    pixels that share one skip gate (one 256-row band of the reference's
    render, or a shard's stripe).  A group runs the floatexp δ-orbit of its
    pixels in lock-step; before every ``FE_BLA_CHUNK`` plain steps, up to
    ``SKIP_SCANS`` greedy skip attempts, each jumping all live pixels by the
    largest aligned table level whose radius² exceeds the group's max |δz|²
    (compared lexicographically on (e, m)): δz ← A·δz + gain·B·δc.  An
    attempt that finds no level changes nothing, so the reference's later
    attempts of that macro step find none either and are not run.  The
    skip decision is taken on the host from the two reduced scalars; it is
    the reference's on-device select, value for value.  ``glitch`` False is
    the p32 tier (the reference zeroes the tolerance column).  ``stats``
    (a dict) gains the work done: ``macro_steps`` and ``attempts`` (lists,
    one count a group), ``skips`` taken, and the pixels of the gates, the
    skips and the plain steps (``gates``, ``pixel_skips``,
    ``pixel_steps``)."""
    if torch.is_tensor(bla.packed):  # its rows are read on the host
        bla = bla._replace(packed=bla.packed.cpu().numpy())
    if stats is not None:
        for k in ("gates", "skips", "pixel_skips", "pixel_steps"):
            stats.setdefault(k, 0)
        stats.setdefault("macro_steps", [])
        stats.setdefault("attempts", [])
    xx, yy = grid_xy(P, groups * height, width, pk.device)
    outs = [_bla_fe_group(pk, P, n_steps, bla, xx[j * height:(j + 1) * height],
                          yy[j * height:(j + 1) * height], iterations=iterations,
                          glitch=glitch, stats=stats) for j in range(groups)]
    return tuple(torch.cat(parts, 0) for parts in zip(*outs))


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _on_cpu(*tensors) -> bool:
    return all(t is None or t.device.type == "cpu" for t in tensors)


def _check(table, gtol, P, n_steps: int, glitch: bool, **extra) -> int:
    """Device, dtype, shape and contiguity checks of a launch; returns rows."""
    named = {"table": table, "P": P, **extra}
    if glitch or gtol is not None:
        named["gtol"] = gtol
    for name, t in named.items():
        if t is None or t.device.type != "cuda" or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 CUDA tensor, got "
                             f"{None if t is None else (t.dtype, t.device)}")
        if t.device != table.device:
            raise ValueError(f"{name} on {t.device} but table on {table.device}")
    rows = table.shape[0]
    if table.dim() != 2 or table.shape[1] != 2 or P.shape != (16,):
        raise ValueError(f"want table (rows, 2) and P (16,), got "
                         f"{tuple(table.shape)} and {tuple(P.shape)}")
    if "gtol" in named and gtol.shape != (rows,):
        raise ValueError(f"want gtol ({rows},), got {tuple(gtol.shape)}")
    if not 0 <= n_steps < rows:
        raise ValueError(f"n_steps {n_steps} outside the {rows}-row table")
    return rows


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: {_cuda_build.error_string(err)}")


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def perturb_dist(table, P, n_steps: int, *, height: int, width: int,
                 algo: str = "mandelbrot", power: int = 2):
    """Kernel B, dist-only form, on ``table``'s device: (d f32, cnt i32),
    each (height, width).  CPU tensors run ``perturb_dist_plain``; CUDA
    tensors launch ``csrc/perturb.cu``."""
    if _on_cpu(table, P):
        return perturb_dist_plain(table, P, n_steps, height=height, width=width,
                                  algo=algo, power=power)
    rows = _check(table, None, P, n_steps, False)
    if height <= 0 or width <= 0:
        raise ValueError("height/width must be positive")
    pw = eff_power(algo, power)
    rule = rule_id(algo, pw)
    d = torch.empty((height, width), dtype=torch.float32, device=table.device)
    cnt = torch.empty((height, width), dtype=torch.int32, device=table.device)
    err = _cuda_build.load().fractal_perturb_dist(
        P.data_ptr(), table.data_ptr(), rows, int(n_steps), rule,
        int(algo == "julia"), pw, int(height), int(width), d.data_ptr(),
        cnt.data_ptr(), torch.cuda.current_stream(table.device).cuda_stream)
    _raise_on(err, "perturb_dist kernel")
    global LAUNCHES
    LAUNCHES += 1
    return d, cnt


def perturb_full(table, gtol, P, n_steps: int, *, iterations: int, height: int,
                 width: int, algo: str = "mandelbrot", power: int = 2,
                 glitch: bool = True):
    """Kernel B, full form (``glitch``: the glitch form), on ``table``'s
    device: (zr f32, zi f32, cnt i32, gl i32), each (height, width)."""
    if _on_cpu(table, gtol, P):
        return perturb_full_plain(table, gtol, P, n_steps, iterations=iterations,
                                  height=height, width=width, algo=algo,
                                  power=power, glitch=glitch)
    rows = _check(table, gtol, P, n_steps, glitch)
    if height <= 0 or width <= 0 or iterations < 0:
        raise ValueError("height/width must be positive and iterations >= 0")
    pw = eff_power(algo, power)
    rule = rule_id(algo, pw)
    dev = table.device
    zr = torch.empty((height, width), dtype=torch.float32, device=dev)
    zi = torch.empty_like(zr)
    cnt = torch.empty((height, width), dtype=torch.int32, device=dev)
    gl = torch.empty_like(cnt)
    err = _cuda_build.load().fractal_perturb_full(
        P.data_ptr(), table.data_ptr(), _ptr(gtol), rows, int(n_steps),
        int(iterations), rule, int(algo == "julia"), int(bool(glitch)), pw,
        int(height), int(width), zr.data_ptr(), zi.data_ptr(), cnt.data_ptr(),
        gl.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "perturb_full kernel")
    global FULL_LAUNCHES
    FULL_LAUNCHES += 1
    return zr, zi, cnt, gl


def perturb_points(table, gtol, P, n_steps: int, xs, ys, *, iterations: int,
                   algo: str = "mandelbrot", power: int = 2, glitch: bool = True):
    """Kernel C on ``table``'s device: pixel coordinates (xs, ys), each (k,)
    f32 → (zr, zi, cnt, gl), each (k,).  δc is computed here with torch ops
    (``points_dc``); CPU tensors run ``perturb_points_plain``."""
    if _on_cpu(table, gtol, P, xs, ys):
        return perturb_points_plain(table, gtol, P, n_steps, xs, ys,
                                    iterations=iterations, algo=algo,
                                    power=power, glitch=glitch)
    rows = _check(table, gtol, P, n_steps, glitch, xs=xs, ys=ys)
    if xs.dim() != 1 or xs.shape != ys.shape or xs.numel() == 0:
        raise ValueError(f"want xs, ys of one shape (k,), got "
                         f"{tuple(xs.shape)} and {tuple(ys.shape)}")
    if iterations < 0:
        raise ValueError("iterations must be >= 0")
    pw = eff_power(algo, power)
    rule = rule_id(algo, pw)
    dcr, dci = points_dc(P, xs, ys)
    k = xs.numel()
    dev = table.device
    chunk, nbuf = points_plan(int(n_steps), k, bool(glitch), _cuda_build.smem_limits(dev),
                              points_layout())
    zr = torch.empty(k, dtype=torch.float32, device=dev)
    zi = torch.empty_like(zr)
    cnt = torch.empty(k, dtype=torch.int32, device=dev)
    gl = torch.empty_like(cnt)
    err = _cuda_build.load().fractal_perturb_points(
        P.data_ptr(), table.data_ptr(), _ptr(gtol), rows, int(n_steps),
        int(iterations), rule, int(algo == "julia"), int(bool(glitch)), pw,
        dcr.data_ptr(), dci.data_ptr(), k, chunk, nbuf, zr.data_ptr(), zi.data_ptr(),
        cnt.data_ptr(), gl.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "perturb_points kernel")
    global POINT_LAUNCHES
    POINT_LAUNCHES += 1
    return zr, zi, cnt, gl


def _fe_outputs(shape, device):
    zr = torch.empty(shape, dtype=torch.float32, device=device)
    cnt = torch.empty(shape, dtype=torch.int32, device=device)
    return zr, torch.empty_like(zr), cnt, torch.empty_like(cnt)


def perturb_fe_full(table, gtol, P, n_steps: int, *, iterations: int, height: int,
                    width: int, algo: str = "mandelbrot", power: int = 2,
                    glitch: bool = True):
    """Kernel D, grid form, on ``table``'s device: (zr f32, zi f32, cnt i32,
    gl i32), each (height, width); ``P`` is the fe block.  CPU tensors run
    ``perturb_fe_full_plain``; CUDA tensors launch ``csrc/perturb_fe.cu``."""
    if _on_cpu(table, gtol, P):
        return perturb_fe_full_plain(table, gtol, P, n_steps, iterations=iterations,
                                     height=height, width=width, algo=algo,
                                     power=power, glitch=glitch)
    _check_fe_rule(algo, power)
    rows = _check(table, gtol, P, n_steps, glitch)
    if height <= 0 or width <= 0 or iterations < 0:
        raise ValueError("height/width must be positive and iterations >= 0")
    zr, zi, cnt, gl = _fe_outputs((height, width), table.device)
    err = _cuda_build.load().fractal_perturb_fe_full(
        P.data_ptr(), table.data_ptr(), _ptr(gtol), rows, int(n_steps),
        int(iterations), int(bool(glitch)), int(height), int(width), zr.data_ptr(),
        zi.data_ptr(), cnt.data_ptr(), gl.data_ptr(),
        torch.cuda.current_stream(table.device).cuda_stream)
    _raise_on(err, "perturb_fe_full kernel")
    global FE_FULL_LAUNCHES
    FE_FULL_LAUNCHES += 1
    return zr, zi, cnt, gl


def perturb_fe_points(table, gtol, P, n_steps: int, xs, ys, *, iterations: int,
                      algo: str = "mandelbrot", power: int = 2, glitch: bool = True):
    """Kernel D, points form, on ``table``'s device: pixel coordinates (xs,
    ys), each (k,) f32 → (zr, zi, cnt, gl), each (k,); the kernel forms δc
    from them as the grid form does.  CPU tensors run
    ``perturb_fe_points_plain``."""
    if _on_cpu(table, gtol, P, xs, ys):
        return perturb_fe_points_plain(table, gtol, P, n_steps, xs, ys,
                                       iterations=iterations, algo=algo,
                                       power=power, glitch=glitch)
    _check_fe_rule(algo, power)
    rows = _check(table, gtol, P, n_steps, glitch, xs=xs, ys=ys)
    if xs.dim() != 1 or xs.shape != ys.shape or xs.numel() == 0:
        raise ValueError(f"want xs, ys of one shape (k,), got "
                         f"{tuple(xs.shape)} and {tuple(ys.shape)}")
    if iterations < 0:
        raise ValueError("iterations must be >= 0")
    k = xs.numel()
    zr, zi, cnt, gl = _fe_outputs((k,), table.device)
    err = _cuda_build.load().fractal_perturb_fe_points(
        P.data_ptr(), table.data_ptr(), _ptr(gtol), rows, int(n_steps),
        int(iterations), int(bool(glitch)), xs.data_ptr(), ys.data_ptr(), k,
        zr.data_ptr(), zi.data_ptr(), cnt.data_ptr(), gl.data_ptr(),
        torch.cuda.current_stream(table.device).cuda_stream)
    _raise_on(err, "perturb_fe_points kernel")
    global FE_POINT_LAUNCHES
    FE_POINT_LAUNCHES += 1
    return zr, zi, cnt, gl


def perturb_bla_fe(pk, P, n_steps: int, bla, *, iterations: int, height: int, width: int,
                   glitch: bool = True, groups: int = 1):
    """The fe BLA route on ``pk``'s device → (zr f32, zi f32, cnt i32, gl
    i32), each (groups · height, width): ``groups`` gate groups of
    ``height`` rows (``perturb_bla_fe_plain``); ``bla.packed`` is the
    table's (rows, 8) f32 tensor on ``pk``'s device
    (``perturb._bla_tensor``).  CPU tensors run the plain version; CUDA
    tensors launch ``csrc/perturb_bla_fe.cu`` once for every group, the
    skip gates and the loop's exit decided on the device, in the state form
    ``bla_fe_form`` picks from the call's shape and the card's occupancy
    (``BLA_FE_FORM`` names it after the launch)."""
    if _on_cpu(pk, P):
        return perturb_bla_fe_plain(pk, P, n_steps, bla, iterations=iterations,
                                    height=height, width=width, glitch=glitch,
                                    groups=groups)
    table = bla.packed
    if not torch.is_tensor(table):
        raise ValueError("bla.packed must be the table's tensor on pk's device")
    for name, t in (("pk", pk), ("P", P), ("bla.packed", table)):
        if t.device.type != "cuda" or t.dtype != torch.float32 or not t.is_contiguous() \
                or t.device != pk.device:
            raise ValueError(f"{name} must be a contiguous float32 CUDA tensor on one "
                             f"device, got {(t.dtype, t.device)}")
    if pk.dim() != 2 or pk.shape[1] != 5 or P.shape != (16,):
        raise ValueError(f"want pk (rows, 5) and P (16,), got {tuple(pk.shape)} and "
                         f"{tuple(P.shape)}")
    rows = pk.shape[0]
    if not 0 <= n_steps < rows:
        raise ValueError(f"n_steps {n_steps} outside the {rows}-row packed orbit")
    if groups <= 0 or height <= 0 or width <= 0 or iterations < 0:
        raise ValueError("groups/height/width must be positive and iterations >= 0")
    n_levels = len(bla.offsets)
    if not 1 <= n_levels <= BLA_MAX_LEVELS or table.dim() != 2 or table.shape[1] != 8:
        raise ValueError(f"want a (rows, 8) table of 1-{BLA_MAX_LEVELS} levels, got "
                         f"{tuple(table.shape)}, {n_levels} levels")
    dev = pk.device
    threads, k, resident = bla_fe_layout(dev, glitch)
    form = bla_fe_form(groups, height, width, resident, threads, k)
    zr, zi, cnt, gl = _fe_outputs((groups * height, width), dev)
    # the streaming form's dz planes; the register form keeps dz in registers
    dz = (torch.empty((4, groups * height * width), dtype=torch.int32, device=dev)
          if form == "streaming" else None)
    # the gate slots: 3 x groups u64 keys, 3 x groups live votes, 3 go-on votes
    slots = torch.zeros(9 * groups + 3, dtype=torch.int32, device=dev)
    base = slots.data_ptr()
    offsets = (ctypes.c_int * n_levels)(*bla.offsets)
    with torch.cuda.device(dev):
        err = _cuda_build.load().fractal_perturb_bla_fe(
            P.data_ptr(), pk.data_ptr(), rows, int(n_steps), int(iterations),
            table.data_ptr(), table.shape[0], offsets, n_levels, BLA_MIN_LEVEL,
            int(bool(glitch)), int(form == "registers"), int(groups), int(height), int(width),
            zr.data_ptr(), zi.data_ptr(), cnt.data_ptr(), gl.data_ptr(), _ptr(dz), base,
            base + 24 * groups, base + 36 * groups,
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, f"perturb_bla_fe kernel ({form})")
    global BLA_FE_LAUNCHES, BLA_FE_REGISTER_LAUNCHES, BLA_FE_STREAMING_LAUNCHES, BLA_FE_FORM
    BLA_FE_LAUNCHES += 1
    if form == "registers":
        BLA_FE_REGISTER_LAUNCHES += 1
    else:
        BLA_FE_STREAMING_LAUNCHES += 1
    BLA_FE_FORM = form
    return zr, zi, cnt, gl


def perturb_packed(packed, P, n_steps: int, *, iterations: int, height: int, width: int):
    """Kernel E on ``packed``'s device: the (rows, 8) f32 packed orbit and
    the P block → (zr f32, zi f32, cnt i32, gl i32), each (height, width).
    CPU tensors run ``perturb_packed_plain``; CUDA tensors launch
    ``csrc/perturb.cu``."""
    if _on_cpu(packed, P):
        return perturb_packed_plain(packed, P, n_steps, iterations=iterations,
                                    height=height, width=width)
    for name, t in (("packed", packed), ("P", P)):
        if t.device.type != "cuda" or t.dtype != torch.float32 or not t.is_contiguous() \
                or t.device != packed.device:
            raise ValueError(f"{name} must be a contiguous float32 CUDA tensor on one "
                             f"device, got {(t.dtype, t.device)}")
    if packed.dim() != 2 or packed.shape[1] != 8 or P.shape != (16,):
        raise ValueError(f"want packed (rows, 8) and P (16,), got "
                         f"{tuple(packed.shape)} and {tuple(P.shape)}")
    rows = packed.shape[0]
    if not 0 <= n_steps < rows:
        raise ValueError(f"n_steps {n_steps} outside the {rows}-row table")
    if height <= 0 or width <= 0 or iterations < 0:
        raise ValueError("height/width must be positive and iterations >= 0")
    zr, zi, cnt, gl = _fe_outputs((height, width), packed.device)
    err = _cuda_build.load().fractal_perturb_packed(
        P.data_ptr(), packed.data_ptr(), rows, int(n_steps), int(iterations), int(height),
        int(width), zr.data_ptr(), zi.data_ptr(), cnt.data_ptr(), gl.data_ptr(),
        torch.cuda.current_stream(packed.device).cuda_stream)
    _raise_on(err, "perturb_packed kernel")
    global PACKED_LAUNCHES
    PACKED_LAUNCHES += 1
    return zr, zi, cnt, gl


def bind(lib: ctypes.CDLL) -> None:
    """Declare the C signatures of ``csrc/perturb.cu``'s entry points."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fractal_perturb_dist.argtypes = [p, p, i, i, i, i, i, i, i, p, p, p]
    lib.fractal_perturb_dist.restype = i
    lib.fractal_perturb_full.argtypes = [p, p, p, i, i, i, i, i, i, i, i, i,
                                         p, p, p, p, p]
    lib.fractal_perturb_full.restype = i
    lib.fractal_perturb_points.argtypes = [p, p, p, i, i, i, i, i, i, i, p, p, i, i, i,
                                           p, p, p, p, p]
    lib.fractal_perturb_points.restype = i
    lib.fractal_points_layout.argtypes = [ctypes.POINTER(i)] * 2
    lib.fractal_points_layout.restype = i
    lib.fractal_perturb_fe_full.argtypes = [p, p, p, i, i, i, i, i, i, p, p, p, p, p]
    lib.fractal_perturb_fe_full.restype = i
    lib.fractal_perturb_fe_points.argtypes = [p, p, p, i, i, i, i, p, p, i,
                                              p, p, p, p, p]
    lib.fractal_perturb_fe_points.restype = i
    lib.fractal_perturb_packed.argtypes = [p, p, i, i, i, i, i, p, p, p, p, p]
    lib.fractal_perturb_packed.restype = i
    bind_bla_fe(lib)


def bind_bla_fe(lib: ctypes.CDLL) -> None:
    """Declare the C signatures of ``csrc/perturb_bla_fe.cu``'s entry points
    (also on a library built from a variant of it, ``tools/bla_phase``)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fractal_perturb_bla_fe.argtypes = [p, p, i, i, i, p, i, ctypes.POINTER(i), i, i, i,
                                           i, i, i, i, p, p, p, p, p, p, p, p, p]
    lib.fractal_perturb_bla_fe.restype = i
    lib.fractal_bla_fe_layout.argtypes = [i] + [ctypes.POINTER(i)] * 3
    lib.fractal_bla_fe_layout.restype = i
