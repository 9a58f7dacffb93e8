"""The fe BLA kernel's closed-domain choices (csrc/perturb_bla_fe.cu) through a
torch mirror, against its plain version, on the CPU.

The kernel runs a pixel's four plain steps and its next gate's |δz|² in
kernel D's closed-domain ops (csrc/floatexp.cuh) where its δz and δc_g are
ready for them (``floatexp.step_ready``: in the closed domain, exponents at
or above −2^23) and every orbit row of the run lies in the domain
(``floatexp.in_domain``), and in the general ops everywhere else, the
skip's products always.  ``mirror_bla_fe`` repeats those choices pixel by
pixel with ``floatexp.closed_add``, ``closed_mul`` and ``closed_to_float``,
and ``perturb_bla_fe_plain`` (the general ops throughout) is the yardstick:
bit-equal in both forms at the interior strip of the 1e40× minibrot, at its
edge @1e31 and at two seeded cases that leave the domain
(``chip_smoke.bla_crossing_inputs``, which the card check runs too: orbit
rows whose 2·Z_n is subnormal; table rows whose A is 0 and B subnormal, so a
skip's δz leaves it), where the test asserts the crossing happened and that the
closed ops would have given other bits than the general ops on the steps
the predicate kept out of them.  The predicates
are held against the domain's definition on seeded values and its edges,
and the wrapper's choice of state form is a pure function of the call's
shape and the card's occupancy.
"""

import numpy as np
import pytest
import torch

from chip_smoke import bla_crossing_inputs
from fractal_tpu_torch import interop
from fractal_tpu_torch.ops import floatexp as fx
from fractal_tpu_torch.ops import perturb as tpt
from fractal_tpu_torch.ops import perturb_cuda as tpc
from tests.test_torch_bla_fe import EDGE, STRIP, _assert_bits_equal, _fresh_caches  # noqa: F401

E_ZERO = fx.E_ZERO
GENERAL = (fx.add, fx.mul, fx.to_float)
CLOSED = (fx.closed_add, fx.closed_mul, fx.closed_to_float)


def _step(ops, b2r, b2i, zr1, zi1, dzr, dzi, dcr_g, dci_g):
    """``perturb_cuda.fe_step`` on the ops ``ops`` (add, mul, to_float), and
    its first sums fe(2Z_n) + δz."""
    add, mul, to_float = ops
    tr = add(fx.fe(b2r), dzr)
    ti = add(fx.fe(b2i), dzi)
    pr = add(mul(tr, dzr), fx.neg(mul(ti, dzi)))
    pi = add(mul(tr, dzi), mul(ti, dzr))
    ndzr, ndzi = add(pr, dcr_g), add(pi, dci_g)
    zr, zi = zr1 + to_float(ndzr), zi1 + to_float(ndzi)
    return ndzr, ndzi, zr, zi, zr * zr + zi * zi, tr, ti


def _m2(ops, dzr, dzi):
    add, mul, _ = ops
    return add(mul(dzr, dzr), mul(dzi, dzi))


def _pick(mask, a, b):
    if isinstance(a, tuple):
        return tuple(_pick(mask, x, y) for x, y in zip(a, b))
    return torch.where(mask, a, b)


def _ready(dzr, dzi):
    return fx.step_ready(dzr) & fx.step_ready(dzi)


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _mirror_group(pk, P, n_steps: int, bla, xx, yy, *, iterations: int, glitch: bool,
                  seen: dict):
    """One gate group as the kernel runs it: ``perturb_cuda._bla_fe_group``
    with the closed ops wherever the kernel takes them; ``seen`` counts the
    live pixel-runs of plain steps in the closed ops, those a row or a δz
    kept in the general ops, the live pixels a skip put outside, and the
    live pixel-steps in the general ops where the closed ops would have
    given other bits (in a first sum or an output)."""
    i32 = torch.int32
    dcr, dci, dcr_g, dci_g = tpc.fe_dc(P, xx, yy)
    gain, limit_sq = P[5], P[4]
    zfr = pk[0, 0] + fx.to_float(dcr)
    zfi = pk[0, 1] + fx.to_float(dci)
    zero = torch.zeros(zfr.shape, dtype=i32)
    state = (dcr, dci, zfr, zfi, zero, zero)
    dcg_ready = _ready(dcr_g, dci_g)
    gate_closed = _ready(dcr, dci)  # phase 0's gate
    table = bla.packed
    n_levels = len(bla.offsets)

    def active(state, n):
        _, _, zfr, zfi, cnt, gl = state
        return (zfr * zfr + zfi * zfi <= limit_sq) & (cnt == n) & (gl == 0)

    def row_ok(n):  # the row the kernel stages for step n, in the domain
        return bool((fx.in_domain(fx.fe(2.0 * pk[n, 0:1]))
                     & fx.in_domain(fx.fe(2.0 * pk[n, 1:2]))).all())

    def one_step(n, state, closed):
        if n >= n_steps:
            return state
        dzr, dzi, zfr, zfi, cnt, gl = state
        live = active(state, n)
        args = (2.0 * pk[n, 0], 2.0 * pk[n, 1], pk[n, 2], pk[n, 3], dzr, dzi, dcr_g, dci_g)
        c, g = _step(CLOSED, *args), _step(GENERAL, *args)
        other = torch.zeros_like(live)
        for a, b in zip((*c[0], *c[1], *c[2:5], *c[5], *c[6]),
                        (*g[0], *g[1], *g[2:5], *g[5], *g[6])):
            other |= _bits(a) != _bits(b)
        seen["differs"] += int((live & ~closed & other).sum())
        ndzr, ndzi, nzfr, nzfi, d = _pick(closed, c[:5], g[:5])
        esc_now = d > limit_sq
        gl_now = live & ~esc_now & (d < pk[n, 4]) if glitch else torch.zeros_like(live)
        dzr = _pick(live, ndzr, dzr)
        dzi = _pick(live, ndzi, dzi)
        zfr = torch.where(live, nzfr, zfr)
        zfi = torch.where(live, nzfi, zfi)
        cnt = cnt + (live & ~esc_now & ~gl_now).to(i32)
        return dzr, dzi, zfr, zfi, cnt, gl | gl_now.to(i32)

    def try_skip(state, n, gate_closed):
        dzr, dzi, zfr, zfi, cnt, gl = state
        live = active(state, n) & (n < n_steps)
        m2 = _pick(gate_closed, _m2(CLOSED, dzr, dzi), _m2(GENERAL, dzr, dzi))
        has = live & (m2[0] > 0.0)
        maxe = torch.where(has, m2[1], E_ZERO).max()
        maxm = torch.where(has & (m2[1] == maxe), m2[0], 0.0).max()
        maxe, maxm = int(maxe), float(maxm)
        row = None
        for lev in range(n_levels - 1, -1, -1):
            step = 1 << (lev + tpc.BLA_MIN_LEVEL)
            r = table[min(bla.offsets[lev] + (n >> (lev + tpc.BLA_MIN_LEVEL)),
                          table.shape[0] - 1)]
            r2m, r2e = float(r[6]), int(r[7])
            if n & (step - 1) == 0 and n + step <= n_steps and r2m > 0.0 \
                    and (maxe < r2e or (maxe == r2e and maxm < r2m)):
                row = r
                break
        if row is None:
            return state, n, gate_closed
        f32 = torch.float32
        sA = (torch.tensor(float(row[0]), dtype=f32), torch.tensor(float(row[1]), dtype=f32),
              torch.tensor(int(row[2]), dtype=i32))
        sB = (torch.tensor(float(row[3]), dtype=f32), torch.tensor(float(row[4]), dtype=f32),
              torch.tensor(int(row[5]), dtype=i32))
        skr, ski = fx.cmul((sA[0], sA[2]), (sA[1], sA[2]), dzr, dzi)  # general, always
        tbr, tbi = fx.cmul((sB[0], sB[2]), (sB[1], sB[2]), dcr, dci)
        tbr = (tbr[0] * gain, torch.where(gain == 0.0, E_ZERO, tbr[1]))
        tbi = (tbi[0] * gain, torch.where(gain == 0.0, E_ZERO, tbi[1]))
        ndzr, ndzi = fx.add(skr, tbr), fx.add(ski, tbi)
        land = n + step
        dzr = _pick(live, ndzr, dzr)
        dzi = _pick(live, ndzi, dzi)
        zfr = torch.where(live, pk[land, 0] + fx.to_float(ndzr), zfr)
        zfi = torch.where(live, pk[land, 1] + fx.to_float(ndzi), zfi)
        cnt = cnt + live.to(i32) * step
        ready = _ready(dzr, dzi)
        seen["skip_out"] += int((live & ~ready).sum())
        return (dzr, dzi, zfr, zfi, cnt, gl), land, ready

    n = 0
    while n < iterations and n < n_steps and bool(active(state, n).any()):
        for _ in range(tpc.SKIP_SCANS):
            state, land, gate_closed = try_skip(state, n, gate_closed)
            if land == n:
                break
            n = land
        rows_ok = all(row_ok(n + i) for i in range(tpc.FE_BLA_CHUNK) if n + i < n_steps)
        ready = _ready(state[0], state[1])
        closed = ready & dcg_ready & rows_ok
        live = active(state, n) & (n < n_steps)
        seen["closed_runs"] += int((live & closed).sum())
        seen["row_runs"] += 0 if rows_ok else int(live.sum())
        seen["dz_runs"] += int((live & ~(ready & dcg_ready)).sum())
        for i in range(tpc.FE_BLA_CHUNK):
            state = one_step(n + i, state, closed)
        gate_closed = closed | _ready(state[0], state[1])
        n += tpc.FE_BLA_CHUNK
    _, _, zfr, zfi, cnt, gl = state
    ran_out = ((zfr * zfr + zfi * zfi <= limit_sq) & (cnt >= n_steps)
               & (n_steps < iterations))
    return zfr, zfi, cnt, gl | ran_out.to(torch.int32)


def mirror_bla_fe(pk, P, n_steps: int, bla, *, iterations: int, height: int, width: int,
                  glitch: bool, groups: int, seen: dict):
    """``perturb_bla_fe_plain``'s call with the kernel's choice of ops."""
    for k in ("closed_runs", "row_runs", "dz_runs", "skip_out", "differs"):
        seen.setdefault(k, 0)
    xx, yy = tpc.grid_xy(P, groups * height, width, pk.device)
    outs = [_mirror_group(pk, P, n_steps, bla, xx[j * height:(j + 1) * height],
                          yy[j * height:(j + 1) * height], iterations=iterations,
                          glitch=glitch, seen=seen)
            for j in range(groups)]
    return tuple(torch.cat(parts, 0) for parts in zip(*outs))


CASES = {"interior strip": (STRIP, None), "edge": (EDGE, None),
         "subnormal rows": (STRIP, "rows"), "skip leaves the domain": (STRIP, "skip")}


@pytest.mark.parametrize("glitch", [True, False])
@pytest.mark.parametrize("case", list(CASES))
def test_mirror_equals_plain(case, glitch):
    """The kernel's choices of closed and general ops give the plain
    version's bits over both gate groups of the strip (the second padded),
    and the closed ops ran; at the seeded crossing cases the loop left the
    domain, and there the closed ops would have given other bits."""
    sc, kind = CASES[case]
    st = tpt.perturb_setup(interop.scene(sc), "cpu")
    assert st.extreme and st.bla is not None
    pk, bla = tpt._packed_tensor(st.orbit, "cpu"), st.bla
    if kind is not None:
        pk, bla = bla_crossing_inputs(pk, bla, st.n_steps, kind)
    kw = dict(iterations=sc.iterations, height=tpt.PERT_BAND_ROWS, width=st.width,
              glitch=glitch, groups=2)
    want = [a.numpy() for a in tpc.perturb_bla_fe_plain(pk, st.P, st.n_steps, bla, **kw)]
    seen = {}
    got = [a.numpy() for a in mirror_bla_fe(pk, st.P, st.n_steps, bla, seen=seen, **kw)]
    _assert_bits_equal(got, want)
    assert seen["closed_runs"] > 0
    if kind is None:
        assert seen["row_runs"] == seen["skip_out"] == seen["differs"] == 0
        return
    assert seen["row_runs" if kind == "rows" else "skip_out"] > 0
    assert seen["dz_runs"] > 0 or kind == "rows"
    assert seen["differs"] > 0


E_MAX = fx.E_DOMAIN


def _definition(m, e):
    """The closed domain as defined: (±0, E_ZERO), or |m| in [0.5, 1) with
    |e| <= 2^29; and ready for closed steps: also e >= -2^23 unless zero."""
    m64, e64 = np.abs(m.astype(np.float64)), e.astype(np.int64)
    dom = np.where(m64 == 0.0, e64 == E_ZERO,
                   (m64 >= 0.5) & (m64 < 1.0) & (np.abs(e64) <= E_MAX))
    return dom, dom & ((m64 == 0.0) | (e64 >= -fx.E_READY))


def _predicate_inputs(seed=7, n=100_000):
    rng = np.random.default_rng(seed)
    m = (rng.uniform(0.25, 1.25, n) * rng.choice([-1.0, 1.0], n)).astype(np.float32)
    e = rng.integers(-(1 << 30), 1 << 30, n).astype(np.int64)
    near = rng.random(n) < 0.5
    e[near] = rng.integers(-600, 600, int(near.sum()))
    e = e.astype(np.int32)
    zero = rng.random(n) < 0.05
    m[zero] = 0.0
    e[zero & (rng.random(n) < 0.5)] = E_ZERO
    edges = [(0.0, E_ZERO), (-0.0, E_ZERO), (0.0, 0), (-0.0, 5), (0.0, -E_MAX),
             (1e-40, 0), (-1e-40, E_ZERO), (1.1754942e-38, 3), (0.5, 0), (-0.5, 3),
             (0.99999994, 0), (-0.99999994, -7), (1.0, 0), (0.49999997, 0),
             (0.75, E_MAX), (0.75, E_MAX + 1), (-0.75, -E_MAX), (0.75, -E_MAX - 1),
             (0.75, -fx.E_READY), (0.75, -fx.E_READY - 1), (np.inf, 0), (np.nan, 0),
             (0.75, E_ZERO), (0.75, 2 ** 31 - 1)]
    m = np.concatenate([m, np.array([x for x, _ in edges], np.float32)])
    e = np.concatenate([e, np.array([y for _, y in edges], np.int32)])
    return m, e


def test_domain_predicates_equal_the_definition():
    """``in_domain`` and ``step_ready`` (the kernel's ``fe_in_domain`` and
    ``fe_step_ready``, expression for expression) on seeded values and the
    edges: ±0 with E_ZERO and with other exponents, subnormal mantissas,
    |m| = 0.5 and the largest m below 1, |e| = 2^29 and 2^29 + 1, e = −2^23
    and one below, inf and NaN."""
    m, e = _predicate_inputs()
    dom, ready = _definition(m, e)
    a = (torch.from_numpy(m), torch.from_numpy(e))
    np.testing.assert_array_equal(fx.in_domain(a).numpy(), dom)
    np.testing.assert_array_equal(fx.step_ready(a).numpy(), ready)
    assert dom.any() and (~dom).any() and (dom & ~ready).any()
    assert list(dom[-24:]) == [True, True, False, False, False, False, False, False, True,
                               True, True, True, False, False, True, False, True, False,
                               True, True, False, False, False, False]


def test_julia_gain_folds_dc_into_the_domain():
    """Julia's gain 0 folds δc_g to (0·m, E_ZERO): in the domain and ready
    for the closed steps wherever δc's mantissa is finite (a ±0), which the
    kernel tests per pixel rather than assumes; 0·inf (NaN) would be out."""
    st = tpt.perturb_setup(interop.scene(STRIP), "cpu")
    P = st.P.clone()
    P[5] = 0.0
    xx, yy = tpc.grid_xy(P, STRIP.height, STRIP.width, "cpu")
    dcr, dci, dcr_g, dci_g = tpc.fe_dc(P, xx, yy)
    assert (dcr_g[1] == E_ZERO).all() and (dci_g[1] == E_ZERO).all()
    assert (dcr_g[0] == 0.0).all() and fx.step_ready(dcr).all()
    assert bool(_ready(dcr_g, dci_g).all())
    nan = (torch.tensor([float("inf")]) * 0.0, torch.tensor([E_ZERO], dtype=torch.int32))
    assert not bool(fx.in_domain(nan).any())


H100_SMS = 132


@pytest.mark.parametrize("occupancy", [2, 3])
def test_form_choice(occupancy):
    """``bla_fe_form`` is a pure function of the call's shape and the
    register form's resident blocks: bla1e40's two padded gate groups of
    256 x 512 go to the register form on an H100 (132 SMs) at two or three
    blocks an SM, a 3000x3000 view's twelve groups of 256 x 3000 to the
    streaming form; one block more than fits tips a call over."""
    threads, k = 256, 4
    resident = occupancy * H100_SMS
    assert tpc.bla_fe_form(2, 256, 512, resident, threads, k) == "registers"
    assert tpc.bla_fe_form(12, 256, 3000, resident, threads, k) == "streaming"
    fits = resident * threads * k  # pixels of one group that just fit
    assert tpc.bla_fe_form(1, 1, fits, resident, threads, k) == "registers"
    assert tpc.bla_fe_form(1, 1, fits + 1, resident, threads, k) == "streaming"
    assert tpc.bla_fe_form(resident, 1, threads * k, resident, threads, k) == "registers"
    assert tpc.bla_fe_form(resident + 1, 1, 1, resident, threads, k) == "streaming"
