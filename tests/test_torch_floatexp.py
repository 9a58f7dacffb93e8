"""The port's floatexp arithmetic, the fe parameter block, kernel D's plain
versions and the extended-exponent BLA table against the JAX package.

The fe ops, ``_pert_params_fe`` and ``build_table_fe`` are bit-equal.  The
JAX package's ``jnp.ldexp`` runs flush-to-zero on XLA:CPU, and the port's
ldexp writes that flush out; IEEE ldexp (numpy, torch, CUDA's ``ldexpf``)
keeps subnormals and differs on 11,352 of the 200,000 seeded (m, e) below.

Kernel D's plain version is compared with ``perturb_pallas_fe(interpret=
True, chunk=4)`` and with the XLA twin, jitted and under
``jax.disable_jit()``.  XLA:CPU contracts a*b + c inside jit, and the port
never fuses; at the 1e44× needle every count is low and well-conditioned,
and the jitted twin equals the port on every pixel as well (measured 0
differences in zr, zi, cnt and gl), so the tolerance is 0 throughout.

One difference inside the JAX package stays visible: at a reference that
escapes, the Pallas kernel (and with it kernel D) poisons a pixel's |z|²
whenever it falls below τ²|Z_{n+1}|², even on the escaping step, while the
twin only flags pixels that did not escape.  Both count the pixel alike;
only its flag differs (42 of 384 pixels of the bad-reference frame below,
all escaping on the reference's last step).  The port follows the kernel.
"""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fractal_tpu.config import Scene
from fractal_tpu.ops import bla as jbla
from fractal_tpu.ops import floatexp as jfx
from fractal_tpu.ops import perturb as jpt
from fractal_tpu_torch import interop
from fractal_tpu_torch.ops import bla as tbla
from fractal_tpu_torch.ops import floatexp as tfx
from fractal_tpu_torch.ops import perturb as tpt
from fractal_tpu_torch.ops import perturb_cuda as tpc
from tests.test_bla import MINIBROT_1E40_X, MINIBROT_1E40_Y

NEEDLE_X = "-1.999999999999999999999999999999999999999999991"
# tests/test_perturb.py:1291-1313: the 1e44× needle
NEEDLE = Scene(width=32, height=24, iterations=300, pos_str=(NEEDLE_X, "0.0"),
               scale=(1e44, 1e44))


@pytest.fixture(autouse=True)
def _fresh_caches():
    for mod in (jpt, tpt):
        for name, val in vars(mod).items():
            if name.endswith("_CACHE") and isinstance(val, dict):
                val.clear()
    yield


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_bits_equal(got, want, names=("zr", "zi", "cnt", "gl")):
    for name, g, w in zip(names, got, want):
        np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=name)


def _fe_inputs(n=200_000, seed=0):
    rng = np.random.default_rng(seed)
    m = (rng.uniform(0.5, 1.0, n) * rng.choice([-1.0, 1.0], n)).astype(np.float32)
    e = rng.integers(-210, 210, n).astype(np.int32)
    m[:5] = [0.0, -0.0, np.inf, -np.inf, np.nan]
    return m, e


def test_to_float_flushes_like_the_reference():
    """to_float bit-equal to the JAX package's, eager and jitted, on seeded
    (m, e) with e clipped to ±200; IEEE ldexp keeps the subnormals the
    reference flushes (the 11,352 of ROADMAP "Faults")."""
    m, e = _fe_inputs()
    got = tfx.to_float((torch.from_numpy(m), torch.from_numpy(e))).numpy()
    for f in (jfx.to_float, jax.jit(jfx.to_float)):
        np.testing.assert_array_equal(_bits(got), _bits(f((jnp.asarray(m), jnp.asarray(e)))))
    with np.errstate(over="ignore"):
        ieee = np.ldexp(m, np.clip(e, -200, 200))
    assert int((_bits(ieee) != _bits(got)).sum()) == 11_352
    tiny = np.abs(np.ldexp(m.astype(np.float64), np.clip(e, -200, 200))) < 2.0 ** -126
    assert np.all(got[tiny] == 0.0)
    assert np.all(np.signbit(got[tiny]) == np.signbit(m[tiny]))


@pytest.mark.parametrize("jitted", [False, True], ids=["eager", "jit"])
def test_fe_ops_bit_equal(jitted):
    """fe, mul, add, neg and cmul on seeded floats spanning 2^±115 (zeros
    and infinities included) equal the JAX package's bit for bit."""
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(50_000) * np.exp(rng.uniform(-80, 80, 50_000))).astype(np.float32)
    x[:4] = [0.0, -0.0, np.inf, -np.inf]
    y = np.roll(x, 7)
    wrap = jax.jit if jitted else (lambda f: f)
    jx, jy = wrap(jfx.fe)(jnp.asarray(x)), wrap(jfx.fe)(jnp.asarray(y))
    tx, ty = tfx.fe(torch.from_numpy(x)), tfx.fe(torch.from_numpy(y))
    _assert_bits_equal([t.numpy() for t in tx], jx, ("m", "e"))
    for name in ("mul", "add"):
        want = wrap(getattr(jfx, name))(jx, jy)
        got = getattr(tfx, name)(tx, ty)
        _assert_bits_equal([t.numpy() for t in got], want, (name + " m", name + " e"))
    want = wrap(jfx.cmul)(jx, jy, jy, jx)
    got = tfx.cmul(tx, ty, ty, tx)
    for w, g in zip(want, got):
        _assert_bits_equal([t.numpy() for t in g], w, ("cmul m", "cmul e"))
    _assert_bits_equal([t.numpy() for t in tfx.neg(tx)], jfx.neg(jx), ("neg m", "neg e"))
    # the flush inside add: a live operand against a 130-bit-smaller one
    a = (torch.tensor([0.5, -0.75]), torch.tensor([0, 3], dtype=torch.int32))
    b = (torch.tensor([0.5, 0.5]), torch.tensor([-130, -127], dtype=torch.int32))
    ja = tuple(jnp.asarray(t.numpy()) for t in a)
    jb = tuple(jnp.asarray(t.numpy()) for t in b)
    _assert_bits_equal([t.numpy() for t in tfx.add(a, b)], wrap(jfx.add)(ja, jb))


@pytest.mark.parametrize("fr", [Fraction(3, 7), Fraction(-1, 2), Fraction(1),
                                Fraction(1, 10 ** 400), Fraction(-(10 ** 350), 3),
                                Fraction(0)])
def test_frexp_fraction_matches(fr):
    assert tpt._frexp_fraction(fr) == jpt._frexp_fraction(fr)


@pytest.mark.parametrize("kw", [
    dict(pos_str=(NEEDLE_X, "0.0"), scale=(1e44, 1e44)),
    dict(pos_str=("-2.0", "0.0"), scale=(1e100, 1e100), supersample=2),
    dict(algo="julia", julia_set=(-0.8, 0.156), pos=(0.3, -0.2), scale=(1e35, 3e35)),
], ids=["needle1e44", "ss2_1e100", "julia1e35"])
def test_pert_params_fe_bit_equal(kw):
    sc = Scene(width=32, height=24, iterations=300, **kw)
    assert jpt._is_extreme(sc) and tpt._is_extreme(interop.scene(sc))
    w, h = sc.width * sc.supersample, sc.height * sc.supersample
    for ref in ((w // 2, h // 2), (0, 3), (7.25, 11.5)):
        want = np.asarray(jpt._pert_params_fe(sc, ref, w, h))
        got = tpt._pert_params_fe(interop.scene(sc), ref, w, h)
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
        assert torch.equal(interop.params16(want).view(torch.int32), got.view(torch.int32))


def _needle_inputs(ref=None):
    sc = NEEDLE
    w, h = sc.width, sc.height
    if ref is None:
        ref, orbit = jpt.resolve_reference(sc, w, h)
    else:
        orbit = jpt.reference_orbit(sc, ref, w, h)
    P = jpt._pert_params_fe(sc, ref, w, h)
    planes = jpt.orbit_planes(orbit)
    return orbit, P, planes, (interop.orbit_table(planes), interop.glitch_column(planes),
                              interop.params16(P))


@pytest.mark.parametrize("glitch", [True, False], ids=["glitch", "full"])
def test_kernel_d_plain_matches_interpreted_kernel(glitch):
    """Kernel D's grid form against the interpreted Pallas kernel at the
    1e44× needle, bit for bit; with glitch, the jitted twin too."""
    sc = NEEDLE
    w, h = sc.width, sc.height
    orbit, P, planes, (table, gtol, tP) = _needle_inputs()
    assert tuple(orbit.ref_px) == (w // 2, h // 2) and orbit.n_steps == 300
    want = [np.asarray(a) for a in jpt.perturb_pallas_fe(
        planes, P, jnp.int32(orbit.n_steps), iterations=sc.iterations, height=h, width=w,
        julia=False, glitch=glitch, interpret=True, chunk=4)]
    got = [a.numpy() for a in tpc.perturb_fe_full(
        table, gtol, tP, orbit.n_steps, iterations=sc.iterations, height=h, width=w,
        glitch=glitch)]
    _assert_bits_equal(got, want)
    assert len(np.unique(want[2])) > 5  # the view has structure
    if glitch:
        assert 0 < int(want[3].sum()) < w * h
        twin = jpt.perturb_whole_jnp(jnp.asarray(orbit.packed), P, jnp.int32(orbit.n_steps),
                                     iterations=sc.iterations, height=h, width=w,
                                     chunk=jpt.PERT_CHUNK_CPU, extreme=True)
        _assert_bits_equal(got, twin)


def test_kernel_d_julia_matches_twin():
    """The julia form (δc folded into δz₀ only: the gain-0 δc is a true
    zero, exponent ``E_ZERO``) at c = −2, whose Julia set is the real
    segment [−2, 2], at 1e35×: bit-equal to the jitted twin."""
    sc = Scene(algo="julia", width=24, height=16, iterations=300, julia_set=(-2.0, 0.0),
               pos_str=("0.5", "0"), scale=(1e35, 1e35))
    w, h = sc.width, sc.height
    ref, orbit = jpt.resolve_reference(sc, w, h)
    P = jpt._pert_params_fe(sc, ref, w, h)
    assert float(P[5]) == 0.0 and orbit.n_steps == sc.iterations
    want = jpt.perturb_whole_jnp(jnp.asarray(orbit.packed), P, jnp.int32(orbit.n_steps),
                                 iterations=sc.iterations, height=h, width=w,
                                 chunk=jpt.PERT_CHUNK_CPU, extreme=True)
    planes = jpt.orbit_planes(orbit)
    got = [a.numpy() for a in tpc.perturb_fe_full(
        interop.orbit_table(planes), interop.glitch_column(planes), interop.params16(P),
        orbit.n_steps, iterations=sc.iterations, height=h, width=w, algo="julia")]
    _assert_bits_equal(got, want)
    assert len(np.unique(got[2])) > 5 and int(got[3].sum()) > 0


def _escaped_on_last_step(zr, zi, cnt, n_steps, limit):
    return (cnt == n_steps - 1) & (zr.astype(np.float64) ** 2 + zi.astype(np.float64) ** 2
                                   > float(limit) ** 2)


def test_kernel_d_bad_reference_against_kernel_and_unjitted_twin():
    """A reference that escapes at step 79 (pixel (0, 0)): most pixels
    outlive it and flag.  Bit-equal to the interpreted kernel; against the
    twin run unjitted (no contraction anywhere), zr, zi and cnt are
    bit-equal and the flags differ only on pixels that escaped on the
    reference's last step (module docstring)."""
    sc = NEEDLE
    w, h = sc.width, sc.height
    orbit, P, planes, (table, gtol, tP) = _needle_inputs(ref=(0, 0))
    assert orbit.n_steps == 79
    kern = [np.asarray(a) for a in jpt.perturb_pallas_fe(
        planes, P, jnp.int32(orbit.n_steps), iterations=sc.iterations, height=h, width=w,
        julia=False, glitch=True, interpret=True, chunk=4)]
    got = [a.numpy() for a in tpc.perturb_fe_full(
        table, gtol, tP, orbit.n_steps, iterations=sc.iterations, height=h, width=w)]
    _assert_bits_equal(got, kern)
    with jax.disable_jit():
        twin = [np.asarray(a) for a in jpt.perturb_whole_jnp(
            jnp.asarray(orbit.packed), P, jnp.int32(orbit.n_steps), iterations=sc.iterations,
            height=h, width=w, chunk=jpt.PERT_CHUNK_CPU, extreme=True)]
    _assert_bits_equal(got[:3], twin[:3])
    differ = got[3] != twin[3]
    assert int(differ.sum()) > 0
    assert np.all((got[3] == 1) & (twin[3] == 0) | ~differ)
    last = _escaped_on_last_step(got[0], got[1], got[2], orbit.n_steps, sc.limit)
    assert np.all(last[differ])
    np.testing.assert_array_equal(got[3][~last], twin[3][~last])
    assert int(got[3].sum()) > w * h // 2


def test_kernel_d_points_form_matches_twin_and_grid():
    """Kernel D's points form over the flagged list of the bad-reference
    frame, against the medoid secondary orbit: equal to the JAX package's
    points twin (``_pert_fallback_1d_jit(extreme=True)``, what its multiref
    rounds run) but for the last-step flags, and bit-equal to the grid
    form at the same pixels."""
    sc = NEEDLE
    w, h = sc.width, sc.height
    _, _, _, (table0, gtol0, P0) = _needle_inputs(ref=(0, 0))
    gl = tpc.perturb_fe_full(table0, gtol0, P0, 79, iterations=sc.iterations, height=h,
                             width=w)[3].numpy()
    idx = np.flatnonzero(gl)
    xs, ys = (idx % w).astype(np.float32), (idx // w).astype(np.float32)
    mi = int(np.argmin((xs - xs.mean()) ** 2 + (ys - ys.mean()) ** 2))
    ref = (int(xs[mi]), int(ys[mi]))
    orbit, P, planes, (table, gtol, tP) = _needle_inputs(ref=ref)
    k = 1 << max(7, (idx.size - 1).bit_length())  # the reference's padded list
    xs_p = np.full(k, float(w), np.float32)
    ys_p = np.full(k, float(h), np.float32)
    xs_p[: idx.size], ys_p[: idx.size] = xs, ys
    want = [np.asarray(a).ravel()[: idx.size] for a in jpt._pert_fallback_1d_jit(
        jnp.asarray(orbit.packed), P, jnp.int32(orbit.n_steps), jnp.asarray(xs_p),
        jnp.asarray(ys_p), iterations=sc.iterations, k=k, extreme=True)]
    got = [a.numpy() for a in tpc.perturb_fe_points(
        table, gtol, tP, orbit.n_steps, torch.from_numpy(xs), torch.from_numpy(ys),
        iterations=sc.iterations)]
    assert (got[3] == 0).sum() > 10  # the secondary resolves pixels
    _assert_bits_equal(got[:3], want[:3])
    last = _escaped_on_last_step(got[0], got[1], got[2], orbit.n_steps, sc.limit)
    np.testing.assert_array_equal(got[3][~last], want[3][~last])
    grid = tpc.perturb_fe_full(table, gtol, tP, orbit.n_steps, iterations=sc.iterations,
                               height=h, width=w)
    _assert_bits_equal(got, [g.numpy().reshape(-1)[idx] for g in grid])


def test_kernel_d_rejects_other_rules_and_devices():
    table = torch.zeros((8, 2))
    P = torch.zeros(16)
    for algo, power in (("burningship", 2), ("multibrot", 3), ("julia", 3)):
        with pytest.raises(ValueError, match="quadratic"):
            tpc.perturb_fe_full(table, None, P, 4, iterations=4, height=2, width=2,
                                algo=algo, power=power, glitch=False)
    meta = torch.empty((8, 2), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tpc.perturb_fe_full(meta, torch.empty(8, device="meta"),
                            torch.empty(16, device="meta"), 4, iterations=4,
                            height=2, width=2)


def _orbit_f64(c, n):
    z = np.zeros((n + 1, 2))
    v = 0j
    for i in range(n + 1):
        z[i] = v.real, v.imag
        v = v * v + c
    return z


@pytest.mark.parametrize("case", ["needle", "synthetic", "tiny_dc", "short"])
def test_build_table_fe_bit_equal(case):
    """The extended-exponent table, bit for bit, on the 1e44× needle's orbit
    (no valid merge), a contracting synthetic orbit, a subnormal dc_max
    and a budget past the orbit's end; carried through interop unchanged."""
    if case == "needle":
        orbit = jpt.resolve_reference(NEEDLE, NEEDLE.width, NEEDLE.height)[1]
        args = (orbit.packed[:, :2], orbit.n_steps, 300, 4e-44)
    else:
        z = _orbit_f64(complex(-0.158, 1.033), 600).astype(np.float32)
        args = {"synthetic": (z, 600, 600, 1e-40), "tiny_dc": (z, 600, 600, 1e-310),
                "short": (z, 200, 512, 1e-35)}[case]
    for min_level in (2, jpt.BLA_MIN_LEVEL):
        want = jbla.build_table_fe(*args, min_level=min_level)
        got = tbla.build_table_fe(*args, min_level=min_level)
        np.testing.assert_array_equal(_bits(got.packed), _bits(want.packed))
        assert got.offsets == want.offsets and got.levels == want.levels
        carried = interop.bla_table(want)
        np.testing.assert_array_equal(_bits(carried.packed), _bits(got.packed))
        assert carried.offsets == got.offsets and carried.levels == got.levels
    if case == "synthetic":
        assert (got.packed[:, 6] > 0).any()  # merges of 64 steps and more stay valid


# --- the extended-exponent BLA route ------------------------------------------


def _minibrot(**kw):
    return Scene(**{**dict(width=48, height=32, iterations=512,
                           pos_str=(MINIBROT_1E40_X, MINIBROT_1E40_Y), scale=(1e40, 1e40),
                           inside=False), **kw})


@pytest.mark.parametrize("view", ["needle", "minibrot"])
def test_fe_bla_gate_agrees(view):
    """tests/test_bla.py:136-186: the needle's orbit expands and no merge
    survives (the route stays off); the minibrot's contracts and deep
    levels stay valid (the route runs)."""
    sc = (Scene(width=24, height=16, iterations=300, pos_str=(NEEDLE_X, "0.0"),
                scale=(1e44, 1e44)) if view == "needle" else _minibrot())
    ts = interop.scene(sc)
    w, h = sc.width, sc.height
    ref, orbit = jpt.resolve_reference(sc, w, h)
    tref, torbit = tpt.resolve_reference(ts, w, h, "cpu")
    assert tref == ref and torbit.n_steps == orbit.n_steps
    useful = tpt._fe_bla_useful(ts, torbit, tref, w, h)
    assert useful == jpt._fe_bla_useful(sc, orbit, ref, w, h) == (view == "minibrot")
    want = jpt._bla_for(sc, orbit, ref, w, h, fe=True)
    got = tpt._bla_for(ts, torbit, tref, w, h, fe=True)
    np.testing.assert_array_equal(_bits(got.packed), _bits(want.packed))
    assert got.offsets == want.offsets
    st = tpt.perturb_setup(ts, "cpu")
    assert st.extreme and (st.bla is not None) == useful


def test_bla_route_matches_twin_and_plain_loop_at_the_minibrot():
    """The fe BLA route against the JAX package's BLA twin (jitted), bit for
    bit; its counts and flags equal the plain fe loop's, and its z values
    differ from the loop's on every pixel, so the skips ran."""
    sc = _minibrot()
    w, h = sc.width, sc.height
    ref, orbit = jpt.resolve_reference(sc, w, h)
    P = jpt._pert_params_fe(sc, ref, w, h)
    bla_packed, bla_offsets = jpt._bla_dev_for(sc, orbit, ref, w, h, fe=True)
    want = jpt.perturb_whole_jnp(jnp.asarray(orbit.packed), P, jnp.int32(orbit.n_steps),
                                 iterations=sc.iterations, height=h, width=w,
                                 chunk=jpt.PERT_CHUNK_CPU, extreme=True,
                                 bla_packed=bla_packed, bla_offsets=bla_offsets)
    ts = interop.scene(sc)
    st = tpt.perturb_setup(ts, "cpu")
    got = [a.numpy() for a in tpt._render_bla(ts, st, tpt.KERNELS, glitch=True)]
    _assert_bits_equal(got, want)
    plain = [a.numpy() for a in tpc.perturb_fe_full(st.table, st.gtol, st.P, st.n_steps,
                                                    iterations=sc.iterations, height=h,
                                                    width=w)]
    np.testing.assert_array_equal(got[2], plain[2])
    np.testing.assert_array_equal(got[3], plain[3])
    assert np.all(_bits(got[0]) != _bits(plain[0]))


def test_bla_route_bookkeeping_behind_a_bad_reference():
    """The route's count, escape and glitch bookkeeping where pixels escape,
    glitch and outlive the orbit: the 1e44× needle against the corner
    reference (0, 0), whose table has no valid merge, so every step is a
    plain one; bit-equal to the JAX BLA twin given the same table."""
    sc = Scene(width=24, height=16, iterations=300, pos_str=(NEEDLE_X, "0.0"),
               scale=(1e44, 1e44), inside=False)
    w, h = sc.width, sc.height
    orbit = jpt.reference_orbit(sc, (0, 0), w, h)
    P = jpt._pert_params_fe(sc, (0, 0), w, h)
    table = jpt._bla_for(sc, orbit, (0, 0), w, h, fe=True)
    want = jpt.perturb_whole_jnp(jnp.asarray(orbit.packed), P, jnp.int32(orbit.n_steps),
                                 iterations=sc.iterations, height=h, width=w,
                                 chunk=jpt.PERT_CHUNK_CPU, extreme=True,
                                 bla_packed=jnp.asarray(table.packed),
                                 bla_offsets=table.offsets)
    pk = torch.from_numpy(np.ascontiguousarray(orbit.packed[:, :5]))
    got = [a.numpy() for a in tpc.perturb_bla_fe_plain(
        pk, interop.params16(P), orbit.n_steps, interop.bla_table(table),
        iterations=sc.iterations, height=h, width=w, glitch=True)]
    _assert_bits_equal(got, want)
    assert int(got[3].sum()) > w * h // 2 and len(np.unique(got[2])) >= 3
