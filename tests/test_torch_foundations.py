"""The port's foundations against the JAX package, input for input.

Scene and its defaults, the exact viewport constants, the double-single
ops, coloring and the downsample must equal ``fractal_tpu``'s on the same
(seeded) inputs.  Where they cannot be bit-equal, each test states the
measured difference and its cause:

* XLA:CPU contracts a*b + c into one FMA inside a jitted program (measured:
  23,448 of 100,000 f32 triples differ from separately rounded a*b + c,
  ``--xla_cpu_enable_fast_math=false`` or not); torch never fuses.  The JAX
  dd ops run eagerly on numpy arrays execute in numpy, unfused, so that is
  the bit-equal comparison, and the jitted one carries a tolerance.
* ``jax.lax.fma`` does not exist in the installed JAX, so the JAX
  package's ``dd._fma`` takes its Dekker fallback ``(p + c) + e``, which
  rounds twice.  The port's ``_fma`` is the single-rounded FMA (emulated in
  f64; the kernels call ``__fmaf_rn``), so ``mul_f``'s lo word differs.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fractal_tpu import config as jcfg
from fractal_tpu.ops import coloring as jcol
from fractal_tpu.ops import dd as jdd
from fractal_tpu.ops import escape_pallas as jep
from fractal_tpu.ops import perturb as jpt
from fractal_tpu_torch import config as tcfg
from fractal_tpu_torch import interop
from fractal_tpu_torch.ops import coloring as tcol
from fractal_tpu_torch.ops import dd as tdd
from fractal_tpu_torch.ops import escape_cuda as tec
from fractal_tpu_torch.ops import viewport as tvp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCENES = [
    dict(),
    dict(algo="julia", width=64, height=48, julia_set=(-0.8, 0.156), scale=(0.6, 0.6)),
    dict(width=3000, height=3000, iterations=4000, pos=(-0.7436447860, 0.1318252536),
         scale=(1e6, 1e6), exposure=5.0, inside=False),
    dict(width=97, height=31, pos_str=("-0.74364388703715870475219150611477",
                                       "0.13182590420531197049016438275577"),
         scale=(3e11, 2e11), supersample=2),
]


def _bits(a):
    a = np.ascontiguousarray(np.asarray(a, np.float32))
    return a.view(np.int32)


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


@pytest.mark.parametrize("algo", jcfg.ALGOS + ("BarnsleyFern", "MANDELBROT"))
def test_scene_defaults_and_exact_pos_match(algo):
    js, ts = jcfg.scene_defaults(algo), tcfg.scene_defaults(algo)
    assert dataclasses.asdict(js) == dataclasses.asdict(ts)
    assert interop.scene(js) == ts
    for kw in SCENES:
        js2, ts2 = js.replace(**kw), ts.replace(**kw)
        assert dataclasses.asdict(js2) == dataclasses.asdict(ts2)
        assert jcfg.exact_pos(js2) == tcfg.exact_pos(ts2)
        assert js2.pixel_spacing == ts2.pixel_spacing


def test_scene_validation_and_hex_match():
    for bad in (dict(width=0), dict(iterations=-1), dict(supersample=0),
                dict(precision="f16"), dict(algo="nope"),
                dict(pos_str=("1/0", "0"))):
        with pytest.raises(ValueError):
            jcfg.Scene(**bad)
        with pytest.raises(ValueError):
            tcfg.Scene(**bad)
    for hexs in ("102030", "#ff0080", "00ff7f"):
        for compat in (True, False):
            j, t = jcfg.parse_hex_rgb(hexs, compat), tcfg.parse_hex_rgb(hexs, compat)
            assert j.as_tuple() == t.as_tuple()


@pytest.mark.parametrize("kw", SCENES, ids=["default", "julia", "headline", "deep_str_ss2"])
def test_viewport_constants_bit_equal(kw):
    js = jcfg.Scene(**kw)
    ts = interop.scene(js)
    ss = js.supersample
    w, h = js.width * ss, js.height * ss
    assert jep.viewport_affine(w, h, jcfg.exact_pos(js), js.scale) == \
        tec.viewport_affine(w, h, tcfg.exact_pos(ts), ts.scale)
    assert jpt._affine_fractions(w, h, jcfg.exact_pos(js), js.scale) == \
        tvp.affine_fractions(w, h, tcfg.exact_pos(ts), ts.scale)
    jp = np.asarray(jep.scene_params(js))
    np.testing.assert_array_equal(_bits(jp), _bits(tec.scene_params(ts, device="cpu").numpy()))
    np.testing.assert_array_equal(_bits(jp), _bits(interop.params16(jp).numpy()))
    # probe-sized blocks (choose_reference) too
    np.testing.assert_array_equal(_bits(jep.scene_params(js, 96, 96)),
                                  _bits(tec.scene_params(ts, 96, 96, "cpu").numpy()))


def _dd_inputs(n=100_000, seed=0):
    rng = np.random.default_rng(seed)
    hi = rng.uniform(-2.0, 2.0, (4, n)).astype(np.float32)
    lo = (hi * rng.uniform(-2.0 ** -25, 2.0 ** -25, (4, n))).astype(np.float32)
    return [(hi[k], lo[k]) for k in range(4)]


def test_dd_ops_bit_equal_unfused():
    """two_sum, two_prod, add, add_f, sub and quad_step: the JAX functions
    run eagerly on numpy arrays (numpy arithmetic, no XLA) equal the port."""
    zr, zi, cr, ci = _dd_inputs()
    tz = [_t(*x) for x in (zr, zi, cr, ci)]
    for jf, tf in ((jdd.two_sum, tdd.two_sum), (jdd.fast_two_sum, tdd.fast_two_sum)):
        for a, b in zip(jf(zr[0], cr[0]), tf(tz[0][0], tz[2][0])):
            np.testing.assert_array_equal(_bits(a), _bits(b.numpy()))
    for a, b in zip(jdd.two_prod(zr[0], zi[0]), tdd.two_prod(tz[0][0], tz[1][0])):
        np.testing.assert_array_equal(_bits(a), _bits(b.numpy()))
    for jf, tf in ((jdd.add, tdd.add), (jdd.sub, tdd.sub)):
        for a, b in zip(jf(zr, cr), tf(tz[0], tz[2])):
            np.testing.assert_array_equal(_bits(a), _bits(b.numpy()))
    for a, b in zip(jdd.add_f(zr, ci[0]), tdd.add_f(tz[0], tz[3][0])):
        np.testing.assert_array_equal(_bits(a), _bits(b.numpy()))
    for a, b in zip(jdd.neg(zr), tdd.neg(tz[0])):
        np.testing.assert_array_equal(_bits(a), _bits(b.numpy()))
    for cs in (1.0, -1.0):
        J = jdd.quad_step(zr, zi, cr, ci, cross_sign=cs)
        T = tdd.quad_step(*tz, cross_sign=cs)
        for a, b in zip((*J[0], *J[1]), (*T[0], *T[1])):
            np.testing.assert_array_equal(_bits(a), _bits(b.numpy()))


def test_dd_ops_against_jitted_reference():
    """Against the jitted JAX ops.  two_prod and add are bit-equal there
    too.  quad_step is not: XLA's contraction breaks the error-free
    transformations of the real part, whose double-word value then errs by
    up to 2^-23 (measured on 16.7 % of these lanes), while the port's stays
    within 2^-43 of the exact rational result; the imaginary parts agree to
    2^-42.  mul_f: the hi word is bit-equal; the lo word differs on ~9 % of
    lanes (the reference's Dekker ``_fma`` rounds twice), by ≤ 2^-46·|hi|."""
    from fractions import Fraction

    zr, zi, cr, ci = _dd_inputs(seed=1)
    tz = [_t(*x) for x in (zr, zi, cr, ci)]
    for a, b in zip(jax.jit(jdd.two_prod)(zr[0], zi[0]), tdd.two_prod(tz[0][0], tz[1][0])):
        np.testing.assert_array_equal(_bits(a), _bits(b.numpy()))
    for a, b in zip(jax.jit(jdd.add)(zr, cr), tdd.add(tz[0], tz[2])):
        np.testing.assert_array_equal(_bits(a), _bits(b.numpy()))

    J = jax.jit(jdd.quad_step)(zr, zi, cr, ci)
    T = tdd.quad_step(*tz)
    value = [np.asarray(h, np.float64) + np.asarray(l, np.float64) for h, l in J]
    port = [h.double().numpy() + l.double().numpy() for h, l in T]
    assert np.max(np.abs(value[0] - port[0])) <= 2.0 ** -22
    assert np.max(np.abs(value[1] - port[1])) <= 2.0 ** -42

    def exact(pair, i):
        return Fraction(float(pair[0][i])) + Fraction(float(pair[1][i]))

    for i in range(300):
        x, y, c = exact(zr, i), exact(zi, i), exact(cr, i)
        assert abs(float(exact(T[0], i) - (x * x - y * y + c))) <= 2.0 ** -43

    for jmul in (jdd.mul_f, jax.jit(jdd.mul_f)):
        jh, jl = jmul(zr, zi[0])
        th, tl = tdd.mul_f(tz[0], tz[1][0])
        np.testing.assert_array_equal(_bits(jh), _bits(th.numpy()))
        dl = np.abs(np.asarray(jl, np.float64) - tl.double().numpy())
        assert np.all(dl <= 2.0 ** -46 * np.abs(np.asarray(jh, np.float64)))
    # mul and sqr carry the same Dekker-vs-FMA difference in their values
    for (jh, jl), (th, tl) in ((jdd.mul(zr, cr), tdd.mul(tz[0], tz[2])),
                               (jdd.sqr(zi), tdd.sqr(tz[1]))):
        jv = np.asarray(jh, np.float64) + np.asarray(jl, np.float64)
        tv = th.double().numpy() + tl.double().numpy()
        assert np.all(np.abs(jv - tv) <= 2.0 ** -45 * np.abs(jv))


def test_fma_emulation_is_single_rounded():
    """The port's _fma equals a correctly rounded fma in two_prod's use
    (c = −fl(a·b)), checked against exact rationals on seeded inputs."""
    from fractions import Fraction

    rng = np.random.default_rng(3)
    a = rng.uniform(-2, 2, 2000).astype(np.float32)
    b = rng.uniform(-2, 2, 2000).astype(np.float32)
    p, e = tdd.two_prod(*_t(a, b))
    for ai, bi, pi, ei in zip(a[:200], b[:200], p.numpy()[:200], e.numpy()[:200]):
        assert Fraction(float(ai)) * Fraction(float(bi)) == \
            Fraction(float(pi)) + Fraction(float(ei))


def _color_inputs(n=50_000, seed=7):
    rng = np.random.default_rng(seed)
    dist = np.concatenate([rng.uniform(0, 4, n // 2),
                           np.exp(rng.uniform(0, 22, n // 2))]).astype(np.float32)
    dist[:7] = [0.0, 2.0, np.nextafter(np.float32(2), np.float32(3)), np.inf,
                np.nan, 1e-30, 4.3e9]
    cnt = rng.integers(0, 500, n).astype(np.int32)
    return dist, cnt


#: How far the two float images may differ: 8× the largest difference
#: measured on these inputs (3.05e-5 absolute below 256, 6.6e-7 relative).
COLOR_FLOAT_TOL = 2.0 ** -12


def _u8_against_float_image(got, want, got_f, want_f):
    """u8 equal wherever the two float images agree, or lie further than
    ``COLOR_FLOAT_TOL`` from an integer (the cast truncates); within 1 at
    the elements where they differ that close to an integer.  Returns the
    count of those elements."""
    np.testing.assert_array_equal(np.isfinite(got_f), np.isfinite(want_f))
    fin = np.isfinite(want_f)
    w64, g64 = want_f[fin].astype(np.float64), got_f[fin].astype(np.float64)
    assert np.all(np.abs(g64 - w64) <= COLOR_FLOAT_TOL * np.maximum(1.0, np.abs(w64)))
    near = np.zeros(want_f.shape, bool)
    near[fin] = (g64 != w64) & (np.abs(w64 - np.round(w64)) <= COLOR_FLOAT_TOL)
    np.testing.assert_array_equal(got[~near], want[~near])
    assert np.all(np.abs(got[near].astype(int) - want[near].astype(int)) <= 1)
    return int(near.sum())


@pytest.mark.parametrize("smooth,inside", [(True, True), (True, False),
                                           (False, True), (False, False)])
def test_coloring_u8_equal(smooth, inside):
    """Equal u8 from seeded (dist, cnt), in the dist form and the (zr, zi)
    form.  Without smoothing the float images are bit-equal.  With it, the
    log2 of XLA:CPU and of torch differ by a few ulp on a third of the
    inputs (measured 32,557 of 100,000), which moves the float image by at
    most 3.05e-5; on 50 (inside) and 43 (outside) of these 150,000 elements
    the image lies within 2^-12 of an integer, where the u8 cast can fall
    either way (one such element fell by 1 on another x86 host, whose libm
    and vector units round log2 differently).  Those elements are allowed
    ±1 and counted; every other element is equal."""
    dist, cnt = _color_inputs()
    kw = dict(iterations=500, stable_limit=2.0, exposure=5.0,
              primary_color=(40, 255, 40), secondary_color=(240, 0, 170),
              inside=inside, smooth=smooth)
    zr = np.sqrt(np.where(np.isfinite(dist), dist, 0.0)).astype(np.float32)
    zi = np.zeros_like(zr)
    for d in (dist, zr * zr + zi * zi):  # the dist form, then the (zr, zi) form
        want_f = np.asarray(jcol.color_escape_result_dist(
            jnp.asarray(d), jnp.asarray(cnt), as_float=True, **kw))
        got_f = tcol.color_escape_result_dist(*_t(d, cnt), as_float=True, **kw).numpy()
        if d is dist:
            want = np.asarray(jcol.color_escape_result_dist(jnp.asarray(dist),
                                                            jnp.asarray(cnt), **kw))
            got = tcol.color_escape_result_dist(*_t(dist, cnt), **kw).numpy()
        else:
            want = np.asarray(jcol.color_escape_result(jnp.asarray(zr), jnp.asarray(zi),
                                                       jnp.asarray(cnt), **kw))
            got = tcol.color_escape_result(*_t(zr, zi, cnt), **kw).numpy()
        near = _u8_against_float_image(got, want, got_f, want_f)
        assert near <= (64 if smooth else 0)


@pytest.mark.parametrize("factor", [1, 2, 4])
def test_downsample_box_equal(factor):
    rng = np.random.default_rng(factor)
    img = rng.uniform(-10, 300, (32, 48, 3)).astype(np.float32)
    img[0, 0, 0] = np.nan
    want = np.asarray(jcol.downsample_box(jnp.asarray(img), factor))
    got = tcol.downsample_box(torch.from_numpy(img), factor).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tcol.rust_u8_cast(torch.from_numpy(img)).numpy(),
                                  np.asarray(jcol.rust_u8_cast(jnp.asarray(img))))


def test_f64_route_matches_scalar_oracle():
    """The port's CPU f64 route equals the pure-Python scalar oracle
    (tests/reference_impl.py, the reference's per-pixel math) pixel for
    pixel, with the same ±1 u8 allowance for libm log2 ulps as
    tests/test_coloring.py."""
    from fractal_tpu_torch import render
    from tests import reference_impl as ref

    for kw in (dict(width=31, height=17, pos=(-0.6, 0.0), iterations=120, exposure=5.0),
               dict(algo="julia", width=24, height=16, julia_set=(-0.8, 0.156),
                    iterations=80, exposure=30.0, scale=(0.6, 0.6))):
        sc = tcfg.scene_defaults(kw.get("algo", "mandelbrot")).replace(
            precision="f64", **kw)
        got = render(sc, "cpu").astype(int)
        want = ref.render_scalar(sc).astype(int)
        assert np.abs(got - want).max() <= 1
        assert np.mean(got != want) < 0.01


def test_port_never_imports_jax():
    code = textwrap.dedent("""
        import sys
        import fractal_tpu_torch
        from fractal_tpu_torch import Scene, render_u8
        from fractal_tpu_torch import cli, interop, viewer
        from fractal_tpu_torch.tools import bla_phase, escape_bench
        from fractal_tpu_torch.utils import timing
        from fractal_tpu_torch.ops import _cuda_build, perturb
        from fractal_tpu_torch.parallel import multihost, sharding
        from fractal_tpu_torch.tools import dryrun_mesh
        img = render_u8(Scene(width=24, height=16, iterations=30), "cpu")
        img = render_u8(Scene(width=24, height=16, iterations=200, precision="p32",
                              pos=(-0.7436447860, 0.1318252536), scale=(1e6, 1e6)), "cpu")
        assert tuple(img.shape) == (16, 24, 3)
        assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
        assert not any(m == "fractal_tpu" or m.startswith("fractal_tpu.")
                       for m in sys.modules)
        print("ok")
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_cuda_requests_raise_without_cuda(monkeypatch):
    """No fallback hides the device: asking for cuda without it raises, and
    a kernel wrapper given a non-CPU tensor it cannot launch on raises."""
    from fractal_tpu_torch import render_u8

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        render_u8(tcfg.Scene(width=8, height=8), "cuda")
    meta = torch.empty(16, dtype=torch.float32, device="meta")
    with pytest.raises(RuntimeError, match="cuda"):
        tec.iterate_params(meta, algo="mandelbrot", power=2, iterations=4,
                           precision="f32", height=4, width=4)


@pytest.mark.parametrize("intervals,busy", [
    ([], 0.0),
    ([(0, 10), (20, 25)], 15.0),
    ([(0, 10), (5, 12), (11, 13), (2, 4)], 13.0),   # overlaps and nesting
    ([(20, 30), (0, 5), (5, 8)], 18.0),             # unsorted, touching
])
def test_profile_busy_time_is_the_union_of_kernel_intervals(intervals, busy):
    """``timing.profile_warm``'s device busy time (the idle share's numerator)."""
    from fractal_tpu_torch.utils.timing import union_length

    assert union_length(intervals) == busy
