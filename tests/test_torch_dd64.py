"""Kernel A's dd64 form and the f64 escape loop of the port
(``fractal_tpu_torch.ops.escape_cuda`` on f64 words, ``ops/dd.py`` on f64
words, ``ops/escape.iterate_grid``) against the JAX package's dd64 twin
(``escape_pallas.iterate_whole_jnp(precision="dd64")``) and ``ops/dd.py``.

The JAX package's ``dd._fma`` is ``_fma_dekker`` (``jax.lax`` has no
``fma``): (p + c) + e over the exact Dekker product p + e.  The port takes
the same expression on f64 words, so under ``jax.disable_jit()``, where
every jnp op rounds on its own, the port's plain dd64 version is bit-equal
to the JAX twin: z words and counts.  Jitted, XLA:CPU contracts a*b + c
into FMAs and the z words differ in their last bits on a few pixels
(measured: 12 of 384 at the needle views), and a chaotic orbit can carry
that into its count: measured, 1 of 384 counts differs at burningship's
shallow view (periodicity on), 0 in every other case; held to at most 2.

Views: 24x16 at 1e16x near c = -2 (past f64: the pixel spacing is below
f64's ulp there), where every quadratic rule's needle runs, and for julia
the needle of c = -2 itself; for multibrot 3 a boundary point of its
imaginary axis at 1e16x (bisected with 60-digit mpmath against a budget of
60 steps).  Periodicity on takes shallower views of every rule with
interior pixels, where the Brent test freezes orbits (near -2 it flags
every pixel on the third step: the orbit sits on the repelling fixed point
2 for ~25 steps).  The unjitted twin takes ~12 ms a step on the CPU, so the twin's cases
keep budgets of 60-150 steps (the render's 300).
"""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fractal_tpu.config import Scene
from fractal_tpu.ops import dd as jdd
from fractal_tpu.ops import escape_pallas as jep
from fractal_tpu.render import render_u8 as jax_render_u8
from fractal_tpu_torch import animate as tan
from fractal_tpu_torch import interop, render_u8
from fractal_tpu_torch import tiled as tti
from fractal_tpu_torch.__main__ import main
from fractal_tpu_torch.cli import parse_options
from fractal_tpu_torch.config import exact_pos
from fractal_tpu_torch.models.rules import get_rule
from fractal_tpu_torch.ops import dd as tdd
from fractal_tpu_torch.ops import escape as tes
from fractal_tpu_torch.ops import escape_cuda as tec
from fractal_tpu_torch.ops import viewport
from tests.test_perturb import _mpmath_count

NEEDLE = dict(width=24, height=16, pos=(-2.0, 0.0), scale=(1e16, 1e16))
MB3_EDGE = ("0", "1.0897640601195403175545243015798")  # z^3 + c, bisected at 60 steps
# rule -> (periodicity-off view, periodicity-on view), each with its budget
CASES = {
    "mandelbrot": (dict(NEEDLE, iterations=100),
                   dict(width=24, height=16, iterations=150, pos=(-0.6, 0.0))),
    "julia": (dict(NEEDLE, algo="julia", julia_set=(-2.0, 0.0), iterations=100),
              dict(width=24, height=16, iterations=150, algo="julia",
                   julia_set=(-0.8, 0.156), scale=(0.6, 0.6))),
    "burningship": (dict(NEEDLE, algo="burningship", iterations=100),
                    dict(width=24, height=16, iterations=150, algo="burningship",
                         pos=(-0.45, -0.5), scale=(0.8, 0.8))),
    "tricorn": (dict(NEEDLE, algo="tricorn", iterations=100),
                dict(width=24, height=16, iterations=150, algo="tricorn", pos=(-0.3, 0.0))),
    "multibrot3": (dict(width=24, height=16, algo="multibrot", power=3, iterations=60,
                        pos_str=MB3_EDGE, scale=(1e16, 1e16)),
                   dict(width=24, height=16, algo="multibrot", power=3, iterations=60)),
}


def _bits(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x, dtype=np.float64)).view(np.int64)


def _words(rng, n: int):
    """n seeded double-words (hi, lo) with |lo| <= ulp(hi)/2 and hi over
    2^-8 .. 2^8."""
    hi = rng.standard_normal(n) * np.exp2(rng.integers(-8, 9, n))
    lo = hi * np.exp2(-54.0) * rng.uniform(-1.0, 1.0, n)
    return hi, lo


def _pair(words):
    return tuple(torch.from_numpy(np.array(w)) for w in words)


ARITH = {
    "two_prod": lambda m, x, y, c: m.two_prod(x[0], y[0]),
    "mul": lambda m, x, y, c: m.mul(x, y),
    "mul_f": lambda m, x, y, c: m.mul_f(x, y[0]),
    "add": lambda m, x, y, c: m.add(x, y),
    "quad_step": lambda m, x, y, c: sum(m.quad_step(x, y, c, x), ()),
    "quad_step_tricorn": lambda m, x, y, c: m.quad_step(x, y, c, y, cross_sign=-1.0)[1],
}


@pytest.mark.parametrize("op", sorted(ARITH))
def test_dd64_arithmetic_bit_equal(op):
    """ops/dd.py on f64 words == fractal_tpu/ops/dd.py under disable_jit,
    bit for bit, on 4,096 seeded double-words each."""
    rng = np.random.default_rng(11)
    x, y, c = (_words(rng, 4096) for _ in range(3))
    with jax.disable_jit():
        want = ARITH[op](jdd, *[tuple(jnp.asarray(w) for w in v) for v in (x, y, c)])
        want = [np.asarray(w) for w in want]
    got = [w.numpy() for w in ARITH[op](tdd, *[_pair(v) for v in (x, y, c)])]
    assert all(g.dtype == np.float64 for g in got)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g), _bits(w))


def test_f64_fma_is_the_reference_dekker_form():
    """The dd64 ``_fma`` is (p + c) + e, not a single-rounded FMA.  Against
    the correctly rounded a·b + c (``Fraction``) on 10,000 seeded triples of
    standard normals, 1,219 differ (pinned; ROADMAP "Faults" records it).
    Inside ``two_prod`` (c = -fl(a·b)) the two agree on every triple: the
    error word is exact either way."""
    assert not hasattr(jax.lax, "fma")  # so the JAX package's _fma is _fma_dekker
    rng = np.random.default_rng(0)
    a, b, c = (rng.standard_normal(10_000) for _ in range(3))
    got = tdd._fma(*(torch.from_numpy(v) for v in (a, b, c))).numpy()
    exact = np.array([float(Fraction(x) * Fraction(y) + Fraction(z))
                      for x, y, z in zip(a, b, c)])
    assert int((got != exact).sum()) == 1219
    with jax.disable_jit():
        np.testing.assert_array_equal(
            _bits(got), _bits(jdd._fma(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c))))
    p, e = tdd.two_prod(torch.from_numpy(a), torch.from_numpy(b))
    exact_e = np.array([float(Fraction(x) * Fraction(y) - Fraction(z))
                        for x, y, z in zip(a, b, p.numpy())])
    np.testing.assert_array_equal(_bits(e.numpy()), _bits(exact_e))
    # the f32 words keep the widened FMA: its two_prod error word is exact too
    a32, b32 = (torch.from_numpy(v.astype(np.float32)) for v in (a, b))
    p32, e32 = tdd.two_prod(a32, b32)
    exact_e32 = np.array([float(Fraction(float(x)) * Fraction(float(y)) - Fraction(float(z)))
                          for x, y, z in zip(a32, b32, p32)], dtype=np.float32)
    np.testing.assert_array_equal(e32.numpy(), exact_e32)


def _scene(view) -> Scene:
    return Scene(precision="dd64", **view)


@pytest.mark.parametrize("periodicity", [False, True], ids=["period-off", "period-on"])
@pytest.mark.parametrize("rule", sorted(CASES))
def test_dd64_escape_matches_reference_twin(rule, periodicity):
    """The port's plain dd64 ``iterate_whole`` == ``iterate_whole_jnp``
    under disable_jit (z words and counts, bit for bit); its counts == the
    jitted twin's but on at most 2 pixels; the view has structure."""
    sc = _scene(CASES[rule][periodicity])
    params = jep.scene_params(sc, dtype=jnp.float64)
    kw = dict(algo=sc.algo, power=sc.power, iterations=sc.iterations, precision="dd64",
              height=sc.height, width=sc.width, periodicity=periodicity)
    tparams = tec.scene_params(interop.scene(sc), device="cpu", dtype=torch.float64)
    np.testing.assert_array_equal(_bits(tparams.numpy()), _bits(params))
    zr, zi, cnt = tec.iterate_params(tparams, **kw)
    assert zr.dtype == zi.dtype == torch.float64 and cnt.dtype == torch.int32
    with jax.disable_jit():
        want = [np.asarray(v) for v in jep.iterate_whole_jnp(params, **kw)]
    np.testing.assert_array_equal(cnt.numpy(), want[2])
    np.testing.assert_array_equal(_bits(zr.numpy()), _bits(want[0]))
    np.testing.assert_array_equal(_bits(zi.numpy()), _bits(want[1]))
    jitted = jax.jit(lambda p: jep.iterate_whole_jnp(p, **kw))(params)
    assert int((cnt.numpy() != np.asarray(jitted[2])).sum()) <= 2
    assert len(np.unique(cnt.numpy())) > 1


def test_dd64_periodicity_flags_the_needle():
    """Near c = -2 the Brent test (eps² 1e-18, the reference's) takes every
    pixel for interior on its third step, escaping ones included: the orbit
    sits on the repelling fixed point 2 for ~25 steps.  The port follows the
    reference (its jitted twin's counts are equal); periodicity runs only
    where interiors render black (``inside=False``)."""
    sc = _scene(CASES["mandelbrot"][False])
    params = tec.scene_params(interop.scene(sc), device="cpu", dtype=torch.float64)
    kw = dict(algo="mandelbrot", power=2, iterations=sc.iterations, precision="dd64",
              height=sc.height, width=sc.width)
    off = tec.iterate_params(params, periodicity=False, **kw)[2]
    on = tec.iterate_params(params, periodicity=True, **kw)[2]
    assert int((off < sc.iterations).sum()) > 100 and bool((on == sc.iterations).all())
    jparams = jep.scene_params(sc, dtype=jnp.float64)
    want = jax.jit(lambda p: jep.iterate_whole_jnp(p, periodicity=True, **kw))(jparams)[2]
    np.testing.assert_array_equal(on.numpy(), np.asarray(want))


def test_dd64_render_matches_reference_and_mpmath():
    """``render_u8`` at dd64 on the CPU == the JAX package's ``render_u8``
    of the same scene within 16 of 384 pixels (measured: 10: the jitted
    twin's z words differ on 12 pixels, and the inside shade reads the
    final |z|²), and its
    sampled escaping pixels == 45-digit mpmath counts."""
    sc = Scene(precision="dd64", iterations=300, **NEEDLE)
    img = render_u8(interop.scene(sc), "cpu").numpy()
    want = np.asarray(jax_render_u8(sc))
    assert img.shape == want.shape == (16, 24, 3)
    assert int((img != want).any(-1).sum()) <= 16
    _, _, cnt = tec.iterate_params(
        tec.scene_params(interop.scene(sc), device="cpu", dtype=torch.float64),
        algo="mandelbrot", power=2, iterations=300, precision="dd64", height=16, width=24)
    (Ar, Cr), (Ai, Ci) = viewport.affine_fractions(24, 16, exact_pos(sc), sc.scale)
    checked = 0
    for x, y in [(0, 0), (12, 8), (23, 15), (3, 9), (5, 2), (20, 6), (7, 13), (16, 1)]:
        truth = _mpmath_count(Ar * x + Cr, Ai * y + Ci, 300, sc.limit)
        if truth < 250:  # escaping pixels; those on the needle are ill-conditioned
            assert int(cnt[y, x]) == truth, (x, y)
            checked += 1
    assert checked >= 4


def test_dd64_bands_and_sweep_equal_one_shot():
    """dd64 banded (bands of 5 rows: starts 0, 5, 10, 15) == one-shot bit
    for bit; a 3-frame dd64 sweep == its stills."""
    sc = interop.scene(Scene(precision="dd64", iterations=300, **NEEDLE))
    one = render_u8(sc, "cpu").numpy()
    np.testing.assert_array_equal(tti.render_tiled(sc, band_rows=5, device="cpu"), one)
    frames = [sc.replace(scale=(s, s)) for s in (1e14, 1e15, 1e16)]
    out = tan.render_sweep(frames, device="cpu")
    assert out.shape == (3, 16, 24, 3)
    for i, f in enumerate(frames):
        np.testing.assert_array_equal(out[i], render_u8(f, "cpu").numpy())


@pytest.mark.parametrize("rule", ["mandelbrot", "julia", "multibrot3"])
def test_f64_wrapper_on_cpu_is_iterate(rule):
    """``iterate_grid`` on CPU f64 tensors == ``ops/escape.iterate`` on the
    same grid, bit for bit."""
    sc = interop.scene(_scene(CASES[rule][1]))
    cr, ci = viewport.pixel_grid(sc.width, sc.height, sc.pos, sc.scale,
                                 dtype=torch.float64, device="cpu")
    julia = sc.julia_set if sc.algo == "julia" else None
    zr, zi, cnt = tes.iterate_grid(cr, ci, algo=sc.algo, power=sc.power,
                                   iterations=sc.iterations, limit=sc.limit, julia_set=julia)
    c = (cr, ci) if julia is None else tuple(torch.tensor(v, dtype=torch.float64)
                                            for v in julia)
    want = tes.iterate(cr, ci, *c, sc.iterations, sc.limit, get_rule(sc.algo, sc.power))
    for g, w in zip((zr, zi, cnt), want):
        assert torch.equal(g, w)
    assert tes.F64_LAUNCHES == 0


@pytest.mark.parametrize("precision,route", [("dd64", "kernel A dd64 plain version"),
                                             ("f64", "f64 grid, plain version")])
def test_cli_renders_exact_tiers_on_cpu(precision, route, monkeypatch, tmp_path, capsys):
    """``--precision dd64`` and ``f64`` render on the CPU through the CLI;
    ``--profile`` names the route, and the PNG equals ``render_u8``."""
    from PIL import Image

    monkeypatch.setenv("FRACTAL_TPU_PLATFORM", "cpu")
    out = tmp_path / "x"
    argv = ["24", "16", "-x", "-2", "-y", "0", "-s", "1e16", "-i", "300", "--precision",
            precision, "--profile", "-o", str(out), "--format", "png"]
    assert main(argv) == 0
    text = capsys.readouterr().out
    assert f"tier: {precision}" in text and route in text
    np.testing.assert_array_equal(np.asarray(Image.open(f"{out}.png").convert("RGB")),
                                  render_u8(parse_options(argv).scene, "cpu").numpy())
