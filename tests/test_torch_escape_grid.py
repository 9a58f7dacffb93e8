"""The grid escape loop on f32 words (``ops/escape.iterate_grid``, whose
CUDA form is ``escape_time_f32_grid`` in ``csrc/escape_f64.cu``) against the
JAX package's ``escape_jnp.iterate`` on f32 words, and ``render_u8``'s
``backend`` against ``fractal_tpu.render.render``'s.

The inputs are pixel coordinates drawn from a seeded numpy generator.  Run
op by op (``jax.disable_jit()``), the JAX loop rounds as torch does, so z
words and counts are bit-equal.  Jitted, XLA:CPU contracts a*b + c into
FMAs, which torch's eager ops never do: the counts are then held to a
stated share of pixels, measured per case below.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fractal_tpu.config import Scene as JaxScene
from fractal_tpu.models.rules import get_rule as jax_rule
from fractal_tpu.ops import escape_jnp
from fractal_tpu.render import render as jax_render
from fractal_tpu_torch import Scene, render
from fractal_tpu_torch.ops import escape as tes

# the module: the package's ``render`` attribute is the function
render_module = importlib.import_module("fractal_tpu_torch.render")

# (algo, power, julia c, iterations): every rule of the grid loop, and julia
RULES = {
    "mandelbrot": ("mandelbrot", 2, None, 200),
    "julia": ("julia", 2, (-0.8, 0.156), 200),
    "burningship": ("burningship", 2, None, 100),
    "tricorn": ("tricorn", 2, None, 200),
    "multibrot 3": ("multibrot", 3, None, 150),
    "julia 3": ("julia", 3, (0.44304637997136526, 0.558308536476846), 150),
}


def _grid(seed: int, shape=(24, 32)):
    rng = np.random.default_rng(seed)
    cr = rng.uniform(-2.0, 1.0, shape).astype(np.float32)
    ci = rng.uniform(-1.5, 1.5, shape).astype(np.float32)
    return cr, ci


def _jax_iterate(cr, ci, algo, power, julia, iterations, limit=2.0 ** 16):
    c = (cr, ci) if julia is None else tuple(jnp.asarray(v, jnp.float32) for v in julia)
    return escape_jnp.iterate(jnp.asarray(cr), jnp.asarray(ci),
                              *(jnp.asarray(v) for v in c), iterations, limit,
                              jax_rule(algo, power))


def _port(cr, ci, algo, power, julia, iterations, limit=2.0 ** 16):
    out = tes.iterate_grid(torch.from_numpy(cr), torch.from_numpy(ci), algo=algo,
                           power=power, iterations=iterations, limit=limit,
                           julia_set=julia)
    return [t.numpy() for t in out]


@pytest.mark.parametrize("name", list(RULES))
def test_f32_grid_equals_jax_op_by_op(name):
    algo, power, julia, its = RULES[name]
    cr, ci = _grid(len(name))
    with jax.disable_jit():
        want = [np.asarray(a) for a in _jax_iterate(cr, ci, algo, power, julia, its)]
    got = _port(cr, ci, algo, power, julia, its)
    assert got[0].dtype == np.float32 and got[2].dtype == np.int32
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.view(np.int32) if g.dtype == np.float32 else g,
                                      w.view(np.int32) if w.dtype == np.float32 else w)
    assert 0 < int((got[2] < its).sum()) < got[2].size  # escaping and held pixels
    assert tes.F32_GRID_LAUNCHES == 0


@pytest.mark.parametrize("name", list(RULES))
def test_f32_grid_counts_near_jitted_jax(name):
    """Against the jitted loop (the JAX package's route): counts differ on at
    most 2 % of the 768 pixels (measured: mandelbrot 2, julia 5, burningship
    12, tricorn, multibrot 3 and julia 3 none; the chaotic pixels near the
    boundary diverge after a contracted FMA)."""
    algo, power, julia, its = RULES[name]
    cr, ci = _grid(len(name))
    want = jax.jit(lambda a, b: _jax_iterate(a, b, algo, power, julia, its))(cr, ci)
    got = _port(cr, ci, algo, power, julia, its)
    assert int((got[2] != np.asarray(want[2])).sum()) <= 0.02 * cr.size


def test_iterate_grid_on_a_device_tensor_launches_or_raises():
    """Off the CPU the wrapper never runs the plain version: a dtype or shape
    it does not take raises ValueError before any launch, and a pair it takes
    goes to the kernel library and is never run by the plain version."""
    kw = dict(algo="mandelbrot", power=2, iterations=10, limit=4.0)
    meta = {dt: torch.empty((4, 8), dtype=dt, device="meta")
            for dt in (torch.float16, torch.float32, torch.float64)}
    with pytest.raises(ValueError, match="float64 or float32"):
        tes.iterate_grid(meta[torch.float16], meta[torch.float16], **kw)
    with pytest.raises(ValueError, match="torch.float32 tensor of cr's shape"):
        tes.iterate_grid(meta[torch.float32], meta[torch.float64], **kw)
    with pytest.raises(ValueError, match="of cr's shape"):
        tes.iterate_grid(meta[torch.float32], meta[torch.float32][:2], **kw)
    # a pair of the right type and shape off the card: refused before any build
    with pytest.raises((RuntimeError, ValueError)):
        tes.iterate_grid(meta[torch.float32], meta[torch.float32], **kw)
    assert tes.F32_GRID_LAUNCHES == 0


VIEW = dict(width=48, height=32, iterations=150, pos=(-0.75, 0.1), scale=(3.0, 3.0),
            exposure=5.0)


@pytest.mark.parametrize("backend,precision,route", [
    ("auto", "f32", "f32 grid, plain version (ops/escape.iterate)"),
    ("jnp", "f32", "f32 grid, plain version (ops/escape.iterate)"),
    ("pallas", "f32", "kernel A f32 colored plain version"),
    ("pallas", "f64", "kernel A f32 colored plain version"),
    ("jnp", "f64", "f64 grid, plain version (ops/escape.iterate)"),
    ("jnp", "ds32", "kernel A ds32 colored plain version"),
    ("pallas", "dd64", "kernel A dd64 plain version"),
])
def test_backend_routes_match_jax(backend, precision, route):
    """``render(scene, "cpu", backend)`` takes the JAX package's route for
    each backend and precision (render.py:222-241): jnp at f32 the grid
    loop, pallas at f32 and f64 kernel A's f32 form, ds32 and dd64 their own
    route whatever the backend.  The image is the JAX package's but for
    chaotic boundary pixels (XLA:CPU's contracted FMAs, and the jitted
    ds32/dd64 twins': measured 1 pixel of 1,536 for auto and jnp at f32, 5
    for pallas at f32 and f64, none for the rest); held to 1 %."""
    got = render(Scene(**VIEW, precision=precision), "cpu", backend)
    assert render_module.RENDER_STATS["route"] == route
    want = np.asarray(jax_render(JaxScene(**VIEW, precision=precision), backend=backend))
    assert got.shape == want.shape == (32, 48, 3)
    assert int((got != want).any(-1).sum()) <= 0.01 * 32 * 48


def test_backend_leaves_fern_and_perturbation_alone():
    fern = Scene(algo="fern", width=40, height=30, iterations=20_000, seed=3)
    deep = Scene(width=24, height=16, iterations=200, pos=(-0.74364388703715871,
                                                          0.13182590420531198),
                 scale=(1e15, 1e15), precision="p32")
    for sc in (fern, deep):
        base = render(sc, "cpu")
        for backend in ("jnp", "pallas"):
            np.testing.assert_array_equal(render(sc, "cpu", backend), base)
    with pytest.raises(ValueError, match="unknown backend"):
        render(deep, "cpu", "xla")
