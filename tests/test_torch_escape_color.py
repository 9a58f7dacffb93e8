"""Kernel A's colored form: its plain version
(``escape_cuda.iterate_color_plain``) against the route it replaces and
against the JAX package, and the sweep that feeds it a block a frame.

* ``iterate_color_plain`` is ``iterate_whole`` followed by the coloring's
  ops on a constants block; it must equal ``iterate_whole`` followed by
  ``render._color_and_downsample`` bit for bit, for every rule, julia and
  mandelbrot, periodicity, inside and smooth, an even budget over the whole
  image and an odd one over a band (params[15]).  On the card the kernel is
  held bit-equal to it (``chip_smoke.py`` phase 23).
* Against the JAX package (``escape_pallas.iterate_whole_jnp`` and
  ``coloring.color_escape_result``) on views made from a seed with numpy:
  with jit disabled, XLA runs each op alone and contracts no a*b + c, so
  the counts agree on every pixel (measured: 0 mismatches in every case
  below; jitted, XLA:CPU's contraction flips boundary counts, ROADMAP
  §3's "Faults").  The u8 image agrees on every pixel
  but where the float image lies within 2^-12 of an integer and the log2 of
  XLA:CPU and of torch differ by an ulp (``test_coloring_u8_equal``'s
  tolerance), which moves a channel by 1 (measured: on 3 elements in all
  the cases below).  The ds32 z differs in its lo
  word on a few pixels (the JAX package's ``dd._fma`` rounds twice), which
  moves the float image by far less than that tolerance.
"""

import itertools

import jax
import numpy as np
import pytest
import torch

from fractal_tpu.config import Scene as JScene
from fractal_tpu.ops import coloring as jcol
from fractal_tpu.ops import escape_pallas as jep
from fractal_tpu_torch import animate as tan
from fractal_tpu_torch import interop, render_u8
from fractal_tpu_torch.config import RGB, Scene
from fractal_tpu_torch.ops import coloring as tcol
from fractal_tpu_torch.ops import escape_cuda as tec
from fractal_tpu_torch.render import _color_and_downsample
from tests.test_torch_foundations import _u8_against_float_image

# Each rule's view, with escaping and interior pixels: f32 and ds32 share it.
RULES = {
    "mandelbrot": dict(pos=(-0.6, 0.0)),
    "julia": dict(algo="julia", julia_set=(-0.8, 0.156), scale=(0.6, 0.6)),
    "burningship": dict(algo="burningship", pos=(-0.45, -0.5), scale=(0.8, 0.8)),
    "tricorn": dict(algo="tricorn", pos=(-0.3, 0.0)),
    "multibrot3": dict(algo="multibrot", power=3),
    "julia3": dict(algo="julia", power=3, julia_set=(0.44304637997136526, 0.558308536476846),
                   scale=(0.6, 0.6)),
}


def _kw(sc, precision, periodicity, height=None):
    return dict(algo=sc.algo, power=sc.power, iterations=sc.iterations, precision=precision,
                height=sc.height if height is None else height, width=sc.width,
                periodicity=periodicity)


def test_color_params_layout():
    sc = Scene(width=8, height=6, iterations=321, stable_limit=3.5, exposure=1.25,
               primary_color=RGB(10, 20, 30), secondary_color=RGB(40, 50, 60))
    block = tec.color_params(sc, device="cpu")
    assert block.dtype == torch.float32 and tuple(block.shape) == (tec.COLOR_FIELDS,)
    np.testing.assert_array_equal(block.numpy(), np.float32(
        [3.5, 321.0, 1.25, 10, 30, 20, 40, 60, 50]))
    other = sc.replace(exposure=2.5, iterations=322)
    params, colors = tec.frame_blocks([sc, other], device="cpu")
    assert tuple(params.shape) == (2, 16) and tuple(colors.shape) == (2, tec.COLOR_FIELDS)
    assert params[1].is_contiguous() and colors[1].is_contiguous()
    np.testing.assert_array_equal(params[1].numpy(), tec.scene_params(other, device="cpu"))
    np.testing.assert_array_equal(colors[0].numpy(), block.numpy())
    np.testing.assert_array_equal(colors[1].numpy(), tec.color_params(other, device="cpu"))


CASES = list(itertools.product(sorted(RULES), ("f32", "ds32"), (False, True), (True, False),
                               (True, False), (150, 151)))


@pytest.mark.parametrize("rule,precision,periodicity,inside,smooth,iterations", CASES)
def test_iterate_color_plain_equals_render_route(rule, precision, periodicity, inside, smooth,
                                                 iterations):
    """The colored form's plain version against the three-output route it
    replaces at supersample 1; an odd budget runs a band of 20 rows from
    global row 11."""
    sc = Scene(width=48, height=36, iterations=iterations, inside=inside, smooth=smooth,
               exposure=3.0, **RULES[rule])
    params = tec.scene_params(sc, device="cpu")
    rows = sc.height
    if iterations % 2:
        params[15] = 11.0
        rows = 20
    kw = _kw(sc, precision, periodicity, rows)
    got = tec.iterate_color(params, tec.color_params(sc, device="cpu"), inside=inside,
                            smooth=smooth, **kw)
    want = _color_and_downsample(sc, *tec.iterate_whole(params, **kw))
    assert got.dtype == torch.uint8 and tuple(got.shape) == (rows, sc.width, 3)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert len(torch.unique(got.reshape(-1, 3), dim=0)) > 4  # the view has structure


JAX_CASES = list(itertools.product(sorted(RULES), ("f32", "ds32"), (False, True)))


@pytest.mark.parametrize("rule,precision,periodicity", JAX_CASES)
def test_iterate_color_plain_matches_jax(rule, precision, periodicity):
    """The port's colored plain route against ``iterate_whole_jnp`` and
    ``color_escape_result`` on a seeded view, jit disabled: counts equal,
    the u8 image equal but ±1 where the smooth term lies within 2^-12 of an
    integer."""
    rng = np.random.default_rng(sum(map(ord, rule)) + 2 * periodicity + (precision == "ds32"))
    view = dict(RULES[rule])
    x, y = view.get("pos", (0.0, 0.0))
    view["pos"] = (x + float(rng.uniform(-0.05, 0.05)), y + float(rng.uniform(-0.05, 0.05)))
    if "julia_set" in view:
        cr, ci = view["julia_set"]
        view["julia_set"] = (cr + float(rng.uniform(-0.01, 0.01)),
                             ci + float(rng.uniform(-0.01, 0.01)))
    jsc = JScene(width=32, height=24, iterations=120, exposure=float(rng.uniform(1, 6)), **view)
    sc = interop.scene(jsc)
    kw = _kw(sc, precision, periodicity)
    ckw = dict(iterations=jsc.iterations, stable_limit=jsc.stable_limit, exposure=jsc.exposure,
               primary_color=jsc.primary_color.as_tuple(),
               secondary_color=jsc.secondary_color.as_tuple(), inside=True, smooth=True)
    jparams = jep.scene_params(jsc)
    with jax.disable_jit():
        zr, zi, cnt = jep.iterate_whole_jnp(jparams, **kw)
        want_f = np.asarray(jcol.color_escape_result(zr, zi, cnt, as_float=True, **ckw))
        want = np.asarray(jcol.color_escape_result(zr, zi, cnt, **ckw))
    params = interop.params16(jparams)
    color = tec.color_params(sc, device="cpu")
    got = tec.iterate_color_plain(params, color, inside=True, smooth=True, **kw).numpy()
    tzr, tzi, tcnt = tec.iterate_whole(params, **kw)
    np.testing.assert_array_equal(tcnt.numpy(), np.asarray(cnt))
    assert len(np.unique(np.asarray(cnt))) > 5 and (np.asarray(cnt) == 120).any()
    got_f = tcol.color_from_block(tzr * tzr + tzi * tzi, tcnt, color, inside=True, smooth=True,
                                  as_float=True).numpy()
    # measured: 2 (julia3 f32, periodicity off) and 1 (mandelbrot f32, on)
    # of 2,304 elements, 0 in every other case
    assert _u8_against_float_image(got, want, got_f, want_f) <= 4


@pytest.mark.parametrize("precision", ["f32", "ds32"])
def test_sweep_per_frame_exposure_equals_stills(precision):
    """A sweep whose frames vary exposure and stable_limit (fields the
    reference traces) renders each frame as its still: the colored form's
    block a frame carries them."""
    base = Scene(algo="julia", width=40, height=30, iterations=80, julia_set=(-0.8, 0.156),
                 scale=(0.5, 0.5), precision=precision)
    scenes = [base.replace(exposure=2.0 + 1.5 * i + 1e-9, stable_limit=2.0 + i)
              for i in range(4)]
    out = tan.render_sweep(scenes, device_resident=True, device="cpu")
    assert isinstance(out, torch.Tensor) and tuple(out.shape) == (4, 30, 40, 3)
    for i, sc in enumerate(scenes):
        torch.testing.assert_close(out[i], render_u8(sc, "cpu"), rtol=0, atol=0)
    assert len({out[i].numpy().tobytes() for i in range(4)}) == 4
