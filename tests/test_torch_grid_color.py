"""The f32 grid loop's colored form (``ops/escape.iterate_grid_color``,
whose CUDA kernel is ``escape_time_f32_grid_color`` in
``csrc/escape_f64.cu``) and the loop that its two forms run on the card.

* ``iterate_grid_color_plain`` (``pixel_grid``, ``iterate_grid_plain``, the
  coloring on ``color_params``' block) must equal the route it replaces,
  ``render._render_grid(sc, "f32", "cpu")``, bit for bit: every rule and
  julia, inside and smooth on and off, the whole image and a band.  On the
  card the kernel is held bit-equal to it (``chip_smoke.py`` phase 26).
* Against the JAX package's ``render._escape_jnp_band`` on seeded views,
  jit disabled: XLA then contracts no a*b + c, so the counts agree on every
  pixel, and the u8 image agrees but where the float image lies within
  2^-12 of an integer and the log2 of XLA:CPU and of torch differ by an
  ulp (``test_coloring_u8_equal``'s tolerance), which moves a channel by 1
  (measured: on 2 elements in all the cases below).
* The kernel's control flow cannot run here, so a torch mirror of it
  (``_mirror``: zr² and zi² carried from one step's |z|² into the next,
  two steps a pass with one exit test, escape only where d > limit², an
  odd budget's last step) is held bit-equal to ``ops/escape.iterate`` on
  budgets 0-3 and 301, at limit 1e20 (limit² is inf in f32: exterior
  pixels overflow to inf and NaN and run to the budget), from start points
  outside the limit, and on every rule.  The mirror is the test's, not the
  package's.
"""

import itertools

import jax
import numpy as np
import pytest
import torch

from fractal_tpu.config import Scene as JScene
from fractal_tpu.ops import coloring as jcol
from fractal_tpu.ops import escape_jnp, viewport as jvp
from fractal_tpu.models.rules import get_rule as jax_rule
from fractal_tpu.render import _escape_jnp_band
from fractal_tpu_torch import interop
from fractal_tpu_torch.config import Scene
from fractal_tpu_torch.models.rules import get_rule
from fractal_tpu_torch.ops import coloring as tcol
from fractal_tpu_torch.ops import escape as tes
from fractal_tpu_torch.ops import escape_cuda as tec
from fractal_tpu_torch.ops.viewport import pixel_grid
from fractal_tpu_torch.render import _render_grid
from tests.test_torch_foundations import _u8_against_float_image

# Each rule's view, with escaping and interior pixels (test_torch_escape_color's).
RULES = {
    "mandelbrot": dict(pos=(-0.6, 0.0)),
    "julia": dict(algo="julia", julia_set=(-0.8, 0.156), scale=(0.6, 0.6)),
    "burningship": dict(algo="burningship", pos=(-0.45, -0.5), scale=(0.8, 0.8)),
    "tricorn": dict(algo="tricorn", pos=(-0.3, 0.0)),
    "multibrot3": dict(algo="multibrot", power=3),
    "julia3": dict(algo="julia", power=3, julia_set=(0.44304637997136526, 0.558308536476846),
                   scale=(0.6, 0.6)),
}


def _grid_kw(sc):
    return dict(width=sc.width, height=sc.height, pos=sc.pos, scale=sc.scale, algo=sc.algo,
                power=sc.power, iterations=sc.iterations, limit=sc.limit,
                julia_set=sc.julia_set if sc.algo == "julia" else None)


PLAIN_CASES = list(itertools.product(sorted(RULES), (True, False), (True, False), (150, 151)))


@pytest.mark.parametrize("rule,inside,smooth,iterations", PLAIN_CASES)
def test_grid_color_plain_equals_render_route(rule, inside, smooth, iterations):
    """The plain colored version against today's f32 grid route on the CPU;
    an odd budget renders a band of 20 rows from global row 11."""
    sc = Scene(width=48, height=36, iterations=iterations, inside=inside, smooth=smooth,
               exposure=3.0, precision="f32", **RULES[rule])
    row0, rows = (11, 20) if iterations % 2 else (0, None)
    color = tec.color_params(sc, device="cpu")
    got = tes.iterate_grid_color(color, inside=inside, smooth=smooth, row0=row0, rows=rows,
                                 **_grid_kw(sc))
    want = _render_grid(sc, "f32", "cpu", row0=row0, rows=rows)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (rows or sc.height, sc.width, 3)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert len(torch.unique(got.reshape(-1, 3), dim=0)) > 4  # the view has structure
    assert tes.F32_GRID_COLOR_LAUNCHES == 0


@pytest.mark.parametrize("rule", sorted(RULES))
def test_grid_color_plain_matches_jax(rule):
    """The plain colored version against ``_escape_jnp_band`` on a seeded
    view, jit disabled: counts equal, the u8 image equal but ±1 where the
    smooth term lies within 2^-12 of an integer."""
    rng = np.random.default_rng(sum(map(ord, rule)))
    view = dict(RULES[rule])
    x, y = view.get("pos", (0.0, 0.0))
    view["pos"] = (x + float(rng.uniform(-0.05, 0.05)), y + float(rng.uniform(-0.05, 0.05)))
    if "julia_set" in view:
        cr, ci = view["julia_set"]
        view["julia_set"] = (cr + float(rng.uniform(-0.01, 0.01)),
                             ci + float(rng.uniform(-0.01, 0.01)))
    jsc = JScene(width=32, height=24, iterations=120, exposure=float(rng.uniform(1, 6)),
                 precision="f32", **view)
    sc = interop.scene(jsc)
    ckw = dict(iterations=jsc.iterations, stable_limit=jsc.stable_limit, exposure=jsc.exposure,
               primary_color=jsc.primary_color.as_tuple(),
               secondary_color=jsc.secondary_color.as_tuple(), inside=True, smooth=True)
    with jax.disable_jit():
        want = np.asarray(_escape_jnp_band(jsc, "f32", 0, jsc.height))
        jcr, jci = jvp.pixel_grid(jsc.width, jsc.height, jsc.pos, jsc.scale)
        c = (jcr, jci) if jsc.algo != "julia" else tuple(
            np.float32(v) for v in jsc.julia_set)
        zr, zi, cnt = escape_jnp.iterate(jcr, jci, *c, jsc.iterations, jsc.limit,
                                         jax_rule(jsc.algo, jsc.power))
        want_f = np.asarray(jcol.color_escape_result(zr, zi, cnt, as_float=True, **ckw))
    color = tec.color_params(sc, device="cpu")
    got = tes.iterate_grid_color_plain(color, inside=True, smooth=True, **_grid_kw(sc)).numpy()
    tcr, tci = pixel_grid(sc.width, sc.height, sc.pos, sc.scale, device="cpu")
    tzr, tzi, tcnt = tes.iterate_grid_plain(tcr, tci, **{
        k: v for k, v in _grid_kw(sc).items() if k not in ("width", "height", "pos", "scale")})
    np.testing.assert_array_equal(tcnt.numpy(), np.asarray(cnt))
    assert len(np.unique(np.asarray(cnt))) > 5 and (np.asarray(cnt) == 120).any()
    got_f = tcol.color_from_block(tzr * tzr + tzi * tzi, tcnt, color, inside=True, smooth=True,
                                  as_float=True).numpy()
    # measured: 2 (julia3) of 2,304 elements, 0 in every other case
    assert _u8_against_float_image(got, want, got_f, want_f) <= 4


# --- the kernel's loop, mirrored in torch -----------------------------------


def _mirror(cr, ci, *, algo, power, iterations, limit, julia_set=None):
    """``escape_grid_f32`` (csrc/escape_f64.cu) on whole tensors, pass by
    pass: the state is z and its squares; a pass takes two steps and tests
    d > limit² once for both; a pixel that stopped keeps the first escaped
    step's z with count n, or the second's with n + 1; an odd budget takes
    one step more."""
    f32 = torch.float32
    limit_sq = torch.tensor(float(limit), dtype=f32) ** 2
    if julia_set is None:
        c = (cr, ci)
    else:
        c = tuple(torch.full_like(cr, float(np.float32(v))) for v in julia_set)
    step = get_rule(algo, power)

    def advance(s):
        r, i, r2, i2 = s
        if algo == "burningship":
            zr, zi = r2 - i2 + c[0], 2.0 * (r.abs() * i.abs()) + c[1]
        elif algo == "tricorn":
            zr, zi = r2 - i2 + c[0], -2.0 * (r * i) + c[1]
        elif power == 2:
            zr, zi = r2 - i2 + c[0], 2.0 * (r * i) + c[1]
        else:
            zr, zi = step(r, i, c[0], c[1])
        r2, i2 = zr * zr, zi * zi
        return (zr, zi, r2, i2), r2 + i2

    s = (cr, ci, cr * cr, ci * ci)
    cnt = torch.full(cr.shape, iterations, dtype=torch.int32)
    live = torch.ones(cr.shape, dtype=torch.bool)
    n = 0
    while n < iterations - 1:
        a, da = advance(s)
        b, db = advance(a)
        ea = da > limit_sq
        stop = live & (ea | (db > limit_sq))
        s = tuple(torch.where(live, torch.where(stop & ea, x, y), w) for x, y, w in zip(a, b, s))
        cnt = torch.where(stop, torch.where(ea, n, n + 1), cnt).to(torch.int32)
        live = live & ~stop
        n += 2
    if n < iterations:
        a, da = advance(s)
        s = tuple(torch.where(live, x, w) for x, w in zip(a, s))
        cnt = torch.where(live & (da > limit_sq), n, cnt).to(torch.int32)
    return s[0], s[1], cnt


MIRROR_RULES = {
    "mandelbrot": ("mandelbrot", 2, None),
    "julia": ("julia", 2, (-0.8, 0.156)),
    "burningship": ("burningship", 2, None),
    "tricorn": ("tricorn", 2, None),
    "multibrot3": ("multibrot", 3, None),
    "julia3": ("julia", 3, (0.44304637997136526, 0.558308536476846)),
}
# (case, iterations, limit, half-width of the start points' square)
MIRROR_CASES = [("budget", b, 2.0 ** 16, 2.0) for b in (0, 1, 2, 3, 301)] + [
    ("nan", 300, 1e20, 2.0), ("nan", 301, 1e20, 2.0),
    ("outside", 3, 4.0, 8.0), ("outside", 300, 4.0, 8.0)]


@pytest.mark.parametrize("rule,case", itertools.product(
    sorted(MIRROR_RULES), range(len(MIRROR_CASES))))
def test_kernel_loop_mirror_equals_iterate(rule, case):
    algo, power, julia = MIRROR_RULES[rule]
    what, its, limit, half = MIRROR_CASES[case]
    rng = np.random.default_rng(case * 7 + len(rule))
    cr, ci = (torch.from_numpy(rng.uniform(-half, half, (24, 32)).astype(np.float32))
              for _ in range(2))
    kw = dict(algo=algo, power=power, iterations=its, limit=limit, julia_set=julia)
    got = _mirror(cr, ci, **kw)
    want = tes.iterate_grid_plain(cr, ci, **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        torch.testing.assert_close(g.view(torch.int32) if g.is_floating_point() else g,
                                   w.view(torch.int32) if w.is_floating_point() else w,
                                   rtol=0, atol=0)
    cnt = want[2]
    if what == "nan":
        # exterior pixels overflowed and ran to the budget as NaN
        assert bool(torch.isnan(want[0]).any()) and bool((cnt == its).all())
    elif what == "outside":
        assert bool(((cr * cr + ci * ci) > limit * limit).any())
        assert bool((cnt == 0).any()) and bool((cnt < its).any())
    elif its == 301:
        assert 0 < int((cnt < its).sum()) < cnt.numel()


# --- the wrappers' refusals --------------------------------------------------


def test_grid_wrappers_on_a_device_tensor_launch_or_raise():
    """Off the CPU the wrappers never run a plain version: a grid that is not
    a CUDA (rows, W) pair of one float type, or a color block that is not a
    CUDA float32 (9,) tensor, raises ValueError before any launch."""
    kw = dict(algo="mandelbrot", power=2, iterations=10, limit=4.0)
    flat = torch.empty(32, dtype=torch.float32, device="meta")
    cube = torch.empty((2, 4, 8), dtype=torch.float32, device="meta")
    for grid in (flat, cube, flat[:0].reshape(0, 4)):
        with pytest.raises(ValueError, match=r"non-empty \(rows, W\) tensor"):
            tes.iterate_grid(grid, grid, **kw)
    with pytest.raises(ValueError, match="of cr's shape"):
        tes.iterate_grid(flat, cube, **kw)
    grid = torch.empty((4, 8), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="cuda, not meta"):
        tes.iterate_grid(grid, grid, **kw)
    gkw = dict(kw, width=8, height=4, pos=(0.0, 0.0), scale=(1.0, 1.0))
    for block in (torch.empty(9, dtype=torch.float32, device="meta"),
                  torch.empty(9, dtype=torch.float64, device="meta"),
                  torch.empty(8, dtype=torch.float32, device="meta")):
        with pytest.raises(ValueError, match="color must be a contiguous float32"):
            tes.iterate_grid_color(block, **gkw)
    assert tes.F32_GRID_LAUNCHES == tes.F32_GRID_COLOR_LAUNCHES == tes.F64_LAUNCHES == 0
