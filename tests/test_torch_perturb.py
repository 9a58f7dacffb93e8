"""The port's p32 path against the JAX package.

Host side (reference pixel and orbit, series skip, the P block, the orbit
table): bit-equal.  Device side: kernel B's plain version against
``perturb_pallas_v2(dist_only=True, interpret=True)``, and the card's p32
route run on the CPU (``render_perturb(..., grids=CARD_ROUTE)``; a CPU
``render_u8`` takes the f32 BLA route, tests/test_torch_bla.py) against
``_render_perturb_pallas_fast_jit(..., interpret=True)``, on the same
inputs (carried over by ``interop``).

The δ-orbit counts carry a stated tolerance: XLA:CPU contracts a*b + c
into FMAs inside the jitted reference (the series polynomial and each
δ-step), and the port never fuses.  On long-running boundary pixels the
f32 δ-orbit amplifies that last-bit difference into a count flip
(measured below per scene).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fractal_tpu.config import Scene
from fractal_tpu.ops import perturb as jpt
from fractal_tpu_torch import interop, render_u8
from fractal_tpu_torch.ops import perturb as tpt
from fractal_tpu_torch.ops import perturb_cuda as tpc

DEEP = (-0.7436447860, 0.1318252536)
SKIP_CENTER = (-0.74364388703715871, 0.13182590420531198)

# name: (scene, measured count mismatches of 1,728, bound as a fraction)
SCENES = {
    # tests/test_perturb.py:1222; measured 4 of 1,728
    "deep-1e6": (Scene(width=48, height=36, iterations=400, pos=DEEP, scale=(1e6, 1e6),
                       precision="p32", inside=False), 0.005),
    # the center escapes early, so the ds32 probe picks the reference;
    # measured 19 of 1,728: pixels ride the orbit to its end at 376 steps
    "julia-1e5": (Scene(algo="julia", width=48, height=36, iterations=600,
                        julia_set=(-0.4, 0.6),
                        pos=(0.10416666666666666, -0.9374999999999999),
                        scale=(1e5, 1e5), precision="p32"), 0.015),
    # the series skip fires (P[8] = 768); measured 9 of 1,728
    "skip-1e10": (Scene(width=48, height=36, iterations=1200, pos=SKIP_CENTER,
                        scale=(1e10, 1e10), precision="p32", inside=False), 0.01),
}


@pytest.fixture(autouse=True)
def _fresh_caches():
    """Both packages memoize orbits across views (cross-view reuse); start
    every test from empty caches so both see the same history."""
    for mod in (jpt, tpt):
        for name, val in vars(mod).items():
            if name.endswith("_CACHE") and isinstance(val, dict):
                val.clear()
    yield


def _jax_inputs(sc):
    w, h = sc.width, sc.height
    ref, orbit = jpt.resolve_reference(sc, w, h)
    P = jpt._pert_params(sc, ref, w, h, orbit=orbit)
    return ref, orbit, P, jpt.orbit_planes(orbit)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_host_side_bit_equal(name):
    sc, _ = SCENES[name]
    ts = interop.scene(sc)
    w, h = sc.width, sc.height
    ref, orbit, P, planes = _jax_inputs(sc)
    tref, torbit = tpt.resolve_reference(ts, w, h, "cpu")
    assert tref == ref
    assert torbit.n_steps == orbit.n_steps and torbit.ref_px == orbit.ref_px
    np.testing.assert_array_equal(torbit.packed.view(np.int32),
                                  np.asarray(orbit.packed).view(np.int32))
    tP = tpt._pert_params(ts, tref, w, h, orbit=torbit)
    np.testing.assert_array_equal(tP.numpy().view(np.int32),
                                  np.asarray(P).view(np.int32))
    assert torch.equal(interop.params16(P).view(torch.int32), tP.view(torch.int32))
    table = tpt.orbit_table(torbit)
    np.testing.assert_array_equal(table.view(np.int32),
                                  interop.orbit_table(planes).numpy().view(np.int32))
    assert table.shape == (sc.iterations + tpt.ORBIT_PAD, 2)
    if name == "skip-1e10":
        assert float(P[8]) == 768.0 and float(P[8]) % tpt.SERIES_ALIGN == 0


def test_series_skip_and_orbit_interop_equal():
    """series_skip on the same orbit, and the RefOrbit carried through
    interop, give the JAX package's (n_skip, A', B', C') exactly."""
    sc, _ = SCENES["skip-1e10"]
    ref, orbit, _, _ = _jax_inputs(sc)
    torbit = interop.ref_orbit(orbit)
    for dc_max, julia in ((3.1e-11, False), (3.1e-11, True), (1e-9, False)):
        for align in (1, tpt.SERIES_ALIGN):
            want = jpt.series_skip(orbit.packed[:, :2], sc.iterations, dc_max, julia,
                                   align=align, esc_radius=float(sc.limit))
            got = tpt.series_skip(torbit.packed[:, :2], sc.iterations, dc_max, julia,
                                  align=align, esc_radius=float(sc.limit))
            assert got == want
    for name in ("ORBIT_PAD", "SERIES_ALIGN", "SERIES_MIN_SKIP", "SERIES_TOL",
                 "F64_ORBIT_SPACING_LIMIT", "EXTREME_SPACING_LIMIT", "GLITCH_TOL_SQ"):
        assert getattr(jpt, name) == getattr(tpt, name), name


def test_cross_view_reuse_matches():
    """A pan that keeps the reference in view reuses the cached orbit in
    both packages, at the same fractional reference coordinates."""
    sc, _ = SCENES["deep-1e6"]
    ts = interop.scene(sc)
    w, h = sc.width, sc.height
    jpt.resolve_reference(sc, w, h)
    tpt.resolve_reference(ts, w, h, "cpu")
    pan = dict(pos=(DEEP[0] + 3.0 / (h * 1e6), DEEP[1] - 2.0 / (h * 1e6)))
    jref, jorbit = jpt.resolve_reference(sc.replace(**pan), w, h)
    tref, torbit = tpt.resolve_reference(ts.replace(**pan), w, h, "cpu")
    assert tref == jref and isinstance(tref[0], float)
    assert torbit.n_steps == jorbit.n_steps
    np.testing.assert_array_equal(torbit.packed, jorbit.packed)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_dist_only_plain_matches_interpreted_kernel(name):
    sc, bound = SCENES[name]
    w, h = sc.width, sc.height
    julia = sc.algo == "julia"
    ref, orbit, P, planes = _jax_inputs(sc)
    d, cnt = jpt.perturb_pallas_v2(planes, P, jnp.int32(orbit.n_steps),
                                   iterations=sc.iterations, height=h, width=w,
                                   julia=julia, glitch=False, interpret=True,
                                   dist_only=True)
    td, tcnt = tpc.perturb_dist(interop.orbit_table(planes), interop.params16(P),
                                orbit.n_steps, height=h, width=w, algo=sc.algo,
                                power=sc.power)
    cnt = np.asarray(cnt)
    assert len(np.unique(cnt)) > 5
    assert np.mean(tcnt.numpy() != cnt) <= bound
    # where the counts agree, both froze on the same side of the escape limit
    same = tcnt.numpy() == cnt
    lim = float(sc.limit) ** 2
    np.testing.assert_array_equal((td.numpy() > lim)[same], (np.asarray(d) > lim)[same])


@pytest.mark.parametrize("name", sorted(SCENES))
def test_p32_render_matches_fused_fast_program(name):
    sc, bound = SCENES[name]
    w, h = sc.width, sc.height
    ref, orbit, P, planes = _jax_inputs(sc)
    want = np.asarray(jpt._render_perturb_pallas_fast_jit(
        sc, planes, P, jnp.int32(orbit.n_steps), height=h, width=w,
        julia=sc.algo == "julia", interpret=True))
    got = tpt.render_perturb(interop.scene(sc), "cpu", fast=True, grids=tpt.CARD_ROUTE).numpy()
    assert tpt.RENDER_STATS["route"] == "plain"
    assert got.shape == want.shape == (h, w, 3)
    assert np.mean((got != want).any(-1)) <= bound


def test_unported_perturbation_paths_raise():
    """The fern renders; an affine julia has no δ-recurrence at all; past
    1e30× (floatexp, in p32 and perturb alike) only quadratic mandelbrot and
    julia render, and the other rules raise the JAX package's ValueError."""
    base = interop.scene(SCENES["deep-1e6"][0])
    fern = render_u8(base.replace(algo="fern", iterations=20_000, pos=(0.0, 0.0),
                                  scale=(0.4, 0.4)), "cpu")
    assert tuple(fern.shape) == (36, 48, 3) and tuple(fern[0, 0].tolist()) == (240, 0, 170)
    with pytest.raises(ValueError, match="perturbation supports"):
        render_u8(base.replace(algo="julia", power=1), "cpu")
    for prec in ("p32", "perturb"):
        for kw in (dict(algo="burningship"), dict(algo="multibrot", power=3),
                   dict(algo="tricorn")):
            with pytest.raises(ValueError, match="1e30"):
                render_u8(base.replace(scale=(1e35, 1e35), precision=prec, **kw), "cpu")
    img = render_u8(base.replace(width=8, height=6, iterations=40, scale=(1e35, 1e35),
                                 precision="perturb"), "cpu")
    assert tuple(img.shape) == (6, 8, 3) and tpt.RENDER_STATS["tier"] == "floatexp"
