"""The f32 BLA route of mid-zoom perturbation renders against the JAX
package, on the CPU.

The reference builds the f32 BLA table only where its backend is the CPU
(``_perturb_setup``) and renders every quadratic mandelbrot or julia view
short of 1e30× there through ``_perturb_tile_bla``, in 256-row bands at
``PERT_CHUNK_CPU`` = 16 (``_render_perturb_jit``), on a mesh a stripe a
shard.  The port takes the same route on the CPU: ``ops/bla.build_table``
and ``ops/perturb._perturb_tile_bla``, route "f32 BLA".

* The table is bit-equal to the reference's on four orbits.
* The tile loop is bit-equal (zr, zi, cnt, gl) to ``perturb_whole_jnp(...,
  bla_packed=...)`` run under ``jax.disable_jit()`` on crops where a skip
  fires, with the P block built without the series (as
  ``tests/test_bla.py::_counts_plain`` builds it), so the skips start at
  step 0; each case shows its skips change z against the same loop without
  the table (kernel E's plain version, ``_perturb_tile``).
* Jitted, XLA:CPU contracts a·b + c into FMAs (ROADMAP §3): the 48×32
  seahorse at 1e13× and 3000 iterations differs from the jitted twin on 17
  of 1,536 counts (measured), held within 24 (1.5 %).
* Renders through ``render_u8(scene, "cpu")``, bands, the mesh, the CLI and
  ``tiled`` against the reference's CPU route, tolerances per view below;
  other algos, the floatexp tier and ``iterate_perturb`` never reach the
  loop.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fractal_tpu.config import Scene
from fractal_tpu.ops import bla as jbla
from fractal_tpu.ops import perturb as jpt
from fractal_tpu.parallel import sharding as jsh
from fractal_tpu_torch import interop, render_u8
from fractal_tpu_torch import tiled as tti
from fractal_tpu_torch.__main__ import main
from fractal_tpu_torch.ops import bla as tbla
from fractal_tpu_torch.ops import perturb as tpt
from fractal_tpu_torch.ops import perturb_cuda as tpc
from fractal_tpu_torch.parallel import sharding as tsh
from chip_smoke import F32_BLA_MISMATCH, F32_BLA_VIEW

SEAHORSE = (-0.74364388703715871, 0.13182590420531198)
SPIRAL = (-0.7746806106269039, -0.1374168856037867)


def _clear():
    for mod in (jpt, tpt):
        for name, val in vars(mod).items():
            if name.endswith("_CACHE") and isinstance(val, dict):
                val.clear()


@pytest.fixture(autouse=True)
def _fresh_caches():
    _clear()
    yield


def _mismatched(a, b) -> int:
    return int((np.asarray(a) != np.asarray(b)).any(-1).sum())


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


# ---------------------------------------------------------------------------
# The table
# ---------------------------------------------------------------------------

# name: (scene, what the table holds)
TABLES = {
    "seahorse-1e13": (Scene(width=48, height=32, iterations=3000, pos=SEAHORSE,
                            scale=(1e13, 1e13)), "valid levels"),
    # the needle's expanding orbit: no entry of any stored level is valid
    "needle-1e16": (Scene(width=64, height=48, iterations=300, pos=(-2.0, 0.0),
                          scale=(1e16, 1e16)), "none valid"),
    # below the smallest stored skip (64 steps): one dead placeholder row
    "iterations-40": (Scene(width=32, height=24, iterations=40, pos=(-2.0, 0.0),
                            scale=(1e16, 1e16)), "no stored level"),
    "julia-1e9": (Scene(algo="julia", julia_set=(-0.4, 0.6), width=48, height=32,
                        iterations=1000, pos=(0.3580968280467445, -0.3483709273182958),
                        scale=(1e9, 1e9)), "valid levels"),
}


@pytest.mark.parametrize("name", sorted(TABLES))
def test_build_table_equals_reference(name):
    """``build_table`` on the reference's orbit, and ``_bla_for`` through each
    package's own orbit and dc_max, give the reference's packed rows bit for
    bit, its offsets and its level count."""
    sc, holds = TABLES[name]
    w, h = sc.width, sc.height
    ref, orbit = jpt.resolve_reference(sc, w, h)
    z = np.asarray(orbit.packed)[:, :2]
    for dc_max in (0.0, 3.5e-12):
        want = jbla.build_table(z, orbit.n_steps, sc.iterations, dc_max, min_level=6)
        got = tbla.build_table(z, orbit.n_steps, sc.iterations, dc_max, min_level=6)
        np.testing.assert_array_equal(_bits(got.packed), _bits(want.packed))
        assert got.offsets == want.offsets and got.levels == want.levels
    want = jpt._bla_for(sc, orbit, ref, w, h)
    tref, torbit = tpt.resolve_reference(interop.scene(sc), w, h, "cpu")
    got = tpt._bla_for(interop.scene(sc), torbit, tref, w, h)
    np.testing.assert_array_equal(_bits(got.packed), _bits(want.packed))
    assert got.offsets == want.offsets and got.levels == want.levels
    valid = got.packed[:, 4] > 0.0
    if holds == "valid levels":
        assert valid.any()
    elif holds == "none valid":
        assert got.levels > 1 and not valid.any()
    else:
        assert got.levels == 1 and not got.packed.any()


# ---------------------------------------------------------------------------
# The tile loop against the JAX twin
# ---------------------------------------------------------------------------

# name: scene; the P block without the series (the skips start at step 0)
TILES = {
    # the reference orbit escapes at 315 and 218 steps: pixels leave the
    # plain loop's z after the skip at step 0
    "elephant-1e9": Scene(width=48, height=32, iterations=800, pos=(0.2501, 0.0000001),
                          scale=(1e9, 1e9)),
    "minibrot-1e11": Scene(width=48, height=32, iterations=800,
                           pos=(-1.7687788, 0.0017389), scale=(1e11, 1e11)),
    "julia-1e9": TABLES["julia-1e9"][0],
}


def _tile_inputs(sc, glitch: bool):
    """The reference's orbit, P (no series), table and packed orbit (its
    tolerance column zeroed for the p32 tier, as ``_packed_for`` zeroes it)
    → (JAX arguments, port arguments)."""
    w, h = sc.width, sc.height
    ref, orbit = jpt.resolve_reference(sc, w, h)
    P = jpt._pert_params(sc, ref, w, h)
    bla = jpt._bla_for(sc, orbit, ref, w, h)
    packed = np.array(np.asarray(orbit.packed))
    if not glitch:
        packed[:, 4] = 0.0
    jargs = (jnp.asarray(packed), P, jnp.int32(orbit.n_steps), bla)
    pk = torch.from_numpy(np.ascontiguousarray(np.asarray(orbit.packed)[:, :5]))
    targs = (pk, interop.params16(P), orbit.n_steps, interop.bla_table(bla))
    return jargs, targs


def _twin(sc, jargs):
    packed, P, ns, bla = jargs
    return jpt.perturb_whole_jnp(packed, P, ns, iterations=sc.iterations, height=sc.height,
                                 width=sc.width, chunk=jpt.PERT_CHUNK_CPU,
                                 bla_packed=jnp.asarray(bla.packed), bla_offsets=bla.offsets)


@pytest.mark.parametrize("glitch", [True, False], ids=["exact", "p32"])
@pytest.mark.parametrize("name", sorted(TILES))
def test_tile_loop_bit_equal_to_unjitted_twin(name, glitch):
    sc = TILES[name]
    jargs, targs = _tile_inputs(sc, glitch)
    stats = {}
    got = tpt.perturb_bla(*targs, iterations=sc.iterations, height=sc.height,
                          width=sc.width, glitch=glitch, stats=stats)
    with jax.disable_jit():
        want = _twin(sc, jargs)
    for label, g, w in zip(("zr", "zi", "cnt", "gl"), got, want):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w), err_msg=label)
    # the skips fired, and moved z off the loop without the table
    assert stats["skips"] > 0
    pk, P, ns, _ = targs
    plain = tpc.perturb_packed_plain(torch.from_numpy(np.array(jargs[0])), P, ns,
                                     iterations=sc.iterations, height=sc.height,
                                     width=sc.width)
    assert bool((plain[0] != got[0]).any())
    np.testing.assert_array_equal(_bits(plain[2].numpy()), _bits(got[2].numpy()))


def test_two_bands_bit_equal_to_the_unjitted_render_program():
    """A 300-row crop is two of the reference's 256-row gate groups (the
    second padded to row 512): the port's ``_render_bla`` through
    ``perturb_setup`` equals ``_render_perturb_jit``'s grids run unjitted, on
    the render's own P (with the series)."""
    sc = Scene(width=16, height=300, iterations=800, pos=SPIRAL, scale=(1e14, 1e14))
    w, h = sc.width, sc.height
    ref, orbit = jpt.resolve_reference(sc, w, h)
    P = jpt._pert_params(sc, ref, w, h, orbit=orbit)
    bla = jpt._bla_for(sc, orbit, ref, w, h)
    with jax.disable_jit():
        _, _, *want = jpt._render_perturb_jit(
            sc, jnp.asarray(orbit.packed), P, jnp.int32(orbit.n_steps), height=h, width=w,
            chunk=jpt.PERT_CHUNK_CPU, bla_packed=jnp.asarray(bla.packed),
            bla_offsets=bla.offsets)
    st = tpt.perturb_setup(interop.scene(sc), "cpu")
    assert st.bla is not None and not st.extreme and st.ref_px == tuple(ref)
    got = tpt._main_grid(interop.scene(sc), st, tpt.KERNELS, glitch=True)
    for label, g, w in zip(("zr", "zi", "cnt", "gl"), got, want):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w), err_msg=label)


@pytest.mark.parametrize("case", ["seahorse-1e13", "elephant-1e9"])
def test_tile_loop_against_jitted_twin(case):
    """Jitted, the reference contracts the δ-step's products: counts held
    within 1.5 % of the pixels (the seahorse: 17 of 1,536 measured, where
    one skip fires at step 0 and pixels run 3000 steps after it; the
    elephant: 0)."""
    sc = TABLES[case][0] if case in TABLES else TILES[case]
    jargs, targs = _tile_inputs(sc, True)
    got = tpt.perturb_bla(*targs, iterations=sc.iterations, height=sc.height,
                          width=sc.width)
    want = _twin(sc, jargs)
    assert int((got[2].numpy() != np.asarray(want[2])).sum()) <= 0.015 * sc.width * sc.height
    assert int((got[3].numpy() != np.asarray(want[3])).sum()) <= 0.015 * sc.width * sc.height


# ---------------------------------------------------------------------------
# Renders on the CPU
# ---------------------------------------------------------------------------

# name: (scene, mismatched pixels allowed against the reference's CPU
# render, measured)
RENDERS = {
    # a skip in the render's gate group, 115 colours; the jitted twin's
    # contraction: 11 of 1,536 in both tiers (the card's route: 5 more)
    "spiral-1e13": (Scene(width=48, height=32, iterations=3000, pos=SPIRAL,
                          scale=(1e13, 1e13)), 0.01),
    # the series skips to step 1024; the jitted twin's contraction: 13 of
    # 1,536 in both tiers
    "seahorse-1e13": (TABLES["seahorse-1e13"][0], 0.01),
    # the orbit runs out at step 256: every pixel is flagged in the exact
    # tier; in p32 the card's route colours the ran-out pixels from |z|² and
    # differs from the reference's CPU render on all 1,536, this route on 0
    "julia-1e9": (Scene(algo="julia", julia_set=(-0.8, 0.156), width=48, height=32,
                        iterations=1000, pos=(0.0, 0.0), scale=(1e9, 1e9)), 0),
}


@pytest.mark.parametrize("tier", ["p32", "perturb"])
@pytest.mark.parametrize("name", sorted(RENDERS))
def test_cpu_render_takes_the_route_of_the_reference(name, tier):
    sc, bound = RENDERS[name]
    sc = sc.replace(precision=tier)
    want = np.asarray(jpt.render_perturb(sc, fast=tier == "p32"))
    assert jpt.RENDER_STATS["route"] == "xla-twin-bla"
    n_glitch = jpt.RENDER_STATS["n_glitch"]
    _clear()
    got = render_u8(interop.scene(sc), "cpu").numpy()
    assert tpt.RENDER_STATS["route"] == "f32 BLA" and tpt.RENDER_STATS["tier"] == tier
    if tier == "perturb":
        assert tpt.RENDER_STATS["n_glitch"] == n_glitch
        assert tpt.RENDER_STATS["n_residual"] == 0
    assert _mismatched(got, want) <= bound * sc.width * sc.height
    if tier == "p32" or name != "julia-1e9":  # the julia view is all interior, exactly
        assert len(np.unique(got.reshape(-1, 3), axis=0)) > 16
    if name == "julia-1e9" and tier == "p32":
        _clear()
        card = tpt.render_perturb(interop.scene(sc), "cpu", fast=True, grids=tpt.CARD_ROUTE)
        assert tpt.RENDER_STATS["route"] == "plain"
        assert _mismatched(card.numpy(), want) == sc.width * sc.height


@pytest.mark.parametrize("tier", ["p32", "perturb"])
def test_cpu_route_beside_the_card_route(tier):
    """``chip_smoke.py``'s phase 28 view (240×135 at the spiral at 1e13×,
    2000; a skip in its one gate group): the f32 BLA image differs from the
    card's route run on the CPU (``CARD_ROUTE``, kernel B's plain versions)
    on 141 of 32,400 pixels in each tier (measured), held within
    ``F32_BLA_MISMATCH`` (180), the bound the card's image is held to
    there.  The view stays below 32,768 pixels a gate group, where torch
    runs its elementwise kernels on one thread: larger ones run threaded
    kernels, which stall when xdist's workers share the cores (a 960×540
    render took over 20 minutes in the tier-1 run, measured)."""
    sc = interop.scene(Scene(**F32_BLA_VIEW, precision=tier))
    bla = render_u8(sc, "cpu")
    assert tpt.RENDER_STATS["route"] == "f32 BLA" and tpt.RENDER_STATS["n_residual"] == 0
    _clear()
    card = tpt.render_perturb(sc, "cpu", fast=tier == "p32", grids=tpt.CARD_ROUTE)
    assert tpt.RENDER_STATS["route"] == "plain"
    assert 0 < _mismatched(bla.numpy(), card.numpy()) <= F32_BLA_MISMATCH
    assert len(np.unique(bla.numpy().reshape(-1, 3), axis=0)) > 16


@pytest.mark.parametrize("case", ["multibrot", "burningship", "floatexp", "floatexp fe BLA",
                                  "iterate_perturb", "card route"])
def test_other_routes_do_not_take_it(case, monkeypatch):
    """Multibrot, the burning ship (no bilinear step for their recurrences),
    the floatexp tier (its own routes), ``iterate_perturb`` (the reference
    passes no table there either) and ``CARD_ROUTE`` never reach the
    loop."""
    def refuse(*a, **k):
        raise AssertionError("the f32 BLA loop ran")

    monkeypatch.setattr(tpt, "_perturb_tile_bla", refuse)
    small = dict(width=24, height=16, iterations=300)
    if case == "multibrot":
        sc = Scene(algo="multibrot", power=3, pos=(0.443046379971365280901244412109,
                                                   0.558308536476846021719895522933),
                   scale=(1e9, 1e9), **small)
    elif case == "burningship":
        sc = Scene(algo="burningship", pos=(-0.45, -0.829977217668251374661143257379),
                   scale=(1e9, 1e9), **small)
    elif case == "floatexp":
        sc = Scene(pos_str=("-1.999999999999999999999999999999999999999999991", "0.0"),
                   scale=(1e44, 1e44), **small)
    elif case == "floatexp fe BLA":
        from tests.test_bla import MINIBROT_1E40_X, MINIBROT_1E40_Y

        sc = Scene(pos_str=(MINIBROT_1E40_X, MINIBROT_1E40_Y), scale=(1e40, 1e40),
                   width=16, height=12, iterations=400)
    else:
        sc = Scene(pos=SPIRAL, scale=(1e14, 1e14), **small)
    ts = interop.scene(sc.replace(precision="perturb"))
    if case == "iterate_perturb":
        zr, zi, cnt, _ = tpt.iterate_perturb(ts, 16, 24, "cpu")
        assert cnt.shape == (16, 24)
        return
    for fast in (True, False):
        grids = tpt.CARD_ROUTE if case == "card route" else tpt.ONE_DEVICE
        img = tpt.render_perturb(ts, "cpu", fast=fast, grids=grids)
        assert img.shape == (sc.height, sc.width, 3)
        assert tpt.RENDER_STATS["route"] == ("fe BLA" if case == "floatexp fe BLA" else "plain")


@pytest.mark.parametrize("tier", ["p32", "perturb"])
def test_bands_equal_the_one_shot_render(tier, tmp_path):
    """300 rows in bands of 112 (the third band crosses the 256-row gate
    groups' edge) with a checkpoint: each band runs the gate groups it
    overlaps whole and crops them, so the image equals the one-shot render
    (7 skips in its two groups, 70 colours); both name the route."""
    sc = interop.scene(Scene(width=16, height=300, iterations=2000, pos=SPIRAL,
                             scale=(1e13, 1e13), precision=tier))
    one = render_u8(sc, "cpu").numpy()
    assert tpt.RENDER_STATS["route"] == "f32 BLA"
    _clear()
    banded = tti.render_tiled(sc, band_rows=112, ckpt_dir=str(tmp_path / "ck"), device="cpu")
    assert tpt.RENDER_STATS["route"] == "f32 BLA"
    np.testing.assert_array_equal(banded, one)


@pytest.mark.parametrize("tier", ["p32", "perturb"])
@pytest.mark.parametrize("n", [2, 3, 8])
def test_cpu_mesh_against_the_reference_sharded_route(n, tier):
    """The reference's sharded CPU route runs the loop on each shard's stripe,
    the stripe one gate group; so does the port's mesh: equal to one
    device's render, and to the reference's within its contraction (11 of
    1,536 pixels at each n, measured, held within 1 %)."""
    sc = Scene(width=48, height=32, iterations=3000, pos=SPIRAL, scale=(1e13, 1e13),
               precision=tier)
    want = np.asarray(jsh.render_perturb_sharded(sc, jsh.make_mesh(n), fast=tier == "p32"))
    assert jpt.RENDER_STATS["route"] == "sharded-xla-twin-bla"
    _clear()
    got = tsh.render_perturb_sharded(interop.scene(sc), tsh.Mesh((torch.device("cpu"),) * n),
                                     fast=tier == "p32")
    assert tpt.RENDER_STATS["route"] == "sharded f32 BLA"
    assert _mismatched(got.numpy(), want) <= 0.01 * sc.width * sc.height
    _clear()
    np.testing.assert_array_equal(render_u8(interop.scene(sc), "cpu").numpy(), got.numpy())


def test_cli_profile_names_the_route(monkeypatch, tmp_path, capsys):
    """``FRACTAL_TPU_PLATFORM=cpu python -m fractal_tpu_torch ... --precision
    perturb --profile`` renders through the route and prints its name."""
    monkeypatch.setenv("FRACTAL_TPU_PLATFORM", "cpu")
    rc = main(f"24 16 -x {SPIRAL[0]!r} -y {SPIRAL[1]!r} -s 1e14 -i 800 --precision perturb "
              f"--format png --profile -o {tmp_path / 'spiral'}".split())
    out = capsys.readouterr().out
    assert rc == 0 and "tier: perturb" in out and "kernel route: f32 BLA" in out
