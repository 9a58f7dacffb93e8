"""The port's device mesh (``fractal_tpu_torch/parallel/sharding.py``) on
logical meshes of 1, 2, 3 and 8 CPU shards: every sharded render bit-equal
to the port's one-device render (escape f32 on each backend and ds32,
supersampled; p32, the exact tier with the ds32 fallback and with
multi-reference resolution, floatexp and the fe BLA route; bands; julia,
zoom and floatexp-zoom sweeps; the fern's exact mode), each perturbation
pair from cleared caches, as tests/test_sharding.py:246-250 renders them;
the same renders against the JAX package's sharded functions on its
8-device CPU mesh (f32: kernel A's plain version rounds a few boundary
pixels otherwise than XLA:CPU's fused products, as the single-device tests
measure, within 0.4 % of the pixels; every other case bit-equal); the
ensemble and compat-replica fern modes against the JAX modes; the
``mesh_for_devices`` contract, the f64/dd64 refusal and ``RENDER_STATS``.

The fe BLA route's skip gate is a max over a band of rows; the reference's
sharded route takes it over each shard's stripe.  The port does the same;
at the 1e40x minibrot the two have agreed on every view measured (20 and
300 rows, ROADMAP §3), which ``test_fe_bla_past_one_band_against_jax``
holds for the port.
"""

import numpy as np
import pytest
import torch

from fractal_tpu import animate as jan
from fractal_tpu.config import Scene
from fractal_tpu.config import scene_defaults as jax_defaults
from fractal_tpu.ops import perturb as jpt
from fractal_tpu.parallel import sharding as jsh
from fractal_tpu_torch import animate as tan
from fractal_tpu_torch import interop
from fractal_tpu_torch import render_u8
from fractal_tpu_torch import tiled as tti
from fractal_tpu_torch.models import fern as tfern
from fractal_tpu_torch.ops import perturb as tpt
from fractal_tpu_torch.parallel import sharding as tsh
from fractal_tpu_torch.render import RENDER_STATS as ESCAPE_STATS
from tests.test_bla import MINIBROT_1E40_X, MINIBROT_1E40_Y

CPU = torch.device("cpu")
SHARDS = [1, 2, 3, 8]
SEAHORSE = (-0.74364388703715871, 0.13182590420531198)
NEEDLE = ("-1.999999999999999999999999999999999999999999991", "0.0")


def _mesh(n):
    return tsh.Mesh((CPU,) * n)


def _clear():
    for mod in (jpt, tpt):
        for name, val in vars(mod).items():
            if name.endswith("_CACHE") and isinstance(val, dict):
                val.clear()


@pytest.fixture(autouse=True)
def _fresh_caches():
    _clear()
    yield


@pytest.fixture(scope="module")
def jmesh():
    import jax

    assert len(jax.devices()) >= 8, "conftest must force 8 CPU devices"
    return jsh.make_mesh(8)


def _mismatched(a, b) -> int:
    return int((np.asarray(a) != np.asarray(b)).any(-1).sum())


# --- escape time ----------------------------------------------------------

ESCAPE = {
    # height 30 on 8 shards pads to 32
    "ds32": (Scene(width=40, height=30, iterations=128, pos=(-0.7436447860, 0.1318252536),
                   scale=(1e6, 1e6), precision="ds32"), "auto"),
    "ds32-ss3-bship": (Scene(algo="burningship", width=17, height=11, iterations=80,
                             supersample=3, scale=(0.5, 0.5), precision="ds32"), "auto"),
    "f32-auto": (Scene(algo="julia", width=64, height=47, iterations=60,
                       julia_set=(-0.8, 0.156), pos=(0.0, 0.0), scale=(0.4, 0.4),
                       precision="f32"), "auto"),
    "f32-jnp": (Scene(algo="julia", width=64, height=47, iterations=60,
                      julia_set=(-0.8, 0.156), pos=(0.0, 0.0), scale=(0.4, 0.4),
                      precision="f32", inside=False), "jnp"),
    "f32-pallas": (Scene(width=51, height=37, iterations=70, precision="f32", smooth=False),
                   "pallas"),
    "f32-ss2-auto": (Scene(width=33, height=21, iterations=60, supersample=2), "auto"),
}


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("case", sorted(ESCAPE))
def test_escape_sharded_bit_equal_to_one_device(case, n):
    sc, backend = ESCAPE[case]
    sc = interop.scene(sc)
    one = render_u8(sc, "cpu", backend)
    got = tsh.render_escape_sharded(sc, _mesh(n), backend=backend)
    assert got.shape == one.shape == (sc.height, sc.width, 3) and got.dtype == torch.uint8
    assert torch.equal(got, one)
    assert ESCAPE_STATS["route"].startswith("sharded ")


def test_escape_band_sharded_at_an_offset():
    """A band from global row 13, 3 shards: the rows of the one-shot image."""
    sc = interop.scene(ESCAPE["ds32"][0])
    one = render_u8(sc, "cpu")
    band = tsh.render_escape_band_sharded(sc, 13, 11, "ds32", _mesh(3))
    assert torch.equal(band, one[13:24])


# --- perturbation ---------------------------------------------------------

PERTURB = {
    "p32": dict(width=32, height=25, iterations=200, pos=SEAHORSE, scale=(1e15, 1e15),
                precision="p32"),
    "exact": dict(width=32, height=25, iterations=200, pos=SEAHORSE, scale=(1e15, 1e15),
                  precision="perturb"),
    "exact-floatexp": dict(width=24, height=17, iterations=300, pos_str=NEEDLE,
                           scale=(1e44, 1e44), precision="perturb"),
    "p32-floatexp": dict(width=24, height=17, iterations=300, pos_str=NEEDLE,
                         scale=(1e44, 1e44), precision="p32"),
    "exact-fe-bla": dict(width=32, height=20, iterations=400,
                         pos_str=(MINIBROT_1E40_X, MINIBROT_1E40_Y), scale=(1e40, 1e40),
                         precision="perturb"),
}


def _perturb_pair(sc, n, fast=False):
    """(one device, sharded), each from cleared caches, on the card's route
    (kernel B's plain versions below 1e30x; the CPU's f32 BLA route on a
    mesh is held in tests/test_torch_bla.py)."""
    _clear()
    one = tpt.render_perturb(sc, "cpu", fast=fast, grids=tpt.CARD_ROUTE)
    n_glitch = tpt.RENDER_STATS["n_glitch"]
    _clear()
    grids = tsh._perturb_grids(_mesh(n))._replace(f32_bla=False)
    got = tpt.render_perturb(sc, CPU, fast=fast, grids=grids)
    assert tpt.RENDER_STATS["n_glitch"] == n_glitch
    assert tpt.RENDER_STATS["route"].startswith("sharded ")
    return one, got


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("case", sorted(PERTURB))
def test_perturb_sharded_bit_equal_to_one_device(case, n):
    sc = interop.scene(Scene(**PERTURB[case]))
    one, got = _perturb_pair(sc, n, fast=sc.precision == "p32")
    assert torch.equal(got, one)
    assert tpt.RENDER_STATS["n_residual"] == 0
    if case == "exact-fe-bla":
        assert tpt.RENDER_STATS["route"] == "sharded fe BLA"


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("depth", ["ds32 fallback", "multiref"])
def test_flagged_pixels_resolved_after_the_gather(depth, n, monkeypatch):
    """A corner reference flags many pixels: above spacing 1e-13 kernel A's
    points form resolves them, below it the multi-reference rounds; both on
    the gathered grid, as one device resolves them."""
    if depth == "ds32 fallback":
        sc = Scene(width=32, height=23, iterations=2000, pos=SEAHORSE, scale=(1e8, 1e8),
                   precision="perturb")
    else:  # tests/test_torch_deep.py's needle view
        sc = Scene(width=24, height=17, iterations=300, inside=False, pos=(-2.0, 0.0),
                   scale=(1e16, 1e16))
    sc = interop.scene(sc)
    monkeypatch.setattr(tpt, "choose_reference", lambda s, ww, hh, device="cpu": (0, 0))
    monkeypatch.setattr(tpt, "reuse_reference", lambda s, ww, hh: None)
    one, got = _perturb_pair(sc, n)
    assert tpt.RENDER_STATS["n_glitch"] > 20 and tpt.RENDER_STATS["n_residual"] == 0
    assert torch.equal(got, one)


def test_fe_bla_past_one_band_against_jax(jmesh):
    """300 rows (two of the one-device route's 256-row bands; one stripe a
    shard): the port's sharded fe BLA route equals its one-device render
    and the JAX package's sharded render."""
    js = Scene(width=6, height=300, iterations=400, pos_str=(MINIBROT_1E40_X, MINIBROT_1E40_Y),
               scale=(1e40, 1e40), precision="perturb")
    sc = interop.scene(js)
    one, got = _perturb_pair(sc, 8)
    assert torch.equal(got, one)
    assert tpt.RENDER_STATS["route"] == "sharded fe BLA"
    np.testing.assert_array_equal(got.numpy(), np.asarray(jsh.render_perturb_sharded(js, jmesh)))


# --- bands ----------------------------------------------------------------


@pytest.mark.parametrize("n", SHARDS)
def test_bands_sharded_equal_one_shot(n, tmp_path):
    """ds32 bands of 16 rows (the last one 5), interleaved; with a
    checkpoint the sharded bands resume on one device."""
    sc = interop.scene(Scene(width=48, height=37, iterations=96, pos=(-0.7436447860, 0.1318252536),
                             scale=(1e6, 1e6), precision="ds32"))
    one = render_u8(sc, "cpu").numpy()
    np.testing.assert_array_equal(tti.render_tiled(sc, 16, mesh=_mesh(n)), one)
    ck = str(tmp_path / "ck")
    tti.render_tiled(sc, 16, ck, mesh=_mesh(n))
    np.testing.assert_array_equal(tti.render_tiled(sc, 16, ck, device="cpu"), one)


@pytest.mark.parametrize("n", [2, 3, 8])
@pytest.mark.parametrize("precision", ["perturb", "p32"])
def test_perturb_bands_sharded_equal_one_device_bands(precision, n, tmp_path):
    sc = interop.scene(Scene(width=32, height=24, iterations=100, pos=SEAHORSE,
                             scale=(1e15, 1e15), precision=precision))
    mesh = tti.render_tiled(sc, 8, str(tmp_path / "m"), mesh=_mesh(n))
    _clear()
    one = tti.render_tiled(sc, 8, str(tmp_path / "s"), device="cpu")
    np.testing.assert_array_equal(mesh, one)


def test_tiled_perturb_without_checkpoint_keeps_the_mesh():
    """tests/test_sharding.py:490 on the port: the one-shot render, across
    the mesh."""
    sc = interop.scene(Scene(width=32, height=24, iterations=100, pos=SEAHORSE,
                             scale=(1e15, 1e15), precision="perturb"))
    one = render_u8(sc, "cpu").numpy()
    _clear()
    np.testing.assert_array_equal(tti.render_tiled(sc, 8, mesh=_mesh(3)), one)
    assert tpt.RENDER_STATS["route"].startswith("sharded ")


# --- sweeps ---------------------------------------------------------------


def _julia_scenes(frames=6):
    cs = jan.julia_c_path(np.linspace(0.0, 1.0, frames, endpoint=False))
    return [Scene(algo="julia", width=40, height=30, iterations=60,
                  julia_set=(float(a), float(b)), pos=(0.0, 0.0), scale=(0.4, 0.4))
            for a, b in cs]


@pytest.mark.parametrize("n", SHARDS)
def test_julia_sweep_sharded(n):
    """6 frames: on 8 shards, blocks of one and shards with none."""
    scenes = [interop.scene(s) for s in _julia_scenes()]
    one = tan.render_sweep(scenes, device="cpu")
    got = tan.render_sweep(scenes, mesh=_mesh(n))
    assert got.shape == (6, 30, 40, 3)
    np.testing.assert_array_equal(got, one)


@pytest.mark.parametrize("kind,n", [(k, n) for k in ("zoom", "exact zoom") for n in SHARDS]
                         + [("floatexp zoom", 3), ("floatexp zoom", 8)])
def test_zoom_sweep_sharded(kind, n):
    if kind == "floatexp zoom":
        sc, scales = Scene(width=24, height=16, iterations=300, pos_str=NEEDLE,
                           scale=(1e44, 1e44)), [1e38, 1e41, 1e44]
    elif kind == "exact zoom":  # every frame flags pixels and is re-rendered
        sc, scales = Scene(width=48, height=32, iterations=300, pos=(-2.0, 0.0),
                           scale=(1e16, 1e16)), [1e3, 1e8, 1e16]
    else:
        sc, scales = Scene(width=32, height=24, iterations=200, pos=SEAHORSE,
                           scale=(1e15, 1e15)), np.geomspace(0.4, 1e15, 5)
    sc, exact = interop.scene(sc), kind == "exact zoom"
    one = tan.render_zoom_sweep(sc, scales, exact=exact, device="cpu")
    stats = dict(tan.SWEEP_STATS)
    _clear()
    got = tan.render_zoom_sweep(sc, scales, exact=exact, mesh=_mesh(n))
    np.testing.assert_array_equal(got, one)
    assert tan.SWEEP_STATS == stats
    if exact:
        assert all(f > 0 for f in stats["flagged"]), stats


# --- the fern -------------------------------------------------------------

FERNS = {  # (scene fields, walkers)
    "default": (dict(), tfern.DEFAULT_WALKERS),
    "replicas": (dict(fern_replicas=3), tfern.DEFAULT_WALKERS),
    "supersample": (dict(supersample=2, iterations=20_000), tfern.DEFAULT_WALKERS),
    "fewer walkers than shards": (dict(iterations=5), tfern.DEFAULT_WALKERS),
    # 200 steps a walker: four batches of the walk, each on its slice's uniforms
    "many steps": (dict(iterations=100_000), 500),
}


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("case", sorted(FERNS))
def test_fern_exact_sharded_bit_equal(case, n):
    fields, walkers = FERNS[case]
    kw = dict(width=48, height=48, iterations=40_000, seed=7) | fields
    sc = interop.scene(jax_defaults("fern").replace(**kw))
    one = tfern.render_fern(sc, "cpu", walkers=walkers)
    got = tsh.render_fern_sharded(sc, _mesh(n), walkers=walkers)
    assert torch.equal(got, one)
    assert tfern.RENDER_STATS["route"] == "sharded plain"


# --- against the JAX package's sharded renders ----------------------------


@pytest.mark.parametrize("case", ["ds32", "f32-pallas"])
def test_escape_sharded_against_jax(case, jmesh):
    sc, backend = ESCAPE[case]
    want = np.asarray(jsh.render_escape_sharded(sc, jmesh, precision=sc.precision))
    got = tsh.render_escape_sharded(interop.scene(sc), _mesh(8), backend=backend).numpy()
    bound = 0.004 * sc.width * sc.height if sc.precision == "f32" else 0
    assert _mismatched(got, want) <= bound


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "p32"])
def test_perturb_sharded_against_jax(fast, jmesh):
    js = Scene(**PERTURB["exact"])
    want = np.asarray(jsh.render_perturb_sharded(js, jmesh, fast=fast))
    _clear()
    got = tsh.render_perturb_sharded(interop.scene(js), _mesh(8), fast=fast)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", [dict(), dict(exact=False), dict(compat_replicas=True)],
                         ids=["exact", "ensemble", "compat"])
def test_fern_modes_against_jax(mode, jmesh):
    js = jax_defaults("fern").replace(width=48, height=48, iterations=40_000, seed=7)
    want = np.asarray(jsh.render_fern_sharded(js, jmesh, **mode))
    got = tsh.render_fern_sharded(interop.scene(js), _mesh(8), **mode)
    np.testing.assert_array_equal(got.numpy(), want)
    # off the attractor: the background, or its saturating sum of 8
    assert tuple(want[0, 0]) == ((255,) * 3 if mode.get("compat_replicas") else (240,) * 3)


def test_sweeps_against_jax(jmesh):
    scenes = _julia_scenes()
    want = jan.render_sweep(scenes, mesh=jmesh)
    got = tan.render_sweep([interop.scene(s) for s in scenes], mesh=_mesh(8))
    for i in range(len(scenes)):
        assert _mismatched(got[i], want[i]) <= 0.004 * 40 * 30
    # tests/test_torch_animate.py's fast sweep, equal to the JAX sweep's
    zs = Scene(width=32, height=24, iterations=300, pos=SEAHORSE, scale=(1e13, 1e13),
               inside=False, precision="perturb")
    np.testing.assert_array_equal(
        tan.render_zoom_sweep(interop.scene(zs), [1e6, 1e13], mesh=_mesh(8)),
        jan.render_zoom_sweep(zs, [1e6, 1e13], mesh=jmesh))


# --- the mesh itself ------------------------------------------------------


def test_mesh_for_devices_validation():
    """tests/test_sharding.py:185 on the port, with the CPU's 8 shards."""
    assert tsh.mesh_for_devices(1, "cpu") is None
    every = tsh.mesh_for_devices(0, "cpu")
    assert every.size == tsh.CPU_SHARDS and every.devices == (CPU,) * tsh.CPU_SHARDS
    assert tsh.mesh_for_devices(3, "cpu").size == 3
    with pytest.raises(ValueError, match="must be >= 0"):
        tsh.mesh_for_devices(-1, "cpu")
    with pytest.raises(ValueError, match="--devices 9: only 8 device"):
        tsh.mesh_for_devices(9, "cpu")
    with pytest.raises(ValueError, match="one type"):
        tsh.Mesh((CPU, torch.device("meta")))
    with pytest.raises(ValueError, match="renders no shard"):
        tsh.Mesh((CPU, CPU), ranks=(1, 1), rank=0)
    m = tsh.Mesh((CPU,) * 4)
    assert (m.size, m.local, m.home, m.spans_ranks) == (4, (0, 1, 2, 3), CPU, False)


@pytest.mark.parametrize("precision", ["f64", "dd64"])
def test_sharded_refuses_f64_dd64(precision):
    sc = interop.scene(Scene(width=16, height=12, iterations=40, precision=precision))
    with pytest.raises(ValueError, match="sharded rendering supports f32/ds32/perturb"):
        tsh.render_escape_sharded(sc, _mesh(2))
    with pytest.raises(ValueError, match="sharded rendering supports f32/ds32/perturb"):
        tti.render_tiled(sc, 4, mesh=_mesh(2))
    with pytest.raises(ValueError, match="sharded rendering supports"):
        jsh.render_escape_sharded(Scene(width=16, height=12, iterations=40,
                                        precision=precision), jsh.make_mesh(2))


def test_render_stats_after_sharded_renders():
    """tests/test_sharding.py:288-310 on the port: tier, route and glitch
    count of the sharded perturbation tiers (a CPU mesh runs the f32 BLA
    route on its stripes, as the reference's CPU mesh does)."""
    deep = interop.scene(Scene(**PERTURB["exact"]))
    tsh.render_perturb_sharded(deep, _mesh(3), fast=True)
    st = tpt.RENDER_STATS
    assert (st["tier"], st["n_glitch"], st["route"]) == ("p32", None, "sharded f32 BLA")
    tsh.render_perturb_sharded(deep, _mesh(3))
    assert st["tier"] == "perturb" and st["n_glitch"] == 0 and st["route"] == "sharded f32 BLA"
    tsh.render_perturb_sharded(interop.scene(Scene(**PERTURB["exact-floatexp"])), _mesh(2))
    assert st["tier"] == "floatexp" and st["route"].startswith("sharded")
