"""The port's banded renders with checkpoint/resume (``fractal_tpu_torch.tiled``
and ``ops/perturb.render_perturb_band``) against the JAX package's
(``fractal_tpu.tiled``), and the port held to the reference's own tests
(tests/test_tiled.py).

Banded equals one-shot bit for bit at every tier but one: f32 on the CPU.
There the one-shot render takes the grid route (``pixel_grid`` + ``iterate``)
and a band takes kernel A's plain version, whose pixel → c arithmetic
differs (c = x·(A_hi + A_lo) + (C_hi + C_lo) against ((x/h − off)/s + pos));
torch's eager ops do not contract, so the rest of the loop is the same.
Measured at SCENE in f32: 16 of 6,144 pixels differ.  On the card both
routes are kernel A and equal bit for bit (``chip_smoke.py``).  Against the
JAX package: ds32 and the perturbation tiers here agree on every pixel; f32
differs on 12 of 6,144 (the reference's band is its interpreted kernel,
contracted); f64 at 1e9× / 3,000 iterations on 43 of 1,536 (XLA:CPU
contracts the f64 escape loop too, and the view is chaotic).
"""

import json
import os

import numpy as np
import pytest
import torch

from fractal_tpu import tiled as jti
from fractal_tpu.config import Scene, scene_defaults
from fractal_tpu.ops import perturb as jpt
from fractal_tpu_torch import interop, render_u8
from fractal_tpu_torch import tiled as tti
from fractal_tpu_torch.ops import escape_cuda as tec
from fractal_tpu_torch.ops import perturb as tpt
from fractal_tpu_torch.ops import perturb_cuda as tpc
from fractal_tpu_torch.parallel.sharding import Mesh
from tests.test_bla import MINIBROT_1E40_X, MINIBROT_1E40_Y

SCENE = Scene(width=64, height=96, iterations=80, pos=(-0.6, 0.0), scale=(0.4, 0.4),
              precision="ds32")
SEAHORSE = (-0.74364388703715871, 0.13182590420531198)
DEEP = Scene(width=48, height=36, iterations=200, pos=SEAHORSE,
             scale=(1e15, 1e15))  # auto → perturbation (past the f64 wall)
NEEDLE = Scene(width=48, height=32, iterations=300, pos=(-2.0, 0.0),
               scale=(1e16, 1e16))  # the exact tier flags pixels here


def _clear_caches(*mods):
    for mod in mods:
        for name, val in vars(mod).items():
            if name.endswith("_CACHE") and isinstance(val, dict):
                val.clear()


@pytest.fixture(autouse=True)
def _fresh_caches():
    _clear_caches(jpt, tpt)
    yield


def _one(scene) -> np.ndarray:
    return render_u8(scene, "cpu").numpy()


def _tiled(scene, band_rows, ckpt_dir=None, **kw):
    return tti.render_tiled(scene, band_rows, ckpt_dir, device="cpu", **kw)


def _mismatched(a, b) -> int:
    return int((np.asarray(a) != np.asarray(b)).any(-1).sum())


def _drop_bands(ckpt_dir, bands, poison=None):
    """Remove ``bands`` from a checkpoint as an interrupted run leaves it;
    write ``poison`` into band 0's first pixel."""
    path = os.path.join(ckpt_dir, "manifest.json")
    with open(path) as f:
        m = json.load(f)
    for b in bands:
        os.remove(os.path.join(ckpt_dir, f"band_{b}.npy"))
    m["done"] = [b for b in m["done"] if b not in bands]
    with open(path, "w") as f:
        json.dump(m, f)
    if poison is not None:
        band0 = np.load(os.path.join(ckpt_dir, "band_0.npy"))
        band0[0, 0] = poison
        np.save(os.path.join(ckpt_dir, "band_0.npy"), band0)


@pytest.mark.parametrize("tier,band_rows,bound", [
    ("ds32", 40, 0),     # uneven last band
    ("f32", 40, 12),
    ("f64", 8, 43),
])
def test_banded_matches_one_shot_and_reference(tier, band_rows, bound):
    """Banded equals the port's one-shot render (f32: within the measured
    16 pixels of the module docstring) and the JAX package's banded render
    within the measured bound."""
    if tier == "f64":
        sc = Scene(width=48, height=32, iterations=3000, pos=SEAHORSE, scale=(1e9, 1e9),
                   precision="f64")
    else:
        sc = SCENE.replace(precision=tier)
    ts = interop.scene(sc)
    banded = _tiled(ts, band_rows)
    one = _one(ts)
    assert banded.shape == one.shape == (sc.height, sc.width, 3)
    assert _mismatched(banded, one) <= (16 if tier == "f32" else 0)
    assert len(np.unique(banded.reshape(-1, 3), axis=0)) > 8
    assert _mismatched(banded, jti.render_tiled(sc, band_rows=band_rows)) <= bound


def test_kernel_a_band_equals_its_rows_of_the_grid():
    """Kernel A's global-row map: a band of its plain version is the same
    rows of the whole grid's, bit for bit, in f32 and ds32 (the card's
    route for one-shot and banded alike)."""
    ts = interop.scene(SCENE)
    for precision in ("f32", "ds32"):
        kw = dict(algo=ts.algo, power=ts.power, iterations=ts.iterations,
                  precision=precision, width=ts.width, periodicity=True)
        whole = tec.iterate_params(tec.scene_params(ts, device="cpu"), height=ts.height, **kw)
        params = tec.scene_params(ts, device="cpu")
        params[15] = 37.0
        band = tec.iterate_params(params, height=21, **kw)
        for w, b in zip(whole, band):
            assert torch.equal(w[37:58], b)


def test_checkpoint_and_resume(tmp_path):
    d = str(tmp_path / "ckpt")
    ts = interop.scene(SCENE)
    lines = []
    full = _tiled(ts, 32, d, progress=lines.append)
    assert lines == [f"band {b}/3 (32 rows)" for b in (1, 2, 3)]
    with open(os.path.join(d, "manifest.json")) as f:
        assert sorted(json.load(f)["done"]) == [0, 1, 2]
    np.testing.assert_array_equal(full, _one(ts))
    # an interrupted run: band 2 missing; band 0 poisoned on disk proves the
    # finished bands are loaded, not rendered again
    _drop_bands(d, [2], poison=[1, 2, 3])
    lines.clear()
    resumed = _tiled(ts, 32, d, progress=lines.append)
    assert lines == ["band 3/3 (32 rows)"]
    assert tuple(resumed[0, 0]) == (1, 2, 3)
    np.testing.assert_array_equal(resumed[32:], full[32:])


def test_stale_checkpoints_rejected(tmp_path):
    """Another scene, and a directory the JAX package wrote for the same
    scene, raise: the port never half-uses a checkpoint it did not write."""
    ts = interop.scene(SCENE)
    d = str(tmp_path / "ckpt")
    _tiled(ts, 32, d)
    with pytest.raises(ValueError, match="different render"):
        _tiled(ts.replace(iterations=81), 32, d)
    with pytest.raises(ValueError, match="different render"):
        _tiled(ts, 16, d)
    jd = str(tmp_path / "jax")
    jti.render_tiled(SCENE, band_rows=32, ckpt_dir=jd)
    with pytest.raises(ValueError, match="different render"):
        _tiled(ts, 32, jd)
    # a band file of the wrong shape is refused, not assembled
    np.save(os.path.join(d, "band_1.npy"), np.zeros((3, 3, 3), np.uint8))
    with pytest.raises(ValueError, match="band_1.npy"):
        _tiled(ts, 32, d)


def test_supersample_band_alignment():
    """Bands of a supersampled grid keep the downsample aligned; against the
    JAX package's, measured 5 of 3,072 pixels differ (ds32 counts agree, the
    final z's last bits do not, and the 2x2 average moves the cast)."""
    sc = SCENE.replace(supersample=2, height=48)
    banded = _tiled(interop.scene(sc), 33)  # rounded down to 32 (a multiple of 2)
    np.testing.assert_array_equal(banded, _one(interop.scene(sc)))
    assert _mismatched(banded, jti.render_tiled(sc, band_rows=33)) <= 8


def test_refusals(tmp_path):
    """The fern refuses, f64 across a mesh refuses (as the reference's
    sharded bands do); a rule with no δ-recurrence refuses in both the
    checkpointed and the one-shot perturbation path."""
    with pytest.raises(ValueError, match="banded rendering applies to escape-time scenes"):
        _tiled(interop.scene(scene_defaults("fern")), 512)
    with pytest.raises(ValueError, match="sharded rendering supports f32/ds32/perturb"):
        tti.render_tiled(interop.scene(SCENE.replace(precision="f64")), 32,
                         mesh=Mesh((torch.device("cpu"),) * 2))
    bad = interop.scene(Scene(algo="julia", power=1, julia_set=(-0.8, 0.156), width=16,
                              height=12, iterations=50, scale=(0.8, 0.8), precision="p32"))
    for ckpt in (str(tmp_path / "ck"), None):
        with pytest.raises(ValueError, match="perturbation supports"):
            _tiled(bad, 8, ckpt)


def _flag_mask(scene) -> np.ndarray:
    """The exact tier's glitch flags of the view's main grid."""
    st = tpt.perturb_setup(scene, "cpu")
    return tpt._main_grid(scene, st, tpt.KERNELS, glitch=True)[3].numpy() != 0


def test_perturbation_checkpoint_matches_one_shot(tmp_path):
    """A glitch-free perturbation view banded with a checkpoint equals the
    one-shot render and the JAX package's banded render; a resume renders
    only the missing band."""
    ts = interop.scene(DEEP)
    assert not _flag_mask(ts).any()
    one = _one(ts)
    d = str(tmp_path / "ck")
    banded = _tiled(ts, 16, d)
    np.testing.assert_array_equal(banded, one)
    np.testing.assert_array_equal(banded, jti.render_tiled(DEEP, band_rows=16,
                                                           ckpt_dir=str(tmp_path / "j")))
    _drop_bands(d, [2], poison=[9, 8, 7])
    resumed = _tiled(ts, 16, d)
    assert tuple(resumed[0, 0]) == (9, 8, 7)
    np.testing.assert_array_equal(resumed[16:], one[16:])


def test_perturbation_without_checkpoint_takes_the_one_shot_path():
    ts = interop.scene(DEEP)
    lines = []
    img = _tiled(ts, 8, progress=lines.append)
    np.testing.assert_array_equal(img, _one(ts))
    assert len(lines) == 1 and "one-shot" in lines[0]


def test_p32_bands_with_supersample(tmp_path):
    sc = DEEP.replace(precision="p32", supersample=2, height=32)
    banded = _tiled(interop.scene(sc), 17, str(tmp_path / "ck"))  # → 16 (ss-aligned)
    np.testing.assert_array_equal(banded, _one(interop.scene(sc)))
    np.testing.assert_array_equal(banded, jti.render_tiled(sc, band_rows=17,
                                                           ckpt_dir=str(tmp_path / "j")))


def test_exact_bands_resolve_every_flagged_pixel(tmp_path):
    """A view whose exact tier flags pixels, banded: every band resolves
    its flagged pixels (n_residual 0) and every pixel no band flagged
    equals the one-shot image.  The bands never read or write the view's
    fix and multiref caches: a poisoned fix-cache entry does not reach them."""
    ts = interop.scene(NEEDLE)
    mask = _flag_mask(ts)
    assert mask.sum() > 0
    one = _one(ts)
    fixed = {k: v for k, v in tpt._FIX_CACHE.items()}
    multiref = dict(tpt._MULTIREF_CACHE)
    assert fixed
    for key, val in fixed.items():  # every cached resolved pixel made wrong
        if val != ():
            tpt._FIX_CACHE[key] = (val[0], val[1] + 1.0, val[2], val[3] + 7, val[4])
    poisoned = dict(tpt._FIX_CACHE)
    stats = []
    banded = _tiled(ts, 8, str(tmp_path / "ck"),
                    progress=lambda line: stats.append(dict(tpt.RENDER_STATS)))
    assert len(stats) == 4
    assert all(s["tier"] == "perturb" and s["n_residual"] == 0 for s in stats)
    assert sum(s["n_glitch"] for s in stats) == int(mask.sum())
    np.testing.assert_array_equal(banded[~mask], one[~mask])
    assert tpt._FIX_CACHE == poisoned and tpt._MULTIREF_CACHE.keys() == multiref.keys()


def test_fe_bla_bands_equal_one_shot(monkeypatch, tmp_path):
    """The fe BLA route's skip gate is a max over the reference's bands of
    PERT_BAND_ROWS rows: bands of another size run the bands they overlap
    and crop them, so banded equals one-shot (PERT_BAND_ROWS cut to 8 rows
    here, so that a small view has several)."""
    monkeypatch.setattr(tpt, "PERT_BAND_ROWS", 8)
    ts = interop.scene(Scene(width=24, height=20, iterations=512, inside=False,
                             precision="p32", scale=(1e40, 1e40),
                             pos_str=(MINIBROT_1E40_X, MINIBROT_1E40_Y)))
    one = _one(ts)
    assert tpt.RENDER_STATS["route"] == "fe BLA"
    banded = _tiled(ts, 6, str(tmp_path / "ck"))
    assert tpt.RENDER_STATS["route"] == "fe BLA"
    np.testing.assert_array_equal(banded, one)


def _bad_reference(scene):
    """The view's main grid against a reference forced to pixel (0, 0),
    whose orbit escapes early, so that many pixels are flagged."""
    w, h = scene.width, scene.height
    orbit = tpt.reference_orbit(scene, (0, 0), w, h)
    P = tpt._pert_params(scene, (0, 0), w, h)
    table, gtol = tpt._orbit_tensors(orbit, "cpu")
    return tpc.perturb_full(table, gtol, P, orbit.n_steps, iterations=scene.iterations,
                            height=h, width=w)


@pytest.mark.parametrize("depth", ["ds32 fallback", "multiref"])
def test_resolvers_in_band_coordinates(depth):
    """``_apply_fallback``, ``_multiref_resolve`` and ``_direct_resolve``
    given a band (its rows, ``row0`` and the whole grid's height) return
    for its pixels what they return for the same global pixels of the
    whole image; the defaults are the whole image."""
    scale = 1e8 if depth == "ds32 fallback" else 1e16
    sc = interop.scene(Scene(width=24, height=16, iterations=300, pos=(-2.0, 0.0),
                             scale=(scale, scale)))
    w, h, row0, rows = sc.width, sc.height, 5, 7
    zr, zi, cnt, gl = _bad_reference(sc)
    band_gl = torch.zeros_like(gl)
    band_gl[row0:row0 + rows] = gl[row0:row0 + rows]
    assert int(band_gl.sum()) > 10
    # each call from empty caches: the secondary orbits one call walks are
    # candidates of the next
    whole = tpt._apply_fallback(sc, zr, zi, cnt, band_gl, w, h, "cpu")
    _clear_caches(tpt)
    band = tpt._apply_fallback(sc, zr[row0:row0 + rows], zi[row0:row0 + rows],
                               cnt[row0:row0 + rows], band_gl[row0:row0 + rows], w, rows,
                               "cpu", row0=row0, full_height=h)
    assert whole[3] == band[3] == int(band_gl.sum())
    for a, b in zip(whole[:3], band[:3]):
        assert torch.equal(a[row0:row0 + rows], b)
    idx = torch.nonzero(band_gl.reshape(-1)).squeeze(1).numpy()
    local = idx - row0 * w
    if depth == "multiref":
        _clear_caches(tpt)
        want = tpt._multiref_resolve(sc, idx, w, h, "cpu")
        _clear_caches(tpt)
        for a, b in zip(want, tpt._multiref_resolve(sc, local, w, h, "cpu", row0=row0)):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(tpt._direct_resolve(sc, idx[:6], w, h),
                    tpt._direct_resolve(sc, local[:6], w, h, row0=row0)):
        np.testing.assert_array_equal(a, b)
