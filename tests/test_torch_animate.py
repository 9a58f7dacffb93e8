"""The port's sweeps (``fractal_tpu_torch.animate``) against the JAX
package's (``fractal_tpu.animate``), and the port held to the reference's
own sweep tests (tests/test_animate.py).

Each frame of a port sweep runs the still's route, so frames equal the
port's stills bit for bit.  Against the JAX package the images carry the
tolerances stated for each tier in the other test_torch_* files: f32 on the
CPU and the f32 δ-orbits of the exact tier flip a few boundary counts
where XLA:CPU contracts a*b + c inside the jitted reference and torch does
not (measured below per case); ds32 and f64 at mid depth and the other
perturbation frames here agree on every pixel.
"""

import math

import numpy as np
import pytest
import torch

from fractal_tpu import animate as jan
from fractal_tpu.config import Scene
from fractal_tpu.ops import perturb as jpt
from fractal_tpu_torch import animate as tan
from fractal_tpu_torch import interop, render_u8
from fractal_tpu_torch.ops import perturb as tpt
from fractal_tpu_torch.parallel.sharding import Mesh
from fractal_tpu_torch.render import resolve_precision

SEAHORSE = (-0.74364388703715871, 0.13182590420531198)
NEEDLE_X = "-1.999999999999999999999999999999999999999999991"


@pytest.fixture(autouse=True)
def _fresh_caches():
    for mod in (jpt, tpt):
        for name, val in vars(mod).items():
            if name.endswith("_CACHE") and isinstance(val, dict):
                val.clear()
    yield


def _mismatched(a, b) -> int:
    return int((np.asarray(a) != np.asarray(b)).any(-1).sum())


def _still(scene) -> np.ndarray:
    return render_u8(scene, "cpu").numpy()


def test_julia_sweep_frames_match_stills_and_reference():
    """The BASELINE.json sweep at 64x48: every frame equals the port's
    still of its c; against the JAX sweep, measured 0, 6, 1 and 6 of 3,072
    pixels differ (f32 julia boundaries, contraction)."""
    out = tan.julia_sweep(frames=4, width=64, height=48, iterations=60, device="cpu")
    want = jan.julia_sweep(frames=4, width=64, height=48, iterations=60)
    assert out.shape == (4, 48, 64, 3) and out.dtype == np.uint8
    cs = tan.julia_c_path(np.linspace(0, 1, 4, endpoint=False))
    np.testing.assert_array_equal(cs, jan.julia_c_path(np.linspace(0, 1, 4, endpoint=False)))
    for i in range(4):
        sc = interop.scene(Scene(algo="julia", width=64, height=48, iterations=60,
                                 julia_set=(float(cs[i, 0]), float(cs[i, 1])),
                                 pos=(0.0, 0.0), scale=(0.4, 0.4)))
        np.testing.assert_array_equal(out[i], _still(sc))
        assert _mismatched(out[i], want[i]) <= 12  # 0.4 % of 3,072
    assert len({out[i].tobytes() for i in range(4)}) == 4


def test_sweep_over_zoom_path_device_resident():
    """A scale path: distinct frames, the JAX sweep's on every pixel; with
    ``device_resident`` the frames stay a tensor on the device."""
    scenes = [Scene(width=48, height=32, iterations=50, pos=(-0.6, 0.0),
                    scale=(0.4 * 1.3 ** k, 0.4 * 1.3 ** k)) for k in range(4)]
    out = tan.render_sweep([interop.scene(s) for s in scenes], device_resident=True,
                           device="cpu")
    assert isinstance(out, torch.Tensor) and tuple(out.shape) == (4, 32, 48, 3)
    assert len({out[i].numpy().tobytes() for i in range(4)}) == 4
    np.testing.assert_array_equal(out.numpy(), jan.render_sweep(scenes))


@pytest.mark.parametrize("precision", ["auto", "ds32"])
def test_sweep_mid_depth_is_not_downgraded(precision):
    """A sweep past the f32 spacing limit renders every frame at the
    deepest frame's tier (f64 for auto on the CPU, ds32 when asked), equal
    to the stills and to the JAX sweep."""
    deep = Scene(width=48, height=32, iterations=80, pos=(-0.7436447860, 0.1318252536),
                 scale=(5e5, 5e5), precision=precision)
    scenes = [deep.replace(scale=(4e5, 4e5)), deep]
    ts = [interop.scene(s) for s in scenes]
    assert resolve_precision(ts[1], "cpu") != "f32"
    out = tan.render_sweep(ts, device="cpu")
    for frame, sc in zip(out, ts):
        np.testing.assert_array_equal(frame, _still(sc))
    np.testing.assert_array_equal(out, jan.render_sweep(scenes))


def test_sweep_refusals():
    """A static mismatch and perturbation depth raise, as in the reference,
    and across a mesh too."""
    base = Scene(width=48, height=32, iterations=50)
    for mod, conv in ((jan, lambda s: s), (tan, interop.scene)):
        kw = {} if mod is jan else {"device": "cpu"}
        with pytest.raises(ValueError, match="static scene structure"):
            mod.render_sweep([conv(base), conv(base.replace(iterations=60))], **kw)
        deep = [conv(Scene(width=24, height=16, iterations=50, pos=SEAHORSE, scale=(s, s)))
                for s in (1e6, 1e15)]
        with pytest.raises(ValueError, match="render_zoom_sweep"):
            mod.render_sweep(deep, **kw)
    mesh = Mesh((torch.device("cpu"),) * 2)
    with pytest.raises(ValueError, match="static scene structure"):
        tan.render_sweep([interop.scene(base), interop.scene(base.replace(iterations=60))],
                         mesh=mesh)
    with pytest.raises(ValueError, match="escapes"):
        tan.render_zoom_sweep(interop.scene(base.replace(pos=(0.5, 0.5))), [1.0, 1e8],
                              mesh=mesh)


def test_zoom_sweep_refusals():
    """An escaping centre and a non-quadratic sweep past 1e30x raise in
    both packages."""
    escaping = Scene(width=16, height=12, iterations=100, pos=(0.5, 0.5), scale=(1e8, 1e8))
    bship = Scene(algo="burningship", width=16, height=12, iterations=100,
                  pos_str=("-2.0", "0.0"), scale=(1e40, 1e40))
    for sc, scales, message in ((escaping, np.geomspace(0.4, 1e8, 3), "escapes"),
                                (bship, np.geomspace(1.0, 1e40, 4), "1e30")):
        with pytest.raises(ValueError, match=message):
            jan.render_zoom_sweep(sc, scales)
        with pytest.raises(ValueError, match=message):
            tan.render_zoom_sweep(interop.scene(sc), scales, device="cpu")


@pytest.mark.parametrize("view", ["seahorse", "needle"])
def test_exact_zoom_frames_equal_stills(view):
    """``exact=True``: every frame equals the still of its zoom level and
    the JAX exact sweep's frame.  At the seahorse (64x48, 300) no frame
    flags a pixel and the sweep's frames are kept; at the needle tip every
    frame flags some and is replaced by its still (ds32 fallback at 1e3
    and 1e8, multiref at 1e16); there the port's stills and the JAX
    package's differ on 4 and 7 of 1,536 pixels at 1e3 and 1e8 (measured:
    the f32 δ-orbits of the glitch form, contracted in the jitted
    reference), and on none at 1e16."""
    if view == "seahorse":
        sc = Scene(width=64, height=48, iterations=300, pos=SEAHORSE, scale=(1e12, 1e12),
                   inside=False)
        scales, flagged = [1e6, 1e11, 1e12], [0, 0, 0]
    else:
        sc = Scene(width=48, height=32, iterations=300, pos=(-2.0, 0.0), scale=(1e16, 1e16))
        scales, flagged = [1e3, 1e8, 1e16], None
    ts = interop.scene(sc)
    out = tan.render_zoom_sweep(ts, scales, exact=True, device="cpu")
    stats = dict(tan.SWEEP_STATS)
    if flagged is None:
        assert all(n > 0 for n in stats["flagged"]), stats
    else:
        assert stats["flagged"] == flagged
    assert stats["n_residual"] == [0] * len(scales)
    want = jan.render_zoom_sweep(sc, scales, exact=True)
    for i, s in enumerate(scales):
        np.testing.assert_array_equal(out[i], tpt.render_perturb(
            ts.replace(scale=(s, s)), "cpu").numpy(), err_msg=f"scale {s}")
        assert _mismatched(out[i], want[i]) <= 0.01 * out[i].shape[0] * out[i].shape[1]


def test_exact_zoom_frames_equal_stills_past_1e30():
    """Past the f32-δc wall the whole sweep runs kernel D's grid form (its
    plain version here) from fe P rows; exact frames equal the stills of
    their zoom levels, one on each side of 1e30x.  (The JAX package's own
    test holds its sweep to its stills, and test_torch_extreme.py holds the
    port's needle stills to the JAX package's; the JAX sweep's fe program
    alone takes about a minute to compile on the CPU.)"""
    sc = interop.scene(Scene(width=24, height=16, iterations=300, pos_str=(NEEDLE_X, "0.0"),
                             scale=(1e44, 1e44), inside=False))
    scales = [1e38, 1e44]
    out = tan.render_zoom_sweep(sc, scales, exact=True, device="cpu")
    assert tan.SWEEP_STATS["n_residual"] == [0, 0]
    for i, s in enumerate(scales):
        np.testing.assert_array_equal(out[i], tpt.render_perturb(
            sc.replace(scale=(s, s)), "cpu").numpy(), err_msg=f"scale {s}")
    assert out[1].std() > 1.0


def test_fast_zoom_frames_ride_series_approximation(monkeypatch):
    """A fast sweep gives each frame its own series skip: with the still's
    reference pinned to the centre, the deep frame equals the p32 still
    (same orbit, same per-scale series), the deep frame's series skips a
    prefix, and both frames equal the JAX fast sweep's."""
    sc = Scene(width=32, height=24, iterations=300, pos=SEAHORSE, scale=(1e13, 1e13),
               inside=False, precision="perturb")
    ts = interop.scene(sc)
    w, h = sc.width, sc.height
    monkeypatch.setattr(tpt, "choose_reference",
                        lambda s, ww, hh, device="cpu": (ww // 2, hh // 2))
    ref, orbit = tpt.resolve_reference(ts, w, h, "cpu")
    (Ar, _), (Ai, _) = tpt.affine_fractions(w, h, ts.pos, ts.scale)
    dcm = math.hypot(max(ref[0], w - 1 - ref[0]) * abs(float(Ar)),
                     max(ref[1], h - 1 - ref[1]) * abs(float(Ai)))
    assert tpt._series_for(ts, orbit, ref, w, h, dcm)[0] > 0
    out = tan.render_zoom_sweep(ts, [1e6, 1e13], device="cpu")
    assert out.shape == (2, 24, 32, 3)
    np.testing.assert_array_equal(out[1], tpt.render_perturb(ts, "cpu", fast=True).numpy())
    np.testing.assert_array_equal(out, jan.render_zoom_sweep(sc, [1e6, 1e13]))
