"""The port's floatexp tier past 1e30× end to end against the JAX package:
the exact orchestration on kernel D's plain versions, the fe BLA route
through render_u8, mpmath-exact counts, renders and the CLI.

Every comparison here is exact.  At these views the jitted JAX routes equal
the port on every pixel (measured: the 64×48 needle renders in both tiers
and the 48×32 minibrot's); XLA:CPU's contraction, which the port never
does, moves no pixel of them.
"""

import os
import subprocess
import sys

import mpmath as mp
import numpy as np
import pytest
import torch

from fractal_tpu.config import Scene
from fractal_tpu.ops import perturb as jpt
from fractal_tpu.render import render_u8 as jax_render_u8
from fractal_tpu_torch import interop, render_u8
from fractal_tpu_torch.__main__ import main
from fractal_tpu_torch.ops import perturb as tpt
from tests.test_bla import MINIBROT_1E40_X, MINIBROT_1E40_Y

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEEDLE_X = "-1.999999999999999999999999999999999999999999991"


@pytest.fixture(autouse=True)
def _fresh_caches():
    for mod in (jpt, tpt):
        for name, val in vars(mod).items():
            if name.endswith("_CACHE") and isinstance(val, dict):
                val.clear()
    yield


def _minibrot(**kw):
    return Scene(**{**dict(width=48, height=32, iterations=512,
                           pos_str=(MINIBROT_1E40_X, MINIBROT_1E40_Y), scale=(1e40, 1e40),
                           inside=False), **kw})


@pytest.mark.parametrize("zoom", [1e40, 1e100])
def test_extreme_depth_vs_mpmath(zoom):
    """tests/test_perturb.py:927-962 on the port: needle-tip views at 1e40×
    and 1e100× through ``iterate_perturb`` equal mpmath (zoom digits + 25)
    on every well-conditioned sampled pixel."""
    w, h = 16, 12
    sc = interop.scene(Scene(width=w, height=h, iterations=300, pos_str=("-2.0", "0.0"),
                             scale=(zoom, zoom)))
    assert tpt._is_extreme(sc)
    _, _, cnt, _ = tpt.iterate_perturb(sc, h, w, "cpu")
    cnt = cnt.numpy()
    assert len(np.unique(cnt)) > 3
    (Ar, Cr), (Ai, Ci) = tpt.affine_fractions(w, h, tpt.exact_pos(sc), sc.scale)
    checked = 0
    with mp.workdps(int(np.log10(zoom)) + 25):
        for x in range(0, w, 3):
            for y in (0, 5, 11):
                z = c = mp.mpc(tpt._mpf_of(Ar * x + Cr), tpt._mpf_of(Ai * y + Ci))
                truth = 300
                for i in range(300):
                    z = z * z + c
                    if z.real * z.real + z.imag * z.imag > 65536.0 ** 2:
                        truth = i
                        break
                if truth < 250:
                    assert int(cnt[y, x]) == truth, (x, y, cnt[y, x], truth)
                    checked += 1
    assert checked >= 12


def test_extreme_rejects_nonquadratic():
    base = Scene(width=8, height=8, iterations=50, pos_str=("-2.0", "0.0"),
                 scale=(1e40, 1e40), precision="perturb")
    for kw in (dict(algo="burningship"), dict(algo="tricorn"),
               dict(algo="multibrot", power=3), dict(algo="julia", power=3)):
        sc = base.replace(**kw)
        with pytest.raises(ValueError, match="1e30"):
            jax_render_u8(sc)
        with pytest.raises(ValueError, match="1e30"):
            render_u8(interop.scene(sc), "cpu")
        with pytest.raises(ValueError, match="1e30"):
            tpt.iterate_perturb(interop.scene(sc), 8, 8, "cpu")


def test_render_exact_bad_reference_resolves_every_pixel(monkeypatch):
    """render_exact at 1e44× with the reference forced to pixel (0, 0):
    kernel D's glitch form flags most of the frame, the multiref rounds on
    its points form and the direct walk resolve every pixel, the counts
    equal the JAX package's iterate_perturb under the same force, and the
    warm frame (the dense fix cache) equals the cold one."""
    sc = Scene(width=24, height=16, iterations=300, pos_str=(NEEDLE_X, "0.0"),
               scale=(1e44, 1e44), inside=False)
    w, h = sc.width, sc.height
    monkeypatch.setattr(jpt, "choose_reference", lambda s, ww, hh: (0, 0))
    monkeypatch.setattr(tpt, "choose_reference", lambda s, ww, hh, device="cuda": (0, 0))
    monkeypatch.setattr(tpt, "reuse_reference", lambda s, ww, hh: None)
    _, _, want, _ = jpt.iterate_perturb(sc, h, w, use_pallas=False)
    ts = interop.scene(sc)
    _, _, cnt, n = tpt.iterate_perturb(ts, h, w, "cpu")
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(want))
    assert n > w * h // 2 and tpt.RENDER_STATS["n_residual"] == 0
    for name, val in vars(tpt).items():
        if name.endswith("_CACHE") and isinstance(val, dict):
            val.clear()
    cold = tpt.render_exact(ts, "cpu")
    stats = dict(tpt.RENDER_STATS)
    assert stats["tier"] == "floatexp" and stats["route"] == "plain"
    assert stats["n_glitch"] == n and stats["n_residual"] == 0
    assert stats["multiref_rounds"] > 0
    fixed = list(tpt._FIX_CACHE.values())[-1]
    np.testing.assert_array_equal(fixed[3].numpy(), np.asarray(want))
    assert torch.equal(tpt.render_exact(ts, "cpu"), cold)
    assert tpt.RENDER_STATS["n_glitch"] == n
    assert torch.equal(tpt.render_exact(ts, "cpu", tpt.PLAIN), cold)


@pytest.mark.parametrize("precision", ["auto", "p32"])
def test_needle_render_equals_jax_render(precision):
    """render_u8 of the ROADMAP's extreme recipe (64×48 @1e44×, 300): the
    JAX package's image on every pixel, tier floatexp (p32 in the fast
    tier), route on kernel D's plain version."""
    sc = Scene(width=64, height=48, iterations=300, pos_str=(NEEDLE_X, "0.0"),
               scale=(1e44, 1e44), precision=precision)
    want = np.asarray(jax_render_u8(sc))
    got = render_u8(interop.scene(sc), "cpu").numpy()
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(want.reshape(-1, 3), axis=0)) > 20
    tier = "p32" if precision == "p32" else "floatexp"
    assert tpt.RENDER_STATS["tier"] == jpt.RENDER_STATS["tier"] == tier
    assert tpt.RENDER_STATS["route"] == "plain"
    assert tpt.RENDER_STATS["n_residual"] == 0


@pytest.mark.parametrize("precision", ["auto", "p32"])
def test_minibrot_render_takes_the_bla_route(precision):
    """The 1e40× minibrot through render_u8: the fe BLA route in both tiers,
    the JAX package's image."""
    sc = _minibrot(inside=True, precision=precision)
    want = np.asarray(jax_render_u8(sc))
    got = render_u8(interop.scene(sc), "cpu").numpy()
    np.testing.assert_array_equal(got, want)
    assert tpt.RENDER_STATS["route"] == "fe BLA"
    assert jpt.RENDER_STATS["route"] == "xla-twin-fe-bla"


def test_julia_render_equals_jax_render():
    """A julia view past 1e30× (c = −2 at 1e35×, the view on the Julia
    set's real segment): the JAX package's image, tier floatexp, every
    flagged pixel resolved."""
    sc = Scene(algo="julia", width=24, height=16, iterations=300, julia_set=(-2.0, 0.0),
               pos_str=("0.5", "0"), scale=(1e35, 1e35))
    want = np.asarray(jax_render_u8(sc))
    got = render_u8(interop.scene(sc), "cpu").numpy()
    np.testing.assert_array_equal(got, want)
    assert tpt.RENDER_STATS["tier"] == "floatexp" and tpt.RENDER_STATS["n_glitch"] > 0
    assert tpt.RENDER_STATS["n_residual"] == 0


def test_exact_centers_resolve():
    """Two centers ~1e-45 apart render different views at 1e44× (exact
    fraction coordinates and floatexp δc resolve sub-f64 structure)."""
    imgs = []
    for tail in ("1", "2"):
        sc = Scene(width=16, height=12, iterations=300, scale=(1e44, 1e44),
                   pos_str=("-1.99999999999999999999999999999999999999999999" + tail, "0.0"))
        imgs.append(render_u8(interop.scene(sc), "cpu"))
    assert not torch.equal(imgs[0], imgs[1])


def test_cli_extreme_recipe_prints_tier_floatexp(monkeypatch, tmp_path, capsys):
    """The ROADMAP's extreme recipe on the CPU, with --profile."""
    from PIL import Image

    monkeypatch.setenv("FRACTAL_TPU_PLATFORM", "cpu")
    rc = main(f"64 48 -x {NEEDLE_X} -y 0.0 -s 1e44 -i 300 --format png --profile "
              f"-o {tmp_path / 'xz'}".split())
    assert rc == 0
    assert np.asarray(Image.open(tmp_path / "xz.png")).shape == (48, 64, 3)
    out = capsys.readouterr().out
    assert "tier: floatexp" in out and "kernel route: plain" in out
    assert "glitch pixels:" in out and "UNRESOLVED" not in out


def test_extreme_render_imports_no_jax():
    code = ("import sys\n"
            "from fractal_tpu_torch import Scene, render_u8\n"
            "from fractal_tpu_torch.ops import perturb\n"
            f"sc = Scene(width=16, height=12, iterations=100, pos_str=({NEEDLE_X!r}, '0'),"
            " scale=(1e44, 1e44))\n"
            "img = render_u8(sc, 'cpu')\n"
            "assert perturb.RENDER_STATS['tier'] == 'floatexp'\n"
            "assert not any(m == 'jax' or m.startswith(('jax.', 'fractal_tpu.'))"
            " or m == 'fractal_tpu' for m in sys.modules)\n"
            "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
