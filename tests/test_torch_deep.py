"""The port's exact deep-zoom tier against the JAX package.

Host side (native walker, mpmath reference orbits, the glitch column): bit
for bit.  Device side: kernel B's full and glitch forms and the dist-only
forms of every δ-recurrence against ``perturb_pallas_v2(interpret=True)``,
kernel C against ``perturb_pallas_v2_points(interpret=True)``, kernel A's
points form against its grid form; then the whole route against the JAX
package's ``iterate_perturb(use_pallas=False)`` and 45-digit mpmath.

Tolerances: XLA:CPU contracts a*b + c into FMAs inside the jitted
reference and the port never fuses (ROADMAP "Faults").  On the 1e16×
needle views every count is low and well-conditioned, and the port equals
the reference on every pixel.  On the other views a few chaotic boundary
pixels flip; the measured count per scene and the bound stand in ``VIEWS``.
The burning-ship δ-recurrence pins its products through a traced 1.0, so
its kernel has no contraction site and matches everywhere.
"""

import os
import subprocess
import sys
import textwrap
import time
from fractions import Fraction

import jax.numpy as jnp
import mpmath as mp
import numpy as np
import pytest
import torch

from fractal_tpu.config import Scene
from fractal_tpu.ops import native_walk as jnw
from fractal_tpu.ops import perturb as jpt
from fractal_tpu_torch import interop, render_u8
from fractal_tpu_torch.ops import escape_cuda as tec
from fractal_tpu_torch.ops import native_walk as tnw
from fractal_tpu_torch.ops import perturb as tpt
from fractal_tpu_torch.ops import perturb_cuda as tpc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEEDLE = dict(pos=(-2.0, 0.0), scale=(1e16, 1e16))
CJ3 = (0.44304637997136526, 0.558308536476846)

# name: (scene, bound on count mismatches of 384 pixels).  Measured
# against the interpreted kernel B (full and glitch forms): mandelbrot and
# tricorn needles 0 (z_final differs in its last bits by contraction, and
# the difference grows along the orbit); burning ship 0 and every output
# bit-equal (its products are pinned); julia z² 1; julia z³ 0 (glitch) and
# 7 (full); multibrot z³ 18 (every count there is ≥ 1,200, chaotic).
# Views from tests/test_perturb.py:95-118, 653-925 and tests/test_torch_perturb.py.
VIEWS = {
    "mandelbrot": (Scene(width=24, height=16, iterations=300, precision="perturb",
                         **NEEDLE), 0),
    "burningship": (Scene(algo="burningship", width=24, height=16, iterations=1500,
                          pos_str=("-0.45", "-0.829977217668251374661143257379"),
                          scale=(1e14, 1e14), precision="perturb"), 0),
    "tricorn": (Scene(algo="tricorn", width=24, height=16, iterations=300,
                      precision="perturb", **NEEDLE), 0),
    "multibrot3": (Scene(algo="multibrot", power=3, width=24, height=16, iterations=1500,
                         pos_str=("0.443046379971365280901244412109",
                                  "0.558308536476846021719895522933"),
                         scale=(1e14, 1e14), precision="perturb"), 24),
    "julia3": (Scene(algo="julia", power=3, width=24, height=16, iterations=2500,
                     julia_set=CJ3, pos_str=("164820600322731/562949953421312",
                                             "445587455483899/1688849860263936"),
                     scale=(1e15, 1e15), precision="perturb"), 10),
    "julia2": (Scene(algo="julia", width=24, height=16, iterations=600,
                     julia_set=(-0.4, 0.6), pos=(0.10416666666666666, -0.9374999999999999),
                     scale=(1e5, 1e5), precision="perturb"), 2),
}


@pytest.fixture(autouse=True)
def _fresh_caches():
    """Both packages memoize orbits, references and resolved frames; start
    every test from empty caches so both see the same history."""
    for mod in (jpt, tpt):
        for name, val in vars(mod).items():
            if name.endswith("_CACHE") and isinstance(val, dict):
                val.clear()
    yield


def _bits(a):
    return np.asarray(a).view(np.int32)


# --- host side ------------------------------------------------------------


def _mp_start(sc, px):
    """(prec, z0, c) of pixel ``px`` as reference_orbit builds them."""
    (Ar, Cr), (Ai, Ci) = jpt._affine_fractions(sc.width, sc.height, jpt.exact_pos(sc),
                                               sc.scale)
    digits = tpt._digits(sc)
    with mp.workdps(digits):
        z = mp.mpc(tpt._mpf_of(Ar * px[0] + Cr), tpt._mpf_of(Ai * px[1] + Ci))
        return mp.mp.prec, z


def _reference_walker_loaded() -> bool:
    """The JAX package builds its walker with make on first use, in place;
    another test process may be writing that file at the moment, so the
    load is retried."""
    for _ in range(10):
        if jnw.available():
            return True
        jnw._TRIED = False
        time.sleep(0.5)
    return False


@pytest.mark.parametrize("zoom", [1e15, 1e16])
def test_native_walk_matches_reference_and_mpmath(zoom):
    """walk(): rows and break index bit-equal to the JAX package's binding
    and to the mpmath loop; direct(): (zr, zi, n) likewise."""
    assert tnw.available() and _reference_walker_loaded()
    sc = Scene(width=24, height=16, iterations=300, pos=(-2.0, 0.0), scale=(zoom, zoom))
    limit_sq = float(sc.limit) ** 2
    step = tpt._host_step("mandelbrot", 2)
    for px in ((0, 0), (5, 3), (12, 8), (23, 15)):
        prec, z0 = _mp_start(sc, px)
        with mp.workprec(prec):
            got = tnw.walk("mandelbrot", 2, prec, z0, z0, 300, limit_sq)
            want = jnw.walk("mandelbrot", 2, prec, z0, z0, 300, limit_sq)
            assert got is not None and want is not None
            n = got[1]
            assert n == want[1]
            np.testing.assert_array_equal(got[0][: n + 1], want[0][: n + 1])
            z, rows = z0, [(float(z0.real), float(z0.imag))]
            for _ in range(n):
                z = step(z, z0)
                rows.append((float(z.real), float(z.imag)))
            np.testing.assert_array_equal(got[0][: n + 1], np.array(rows))
            d = tnw.direct("mandelbrot", 2, prec, z0, z0, 300, limit_sq)
            assert d == jnw.direct("mandelbrot", 2, prec, z0, z0, 300, limit_sq)
            m, z = 0, z0
            while m < 300:
                z2 = step(z, z0)
                z = z2
                if z2.real * z2.real + z2.imag * z2.imag > limit_sq:
                    break
                m += 1
            assert d == (float(z.real), float(z.imag), m)


def test_native_walker_builds_into_build_dir():
    path = tnw.library_path()
    assert tnw.available() and os.path.exists(path)
    assert os.path.relpath(path, ROOT).startswith(os.path.join("build", "fractal_tpu_torch"))
    assert tnw.walk("fern", 2, 64, mp.mpc(0), mp.mpc(0), 4, 4.0) is None  # declined


@pytest.mark.parametrize("name", ["mandelbrot", "burningship", "multibrot3"])
def test_deep_orbit_bit_equal(name):
    """reference_orbit below spacing 1e-13 (mpmath precision, native walk)
    at the view center and at a corner pixel: packed rows, n_steps and
    ref_px bit-equal to the JAX package's; the glitch column is
    orbit_planes' plane 2.  (The reference pixel itself is compared where
    the center orbit survives: a probe runs on the contraction-affected
    XLA:CPU ds32 program otherwise.)"""
    sc = VIEWS[name][0]
    w, h = sc.width, sc.height
    assert sc.pixel_spacing <= tpt.F64_ORBIT_SPACING_LIMIT
    before = dict(tpt.MPMATH_WALKS)
    for px in ((w // 2, h // 2), (1, 2)):
        orbit = jpt.reference_orbit(sc, px, w, h)
        torbit = tpt.reference_orbit(interop.scene(sc), px, w, h)
        assert torbit.ref_px == orbit.ref_px and torbit.n_steps == orbit.n_steps
        np.testing.assert_array_equal(_bits(torbit.packed), _bits(orbit.packed))
        planes = jpt.orbit_planes(orbit)
        np.testing.assert_array_equal(_bits(tpt.glitch_column(torbit)),
                                      _bits(np.asarray(planes[2])[:, 0]))
        np.testing.assert_array_equal(_bits(interop.glitch_column(planes).numpy()),
                                      _bits(tpt.glitch_column(torbit)))
    if jpt.reference_orbit(sc, (w // 2, h // 2), w, h).n_steps >= sc.iterations:
        assert tpt.resolve_reference(interop.scene(sc), w, h, "cpu")[0] == \
            jpt.resolve_reference(sc, w, h)[0]
    assert tpt.MPMATH_WALKS == before  # the walker took every walk


# --- kernel B and C twins ---------------------------------------------------


def _jax_inputs(sc):
    w, h = sc.width, sc.height
    ref, orbit = jpt.resolve_reference(sc, w, h)
    P = jpt._pert_params(sc, ref, w, h, orbit=orbit)
    planes = jpt.orbit_planes(orbit)
    return orbit, P, planes, (interop.orbit_table(planes), interop.glitch_column(planes),
                              interop.params16(P))


@pytest.mark.parametrize("glitch", [True, False], ids=["glitch", "full"])
@pytest.mark.parametrize("name", sorted(VIEWS))
def test_kernel_b_full_twin_matches_interpreted_kernel(name, glitch):
    sc, bound = VIEWS[name]
    w, h = sc.width, sc.height
    orbit, P, planes, (table, gtol, tP) = _jax_inputs(sc)
    pw = jpt.eff_power(sc.algo, sc.power)
    want = [np.asarray(a) for a in jpt.perturb_pallas_v2(
        planes, P, jnp.int32(orbit.n_steps), iterations=sc.iterations, height=h, width=w,
        julia=sc.algo == "julia", glitch=glitch, interpret=True, chunk=16, power=pw, algo=sc.algo)]
    got = [a.numpy() for a in tpc.perturb_full(
        table, gtol if glitch else None, tP, orbit.n_steps, iterations=sc.iterations,
        height=h, width=w, algo=sc.algo, power=sc.power, glitch=glitch)]
    cnt_same = got[2] == want[2]
    assert int((~cnt_same).sum()) <= bound
    assert len(np.unique(want[2])) > 5  # the view has structure
    # where the counts agree, both flag the same pixels and froze on the
    # same side of the escape limit
    np.testing.assert_array_equal(got[3][cnt_same], want[3][cnt_same])
    lim = float(sc.limit) ** 2
    esc = [(z[0].astype(np.float64) ** 2 + z[1].astype(np.float64) ** 2 > lim)[cnt_same]
           for z in (got, want)]
    np.testing.assert_array_equal(*esc)
    if sc.algo == "burningship":  # pinned products: no contraction site
        for a, b in zip(got, want):
            np.testing.assert_array_equal(_bits(a), _bits(b))


@pytest.mark.parametrize("name", ["burningship", "tricorn", "multibrot3", "julia3"])
def test_dist_only_twin_new_recurrences(name):
    sc, bound = VIEWS[name]
    w, h = sc.width, sc.height
    orbit, P, planes, (table, _, tP) = _jax_inputs(sc)
    d, cnt = jpt.perturb_pallas_v2(
        planes, P, jnp.int32(orbit.n_steps), iterations=sc.iterations, height=h, width=w,
        julia=sc.algo == "julia", glitch=False, interpret=True, dist_only=True, chunk=16,
        power=jpt.eff_power(sc.algo, sc.power), algo=sc.algo)
    td, tcnt = tpc.perturb_dist(table, tP, orbit.n_steps, height=h, width=w,
                                algo=sc.algo, power=sc.power)
    same = tcnt.numpy() == np.asarray(cnt)
    assert int((~same).sum()) <= bound
    # |z|² itself is a contraction site (XLA fuses one of its products)
    lim = float(sc.limit) ** 2
    np.testing.assert_array_equal((td.numpy() > lim)[same], (np.asarray(d) > lim)[same])
    # the dist-only form is the full form without the z outputs
    full = tpc.perturb_full(table, None, tP, orbit.n_steps, iterations=sc.iterations,
                            height=h, width=w, algo=sc.algo, power=sc.power, glitch=False)
    np.testing.assert_array_equal(tcnt.numpy(), full[2].numpy())


def _bad_reference_frame(sc):
    """A corner reference that escapes early: most pixels flag."""
    w, h = sc.width, sc.height
    orbit = jpt.reference_orbit(sc, (0, 0), w, h)
    P = jpt._pert_params(sc, (0, 0), w, h)
    gl = np.asarray(jpt.perturb_pallas_v2(
        jpt.orbit_planes(orbit), P, jnp.int32(orbit.n_steps), iterations=sc.iterations,
        height=h, width=w, julia=False, glitch=True, interpret=True, chunk=16,
        power=jpt.eff_power(sc.algo, sc.power), algo=sc.algo)[3])
    return np.flatnonzero(gl)


@pytest.mark.parametrize("name", ["mandelbrot", "burningship"])
def test_kernel_c_twin_matches_interpreted_points_kernel(name):
    """Kernel C on the flagged list of a forced-bad-reference needle frame,
    against the medoid secondary orbit: counts and flags equal to the
    interpreted points kernel, every output for the pinned burning ship."""
    sc = Scene(algo=name, width=24, height=16, iterations=300, **NEEDLE)
    w, h = sc.width, sc.height
    idx = _bad_reference_frame(sc)
    assert idx.size > 50
    xs, ys = (idx % w).astype(np.float32), (idx // w).astype(np.float32)
    mi = int(np.argmin((xs - xs.mean()) ** 2 + (ys - ys.mean()) ** 2))
    ref = (int(xs[mi]), int(ys[mi]))
    orbit = jpt.reference_orbit(sc, ref, w, h)
    P = jpt._pert_params(sc, ref, w, h)
    planes = jpt.orbit_planes(orbit)
    # the reference's lane layout: padded to (rows, 128) with off-image pixels
    k = 128 * -(-idx.size // 128)
    xs_p = np.full(k, float(w), np.float32)
    ys_p = np.full(k, float(h), np.float32)
    xs_p[: idx.size], ys_p[: idx.size] = xs, ys
    dcr = ((jnp.asarray(xs_p) - P[2]) * P[0]).reshape(k // 128, 128)
    dci = ((jnp.asarray(ys_p) - P[3]) * P[1]).reshape(k // 128, 128)
    want = [np.asarray(a).ravel()[: idx.size] for a in jpt.perturb_pallas_v2_points(
        planes, P, jnp.int32(orbit.n_steps), dcr, dci, iterations=sc.iterations,
        glitch=True, interpret=True, chunk=16, power=2, algo=sc.algo)]
    got = [a.numpy() for a in tpc.perturb_points(
        interop.orbit_table(planes), interop.glitch_column(planes), interop.params16(P),
        orbit.n_steps, torch.from_numpy(xs), torch.from_numpy(ys),
        iterations=sc.iterations, algo=sc.algo, power=2)]
    assert (got[3] == 0).sum() > 10  # the secondary resolves pixels
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[3], want[3])
    if name == "burningship":  # pinned products: no contraction site
        for a, b in zip(got, want):
            np.testing.assert_array_equal(_bits(a), _bits(b))
    else:  # z_final carries XLA:CPU's contraction; the escape side does not
        lim = float(sc.limit) ** 2
        esc = [z[0].astype(np.float64) ** 2 + z[1].astype(np.float64) ** 2 > lim
               for z in (got, want)]
        np.testing.assert_array_equal(*esc)


ESCAPE_POINT_CASES = {
    "mandelbrot": Scene(width=40, height=24, iterations=300,
                        pos=(-0.7436447860, 0.1318252536), scale=(5e5, 5e5)),
    "julia": Scene(algo="julia", width=40, height=24, iterations=300,
                   julia_set=(-0.8, 0.156), pos=(-1.1979166666666665, 0.15625),
                   scale=(2e4, 2e4)),
    "burningship": Scene(algo="burningship", width=40, height=24, iterations=60,
                         pos=(-1.62, -0.01), scale=(2e4, 2e4)),
    "tricorn": Scene(algo="tricorn", width=40, height=24, iterations=300,
                     pos=(0.37708333333333327, 0.46875), scale=(2e4, 2e4)),
    "multibrot3": Scene(algo="multibrot", power=3, width=40, height=24, iterations=300,
                        pos=(-0.5729166666666666, -0.3125), scale=(1e5, 1e5)),
}


@pytest.mark.parametrize("name", sorted(ESCAPE_POINT_CASES))
def test_escape_points_twin_equals_grid_twin(name):
    """Kernel A's points form at seeded pixels equals its grid form there,
    bit for bit (ds32, no periodicity, as _fallback_1d runs it)."""
    sc = ESCAPE_POINT_CASES[name]
    params = tec.scene_params(sc, device="cpu")
    kw = dict(algo=sc.algo, power=sc.power, iterations=sc.iterations, precision="ds32")
    grid = tec.iterate_params(params, height=sc.height, width=sc.width, **kw)
    rng = np.random.default_rng(7)
    idx = rng.choice(sc.width * sc.height, size=200, replace=False)
    xs = torch.from_numpy((idx % sc.width).astype(np.float32))
    ys = torch.from_numpy((idx // sc.width).astype(np.float32))
    pts = tec.iterate_points(params, xs, ys, **kw)
    for p, g in zip(pts, grid):
        np.testing.assert_array_equal(_bits(p.numpy()), _bits(g.reshape(-1)[idx].numpy()))
    assert len(np.unique(pts[2].numpy())) > 5


# --- the whole route ----------------------------------------------------------


def _mpmath_count(c0r, c0i, iterations, limit):
    with mp.workdps(45):
        cr, ci = tpt._mpf_of(c0r), tpt._mpf_of(c0i)
        zr, zi = cr, ci
        lim_sq = mp.mpf(limit) ** 2
        for i in range(iterations):
            zr, zi = zr * zr - zi * zi + cr, 2 * zr * zi + ci
            if zr * zr + zi * zi > lim_sq:
                return i
        return iterations


def test_whole_route_bad_reference_vs_reference_and_mpmath(monkeypatch):
    """iterate_perturb with a forced bad reference at the 1e16× needle
    (mirrors tests/test_perturb.py:192-274): every escaping pixel's count
    equals the JAX route's, nothing is left unresolved, and sampled counts
    equal 45-digit mpmath."""
    sc = Scene(width=24, height=16, iterations=300, **NEEDLE)
    w, h = sc.width, sc.height
    monkeypatch.setattr(jpt, "choose_reference", lambda s, ww, hh: (0, 0))
    monkeypatch.setattr(tpt, "choose_reference", lambda s, ww, hh, device="cpu": (0, 0))
    _, _, want, jn = jpt.iterate_perturb(sc, h, w, use_pallas=False)
    _, _, got, n = tpt.iterate_perturb(interop.scene(sc), h, w, "cpu")
    want, got = np.asarray(want), got.numpy()
    assert n == jn and n > 50  # most of the frame outlived the bad orbit
    assert tpt.RENDER_STATS["n_residual"] == 0
    esc = want < 300
    np.testing.assert_array_equal(got[esc], want[esc])
    (Ar, Cr), (Ai, Ci) = jpt._affine_fractions(w, h, sc.pos, sc.scale)
    rng = np.random.default_rng(0)
    checked = 0
    for x, y in zip(rng.integers(0, w, 8), rng.integers(0, h, 8)):
        truth = _mpmath_count(Ar * int(x) + Cr, Ai * int(y) + Ci, 300, sc.limit)
        if truth < 250:
            assert got[y, x] == truth, (x, y)
            checked += 1
    assert checked >= 4


def test_warm_multiref_device_pass_equals_host_resolve():
    """The warm frame's device pass over the references the cold host
    resolve discovered gives the host resolve's image (mirrors
    tests/test_perturb.py:293-329)."""
    sc = interop.scene(Scene(width=24, height=16, iterations=300, inside=False, **NEEDLE))
    w, h = sc.width, sc.height
    orbit = tpt.reference_orbit(sc, (0, 0), w, h)
    P = tpt._pert_params(sc, (0, 0), w, h)
    table, gtol = tpt._orbit_tensors(orbit, "cpu")
    zr, zi, cnt, gl = tpc.perturb_full(table, gtol, P, orbit.n_steps, iterations=300,
                                       height=h, width=w)
    idx = torch.nonzero(gl.reshape(-1)).squeeze(1)
    assert idx.numel() > 50
    refs = []
    hzr, hzi, hcnt, nres = tpt._multiref_resolve(sc, idx.numpy(), w, h, "cpu",
                                                 refs_out=refs)
    assert refs and nres == 0
    host = tpt._color(sc, *tpt._scatter_fixed(zr, zi, cnt, idx, *map(torch.from_numpy,
                                                                    (hzr, hzi, hcnt))))
    pack = tpt._refs_device_pack(sc, refs, w, h, "cpu")
    dev, *_, n_res = tpt._multiref_fallback_color(
        sc, zr, zi, cnt, gl, pack, width=w, kernels=tpt.KERNELS)
    assert torch.equal(dev, host)
    assert int(n_res) <= 2  # at most the measure-zero needle pixels


def test_fix_cache_warm_frames_equal_cold(monkeypatch):
    """Warm frames of a glitchy deep view take the dense fix cache and
    equal the cold frame (mirrors tests/test_perturb.py:542)."""
    sc = interop.scene(Scene(width=24, height=16, iterations=300, inside=False, **NEEDLE))
    monkeypatch.setattr(tpt, "choose_reference", lambda s, ww, hh, device="cpu": (0, 0))
    monkeypatch.setattr(tpt, "reuse_reference", lambda s, ww, hh: None)
    cold = render_u8(sc, "cpu")
    assert tpt.RENDER_STATS["n_glitch"] > 50 and tpt.RENDER_STATS["n_residual"] == 0
    fkey = tpt._orbit_key(sc, ("fix", 0, 0), sc.width, sc.height)
    assert fkey in tpt._FIX_CACHE and tpt._FIX_CACHE[fkey] != ()
    for _ in range(2):
        assert torch.equal(render_u8(sc, "cpu"), cold)
        assert tpt.RENDER_STATS["n_glitch"] > 50


def test_ds32_fallback_equals_ds32_grid():
    """Above spacing 1e-13 flagged pixels are re-rendered by kernel A's ds32
    points form: they equal the port's ds32 grid counts (mirrors
    tests/test_perturb.py:142-167 and 428-453, at a budget where the view
    has structure, with a seeded flag mask: the fallback re-renders whatever
    is flagged)."""
    sc = interop.scene(Scene(width=64, height=48, iterations=2000,
                             pos=(-0.7436447860, 0.1318252536), scale=(1e8, 1e8)))
    w, h = sc.width, sc.height
    ref = tpt.choose_reference(sc, w, h, "cpu")
    orbit = tpt.reference_orbit(sc, ref, w, h)
    P = tpt._pert_params(sc, ref, w, h, orbit=orbit)
    table, gtol = tpt._orbit_tensors(orbit, "cpu")
    zr, zi, cnt, _ = tpc.perturb_full(table, gtol, P, orbit.n_steps, iterations=2000,
                                      height=h, width=w)
    flagged = np.random.default_rng(3).random((h, w)) < 0.15
    _, _, fcnt, n = tpt._apply_fallback(sc, zr, zi, cnt,
                                        torch.from_numpy(flagged.astype(np.int32)),
                                        w, h, "cpu")
    assert n == flagged.sum() > 300
    c_ds = tec.iterate_params(tec.scene_params(sc, device="cpu"), algo="mandelbrot", power=2,
                              iterations=2000, precision="ds32", height=h, width=w)[2]
    np.testing.assert_array_equal(fcnt.numpy()[flagged], c_ds.numpy()[flagged])
    np.testing.assert_array_equal(fcnt.numpy()[~flagged], cnt.numpy()[~flagged])
    assert len(np.unique(c_ds.numpy()[flagged])) > 10


def test_deep_render_imports_no_jax():
    code = textwrap.dedent("""
        import sys
        import fractal_tpu_torch
        from fractal_tpu_torch import Scene, render_u8
        from fractal_tpu_torch.ops import perturb
        sc = Scene(width=24, height=16, iterations=300, pos=(-2.0, 0.0), scale=(1e16, 1e16))
        img = render_u8(sc, "cpu")
        assert tuple(img.shape) == (16, 24, 3) and perturb.RENDER_STATS["tier"] == "perturb"
        assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
        assert not any(m == "fractal_tpu" or m.startswith("fractal_tpu.")
                       for m in sys.modules)
        print("ok")
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_pan_takes_the_candidate_orbit_pass():
    """A 7-pixel pan of a rendered deep view reuses its orbits: no host
    walk, the candidate-orbit pass on kernel C resolves every flagged pixel,
    and the panned frame's counts equal those of a cold render of the same
    view on every pixel.  (The images differ on a few pixels: the cold
    render walks its own references, so z_final, and with it the smooth
    coloring, rounds differently.)"""
    sc = interop.scene(Scene(width=24, height=16, iterations=300, inside=False, **NEEDLE))
    render_u8(sc, "cpu")
    spacing = Fraction(1) / (Fraction(sc.height) * Fraction(sc.scale[1]))
    pan = sc.replace(pos_str=(str(Fraction(-2) + 7 * spacing), "0"))
    walks = dict(tnw.WALKS)
    img = render_u8(pan, "cpu")
    assert tnw.WALKS == walks  # no high-precision walk
    assert tpt.RENDER_STATS["n_residual"] == 0
    assert tpt.RENDER_STATS["multiref_rounds"] == 0
    assert tpt.RENDER_STATS["n_glitch"] > 0
    assert img.shape == (16, 24, 3)
    warm_cnt = list(tpt._FIX_CACHE.values())[-1][3]  # the newest frame's fix
    for name, val in vars(tpt).items():
        if name.endswith("_CACHE") and isinstance(val, dict):
            val.clear()
    render_u8(pan, "cpu")
    assert tpt.RENDER_STATS["multiref_rounds"] > 0  # cold: walked its own medoid
    cold_cnt = list(tpt._FIX_CACHE.values())[-1][3]
    torch.testing.assert_close(warm_cnt, cold_cnt, rtol=0, atol=0)


def test_probe_reference_choice_differs_only_by_contraction():
    """A fault of the reference on this path (ROADMAP "Faults"): where the
    view center escapes early, choose_reference takes the medoid of a ds32
    probe's max-count pixels, and XLA:CPU's contraction moves the jitted
    probe's counts.  At this burning-ship view the JAX package picks another
    reference pixel than the port; run unjitted (no fusion) it picks the
    port's."""
    import jax

    sc = VIEWS["burningship"][0]
    w, h = sc.width, sc.height
    port = tpt.choose_reference(interop.scene(sc), w, h, "cpu")
    assert jpt.choose_reference(sc, w, h) != port
    jpt._REF_CACHE.clear()
    with jax.disable_jit():
        assert jpt.choose_reference(sc, w, h) == port
