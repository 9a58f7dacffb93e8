"""The port's probe kernels G, F and E (plain versions) against the JAX
package, on the CPU, at 48×36 views.

Kernel G's plain version is held against numpy float32 step by step: equal.

Kernels F and E carry kernel B's stated tolerance (tests/test_torch_perturb
.py): XLA:CPU contracts a·b + c into FMAs inside the jitted references and
the port never fuses, so a few long-running boundary pixels flip their
count (measured 4 of 1,728 at 1e6×, 9 of 1,728 behind the series skip at
1e10×; the bounds are 0.5 % and 1 %).  Inside the port the relations are
exact: F's ``base`` and ``dout`` equal kernel B's dist-only form bit for
bit, and E equals kernel B's glitch form on these views.

``nofreeze`` is the variant whose |z|² runs on after escape until the
TPU's 32×128 tile leaves its loop; where it has reached NaN by then, the
tile does not take the escape step back out of the count.  The port's
tile is one pixel, so its count is ``dout``'s, and the relation held is
cnt_jax == cnt_port + isnan(d_jax), within the same tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fractal_tpu.config import Scene
from fractal_tpu.ops import perturb as jpt
from fractal_tpu_torch import interop
from fractal_tpu_torch.ops import perturb as tpt
from fractal_tpu_torch.ops import perturb_cuda as tpc
from fractal_tpu_torch.ops import probe_cuda as tpr
from fractal_tpu_torch.tools import lean_probe as tlp
from tests.test_torch_perturb import SCENES
from tools import lean_probe as jlp


@pytest.fixture(autouse=True)
def _fresh_caches():
    for mod in (jpt, tpt):
        for name, val in vars(mod).items():
            if name.endswith("_CACHE") and isinstance(val, dict):
                val.clear()
    yield


def _inputs(sc):
    w, h = sc.width, sc.height
    ref, orbit = jpt.resolve_reference(sc, w, h)
    P = jpt._pert_params(sc, ref, w, h, orbit=orbit)
    return orbit, P, jpt.orbit_planes(orbit)


# ---------------------------------------------------------------------------
# kernel G
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ("fma", "pinned", "mul"))
def test_chain_plain_equals_numpy_f32_step_by_step(mode):
    rng = np.random.default_rng(3)
    x = rng.uniform(0.1, 1.0, (8, 16)).astype(np.float32)
    a = rng.uniform(0.9, 1.0, (8, 16)).astype(np.float32)
    b = rng.uniform(0.0, 1e-3, (8, 16)).astype(np.float32)
    x[0, :3], a[0, :3], b[0, :3] = 0.5, 0.999999, 1e-7  # the probe's own inputs
    want = x.copy()
    for _ in range(300):
        if mode == "mul":
            want = want * a
        else:
            want = (a * want).astype(np.float32) + b
    got = tpr.chain(*(torch.from_numpy(v) for v in (x, a, b)), 300, mode)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))
    assert tpr.CHAIN_LAUNCHES == 0  # CPU tensors: the plain version


def test_chain_fused_differs_at_the_probe_inputs():
    """At x = 0.5, a = 0.999999, b = 1e-7 one rounding per step ends on
    other bits than two within the probe's 20,000 steps (measured: equal at
    8,000 steps, apart at 12,000), so 'fma equal to pinned' says something."""
    x, a, b = tlp.chain_inputs("cpu", (2, 2))
    two = tpr.chain(x, a, b, tlp.CHAIN_STEPS, "fma")
    assert torch.equal(two, tpr.chain(x, a, b, tlp.CHAIN_STEPS, "pinned"))
    one = tpr.chain(x, a, b, tlp.CHAIN_STEPS, "fused")
    assert one.dtype == torch.float32 and not torch.equal(one, two)
    assert float((one - two).abs().max()) < 1e-3
    with pytest.raises(ValueError, match="unknown chain mode"):
        tpr.chain(x, a, b, 1, "fast")


# ---------------------------------------------------------------------------
# kernel F
# ---------------------------------------------------------------------------

F_SCENES = ("deep-1e6", "skip-1e10")


@pytest.mark.parametrize("variant", tpr.VARIANTS)
@pytest.mark.parametrize("name", F_SCENES)
def test_probe_plain_matches_interpreted_probe_kernel(name, variant):
    sc, bound = SCENES[name]
    w, h = sc.width, sc.height
    orbit, P, planes = _inputs(sc)
    want = jlp.probe_kernel(planes[:3], P, jnp.int32(orbit.n_steps),
                            iterations=sc.iterations, height=h, width=w, variant=variant,
                            interpret=True)
    got = tpr.probe(interop.orbit_table(planes), interop.params16(P), orbit.n_steps,
                    height=h, width=w, variant=variant)
    assert len(got) == len(want) == (4 if variant == "base" else 2)
    if variant == "base":
        (_, _, jcnt, jd), (_, _, cnt, d) = want, got
    else:
        (jd, jcnt), (d, cnt) = want, got
    jcnt, jd = np.asarray(jcnt), np.asarray(jd)
    assert len(np.unique(jcnt)) > 5
    if variant == "nofreeze":
        assert np.isnan(jd).sum() > 100  # the tile ran on past most escapes
        jcnt = jcnt - np.isnan(jd)
    assert np.mean(cnt.numpy() != jcnt) <= bound
    if variant != "nofreeze":
        same = cnt.numpy() == jcnt
        lim = float(sc.limit) ** 2
        np.testing.assert_array_equal((d.numpy() > lim)[same], (jd > lim)[same])


@pytest.mark.parametrize("name", F_SCENES)
def test_probe_variants_against_kernel_b_inside_the_port(name):
    """The entry point's gate: ``base`` and ``dout`` (and the one-pixel
    tile's ``nofreeze``) are kernel B's dist-only form bit for bit;
    ``every2`` counts one fewer where the escape falls on an odd (tested)
    step, whose live test counted 2 and whose escape gives 2 back."""
    sc, _ = SCENES[name]
    ts = interop.scene(sc)
    st = tpt.perturb_setup(ts, "cpu")
    if name == "skip-1e10":
        assert int(st.P[8]) == 768 and int(st.P[8]) % tpr.CHUNK == 0
    kw = dict(height=st.height, width=st.width)
    d_b, cnt_b = tpc.perturb_dist(st.table, st.P, st.n_steps, **kw)
    zr, zi, cnt, d = tpr.probe(st.table, st.P, st.n_steps, variant="base", **kw)
    assert torch.equal(cnt, cnt_b) and torch.equal(d.view(torch.int32), d_b.view(torch.int32))
    assert torch.equal((zr * zr + zi * zi).view(torch.int32), d.view(torch.int32))
    for variant in ("dout", "nofreeze"):
        d_v, cnt_v = tpr.probe(st.table, st.P, st.n_steps, variant=variant, **kw)
        assert torch.equal(cnt_v, cnt_b)
        assert torch.equal(d_v.view(torch.int32), d_b.view(torch.int32))
    d2, cnt2 = tpr.probe(st.table, st.P, st.n_steps, variant="every2", **kw)
    shift = (cnt2 - cnt_b).numpy()
    assert set(np.unique(shift)) == {-1, 0}
    assert tpr.PROBE_LAUNCHES == 0
    with pytest.raises(ValueError, match="unknown probe variant"):
        tpr.probe(st.table, st.P, st.n_steps, variant="lean", **kw)


# ---------------------------------------------------------------------------
# kernel E
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(SCENES))
def test_packed_plain_matches_whole_image_program(name):
    """``perturb_pallas`` has no interpret mode; ``perturb_whole_jnp`` runs
    the same ``_perturb_tile`` (power 2; julia through the gain P[5])."""
    sc, bound = SCENES[name]
    w, h = sc.width, sc.height
    orbit, P, planes = _inputs(sc)
    want = jpt.perturb_whole_jnp(jnp.asarray(orbit.packed), P, jnp.int32(orbit.n_steps),
                                 iterations=sc.iterations, height=h, width=w)
    torbit = interop.ref_orbit(orbit)
    tP = interop.params16(P)
    got = tpc.perturb_packed(torch.from_numpy(torbit.packed), tP, orbit.n_steps,
                             iterations=sc.iterations, height=h, width=w)
    jcnt = np.asarray(want[2])
    assert len(np.unique(jcnt)) > 5
    assert np.mean(got[2].numpy() != jcnt) <= bound
    assert np.mean(got[3].numpy() != np.asarray(want[3])) <= bound
    # inside the port: kernel B's glitch form on the same orbit, bit for bit
    b = tpc.perturb_full(torch.from_numpy(tpt.orbit_table(torbit)),
                         torch.from_numpy(tpt.glitch_column(torbit)), tP, orbit.n_steps,
                         iterations=sc.iterations, height=h, width=w, algo=sc.algo)
    for e_out, b_out in zip(got, b):
        assert torch.equal(e_out.view(torch.int32), b_out.view(torch.int32))
    assert tpc.PACKED_LAUNCHES == 0


def test_packed_flags_glitches_and_ran_out_as_the_tile_does():
    """A forced bad reference (pixel (0, 0) of the 1e16× needle, whose orbit
    escapes early) flags most of the frame; the flags equal the JAX tile's."""
    sc = Scene(width=48, height=36, iterations=300, pos=(-2.0, 0.0), scale=(1e16, 1e16))
    w, h = sc.width, sc.height
    orbit = jpt.reference_orbit(sc, (0, 0), w, h)
    P = jpt._pert_params(sc, (0, 0), w, h)
    assert orbit.n_steps < sc.iterations
    want = jpt.perturb_whole_jnp(jnp.asarray(orbit.packed), P, jnp.int32(orbit.n_steps),
                                 iterations=sc.iterations, height=h, width=w)
    got = tpc.perturb_packed(torch.from_numpy(np.asarray(orbit.packed)), interop.params16(P),
                             orbit.n_steps, iterations=sc.iterations, height=h, width=w)
    assert int(got[3].sum()) > 100
    assert np.mean(got[3].numpy() != np.asarray(want[3])) <= 0.01
    assert np.mean(got[2].numpy() != np.asarray(want[2])) <= 0.01


def test_packed_wrapper_refuses_what_the_kernel_does_not_take():
    packed = torch.zeros((300, 8), device="meta")
    with pytest.raises(ValueError, match="float32 CUDA tensor"):
        tpc.perturb_packed(packed, torch.zeros(16), 10, iterations=10, height=4, width=4)
