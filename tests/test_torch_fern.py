"""The port's Barnsley fern against the JAX package, on the CPU.

Integers are held exactly: the port's threefry is bit-equal to
``jax.random`` (this JAX runs with ``jax_threefry_partitionable`` on), the
darkening curve, its lookup and the saturating sum are equal, and kernel
H's plain version equals ``hist_pallas(interpret=True)`` and ``np.bincount``.

The f32 walk carries one stated tolerance.  XLA:CPU contracts a·b + c into
FMAs inside the jitted ``_fern_hits`` and torch never fuses.  The IFS
contracts by at least 0.85 a step, so a last-bit difference does not grow,
but a point next to a bin edge can land one pixel over: with
``jax.disable_jit()`` the histograms are bit-equal; against the jitted
function the total hit count is equal and a few bins differ (measured per
scene below: at most 8 of 40,000 bins, each by one hit moved to a
neighbour).  The rendered images of every scene here are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fractal_tpu.config import scene_defaults
from fractal_tpu.models import fern as jfern
from fractal_tpu.render import render as jax_render
from fractal_tpu_torch import interop, render_u8
from fractal_tpu_torch.models import fern as tfern
from fractal_tpu_torch.ops import hist_cuda, threefry
from fractal_tpu_torch.tools import fern_hist
from tests.test_goldens import GOLDENS, _DIR

SEEDS = (0, 7, 123456789, 2**31 - 1)


def _bits(a):
    return np.asarray(a).view(np.int32)


# ---------------------------------------------------------------------------
# threefry: bit-equal to jax.random
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
def test_threefry_key_chain_bit_equal(seed):
    """PRNGKey, fold_in and 100 successive splits, for three replicas."""
    key0 = jax.random.PRNGKey(seed)
    assert threefry.prng_key(seed) == tuple(int(v) for v in np.asarray(key0))
    assert interop.prng_key(jax.random.key_data(key0)) == threefry.prng_key(seed)
    for rep in (0, 1, 5):
        key = jax.random.fold_in(key0, rep)
        assert threefry.fold_in(threefry.prng_key(seed), rep) == \
            tuple(int(v) for v in np.asarray(key))
        subs = []
        for _ in range(100):
            key, sub = jax.random.split(key)
            subs.append(np.asarray(sub))
        np.testing.assert_array_equal(threefry.key_chain(seed, rep, 100), np.stack(subs))
        pkey = threefry.fold_in(threefry.prng_key(seed), rep)
        assert threefry.split(pkey)[1] == tuple(int(v) for v in subs[0])


@pytest.mark.parametrize("k", (1, 2, 1000, 65536, 70001))
def test_threefry_uniform_bit_equal(k):
    """uniform(key, (k,), f32), odd sizes and sizes past 65,536 included;
    two keys are drawn in one batched call."""
    for seed in SEEDS[:3]:
        keys = threefry.key_chain(seed, 0, 3)[1:]
        got = threefry.uniform(keys, k, "cpu").numpy()
        assert got.shape == (2, k) and got.dtype == np.float32
        for row, key in zip(got, keys):
            want = jax.random.uniform(jnp.asarray(key), (k,), jnp.float32)
            np.testing.assert_array_equal(_bits(row), _bits(want))
        assert (got >= 0.0).all() and (got < 1.0).all()


def test_threefry_bits_bit_equal():
    key = threefry.key_chain(3, 2, 1)
    want = jax.random.bits(jnp.asarray(key[0]), (1001,), jnp.uint32)
    got = threefry.random_bits(key, 1001, "cpu").numpy().view(np.uint32)[0]
    np.testing.assert_array_equal(got, np.asarray(want))


# ---------------------------------------------------------------------------
# the darkening post-pass: equal
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bg,prim,weight", [
    ((240, 240, 240), (4, 3, 100), 0.01),
    ((200, 200, 200), (0, 128, 255), 0.5),
    ((240, 230, 220), (4, 3, 100), 0.2),
])
def test_darkening_curve_equal(bg, prim, weight):
    np.testing.assert_array_equal(tfern.darkening_curve(bg, prim, weight),
                                  jfern.darkening_curve(bg, prim, weight))


def test_constants_and_burn_in_equal():
    np.testing.assert_array_equal(tfern._FERN_COEFFS, jfern._FERN_COEFFS)
    assert tfern.DEFAULT_WALKERS == jfern.DEFAULT_WALKERS
    for pos, (w, h) in (((0.0, 0.0), (96, 96)), ((-0.6, 0.0), (2000, 2000)),
                        ((0.3, -1.5), (750, 500))):
        js = scene_defaults("fern").replace(pos=pos)
        assert tfern._burn_in(interop.scene(js), w, h) == jfern._burn_in(js, w, h)


def test_lut_index_apply_darkening_and_saturating_sum_equal():
    curve = jfern.darkening_curve((240, 240, 240), (4, 3, 100), 0.01)
    L = len(curve)
    rng = np.random.default_rng(5)
    hits = rng.integers(0, 3 * L, size=(2, 9, 11)).astype(np.int32)
    hits[0, 0, :8] = [0, 1, L - 2, L - 1, L, L + 1, L + 2, L + 7]
    t_hits = torch.from_numpy(hits)
    np.testing.assert_array_equal(tfern.lut_index(t_hits, L).numpy(),
                                  np.asarray(jfern.lut_index(jnp.asarray(hits), L)))
    t_img = tfern.apply_darkening(t_hits, curve)
    j_img = jfern.apply_darkening(jnp.asarray(hits), curve)
    assert t_img.dtype == torch.uint8
    np.testing.assert_array_equal(t_img.numpy(), np.asarray(j_img))
    imgs = rng.integers(0, 256, size=(3, 7, 5, 3)).astype(np.uint8)
    np.testing.assert_array_equal(
        tfern.saturating_sum_u8(torch.from_numpy(imgs)).numpy(),
        np.asarray(jfern.saturating_sum_u8(jnp.asarray(imgs))))


# ---------------------------------------------------------------------------
# the walk and its histogram
# ---------------------------------------------------------------------------


def _walk_args(js):
    ss = js.supersample
    w, h = js.width * ss, js.height * ss
    reps = max(1, js.fern_replicas)
    per = max(1, js.iterations // reps)
    k = min(jfern.DEFAULT_WALKERS, per)
    return w, h, k, max(1, per // k), reps


def test_fern_hits_bit_equal_without_jit():
    """Without jit XLA:CPU runs the walk op by op and cannot contract: the
    port's histogram is then bit-equal (two replicas, an offset start)."""
    js = scene_defaults("fern").replace(width=96, height=96, iterations=6000, seed=11,
                                        pos=(-0.6, 0.0), fern_replicas=2)
    w, h, k, steps, reps = _walk_args(js)
    burn = jfern._burn_in(js, w, h)
    with jax.disable_jit():
        want = np.asarray(jfern._fern_hits(js, w, h, k, steps, reps, js.seed, burn_in=burn))
    got = tfern.fern_hits(interop.scene(js), w, h, k, steps, reps, js.seed, burn_in=burn,
                          device="cpu").numpy()
    assert want.sum() > 0.9 * reps * k * steps
    np.testing.assert_array_equal(got, want)


# scene changes: (measured bins that differ from the jitted _fern_hits, the bound held)
WALKS = {
    "seeded-96": (dict(width=96, height=96, iterations=150_000, seed=7), 2, 8),
    "offset-200": (dict(width=200, height=200, iterations=1_000_000, pos=(-0.6, 0.0)), 8, 24),
    "replicas-96": (dict(width=96, height=96, iterations=100_000, fern_replicas=2), 0, 8),
}


@pytest.mark.parametrize("name", sorted(WALKS))
def test_fern_hits_against_jitted_walk(name):
    """Against the jitted walk: the same number of hits, and at most
    ``bound`` bins that differ (a contraction moves a point over a bin
    edge: one bin loses the hit, its neighbour gains it)."""
    kw, _, bound = WALKS[name]
    js = scene_defaults("fern").replace(**kw)
    w, h, k, steps, reps = _walk_args(js)
    burn = jfern._burn_in(js, w, h)
    want = np.asarray(jfern._fern_hits(js, w, h, k, steps, reps, js.seed, burn_in=burn))
    got = tfern.fern_hits(interop.scene(js), w, h, k, steps, reps, js.seed, burn_in=burn,
                          device="cpu").numpy()
    assert got.shape == want.shape == (reps, h, w) and got.dtype == np.int32
    assert got.sum() == want.sum()
    differ = got != want
    assert differ.sum() <= bound
    assert np.abs(got.astype(np.int64) - want)[differ].max(initial=0) <= 2


def test_walk_does_not_depend_on_the_step_batch(monkeypatch):
    """The batch of steps whose uniforms are drawn at once is free: the
    stream is the same at any batch size, burn-in boundary included."""
    ts = interop.scene(scene_defaults("fern").replace(width=60, height=60, pos=(-0.6, 0.0)))
    burn = tfern._burn_in(ts, 60, 60)
    streams = []
    for b in (64, 7, 1):
        monkeypatch.setattr(tfern, "STEP_BATCH", b)
        streams.append(torch.cat(list(tfern.walk_stream(ts, 60, 60, 256, 23, 3, burn,
                                                        device="cpu"))))
    assert streams[0].shape == (23, 256)
    assert torch.equal(streams[0], streams[1]) and torch.equal(streams[0], streams[2])


def test_hist_plain_matches_interpreted_pallas_kernel_and_bincount():
    """Kernel H's plain version on a real stream with the drop sentinel and
    negative indices (tools/fern_hist_pallas.py:175-197's case)."""
    from tools.fern_hist_pallas import hist_pallas

    ts = interop.scene(scene_defaults("fern").replace(width=200, height=200))
    w, h = 200, 200
    idx = fern_hist.walk_stream(ts, w, h, 1024, 12, ts.seed,
                                burn_in=tfern._burn_in(ts, w, h), device="cpu").reshape(-1)
    idx = torch.cat([idx, torch.tensor([-1, -9, w * h, w * h + 3], dtype=torch.int32)])
    n_bins = w * h
    flat = idx.numpy()
    assert (flat == n_bins).sum() >= 1 and (flat < 0).sum() == 2
    ref = np.bincount(flat[(flat >= 0) & (flat < n_bins)], minlength=n_bins).astype(np.int32)
    # the tool is written for 32-bit JAX (its --check runs without x64)
    with jax.enable_x64(False):
        want = np.asarray(hist_pallas(jnp.asarray(flat), n_bins=n_bins, chunk=512,
                                      slab_bins=1 << 14, interpret=True))
    np.testing.assert_array_equal(want, ref)
    hist = torch.zeros(n_bins, dtype=torch.int32)
    assert hist_cuda.hist_accumulate(idx, hist) is hist  # a CPU tensor: the plain version
    np.testing.assert_array_equal(hist.numpy(), ref)
    # it accumulates: a second call doubles every bin
    hist_cuda.hist_accumulate(idx.reshape(2, -1), hist)
    np.testing.assert_array_equal(hist.numpy(), 2 * ref)
    assert hist_cuda.LAUNCHES == 0
    # the yardsticks compute the same function on a stream without negatives
    clean = idx[idx >= 0].clamp(max=n_bins)
    np.testing.assert_array_equal(fern_hist.bincount_hist(clean, n_bins).numpy(), ref)
    ones = torch.ones(clean.numel(), dtype=torch.int32)
    np.testing.assert_array_equal(fern_hist.index_add_hist(clean, n_bins, ones).numpy(), ref)


def test_fern_hist_check_and_duplicate_fraction(capsys):
    assert fern_hist.main(["--check"]) == 0
    assert "plain-version parity: OK" in capsys.readouterr().out
    idx = torch.tensor([0, 0, 1, 9, 2, 2, 2, 9], dtype=torch.int32)
    # bins 9 is the sentinel: batch 1 has 3 kept points on 2 bins, batch 2 has 3 on 1
    assert fern_hist.duplicate_fraction(idx, 9, 4) == pytest.approx((1 / 3 + 2 / 3) / 2)


def test_hist_wrapper_refuses_what_the_kernel_does_not_take():
    hist = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32 CUDA tensor"):
        hist_cuda.hist_accumulate(torch.zeros(4, dtype=torch.int32, device="meta"), hist)


# ---------------------------------------------------------------------------
# render_fern through render_u8
# ---------------------------------------------------------------------------

# the situations of tests/test_fern.py
RENDERS = {
    "seeded": dict(width=96, height=96, iterations=150_000, seed=7),
    "seed-8": dict(width=96, height=96, iterations=150_000, seed=8),
    "background": dict(width=96, height=96, iterations=5_000),
    "replicas": dict(width=96, height=96, iterations=100_000, fern_replicas=2),
    "color-weight": dict(width=96, height=96, iterations=150_000, color_weight=0.2),
    "offset-start": dict(width=200, height=200, iterations=1_000_000, pos=(-0.6, 0.0)),
    "supersample": dict(width=80, height=80, iterations=400_000, supersample=2),
}


@pytest.mark.parametrize("name", sorted(RENDERS))
def test_render_fern_equals_jax_render(name):
    js = scene_defaults("fern").replace(**RENDERS[name])
    want = jax_render(js)
    got = render_u8(interop.scene(js), "cpu")
    assert got.dtype == torch.uint8 and tuple(got.shape) == (js.height, js.width, 3)
    np.testing.assert_array_equal(got.numpy(), want)
    assert tfern.RENDER_STATS["tier"] == "fern" and tfern.RENDER_STATS["route"] == "plain"
    if name == "replicas":
        assert tuple(got[0, 0].tolist()) == (255, 255, 255)
    elif name != "supersample":
        assert tuple(got[0, 0].tolist()) == (240, 240, 240)


def test_render_fern_matches_golden_and_is_deterministic():
    ts = interop.scene(GOLDENS["fern_seeded"])
    golden = np.load(f"{_DIR}/fern_seeded.npy")
    a = render_u8(ts, "cpu").numpy()
    np.testing.assert_array_equal(a, golden)
    np.testing.assert_array_equal(render_u8(ts, "cpu").numpy(), a)
    assert (render_u8(ts.replace(seed=8), "cpu").numpy() != a).any()
    # "barnsleyfern" is the fern (calc/src/lib.rs:166-179)
    np.testing.assert_array_equal(render_u8(ts.replace(algo="barnsleyfern"), "cpu").numpy(), a)


def test_render_fern_with_the_plain_histogram_is_the_same_image():
    ts = interop.scene(scene_defaults("fern").replace(width=60, height=60, iterations=90_000))
    a = tfern.render_fern(ts, "cpu")
    b = tfern.render_fern(ts, "cpu", histogram=hist_cuda.hist_accumulate_plain)
    assert torch.equal(a, b)


def test_interop_carries_the_fern_scene_and_key():
    js = scene_defaults("fern").replace(seed=42, fern_replicas=3, color_weight=0.05,
                                        pos=(-0.6, 0.25))
    ts = interop.scene(js)
    assert (ts.algo, ts.seed, ts.fern_replicas, ts.color_weight, ts.pos) == \
        ("fern", 42, 3, 0.05, (-0.6, 0.25))
    assert ts.primary_color.as_tuple() == js.primary_color.as_tuple() == (4, 3, 100)
    assert ts.secondary_color.as_tuple() == js.secondary_color.as_tuple() == (240, 240, 240)
    key = jax.random.fold_in(jax.random.PRNGKey(42), 3)
    assert interop.prng_key(jax.random.key_data(key)) == \
        threefry.fold_in(threefry.prng_key(42), 3)
    with pytest.raises(ValueError, match="uint32"):
        interop.prng_key(np.zeros(3, np.uint32))
