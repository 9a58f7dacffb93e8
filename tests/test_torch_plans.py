"""The bookkeeping of kernel C on the card, held on the CPU, and kernel H's
plain version on the streams the card sees.

Kernel C keeps the orbit in shared memory, whole or in a double-buffered
ring of chunks, and computes the next pass before it tests the current one
(``perturb_cuda.points_plan``, ``points_ring_plain``).  The mirror is not on
a render's path: it repeats the kernel's chunking in plain torch, and must
give exactly what the plain version gives for every plan, including plans
far smaller than the card's, so that tables straddle every boundary.  Rows a
chunk does not copy are NaN in the mirror, so a result that reads one shows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from fractal_tpu.config import Scene as JScene
from fractal_tpu.ops import perturb as jpt
from fractal_tpu_torch import interop
from fractal_tpu_torch.config import Scene
from fractal_tpu_torch.ops import hist_cuda as hc
from fractal_tpu_torch.ops import perturb as tpt
from fractal_tpu_torch.ops import perturb_cuda as tpc

NEEDLE = dict(pos=(-2.0, 0.0), scale=(1e16, 1e16))
# one view per δ-recurrence (tests/test_torch_deep.py's, shorter budgets)
RULES = {
    "mandelbrot": Scene(width=24, height=16, iterations=300, precision="perturb", **NEEDLE),
    "burningship": Scene(algo="burningship", width=24, height=16, iterations=400,
                         pos_str=("-0.45", "-0.829977217668251374661143257379"),
                         scale=(1e14, 1e14), precision="perturb"),
    "tricorn": Scene(algo="tricorn", width=24, height=16, iterations=300, precision="perturb",
                     **NEEDLE),
    "multibrot3": Scene(algo="multibrot", power=3, width=24, height=16, iterations=400,
                        pos_str=("0.443046379971365280901244412109",
                                 "0.558308536476846021719895522933"),
                        scale=(1e14, 1e14), precision="perturb"),
    "julia2": Scene(algo="julia", width=24, height=16, iterations=300, julia_set=(-0.4, 0.6),
                    pos=(0.10416666666666666, -0.9374999999999999), scale=(1e5, 1e5),
                    precision="perturb"),
}
H100 = (232448, 233472, 132, 1024)  # per block (opt-in), per SM, SMs, reserved a block
LAYOUT = (128, 8)  # kernel C's threads a block and rows ahead (csrc/perturb.cu)


def _bits(ts):
    return [t.view(torch.int32) if t.dtype == torch.float32 else t for t in ts]


def _assert_same(got, want):
    for a, b in zip(_bits(got), _bits(want)):
        assert torch.equal(a, b)


def _pixels(sc):
    k = sc.width * sc.height
    xs = torch.arange(k, dtype=torch.float32) % sc.width
    ys = torch.div(torch.arange(k), sc.width, rounding_mode="floor").float()
    return xs, ys


# ---------------------------------------------------------------------------
# kernel C
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("glitch", [True, False])
@pytest.mark.parametrize("name", sorted(RULES))
def test_points_ring_mirror_equals_plain(name, glitch):
    """Whole table and rings of 2, 4 and 6 rows a chunk, from an even and an
    odd n0, with n_steps − n0 even and odd: the mirror equals
    ``perturb_points_plain`` bit for bit."""
    sc = RULES[name]
    s = tpt.perturb_setup(sc, "cpu")
    xs, ys = _pixels(sc)
    for n0 in (0, 5, 6):
        P = s.P.clone()
        P[8] = float(n0)
        for n_steps in (s.n_steps, s.n_steps - 1):
            kw = dict(iterations=sc.iterations, algo=sc.algo, power=sc.power, glitch=glitch)
            want = tpc.perturb_points_plain(s.table, s.gtol, P, n_steps, xs, ys, **kw)
            assert (want[2] > n0 + 40).sum() > 10  # pixels cross many chunks
            for chunk, nbuf in ((n_steps, 1), (2, 2), (4, 2), (6, 2)):
                got = tpc.points_ring_plain(s.table, s.gtol, P, n_steps, xs, ys,
                                            chunk=chunk, nbuf=nbuf, ahead_rows=LAYOUT[1],
                                            **kw)
                _assert_same(got, want)


@pytest.mark.parametrize("name", ["mandelbrot", "burningship"])
def test_points_ring_mirror_matches_interpreted_points_kernel(name):
    """The mirror on a 4-row ring against the JAX package's
    ``perturb_pallas_v2_points(interpret=True)`` on the flagged list of a
    forced bad reference (tests/test_torch_deep.py's case): counts and flags
    equal, and every output for the pinned burning ship."""
    sc = JScene(algo=name, width=24, height=16, iterations=300, **NEEDLE)
    w, h = sc.width, sc.height
    orbit0 = jpt.reference_orbit(sc, (0, 0), w, h)
    gl = np.asarray(jpt.perturb_pallas_v2(
        jpt.orbit_planes(orbit0), jpt._pert_params(sc, (0, 0), w, h),
        jnp.int32(orbit0.n_steps), iterations=sc.iterations, height=h, width=w, julia=False,
        glitch=True, interpret=True, chunk=16, power=2, algo=sc.algo)[3])
    idx = np.flatnonzero(gl)
    assert idx.size > 50
    xs, ys = (idx % w).astype(np.float32), (idx // w).astype(np.float32)
    mi = int(np.argmin((xs - xs.mean()) ** 2 + (ys - ys.mean()) ** 2))
    ref = (int(xs[mi]), int(ys[mi]))
    orbit = jpt.reference_orbit(sc, ref, w, h)
    P = jpt._pert_params(sc, ref, w, h)
    planes = jpt.orbit_planes(orbit)
    k = 128 * -(-idx.size // 128)
    xs_p = np.full(k, float(w), np.float32)
    ys_p = np.full(k, float(h), np.float32)
    xs_p[: idx.size], ys_p[: idx.size] = xs, ys
    dcr = ((jnp.asarray(xs_p) - P[2]) * P[0]).reshape(k // 128, 128)
    dci = ((jnp.asarray(ys_p) - P[3]) * P[1]).reshape(k // 128, 128)
    want = [np.asarray(a).ravel()[: idx.size] for a in jpt.perturb_pallas_v2_points(
        planes, P, jnp.int32(orbit.n_steps), dcr, dci, iterations=sc.iterations,
        glitch=True, interpret=True, chunk=16, power=2, algo=sc.algo)]
    got = [a.numpy() for a in tpc.points_ring_plain(
        interop.orbit_table(planes), interop.glitch_column(planes), interop.params16(P),
        orbit.n_steps, torch.from_numpy(xs), torch.from_numpy(ys), iterations=sc.iterations,
        chunk=4, nbuf=2, ahead_rows=LAYOUT[1], algo=sc.algo, power=2)]
    assert (got[3] == 0).sum() > 10
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[3], want[3])
    if name == "burningship":  # pinned products: no contraction site
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.view(np.int32), np.asarray(b).view(np.int32))


def test_points_plan():
    """Whole where the table and the list's blocks fit (dz1e12's first list:
    17,508 px at 4,000 steps, 12 B a row), a ring of even chunks past it (the
    20,000-iteration budget, or a list whose blocks would crowd the SMs)."""
    assert tpc.points_plan(4000, 17_508, True, H100, LAYOUT) == (4000, 1)
    assert tpc.points_plan(4000, 100, True, H100, LAYOUT) == (4000, 1)
    assert tpc.points_plan(20_000, 8192, True, H100, LAYOUT) == (tpc.RING_CHUNK, 2)
    # 19,500 rows fit a block at 8 B a row (no glitch column), not at 12
    assert tpc.points_plan(19_500, 128, False, H100, LAYOUT) == (19_500, 1)
    assert tpc.points_plan(19_500, 128, True, H100, LAYOUT) == (tpc.RING_CHUNK, 2)
    # 6,000 rows (72 KB) fit 3 blocks an SM, not 4
    assert tpc.points_plan(6000, 3 * 132 * 128, True, H100, LAYOUT) == (6000, 1)
    assert tpc.points_plan(6000, 3 * 132 * 128 + 1, True, H100, LAYOUT) == (tpc.RING_CHUNK, 2)
    # 6,450 rows fit 3 blocks an SM only if the card kept nothing back a block
    assert tpc.points_plan(6450, 3 * 132 * 128, True, H100[:3] + (0,), LAYOUT) == (6450, 1)
    assert tpc.points_plan(6450, 3 * 132 * 128, True, H100, LAYOUT) == (tpc.RING_CHUNK, 2)
    assert tpc.RING_CHUNK % 2 == 0


def test_points_ring_plain_refuses_plans_the_kernel_refuses():
    s = tpt.perturb_setup(RULES["mandelbrot"], "cpu")
    xs, ys = _pixels(RULES["mandelbrot"])
    for chunk, nbuf in ((s.n_steps - 1, 1), (3, 2), (0, 2), (8, 3)):
        with pytest.raises(ValueError, match="no such plan"):
            tpc.points_ring_plain(s.table, s.gtol, s.P, s.n_steps, xs, ys, iterations=300,
                                  chunk=chunk, nbuf=nbuf, ahead_rows=LAYOUT[1])


# ---------------------------------------------------------------------------
# kernel H
# ---------------------------------------------------------------------------


@settings(max_examples=200, deadline=None)
@given(n_bins=st.integers(1, 3000), n=st.integers(1, 4000), seed=st.integers(0, 2**31 - 1))
def test_hist_plain_adds_into_held_counts_hypothesis(n_bins, n, seed):
    """Kernel H's plain version over a stream with the drop sentinel,
    indices past it and negatives (INT32_MIN too), added into a histogram
    that already holds counts, as the fern hands it one batch after another:
    the held counts plus ``np.bincount`` of the kept indices."""
    rng = np.random.default_rng(seed)
    flat = rng.integers(-40, n_bins + 40, n).astype(np.int32)
    flat[::7] = n_bins
    flat[::13] = np.iinfo(np.int32).min
    start = rng.integers(0, 5, n_bins).astype(np.int32)
    got = hc.hist_accumulate_plain(torch.from_numpy(flat), torch.from_numpy(start.copy()))
    ref = start + np.bincount(flat[(flat >= 0) & (flat < n_bins)], minlength=n_bins)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
