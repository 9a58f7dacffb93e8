"""The fe BLA route's kernel wrapper, its plain version and the gate's 64-bit
key against the JAX package's BLA twin, on the CPU.

``perturb_cuda.perturb_bla_fe`` runs its plain version for CPU tensors
(``csrc/perturb_bla_fe.cu`` runs only on the card, where ``chip_smoke.py``
holds it bit-equal to the plain version in both forms).  The kernel reduces
each gate group's max |δz|² as one 64-bit key a pixel,
((e + 2³¹) << 32) | bits(m) for m > 0, (E_ZERO, 0) for the rest; the first
tests hold a torch mirror of that packing against the plain version's two
passes, max e then max m at that e.

The views are narrow strips 300 rows high, of the 1e40× minibrot (every
pixel interior) and of its edge at 1e31× (every pixel escapes after the
skips): two gate groups of 256 rows, the second padded to row 512 as the
reference pads its last band.  The JAX twin runs each band
(``perturb_whole_jnp`` at ``PERT_CHUNK_CPU``, jitted); every comparison is
bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fractal_tpu.config import Scene
from fractal_tpu.ops import perturb as jpt
from fractal_tpu_torch import interop
from fractal_tpu_torch.ops import floatexp as tfx
from fractal_tpu_torch.ops import perturb as tpt
from fractal_tpu_torch.ops import perturb_cuda as tpc
from tests.test_bla import MINIBROT_1E40_X, MINIBROT_1E40_Y

E_ZERO = tfx.E_ZERO


@pytest.fixture(autouse=True)
def _fresh_caches():
    for mod in (jpt, tpt):
        for name, val in vars(mod).items():
            if name.endswith("_CACHE") and isinstance(val, dict):
                val.clear()
    yield


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_bits_equal(got, want, names=("zr", "zi", "cnt", "gl")):
    for name, g, w in zip(names, got, want):
        np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=name)


# ---------------------------------------------------------------------------
# The gate's 64-bit key
# ---------------------------------------------------------------------------


def kernel_keys(e, m, has):
    """The kernel's u64 gate keys (csrc/perturb_bla_fe.cu ``gate_key`` and
    ``FILL_KEY``) as Python integers."""
    keys = []
    for ei, mi, hi in zip(e.tolist(), m.view(torch.int32).tolist(), has.tolist()):
        ei, bits = (ei, mi & 0xFFFFFFFF) if hi else (E_ZERO, 0)
        keys.append((((ei & 0xFFFFFFFF) ^ 0x80000000) << 32) | bits)
    return keys


def mirror_gate(e, m, has):
    """The kernel's reduction in torch: each key as the int64 (e << 32) |
    bits(m), whose order is the u64 key's (the u64 is it plus 2⁶³), its
    max decoded → (max e, max m at that e)."""
    s = torch.where(has, (e.to(torch.int64) << 32) | (m.view(torch.int32).to(torch.int64)
                                                      & 0xFFFFFFFF),
                    torch.tensor(E_ZERO, dtype=torch.int64) << 32)
    best = int(s.max())
    low = torch.tensor([best & 0xFFFFFFFF], dtype=torch.int64).to(torch.int32)
    return best >> 32, float(low.view(torch.float32))


def plain_gate(e, m, has):
    """The plain version's two passes (``perturb_cuda._bla_fe_group``)."""
    maxe = torch.where(has, e, E_ZERO).max()
    maxm = torch.where(has & (e == maxe), m, 0.0).max()
    return int(maxe), float(maxm)


def _gate_inputs(case, n=4096, seed=3):
    rng = np.random.default_rng(seed)
    m = rng.uniform(0.5, 1.0, n).astype(np.float32)
    if case == "negative exponents":
        e = rng.integers(-700, -300, n)
    elif case == "ties on e":
        e = rng.choice([-410, -409, -408], n)
    elif case == "E_ZERO entries":
        e = np.where(rng.random(n) < 0.5, E_ZERO, rng.integers(-900, -880, n))
    elif case == "below E_ZERO":  # wrapped exponents order below the fill
        e = rng.integers(E_ZERO - 50, E_ZERO, n)
    elif case == "subnormal mantissas":
        e = rng.choice([-3, -2], n)
        m = np.where(rng.random(n) < 0.5, np.float32(1e-40), m).astype(np.float32)
    else:
        e = rng.integers(-300, 300, n)
    live = {"empty group": np.zeros(n, bool), "every pixel has one": np.ones(n, bool),
            "below E_ZERO": np.ones(n, bool)}.get(case, rng.random(n) < 0.7)
    return (torch.from_numpy(e.astype(np.int32)), torch.from_numpy(m),
            torch.from_numpy(live) & (torch.from_numpy(m) > 0.0))


@pytest.mark.parametrize("case", ["mixed", "negative exponents", "ties on e",
                                  "E_ZERO entries", "below E_ZERO", "subnormal mantissas",
                                  "empty group", "every pixel has one"])
def test_gate_key_max_equals_two_pass_max(case):
    """The max of the kernel's keys decodes to the plain version's (max e,
    max m at that e), the empty group to (E_ZERO, 0); the u64 keys' max and
    the int64 mirror's pick the same pixel."""
    e, m, has = _gate_inputs(case)
    if case == "below E_ZERO":  # every pixel has a key: the fill never joins
        assert int(e.max()) < E_ZERO
    want = plain_gate(e, m, has)
    assert mirror_gate(e, m, has) == want
    top = max(kernel_keys(e, m, has))
    u_e = ((top >> 32) ^ 0x80000000) - (1 << 32) * (((top >> 32) ^ 0x80000000) >= 1 << 31)
    u_m = float(torch.tensor([top & 0xFFFFFFFF], dtype=torch.int64).to(torch.int32)
                .view(torch.float32))
    assert (u_e, u_m) == want
    if case == "empty group":
        assert want == (E_ZERO, 0.0)


# ---------------------------------------------------------------------------
# The route at two gate groups against the JAX twin
# ---------------------------------------------------------------------------


# a point of the minibrot's edge at the escape radius 2^16 and 4000
# iterations (bisected in 50-digit arithmetic along the real axis from its
# nucleus): at 1e31x every pixel escapes at step 3998 or 3999, after the
# route's skips
EDGE_X = ("-0.743643887037151935882508056985791959837846128072059617172007633894388229804"
          "22418")
STRIP = Scene(width=8, height=300, iterations=2000,
              pos_str=(MINIBROT_1E40_X, MINIBROT_1E40_Y), scale=(1e40, 1e40), inside=False)
EDGE = Scene(width=8, height=300, iterations=4000, pos_str=(EDGE_X, MINIBROT_1E40_Y),
             scale=(1e31, 1e31), inside=False)
VIEWS = {"interior strip": STRIP, "edge": EDGE}


def _jax_bands(sc, glitch: bool, band: int, groups: int):
    """The JAX package's BLA twin a band of ``band`` rows from row 0 (the
    reference's ``_render_perturb_jit`` bands), the p32 form on the packed
    orbit with its tolerance column zeroed, as its p32 route zeroes it."""
    w, h = sc.width, sc.height
    ref, orbit = jpt.resolve_reference(sc, w, h)
    P = jpt._pert_params_fe(sc, ref, w, h)
    bla_packed, bla_offsets = jpt._bla_dev_for(sc, orbit, ref, w, h, fe=True)
    packed = np.array(orbit.packed)
    if not glitch:
        packed[:, 4] = 0.0
    outs = [jpt.perturb_whole_jnp(jnp.asarray(packed), P.at[7].set(float(b * band)),
                                  jnp.int32(orbit.n_steps), iterations=sc.iterations,
                                  height=band, width=w, chunk=jpt.PERT_CHUNK_CPU,
                                  extreme=True, bla_packed=bla_packed, bla_offsets=bla_offsets)
            for b in range(groups)]
    return [np.concatenate([np.asarray(o[k]) for o in outs], 0) for k in range(4)]


@pytest.mark.parametrize("glitch", [True, False])
@pytest.mark.parametrize("view", list(VIEWS))
def test_wrapper_on_cpu_equals_plain_and_jax_twin(view, glitch):
    """``perturb_bla_fe`` on CPU tensors is its plain version, and both
    equal the JAX twin's bands bit for bit over all 512 rows, padding
    included; the gate groups ran their own macro loops, and at the edge
    every pixel escaped after the skips."""
    sc = VIEWS[view]
    ts = interop.scene(sc)
    st = tpt.perturb_setup(ts, "cpu")
    assert st.extreme and st.bla is not None
    band, groups = tpt.PERT_BAND_ROWS, 2
    assert (groups - 1) * band < st.height < groups * band
    pk = tpt._packed_tensor(st.orbit, "cpu")
    kw = dict(iterations=sc.iterations, height=band, width=st.width, glitch=glitch,
              groups=groups)
    work = {}
    plain = [a.numpy() for a in tpc.perturb_bla_fe_plain(pk, st.P, st.n_steps, st.bla,
                                                         stats=work, **kw)]
    got = [a.numpy() for a in tpc.perturb_bla_fe(pk, st.P, st.n_steps, st.bla, **kw)]
    assert got[0].shape == (groups * band, st.width)
    _assert_bits_equal(got, plain)
    _assert_bits_equal(got, _jax_bands(sc, glitch, band, groups))
    assert len(work["macro_steps"]) == groups and work["skips"] > 0
    assert work["pixel_steps"] > 0 and work["gates"] >= work["pixel_skips"] > 0
    if view == "edge":
        assert set(np.unique(got[2])) == {3998, 3999}


def test_render_exact_kernels_equal_plain_and_routes(monkeypatch):
    """``render_exact`` on the CUDA wrappers (their plain versions here) and
    on ``PLAIN`` give one image at the strip; ``_route`` names the kernel on
    the card, with the state form of its last launch, and the plain version
    everywhere else."""
    ts = interop.scene(STRIP)
    got = tpt.render_exact(ts, "cpu", tpt.KERNELS)
    assert tpt.RENDER_STATS["route"] == "fe BLA"
    assert tpt.RENDER_STATS["n_residual"] == 0
    want = tpt.render_exact(ts, "cpu", tpt.PLAIN)
    assert torch.equal(got, want)
    st = tpt.perturb_setup(ts, "cpu")
    for form in ("registers", "streaming"):
        monkeypatch.setattr(tpc, "BLA_FE_FORM", form)
        assert tpt._route(tpt.KERNELS, "cuda", st) == f"fe BLA kernel ({form})"
    assert tpt._route(tpt.KERNELS, "cpu", st) == "fe BLA"
    assert tpt._route(tpt.PLAIN, "cuda", st) == "fe BLA"
    assert tpt.KERNELS.bla_fe is tpc.perturb_bla_fe
    assert tpt.PLAIN.bla_fe is tpc.perturb_bla_fe_plain


def test_banded_call_crops_the_groups_it_overlaps():
    """``_render_bla`` over rows [200, 290) runs both 256-row groups in
    one call and crops them: the rows equal the whole view's."""
    ts = interop.scene(STRIP)
    st = tpt.perturb_setup(ts, "cpu")
    whole = tpt._render_bla(ts, st, tpt.KERNELS, glitch=True)
    part = tpt._render_bla(ts, st, tpt.KERNELS, glitch=True, start=200, rows=90)
    assert whole[0].shape == (300, 8) and part[0].shape == (90, 8)
    for a, b in zip(part, whole):
        assert torch.equal(a, b[200:290])
