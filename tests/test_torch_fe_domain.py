"""Kernel D's closed-domain floatexp ops, through their torch mirrors, against
the general ops and the JAX package's, and the ring rows' plain twin.

``csrc/perturb_fe.cu`` steps with an ``fe_add`` that shifts only the operand
with the smaller exponent and renormalises its sum from the sum's own
exponent field, an ``fe_mul`` that renormalises a product in [0.25, 1), and
a ``to_float`` that adds e to the exponent field.  They hold on the closed
domain of floatexp values, (±0, ``E_ZERO``) and |m| ∈ [0.5, 1) with
|e| ≤ 2^29.  ``floatexp.closed_add``, ``closed_mul`` and
``closed_to_float`` mirror them expression for expression; here each is
bit-equal to the general op and to ``fractal_tpu/ops/floatexp.py`` run
unjitted, on seeded inputs, on the edges (gaps of 125 to 127 bits and past
200, ties, zeros against zeros and live values, julia's gain-0 δc, the
sign of a flushed zero, exponents at the domain's ends) and on hypothesis
cases; and the 1e44× needle scene stepped with the mirrors gives kernel
D's plain version bit for bit, so real δ-trajectories stay in the domain.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from fractal_tpu.ops import floatexp as jfx
from fractal_tpu_torch import interop
from fractal_tpu_torch.ops import floatexp as tfx
from fractal_tpu_torch.ops import perturb_cuda as tpc
from tests.test_torch_floatexp import NEEDLE, _fresh_caches, _needle_inputs  # noqa: F401

E_MAX = 1 << 29  # the domain's exponent bound


def _domain(n, seed):
    """n seeded domain values: signed mantissas in [0.5, 1), exponents
    mostly within ±300, some anywhere in ±2^29, 5 % zeros of either sign."""
    rng = np.random.default_rng(seed)
    m = (rng.uniform(0.5, 1.0, n) * rng.choice([-1.0, 1.0], n)).astype(np.float32)
    e = rng.integers(-300, 300, n).astype(np.int32)
    wide = rng.random(n) < 0.05
    e[wide] = rng.integers(-E_MAX, E_MAX + 1, int(wide.sum()))
    zero = rng.random(n) < 0.05
    m[zero] = np.where(rng.random(int(zero.sum())) < 0.5, 0.0, -0.0)
    e[zero] = tfx.E_ZERO
    return m, e


def _pairs(n=200_000):
    """Operand pairs; half the second operands sit within 140 bits of the
    first, so every gap around the flush at 126 is met."""
    am, ae = _domain(n, 11)
    bm, be = _domain(n, 12)
    rng = np.random.default_rng(13)
    near = (rng.random(n) < 0.5) & (ae != tfx.E_ZERO) & (be != tfx.E_ZERO)
    be[near] = np.clip(ae[near] + rng.integers(-140, 141, int(near.sum())), -E_MAX, E_MAX)
    return (am, ae), (bm, be)


def _edges():
    """(a, b) pairs at the edges named in the module docstring."""
    z = tfx.E_ZERO
    rows = [
        # ties, and gaps of 1, 125, 126, 127, 200 and 201 bits, both orders
        (0.75, 3, -0.5, 3), (0.5, 0, -0.5, 0), (-0.999999940, 7, 0.999999940, 7),
        (0.75, 0, 0.5, -1), (0.5, 0, -0.999999940, -1),
        (0.5, 0, 0.75, -125), (0.5, 0, -0.75, -126), (-0.5, 3, 0.75, -124),
        (0.5, 0, 0.75, -127), (0.5, 0, -0.75, -200), (0.5, 0, 0.75, -201),
        (0.75, -125, 0.5, 0), (-0.75, -126, 0.5, 0),
        # zeros against zeros and live values (julia's gain-0 δc is (±0, E_ZERO))
        (0.0, z, 0.0, z), (-0.0, z, -0.0, z), (0.0, z, -0.0, z), (-0.0, z, 0.0, z),
        (0.75, 5, -0.0, z), (-0.0, z, 0.75, 5), (0.5, -E_MAX, 0.0, z),
        (0.0, z, -0.5, E_MAX), (-0.625, -E_MAX, -0.0, z),
        # exponents at the domain's ends, and where to_float saturates/flushes
        (0.5, E_MAX, 0.5, E_MAX), (-0.75, -E_MAX, 0.5, -E_MAX), (0.5, 128, 0.75, 129),
        (0.75, -125, -0.5, -126), (0.999999940, 128, 0.5, -126), (-0.5, 129, 0.5, 200),
        (0.5, 201, -0.5, -201),
    ]
    a = [(r[0], r[1]) for r in rows]
    b = [(r[2], r[3]) for r in rows]
    m = lambda v: np.array([x for x, _ in v], np.float32)  # noqa: E731
    e = lambda v: np.array([y for _, y in v], np.int32)  # noqa: E731
    return (m(a), e(a)), (m(b), e(b))


def _t(pair):
    return torch.from_numpy(pair[0].copy()), torch.from_numpy(pair[1].copy())


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def _equal(got, want, what):
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(np.asarray(g)), _bits(np.asarray(w)), err_msg=what)


def _check_ops(a, b, against_jax=True):
    """Each mirror bit-equal to the general op and, with ``against_jax``,
    to the JAX package's op run unjitted, on the pairs (a, b) and (b, a)."""
    ta, tb = _t(a), _t(b)
    ja = tuple(jnp.asarray(x) for x in a)
    jb = tuple(jnp.asarray(x) for x in b)
    with jax.disable_jit():
        for x, y, jx, jy in ((ta, tb, ja, jb), (tb, ta, jb, ja)):
            for name in ("add", "mul"):
                got = [t.numpy() for t in getattr(tfx, "closed_" + name)(x, y)]
                _equal(got, [t.numpy() for t in getattr(tfx, name)(x, y)], name)
                if against_jax:
                    _equal(got, getattr(jfx, name)(jx, jy), name + " vs JAX")
            got = tfx.closed_to_float(x).numpy()
            _equal(got, tfx.to_float(x).numpy(), "to_float")
            if against_jax:
                _equal(got, jfx.to_float(jx), "to_float vs JAX")


@pytest.mark.parametrize("inputs", ["seeded", "edges"])
def test_closed_ops_equal_general_ops(inputs):
    a, b = _pairs() if inputs == "seeded" else _edges()
    _check_ops(a, b)


def test_edges_reach_the_branches():
    """The edge list meets the flush, the tie, both zero signs of a sum and
    to_float's saturation and flush."""
    a, b = _edges()
    s = tfx.closed_add(_t(a), _t(b))
    assert (s[0] == 0).any() and (s[1] == tfx.E_ZERO).any()
    signs = np.signbit(s[0].numpy()[s[0].numpy() == 0])
    assert signs.any() and not signs.all()
    f = tfx.closed_to_float(_t(a)).numpy()
    assert np.isinf(f).any() and (f == 0).any() and np.signbit(f[f == 0]).any()


_mant = st.floats(0.5, 1.0, exclude_max=True, width=32)
_val = st.one_of(
    st.tuples(st.sampled_from([0.0, -0.0]), st.just(tfx.E_ZERO)),
    st.tuples(st.builds(lambda m, s: m * s, _mant, st.sampled_from([1.0, -1.0])),
              st.integers(-E_MAX, E_MAX)),
    st.tuples(st.builds(lambda m, s: m * s, _mant, st.sampled_from([1.0, -1.0])),
              st.integers(-260, 260)),
)


@settings(max_examples=300, deadline=None)
@given(st.lists(st.tuples(_val, _val), min_size=1, max_size=16))
def test_closed_ops_hypothesis(pairs):
    """Against the general ops (the JAX package's equal them on the seeded
    and edge inputs above)."""
    a = (np.array([p[0][0] for p in pairs], np.float32), np.array([p[0][1] for p in pairs],
                                                                   np.int32))
    b = (np.array([p[1][0] for p in pairs], np.float32), np.array([p[1][1] for p in pairs],
                                                                   np.int32))
    _check_ops(a, b, against_jax=False)


@pytest.mark.parametrize("ref", [None, (0, 0)], ids=["center", "bad_reference"])
def test_needle_scene_stays_in_the_domain(monkeypatch, ref):
    """Kernel D's plain version at the 1e44× needle (32×24, 300 iterations),
    its center reference and the corner reference whose orbit escapes at
    step 79, with fe_step and δc written with the mirrors: (zr, zi, cnt, gl)
    bit-equal to the general ops' run."""
    sc = NEEDLE
    _, _, _, (table, gtol, tP) = _needle_inputs(ref=ref)
    n_steps = 300 if ref is None else 79
    kw = dict(iterations=sc.iterations, height=sc.height, width=sc.width)
    want = tpc.perturb_fe_full(table, gtol, tP, n_steps, **kw)
    monkeypatch.setattr(tfx, "add", tfx.closed_add)
    monkeypatch.setattr(tfx, "mul", tfx.closed_mul)
    monkeypatch.setattr(tfx, "to_float", tfx.closed_to_float)
    got = tpc.perturb_fe_full(table, gtol, tP, n_steps, **kw)
    _equal([g.numpy() for g in got], [w.numpy() for w in want], "needle")
    assert len(np.unique(want[2].numpy())) >= 3 and int(want[3].sum()) > 0


@pytest.mark.parametrize("glitch", [True, False], ids=["glitch", "full"])
def test_ring_rows_twin(glitch):
    """The ring's rows: fe(2Z_n), 0.5·2Z_{n+1} and τ²|Z_{n+1}|², rows past
    n_steps and past the table's end clamped to its last row."""
    _, _, _, (table, gtol, _) = _needle_inputs()
    rows = table.shape[0]
    g = gtol if glitch else None
    mr, mi, zr1, zi1, er, ei, gg = tpc.ring_rows(table, g, 0, rows + 5)
    n = np.minimum(np.arange(rows + 5), rows - 1)
    n1 = np.minimum(np.arange(rows + 5) + 1, rows - 1)
    for col, (m, e) in ((0, (mr, er)), (1, (mi, ei))):
        fm, fe = tfx.fe(table[:, col])
        _equal((m.numpy(), e.numpy()), (fm.numpy()[n], fe.numpy()[n]), f"fe column {col}")
    _equal((zr1.numpy(), zi1.numpy()), (0.5 * table.numpy()[n1, 0], 0.5 * table.numpy()[n1, 1]),
           "Z_{n+1}")
    _equal(gg.numpy(), gtol.numpy()[n] if glitch else np.zeros(rows + 5, np.float32), "gtol")
    mid = tpc.ring_rows(table, g, rows - 2, 4)
    _equal([t.numpy() for t in mid], [t.numpy()[rows - 2:rows + 2] for t in
                                      (mr, mi, zr1, zi1, er, ei, gg)], "a chunk past the end")
