"""Extended-exponent ("floatexp") arithmetic on torch tensors (port of
``fractal_tpu/ops/floatexp.py``).

Past ~1e30× zoom the per-pixel δ quantities leave f32's exponent range, so
each value is carried as a normalised f32 mantissa and an int32 exponent,
value = m·2^e with |m| ∈ [0.5, 1), renormalised after every op.  Zero is
(±0.0, ``E_ZERO``), so exponent alignment never flushes a live operand
against a true zero.

The JAX package's ops round like this module's, bit for bit, because both
scale by powers of two exactly.  Two details of the reference are part of
the contract, and both are written out here:

* ``jnp.ldexp`` is ``m·2**e`` and XLA:CPU runs it flush-to-zero: a result
  below 2⁻¹²⁶ in magnitude is ±0, not a subnormal.  ``ldexp`` below scales
  the exponent field and flushes the same way (CUDA and torch would keep
  the subnormal).
* ``jnp.frexp`` returns (x, 0) for ±0, ±inf and NaN.  Subnormal inputs are
  outside the domain: the δ-orbit never forms one (the sums in ``add`` are
  normal or exactly 0, the larger operand being unshifted).

``csrc/perturb_fe.cu`` carries the same functions on the card; these are
its plain versions.
"""

from __future__ import annotations

import torch

#: Exponent of a true zero: far below any live value.
E_ZERO = -(1 << 30)

_EXP_MASK = 0xFF << 23
_CLEAR_EXP = ~_EXP_MASK  # sign and mantissa bits, as an int32


def _field(bits):
    return (bits >> 23) & 0xFF


def frexp(x):
    """(m, e) with x = m·2^e, |m| ∈ [0.5, 1) for normal x; (x, 0) for ±0,
    ±inf and NaN (``jnp.frexp``'s results)."""
    bits = x.view(torch.int32)
    field = _field(bits)
    normal = (field != 0) & (field != 0xFF)
    m = ((bits & _CLEAR_EXP) | (126 << 23)).view(torch.float32)
    return (torch.where(normal, m, x),
            torch.where(normal, field - 126, torch.zeros_like(field)))


def ldexp(m, e):
    """m·2^e, exact where the result is a normal float, ±inf above the
    range and ±0 below 2⁻¹²⁶ (flush to zero); ±0, ±inf and NaN pass
    through.  ``e`` is int32 and small (the callers clip it to ±200)."""
    bits = m.view(torch.int32)
    field = _field(bits)
    nf = field + e
    scaled = ((bits & _CLEAR_EXP) | (nf.clamp(1, 254) << 23)).view(torch.float32)
    out = torch.where(nf >= 0xFF, m * float("inf"), scaled)
    out = torch.where(nf <= 0, m * 0.0, out)
    special = (field == 0) | (field == 0xFF)
    return torch.where(special, m, out)


def fe(x):
    """Plain f32 tensor → (m, e)."""
    m, e = frexp(x)
    return m, torch.where(m == 0.0, E_ZERO, e)


def to_float(a):
    """(m, e) → f32: below 2⁻¹²⁶ flushes to ±0, above 2¹²⁸ saturates."""
    return ldexp(a[0], a[1].clamp(-200, 200))


def mul(a, b):
    m2, de = frexp(a[0] * b[0])
    return m2, torch.where(m2 == 0.0, E_ZERO, a[1] + b[1] + de)


def add(a, b):
    e = torch.maximum(a[1], b[1])
    # the smaller operand shifts down; gaps past 200 bits flush to 0
    s = (ldexp(a[0], torch.clamp(a[1] - e, min=-200))
         + ldexp(b[0], torch.clamp(b[1] - e, min=-200)))
    m2, de = frexp(s)
    return m2, torch.where(m2 == 0.0, E_ZERO, e + de)


def neg(a):
    return -a[0], a[1]


def cmul(ar, ai, br, bi):
    """Complex multiply on (m, e) component pairs."""
    return add(mul(ar, br), neg(mul(ai, bi))), add(mul(ar, bi), mul(ai, br))


# ---------------------------------------------------------------------------
# Closed-domain mirrors of kernel D's ops (csrc/perturb_fe.cu), expression for
# expression.  On the domain, (±0, E_ZERO) and |m| ∈ [0.5, 1) with
# |e| ≤ 2^29, each equals the general op above; only the tests call them.
# ---------------------------------------------------------------------------

_SIGN = -(1 << 31)  # 0x80000000 as an int32
_MANT = 0x807FFFFF - (1 << 32)  # sign and mantissa bits, as an int32


def _renorm(s, e):
    """s·2^e renormalised, s zero or normal with |s| < 2."""
    bits = s.view(torch.int32)
    field = _field(bits)
    zero = s == 0.0
    return (torch.where(zero, s, ((bits & _MANT) | (126 << 23)).view(torch.float32)),
            torch.where(zero, E_ZERO, e + (field - 126)))


def closed_mul(a, b):
    return _renorm(a[0] * b[0], a[1] + b[1])  # |a.m·b.m| ∈ [0.25, 1) or 0


def closed_add(a, b):
    a_big = a[1] >= b[1]
    e = torch.where(a_big, a[1], b[1])
    big = torch.where(a_big, a[0], b[0])
    small = torch.where(a_big, b[0], a[0])
    k = e - torch.where(a_big, b[1], a[1])  # the gap, >= 0
    shifted = torch.where(k >= 126, 0.0, (small.view(torch.int32) - (k << 23)).view(torch.float32))
    return _renorm(big + shifted, e)


def closed_to_float(a):
    bits = a[0].view(torch.int32)
    out = (bits + (a[1] << 23)).view(torch.float32)
    out = torch.where(a[1] >= 129, ((bits & _SIGN) | _EXP_MASK).view(torch.float32), out)
    return torch.where(a[1] <= -126, (bits & _SIGN).view(torch.float32), out)


#: The closed domain's exponent bound, and the least exponent a value may
#: carry into a run of closed steps (csrc/floatexp.cuh E_DOMAIN, E_READY).
E_DOMAIN = 1 << 29
E_READY = 1 << 23


def in_domain(a):
    """Whether each (m, e) lies in the closed domain: (±0, ``E_ZERO``), or
    |m| ∈ [0.5, 1) with |e| ≤ 2^29 (``fe_in_domain``)."""
    bits = a[0].view(torch.int32) & 0x7FFFFFFF
    normal = (_field(bits) == 126) & (a[1] >= -E_DOMAIN) & (a[1] <= E_DOMAIN)
    return torch.where(bits == 0, a[1] == E_ZERO, normal)


def step_ready(a):
    """Whether each (m, e) may enter the fe BLA kernel's closed steps: in the
    domain, its exponent at or above −2^23 unless it is zero
    (``fe_step_ready``)."""
    return in_domain(a) & ((a[0] == 0.0) | (a[1] >= -E_READY))
