// Closed-domain floatexp ops and the orbit row of a step, shared by kernel D
// (perturb_fe.cu) and the fe BLA kernel (perturb_bla_fe.cu).
//
// A floatexp value is a pair (m, e): m * 2^e with a float mantissa and an int
// exponent, zero as (+-0, E_ZERO) (ops/floatexp.py is the plain version).
// The ops below hold on the closed domain: (+-0, E_ZERO), or |m| in [0.5, 1)
// with |e| <= 2^29.  There each equals floatexp.py's general add, mul and
// to_float bit for bit (tests/test_torch_fe_domain.py), and
// floatexp.closed_add, closed_mul and closed_to_float mirror them.
//  - fe_add shifts only the operand with the smaller exponent, by one
//    subtraction on its exponent field (a gap of 126 bits or more flushes it
//    to 0; the larger operand is nonzero then, so the sign of that zero
//    cannot reach the sum), and the sum, 0 or normal below 2 in magnitude,
//    renormalises by reading its own exponent field;
//  - fe_mul's product lies in [0.25, 1) (a shift of 0 or 1);
//  - to_float adds e to the exponent field and flushes below 2^-126 (the
//    reference's clamp to +-200 changes no result there).

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int E_ZERO = -(1 << 30);
constexpr unsigned SIGN = 0x80000000u;
constexpr unsigned MANT = 0x807fffffu;  // sign and mantissa bits
// The domain's exponent bound, and the least exponent a value may carry into
// a run of closed steps (fe_step_ready).
constexpr int E_DOMAIN = 1 << 29;
constexpr int E_READY = 1 << 23;

struct Fe {
  float m;
  int e;
};

// two's-complement int addition (the torch plain version's int32 wraps)
__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

// jnp.frexp: x = m * 2^e, |m| in [0.5, 1), for normal x; (x, 0) for +-0,
// subnormals, +-inf and NaN (the exponent field 0 or 255).
__device__ __forceinline__ Fe frexp_fe(float x) {
  const unsigned bits = __float_as_uint(x);
  const int field = static_cast<int>((bits >> 23) & 0xffu);
  if (field == 0 || field == 0xff) return {x, 0};
  return {__uint_as_float((bits & MANT) | (126u << 23)), field - 126};
}

__device__ __forceinline__ Fe fe_of(float x) {
  Fe r = frexp_fe(x);
  if (r.m == 0.0f) r.e = E_ZERO;
  return r;
}

// Whether `a` lies in the closed domain: (+-0, E_ZERO), or |m| in [0.5, 1)
// (the exponent field 126: no subnormal, inf or NaN) with |e| <= 2^29.
__device__ __forceinline__ bool fe_in_domain(Fe a) {
  const unsigned bits = __float_as_uint(a.m) & ~SIGN;
  if (bits == 0u) return a.e == E_ZERO;
  return (bits >> 23) == 126u && a.e >= -E_DOMAIN && a.e <= E_DOMAIN;
}

// Whether `a` may enter four closed steps and the gate's |dz|^2: in the
// domain with its exponent at or above -2^23 unless it is zero.  A step at
// most doubles how far below 0 an exponent lies, plus 73 bits (a sum loses at
// most 24 bits to cancellation, a product 1), so from -2^23 four steps and the
// gate's square stay above -(2^28 + 2^12): every operand they form is in the
// domain.  Above, a live pixel's dz is below 2^129 (to_float would saturate
// and the pixel escape), as fe(2Z_n) is.
__device__ __forceinline__ bool fe_step_ready(Fe a) {
  return fe_in_domain(a) && (a.m == 0.0f || a.e >= -E_READY);
}

// s * 2^e renormalised, s zero or normal with |s| < 2.
__device__ __forceinline__ Fe renorm(float s, int e) {
  const unsigned bits = __float_as_uint(s);
  const int field = static_cast<int>((bits >> 23) & 0xffu);
  const bool zero = s == 0.0f;
  return {zero ? s : __uint_as_float((bits & MANT) | (126u << 23)),
          zero ? E_ZERO : wrap_add(e, field - 126)};
}

__device__ __forceinline__ Fe fe_mul(Fe a, Fe b) {
  return renorm(a.m * b.m, wrap_add(a.e, b.e));  // |a.m * b.m| in [0.25, 1) or 0
}

__device__ __forceinline__ Fe fe_add(Fe a, Fe b) {
  const bool a_big = a.e >= b.e;
  const int e = a_big ? a.e : b.e;
  const float big = a_big ? a.m : b.m;
  const float small = a_big ? b.m : a.m;
  const int k = wrap_add(e, -(a_big ? b.e : a.e));  // the gap, >= 0
  const float shifted =
      k >= 126 ? 0.0f : __uint_as_float(__float_as_uint(small) - (static_cast<unsigned>(k) << 23));
  return renorm(big + shifted, e);
}

__device__ __forceinline__ float to_float(Fe a) {
  const unsigned bits = __float_as_uint(a.m);
  if (a.e <= -126) return __uint_as_float(bits & SIGN);
  if (a.e >= 129) return __uint_as_float((bits & SIGN) | 0x7f800000u);
  return __uint_as_float(bits + (static_cast<unsigned>(a.e) << 23));
}

__device__ __forceinline__ Fe fe_neg(Fe a) { return {-a.m, a.e}; }

// One orbit row: what step n reads (perturb_cuda.ring_rows is its plain twin
// for kernel D).
struct alignas(16) Row {
  float mr, mi;    // fe(2Z_n) mantissas
  float zr1, zi1;  // Z_{n+1}
  int er, ei;      // fe(2Z_n) exponents
  float gtol;      // tau^2 |Z_{n+1}|^2 (glitch form)
  float pad;
};

// One closed step from row r (perturb.py:871-878): dz becomes
// (fe(2Z_n) + dz) * dz + dc_g and z = Z_{n+1} + to_float(dz').
__device__ __forceinline__ void closed_step(const Row& r, const Fe& dcr_g, const Fe& dci_g,
                                            Fe& dzr, Fe& dzi, float& zr, float& zi) {
  const Fe tr = fe_add({r.mr, r.er}, dzr);
  const Fe ti = fe_add({r.mi, r.ei}, dzi);
  const Fe pr = fe_add(fe_mul(tr, dzr), fe_neg(fe_mul(ti, dzi)));
  const Fe pi = fe_add(fe_mul(tr, dzi), fe_mul(ti, dzr));
  dzr = fe_add(pr, dcr_g);
  dzi = fe_add(pi, dci_g);
  zr = r.zr1 + to_float(dzr);
  zi = r.zi1 + to_float(dzi);
}

}  // namespace
