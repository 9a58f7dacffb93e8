// Escape-time kernel A: z <- rule(z, c) per pixel, f32 or ds32.
//
// Replaces fractal_tpu/ops/escape_pallas.py::iterate_params (body
// _build_kernel / _iterate_tile).  The TPU kernel iterates 32x128 tiles in
// lock-step with freeze masks and a chunked early exit; here one thread owns
// one pixel and leaves its loop when the pixel freezes.  The results are the
// same: a pixel's freeze, its count and its Brent snapshot schedule
// (n >= 1 and n & (n-1) == 0 on the global step n) depend only on its own
// state and n, and a pixel is active on a prefix of steps, so the thread's
// loop counter IS the global step.
//
// The grid form comes in two: the three-output form writes (zr, zi, cnt),
// 12 B a pixel; the colored form runs ops/coloring.py's epilogue on the
// pixel's final state in the thread and writes the (rows, W, 3) uint8 image,
// 3 B a pixel, so one launch renders a frame (the JAX package fuses the same
// tail into its jitted program; render.py takes this form at supersample 1).
//
// The points form replaces perturb.py::_fallback_1d, the ds32 re-render of
// the flagged pixels of a perturbation frame (_iterate_tile over a 1-D pixel
// list; XLA in the JAX package, a launch here since the card's main path runs
// no plain version): the same per-pixel loop, with the pixel coordinate read
// from two (k,) float inputs instead of the thread index.  Flagged pixels lie
// scattered, so its warps diverge more than the grid form's.
//
// Bound: compute.  Inside the loop there is no global-memory traffic at all
// (state lives in registers; the parameters are read once), so the cost is
// the instructions a step issues (f32: 8 flops and the escape test; ds32:
// quad_step's 46 flops, then |z|^2, the escape and Brent tests and the count;
// chip_smoke.py prints the loop's SASS), times the pixel's escape time, plus
// warp divergence where neighbouring pixels escape at different steps.  Both
// loops carry the squares of z's (hi) words from one step's |z|^2 into the
// next step (the same products, so the same bits).  The f32 loop also takes
// two steps a pass with one exit test, and counts from its loop counter.  A
// warp of the f32 grid form covers a compact 8x4 tile of pixels, whose escape
// times lie closer together than a row of 32's (utils/divergence.py); the
// ds32 form keeps rows of 32.
//
// Rounding: every expression follows the JAX package's evaluation order
// (models/rules.py for f32; ops/dd.py quad_step, add(mul_f(...)) and the
// multibrot dd chain for ds32; ops/coloring.py for the epilogue, color_pixel in
// color_epilogue.cuh, which the f32 grid loop's colored form shares).
// __fmaf_rn appears where dd._fma does, and in quad_step where dd.quad_step
// forms an exact product error by Dekker's splits.  Where that error
// a*b - fl(a*b) does not reach below the smallest subnormal, it is a float,
// Dekker's expression computes it exactly, and one FMA, which rounds it once,
// returns it as it is: the same bits in 1 instruction for 7 to 9.  That holds
// for every product of 2^-100 and above (tests/test_torch_dd_fma.py; the two
// first differ under 2^-108), so on every step whose hi words reach 2^-50.
// The file is compiled with -fmad=false so no other a*b+c is fused, and
// without fast-math, so log2f, sqrtf and the division are the ones torch's
// elementwise kernels call.  The plain torch version
// (fractal_tpu_torch/ops/escape_cuda.py) is then bit-equal on the card.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "color_epilogue.cuh"

namespace {

constexpr int RULE_SQUARE = 0;
constexpr int RULE_BURNINGSHIP = 1;
constexpr int RULE_TRICORN = 2;
constexpr int RULE_POWER = 3;

// Periodicity detection radius, squared (escape_cuda.PERIOD_EPS_SQ_*)
constexpr float PERIOD_EPS_SQ_F32 = 1e-12f;
constexpr float PERIOD_EPS_SQ_DS32 = 1e-18f;

struct F2 {  // double-single word pair, value = hi + lo
  float hi, lo;
};
struct ZF {  // f32 complex
  float r, i;
};
struct ZD {  // ds32 complex
  F2 r, i;
};

// --- ops/dd.py ---------------------------------------------------------------

__device__ __forceinline__ F2 two_sum(float a, float b) {
  float s = a + b;
  float bb = s - a;
  float e = (a - (s - bb)) + (b - bb);
  return {s, e};
}

__device__ __forceinline__ F2 fast_two_sum(float a, float b) {
  float s = a + b;
  float e = b - (s - a);
  return {s, e};
}

__device__ __forceinline__ F2 two_prod(float a, float b) {
  float p = a * b;
  return {p, __fmaf_rn(a, b, -p)};
}

__device__ __forceinline__ F2 dd_add(F2 x, F2 y) {
  F2 s = two_sum(x.hi, y.hi);
  F2 t = two_sum(x.lo, y.lo);
  float c = s.lo + t.hi;
  F2 v = fast_two_sum(s.hi, c);
  float w = t.lo + v.lo;
  return fast_two_sum(v.hi, w);
}

__device__ __forceinline__ F2 dd_neg(F2 x) { return {-x.hi, -x.lo}; }

__device__ __forceinline__ F2 dd_sub(F2 x, F2 y) { return dd_add(x, dd_neg(y)); }

__device__ __forceinline__ F2 dd_mul(F2 x, F2 y) {
  F2 p = two_prod(x.hi, y.hi);
  float t = x.lo * y.lo;
  t = __fmaf_rn(x.hi, y.lo, t);
  t = __fmaf_rn(x.lo, y.hi, t);
  return fast_two_sum(p.hi, p.lo + t);
}

__device__ __forceinline__ F2 dd_mul_f(F2 x, float y) {
  F2 p = two_prod(x.hi, y);
  return fast_two_sum(p.hi, __fmaf_rn(x.lo, y, p.lo));
}

// dd.quad_step: z^2 + c; cross2 = +-2 (tricorn -2).  p1 = xh*xh and p2 = yh*yh
// are the squares |z|^2 summed in the step before (dist_sq), carried in.  Each
// exact product error is one FMA where dd.quad_step splits xh and yh (see the
// header); every other expression keeps dd.quad_step's order.
__device__ __forceinline__ ZD quad_step(F2 zr, F2 zi, float p1, float p2, F2 cr, F2 ci,
                                        float cross2) {
  float xh = zr.hi, xl = zr.lo, yh = zi.hi, yl = zi.lo;
  float e1 = __fmaf_rn(xh, xh, -p1);
  float e2 = __fmaf_rn(yh, yh, -p2);
  float p3 = xh * yh;
  float e3 = __fmaf_rn(xh, yh, -p3);

  float l1 = e1 + (xh + xh) * xl;
  float l2 = e2 + (yh + yh) * yl;
  float l3 = e3 + (xh * yl + xl * yh);

  F2 s = two_sum(p1, -p2);
  F2 s2 = two_sum(s.hi, cr.hi);
  float lo = ((l1 - l2) + s.lo) + (cr.lo + s2.lo);
  F2 nzr = fast_two_sum(s2.hi, lo);

  float ph = cross2 * p3;
  float pl = cross2 * l3;
  F2 s3 = two_sum(ph, ci.hi);
  F2 nzi = fast_two_sum(s3.hi, pl + (ci.lo + s3.lo));
  return {nzr, nzi};
}

// --- representation adapters (escape_pallas.py _F32Rep / _DS32Rep) ----------

__device__ __forceinline__ ZF make_c(ZF*, float xx, float yy, const float* P) {
  return {xx * (P[0] + P[1]) + (P[2] + P[3]), yy * (P[4] + P[5]) + (P[6] + P[7])};
}

__device__ __forceinline__ ZD make_c(ZD*, float xx, float yy, const float* P) {
  return {dd_add(dd_mul_f({P[0], P[1]}, xx), {P[2], P[3]}),
          dd_add(dd_mul_f({P[4], P[5]}, yy), {P[6], P[7]})};
}

__device__ __forceinline__ ZF julia_c(ZF*, const float* P) {
  return {P[10] + P[11], P[12] + P[13]};
}

__device__ __forceinline__ ZD julia_c(ZD*, const float* P) {
  return {{P[10], P[11]}, {P[12], P[13]}};
}

// |z|^2 on the hi words only (the escape threshold is >= 2, see
// escape_pallas.py), with the squares it sums, which the next step takes
struct SD {
  float r2, i2, d;
};
__device__ __forceinline__ SD dist_sq(ZD z) {
  float r2 = z.r.hi * z.r.hi;
  float i2 = z.i.hi * z.i.hi;
  return {r2, i2, r2 + i2};
}

__device__ __forceinline__ float diff_dist(ZF a, ZF b) {
  float dr = a.r - b.r;
  float di = a.i - b.i;
  return dr * dr + di * di;
}

__device__ __forceinline__ float diff_dist(ZD a, ZD b) {
  float dr = (a.r.hi - b.r.hi) + (a.r.lo - b.r.lo);
  float di = (a.i.hi - b.i.hi) + (a.i.lo - b.i.lo);
  return dr * dr + di * di;
}

__device__ __forceinline__ float collapse_r(ZD z) { return z.r.hi + z.r.lo; }
__device__ __forceinline__ float collapse_i(ZD z) { return z.i.hi + z.i.lo; }

// escape_pallas.py _DS32Rep.step, from the squares sq of z's hi words, which
// the step before formed for |z|^2 (burning ship's |z.r.hi| and |z.i.hi| have
// the same squares; multibrot's dd chain forms its own products).
template <int RULE>
__device__ __forceinline__ ZD step(ZD z, SD sq, ZD c, int power) {
  if constexpr (RULE == RULE_SQUARE) {
    return quad_step(z.r, z.i, sq.r2, sq.i2, c.r, c.i, 2.0f);
  } else if constexpr (RULE == RULE_BURNINGSHIP) {
    F2 ar = z.r.hi < 0.0f ? dd_neg(z.r) : z.r;
    F2 ai = z.i.hi < 0.0f ? dd_neg(z.i) : z.i;
    return quad_step(ar, ai, sq.r2, sq.i2, c.r, c.i, 2.0f);
  } else if constexpr (RULE == RULE_TRICORN) {
    return quad_step(z.r, z.i, sq.r2, sq.i2, c.r, c.i, -2.0f);
  } else {
    F2 wr = z.r, wi = z.i;
    for (int k = 0; k < power - 1; ++k) {
      F2 nwr = dd_sub(dd_mul(wr, z.r), dd_mul(wi, z.i));
      F2 nwi = dd_add(dd_mul(wr, z.i), dd_mul(wi, z.r));
      wr = nwr;
      wi = nwi;
    }
    return {dd_add(wr, c.r), dd_add(wi, c.i)};
  }
}

// models/rules.py's step for f32, in its evaluation order, from z's squares
// zr2 = z.r*z.r and zi2 = z.i*z.i, which the step before formed for |z|^2.
// The quadratic rules square z.r and z.i (burning ship |z.r| and |z.i|, whose
// squares are the same bits), so they take the carried products; multibrot's
// square-and-multiply forms its own.
template <int RULE>
__device__ __forceinline__ ZF step_sq(ZF z, float zr2, float zi2, ZF c, int power) {
  if constexpr (RULE == RULE_SQUARE) {
    return {zr2 - zi2 + c.r, 2.0f * (z.r * z.i) + c.i};
  } else if constexpr (RULE == RULE_BURNINGSHIP) {
    return {zr2 - zi2 + c.r, 2.0f * (fabsf(z.r) * fabsf(z.i)) + c.i};
  } else if constexpr (RULE == RULE_TRICORN) {
    return {zr2 - zi2 + c.r, -2.0f * (z.r * z.i) + c.i};
  } else {
    // make_multibrot_step: square-and-multiply
    float br = z.r, bi = z.i, wr = 0.0f, wi = 0.0f;
    bool first = true;
    for (int n = power; n > 0;) {
      if (n & 1) {
        if (first) {
          wr = br;
          wi = bi;
          first = false;
        } else {
          float t = wr * br - wi * bi;
          wi = wr * bi + wi * br;
          wr = t;
        }
      }
      n >>= 1;
      if (n) {
        float t = br * br - bi * bi;
        bi = 2.0f * (br * bi);
        br = t;
      }
    }
    return {wr + c.r, wi + c.i};
  }
}

struct SF {  // an f32 pixel's state: z, its squares and |z|^2
  ZF z;
  float r2, i2, d;
};

template <int RULE>
__device__ __forceinline__ SF advance(const SF& s, ZF c, int power) {
  ZF z = step_sq<RULE>(s.z, s.r2, s.i2, c, power);
  float r2 = z.r * z.r;
  float i2 = z.i * z.i;
  return {z, r2, i2, r2 + i2};
}

__device__ __forceinline__ bool pow2_step(int n) { return n >= 1 && (n & (n - 1)) == 0; }

// The f32 loop: two steps a pass with one exit test.  The reference's loop
// (the ds32 one below) counts a step unless it escaped and stops when |z|^2
// is not <= limit^2 (escaped, or NaN), when a periodic return sets the count
// to the budget, or at the budget; a pixel's count before step n is n, so the
// count at a stop is n for an escape at step n, n + 1 for a NaN, the budget
// otherwise.  The pass's second step runs on the first's z whether or not it
// stopped; its result is then not taken.
template <int RULE, bool JULIA, bool PERIOD>
__device__ __forceinline__ void escape_pixel_f32(const float* P, float xx, float yy, int power,
                                                 int iterations, float& zr_out, float& zi_out,
                                                 int& cnt_out) {
  const float limit_sq = P[8];
  ZF c = make_c(static_cast<ZF*>(nullptr), xx, yy, P);
  SF s;
  s.z = c;  // z starts at the pixel coordinate (calc/src/lib.rs:208-212)
  if (JULIA) c = julia_c(static_cast<ZF*>(nullptr), P);
  s.r2 = s.z.r * s.z.r;
  s.i2 = s.z.i * s.z.i;
  s.d = s.r2 + s.i2;
  ZF snap = s.z;
  int cnt = 0;
  if (s.d <= limit_sq) {
    cnt = iterations;
    int n = 0;
    bool live = true;
    for (; n < iterations - 1; n += 2) {
      SF a = advance<RULE>(s, c, power);
      bool pa = PERIOD && diff_dist(a.z, snap) < PERIOD_EPS_SQ_F32;
      if (PERIOD && pow2_step(n)) snap = a.z;
      SF b = advance<RULE>(a, c, power);
      bool pb = PERIOD && diff_dist(b.z, snap) < PERIOD_EPS_SQ_F32;
      if (PERIOD && ((n + 1) & n) == 0) snap = b.z;  // n + 1 >= 1 is a power of two
      if (!((a.d <= limit_sq) & (b.d <= limit_sq)) || pa || pb) {
        if (!(a.d <= limit_sq)) {
          s = a;
          cnt = n + (a.d > limit_sq ? 0 : 1);
        } else if (pa) {
          s = a;
        } else {
          s = b;
          if (!(b.d <= limit_sq)) cnt = n + 1 + (b.d > limit_sq ? 0 : 1);
        }
        live = false;
        break;
      }
      s = b;
    }
    if (live && n < iterations) {  // an odd budget's last step
      s = advance<RULE>(s, c, power);
      if (!(s.d <= limit_sq)) cnt = n + (s.d > limit_sq ? 0 : 1);
    }
  }
  zr_out = s.z.r;
  zi_out = s.z.i;
  cnt_out = cnt;
}

// One pixel's escape-time loop from its (xx, yy) pixel coordinate: the f32
// loop above, or the reference's loop step by step for ds32.
template <typename Z, int RULE, bool JULIA, bool PERIOD>
__device__ __forceinline__ void escape_pixel(const float* P, float xx, float yy, int power,
                                             int iterations, float& zr_out, float& zi_out,
                                             int& cnt_out) {
  if constexpr (std::is_same<Z, ZF>::value) {
    escape_pixel_f32<RULE, JULIA, PERIOD>(P, xx, yy, power, iterations, zr_out, zi_out,
                                          cnt_out);
  } else {
    const float limit_sq = P[8];
    const float eps_sq = PERIOD_EPS_SQ_DS32;

    Z c = make_c(static_cast<Z*>(nullptr), xx, yy, P);
    Z z = c;  // z starts at the pixel coordinate (calc/src/lib.rs:208-212)
    if (JULIA) c = julia_c(static_cast<Z*>(nullptr), P);
    SD sq = dist_sq(z);
    int cnt = 0;
    Z snap = z;
    for (int n = 0; sq.d <= limit_sq && cnt < iterations; ++n) {
      Z nz = step<RULE>(z, sq, c, power);
      SD nsq = dist_sq(nz);
      bool esc = nsq.d > limit_sq;
      z = nz;
      sq = nsq;
      if (!esc) cnt += 1;
      if (PERIOD) {
        if (!esc && diff_dist(nz, snap) < eps_sq) cnt = iterations;
        if (pow2_step(n)) snap = z;
      }
    }
    zr_out = collapse_r(z);
    zi_out = collapse_i(z);
    cnt_out = cnt;
  }
}

// The grid form.  A block is 32x8 pixels; its warps cover 8x4 tiles (the f32
// form) or rows of 32 (ds32).  COLOR writes the colored pixel to rgb instead
// of (zr, zi, cnt).
template <typename Z, int RULE, bool JULIA, bool PERIOD, bool COLOR>
__global__ void __launch_bounds__(256) escape_kernel(
    const float* __restrict__ params, const float* __restrict__ colors, int power,
    int iterations, int height, int width, int inside, int smooth, float* __restrict__ zr_out,
    float* __restrict__ zi_out, int* __restrict__ cnt_out, uint8_t* __restrict__ rgb) {
  int x, y;
  if constexpr (std::is_same<Z, ZF>::value) {
    const int warp = threadIdx.y, lane = threadIdx.x;  // 8 warps of 32 lanes
    x = blockIdx.x * 32 + (warp & 3) * 8 + (lane & 7);
    y = blockIdx.y * 8 + (warp >> 2) * 4 + (lane >> 3);
  } else {
    x = blockIdx.x * 32 + threadIdx.x;
    y = blockIdx.y * 8 + threadIdx.y;
  }
  if (x >= width || y >= height) return;
  float P[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) P[k] = params[k];
  const float xx = static_cast<float>(x);
  const float yy = static_cast<float>(y) * P[14] + P[15];  // global-row map
  const long i = static_cast<long>(y) * width + x;
  float zr, zi;
  int cnt;
  escape_pixel<Z, RULE, JULIA, PERIOD>(P, xx, yy, power, iterations, zr, zi, cnt);
  if constexpr (COLOR) {
    color_pixel(colors, inside != 0, smooth != 0, zr, zi, cnt, rgb + 3 * i);
  } else {
    zr_out[i] = zr;
    zi_out[i] = zi;
    cnt_out[i] = cnt;
  }
}

// The points form (perturb.py::_fallback_1d): the same loop over k pixels
// whose coordinates are read from xs/ys, as _iterate_tile takes them (no
// global-row map).
template <typename Z, int RULE, bool JULIA, bool PERIOD>
__global__ void escape_points_kernel(const float* __restrict__ params, int power,
                                     int iterations, const float* __restrict__ xs,
                                     const float* __restrict__ ys, int k,
                                     float* __restrict__ zr_out, float* __restrict__ zi_out,
                                     int* __restrict__ cnt_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= k) return;
  float P[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) P[j] = params[j];
  escape_pixel<Z, RULE, JULIA, PERIOD>(P, xs[i], ys[i], power, iterations, zr_out[i],
                                       zi_out[i], cnt_out[i]);
}

struct Args {
  const float* params;
  int power, iterations, height, width;
  const float* xs;  // points form: k = width pixels at (xs, ys); grid form: null
  const float* ys;
  float* zr;
  float* zi;
  int* cnt;
  const float* colors;  // colored grid form: the color block and the (height, width, 3) image
  int inside, smooth;
  uint8_t* rgb;
  cudaStream_t stream;
};

template <typename Z, int RULE, bool JULIA, bool PERIOD>
void launch(const Args& a) {
  if (a.xs != nullptr) {
    const int threads = 128;
    escape_points_kernel<Z, RULE, JULIA, PERIOD><<<(a.width + threads - 1) / threads, threads,
                                                  0, a.stream>>>(
        a.params, a.power, a.iterations, a.xs, a.ys, a.width, a.zr, a.zi, a.cnt);
    return;
  }
  dim3 block(32, 8);
  dim3 grid((a.width + 31) / 32, (a.height + 7) / 8);
  if (a.rgb != nullptr) {
    escape_kernel<Z, RULE, JULIA, PERIOD, true><<<grid, block, 0, a.stream>>>(
        a.params, a.colors, a.power, a.iterations, a.height, a.width, a.inside, a.smooth,
        nullptr, nullptr, nullptr, a.rgb);
  } else {
    escape_kernel<Z, RULE, JULIA, PERIOD, false><<<grid, block, 0, a.stream>>>(
        a.params, nullptr, a.power, a.iterations, a.height, a.width, 0, 0, a.zr, a.zi, a.cnt,
        nullptr);
  }
}

template <typename Z, int RULE>
void by_flags(bool julia, bool period, const Args& a) {
  if (julia) {
    period ? launch<Z, RULE, true, true>(a) : launch<Z, RULE, true, false>(a);
  } else {
    period ? launch<Z, RULE, false, true>(a) : launch<Z, RULE, false, false>(a);
  }
}

template <typename Z>
bool by_rule(int rule, bool julia, bool period, const Args& a) {
  switch (rule) {
    case RULE_SQUARE: by_flags<Z, RULE_SQUARE>(julia, period, a); return true;
    case RULE_BURNINGSHIP: by_flags<Z, RULE_BURNINGSHIP>(julia, period, a); return true;
    case RULE_TRICORN: by_flags<Z, RULE_TRICORN>(julia, period, a); return true;
    case RULE_POWER: by_flags<Z, RULE_POWER>(julia, period, a); return true;
    default: return false;
  }
}

int dispatch(int ds32, int rule, int julia, int periodicity, const Args& a) {
  bool ok = ds32 ? by_rule<ZD>(rule, julia != 0, periodicity != 0, a)
                 : by_rule<ZF>(rule, julia != 0, periodicity != 0, a);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// y = log2f(x) (op 0) or sqrtf(x) (op 1), as color_pixel calls them.
__global__ void math_probe_kernel(int op, const float* __restrict__ x, float* __restrict__ y,
                                  long n) {
  const long i = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) y[i] = op == 0 ? log2f(x[i]) : sqrtf(x[i]);
}

}  // namespace

// Launch kernel A on `stream`; returns cudaGetLastError() after the launch.
extern "C" int fractal_escape(const float* params, int ds32, int rule, int julia,
                              int periodicity, int power, int iterations, int height,
                              int width, float* zr, float* zi, int* cnt, void* stream) {
  if (height <= 0 || width <= 0 || iterations < 0) return static_cast<int>(cudaErrorInvalidValue);
  Args a{params, power, iterations, height, width, nullptr, nullptr, zr, zi, cnt,
         nullptr, 0, 0, nullptr, static_cast<cudaStream_t>(stream)};
  return dispatch(ds32, rule, julia, periodicity, a);
}

// Launch kernel A's colored grid form: the (height, width, 3) uint8 image.
extern "C" int fractal_escape_color(const float* params, const float* colors, int ds32,
                                    int rule, int julia, int periodicity, int power,
                                    int iterations, int height, int width, int inside,
                                    int smooth, uint8_t* rgb, void* stream) {
  if (height <= 0 || width <= 0 || iterations < 0 || colors == nullptr || rgb == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{params, power, iterations, height, width, nullptr, nullptr, nullptr, nullptr,
         nullptr, colors, inside, smooth, rgb, static_cast<cudaStream_t>(stream)};
  return dispatch(ds32, rule, julia, periodicity, a);
}

// Launch kernel A's points form over k pixels at (xs, ys); outputs (k,).
extern "C" int fractal_escape_points(const float* params, int ds32, int rule, int julia,
                                     int periodicity, int power, int iterations,
                                     const float* xs, const float* ys, int k, float* zr,
                                     float* zi, int* cnt, void* stream) {
  if (k <= 0 || iterations < 0 || xs == nullptr || ys == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{params, power, iterations, 1, k, xs, ys, zr, zi, cnt,
         nullptr, 0, 0, nullptr, static_cast<cudaStream_t>(stream)};
  return dispatch(ds32, rule, julia, periodicity, a);
}

// The epilogue's libdevice calls over n floats (a check against torch's).
extern "C" int fractal_math_probe(int op, const float* x, float* y, long n, void* stream) {
  if (n <= 0 || (op != 0 && op != 1)) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256;
  math_probe_kernel<<<static_cast<unsigned>((n + threads - 1) / threads), threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(op, x, y, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fractal_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
