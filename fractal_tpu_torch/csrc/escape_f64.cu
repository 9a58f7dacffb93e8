// The escape-time loop on f64 words, kernel A's dd64 grid form, and the grid
// escape loop on f64 and f32 words.
//
// escape_time_dd64 replaces fractal_tpu/ops/escape_pallas.py::iterate_params
// with precision="dd64" (the _iterate_tile scaffold over double-double pairs
// of f64 words, ~2^-106 relative; the JAX package runs it only as its
// whole-image twin on the CPU, since a TPU has no f64 vectors).  Its result is
// (zr, zi) f64 and cnt int32 for a (rows, W) grid from an f64[16] parameter
// block (escape_cuda.scene_params(..., dtype=torch.float64)): the viewport's
// double-word affine, limit^2, julia c and the global-row map.  The loop is
// escape.cu's ds32 loop step for step on double words: a pixel's freeze, its
// count and its Brent snapshots (n >= 1, n & (n-1) == 0) depend on its own
// state and the global step n only, so one thread a pixel with its own early
// exit gives the TPU kernel's lock-step result.
//
// escape_time_f64, escape_time_f32_grid and escape_time_f32_grid_color replace
// fractal_tpu/ops/escape_jnp.py::iterate (:30) on f64 and on f32 words, an
// XLA program: the JAX package's f64 route, and its f32 route under --backend
// jnp or on the CPU, which fractal_tpu/render.py::_escape_jnp_band jits
// together with the pixel grid and the coloring.  z <- rule(z) + c from the
// pixel's c (viewport.pixel_grid), c the pixel's point or julia's constant, no
// periodicity.  Step i escapes with count i when |z'|^2 > limit^2; the start
// point is not tested, and a NaN |z'|^2 is no escape: the pixel counts the step
// and runs on to the budget, as iterate's does.
//
// Bound: operations.  No global-memory traffic inside the loops; the card
// runs f64 at 64 lanes an SM, half its f32 rate without FMA, and a dd64 step
// is ~80 of them (quad_step with its two Dekker splits), a quadratic grid
// step 9 in either word type (f32 at 128 lanes an SM).  The dd64 form runs one
// thread a pixel in blocks of 32x8, a warp a row of 32; the f64 loop
// (escape_grid) one thread a pixel over the flat grid, one step and one exit
// test a pass, squaring z twice a step.
//
// The f32 loop (escape_grid_f32) is designed for what bounds it, as kernel
// A's f32 loop is (escape.cu escape_pixel_f32): it carries zr^2 and zi^2 from
// one step's |z|^2 into the next step (the same products, so the same bits;
// burning ship's |x|*|x| is x*x), 8 operations a step where 10 were; it
// takes two steps a pass with one exit test and one branch; and its warps
// cover 8x4 tiles of a 2-D launch over (rows, W), whose escape times lie
// closer together than a row of 32's (utils/divergence.py).  Its two forms:
// escape_time_f32_grid reads the (rows, W) pixel grid and writes (zr, zi,
// cnt), 20 B a pixel; escape_time_f32_grid_color forms the pixel's c itself,
// op for op as pixel_grid does in f32, runs the loop and the coloring
// epilogue (color_epilogue.cuh) and writes the u8 pixel, 3 B: one launch a
// frame, as the JAX package's jitted program is one program.
//
// Rounding: every expression follows the JAX package's order (ops/dd.py for
// dd64, models/rules.py for the grid loop, ops/viewport.py for c,
// ops/coloring.py for the epilogue).  The file is compiled with -fmad=false,
// so no a*b + c is fused, and without fast-math, so a division is IEEE's.
// dd64 takes the reference's own _fma, which is not an FMA: jax.lax has no
// fma, so ops/dd.py's _fma is _fma_dekker, the exact Dekker product p + e of
// a*b followed by (p + c) + e.  fma_dekker below writes that out; no __fma_rn
// appears in this file.  Torch on the CPU has no f64 FMA either, and its
// eager f32 ops never fuse, so the plain versions (escape_cuda.iterate_whole
// over ops/dd.py's f64 path; ops/escape.iterate in f64 and f32, after
// viewport.pixel_grid and before torch's coloring) round the same and are
// bit-equal to these kernels on the card.

#include <cuda_runtime.h>

#include <cstdint>

#include "color_epilogue.cuh"

namespace {

constexpr int RULE_SQUARE = 0;
constexpr int RULE_BURNINGSHIP = 1;
constexpr int RULE_TRICORN = 2;
constexpr int RULE_POWER = 3;

constexpr double kSplitter = 134217729.0;  // 2^27 + 1
// Periodicity detection radius, squared (escape_cuda.PERIOD_EPS_SQ_DS32,
// compared in the word type as escape_pallas.py compares it)
constexpr double PERIOD_EPS_SQ = 1e-18;

struct D2 {  // double-double pair, value = hi + lo
  double hi, lo;
};
struct ZQ {  // dd64 complex
  D2 r, i;
};

// --- ops/dd.py on f64 words -------------------------------------------------

__device__ __forceinline__ D2 two_sum(double a, double b) {
  double s = a + b;
  double bb = s - a;
  double e = (a - (s - bb)) + (b - bb);
  return {s, e};
}

__device__ __forceinline__ D2 fast_two_sum(double a, double b) {
  double s = a + b;
  double e = b - (s - a);
  return {s, e};
}

__device__ __forceinline__ D2 split(double a) {
  double s = a * kSplitter;
  double h = s - (s - a);
  return {h, a - h};
}

// dd._two_prod_dekker
__device__ __forceinline__ D2 two_prod_dekker(double a, double b) {
  D2 x = split(a);
  D2 y = split(b);
  double p = a * b;
  double err = ((x.hi * y.hi - p) + x.hi * y.lo + x.lo * y.hi) + x.lo * y.lo;
  return {p, err};
}

// dd._fma_dekker: (p + c) + e, two roundings
__device__ __forceinline__ double fma_dekker(double a, double b, double c) {
  D2 pe = two_prod_dekker(a, b);
  return (pe.hi + c) + pe.lo;
}

__device__ __forceinline__ D2 two_prod(double a, double b) {
  double p = a * b;
  return {p, fma_dekker(a, b, -p)};
}

__device__ __forceinline__ D2 dd_add(D2 x, D2 y) {
  D2 s = two_sum(x.hi, y.hi);
  D2 t = two_sum(x.lo, y.lo);
  double c = s.lo + t.hi;
  D2 v = fast_two_sum(s.hi, c);
  double w = t.lo + v.lo;
  return fast_two_sum(v.hi, w);
}

__device__ __forceinline__ D2 dd_neg(D2 x) { return {-x.hi, -x.lo}; }

__device__ __forceinline__ D2 dd_sub(D2 x, D2 y) { return dd_add(x, dd_neg(y)); }

__device__ __forceinline__ D2 dd_mul(D2 x, D2 y) {
  D2 p = two_prod(x.hi, y.hi);
  double t = x.lo * y.lo;
  t = fma_dekker(x.hi, y.lo, t);
  t = fma_dekker(x.lo, y.hi, t);
  return fast_two_sum(p.hi, p.lo + t);
}

__device__ __forceinline__ D2 dd_mul_f(D2 x, double y) {
  D2 p = two_prod(x.hi, y);
  return fast_two_sum(p.hi, fma_dekker(x.lo, y, p.lo));
}

// dd.quad_step: z^2 + c with shared Dekker splits; cross2 = +-2 (tricorn -2).
__device__ __forceinline__ ZQ quad_step(D2 zr, D2 zi, D2 cr, D2 ci, double cross2) {
  double xh = zr.hi, xl = zr.lo, yh = zi.hi, yl = zi.lo;
  D2 a = split(xh);
  D2 b = split(yh);
  double a1 = a.hi, a2 = a.lo, b1 = b.hi, b2 = b.lo;

  double p1 = xh * xh;
  double e1 = ((a1 * a1 - p1) + (a1 + a1) * a2) + a2 * a2;
  double p2 = yh * yh;
  double e2 = ((b1 * b1 - p2) + (b1 + b1) * b2) + b2 * b2;
  double p3 = xh * yh;
  double e3 = ((a1 * b1 - p3) + (a1 * b2 + a2 * b1)) + a2 * b2;

  double l1 = e1 + (xh + xh) * xl;
  double l2 = e2 + (yh + yh) * yl;
  double l3 = e3 + (xh * yl + xl * yh);

  D2 s = two_sum(p1, -p2);
  D2 s2 = two_sum(s.hi, cr.hi);
  double lo = ((l1 - l2) + s.lo) + (cr.lo + s2.lo);
  D2 nzr = fast_two_sum(s2.hi, lo);

  double ph = cross2 * p3;
  double pl = cross2 * l3;
  D2 s3 = two_sum(ph, ci.hi);
  D2 nzi = fast_two_sum(s3.hi, pl + (ci.lo + s3.lo));
  return {nzr, nzi};
}

// escape_pallas.py _DS32Rep.step on f64 words
template <int RULE>
__device__ __forceinline__ ZQ dd_step(ZQ z, ZQ c, int power) {
  if constexpr (RULE == RULE_SQUARE) {
    return quad_step(z.r, z.i, c.r, c.i, 2.0);
  } else if constexpr (RULE == RULE_BURNINGSHIP) {
    D2 ar = z.r.hi < 0.0 ? dd_neg(z.r) : z.r;
    D2 ai = z.i.hi < 0.0 ? dd_neg(z.i) : z.i;
    return quad_step(ar, ai, c.r, c.i, 2.0);
  } else if constexpr (RULE == RULE_TRICORN) {
    return quad_step(z.r, z.i, c.r, c.i, -2.0);
  } else {
    D2 wr = z.r, wi = z.i;
    for (int k = 0; k < power - 1; ++k) {
      D2 nwr = dd_sub(dd_mul(wr, z.r), dd_mul(wi, z.i));
      D2 nwi = dd_add(dd_mul(wr, z.i), dd_mul(wi, z.r));
      wr = nwr;
      wi = nwi;
    }
    return {dd_add(wr, c.r), dd_add(wi, c.i)};
  }
}

// hi words only: the escape threshold is >= 2 (see escape_pallas.py)
__device__ __forceinline__ double dist(ZQ z) { return z.r.hi * z.r.hi + z.i.hi * z.i.hi; }

__device__ __forceinline__ double diff_dist(ZQ a, ZQ b) {
  double dr = (a.r.hi - b.r.hi) + (a.r.lo - b.r.lo);
  double di = (a.i.hi - b.i.hi) + (a.i.lo - b.i.lo);
  return dr * dr + di * di;
}

__device__ __forceinline__ bool pow2_step(int n) { return n >= 1 && (n & (n - 1)) == 0; }

// The dd64 grid form: a 32x8 block, a warp a row of 32 pixels.
template <int RULE, bool JULIA, bool PERIOD>
__global__ void __launch_bounds__(256) escape_dd64_kernel(
    const double* __restrict__ params, int power, int iterations, int height, int width,
    double* __restrict__ zr_out, double* __restrict__ zi_out, int* __restrict__ cnt_out) {
  const int x = blockIdx.x * 32 + threadIdx.x;
  const int y = blockIdx.y * 8 + threadIdx.y;
  if (x >= width || y >= height) return;
  const double* P = params;
  const double xx = static_cast<double>(x);
  const double yy = static_cast<double>(y) * P[14] + P[15];  // global-row map
  const double limit_sq = P[8];

  // _DS32Rep.make_c: c = A * u + C per axis in double words
  ZQ c = {dd_add(dd_mul_f({P[0], P[1]}, xx), {P[2], P[3]}),
          dd_add(dd_mul_f({P[4], P[5]}, yy), {P[6], P[7]})};
  ZQ z = c;  // z starts at the pixel coordinate (calc/src/lib.rs:208-212)
  if (JULIA) c = {{P[10], P[11]}, {P[12], P[13]}};
  double d = dist(z);
  int cnt = 0;
  ZQ snap = z;
  for (int n = 0; d <= limit_sq && cnt < iterations; ++n) {
    ZQ nz = dd_step<RULE>(z, c, power);
    double nd = dist(nz);
    bool esc = nd > limit_sq;
    z = nz;
    d = nd;
    if (!esc) cnt += 1;
    if (PERIOD) {
      if (!esc && diff_dist(nz, snap) < PERIOD_EPS_SQ) cnt = iterations;
      if (pow2_step(n)) snap = z;
    }
  }
  const long i = static_cast<long>(y) * width + x;
  zr_out[i] = z.r.hi + z.r.lo;  // collapse
  zi_out[i] = z.i.hi + z.i.lo;
  cnt_out[i] = cnt;
}

__device__ __forceinline__ float abs_word(float x) { return fabsf(x); }
__device__ __forceinline__ double abs_word(double x) { return fabs(x); }

// models/rules.py's step in the word type T, in its evaluation order (the
// constants +-2 are exact in either type).
template <typename T, int RULE>
__device__ __forceinline__ void grid_step(T& zr, T& zi, T cr, T ci, int power) {
  if constexpr (RULE == RULE_SQUARE || RULE == RULE_TRICORN) {
    T zr2 = zr * zr;
    T zi2 = zi * zi;
    T im = T(RULE == RULE_TRICORN ? -2.0 : 2.0) * (zr * zi) + ci;
    zr = zr2 - zi2 + cr;
    zi = im;
  } else if constexpr (RULE == RULE_BURNINGSHIP) {
    T ar = abs_word(zr);
    T ai = abs_word(zi);
    zr = ar * ar - ai * ai + cr;
    zi = T(2.0) * (ar * ai) + ci;
  } else {
    // make_multibrot_step: square-and-multiply
    T br = zr, bi = zi, wr = T(0), wi = T(0);
    bool first = true;
    for (int n = power; n > 0;) {
      if (n & 1) {
        if (first) {
          wr = br;
          wi = bi;
          first = false;
        } else {
          T t = wr * br - wi * bi;
          wi = wr * bi + wi * br;
          wr = t;
        }
      }
      n >>= 1;
      if (n) {
        T t = br * br - bi * bi;
        bi = T(2.0) * (br * bi);
        br = t;
      }
    }
    zr = wr + cr;
    zi = wi + ci;
  }
}

// The grid loop on pixel i of (cr, ci), in the word type T.
template <typename T, int RULE, bool JULIA>
__device__ __forceinline__ void escape_grid(const T* __restrict__ cr, const T* __restrict__ ci,
                                            T jr, T ji, T limit_sq, int power, int iterations,
                                            long i, T* __restrict__ zr_out,
                                            T* __restrict__ zi_out, int* __restrict__ cnt_out) {
  T zr = cr[i], zi = ci[i];
  const T c_r = JULIA ? jr : zr;
  const T c_i = JULIA ? ji : zi;
  int cnt = 0;
  while (cnt < iterations) {
    grid_step<T, RULE>(zr, zi, c_r, c_i, power);
    T d = zr * zr + zi * zi;
    if (d > limit_sq) break;  // escaped at step cnt; a NaN runs on, as iterate's does
    cnt += 1;
  }
  zr_out[i] = zr;
  zi_out[i] = zi;
  cnt_out[i] = cnt;
}

// The f64 loop over n pixels of the grid (cr, ci): one thread a pixel.
template <int RULE, bool JULIA>
__global__ void __launch_bounds__(256) escape_f64_kernel(
    const double* __restrict__ cr, const double* __restrict__ ci, double jr, double ji,
    double limit_sq, int power, int iterations, long n, double* __restrict__ zr_out,
    double* __restrict__ zi_out, int* __restrict__ cnt_out) {
  const long i = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  escape_grid<double, RULE, JULIA>(cr, ci, jr, ji, limit_sq, power, iterations, i, zr_out,
                                   zi_out, cnt_out);
}

struct GF {  // an f32 pixel's state: z, its squares and |z|^2
  float r, i, r2, i2, d;
};

// One step of models/rules.py's rule from z's squares r2 = z.r*z.r and i2 =
// z.i*z.i, which the step before formed for |z|^2, then the new z's squares
// and |z|^2.  Multibrot's square-and-multiply forms its own squares.
template <int RULE>
__device__ __forceinline__ GF grid_advance(const GF& s, float cr, float ci, int power) {
  float zr, zi;
  if constexpr (RULE == RULE_SQUARE || RULE == RULE_TRICORN) {
    zr = s.r2 - s.i2 + cr;
    zi = (RULE == RULE_TRICORN ? -2.0f : 2.0f) * (s.r * s.i) + ci;
  } else if constexpr (RULE == RULE_BURNINGSHIP) {
    zr = s.r2 - s.i2 + cr;
    zi = 2.0f * (fabsf(s.r) * fabsf(s.i)) + ci;
  } else {
    zr = s.r;
    zi = s.i;
    grid_step<float, RULE_POWER>(zr, zi, cr, ci, power);
  }
  const float r2 = zr * zr;
  const float i2 = zi * zi;
  return {zr, zi, r2, i2, r2 + i2};
}

// The f32 grid loop from z0 = (zr0, zi0): two steps a pass with one exit
// test.  Escaping is d > limit_sq only (a NaN d runs on), so a pass ends when
// either step escaped: the first with count n, else the second with n + 1;
// the second step runs on the first's z whether or not it escaped, and its
// result is then not taken.  An odd budget takes one step more at the end.
template <int RULE, bool JULIA>
__device__ __forceinline__ void escape_grid_f32(float zr0, float zi0, float jr, float ji,
                                                float limit_sq, int power, int iterations,
                                                float& zr_out, float& zi_out, int& cnt_out) {
  const float cr = JULIA ? jr : zr0;
  const float ci = JULIA ? ji : zi0;
  GF s = {zr0, zi0, zr0 * zr0, zi0 * zi0, 0.0f};
  int cnt = iterations;
  int n = 0;
  bool live = true;
  for (; n < iterations - 1; n += 2) {
    const GF a = grid_advance<RULE>(s, cr, ci, power);
    const GF b = grid_advance<RULE>(a, cr, ci, power);
    if ((a.d > limit_sq) | (b.d > limit_sq)) {
      const bool first = a.d > limit_sq;
      s = first ? a : b;
      cnt = first ? n : n + 1;
      live = false;
      break;
    }
    s = b;
  }
  if (live && n < iterations) {  // an odd budget's last step
    s = grid_advance<RULE>(s, cr, ci, power);
    if (s.d > limit_sq) cnt = n;
  }
  zr_out = s.r;
  zi_out = s.i;
  cnt_out = cnt;
}

// A block of 32x8 threads covers 32x8 pixels of the (rows, W) grid; each of
// its 8 warps an 8x4 tile.
__device__ __forceinline__ void tile_xy(int& x, int& y) {
  const int warp = threadIdx.y, lane = threadIdx.x;
  x = blockIdx.x * 32 + (warp & 3) * 8 + (lane & 7);
  y = blockIdx.y * 8 + (warp >> 2) * 4 + (lane >> 3);
}

// escape_time_f32_grid: the f32 loop over the (rows, width) grid (cr, ci).
template <int RULE, bool JULIA>
__global__ void __launch_bounds__(256) escape_f32_grid_kernel(
    const float* __restrict__ cr, const float* __restrict__ ci, float jr, float ji,
    float limit_sq, int power, int iterations, int rows, int width,
    float* __restrict__ zr_out, float* __restrict__ zi_out, int* __restrict__ cnt_out) {
  int x, y;
  tile_xy(x, y);
  if (x >= width || y >= rows) return;
  const long i = static_cast<long>(y) * width + x;
  float zr, zi;
  int cnt;
  escape_grid_f32<RULE, JULIA>(cr[i], ci[i], jr, ji, limit_sq, power, iterations, zr, zi, cnt);
  zr_out[i] = zr;
  zi_out[i] = zi;
  cnt_out[i] = cnt;
}

struct GridView {  // viewport.pixel_grid's constants, each rounded to f32 as it rounds them
  float h, off_re, scale_re, scale_im, pos_re, pos_im, row0;
};

// Pixel (x, y) of the band's c as pixel_grid forms it, op for op in f32: x
// and y + row0 integer-valued words, then (u / h - off) / scale + pos with
// IEEE divisions.
__device__ __forceinline__ void grid_c(const GridView& v, int x, int y, float& cr, float& ci) {
  cr = (static_cast<float>(x) / v.h - v.off_re) / v.scale_re + v.pos_re;
  ci = ((static_cast<float>(y) + v.row0) / v.h - 0.5f) / v.scale_im + v.pos_im;
}

// escape_time_f32_grid_color: rows [row0, row0 + rows) of the view's grid,
// c formed by grid_c, the f32 loop and the coloring epilogue on
// color_params' block.
template <int RULE, bool JULIA>
__global__ void __launch_bounds__(256) escape_f32_grid_color_kernel(
    GridView v, float jr, float ji, float limit_sq, int power, int iterations, int rows,
    int width, const float* __restrict__ colors, int inside, int smooth,
    uint8_t* __restrict__ rgb) {
  int x, y;
  tile_xy(x, y);
  if (x >= width || y >= rows) return;
  float cr, ci;
  grid_c(v, x, y, cr, ci);
  float zr, zi;
  int cnt;
  escape_grid_f32<RULE, JULIA>(cr, ci, jr, ji, limit_sq, power, iterations, zr, zi, cnt);
  color_pixel(colors, inside != 0, smooth != 0, zr, zi, cnt,
              rgb + 3 * (static_cast<long>(y) * width + x));
}

struct Dd64Args {
  const double* params;
  int power, iterations, height, width;
  double *zr, *zi;
  int* cnt;
  cudaStream_t stream;
};

template <int RULE, bool JULIA, bool PERIOD>
void launch_dd64(const Dd64Args& a) {
  dim3 block(32, 8);
  dim3 grid((a.width + 31) / 32, (a.height + 7) / 8);
  escape_dd64_kernel<RULE, JULIA, PERIOD><<<grid, block, 0, a.stream>>>(
      a.params, a.power, a.iterations, a.height, a.width, a.zr, a.zi, a.cnt);
}

template <int RULE>
void dd64_by_flags(bool julia, bool period, const Dd64Args& a) {
  if (julia) {
    period ? launch_dd64<RULE, true, true>(a) : launch_dd64<RULE, true, false>(a);
  } else {
    period ? launch_dd64<RULE, false, true>(a) : launch_dd64<RULE, false, false>(a);
  }
}

// The c that grid_c forms for each pixel of the band (a check against
// pixel_grid's torch ops).
__global__ void grid_c_probe_kernel(GridView v, int rows, int width, float* __restrict__ cr,
                                    float* __restrict__ ci) {
  int x, y;
  tile_xy(x, y);
  if (x >= width || y >= rows) return;
  const long i = static_cast<long>(y) * width + x;
  grid_c(v, x, y, cr[i], ci[i]);
}

struct GridArgs {
  const double *cr, *ci;
  double jr, ji, limit_sq;
  int power, iterations;
  long n;
  double *zr, *zi;
  int* cnt;
  cudaStream_t stream;
};

constexpr int GRID_THREADS = 256;

template <int RULE, bool JULIA>
void launch_grid(const GridArgs& a) {
  const unsigned blocks = static_cast<unsigned>((a.n + GRID_THREADS - 1) / GRID_THREADS);
  escape_f64_kernel<RULE, JULIA><<<blocks, GRID_THREADS, 0, a.stream>>>(
      a.cr, a.ci, a.jr, a.ji, a.limit_sq, a.power, a.iterations, a.n, a.zr, a.zi, a.cnt);
}

struct F32GridArgs {
  const float *cr, *ci;  // the three-output form's grid; null for the colored form
  GridView view;         // the colored form's viewport
  float jr, ji, limit_sq;
  int power, iterations, rows, width;
  float *zr, *zi;
  int* cnt;
  const float* colors;  // the colored form's block and (rows, width, 3) image
  int inside, smooth;
  uint8_t* rgb;
  cudaStream_t stream;
};

template <int RULE, bool JULIA>
void launch_grid(const F32GridArgs& a) {
  dim3 block(32, 8);
  dim3 grid((a.width + 31) / 32, (a.rows + 7) / 8);
  if (a.rgb != nullptr) {
    escape_f32_grid_color_kernel<RULE, JULIA><<<grid, block, 0, a.stream>>>(
        a.view, a.jr, a.ji, a.limit_sq, a.power, a.iterations, a.rows, a.width, a.colors,
        a.inside, a.smooth, a.rgb);
  } else {
    escape_f32_grid_kernel<RULE, JULIA><<<grid, block, 0, a.stream>>>(
        a.cr, a.ci, a.jr, a.ji, a.limit_sq, a.power, a.iterations, a.rows, a.width, a.zr,
        a.zi, a.cnt);
  }
}

template <int RULE, typename A>
void grid_by_flags(bool julia, const A& a) {
  julia ? launch_grid<RULE, true>(a) : launch_grid<RULE, false>(a);
}

template <typename A>
int launch_grid_rule(int rule, bool julia, const A& a) {
  switch (rule) {
    case RULE_SQUARE: grid_by_flags<RULE_SQUARE>(julia, a); break;
    case RULE_BURNINGSHIP: grid_by_flags<RULE_BURNINGSHIP>(julia, a); break;
    case RULE_TRICORN: grid_by_flags<RULE_TRICORN>(julia, a); break;
    case RULE_POWER: grid_by_flags<RULE_POWER>(julia, a); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch kernel A's dd64 grid form on `stream`; returns cudaGetLastError().
extern "C" int fractal_escape_dd64(const double* params, int rule, int julia, int periodicity,
                                   int power, int iterations, int height, int width,
                                   double* zr, double* zi, int* cnt, void* stream) {
  if (height <= 0 || width <= 0 || iterations < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Dd64Args a{params, power, iterations, height, width, zr, zi, cnt,
             static_cast<cudaStream_t>(stream)};
  const bool j = julia != 0, p = periodicity != 0;
  switch (rule) {
    case RULE_SQUARE: dd64_by_flags<RULE_SQUARE>(j, p, a); break;
    case RULE_BURNINGSHIP: dd64_by_flags<RULE_BURNINGSHIP>(j, p, a); break;
    case RULE_TRICORN: dd64_by_flags<RULE_TRICORN>(j, p, a); break;
    case RULE_POWER: dd64_by_flags<RULE_POWER>(j, p, a); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launch the f64 escape loop over the n pixels of (cr, ci) on `stream`.
extern "C" int fractal_escape_f64(const double* cr, const double* ci, double jr, double ji,
                                  double limit_sq, int rule, int julia, int power,
                                  int iterations, long n, double* zr, double* zi, int* cnt,
                                  void* stream) {
  if (n <= 0 || iterations < 0) return static_cast<int>(cudaErrorInvalidValue);
  GridArgs a{cr, ci, jr, ji, limit_sq, power, iterations, n, zr, zi, cnt,
             static_cast<cudaStream_t>(stream)};
  return launch_grid_rule(rule, julia != 0, a);
}

// Launch the f32 escape loop over the (rows, width) grid (cr, ci) on `stream`;
// jr, ji and limit_sq arrive as f32 values (the wrapper rounds them as the
// plain version does).
extern "C" int fractal_escape_f32_grid(const float* cr, const float* ci, double jr, double ji,
                                       double limit_sq, int rule, int julia, int power,
                                       int iterations, int rows, int width, float* zr,
                                       float* zi, int* cnt, void* stream) {
  if (rows <= 0 || width <= 0 || iterations < 0 || cr == nullptr || ci == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  F32GridArgs a{cr, ci, {}, static_cast<float>(jr), static_cast<float>(ji),
                static_cast<float>(limit_sq), power, iterations, rows, width, zr, zi, cnt,
                nullptr, 0, 0, nullptr, static_cast<cudaStream_t>(stream)};
  return launch_grid_rule(rule, julia != 0, a);
}

static GridView grid_view(const double* view) {
  return {static_cast<float>(view[0]), static_cast<float>(view[1]),
          static_cast<float>(view[2]), static_cast<float>(view[3]),
          static_cast<float>(view[4]), static_cast<float>(view[5]),
          static_cast<float>(view[6])};
}

// Launch the f32 loop's colored form over rows [row0, row0 + rows) of a view
// whose pixel_grid constants are view[0:7] (h, off_re, scale_re, scale_im,
// pos_re, pos_im, row0, each an f32 value): the (rows, width, 3) uint8 image.
extern "C" int fractal_escape_f32_grid_color(const double* view, double jr, double ji,
                                             double limit_sq, int rule, int julia, int power,
                                             int iterations, int rows, int width,
                                             const float* colors, int inside, int smooth,
                                             uint8_t* rgb, void* stream) {
  if (rows <= 0 || width <= 0 || iterations < 0 || view == nullptr || colors == nullptr ||
      rgb == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  F32GridArgs a{nullptr, nullptr, grid_view(view), static_cast<float>(jr),
                static_cast<float>(ji), static_cast<float>(limit_sq), power, iterations,
                rows, width, nullptr, nullptr, nullptr, colors, inside, smooth, rgb,
                static_cast<cudaStream_t>(stream)};
  return launch_grid_rule(rule, julia != 0, a);
}

// The colored form's c over rows [row0, row0 + rows) of view[0:7]: (rows,
// width) f32 cr and ci.
extern "C" int fractal_grid_c_probe(const double* view, int rows, int width, float* cr,
                                    float* ci, void* stream) {
  if (rows <= 0 || width <= 0 || view == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  dim3 block(32, 8);
  dim3 grid((width + 31) / 32, (rows + 7) / 8);
  grid_c_probe_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      grid_view(view), rows, width, cr, ci);
  return static_cast<int>(cudaGetLastError());
}
