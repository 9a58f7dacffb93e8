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
// escape_time_f64 and escape_time_f32_grid replace
// fractal_tpu/ops/escape_jnp.py::iterate on f64 and on f32 words (an XLA
// program: the JAX package's f64 route, and its f32 route under --backend jnp
// or on the CPU): z <- rule(z) + c from the (rows, W) pixel grid of
// viewport.pixel_grid, c the grid's point or julia's constant, no
// periodicity.  Step i escapes with count i when |z'|^2 > limit^2; the start
// point is not tested.  One templated loop (escape_grid) in the word type,
// two kernels: escape_f64_kernel and escape_f32_grid_kernel.
//
// Bound: operations.  No global-memory traffic inside the loop; the card
// runs f64 at 64 lanes an SM, half its f32 rate without FMA, and a dd64 step
// is ~80 of them (quad_step with its two Dekker splits), a quadratic grid
// step ~9 in either word type (f32 at 128 lanes an SM).  All are the simple
// form: one thread a pixel (dd64 in blocks of 32x8, a warp a row of 32; the
// grid loop over the flat grid), outputs written once.
//
// Rounding: every expression follows the JAX package's order (ops/dd.py for
// dd64, models/rules.py for the grid loop).  The file is compiled with
// -fmad=false, so
// no a*b + c is fused.  dd64 takes the reference's own _fma, which is not an
// FMA: jax.lax has no fma, so ops/dd.py's _fma is _fma_dekker, the exact
// Dekker product p + e of a*b followed by (p + c) + e.  fma_dekker below
// writes that out; no __fma_rn appears in this file.  Torch on the CPU has no
// f64 FMA either, and its eager f32 ops never fuse, so the plain versions
// (escape_cuda.iterate_whole over ops/dd.py's f64 path; ops/escape.iterate
// in f64 and f32) round the same and are bit-equal to these kernels on the
// card.

#include <cuda_runtime.h>

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

// The same loop on f32 words.
template <int RULE, bool JULIA>
__global__ void __launch_bounds__(256) escape_f32_grid_kernel(
    const float* __restrict__ cr, const float* __restrict__ ci, float jr, float ji,
    float limit_sq, int power, int iterations, long n, float* __restrict__ zr_out,
    float* __restrict__ zi_out, int* __restrict__ cnt_out) {
  const long i = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  escape_grid<float, RULE, JULIA>(cr, ci, jr, ji, limit_sq, power, iterations, i, zr_out,
                                  zi_out, cnt_out);
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

template <typename T>
struct GridArgs {
  const T *cr, *ci;
  T jr, ji, limit_sq;
  int power, iterations;
  long n;
  T *zr, *zi;
  int* cnt;
  cudaStream_t stream;
};

constexpr int GRID_THREADS = 256;

template <typename T>
unsigned grid_blocks(const GridArgs<T>& a) {
  return static_cast<unsigned>((a.n + GRID_THREADS - 1) / GRID_THREADS);
}

template <int RULE, bool JULIA>
void launch_grid(const GridArgs<double>& a) {
  escape_f64_kernel<RULE, JULIA><<<grid_blocks(a), GRID_THREADS, 0, a.stream>>>(
      a.cr, a.ci, a.jr, a.ji, a.limit_sq, a.power, a.iterations, a.n, a.zr, a.zi, a.cnt);
}

template <int RULE, bool JULIA>
void launch_grid(const GridArgs<float>& a) {
  escape_f32_grid_kernel<RULE, JULIA><<<grid_blocks(a), GRID_THREADS, 0, a.stream>>>(
      a.cr, a.ci, a.jr, a.ji, a.limit_sq, a.power, a.iterations, a.n, a.zr, a.zi, a.cnt);
}

template <int RULE, typename T>
void grid_by_flags(bool julia, const GridArgs<T>& a) {
  julia ? launch_grid<RULE, true>(a) : launch_grid<RULE, false>(a);
}

template <typename T>
int launch_grid_rule(int rule, bool julia, const GridArgs<T>& a) {
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
  GridArgs<double> a{cr, ci, jr, ji, limit_sq, power, iterations, n, zr, zi, cnt,
                     static_cast<cudaStream_t>(stream)};
  return launch_grid_rule(rule, julia != 0, a);
}

// Launch the f32 escape loop over the n pixels of (cr, ci) on `stream`; jr,
// ji and limit_sq arrive as f32 values (the wrapper rounds them as the plain
// version does).
extern "C" int fractal_escape_f32_grid(const float* cr, const float* ci, double jr, double ji,
                                       double limit_sq, int rule, int julia, int power,
                                       int iterations, long n, float* zr, float* zi, int* cnt,
                                       void* stream) {
  if (n <= 0 || iterations < 0) return static_cast<int>(cudaErrorInvalidValue);
  GridArgs<float> a{cr, ci, static_cast<float>(jr), static_cast<float>(ji),
                    static_cast<float>(limit_sq), power, iterations, n, zr, zi, cnt,
                    static_cast<cudaStream_t>(stream)};
  return launch_grid_rule(rule, julia != 0, a);
}
