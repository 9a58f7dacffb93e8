// delta-orbit kernel D: the extreme-depth tier's per-pixel loop in floatexp.
//
// Replaces fractal_tpu/ops/perturb.py::perturb_pallas_fe (body
// _build_pert_kernel_fe), the quadratic mandelbrot/julia delta orbit past
// pixel spacing 1e-30, where dc ~ 1/zoom leaves float's exponent range.
// Every delta quantity is a floatexp pair (m, e): value m * 2^e with a float
// mantissa |m| in [0.5, 1), an int exponent, and zero as (0, E_ZERO); each
// op renormalises (fractal_tpu_torch/ops/floatexp.py is the plain version).
// Per step, in the reference twin's order (perturb.py:871-888):
//
//   tr = fe(2Z_r) + dz_r,  ti = fe(2Z_i) + dz_i       (fe add)
//   dz' = (tr + i ti) * dz  + dc_g                     (fe cmul, fe add)
//   z = Z_{n+1} + to_float(dz'),  |z|^2                (float)
//   glitch form: |z|^2 = +inf when below tau^2 |Z_{n+1}|^2
//
// dc = fe(x - u0) * (A_m, A_e) per axis from the fe parameter block
// (perturb._pert_params_fe: P[0], P[1] the affine mantissas, P[8], P[9] their
// exponents); dc_g is dc times the gain P[5], a true zero for julia.  There is
// no series skip: every pixel starts at n = 0 with dz = dc.  Each thread owns
// one pixel and steps while it is live (|z|^2 <= limit^2; a glitch leaves
// through +inf) and the orbit lasts (n < n_steps).  The TPU kernel updates dz
// of frozen pixels too (its exponents then keep doubling and wrap); here a
// stopped thread stops stepping, so no exponent overflows.  The epilogue is
// kernel B's (perturb.py:1792-1799): the terminal escape or glitch step comes
// back out of the count, and glitched pixels and pixels that outlived the
// orbit are flagged.  The grid form computes x, y from its thread index (y
// through the global-row map P[6], P[7]); the points form reads them from two
// lists, so both form dc with the same expressions.
//
// Rounding: the JAX package's floatexp runs on XLA:CPU flush-to-zero
// (jnp.ldexp is m * 2**e there), so results below 2^-126 flush to +-0;
// frexp_fe gives jnp.frexp's (x, 0) on +-0, +-inf and NaN.  The file is built
// with -fmad=false and without fast math (no -ftz: kernels B and C keep
// subnormals), so nothing is fused and the plain torch version is bit-equal
// on the card.
//
// Bound: one pixel's dependent chain.  A step is a chain of fe add, fe mul,
// fe add, fe add on dz, then to_float, z and |z|^2 before the escape test;
// the points form runs a few hundred pixels (fe1e44's first multiref list:
// 392), one warp per SM, so the launch lasts the slowest pixel's steps times
// that chain.  The grid form (393,216 pixels) keeps the card full and is
// bound by the instructions it issues.  The design cuts both:
//  - Closed-domain floatexp ops (floatexp.cuh, shared with the fe BLA
//    kernel): a floatexp value is either (+-0, E_ZERO) or |m| in [0.5, 1)
//    with |e| <= 2^29, and there the closed ops equal the general ones with
//    fewer instructions.  The loop's values never leave that domain: dz
//    comes out of these ops, fe(2Z_n) out of frexp of a normal float or zero.
//  - A ring of orbit rows in shared memory.  The block walks the orbit in
//    chunks of one row a thread, double-buffered: row n holds fe(2Z_n),
//    Z_{n+1} = 0.5 * 2Z_{n+1} and tau^2 |Z_{n+1}|^2, so frexp runs once a row
//    in a block, not once a pixel-step.  Every thread of the block loads its
//    row of chunk c + 1 from global memory before it steps through chunk c
//    and stores it after, so the loads' latency hides behind the steps; one
//    __syncthreads_or a chunk publishes the rows and ends the loop when no
//    thread has a step left.  The loop reads its rows from shared memory a
//    step ahead, off the dependent chain, and takes two steps a pass, so the
//    second step's chain runs while the first one's exit test waits.
//  - Launch shape: the points form runs 32-thread blocks, so a list of a few
//    hundred pixels spreads one warp to an SM; the grid form 32x8 blocks.
// On an H100 at 700 W: points form 1.55 -> 0.43 ms on fe1e44's 392-pixel
// list (3.0x the latency floor of its longest pixel's chain), grid form
// 1.86 -> 0.57 ms at fe1e44 768x512.

#include <cuda_runtime.h>

#include <cmath>

#include "floatexp.cuh"

namespace {

constexpr int GRID_BX = 32, GRID_BY = 8;
constexpr int POINTS_THREADS = 32;

struct Pixel {  // one pixel's outputs before the epilogue
  float zr, zi, d;
  int cnt;
};

struct Orbit {
  const float* params;
  const float2* orbit2z;
  const float* gtol;
  int rows, n_steps, iterations;
};

struct RawRow {  // row n as read from global memory
  float2 b, b1;
  float g;
};

template <bool GLITCH>
__device__ __forceinline__ RawRow load_row(const Orbit& o, int n) {
  const int i = min(n, o.rows - 1);
  const int i1 = min(n + 1, o.rows - 1);
  return {o.orbit2z[i], o.orbit2z[i1], GLITCH ? o.gtol[i] : 0.0f};
}

__device__ __forceinline__ void store_row(Row* dst, const RawRow& r) {
  const Fe fr = fe_of(r.b.x);
  const Fe fi = fe_of(r.b.y);
  *dst = {fr.m, fi.m, 0.5f * r.b1.x, 0.5f * r.b1.y, fr.e, fi.e, r.g, 0.0f};
}

// One step from ring row r: dz becomes dz', z = Z_{n+1} + to_float(dz') and
// d = |z|^2 (+inf on a glitch).
template <bool GLITCH>
__device__ __forceinline__ void fe_step(const Row& r, const Fe& dcr_g, const Fe& dci_g, Fe& dzr,
                                        Fe& dzi, float& zr, float& zi, float& d) {
  closed_step(r, dcr_g, dci_g, dzr, dzi, zr, zi);
  d = zr * zr + zi * zi;
  if (GLITCH && d < r.gtol) d = INFINITY;  // Pauldelbrot: poison |z|^2
}

// The orbit of the pixel (x, y) of every thread of the block (R threads;
// `active` false for the threads past the image or the list, which step
// nothing but take their share of the ring).  `ring` holds 2R rows.
template <bool GLITCH, int R>
__device__ __forceinline__ Pixel fe_orbit(const float* P, float x, float y, bool active,
                                          const Orbit& o, Row* ring, int tid) {
  const float limit_sq = P[4];
  const float gain = P[5];
  const Fe ar{P[0], static_cast<int>(P[8])};
  const Fe ai{P[1], static_cast<int>(P[9])};
  // the affine mantissas lie in [0.5, 1]: the products stay in [0.25, 1)
  const Fe dcr = fe_mul(fe_of(x - P[2]), ar);
  const Fe dci = fe_mul(fe_of(y - P[3]), ai);
  // julia folds dc into dz_0 only: gain 0 makes dc_g a true zero
  const Fe dcr_g{dcr.m * gain, gain == 0.0f ? E_ZERO : dcr.e};
  const Fe dci_g{dci.m * gain, gain == 0.0f ? E_ZERO : dci.e};

  Fe dzr = dcr;
  Fe dzi = dci;
  const float2 z0 = o.orbit2z[0];
  Pixel px;
  px.zr = 0.5f * z0.x + to_float(dzr);
  px.zi = 0.5f * z0.y + to_float(dzi);
  px.d = px.zr * px.zr + px.zi * px.zi;
  px.cnt = 0;

  store_row(ring + tid, load_row<GLITCH>(o, tid));
  __syncthreads();
  for (int base = 0;; base += R) {
    const Row* rows = ring + ((base / R) & 1) * R;
    const RawRow next = load_row<GLITCH>(o, base + R + tid);
    const int end = min(base + R, o.n_steps);
    if (active && base < end && px.d <= limit_sq) {
      // two steps a pass, as kernel B's loop: the second step's chain runs
      // while the first one's exit test waits on its |z|^2
      int n = base;
      Row cur = rows[0];
      while (n + 1 < end && px.d <= limit_sq) {
        const Row second = rows[n - base + 1];
        const Row ahead = rows[min(n - base + 2, R - 1)];
        float azr, azi, ad;
        fe_step<GLITCH>(cur, dcr_g, dci_g, dzr, dzi, azr, azi, ad);
        fe_step<GLITCH>(second, dcr_g, dci_g, dzr, dzi, px.zr, px.zi, px.d);
        if (!(ad <= limit_sq)) {  // the first step escaped or glitched
          px = {azr, azi, ad, px.cnt + 1};
          break;
        }
        px.cnt += 2;
        cur = ahead;
        n += 2;
      }
      if (n < end && px.d <= limit_sq) {
        fe_step<GLITCH>(cur, dcr_g, dci_g, dzr, dzi, px.zr, px.zi, px.d);
        px.cnt += 1;
      }
    }
    store_row(ring + (((base / R) + 1) & 1) * R + tid, next);
    const bool more = active && px.d <= limit_sq && base + R < o.n_steps;
    if (!__syncthreads_or(more)) break;
  }
  return px;
}

// Epilogue (perturb.py:1792-1799).
__device__ __forceinline__ void store(const Pixel& px, const Orbit& o, float limit_sq, long i,
                                      float* zr, float* zi, int* cnt, int* gl) {
  const int escaped = px.d > limit_sq ? 1 : 0;
  const int c = px.cnt - escaped > 0 ? px.cnt - escaped : 0;
  const bool glitched = px.d == INFINITY;
  const bool ran_out = !escaped && c >= o.n_steps && o.n_steps < o.iterations;
  zr[i] = px.zr;
  zi[i] = px.zi;
  cnt[i] = c;
  gl[i] = (glitched || ran_out) ? 1 : 0;
}

template <bool GLITCH>
__global__ void __launch_bounds__(GRID_BX * GRID_BY)
    perturb_fe_full_kernel(Orbit o, int height, int width, float* __restrict__ zr,
                           float* __restrict__ zi, int* __restrict__ cnt, int* __restrict__ gl) {
  constexpr int R = GRID_BX * GRID_BY;
  __shared__ Row ring[2 * R];
  const int x = blockIdx.x * GRID_BX + threadIdx.x;
  const int y = blockIdx.y * GRID_BY + threadIdx.y;
  const bool active = x < width && y < height;
  float P[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) P[k] = o.params[k];
  const float yy = static_cast<float>(y) * P[6] + P[7];  // global-row map
  const Pixel px = fe_orbit<GLITCH, R>(P, static_cast<float>(x), yy, active, o, ring,
                                       threadIdx.y * GRID_BX + threadIdx.x);
  if (active) store(px, o, P[4], static_cast<long>(y) * width + x, zr, zi, cnt, gl);
}

template <bool GLITCH>
__global__ void __launch_bounds__(POINTS_THREADS)
    perturb_fe_points_kernel(Orbit o, const float* __restrict__ xs, const float* __restrict__ ys,
                             int k, float* __restrict__ zr, float* __restrict__ zi,
                             int* __restrict__ cnt, int* __restrict__ gl) {
  __shared__ Row ring[2 * POINTS_THREADS];
  const int i = blockIdx.x * POINTS_THREADS + threadIdx.x;
  const bool active = i < k;
  float P[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) P[j] = o.params[j];
  const Pixel px = fe_orbit<GLITCH, POINTS_THREADS>(P, active ? xs[i] : 0.0f,
                                                    active ? ys[i] : 0.0f, active, o, ring,
                                                    threadIdx.x);
  if (active) store(px, o, P[4], i, zr, zi, cnt, gl);
}

bool valid(int rows, int n_steps, int iterations, int glitch, const float* gtol) {
  return rows >= 1 && n_steps >= 0 && n_steps < rows && iterations >= 0 &&
         !(glitch && gtol == nullptr);
}

}  // namespace

// Each entry point launches on `stream` and returns cudaGetLastError() after
// the launch (cudaErrorInvalidValue for arguments the kernels do not take).

// Kernel D, grid form (glitch != 0: with the glitch test): (zr, zi, cnt, gl),
// each (height, width).
extern "C" int fractal_perturb_fe_full(const float* params, const float* orbit2z,
                                       const float* gtol, int rows, int n_steps, int iterations,
                                       int glitch, int height, int width, float* zr, float* zi,
                                       int* cnt, int* gl, void* stream) {
  if (height <= 0 || width <= 0 || !valid(rows, n_steps, iterations, glitch, gtol))
    return static_cast<int>(cudaErrorInvalidValue);
  const Orbit o{params, reinterpret_cast<const float2*>(orbit2z), gtol, rows, n_steps,
                iterations};
  dim3 block(GRID_BX, GRID_BY);
  dim3 grid((width + GRID_BX - 1) / GRID_BX, (height + GRID_BY - 1) / GRID_BY);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (glitch) {
    perturb_fe_full_kernel<true><<<grid, block, 0, s>>>(o, height, width, zr, zi, cnt, gl);
  } else {
    perturb_fe_full_kernel<false><<<grid, block, 0, s>>>(o, height, width, zr, zi, cnt, gl);
  }
  return static_cast<int>(cudaGetLastError());
}

// Kernel D, points form: the grid form's body at k pixel coordinates (xs,
// ys): (zr, zi, cnt, gl), each (k,).
extern "C" int fractal_perturb_fe_points(const float* params, const float* orbit2z,
                                         const float* gtol, int rows, int n_steps,
                                         int iterations, int glitch, const float* xs,
                                         const float* ys, int k, float* zr, float* zi, int* cnt,
                                         int* gl, void* stream) {
  if (k <= 0 || !valid(rows, n_steps, iterations, glitch, gtol))
    return static_cast<int>(cudaErrorInvalidValue);
  const Orbit o{params, reinterpret_cast<const float2*>(orbit2z), gtol, rows, n_steps,
                iterations};
  const int blocks = (k + POINTS_THREADS - 1) / POINTS_THREADS;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (glitch) {
    perturb_fe_points_kernel<true><<<blocks, POINTS_THREADS, 0, s>>>(o, xs, ys, k, zr, zi, cnt,
                                                                     gl);
  } else {
    perturb_fe_points_kernel<false><<<blocks, POINTS_THREADS, 0, s>>>(o, xs, ys, k, zr, zi,
                                                                      cnt, gl);
  }
  return static_cast<int>(cudaGetLastError());
}
