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
// one pixel and stops when it is no longer live (|z|^2 > limit^2, which a
// glitch reaches through +inf) or the orbit runs out (n >= n_steps).  The TPU
// kernel updates dz of frozen pixels too (its exponents then keep doubling
// and wrap); here a stopped thread leaves its loop, so no exponent overflows.
// The epilogue is kernel B's (perturb.py:1792-1799): the terminal escape or
// glitch step comes back out of the count, and glitched pixels and pixels
// that outlived the orbit are flagged.  The grid form computes x, y from its
// thread index (y through the global-row map P[6], P[7]); the points form
// reads them from two lists, so both form dc with the same expressions.
//
// Orbit layout as kernel B's: a (rows, 2) float table of 2 Z_n and a (rows,)
// column of tau^2 |Z_{n+1}|^2; Z is 0.5 * 2Z, an exact exponent shift.  The
// table stays in global memory at any budget (the TPU kernel's stream form
// has no counterpart).
//
// Rounding: the JAX package's floatexp runs on XLA:CPU flush-to-zero
// (jnp.ldexp is m * 2**e there), so ldexp_ftz scales the exponent field
// exactly and flushes results below 2^-126 to +-0; frexp_fe gives jnp.frexp's
// (x, 0) on +-0, +-inf and NaN.  The file is built with -fmad=false and
// without fast math (no -ftz: kernels B and C keep subnormals), so nothing is
// fused and the plain torch version is bit-equal on the card.
//
// Bound: compute.  Per live step ~120 integer and float ops (4 fe mul, 6 fe
// add, 2 fe, 2 to_float, |z|^2, the glitch compare and the loop test); the only
// global traffic in the loop is the orbit row and tolerance that all live
// threads of a warp read at the same n.  Threads of a warp that stop at
// different steps idle the rest of the warp: 32x8 blocks keep a warp on 32
// horizontally adjacent pixels.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int E_ZERO = -(1 << 30);

struct Fe {
  float m;
  int e;
};

// two's-complement int addition (the torch plain version's int32 wraps)
__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

// jnp.frexp: x = m * 2^e, |m| in [0.5, 1), for normal x; (x, 0) for +-0,
// +-inf and NaN.  (Subnormals are not a floatexp input.)
__device__ __forceinline__ Fe frexp_fe(float x) {
  const unsigned bits = __float_as_uint(x);
  const int field = static_cast<int>((bits >> 23) & 0xffu);
  if (field == 0 || field == 0xff) return {x, 0};
  return {__uint_as_float((bits & 0x807fffffu) | (126u << 23)), field - 126};
}

// m * 2^e: exact while normal, +-inf above, +-0 below 2^-126 (flush to zero).
__device__ __forceinline__ float ldexp_ftz(float m, int e) {
  const unsigned bits = __float_as_uint(m);
  const int field = static_cast<int>((bits >> 23) & 0xffu);
  if (field == 0 || field == 0xff) return m;
  const int nf = field + e;
  if (nf >= 0xff) return __uint_as_float((bits & 0x80000000u) | 0x7f800000u);
  if (nf <= 0) return __uint_as_float(bits & 0x80000000u);
  return __uint_as_float((bits & 0x807fffffu) | (static_cast<unsigned>(nf) << 23));
}

__device__ __forceinline__ Fe fe_of(float x) {
  Fe r = frexp_fe(x);
  if (r.m == 0.0f) r.e = E_ZERO;
  return r;
}

__device__ __forceinline__ float to_float(Fe a) {
  return ldexp_ftz(a.m, min(max(a.e, -200), 200));
}

__device__ __forceinline__ Fe fe_mul(Fe a, Fe b) {
  Fe r = frexp_fe(a.m * b.m);
  r.e = r.m == 0.0f ? E_ZERO : wrap_add(wrap_add(a.e, b.e), r.e);
  return r;
}

__device__ __forceinline__ Fe fe_add(Fe a, Fe b) {
  const int e = max(a.e, b.e);
  // the smaller operand shifts down; gaps past 200 bits flush to 0
  const float s = ldexp_ftz(a.m, max(wrap_add(a.e, -e), -200)) +
                  ldexp_ftz(b.m, max(wrap_add(b.e, -e), -200));
  Fe r = frexp_fe(s);
  r.e = r.m == 0.0f ? E_ZERO : wrap_add(e, r.e);
  return r;
}

__device__ __forceinline__ Fe fe_neg(Fe a) { return {-a.m, a.e}; }

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

template <bool GLITCH>
__device__ __forceinline__ Pixel fe_orbit(const float* P, float x, float y, const Orbit& o) {
  const float limit_sq = P[4];
  const float gain = P[5];
  const Fe ar{P[0], static_cast<int>(P[8])};
  const Fe ai{P[1], static_cast<int>(P[9])};
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
  for (int n = 0; n < o.n_steps && px.d <= limit_sq; ++n) {
    const float2 b = o.orbit2z[n];
    const float2 b1 = o.orbit2z[n + 1];
    const Fe tr = fe_add(fe_of(b.x), dzr);
    const Fe ti = fe_add(fe_of(b.y), dzi);
    const Fe pr = fe_add(fe_mul(tr, dzr), fe_neg(fe_mul(ti, dzi)));
    const Fe pi = fe_add(fe_mul(tr, dzi), fe_mul(ti, dzr));
    const Fe ndzr = fe_add(pr, dcr_g);
    const Fe ndzi = fe_add(pi, dci_g);
    const float nzfr = 0.5f * b1.x + to_float(ndzr);
    const float nzfi = 0.5f * b1.y + to_float(ndzi);
    float nd = nzfr * nzfr + nzfi * nzfi;
    if (GLITCH && nd < o.gtol[n]) nd = INFINITY;  // Pauldelbrot: poison |z|^2
    px.zr = nzfr;
    px.zi = nzfi;
    px.d = nd;
    px.cnt += 1;
    dzr = ndzr;
    dzi = ndzi;
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
__global__ void perturb_fe_full_kernel(Orbit o, int height, int width, float* __restrict__ zr,
                                       float* __restrict__ zi, int* __restrict__ cnt,
                                       int* __restrict__ gl) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= width || y >= height) return;
  float P[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) P[k] = o.params[k];
  const float yy = static_cast<float>(y) * P[6] + P[7];  // global-row map
  const Pixel px = fe_orbit<GLITCH>(P, static_cast<float>(x), yy, o);
  store(px, o, P[4], static_cast<long>(y) * width + x, zr, zi, cnt, gl);
}

template <bool GLITCH>
__global__ void perturb_fe_points_kernel(Orbit o, const float* __restrict__ xs,
                                         const float* __restrict__ ys, int k,
                                         float* __restrict__ zr, float* __restrict__ zi,
                                         int* __restrict__ cnt, int* __restrict__ gl) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= k) return;
  float P[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) P[j] = o.params[j];
  const Pixel px = fe_orbit<GLITCH>(P, xs[i], ys[i], o);
  store(px, o, P[4], i, zr, zi, cnt, gl);
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
  dim3 block(32, 8);
  dim3 grid((width + block.x - 1) / block.x, (height + block.y - 1) / block.y);
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
  const int threads = 128;
  const int blocks = (k + threads - 1) / threads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (glitch) {
    perturb_fe_points_kernel<true><<<blocks, threads, 0, s>>>(o, xs, ys, k, zr, zi, cnt, gl);
  } else {
    perturb_fe_points_kernel<false><<<blocks, threads, 0, s>>>(o, xs, ys, k, zr, zi, cnt, gl);
  }
  return static_cast<int>(cudaGetLastError());
}
