// delta-orbit kernels B (grid), C (points) and E (packed orbit): the
// perturbation tiers' per-pixel loop.
//
// Replaces fractal_tpu/ops/perturb.py::perturb_pallas_v2 (kernel B, body
// _build_pert_kernel_v2) in its dist-only, full and glitch forms, and
// perturb.py::perturb_pallas_v2_points (kernel C, the same body with dc given
// per pixel), for every delta-recurrence the reference carries:
//
//   quadratic (mandelbrot, julia)  dz' = (2Z + dz) * dz + dc   (julia: no + dc)
//   burning ship                   quadratic real part; imaginary part by
//                                  diffabs(Z_r Z_i, x), every product pinned
//                                  through a traced 1.0 (perturb.py:1342-1364)
//   tricorn                        quadratic real part; -2(Z_r dz_i + Z_i dz_r
//                                  + dz_r dz_i) + dc
//   z^d (multibrot, julia d >= 3)  binomial Horner in dz with coefficients
//                                  C(d, j) Z^(d-j) (perturb.py:1381-1405)
//
// then z = Z_{n+1} + dz' and the escape test on |z|^2.  Each thread owns one
// pixel: it starts at exactly n0 = P[8] with the cubic series start
// (perturb.py:1262-1270) and stops when the pixel is no longer live
// (|z|^2 > limit^2, which a glitch reaches by poisoning |z|^2 to +inf) or the
// orbit runs out (n >= n_steps).  The TPU kernel runs 32x128 tiles in
// lock-step from the chunk n0 / chunk; a pixel's steps depend only on its own
// state and n, so the results are the same.  The full form carries the frozen
// z (the two freeze selects of perturb.py:1414-1419 become the last update
// before the loop ends); the glitch form sets |z|^2 to +inf when it falls
// below tau^2 |Z_{n+1}|^2 (perturb.py:1409-1413).  The epilogue takes the
// terminal escape or glitch step back out of the count and flags glitched
// pixels (|z|^2 == inf) and pixels that outlived the orbit
// (perturb.py:1444-1455); the latter needs the iteration budget.
//
// Orbit layout: a (rows, 2) float table of 2 Z_n (one float2 per row) and,
// for the glitch form, a (rows,) float column of tau^2 |Z_{n+1}|^2.  Z is
// recovered as 0.5 * 2Z, an exact exponent shift.
//
// Bound: the instructions a step issues, at full occupancy (the grid
// forms), and one pixel's dependent chain (kernel C's few-thousand-pixel
// lists).  Per step ~17 unfused ops (quadratic; burning ship ~30, tricorn
// ~19, z^3 ~35) plus the glitch compare; the only global traffic in the loop
// is the orbit row (and tolerance) that all live threads of a warp read at
// the same n, one broadcast that hits L1.  The loop takes two steps a pass:
// each row is read once and carried into the next step (the glitch form
// reads two rows and two tolerances a pass, 2 loads a step where it read 3;
// the dist-only form 1 where it read 2), the bound test and the count are
// paid once a pass, and the second step's arithmetic issues while the first
// step's exit test waits on its |z|^2 (dz1e12's glitch form: 15.9 -> 14.6
// ms on an H100 at 700 W, under twice its operation bound).  Pixels of one warp that stop at different steps idle
// the rest of the warp (divergence): the grid kernels use 32x8 blocks so a
// warp holds 32 horizontally adjacent pixels, whose counts are close
// (utils/divergence.py measures the warp efficiency from a launch's counts);
// kernel C's flagged pixels come in raster order.  The TPU's VMEM cap on the
// lane-replicated planes has no counterpart: the table stays in global
// memory at any budget, so one kernel covers the reference's resident and
// stream forms.
//
// Kernel E replaces perturb.py::perturb_pallas (body _build_pert_kernel over
// _perturb_tile with power 2 and the mandelbrot/julia rule): the quadratic
// delta-orbit against the (rows, 8) packed orbit [Z_n, Z_{n+1},
// tau^2 |Z_{n+1}|^2, 0, 0, 0], one 32-byte row per step, with 2 Z_n formed in
// the loop and dc scaled by the gain P[5] (0 for julia).  Its tile state
// (live only while cnt == n and no glitch flag is set) is the per-thread loop
// with two exits: the escape step leaves z updated and the count as it was,
// the glitch step (|z|^2 < tau^2 |Z_{n+1}|^2 on a step that did not escape)
// sets the flag.  It differs from kernel B's glitch form in where 2Z and Z
// are formed (both exact) and in giving the escape test precedence over the
// glitch test.
//
// Rounding: the expressions follow perturb.py:1342-1413 operation for
// operation (the burning-ship pin and the where-chain's comparison order
// included).  The file is compiled with -fmad=false and without fast math,
// so nothing is fused, subnormals are kept and d == inf stays a real test;
// the plain torch versions (fractal_tpu_torch/ops/perturb_cuda.py) are then
// bit-equal on the card.

#include <cuda_runtime.h>

#include <cmath>
#include <type_traits>

namespace {

constexpr int RULE_SQUARE = 0;
constexpr int RULE_BURNINGSHIP = 1;
constexpr int RULE_TRICORN = 2;
constexpr int RULE_POWER = 3;

template <int V>
using IntC = std::integral_constant<int, V>;
using True = std::true_type;
using False = std::false_type;

struct Pixel {  // one pixel's outputs before the epilogue
  float zr, zi, d;
  int cnt;
};

// dz' from dz, the row's 2Z (b) and Z (hb = 0.5 b), perturb.py:1342-1405.
template <int RULE, bool JULIA>
__device__ __forceinline__ void delta_step(float br, float bi, float dzr, float dzi,
                                           float dcr, float dci, float pin, int power,
                                           float& ndzr, float& ndzi) {
  const float hbr = 0.5f * br;
  const float hbi = 0.5f * bi;
  if constexpr (RULE == RULE_BURNINGSHIP) {
    ndzr = ((br + dzr) * dzr) * pin - ((bi + dzi) * dzi) * pin + dcr * pin;
    const float X = hbr * hbi;
    const float x = (hbr * dzi) * pin + (hbi * dzr) * pin + (dzr * dzi) * pin;
    const float nx = -x;
    float s;
    if (X >= 0.0f) {
      s = X >= nx ? x : -(2.0f * X + x);
    } else {
      s = X <= nx ? -x : 2.0f * X + x;
    }
    ndzi = (2.0f * s) * pin + dci * pin;
  } else if constexpr (RULE == RULE_TRICORN) {
    ndzr = (br + dzr) * dzr - (bi + dzi) * dzi + dcr;
    ndzi = -2.0f * (hbr * dzi + hbi * dzr + dzr * dzi) + dci;
  } else if constexpr (RULE == RULE_SQUARE) {
    const float tr = br + dzr;
    const float t2 = bi + dzi;
    if (JULIA) {
      ndzr = tr * dzr - t2 * dzi;
      ndzi = tr * dzi + t2 * dzr;
    } else {
      ndzr = tr * dzr - t2 * dzi + dcr;
      ndzi = tr * dzi + t2 * dzr + dci;
    }
  } else {
    // Horner over sum_k C(d,k) Z^(d-k) dz^k: for j = d-1 .. 1 the
    // coefficient is C(d,j) Z^(d-j), so Z's power rises by one per pass
    // (the zp list of perturb.py:1387-1390, built in the same order).
    float accr = 1.0f, acci = 0.0f;
    float pr = hbr, pi = hbi;  // Z^(d-j)
    double cj = 1.0;           // C(d, j), exact in double
    for (int j = power - 1; j >= 1; --j) {
      cj = cj * static_cast<double>(j + 1) / static_cast<double>(power - j);
      const float c = static_cast<float>(cj);
      const float tr = accr * dzr - acci * dzi + c * pr;
      const float ti = accr * dzi + acci * dzr + c * pi;
      accr = tr;
      acci = ti;
      if (j > 1) {
        const float npr = pr * hbr - pi * hbi;
        const float npi = pr * hbi + pi * hbr;
        pr = npr;
        pi = npi;
      }
    }
    if (JULIA) {
      ndzr = accr * dzr - acci * dzi;
      ndzi = accr * dzi + acci * dzr;
    } else {
      ndzr = accr * dzr - acci * dzi + dcr;
      ndzi = accr * dzi + acci * dzr + dci;
    }
  }
}

// One step from row n (2Z_n = b, 2Z_{n+1} = b1, tolerance g): dz becomes
// dz', (zr, zi) z = Z_{n+1} + dz' and d |z|^2 (+inf on a glitch).
template <int RULE, bool JULIA, bool GLITCH>
__device__ __forceinline__ void one_step(float2 b, float2 b1, float g, float dcr, float dci,
                                         float pin, int power, float& dzr, float& dzi,
                                         float& zr, float& zi, float& d) {
  float ndzr, ndzi;
  delta_step<RULE, JULIA>(b.x, b.y, dzr, dzi, dcr, dci, pin, power, ndzr, ndzi);
  zr = 0.5f * b1.x + ndzr;
  zi = 0.5f * b1.y + ndzi;
  d = zr * zr + zi * zi;
  if (GLITCH && d < g) d = INFINITY;  // Pauldelbrot: poison |z|^2
  dzr = ndzr;
  dzi = ndzi;
}

// One pixel's delta orbit from its dc: the frozen z, |z|^2 and the count
// with the terminal step still in it.  The loop takes two steps a pass: row
// n comes in from the pass before, rows n+1 and n+2 (and tolerances n, n+1)
// are read, and the bound test and the count are paid once.  The second
// step is computed before the first one's exit test, off its chain, and is
// dropped when the first step leaves: the result is the step-by-step loop's.
template <int RULE, bool JULIA, bool GLITCH>
__device__ __forceinline__ Pixel delta_orbit(const float* P, float dcr, float dci,
                                             const float2* __restrict__ orbit2z,
                                             const float* __restrict__ gtol, int rows,
                                             int n_steps, int power) {
  const float limit_sq = P[4];
  // series start: dz_n0 = A'u + B'u^2 + C'u^3, u = dc / dc_max (Horner)
  int n0 = static_cast<int>(P[8]);
  n0 = n0 < 0 ? 0 : (n0 > rows - 1 ? rows - 1 : n0);
  const float ur = dcr * P[15];
  const float ui = dci * P[15];
  const float t1r = P[13] * ur - P[14] * ui + P[11];
  const float t1i = P[13] * ui + P[14] * ur + P[12];
  const float t2r = t1r * ur - t1i * ui + P[9];
  const float t2i = t1r * ui + t1i * ur + P[10];
  float dzr = t2r * ur - t2i * ui;
  float dzi = t2r * ui + t2i * ur;
  const float pin = P[15] * 0.0f + 1.0f;  // the traced 1.0 of perturb.py:1351

  float2 zn = orbit2z[n0];
  Pixel px;
  px.zr = 0.5f * zn.x + dzr;
  px.zi = 0.5f * zn.y + dzi;
  px.d = px.zr * px.zr + px.zi * px.zi;
  px.cnt = n0;
  int n = n0;
  while (n + 1 < n_steps && px.d <= limit_sq) {
    const float2 zn1 = orbit2z[n + 1];
    const float2 zn2 = orbit2z[n + 2];
    const float g0 = GLITCH ? gtol[n] : 0.0f;
    const float g1 = GLITCH ? gtol[n + 1] : 0.0f;
    float azr, azi, ad, bzr, bzi, bd;
    one_step<RULE, JULIA, GLITCH>(zn, zn1, g0, dcr, dci, pin, power, dzr, dzi, azr, azi, ad);
    one_step<RULE, JULIA, GLITCH>(zn1, zn2, g1, dcr, dci, pin, power, dzr, dzi, bzr, bzi, bd);
    if (!(ad <= limit_sq)) {  // the first step escaped or glitched
      return {azr, azi, ad, px.cnt + 1};
    }
    px = {bzr, bzi, bd, px.cnt + 2};
    zn = zn2;
    n += 2;
  }
  if (n < n_steps && px.d <= limit_sq) {
    one_step<RULE, JULIA, GLITCH>(zn, orbit2z[n + 1], GLITCH ? gtol[n] : 0.0f, dcr, dci, pin,
                                  power, dzr, dzi, px.zr, px.zi, px.d);
    px.cnt += 1;
  }
  return px;
}

struct Orbit {
  const float* params;
  const float2* orbit2z;
  const float* gtol;
  int rows, n_steps, iterations, power;
};

// Epilogue of the full form (perturb.py:1444-1455).
__device__ __forceinline__ void store_full(const Pixel& px, const Orbit& o, float limit_sq,
                                           long i, float* zr, float* zi, int* cnt, int* gl) {
  const int escaped = px.d > limit_sq ? 1 : 0;
  const int c = px.cnt - escaped > 0 ? px.cnt - escaped : 0;
  const bool glitched = px.d == INFINITY;
  const bool ran_out = !escaped && c >= o.n_steps && o.n_steps < o.iterations;
  zr[i] = px.zr;
  zi[i] = px.zi;
  cnt[i] = c;
  gl[i] = (glitched || ran_out) ? 1 : 0;
}

__device__ __forceinline__ void grid_dc(const float* P, int x, int y, float& dcr, float& dci) {
  const float xx = static_cast<float>(x);
  const float yy = static_cast<float>(y) * P[6] + P[7];  // global-row map
  dcr = (xx - P[2]) * P[0];
  dci = (yy - P[3]) * P[1];
}

template <int RULE, bool JULIA>
__global__ void perturb_dist_kernel(Orbit o, int height, int width, float* __restrict__ d_out,
                                    int* __restrict__ cnt_out) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= width || y >= height) return;
  float P[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) P[k] = o.params[k];
  float dcr, dci;
  grid_dc(P, x, y, dcr, dci);
  const Pixel px = delta_orbit<RULE, JULIA, false>(P, dcr, dci, o.orbit2z, o.gtol, o.rows,
                                                   o.n_steps, o.power);
  const int escaped = px.d > P[4] ? 1 : 0;
  const long i = static_cast<long>(y) * width + x;
  d_out[i] = px.d;
  cnt_out[i] = px.cnt - escaped > 0 ? px.cnt - escaped : 0;
}

template <int RULE, bool JULIA, bool GLITCH>
__global__ void perturb_full_kernel(Orbit o, int height, int width, float* __restrict__ zr,
                                    float* __restrict__ zi, int* __restrict__ cnt,
                                    int* __restrict__ gl) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= width || y >= height) return;
  float P[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) P[k] = o.params[k];
  float dcr, dci;
  grid_dc(P, x, y, dcr, dci);
  const Pixel px = delta_orbit<RULE, JULIA, GLITCH>(P, dcr, dci, o.orbit2z, o.gtol, o.rows,
                                                    o.n_steps, o.power);
  store_full(px, o, P[4], static_cast<long>(y) * width + x, zr, zi, cnt, gl);
}

template <int RULE, bool JULIA, bool GLITCH>
__global__ void perturb_points_kernel(Orbit o, const float* __restrict__ dcr_in,
                                      const float* __restrict__ dci_in, int k,
                                      float* __restrict__ zr, float* __restrict__ zi,
                                      int* __restrict__ cnt, int* __restrict__ gl) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= k) return;
  float P[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) P[j] = o.params[j];
  const Pixel px = delta_orbit<RULE, JULIA, GLITCH>(P, dcr_in[i], dci_in[i], o.orbit2z, o.gtol,
                                                    o.rows, o.n_steps, o.power);
  store_full(px, o, P[4], i, zr, zi, cnt, gl);
}

// Kernel E: one pixel per thread over the packed orbit (perturb.py:402-551).
__global__ void perturb_packed_kernel(const float* __restrict__ params,
                                      const float4* __restrict__ packed, int rows, int n_steps,
                                      int iterations, int height, int width,
                                      float* __restrict__ zr, float* __restrict__ zi,
                                      int* __restrict__ cnt_out, int* __restrict__ gl_out) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= width || y >= height) return;
  float P[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) P[k] = params[k];
  const float limit_sq = P[4];
  float dcr, dci;
  grid_dc(P, x, y, dcr, dci);
  // series start (perturb.py:1075-1086)
  int n0 = static_cast<int>(P[8]);
  n0 = n0 < 0 ? 0 : (n0 > rows - 1 ? rows - 1 : n0);
  const float ur = dcr * P[15];
  const float ui = dci * P[15];
  const float t1r = P[13] * ur - P[14] * ui + P[11];
  const float t1i = P[13] * ui + P[14] * ur + P[12];
  const float t2r = t1r * ur - t1i * ui + P[9];
  const float t2i = t1r * ui + t1i * ur + P[10];
  float dzr = t2r * ur - t2i * ui;
  float dzi = t2r * ui + t2i * ur;
  const float gcr = dcr * P[5];
  const float gci = dci * P[5];

  const float4 first = packed[2 * static_cast<long>(n0)];
  float zfr = first.x + dzr;
  float zfi = first.y + dzi;
  int cnt = n0;
  int gl = 0;
  for (int n = n0; n < n_steps && zfr * zfr + zfi * zfi <= limit_sq; ++n) {
    const float4 row = packed[2 * static_cast<long>(n)];       // Z_n, Z_{n+1}
    const float gtol = packed[2 * static_cast<long>(n) + 1].x;  // tau^2 |Z_{n+1}|^2
    const float tr = 2.0f * row.x + dzr;
    const float ti = 2.0f * row.y + dzi;
    const float ndzr = tr * dzr - ti * dzi + gcr;
    const float ndzi = tr * dzi + ti * dzr + gci;
    zfr = row.z + ndzr;
    zfi = row.w + ndzi;
    dzr = ndzr;
    dzi = ndzi;
    const float d = zfr * zfr + zfi * zfi;
    if (d > limit_sq) break;  // the escape step is not counted
    if (d < gtol) {
      gl = 1;
      break;
    }
    cnt += 1;
  }
  const bool ran_out =
      zfr * zfr + zfi * zfi <= limit_sq && cnt >= n_steps && n_steps < iterations;
  const long i = static_cast<long>(y) * width + x;
  zr[i] = zfr;
  zi[i] = zfi;
  cnt_out[i] = cnt;
  gl_out[i] = (gl || ran_out) ? 1 : 0;
}

// Calls f(rule, julia) with compile-time constants; burning ship and tricorn
// have no julia form (perturb_supported sends julia only to z^d).
template <typename F>
bool by_rule(int rule, bool julia, F&& f) {
  switch (rule) {
    case RULE_SQUARE: julia ? f(IntC<RULE_SQUARE>{}, True{}) : f(IntC<RULE_SQUARE>{}, False{});
      return true;
    case RULE_POWER: julia ? f(IntC<RULE_POWER>{}, True{}) : f(IntC<RULE_POWER>{}, False{});
      return true;
    case RULE_BURNINGSHIP: if (julia) return false;
      f(IntC<RULE_BURNINGSHIP>{}, False{});
      return true;
    case RULE_TRICORN: if (julia) return false;
      f(IntC<RULE_TRICORN>{}, False{});
      return true;
    default: return false;
  }
}

bool valid(int rows, int n_steps, int power, int rule) {
  return rows >= 1 && n_steps >= 0 && n_steps < rows && (rule != RULE_POWER || power >= 3);
}

}  // namespace

// Each entry point launches on `stream` and returns cudaGetLastError() after
// the launch (cudaErrorInvalidValue for arguments the kernels do not take).

// Kernel B, dist-only form: (d, cnt), each (height, width).
extern "C" int fractal_perturb_dist(const float* params, const float* orbit2z, int rows,
                                    int n_steps, int rule, int julia, int power, int height,
                                    int width, float* d, int* cnt, void* stream) {
  if (height <= 0 || width <= 0 || !valid(rows, n_steps, power, rule))
    return static_cast<int>(cudaErrorInvalidValue);
  const Orbit o{params, reinterpret_cast<const float2*>(orbit2z), nullptr, rows, n_steps, 0,
                power};
  dim3 block(32, 8);
  dim3 grid((width + block.x - 1) / block.x, (height + block.y - 1) / block.y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool ok = by_rule(rule, julia != 0, [&](auto r, auto j) {
    perturb_dist_kernel<decltype(r)::value, decltype(j)::value>
        <<<grid, block, 0, s>>>(o, height, width, d, cnt);
  });
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// Kernel B, full form (glitch != 0: the glitch form): (zr, zi, cnt, gl).
extern "C" int fractal_perturb_full(const float* params, const float* orbit2z, const float* gtol,
                                    int rows, int n_steps, int iterations, int rule, int julia,
                                    int glitch, int power, int height, int width, float* zr,
                                    float* zi, int* cnt, int* gl, void* stream) {
  if (height <= 0 || width <= 0 || iterations < 0 || !valid(rows, n_steps, power, rule) ||
      (glitch && gtol == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Orbit o{params, reinterpret_cast<const float2*>(orbit2z), gtol, rows, n_steps,
                iterations, power};
  dim3 block(32, 8);
  dim3 grid((width + block.x - 1) / block.x, (height + block.y - 1) / block.y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool ok = by_rule(rule, julia != 0, [&](auto r, auto j) {
    constexpr int R = decltype(r)::value;
    constexpr bool J = decltype(j)::value;
    if (glitch) {
      perturb_full_kernel<R, J, true><<<grid, block, 0, s>>>(o, height, width, zr, zi, cnt, gl);
    } else {
      perturb_full_kernel<R, J, false><<<grid, block, 0, s>>>(o, height, width, zr, zi, cnt, gl);
    }
  });
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// Kernel C: kernel B's body over k pixels with dc given per pixel: (zr, zi,
// cnt, gl), each (k,).
extern "C" int fractal_perturb_points(const float* params, const float* orbit2z,
                                      const float* gtol, int rows, int n_steps, int iterations,
                                      int rule, int julia, int glitch, int power,
                                      const float* dcr, const float* dci, int k, float* zr,
                                      float* zi, int* cnt, int* gl, void* stream) {
  if (k <= 0 || iterations < 0 || !valid(rows, n_steps, power, rule) ||
      (glitch && gtol == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Orbit o{params, reinterpret_cast<const float2*>(orbit2z), gtol, rows, n_steps,
                iterations, power};
  const int threads = 128;
  const int blocks = (k + threads - 1) / threads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool ok = by_rule(rule, julia != 0, [&](auto r, auto j) {
    constexpr int R = decltype(r)::value;
    constexpr bool J = decltype(j)::value;
    if (glitch) {
      perturb_points_kernel<R, J, true>
          <<<blocks, threads, 0, s>>>(o, dcr, dci, k, zr, zi, cnt, gl);
    } else {
      perturb_points_kernel<R, J, false>
          <<<blocks, threads, 0, s>>>(o, dcr, dci, k, zr, zi, cnt, gl);
    }
  });
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// Kernel E: the quadratic delta-orbit over the (rows, 8) packed orbit:
// (zr, zi, cnt, gl), each (height, width).
extern "C" int fractal_perturb_packed(const float* params, const float* packed, int rows,
                                      int n_steps, int iterations, int height, int width,
                                      float* zr, float* zi, int* cnt, int* gl, void* stream) {
  if (height <= 0 || width <= 0 || iterations < 0 || !valid(rows, n_steps, 2, RULE_SQUARE))
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 block(32, 8);
  dim3 grid((width + block.x - 1) / block.x, (height + block.y - 1) / block.y);
  perturb_packed_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      params, reinterpret_cast<const float4*>(packed), rows, n_steps, iterations, height, width,
      zr, zi, cnt, gl);
  return static_cast<int>(cudaGetLastError());
}
