// delta-orbit kernels B (grid), C (points) and E (packed orbit): the
// perturbation tiers' per-pixel loop.
//
// Replaces fractal_tpu/ops/perturb.py::perturb_pallas_v2 (kernel B, body
// _build_pert_kernel_v2) in its dist-only, full and glitch forms, and
// perturb.py::perturb_pallas_v2_points (kernel C, the same steps with dc
// given per pixel, in a loop of its own below), for every delta-recurrence
// the reference carries:
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
// forms), and one warp's issue and dependent chain (kernel C's
// few-thousand-pixel lists, whose loop is described at its kernel).  Per step ~17 unfused ops (quadratic; burning ship ~30, tricorn
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
// (utils/divergence.py measures the warp efficiency from a launch's counts).
// The TPU's VMEM cap on the lane-replicated planes has no counterpart: the
// grid forms read the table from global memory and kernel C streams it
// through shared memory, at any budget, so one kernel a form covers the
// reference's resident and stream forms.
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

#include <cuda_pipeline.h>
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

// Kernel C's own loop.  A list of a few thousand pixels runs about one warp
// a scheduler, so nothing hides a stall of the one warp: the kernel's time is
// the longest pixel's warp, its chain and its issue.  B's loop, which C ran
// before it had its own, waits at every pass for its orbit rows from global
// memory: 156 cycles a step for the longest pixel of dz1e12's first list
// alone (H100, PERF.md).  Here the block copies the orbit from n0 on (2Z_n
// and tau^2 |Z_{n+1}|^2, 12 B a row) into shared memory with cp.async; each
// thread fetches the rows of the pass after next into registers, so no load
// sits on a step's chain; and the loop computes the next pass before it tests
// the current one, so the test's branch waits on |z|^2 of a pass computed an
// iteration earlier and the chain from pass to pass is dz' alone (a pass past
// the pixel's exit is computed and dropped).  An iteration takes two passes,
// their registers swapping roles, which saves most register copies: ~58
// instructions a pass (sass), ~54 cycles a step for that pixel alone.  A
// scheduler that holds two of the list's warps issues for both (137 blocks of
// 4 warps on 132 SMs): the list takes ~1.4 times its longest pixel.  The copy
// is a chunk of `chunk` rows plus POINTS_AHEAD rows of the next chunk (what a
// chunk's last passes read ahead): the whole table in one chunk where the
// list's blocks fit the card with it (nbuf 1, no barrier in the loop), else a
// double-buffered ring of even chunks, the next one copied while this one
// steps, one __syncthreads_or a chunk publishing it and ending the loop
// (perturb_cuda.points_plan decides; points_ring_plain is its plain mirror).
// The steps, and a pass's exits, are delta_orbit's, so the results are too.
constexpr int POINTS_THREADS = 128;
constexpr int POINTS_AHEAD = 8;

template <bool GLITCH>
__device__ __forceinline__ void copy_rows(const Orbit& o, int base, int count, float2* z2,
                                          float* g) {
  for (int j = threadIdx.x; j < count; j += POINTS_THREADS) {
    const int r = min(base + j, o.rows - 1);  // rows past the table are never stepped
    __pipeline_memcpy_async(z2 + j, o.orbit2z + r, sizeof(float2));
    if (GLITCH) __pipeline_memcpy_async(g + j, o.gtol + r, sizeof(float));
  }
  __pipeline_commit();
}

struct PassRows {  // what the pass at n reads: 2Z_n, 2Z_{n+1}, 2Z_{n+2}, tolerances n, n+1
  float2 z0, z1, z2;
  float g0, g1;
};

struct Pass {  // z and |z|^2 after the pass's first (a) and second (b) step
  float azr, azi, ad, bzr, bzi, bd;
};

template <int RULE, bool JULIA, bool GLITCH>
__device__ __forceinline__ Pass run_pass(const PassRows& r, float dcr, float dci, float pin,
                                         int power, float& dzr, float& dzi) {
  Pass p;
  one_step<RULE, JULIA, GLITCH>(r.z0, r.z1, r.g0, dcr, dci, pin, power, dzr, dzi, p.azr, p.azi,
                                p.ad);
  one_step<RULE, JULIA, GLITCH>(r.z1, r.z2, r.g1, dcr, dci, pin, power, dzr, dzi, p.bzr, p.bzi,
                                p.bd);
  return p;
}

template <bool GLITCH>
__device__ __forceinline__ PassRows pass_rows(const float2* zb, const float* gb, int j) {
  return {zb[j], zb[j + 1], zb[j + 2], GLITCH ? gb[j] : 0.0f, GLITCH ? gb[j + 1] : 0.0f};
}

template <int RULE, bool JULIA, bool GLITCH>
__global__ void __launch_bounds__(POINTS_THREADS)
    perturb_points_kernel(Orbit o, const float* __restrict__ dcr_in,
                          const float* __restrict__ dci_in, int k, int chunk, int nbuf,
                          float* __restrict__ zr, float* __restrict__ zi, int* __restrict__ cnt,
                          int* __restrict__ gl) {
  extern __shared__ float2 ring2z[];  // [nbuf][L] rows of 2Z, then [nbuf][L] tolerances
  const int L = chunk + POINTS_AHEAD;
  float* ring_g = reinterpret_cast<float*>(ring2z + nbuf * L);
  const int i = blockIdx.x * POINTS_THREADS + threadIdx.x;
  const bool active = i < k;
  float P[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) P[j] = o.params[j];
  const float limit_sq = P[4];
  int n0 = static_cast<int>(P[8]);
  n0 = n0 < 0 ? 0 : (n0 > o.rows - 1 ? o.rows - 1 : n0);
  // rows base .. n_steps are all a result can read (at least 3: the start)
  auto rows_of = [&](int base) { return min(L, max(3, o.n_steps + 1 - base)); };
  copy_rows<GLITCH>(o, n0, rows_of(n0), ring2z, ring_g);

  const float dcr = active ? dcr_in[i] : 0.0f;
  const float dci = active ? dci_in[i] : 0.0f;
  // series start, as delta_orbit
  const float ur = dcr * P[15];
  const float ui = dci * P[15];
  const float t1r = P[13] * ur - P[14] * ui + P[11];
  const float t1i = P[13] * ui + P[14] * ur + P[12];
  const float t2r = t1r * ur - t1i * ui + P[9];
  const float t2i = t1r * ui + t1i * ur + P[10];
  float dzr = t2r * ur - t2i * ui;
  float dzi = t2r * ui + t2i * ur;
  const float pin = P[15] * 0.0f + 1.0f;
  __pipeline_wait_prior(0);
  __syncthreads();

  Pixel px;
  px.zr = 0.5f * ring2z[0].x + dzr;
  px.zi = 0.5f * ring2z[0].y + dzi;
  px.d = px.zr * px.zr + px.zi * px.zi;
  px.cnt = n0;
  bool live = active && px.d <= limit_sq;
  int n = n0;
  // cur: the pass at n, computed (dz is now at n + 2); nxt: the rows of the
  // pass at n + 2; ahead, after: the same one pass further
  Pass cur = run_pass<RULE, JULIA, GLITCH>(pass_rows<GLITCH>(ring2z, ring_g, 0), dcr, dci, pin,
                                           o.power, dzr, dzi);
  PassRows nxt = pass_rows<GLITCH>(ring2z, ring_g, 2);
  Pass ahead = cur;
  PassRows after = nxt;
  for (int base = n0, c = 0;; base += chunk, ++c) {
    const int buf = nbuf == 2 ? (c & 1) : 0;
    const float2* zb = ring2z + buf * L;
    const float* gb = ring_g + buf * L;
    const bool more = base + chunk < o.n_steps;  // the same in every thread
    if (more) copy_rows<GLITCH>(o, base + chunk, rows_of(base + chunk), ring2z + (buf ^ 1) * L,
                                ring_g + (buf ^ 1) * L);
    const int end = min(base + chunk, o.n_steps);
    // two passes an iteration, the roles of (p0, q0) and (p1, q1) swapping,
    // so no pass or row is copied from register to register on the way
    Pass p0 = cur, p1;
    PassRows q0 = nxt, q1;
    while (live) {
      int j = n - base;
      p1 = run_pass<RULE, JULIA, GLITCH>(q0, dcr, dci, pin, o.power, dzr, dzi);
      q1 = {q0.z2, zb[j + 5], zb[j + 6], GLITCH ? gb[j + 4] : 0.0f, GLITCH ? gb[j + 5] : 0.0f};
      if (!(p0.ad <= limit_sq && p0.bd <= limit_sq && n + 3 < end)) {
        cur = p0;
        ahead = p1;
        nxt = q0;
        after = q1;
        break;
      }
      n += 2;
      j += 2;
      p0 = run_pass<RULE, JULIA, GLITCH>(q1, dcr, dci, pin, o.power, dzr, dzi);
      q0 = {q1.z2, zb[j + 5], zb[j + 6], GLITCH ? gb[j + 4] : 0.0f, GLITCH ? gb[j + 5] : 0.0f};
      if (!(p1.ad <= limit_sq && p1.bd <= limit_sq && n + 3 < end)) {
        cur = p1;
        ahead = p0;
        nxt = q1;
        after = q0;
        break;
      }
      n += 2;
    }
    if (live) {  // the loop stopped at cur, the pass at n
      if (n + 1 < end && !(cur.ad <= limit_sq)) {  // its first step escaped or glitched
        px = {cur.azr, cur.azi, cur.ad, n + 1};
        live = false;
      } else if (n + 1 < end) {  // both steps stand
        px = {cur.bzr, cur.bzi, cur.bd, n + 2};
        live = cur.bd <= limit_sq;
        n += 2;
        cur = ahead;
        nxt = after;
      }
      if (live && n < end) {  // the single last step (end == n_steps here)
        px = {cur.azr, cur.azi, cur.ad, n + 1};
        live = false;
      }
    }
    if (nbuf == 1) break;
    __pipeline_wait_prior(0);
    if (!__syncthreads_or(live && more)) break;
  }
  if (active) store_full(px, o, limit_sq, i, zr, zi, cnt, gl);
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

// Kernel C: kernel B's steps over k pixels with dc given per pixel, the
// orbit in shared memory in chunks of `chunk` rows (nbuf 1: the whole table
// in one chunk; 2: a ring; perturb_cuda.points_plan): (zr, zi, cnt, gl),
// each (k,).
extern "C" int fractal_perturb_points(const float* params, const float* orbit2z,
                                      const float* gtol, int rows, int n_steps, int iterations,
                                      int rule, int julia, int glitch, int power,
                                      const float* dcr, const float* dci, int k, int chunk,
                                      int nbuf, float* zr, float* zi, int* cnt, int* gl,
                                      void* stream) {
  if (k <= 0 || iterations < 0 || !valid(rows, n_steps, power, rule) ||
      (glitch && gtol == nullptr) || !(nbuf == 1 || nbuf == 2) ||
      (nbuf == 1 ? chunk < n_steps : (chunk < 2 || chunk % 2 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Orbit o{params, reinterpret_cast<const float2*>(orbit2z), gtol, rows, n_steps,
                iterations, power};
  const size_t smem = static_cast<size_t>(nbuf) * (chunk + POINTS_AHEAD) *
                      (sizeof(float2) + (glitch ? sizeof(float) : 0));
  const int blocks = (k + POINTS_THREADS - 1) / POINTS_THREADS;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  bool ok = by_rule(rule, julia != 0, [&](auto r, auto j) {
    constexpr int R = decltype(r)::value;
    constexpr bool J = decltype(j)::value;
    auto launch = [&](auto kernel) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err == cudaSuccess)
        kernel<<<blocks, POINTS_THREADS, smem, s>>>(o, dcr, dci, k, chunk, nbuf, zr, zi, cnt,
                                                    gl);
    };
    if (glitch) {
      launch(perturb_points_kernel<R, J, true>);
    } else {
      launch(perturb_points_kernel<R, J, false>);
    }
  });
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Kernel C's launch shape, which perturb_cuda.points_plan sizes its plan
// with: threads a block, and rows a chunk's buffer holds past the chunk.
extern "C" int fractal_points_layout(int* threads, int* ahead) {
  *threads = POINTS_THREADS;
  *ahead = POINTS_AHEAD;
  return 0;
}

// The card's shared-memory limits for a launch plan: the most a block may
// opt in to, what one SM holds, the number of SMs, and what the card keeps
// back for each block.
extern "C" int fractal_smem_limits(int* per_block, int* per_sm, int* sms, int* reserved) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(per_block, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
  return static_cast<int>(err);
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
