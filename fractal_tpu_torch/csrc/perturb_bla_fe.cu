// The fe BLA route: the extreme-depth tier's macro-skip loop as one launch.
//
// Replaces fractal_tpu/ops/perturb.py::_perturb_tile_bla_fe (:915-1072), an
// XLA program with no Pallas kernel, which the reference runs over bands of
// 256 rows in one fused program (_render_perturb_jit, lax.map); the plain
// version is perturb_cuda.perturb_bla_fe_plain.  Every pixel carries its
// floatexp delta orbit (dz as two (m, e) pairs, z, the count and the glitch
// flag).  A gate group, the set of pixels that share one skip gate, runs its
// own loop counter n:
//
//   while n < iterations and n < n_steps and some pixel of the group is live:
//     up to 4 skip attempts: the gate is the lexicographic (e, m) maximum of
//       |dz|^2 over the group's live pixels (E_ZERO, 0 when there is none);
//       the largest table level k with n aligned to 2^k, n + 2^k <= n_steps,
//       r^2 > 0 and the gate below r^2 jumps every live pixel:
//       dz <- A dz + gain B dc, z = Z_{n+2^k} + dz, count += 2^k, n += 2^k;
//       an attempt that finds no level changes nothing, so the reference's
//       later attempts of the macro step find none either and are not run
//     4 plain steps n .. n+3 (kernel D's step, with the glitch test)
//   ran_out: live past the orbit's end when the orbit ended before the budget
//
// A group is one band of `height` rows of the launch (the reference's
// 256-row bands on one device, a shard's stripe on a mesh); rows map to the
// plane through y * P[6] + P[7] as kernel D's grid form maps them.
//
// Arithmetic: the plain version runs floatexp.py's general ops throughout
// (frexp, ldexp with the flush below 2^-126 and the clamps at +-200, mul,
// add).  The kernel runs kernel D's closed-domain ops (floatexp.cuh) where
// they give the same bits, and the general ops elsewhere:
//  - A pixel's plain steps and its next gate's |dz|^2 take the closed ops
//    when its dz and its gain-folded dc_g are ready for them
//    (fe_step_ready: in the closed domain, exponents at or above -2^23) and
//    every orbit row of the run lies in the domain (fe(2Z_n) of a subnormal
//    2Z_n does not).  Four steps keep such a pixel in the domain, so nothing
//    is tested between them.  dz is tested when the steps begin, after a
//    skip, and again for the gate after steps in the general ops; dc_g once
//    a pixel, the rows once a phase.
//  - The skip's two complex products take the general ops always: the table
//    stores each complex A and B with one shared exponent, so the smaller
//    mantissa can be tiny or subnormal and the products leave the domain; a
//    pixel a skip pushed out takes the general ops until it is back in.
// Table exponents are f32 values clipped to +-1e7 (a zero row carries -1e7,
// not E_ZERO), read as int(row[k]); the row index is clamped to the table's
// last row, as the reference's dynamic_slice clamps it.  Built with
// -fmad=false and without fast math, so the plain torch version is bit-equal
// on the card.
//
// Design: one cooperative launch over every group of the call, sized to be
// co-resident (occupancy x SMs), each block owning pixels of one group.  A
// phase is one skip attempt of each group and one pass over the block's
// pixels: the skip the previous gate decided (and, after the last attempt of
// a macro step, its four plain steps), then the next gate's |dz|^2.  Each
// group keeps its own n and attempt count.  Two forms of the same loop:
//  - registers (K > 0): each thread owns K fixed pixels of its group for the
//    whole launch and keeps their dz, z, count, flag and dc in registers; the
//    outputs are written once, after the loop and the ran-out pass.  It takes
//    calls whose pixels fit the co-resident threads x K (bla1e40's two padded
//    groups, 262,144 pixels, at two blocks of 256 threads an SM);
//  - streaming (K = 0): a block-stride loop over the group's pixels whose
//    state lives in the outputs (z, count, flag) and a scratch plane of dz,
//    so any number of pixels fits.
// The wrapper picks the form (perturb_cuda.bla_fe_form) from the call's
// shape and the register form's occupancy.  Warp 0 of each block decides the skip
// and stages the phase's four orbit rows in shared memory as kernel D's
// ring rows (fe(2Z_n), Z_{n+1}, tau^2 |Z_{n+1}|^2), so frexp runs once a row
// a block and not once a pixel-step.
// Each pixel packs (e, m) into one 64-bit key, ((e + 2^31) << 32) | bits(m)
// for m > 0 (positive floats order as their bits), a block reduces its keys
// and its "live" votes and adds one atomicMax and one atomicOr a group, and
// a grid barrier publishes them; a max is exact, so no order changes a bit.
// After the barrier warp 0 of each block tests the group's key against the
// table's levels, one a lane, and shares the decision through shared
// memory.  The key, live and continue slots rotate over
// three phases, so a slot is reset while nobody reads or writes it; groups
// that have finished wait at the barriers until every group has, so every
// block leaves at the same phase.  The loop makes no host sync: the group's
// n and its exit are decided on the device.
//
// Bound: a phase depends on the barrier before it, so the launch is at least
// its phases (2 + the most attempts of a group) times one phase's dependent
// chain (the skip's mul-add chain, the plain steps after a macro step's last
// attempt, the gate and the block's reduction) and barrier; its work is the
// pixel-steps at kernel D's count of operations a step plus the skips and the
// gates a pixel.  chip_smoke.py phase 12 prints both.  On an H100 at 700 W
// (bla1e40, 30 phases; tools/bla_phase.py): 0.7653 ms before this design,
// 0.379 ms in the register form and 0.487 in the streaming form; the general
// ops alone would take 0.662; a phase's barrier and bookkeeping 1.7 us of its
// 12.7, its state pass through memory 3.6 us more in the streaming form.
// Fewer, larger blocks (8 pixels a thread, one block an SM: 0.655 ms) and a
// barrier a group (0.413 ms) measured slower.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cmath>

#include "floatexp.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int REG_K = 4;           // pixels a thread in the register form
constexpr int REG_MIN_BLOCKS = 2;  // its blocks an SM: at most 128 registers a thread
constexpr int MAX_LEVELS = 32;
constexpr int SKIP_SCANS = 4;  // perturb_cuda.SKIP_SCANS
constexpr int CHUNK = 4;       // perturb_cuda.FE_BLA_CHUNK
constexpr int SLOTS = 3;

__device__ __forceinline__ int wrap_sub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}

// floatexp.py's general ops, expression for expression (frexp_fe and fe_of
// are jnp.frexp and floatexp.fe).

// m * 2^e on the exponent field: +-inf above the range, +-0 below 2^-126;
// +-0, subnormals, +-inf and NaN pass through.
__device__ __forceinline__ float ldexp_g(float m, int e) {
  const unsigned bits = __float_as_uint(m);
  const int field = static_cast<int>((bits >> 23) & 0xffu);
  if (field == 0 || field == 0xff) return m;
  const int nf = wrap_add(field, e);
  if (nf >= 0xff) return m * INFINITY;
  if (nf <= 0) return m * 0.0f;
  return __uint_as_float((bits & MANT) | (static_cast<unsigned>(nf) << 23));
}

__device__ __forceinline__ float g_to_float(Fe a) {
  return ldexp_g(a.m, min(max(a.e, -200), 200));
}

__device__ __forceinline__ Fe g_mul(Fe a, Fe b) {
  const Fe r = frexp_fe(a.m * b.m);
  return {r.m, r.m == 0.0f ? E_ZERO : wrap_add(wrap_add(a.e, b.e), r.e)};
}

__device__ __forceinline__ Fe g_add(Fe a, Fe b) {
  const int e = max(a.e, b.e);
  // the smaller operand shifts down; gaps past 200 bits flush to 0
  const float s = ldexp_g(a.m, max(wrap_sub(a.e, e), -200)) +
                  ldexp_g(b.m, max(wrap_sub(b.e, e), -200));
  const Fe r = frexp_fe(s);
  return {r.m, r.m == 0.0f ? E_ZERO : wrap_add(e, r.e)};
}

__device__ __forceinline__ void g_cmul(Fe ar, Fe ai, Fe br, Fe bi, Fe& outr, Fe& outi) {
  outr = g_add(g_mul(ar, br), fe_neg(g_mul(ai, bi)));
  outi = g_add(g_mul(ar, bi), g_mul(ai, br));
}

// The gate key of (e, m), m > 0: lexicographic (e, m) order as u64 order.
__device__ __forceinline__ unsigned long long gate_key(int e, float m) {
  return (static_cast<unsigned long long>(static_cast<unsigned>(e) ^ 0x80000000u) << 32) |
         __float_as_uint(m);
}

// A pixel with no |dz|^2 in the gate still takes part as (E_ZERO, 0), as the
// plain version's where(has, e, E_ZERO) fill does.
constexpr unsigned long long FILL_KEY =
    static_cast<unsigned long long>(static_cast<unsigned>(E_ZERO) ^ 0x80000000u) << 32;

struct Args {
  const float* params;  // the fe P block (16)
  const float* pk;      // (rows, 5): Zr_n, Zi_n, Zr_n+1, Zi_n+1, tau^2 |Z_n+1|^2
  const float* table;   // (table_rows, 8): the BLA table
  int rows, n_steps, iterations;
  int table_rows, n_levels, min_level;
  int offsets[MAX_LEVELS];
  int groups, height, width, blocks_per_group;
  float* zr;
  float* zi;
  int* cnt;
  int* gl;
  int* dz;                    // streaming form: 4 planes, dz_r.m, dz_r.e, dz_i.m, dz_i.e
  unsigned long long* keys;   // SLOTS x groups
  int* live;                  // SLOTS x groups
  int* cont;                  // SLOTS
};

struct Decision {
  float ar, ai, br, bi, land_r, land_i;
  int ae, be, step, cont, n, done, attempt, rows_ok;
};

struct Pixel {
  Fe dzr, dzi;
  float zr, zi;
  int cnt, gl;
};

// One plain step of a pixel from row r at orbit row n (kernel D's step,
// closed or general ops): the state changes only where the pixel is live.
template <bool GLITCH, bool CLOSED>
__device__ __forceinline__ void plain_step(const Row& r, int n, const Fe& dcr_g, const Fe& dci_g,
                                           float limit_sq, Pixel& px) {
  const bool live = px.zr * px.zr + px.zi * px.zi <= limit_sq && px.cnt == n && px.gl == 0;
  if (!live) return;
  if (CLOSED) {
    closed_step(r, dcr_g, dci_g, px.dzr, px.dzi, px.zr, px.zi);
  } else {
    const Fe tr = g_add({r.mr, r.er}, px.dzr);
    const Fe ti = g_add({r.mi, r.ei}, px.dzi);
    Fe pr, pi;
    g_cmul(tr, ti, px.dzr, px.dzi, pr, pi);
    px.dzr = g_add(pr, dcr_g);
    px.dzi = g_add(pi, dci_g);
    px.zr = r.zr1 + g_to_float(px.dzr);
    px.zi = r.zi1 + g_to_float(px.dzi);
  }
  const float d = px.zr * px.zr + px.zi * px.zi;
  const bool esc = d > limit_sq;
  const bool glitched = GLITCH && !esc && d < r.gtol;
  if (!esc && !glitched) px.cnt += 1;
  if (glitched) px.gl = 1;
}

// The group's skip at n from its gate key, by warp 0 (lane l evaluates
// stored level l; the highest level that passes wins, as the walk from the
// top level down takes it): the step in every lane (0 for none), the table
// row's A and B written into `d` by the winning lane.
__device__ int decide(const Args& a, int n, unsigned long long key, Decision& d) {
  const int lane = threadIdx.x & 31;
  const int maxe =
      key == 0 ? E_ZERO : static_cast<int>(static_cast<unsigned>(key >> 32) ^ 0x80000000u);
  const float maxm = key == 0 ? 0.0f : __uint_as_float(static_cast<unsigned>(key));
  bool ok = false;
  const float* r = a.table;
  if (lane < a.n_levels) {
    const int k = lane + a.min_level;
    const int step = 1 << k;
    // the reference's dynamic_slice clamps the row index
    const int idx = min(a.offsets[lane] + (n >> k), a.table_rows - 1);
    r = a.table + static_cast<long>(idx) * 8;
    const float r2m = r[6];
    const int r2e = static_cast<int>(r[7]);  // int(row[7]): -1e7 on a zero row
    ok = (n & (step - 1)) == 0 && n + step <= a.n_steps && r2m > 0.0f &&
         (maxe < r2e || (maxe == r2e && maxm < r2m));
  }
  const unsigned mask = __ballot_sync(0xffffffffu, ok);
  if (mask == 0) return 0;
  const int win = 31 - __clz(mask);
  if (lane == win) {
    d.ar = r[0];
    d.ai = r[1];
    d.ae = static_cast<int>(r[2]);
    d.br = r[3];
    d.bi = r[4];
    d.be = static_cast<int>(r[5]);
  }
  return 1 << (win + a.min_level);
}

__device__ __forceinline__ unsigned long long block_max(unsigned long long v,
                                                        unsigned long long* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_down_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0)
    for (int w = 1; w < WARPS; ++w) v = max(v, red[w]);
  return v;  // thread 0's is the block's
}

// K > 0: the register form, K pixels a thread; K = 0: the streaming form.
template <bool GLITCH, int K>
__global__ void __launch_bounds__(THREADS, K > 0 ? REG_MIN_BLOCKS : 1)
    perturb_bla_fe_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ float P[16];
  __shared__ unsigned long long red_key[WARPS];
  __shared__ int red_live[WARPS];
  __shared__ Decision dec;
  __shared__ Row rows[CHUNK];
  if (threadIdx.x < 16) P[threadIdx.x] = a.params[threadIdx.x];
  const int g = blockIdx.x / a.blocks_per_group;
  const long group_px = static_cast<long>(a.height) * a.width;
  const long base = static_cast<long>(g) * group_px;
  const long stride = static_cast<long>(a.blocks_per_group) * THREADS;
  const long first = static_cast<long>(blockIdx.x % a.blocks_per_group) * THREADS + threadIdx.x;
  const long plane = static_cast<long>(a.groups) * group_px;
  if (threadIdx.x == 0) {
    dec.n = 0;
    dec.done = 0;
    dec.attempt = 0;
  }
  __syncthreads();
  const float limit_sq = P[4];
  const float gain = P[5];
  const Fe ar{P[0], static_cast<int>(P[8])};
  const Fe ai{P[1], static_cast<int>(P[9])};

  // dc of pixel p of the group (perturb_cuda.fe_dc)
  auto pixel_dc = [&](long p, Fe& dcr, Fe& dci) {
    const int y = g * a.height + static_cast<int>(p / a.width);
    const float xx = static_cast<float>(p % a.width);
    const float yy = static_cast<float>(y) * P[6] + P[7];  // global-row map
    dcr = g_mul(fe_of(xx - P[2]), ar);
    dci = g_mul(fe_of(yy - P[3]), ai);
  };
  // the gain-folded dc (julia: a true zero)
  auto fold = [&](Fe d) { return Fe{d.m * gain, gain == 0.0f ? E_ZERO : d.e}; };
  auto dcg_ready = [&](const Fe& dcr, const Fe& dci) {
    return fe_step_ready(fold(dcr)) && fe_step_ready(fold(dci));
  };
  auto dz_ready = [](const Pixel& px) { return fe_step_ready(px.dzr) && fe_step_ready(px.dzi); };
  // the pixel's gate key and live vote at the group's n (|dz|^2 in the
  // closed ops where `closed`)
  auto gate = [&](const Pixel& px, int n, bool closed, unsigned long long& key, int& live) {
    const bool act = px.zr * px.zr + px.zi * px.zi <= limit_sq && px.cnt == n && px.gl == 0;
    live |= act ? 1 : 0;
    unsigned long long k = FILL_KEY;
    if (act && n < a.n_steps) {
      const Fe m2 = closed ? fe_add(fe_mul(px.dzr, px.dzr), fe_mul(px.dzi, px.dzi))
                           : g_add(g_mul(px.dzr, px.dzr), g_mul(px.dzi, px.dzi));
      if (m2.m > 0.0f) k = gate_key(m2.e, m2.m);
    }
    key = max(key, k);
  };
  // the pixel's initial state (dz = dc at n = 0) and its first gate
  auto start = [&](Pixel& px, const Fe& dcr, const Fe& dci, unsigned long long& key,
                   int& live) {
    px.dzr = dcr;
    px.dzi = dci;
    px.zr = a.pk[0] + g_to_float(px.dzr);
    px.zi = a.pk[1] + g_to_float(px.dzi);
    px.cnt = 0;
    px.gl = 0;
    gate(px, 0, dz_ready(px), key, live);
  };
  // one block's key and live vote into `slot`, and whether its group goes
  // on: at a macro step's head (`at_cond`) while n < iterations, n < n_steps
  // and a pixel is live, between attempts while the group has not finished
  auto publish = [&](int slot, unsigned long long key, int live, bool done, bool at_cond,
                     int n) {
    const unsigned long long bkey = block_max(key, red_key);
    const int wlive = __any_sync(0xffffffffu, live);
    if ((threadIdx.x & 31) == 0) red_live[threadIdx.x >> 5] = wlive;
    __syncthreads();
    if (threadIdx.x == 0) {
      int blive = 0;
      for (int w = 0; w < WARPS; ++w) blive |= red_live[w];
      if (bkey != 0) atomicMax(&a.keys[slot * a.groups + g], bkey);
      if (blive) atomicOr(&a.live[slot * a.groups + g], 1);
      if (!done && (!at_cond || (n < a.iterations && n < a.n_steps && blive)))
        atomicOr(&a.cont[slot], 1);
    }
  };

  // the register form's pixels: p = first + j * stride, j < K, inside the group
  constexpr int KR = K > 0 ? K : 1;
  Pixel px[KR];
  Fe dcr[KR], dci[KR];
  unsigned ready = 0;  // bit j: pixel j's dc_g is ready for the closed ops

  // phase 0: the initial state and the first gate, into slot 1
  {
    unsigned long long key = 0;
    int live = 0;
    if constexpr (K > 0) {
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const long p = first + j * stride;
        if (p < group_px) {
          pixel_dc(p, dcr[j], dci[j]);
          if (dcg_ready(dcr[j], dci[j])) ready |= 1u << j;
          start(px[j], dcr[j], dci[j], key, live);
        }
      }
    } else {
      for (long p = first; p < group_px; p += stride) {
        const long i = base + p;
        Pixel q;
        Fe cr, ci;
        pixel_dc(p, cr, ci);
        start(q, cr, ci, key, live);
        a.dz[i] = __float_as_int(q.dzr.m);
        a.dz[plane + i] = q.dzr.e;
        a.dz[2 * plane + i] = __float_as_int(q.dzi.m);
        a.dz[3 * plane + i] = q.dzi.e;
        a.zr[i] = q.zr;
        a.zi[i] = q.zi;
        a.cnt[i] = 0;
        a.gl[i] = 0;
      }
    }
    publish(1, key, live, false, true, 0);
  }
  grid.sync();

  // every macro step advances n by CHUNK at least and the loop stops past
  // the budget, so this bound is never reached; it keeps a fault from
  // looping (the same bound in every block, so all leave together)
  const int max_phases = 2 + SKIP_SCANS * (a.iterations / CHUNK + 2);
  for (int phase = 1; phase <= max_phases; ++phase) {
    const int slot = phase % SLOTS;
    const int next = (phase + 1) % SLOTS;
    const int stale = (phase + 2) % SLOTS;
    if (threadIdx.x < 32) {  // warp 0 reads the slot, decides, stages the rows
      const int lane = threadIdx.x;
      int cont = 0, live = 0, done = 0;
      unsigned long long key = 0;
      if (lane == 0) {
        cont = *reinterpret_cast<volatile int*>(&a.cont[slot]);
        done = dec.done;
        live = *reinterpret_cast<volatile int*>(&a.live[slot * a.groups + g]);
        key = *reinterpret_cast<volatile unsigned long long*>(&a.keys[slot * a.groups + g]);
      }
      cont = __shfl_sync(0xffffffffu, cont, 0);
      done = __shfl_sync(0xffffffffu, done, 0);
      live = __shfl_sync(0xffffffffu, live, 0);
      key = __shfl_sync(0xffffffffu, key, 0);
      const int n = dec.n;
      // a macro step's head: the group goes on while n < iterations,
      // n < n_steps and a pixel of it is live
      if (cont != 0 && !done && dec.attempt == 0)
        done = !(n < a.iterations && n < a.n_steps && live);
      const bool run = cont != 0 && !done;
      const int step = run ? decide(a, n, key, dec) : 0;
      // An attempt that finds no level leaves the state and n as they were,
      // so the macro step's later attempts would find none either: the plain
      // steps follow at once, as they do after the last attempt.
      const int n1 = n + step;
      bool bad = false;  // a row the steps read lies outside the closed domain
      if (run && (step == 0 || dec.attempt == SKIP_SCANS - 1) && lane < CHUNK) {
        const float* r = a.pk + static_cast<long>(min(n1 + lane, a.rows - 1)) * 5;
        const Fe fr = fe_of(2.0f * r[0]);
        const Fe fi = fe_of(2.0f * r[1]);
        rows[lane] = {fr.m, fi.m, r[2], r[3], fr.e, fi.e, r[4], 0.0f};
        bad = n1 + lane < a.n_steps && !(fe_in_domain(fr) && fe_in_domain(fi));
      }
      const bool rows_ok = __ballot_sync(0xffffffffu, bad) == 0;
      if (lane == 0) {
        dec.step = step;
        dec.cont = cont;
        dec.done = done;
        dec.rows_ok = rows_ok;
        if (step > 0) {
          dec.land_r = a.pk[static_cast<long>(n1) * 5];
          dec.land_i = a.pk[static_cast<long>(n1) * 5 + 1];
        }
      }
    }
    if (blockIdx.x == 0) {  // nobody reads or writes the stale slot in this phase
      for (int i = threadIdx.x; i < a.groups; i += THREADS) {
        a.keys[stale * a.groups + i] = 0;
        a.live[stale * a.groups + i] = 0;
      }
      if (threadIdx.x == 0) a.cont[stale] = 0;
    }
    __syncthreads();
    if (dec.cont == 0) break;  // every group has finished (the same slot everywhere)
    const int n0 = dec.n;
    const bool done = dec.done;
    const int step = dec.step;
    const bool steps = step == 0 || dec.attempt == SKIP_SCANS - 1;
    const bool rows_ok = dec.rows_ok;
    const int n1 = n0 + step;
    const int n2 = steps ? n1 + CHUNK : n1;
    unsigned long long key = 0;
    int live = 0;
    if (!done) {
      const Fe sAr{dec.ar, dec.ae}, sAi{dec.ai, dec.ae};
      const Fe sBr{dec.br, dec.be}, sBi{dec.bi, dec.be};
      const float land_r = dec.land_r, land_i = dec.land_i;
      // the phase of a pixel live at n0: the skip, the plain steps, the gate
      auto advance = [&](Pixel& q, const Fe& cr, const Fe& ci, bool cg_ready) {
        if (step > 0) {  // a skip: n0 + step <= n_steps, so the pixel is live
          Fe skr, ski, tbr, tbi;
          g_cmul(sAr, sAi, q.dzr, q.dzi, skr, ski);
          g_cmul(sBr, sBi, cr, ci, tbr, tbi);
          q.dzr = g_add(skr, fold(tbr));
          q.dzi = g_add(ski, fold(tbi));
          q.zr = land_r + g_to_float(q.dzr);
          q.zi = land_i + g_to_float(q.dzi);
          q.cnt += step;
        }
        bool closed = dz_ready(q);
        if (steps) {
          const Fe cr_g = fold(cr), ci_g = fold(ci);
          closed = closed && cg_ready && rows_ok;
          if (closed) {
#pragma unroll
            for (int j = 0; j < CHUNK; ++j)
              if (n1 + j < a.n_steps)
                plain_step<GLITCH, true>(rows[j], n1 + j, cr_g, ci_g, limit_sq, q);
          } else {
            for (int j = 0; j < CHUNK && n1 + j < a.n_steps; ++j)
              plain_step<GLITCH, false>(rows[j], n1 + j, cr_g, ci_g, limit_sq, q);
            closed = dz_ready(q);
          }
        }
        gate(q, n2, closed, key, live);
      };
      auto is_live = [&](const Pixel& q) {
        return q.cnt == n0 && q.gl == 0 && q.zr * q.zr + q.zi * q.zi <= limit_sq;
      };
      if constexpr (K > 0) {
#pragma unroll
        for (int j = 0; j < K; ++j) {
          if (first + j * stride >= group_px) continue;
          if (!is_live(px[j])) {  // not live now, nor at any later n
            key = max(key, FILL_KEY);
            continue;
          }
          advance(px[j], dcr[j], dci[j], (ready >> j) & 1u);
        }
      } else {
        for (long p = first; p < group_px; p += stride) {
          const long i = base + p;
          Pixel q;
          q.cnt = a.cnt[i];
          q.gl = a.gl[i];
          if (q.cnt != n0 || q.gl != 0) {  // not live now, nor at any later n
            key = max(key, FILL_KEY);
            continue;
          }
          q.zr = a.zr[i];
          q.zi = a.zi[i];
          if (!is_live(q)) {
            key = max(key, FILL_KEY);
            continue;
          }
          q.dzr = {__int_as_float(a.dz[i]), a.dz[plane + i]};
          q.dzi = {__int_as_float(a.dz[2 * plane + i]), a.dz[3 * plane + i]};
          Fe cr, ci;
          pixel_dc(p, cr, ci);
          advance(q, cr, ci, dcg_ready(cr, ci));
          a.dz[i] = __float_as_int(q.dzr.m);
          a.dz[plane + i] = q.dzr.e;
          a.dz[2 * plane + i] = __float_as_int(q.dzi.m);
          a.dz[3 * plane + i] = q.dzi.e;
          a.zr[i] = q.zr;
          a.zi[i] = q.zi;
          a.cnt[i] = q.cnt;
          a.gl[i] = q.gl;
        }
      }
    }
    publish(next, key, live, done, steps, n2);
    if (threadIdx.x == 0 && !done) {
      dec.n = n2;
      dec.attempt = steps ? 0 : dec.attempt + 1;
    }
    grid.sync();
  }

  // ran_out: live past the orbit's end, which came before the budget
  const bool outlived = a.n_steps < a.iterations;
  if constexpr (K > 0) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const long p = first + j * stride;
      if (p < group_px) {
        const long i = base + p;
        const Pixel& q = px[j];
        const bool ran_out =
            outlived && q.zr * q.zr + q.zi * q.zi <= limit_sq && q.cnt >= a.n_steps;
        a.zr[i] = q.zr;
        a.zi[i] = q.zi;
        a.cnt[i] = q.cnt;
        a.gl[i] = ran_out ? 1 : q.gl;
      }
    }
  } else if (outlived) {
    for (long p = first; p < group_px; p += stride) {
      const long i = base + p;
      const float zr = a.zr[i], zi = a.zi[i];
      if (zr * zr + zi * zi <= limit_sq && a.cnt[i] >= a.n_steps) a.gl[i] = 1;
    }
  }
}

template <bool GLITCH>
void* kernel_of(int form) {
  return form ? reinterpret_cast<void*>(perturb_bla_fe_kernel<GLITCH, REG_K>)
              : reinterpret_cast<void*>(perturb_bla_fe_kernel<GLITCH, 0>);
}

// The blocks of `form` (1 registers, 0 streaming) co-resident on the current
// card: occupancy x SMs.
int resident_blocks(int glitch, int form, long* blocks) {
  void* fn = glitch ? kernel_of<true>(form) : kernel_of<false>(form);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, THREADS, 0);
  *blocks = static_cast<long>(per_sm) * sms;
  return static_cast<int>(err);
}

}  // namespace

// The register form's launch shape on the current card: threads a block,
// pixels a thread, and its blocks that fit on the card at once
// (perturb_cuda.bla_fe_form reads them).
extern "C" int fractal_bla_fe_layout(int glitch, int* threads, int* k, int* resident) {
  long blocks = 0;
  const int err = resident_blocks(glitch, 1, &blocks);
  *threads = THREADS;
  *k = REG_K;
  *resident = static_cast<int>(blocks);
  return err;
}

// The fe BLA route over `groups` gate groups of `height` rows each (rows
// g * height .. of the launch, mapped through P[6], P[7]): (zr, zi, cnt, gl),
// each (groups * height, width), in `form` 1 (registers: every pixel's state
// in registers, the groups' pixels within the co-resident threads x K) or 0
// (streaming: `dz` is int32 scratch of 4 * groups * height * width words;
// the register form does not touch it).  `keys` (3 x groups u64), `live`
// (3 x groups int32) and `cont` (3 int32) must be zero.  Launches
// cooperatively on `stream` and returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for arguments it does not take,
// cudaErrorCooperativeLaunchTooLarge when the form's blocks do not fit on the
// card at once).
extern "C" int fractal_perturb_bla_fe(const float* params, const float* pk, int rows,
                                      int n_steps, int iterations, const float* table,
                                      int table_rows, const int* offsets, int n_levels,
                                      int min_level, int glitch, int form, int groups,
                                      int height, int width, float* zr, float* zi, int* cnt,
                                      int* gl, int* dz, unsigned long long* keys, int* live,
                                      int* cont, void* stream) {
  if (groups <= 0 || height <= 0 || width <= 0 || rows < 1 || n_steps < 0 ||
      n_steps >= rows || iterations < 0 || table_rows < 1 || n_levels < 1 ||
      n_levels > MAX_LEVELS || min_level < 0 || min_level + n_levels > 31 ||
      (form != 0 && form != 1) || (form == 0 && dz == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.params = params;
  a.pk = pk;
  a.table = table;
  a.rows = rows;
  a.n_steps = n_steps;
  a.iterations = iterations;
  a.table_rows = table_rows;
  a.n_levels = n_levels;
  a.min_level = min_level;
  for (int k = 0; k < n_levels; ++k) a.offsets[k] = offsets[k];
  a.groups = groups;
  a.height = height;
  a.width = width;
  a.zr = zr;
  a.zi = zi;
  a.cnt = cnt;
  a.gl = gl;
  a.dz = dz;
  a.keys = keys;
  a.live = live;
  a.cont = cont;
  long resident = 0;
  int err = resident_blocks(glitch, form, &resident);
  if (err != 0) return err;
  const long group_px = static_cast<long>(height) * width;
  long per_group;
  if (form == 1) {  // every pixel owned: K a thread
    per_group = (group_px + static_cast<long>(THREADS) * REG_K - 1) / (THREADS * REG_K);
    if (per_group * groups > resident)
      return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  } else {
    if (resident < groups) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
    per_group = resident / groups;
    const long need = (group_px + THREADS - 1) / THREADS;
    if (per_group > need) per_group = need;
  }
  a.blocks_per_group = static_cast<int>(per_group);
  void* fn = glitch ? kernel_of<true>(form) : kernel_of<false>(form);
  void* args[] = {&a};
  cudaError_t cerr =
      cudaLaunchCooperativeKernel(fn, dim3(static_cast<unsigned>(groups * per_group)),
                                  dim3(THREADS), args, 0, static_cast<cudaStream_t>(stream));
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  return static_cast<int>(cudaGetLastError());
}
