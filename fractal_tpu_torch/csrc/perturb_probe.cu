// Kernel F: the probe twins of kernel B's quadratic delta-orbit loop.
//
// Replaces tools/lean_probe.py::probe_kernel (body _build_probe_kernel): the
// non-julia z^2 + c delta-orbit of kernel B without the glitch test,
//
//   dz' = (2Z_n + dz) * dz + dc,  z = Z_{n+1} + dz',  escape when |z|^2 > limit^2
//
// from the cubic series start at n0 = P[8], in four variants:
//
//   base      outputs (zr, zi, cnt, d): the frozen z, the count, the frozen |z|^2
//   dout      outputs (d, cnt) only: no frozen z is carried
//   every2    dout, with the escape test on odd steps only: an even step
//             advances dz alone, a live odd step counts 2, and an escaped
//             pixel gives 2 back at the end: an escape on an even step is
//             seen one step late and counts as in base, an escape on an odd
//             step counts one fewer
//   nofreeze  dout without the freeze of d
//
// The TPU kernel steps a 32x128 tile in lock-step, in chunks of 16 from the
// chunk that holds n0, until no pixel of the tile is live; dz is never
// frozen there, only z, d and the count are.  Here the tile is one pixel:
// each thread starts at 16 * (n0 / 16) and leaves its loop when its own
// pixel is no longer live, which is where the tile's freeze selects would
// have stopped its outputs.  For base, dout and every2 the outputs are the
// same as the tile's.  nofreeze is the variant whose d runs on after escape
// until the tile leaves the loop, so its final d (and, where that d has
// reached NaN by then, whether the escape step is taken back out of the
// count) depends on the tile's other pixels; on a one-pixel tile it stops at
// the escape step and equals dout.  "Even" and "odd" are by the absolute
// step index, which is the index within the chunk because chunks start at
// multiples of 16.
//
// Bound: operations, as kernel B's dist-only form (csrc/perturb.cu); the
// orbit row read is a warp-wide broadcast.  Built with -fmad=false, so the
// plain torch version (fractal_tpu_torch/ops/probe_cuda.py) is bit-equal.

#include <cuda_runtime.h>

namespace {

constexpr int VARIANT_BASE = 0;
constexpr int VARIANT_DOUT = 1;
constexpr int VARIANT_EVERY2 = 2;
constexpr int VARIANT_NOFREEZE = 3;
constexpr int CHUNK = 16;

template <int VARIANT>
__global__ void probe_kernel(const float* __restrict__ params,
                             const float2* __restrict__ orbit2z, int rows, int n_steps,
                             int height, int width, float* __restrict__ zr_out,
                             float* __restrict__ zi_out, float* __restrict__ d_out,
                             int* __restrict__ cnt_out) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= width || y >= height) return;
  float P[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) P[k] = params[k];
  const float limit_sq = P[4];
  const float xx = static_cast<float>(x);
  const float yy = static_cast<float>(y) * P[6] + P[7];
  const float dcr = (xx - P[2]) * P[0];
  const float dci = (yy - P[3]) * P[1];

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

  const float2 z0 = orbit2z[n0];
  float zfr = 0.5f * z0.x + dzr;
  float zfi = 0.5f * z0.y + dzi;
  float d = zfr * zfr + zfi * zfi;
  int cnt = n0;
  constexpr int PER_TEST = VARIANT == VARIANT_EVERY2 ? 2 : 1;
  for (int n = (n0 / CHUNK) * CHUNK; n < n_steps && d <= limit_sq; ++n) {
    const float2 zn = orbit2z[n];
    const float tr = zn.x + dzr;
    const float t2 = zn.y + dzi;
    const float ndzr = tr * dzr - t2 * dzi + dcr;
    const float ndzi = tr * dzi + t2 * dzr + dci;
    dzr = ndzr;
    dzi = ndzi;
    if (VARIANT == VARIANT_EVERY2 && (n & 1) == 0) continue;  // no escape test
    const float2 zn1 = orbit2z[n + 1];
    zfr = 0.5f * zn1.x + ndzr;
    zfi = 0.5f * zn1.y + ndzi;
    d = zfr * zfr + zfi * zfi;
    cnt += PER_TEST;
  }
  const int escaped = d > limit_sq ? PER_TEST : 0;
  const long i = static_cast<long>(y) * width + x;
  if (VARIANT == VARIANT_BASE) {
    zr_out[i] = zfr;
    zi_out[i] = zfi;
  }
  d_out[i] = d;
  cnt_out[i] = cnt - escaped > 0 ? cnt - escaped : 0;
}

}  // namespace

// Kernel F: (zr, zi, cnt, d) for variant 0, (d, cnt) for variants 1-3 (zr
// and zi are then not touched), each (height, width).  Launches on `stream`
// and returns cudaGetLastError() after the launch.
extern "C" int fractal_perturb_probe(const float* params, const float* orbit2z, int rows,
                                     int n_steps, int variant, int height, int width,
                                     float* zr, float* zi, float* d, int* cnt, void* stream) {
  if (height <= 0 || width <= 0 || rows < 1 || n_steps < 0 || n_steps >= rows ||
      variant < VARIANT_BASE || variant > VARIANT_NOFREEZE ||
      (variant == VARIANT_BASE && (zr == nullptr || zi == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const float2* table = reinterpret_cast<const float2*>(orbit2z);
  dim3 block(32, 8);
  dim3 grid((width + block.x - 1) / block.x, (height + block.y - 1) / block.y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case VARIANT_BASE:
      probe_kernel<VARIANT_BASE><<<grid, block, 0, s>>>(params, table, rows, n_steps, height,
                                                        width, zr, zi, d, cnt);
      break;
    case VARIANT_DOUT:
      probe_kernel<VARIANT_DOUT><<<grid, block, 0, s>>>(params, table, rows, n_steps, height,
                                                        width, zr, zi, d, cnt);
      break;
    case VARIANT_EVERY2:
      probe_kernel<VARIANT_EVERY2><<<grid, block, 0, s>>>(params, table, rows, n_steps, height,
                                                          width, zr, zi, d, cnt);
      break;
    default:
      probe_kernel<VARIANT_NOFREEZE><<<grid, block, 0, s>>>(params, table, rows, n_steps,
                                                            height, width, zr, zi, d, cnt);
  }
  return static_cast<int>(cudaGetLastError());
}
