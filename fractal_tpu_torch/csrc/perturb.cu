// delta-orbit kernel B, dist-only form: the p32 fast tier's per-pixel loop.
//
// Replaces the dist_only form of fractal_tpu/ops/perturb.py::perturb_pallas_v2
// (body _build_pert_kernel_v2 with dist_only=True, glitch=False, quadratic
// mandelbrot and julia).  Each thread owns one pixel and iterates the f32
// perturbation recurrence against the host's reference orbit:
//
//   dz' = (2Z_n + dz) * dz + dc          (julia drops + dc)
//   z   = Z_{n+1} + dz'                   (escape test on |z|^2)
//
// starting at n0 = P[8] with the cubic series start dz_0 (perturb.py
// :1262-1270).  The TPU kernel runs 32x128 tiles in lock-step from the chunk
// index n0 / chunk; this loop starts at exactly n0 and stops when the pixel
// freezes (|z|^2 > limit^2) or the orbit runs out (n >= n_steps), so the
// series-skip alignment of the TPU kernel (SERIES_ALIGN) plays no role here.
// The epilogue takes the terminal escape step back out of the count.
//
// Bound: compute.  Per step ~20 flops; the orbit row 2Z_n is read from a
// (rows, 2) float table in global memory.  All threads of a warp start at
// the same n0 and advance together while live, so each read is one broadcast
// that hits L1; no other global traffic happens inside the loop.  The
// TPU's VMEM cap on the lane-replicated planes has no counterpart: the
// table stays in global memory at any budget.  Staging it through shared
// memory is later work.
//
// Rounding: the expressions follow perturb.py:1372-1380 operation for
// operation; the file is compiled with -fmad=false, so nothing is fused and
// the plain torch version (fractal_tpu_torch/ops/perturb_cuda.py) is
// bit-equal on the card.

#include <cuda_runtime.h>

namespace {

template <bool JULIA>
__global__ void perturb_dist_kernel(const float* __restrict__ params,
                                    const float2* __restrict__ orbit2z, int rows, int n_steps,
                                    int height, int width, float* __restrict__ d_out,
                                    int* __restrict__ cnt_out) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= width || y >= height) return;
  float P[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) P[k] = params[k];
  const float limit_sq = P[4];

  const float xx = static_cast<float>(x);
  const float yy = static_cast<float>(y) * P[6] + P[7];  // global-row map
  const float dcr = (xx - P[2]) * P[0];
  const float dci = (yy - P[3]) * P[1];

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

  const float2 z0 = orbit2z[n0];
  const float zfr = 0.5f * z0.x + dzr;
  const float zfi = 0.5f * z0.y + dzi;
  float d = zfr * zfr + zfi * zfi;
  int cnt = n0;
  for (int n = n0; n < n_steps && d <= limit_sq; ++n) {
    const float2 zn = orbit2z[n];
    const float2 zn1 = orbit2z[n + 1];
    const float tr = zn.x + dzr;
    const float t2 = zn.y + dzi;
    float ndzr, ndzi;
    if (JULIA) {
      ndzr = tr * dzr - t2 * dzi;
      ndzi = tr * dzi + t2 * dzr;
    } else {
      ndzr = tr * dzr - t2 * dzi + dcr;
      ndzi = tr * dzi + t2 * dzr + dci;
    }
    const float nzfr = 0.5f * zn1.x + ndzr;
    const float nzfi = 0.5f * zn1.y + ndzi;
    d = nzfr * nzfr + nzfi * nzfi;
    cnt += 1;
    dzr = ndzr;
    dzi = ndzi;
  }
  const int escaped = d > limit_sq ? 1 : 0;
  const long i = static_cast<long>(y) * width + x;
  d_out[i] = d;
  cnt_out[i] = cnt - escaped > 0 ? cnt - escaped : 0;
}

}  // namespace

// Launch kernel B on `stream`; returns cudaGetLastError() after the launch.
extern "C" int fractal_perturb_dist(const float* params, const float* orbit2z, int rows,
                                    int n_steps, int julia, int height, int width, float* d,
                                    int* cnt, void* stream) {
  if (height <= 0 || width <= 0 || rows < 1 || n_steps < 0 || n_steps >= rows)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 block(32, 8);
  dim3 grid((width + block.x - 1) / block.x, (height + block.y - 1) / block.y);
  const float2* z2 = reinterpret_cast<const float2*>(orbit2z);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (julia) {
    perturb_dist_kernel<true><<<grid, block, 0, s>>>(params, z2, rows, n_steps, height, width,
                                                    d, cnt);
  } else {
    perturb_dist_kernel<false><<<grid, block, 0, s>>>(params, z2, rows, n_steps, height, width,
                                                     d, cnt);
  }
  return static_cast<int>(cudaGetLastError());
}
