// Kernel G: the multiply-add chain, the card's contraction probe.
//
// Replaces tools/lean_probe.py::chain_kernel: x <- a*x + b repeated `steps`
// times on every element, in the modes
//
//   fma     a * x + b            as written: contractible where the compiler may
//   pinned  (a * x) * pin + b    pin = p[0] * 0 + 1, a 1.0 the compiler cannot see
//   mul     x * a
//   fused   __fmaf_rn(a, x, b)   one rounding, asked for by name
//
// The port's kernels are built with -fmad=false and are held bit-equal to
// plain torch versions that round every product and every sum; that only
// holds if nvcc then leaves `a * x + b` as two roundings.  So under the
// build's flags mode fma must equal mode pinned and the plain version, and
// mode fused shows that a single rounding does give other bits on the same
// inputs.  One thread per element, the chain in registers.
//
// Bound: operations (two per element-step, one for mul and fused); the only
// memory traffic is three loads and one store per element.

#include <cuda_runtime.h>

namespace {

constexpr int MODE_FMA = 0;
constexpr int MODE_PINNED = 1;
constexpr int MODE_MUL = 2;
constexpr int MODE_FUSED = 3;

template <int MODE>
__global__ void chain_kernel(const float* __restrict__ p, const float* __restrict__ x_in,
                             const float* __restrict__ a_in, const float* __restrict__ b_in,
                             float* __restrict__ out, long long n, int steps) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float x = x_in[i];
  const float a = a_in[i];
  const float b = b_in[i];
  const float pin = p[0] * 0.0f + 1.0f;
  for (int s = 0; s < steps; ++s) {
    if constexpr (MODE == MODE_FMA) {
      x = a * x + b;
    } else if constexpr (MODE == MODE_PINNED) {
      x = (a * x) * pin + b;
    } else if constexpr (MODE == MODE_MUL) {
      x = x * a;
    } else {
      x = __fmaf_rn(a, x, b);
    }
  }
  out[i] = x;
}

}  // namespace

// out = the chain of `mode` over n elements.  Launches on `stream` and
// returns cudaGetLastError() after the launch.
extern "C" int fractal_chain(const float* p, const float* x, const float* a, const float* b,
                             float* out, long long n, int steps, int mode, void* stream) {
  if (n <= 0 || steps < 0 || mode < MODE_FMA || mode > MODE_FUSED)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((n + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case MODE_FMA: chain_kernel<MODE_FMA><<<blocks, threads, 0, s>>>(p, x, a, b, out, n, steps);
      break;
    case MODE_PINNED:
      chain_kernel<MODE_PINNED><<<blocks, threads, 0, s>>>(p, x, a, b, out, n, steps);
      break;
    case MODE_MUL: chain_kernel<MODE_MUL><<<blocks, threads, 0, s>>>(p, x, a, b, out, n, steps);
      break;
    default: chain_kernel<MODE_FUSED><<<blocks, threads, 0, s>>>(p, x, a, b, out, n, steps);
  }
  return static_cast<int>(cudaGetLastError());
}
