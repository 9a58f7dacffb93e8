// The coloring epilogue of the colored grid forms: kernel A's (escape.cu) and
// the f32 grid loop's (escape_f64.cu), one copy for both.
//
// Rounding: ops/coloring.py's order.  The including file is compiled with
// -fmad=false and without fast-math, so log2f, sqrtf and the division are the
// ones torch's elementwise kernels call, and the plain version (torch's
// coloring on the card) is bit-equal.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// ops/coloring.py's epilogue for one pixel, in its order: |z|^2 of the
// collapsed z, the escape test against stable_limit, the smooth term, the
// exposure multiplier, primary * mult or the inside shade, NaN -> 0, trunc,
// clamp to [0, 255], u8.  C is escape_cuda.color_params' block: stable_limit,
// iterations, exposure, primary (r, b, g), secondary (r, b, g).
__device__ __forceinline__ void color_pixel(const float* __restrict__ C, bool inside,
                                            bool smooth, float zr, float zi, int cnt,
                                            uint8_t* __restrict__ px) {
  const float d = zr * zr + zi * zi;
  const bool escaped = d > C[0];
  float mult = 0.0f;  // read only where the pixel escaped
  if (escaped) {
    float iters = static_cast<float>(cnt);
    if (smooth) {
      float log_zn = log2f(sqrtf(d)) / 2.0f;
      float nu = log2f(log_zn);
      iters = iters + (1.0f - nu);
    }
    mult = iters / C[1] * C[2];
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float v = escaped ? C[3 + k] * mult : (inside ? C[6 + k] * d : 0.0f);
    v = fminf(fmaxf(truncf(v), 0.0f), 255.0f);  // fmaxf takes NaN to 0
    px[k] = static_cast<uint8_t>(v);
  }
}

}  // namespace
