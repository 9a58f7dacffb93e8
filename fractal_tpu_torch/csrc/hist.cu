// Kernel H: the fern's hit histogram.
//
// Replaces tools/fern_hist_pallas.py::hist_pallas (body _hist_kernel): the
// count of each flat bin index in [0, n_bins), with every index outside that
// range dropped (the walk marks off-image points with n_bins).  The TPU
// kernel serializes one read-modify-write of a 128-lane row per point,
// re-scans the stream once per VMEM slab of bins and sends points outside the
// slab to a dummy row, because a TPU has no atomics; none of that is carried
// over.  Here each thread walks the stream with a grid stride and adds 1 to
// its point's bin with one atomicAdd in global memory.  The kernel adds into
// a histogram the caller owns and has zeroed, so a walk hands it one batch of
// steps after another.  Integer adds commute: the result is exact whatever
// order the atomics land in.
//
// Bound: bytes by the count (4 B read per point; the bins are read and
// written once), but in practice the atomic rate of the L2 slices: the 16 MB
// of bins of a 2000x2000 image stay in the 50 MB L2, and the fern's dense
// fronds send many points of one warp to the same few bins, which serialize
// there.
//
// A histogram owned by thread-block clusters in distributed shared memory
// (slabs of bins, one shared-memory atomic a point in the owning block, one
// flush a counter) was measured slower on an H100 where the bins need several
// slabs (fern_100m: every cluster re-reads the batch and a remote
// shared-memory atomic costs what the L2's does) and gained only ~4 us a
// launch where one slab holds them all (fern_10m); PERF.md keeps its times.

#include <cuda_runtime.h>

namespace {

__global__ void hist_kernel(const int* __restrict__ idx, long long n, int* hist, int n_bins) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int v = idx[i];
    if (v >= 0 && v < n_bins) atomicAdd(hist + v, 1);
  }
}

}  // namespace

// hist[v] += 1 for each of the n indices v in [0, n_bins).  Launches on
// `stream` and returns cudaGetLastError() after the launch.
extern "C" int fractal_hist_accumulate(const int* idx, long long n, int* hist, int n_bins,
                                       void* stream) {
  if (n <= 0 || n_bins <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256;
  const long long want = (n + threads - 1) / threads;
  const long long cap = 132LL * 32;  // enough blocks in flight for every SM
  const int blocks = static_cast<int>(want < cap ? want : cap);
  hist_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(idx, n, hist, n_bins);
  return static_cast<int>(cudaGetLastError());
}
