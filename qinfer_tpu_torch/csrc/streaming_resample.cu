// Systematic-resample fill of the SMC main path (K3).
//
// Replaces qinfer_tpu/ops/streaming_resample.py::streaming_resample_locations
// (Pallas kernel built by _make_kernel): given copy counts m (sum m = n),
// their exclusive prefix sums `starts` and (n, d) coordinates x, write
// out[starts_i : starts_i + m_i] = x_i, i.e. np.repeat(x, m, axis=0).
//
// What bounds it on an H100: device-memory bytes. It reads starts and x
// and writes out: at 2^22 particles and d = 1, 48 MB a resample against
// 3.35 TB/s.
//
// What the design does about it: the TPU kernel streamed input blocks
// through a sequential grid and built each output tile with a one-hot int8
// matrix product, because a TPU has no cheap scatter or gather; none of
// that (the MXU trick, the DMA flush chunks, the (8, 128) layout, the n and
// d padding) is needed here. Each thread takes one output slot s, finds its
// owner by a binary search over `starts` (the last i with starts_i <= s;
// that i always has m_i > 0, since an empty particle shares its start with
// the next one) and copies the owner's row. Neighbouring threads search for
// neighbouring slots, so their searches walk the same cache lines, and
// `starts` (16 MB at 2^22) stays in the 50 MB L2. Writes are coalesced. The
// copy moves raw 32-bit words and never does float arithmetic, so
// subnormals, -0 and NaN payloads come out bit for bit. Any n and d work.

#include <cuda_runtime.h>
#include <stdint.h>

#define K3_THREADS 256

namespace {

__global__ void __launch_bounds__(K3_THREADS)
streaming_resample_kernel(const int32_t* __restrict__ starts, const uint32_t* __restrict__ x,
                          uint32_t* __restrict__ out, int64_t n, int64_t d) {
  const int64_t stride = (int64_t)gridDim.x * K3_THREADS;
  for (int64_t s = (int64_t)blockIdx.x * K3_THREADS + threadIdx.x; s < n; s += stride) {
    // last i with starts[i] <= s; starts[0] == 0 <= s, so it exists
    int64_t lo = 0, hi = n - 1;
    while (lo < hi) {
      const int64_t mid = (lo + hi + 1) >> 1;
      if ((int64_t)__ldg(starts + mid) <= s) {
        lo = mid;
      } else {
        hi = mid - 1;
      }
    }
    const uint32_t* src = x + lo * d;
    uint32_t* dst = out + s * d;
    for (int64_t k = 0; k < d; ++k) dst[k] = __ldg(src + k);
  }
}

}  // namespace

extern "C" {

// starts: n int32 exclusive prefix sums of the copy counts; x, out: (n, d)
// 32-bit words, row-major.
int qk_streaming_resample_locations(const int32_t* starts, const uint32_t* x, uint32_t* out,
                                    long long n, long long d, void* stream) {
  if (n <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  int64_t blocks = (n + K3_THREADS - 1) / K3_THREADS;
  if (blocks > 132 * 16) blocks = 132 * 16;
  streaming_resample_kernel<<<(int)blocks, K3_THREADS, 0, (cudaStream_t)stream>>>(starts, x, out,
                                                                                n, d);
  return (int)cudaGetLastError();
}

}  // extern "C"
