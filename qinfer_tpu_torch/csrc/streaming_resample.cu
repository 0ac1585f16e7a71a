// Systematic-resample fill of the SMC main path (K3).
//
// Replaces qinfer_tpu/ops/streaming_resample.py::streaming_resample_locations
// (Pallas kernel built by _make_kernel): given copy counts m (sum m = n),
// their exclusive prefix sums `starts` and (n, d) coordinates x, write
// out[starts_i : starts_i + m_i] = x_i, i.e. np.repeat(x, m, axis=0).
//
// What bounds it on an H100: device-memory bytes. It reads starts and x
// and writes out: 4n + 8nd bytes, 50 MB at 2^22 particles and d = 1 and
// 102 MB at 50 000 particles and d = 255, against 3.35 TB/s.
//
// What the design does about it: the TPU kernel streamed input blocks
// through a sequential grid and built each output tile with a one-hot int8
// matrix product, because a TPU has no cheap scatter or gather; none of
// that (the MXU trick, the DMA flush chunks, the (8, 128) layout, the n and
// d padding) is needed here. A block takes a tile of consecutive output
// rows and finds the owner of each row (the last i with starts_i <= row;
// that i always has m_i > 0, since an empty particle shares its start with
// the next one) once per row, not once per word:
//   1. two warps search `starts` for the owners of the tile's first and
//      last rows, each probing 32 points a step (5 dependent loads at 2^22);
//   2. the owners' range of `starts` is copied into shared memory and each
//      row's owner is found there by a binary search; a range too long for
//      shared memory (a long run of empty particles inside the tile) is
//      searched in device memory instead, still once per row;
//   3. the block copies the tile as one flat run of rows * d words:
//      consecutive threads write consecutive words, so every store is
//      coalesced, and read consecutive words of the owner's row, so the
//      reads coalesce too.
// A tile holds about kTileWords words, so that a block at d = 255 moves
// 32 KB each way. The copy moves raw 32-bit words and never does float
// arithmetic, so subnormals, -0 and NaN payloads come out bit for bit. Any
// n < 2^31 and any d work.

#include <cuda_runtime.h>
#include <stdint.h>

#define K3_THREADS 256

namespace {

constexpr int kTileWords = 8192;  // words of output a block writes
constexpr int kMaxRows = 2048;    // rows of a tile (d = 1 .. 4)
constexpr int kRangeCap = 4096;   // starts a block keeps in shared memory
constexpr int kUnroll = 4;        // words in flight per thread
constexpr unsigned kFull = 0xffffffffu;

// Last i in [lo, hi] with starts[i] <= s, given starts[lo] <= s and starts
// non-decreasing; called by all 32 lanes of a warp, each probing one of 32
// points spread over (lo, hi] per step.
__device__ int64_t warp_search(const int32_t* __restrict__ starts, int64_t lo, int64_t hi,
                               int64_t s, int lane) {
  while (hi > lo) {
    const int64_t span = hi - lo;
    const int64_t p = lo + ((lane + 1) * span + 31) / 32;  // p of lane 31 = hi
    const unsigned ok = __ballot_sync(kFull, (int64_t)__ldg(starts + p) <= s);
    const int64_t p_next = __shfl_down_sync(kFull, p, 1);
    const int64_t p_first = __shfl_sync(kFull, p, 0);
    if (ok == 0u) {
      hi = p_first - 1;
    } else {
      const int k = 31 - __clz(ok);  // probes <= s form a prefix of the lanes
      const int64_t new_lo = __shfl_sync(kFull, p, k);
      const int64_t new_hi = __shfl_sync(kFull, p_next, k) - 1;
      hi = k == 31 ? hi : new_hi;
      lo = new_lo;
    }
  }
  return lo;
}

// Last i in [lo, hi] with v[i] <= s, given v[lo] <= s and v non-decreasing:
// over the tile's range of `starts` in shared memory (I = int: 64-bit
// index arithmetic made the d = 1 fill 1.6x slower), or over `starts` in
// device memory when the range is too long for it (I = int64_t).
template <typename I>
__device__ __forceinline__ I last_at_most(const int32_t* v, I lo, I hi, I s) {
  while (lo < hi) {
    const I mid = (lo + hi + 1) >> 1;
    if ((I)v[mid] <= s) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(K3_THREADS)
streaming_resample_kernel(const int32_t* __restrict__ starts, const uint32_t* __restrict__ x,
                          uint32_t* __restrict__ out, int64_t n, int d, int tile_rows) {
  __shared__ int64_t s_bounds[2];
  __shared__ int32_t s_starts[kRangeCap];
  __shared__ int32_t s_owner[kMaxRows];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t r0 = (int64_t)blockIdx.x * tile_rows;
  const int rows = (int)(n - r0 < tile_rows ? n - r0 : tile_rows);

  // 1. owners of the tile's first and last rows
  if (warp < 2) {
    const int64_t owner = warp_search(starts, 0, n - 1, r0 + (warp == 0 ? 0 : rows - 1), lane);
    if (lane == 0) s_bounds[warp] = owner;
  }
  __syncthreads();
  const int64_t lo = s_bounds[0], hi = s_bounds[1];
  const int64_t len = hi - lo + 1;

  // 2. the owner of each row
  if (len <= kRangeCap) {
    for (int j = tid; j < (int)len; j += K3_THREADS) s_starts[j] = __ldg(starts + lo + j);
    __syncthreads();
    for (int r = tid; r < rows; r += K3_THREADS)
      s_owner[r] = (int32_t)(lo + last_at_most<int>(s_starts, 0, (int)len - 1, (int)(r0 + r)));
  } else {
    for (int r = tid; r < rows; r += K3_THREADS)
      s_owner[r] = (int32_t)last_at_most<int64_t>(starts, lo, hi, r0 + r);
  }
  __syncthreads();

  // 3. the tile as one flat run of words; (row, col) of word w advance by
  // K3_THREADS words a step without a division
  const int64_t words = (int64_t)rows * d;
  uint32_t* dst = out + r0 * d;
  const int step_rows = K3_THREADS / d, step_cols = K3_THREADS - step_rows * d;
  int64_t w = tid;
  int row = tid / d, col = tid - row * d;
  while (w < words) {
    uint32_t v[kUnroll];
    int64_t at[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      at[u] = w;
      if (w < words) v[u] = __ldg(x + (int64_t)s_owner[row] * d + col);
      w += K3_THREADS;
      row += step_rows;
      col += step_cols;
      if (col >= d) {
        col -= d;
        ++row;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (at[u] < words) dst[at[u]] = v[u];
  }
}

}  // namespace

extern "C" {

// starts: n int32 exclusive prefix sums of the copy counts; x, out: (n, d)
// 32-bit words, row-major.
int qk_streaming_resample_locations(const int32_t* starts, const uint32_t* x, uint32_t* out,
                                    long long n, long long d, void* stream) {
  if (n <= 0 || d <= 0 || n > INT32_MAX || d > INT32_MAX) return (int)cudaErrorInvalidValue;
  long long tile_rows = kTileWords / d;
  if (tile_rows < 1) tile_rows = 1;
  if (tile_rows > kMaxRows) tile_rows = kMaxRows;
  const long long blocks = (n + tile_rows - 1) / tile_rows;
  streaming_resample_kernel<<<(unsigned)blocks, K3_THREADS, 0, (cudaStream_t)stream>>>(
      starts, x, out, (int64_t)n, (int)d, (int)tile_rows);
  return (int)cudaGetLastError();
}

}  // extern "C"
