// The counting pass of systematic resampling: copy counts and output
// offsets from the weights, for every caller of
// qinfer_tpu_torch.resamplers.counting_multiplicities_from_u on the card.
//
// Replaces no Pallas kernel. The JAX package computes the pass with
// jnp.cumsum and jax.lax.cummax (qinfer_tpu/resamplers.py:164); PyTorch's
// cumsum and cummax scan a row inside ONE thread block, so at 2^22
// particles one SM did the work while the others idled (11.7 ms a call on
// an H100). This chain computes, per row of n weights w with uniform
// offset u and n_out slots:
//   v_i   = the prefix sum of w up to i (the order below), total = v_{n-1}
//   c_i   = min(v_i / max(total, EPS), 1)
//   up_i  = n_out if c_i >= 1 or i = n - 1, else ceil(n_out * c_i - u)
//   m_i   = up_i - up_{i-1},  offsets_i = max(up_{i-1}, 0),  up_{-1} = 0
// which is the plain PyTorch version's arithmetic, op for op (IEEE
// division, no multiply contracted into an FMA), with another summation
// order and no cummax.
//
// What bounds it on an H100: device-memory bytes. It must read each weight
// (4 B) and write its count and offset (8 B): 12 B a particle, 50 MB at
// 2^22 against 3.35 TB/s, about 0.015 ms. This chain reads the weights
// twice (16 B a particle).
//
// What the design does about it, and why the counts are monotone without a
// cummax:
//   A. counting_pass_tile_totals: one block per tile of kTile weights of a
//      row (rows x tiles blocks) scans its tile and writes the tile's total.
//   B. counting_pass_carry: one warp per row carries the tile totals in
//      tile order in float64, P_{k+1} = P_k + T_k, and writes each tile's
//      carry P_k and the row's total P_K.
//   C. counting_pass_counts: each block scans its tile again with the same
//      arithmetic as A, takes v = float(P_k + s) for each tile prefix s,
//      and writes the counts and offsets through shared memory, coalesced.
//   A row of one tile runs C alone (carry 0, total its own tile's).
// The tile's scan nests four levels, each a sum carried strictly in order:
// a thread's kPer consecutive weights; the 32 thread totals of a warp; the
// kWarps warp totals of the block; the tiles. A prefix is
//   v = float(P_k + (warp_base + (lane_base + local)))
// where each base is the previous base plus the previous part's own total,
// added in the same rounding. Weights are non-negative and every rounded
// add is monotone in each argument, so the last prefix of one part equals
// the next part's base exactly and the first prefix of the next part is at
// least that base: v never decreases, nor do c and up, so m >= 0 and the
// offsets are the exclusive sums of m; sum m = up_{n-1} = n_out. A zero
// weight repeats the prefix before it, so it gets no slot (but the last
// particle, when the total is below EPS). The carry between tiles is kept
// in float64 so that the 2^10-2^12 tile totals of a long row add no drift
// (in float32 they moved a count by up to 10 slots from a float64 count at
// 10^7 particles); each prefix is still rounded to float32. No atomics and
// no order that depends on timing: the same input gives the same bits, and
// a row of a batch gives what the row gives alone.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 16;                       // consecutive weights a thread adds
constexpr int kTile = kThreads * kPer;         // 4096 weights a block
constexpr int kPadded = kTile + kTile / 32;    // one pad word per 32: no bank conflicts
constexpr int kCarryWarps = 4;                 // rows a block of pass B
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int padded(int i) { return i + (i >> 5); }

// The tile's scan, called by every thread of the block: loads the tile
// [start, start + kTile) of `row` (zeros past n) into s_buf, then returns
// in loc the thread's kPer local prefixes and its lane and warp bases, and
// in total the tile's own total (the prefix of its last slot). Ends with
// every thread past a barrier that follows its last read of s_buf.
__device__ __forceinline__ void tile_scan(const float* __restrict__ row, int64_t n, int64_t start,
                                          float* s_buf, float* s_warp, float (&loc)[kPer],
                                          float& lane_base, float& warp_base, float& total) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int i = tid + r * kThreads;
    s_buf[padded(i)] = start + i < n ? __ldg(row + start + i) : 0.0f;
  }
  __syncthreads();
  float acc = 0.0f;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    acc = __fadd_rn(acc, s_buf[padded(tid * kPer + j)]);
    loc[j] = acc;
  }
  float chain = 0.0f;
  lane_base = 0.0f;
#pragma unroll
  for (int l = 0; l < 32; ++l) {
    const float t = __shfl_sync(kFull, acc, l);
    if (l == lane) lane_base = chain;
    chain = __fadd_rn(chain, t);
  }
  if (lane == 0) s_warp[warp] = chain;
  __syncthreads();
  chain = 0.0f;
  warp_base = 0.0f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w == warp) warp_base = chain;
    chain = __fadd_rn(chain, s_warp[w]);
  }
  total = chain;
}

// The ceiling of one prefix v: the plain version's clamp, `reached` rule
// and ceil(n_out * c - u), each op rounded on its own.
__device__ __forceinline__ int ceiling(float v, float denom, int n_out, float u, bool last) {
  const float c = fminf(__fdiv_rn(v, denom), 1.0f);
  if (last || c >= 1.0f) return n_out;
  return (int)ceilf(__fsub_rn(__fmul_rn((float)n_out, c), u));
}

__global__ void __launch_bounds__(kThreads)
counting_pass_tile_totals(const float* __restrict__ w, int64_t n, int tiles,
                          double* __restrict__ sums) {
  __shared__ float s_buf[kPadded];
  __shared__ float s_warp[kWarps];
  const int64_t row = blockIdx.x / tiles;
  const int tile = (int)(blockIdx.x - row * tiles);
  float loc[kPer], lane_base, warp_base, total;
  tile_scan(w + row * n, n, (int64_t)tile * kTile, s_buf, s_warp, loc, lane_base, warp_base,
            total);
  if (threadIdx.x == 0) sums[row * (tiles + 1) + tile] = (double)total;
}

// In place over each row's tiles + 1 doubles: tile totals in, each tile's
// carry (the sum of the totals before it, added in tile order) out, and
// the row's total in the last slot. A lane loads the next 32 totals while
// the warp adds the current ones.
__global__ void counting_pass_carry(double* __restrict__ sums, int tiles, int64_t rows) {
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kCarryWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  double* s = sums + row * (tiles + 1);
  double carry = 0.0;
  double t = lane < tiles ? s[lane] : 0.0;
  for (int base = 0; base < tiles; base += 32) {
    const int next = base + 32 + lane;
    const double t_next = next < tiles ? s[next] : 0.0;
    double mine = 0.0;
#pragma unroll
    for (int l = 0; l < 32; ++l) {
      const double tl = __shfl_sync(kFull, t, l);
      if (l == lane) mine = carry;
      carry = __dadd_rn(carry, tl);
    }
    if (base + lane < tiles) s[base + lane] = mine;
    t = t_next;
  }
  if (lane == 0) s[tiles] = carry;
}

// sums: the carries and totals of pass B, or null for rows of one tile;
// u: one offset a row (u_stride 1), one for all rows (0), or null (u_value).
__global__ void __launch_bounds__(kThreads)
counting_pass_counts(const float* __restrict__ w, int64_t n, int tiles,
                     const double* __restrict__ sums, const float* __restrict__ u, int u_stride,
                     float u_value, int n_out, float eps, int32_t* __restrict__ m,
                     int32_t* __restrict__ offsets) {
  __shared__ float s_buf[kPadded];  // the tile's weights, then its ceilings
  __shared__ float s_warp[kWarps];
  const int tid = threadIdx.x;
  const int64_t row = blockIdx.x / tiles;
  const int tile = (int)(blockIdx.x - row * tiles);
  const int64_t start = (int64_t)tile * kTile;
  float loc[kPer], lane_base, warp_base, tile_total;
  tile_scan(w + row * n, n, start, s_buf, s_warp, loc, lane_base, warp_base, tile_total);

  double carry = 0.0;
  float total = tile_total;
  if (sums != nullptr) {
    carry = sums[row * (tiles + 1) + tile];
    total = (float)sums[row * (tiles + 1) + tiles];
  }
  const float denom = fmaxf(total, eps);
  const float off = u != nullptr ? __ldg(u + row * u_stride) : u_value;

  int* s_up = reinterpret_cast<int*>(s_buf);
  const int64_t first = start + (int64_t)tid * kPer;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const float s = __fadd_rn(warp_base, __fadd_rn(lane_base, loc[j]));
    const float v = __double2float_rn(__dadd_rn(carry, (double)s));
    s_up[padded(tid * kPer + j)] = ceiling(v, denom, n_out, off, first + j == n - 1);
  }
  // the prefix before the tile is the last prefix of the tile before,
  // float(P_{k-1} + T_{k-1}) = float(P_k)
  const int before = tile > 0 ? ceiling(__double2float_rn(carry), denom, n_out, off, false) : 0;
  __syncthreads();
  int32_t* m_row = m + row * n;
  int32_t* off_row = offsets + row * n;
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int i = tid + r * kThreads;
    if (start + i < n) {
      const int lo = i > 0 ? s_up[padded(i - 1)] : before;
      m_row[start + i] = s_up[padded(i)] - lo;
      off_row[start + i] = lo > 0 ? lo : 0;
    }
  }
}

}  // namespace

extern "C" {

int qk_counting_pass_tile(void) { return kTile; }

// w: rows x n float32 weights, row-major; u: see counting_pass_counts;
// sums: rows * (tiles + 1) float64 scratch, tiles = ceil(n / kTile) (unused
// when tiles is 1); m, offsets: rows x n int32 out.
int qk_counting_pass(const float* w, long long rows, long long n, const float* u, int u_stride,
                     float u_value, long long n_out, float eps, double* sums, int32_t* m,
                     int32_t* offsets, void* stream) {
  if (rows <= 0 || n <= 0 || n_out < 0 || n_out > INT32_MAX) return (int)cudaErrorInvalidValue;
  const long long tiles = (n + kTile - 1) / kTile;
  if (rows * tiles > INT32_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned blocks = (unsigned)(rows * tiles);
  if (tiles > 1) {
    counting_pass_tile_totals<<<blocks, kThreads, 0, s>>>(w, (int64_t)n, (int)tiles, sums);
    const unsigned carry_blocks = (unsigned)((rows + kCarryWarps - 1) / kCarryWarps);
    counting_pass_carry<<<carry_blocks, 32 * kCarryWarps, 0, s>>>(sums, (int)tiles,
                                                                 (int64_t)rows);
  }
  counting_pass_counts<<<blocks, kThreads, 0, s>>>(w, (int64_t)n, (int)tiles,
                                                   tiles > 1 ? sums : nullptr, u, u_stride,
                                                   u_value, (int)n_out, eps, m, offsets);
  return (int)cudaGetLastError();
}

}  // extern "C"
