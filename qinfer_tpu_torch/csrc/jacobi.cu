// Batched parallel-ordered cyclic Jacobi for small symmetric matrices: the
// eigensolver (K6) and the fused PSD-cone projection (K4, K5) of the
// tomography path.
//
// Replaces three Pallas kernels of qinfer_tpu/ops/jacobi.py:
//   K4 qinfer_tpu/ops/jacobi.py::jacobi_project_lanes        (_make_kernel, project=True)
//   K5 qinfer_tpu/ops/jacobi.py::jacobi_project_lanes_looped (_make_kernel_looped)
//   K6 qinfer_tpu/ops/jacobi.py::jacobi_eigh_lanes           (_make_kernel, project=False)
// K4 and K6 run the block kernel (jacobi_kernel, below): one matrix per d/2
// threads in shared memory, K6 its PROJECT = false instantiation. K5, the
// projection of the process path's 32 x 32 Choi states, runs the warp
// kernel (jacobi_project_warp_kernel, after it), which keeps each matrix
// in registers.
//
// What it computes, per (d, d) matrix, d even, 2 <= d <= 32: `sweeps` sweeps
// of d - 1 round-robin rounds (the circle-method schedule of
// _round_robin_rounds); in each round, d/2 disjoint plane rotations
// G = [[c, s], [-s, c]] on (p, q) with the angle that zeroes a_pq (skipped
// when |a_pq| <= 1e-30), applied as A <- G^T A G and V <- V G. K6 writes the
// diagonal of A (the eigenvalues, unsorted) and V. K4/K5 clip the
// eigenvalues at 0, rescale them to sum to `trace` and rebuild
// V diag(ev) V^T, computing each upper-triangle entry once and storing it to
// (i, j) and (j, i), so the output is exactly symmetric.
//
// What bounds the block kernel on an H100: shared-memory traffic. Each
// rotation loads and stores two columns and two rows of A and two columns
// of V, 12 d words: at d = 32 and 8 sweeps 1.5e6 words a matrix, 7.6e10
// for 50 000 matrices, against ~8.4e12 a second for the card. Device
// memory is touched twice (one read, one write of the batch).
//
// What the design does about it: one matrix per group of d/2 threads, with
// A and V in shared memory (8.6 KB at d = 32; row stride d + 1, so the row
// phase, where thread k walks rows p_k and q_k, hits 32 different banks).
// In each round thread k owns pair k. The pairs are disjoint, so every
// thread reads its pivots from the round's starting A, then all apply their
// column rotations (of A and V), a barrier, then their row rotations. This
// is the GPU form of the TPU's pair-by-pair order: the rotations of one
// round commute, so the two differ only in rounding. The block's matrices
// are consecutive in memory, so loads and stores are coalesced copies
// between device and shared memory. Slots past n hold the identity, a fixed
// point, so every thread runs the same loop and reaches every barrier.
//
// Numerics: every multiply, add and divide is an explicitly rounded
// intrinsic (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn), so no product is
// contracted into an FMA and each step rounds exactly as the plain PyTorch
// version's separate elementwise ops do. No fast math and no flush to zero:
// the pivot guard and the "theta^2 overflows to inf, so t = 0" rule rely on
// IEEE denormals and infinities. Embedded Hermitian matrices have every
// eigenvalue twice; exact degeneracy is the normal case and needs nothing
// special (a zero pivot is skipped).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// threads per block; a block holds 64 / (d/2) matrices
constexpr int kThreads = 64;
constexpr int kMaxD = 32;

// i-th slot of the circle-method ring in round `round`: slot 0 stays 0, the
// others rotate right by one each round (qinfer_tpu/ops/jacobi.py:49)
__device__ __forceinline__ int ring_at(int i, int round, int d) {
  if (i == 0) return 0;
  int r = (i - 1 - round) % (d - 1);
  if (r < 0) r += d - 1;
  return 1 + r;
}

// the annihilating rotation of pivot (p, q), operation by operation as in
// qinfer_tpu/ops/jacobi.py:77-88
__device__ __forceinline__ void rotation(float app, float aqq, float apq, float* c, float* s) {
  const bool small = fabsf(apq) <= 1e-30f;
  const float theta = __fdiv_rn(__fsub_rn(aqq, app), small ? 1.0f : __fmul_rn(2.0f, apq));
  const float sgn = theta >= 0.0f ? 1.0f : -1.0f;
  const float t =
      __fdiv_rn(sgn, __fadd_rn(fabsf(theta), __fsqrt_rn(__fadd_rn(__fmul_rn(theta, theta), 1.0f))));
  const float cc = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(__fmul_rn(t, t), 1.0f)));
  *c = small ? 1.0f : cc;
  *s = small ? 0.0f : __fmul_rn(t, cc);
}

__device__ __forceinline__ void rotate(float* xp, float* xq, float c, float s) {
  const float p = *xp, q = *xq;
  *xp = __fsub_rn(__fmul_rn(c, p), __fmul_rn(s, q));
  *xq = __fadd_rn(__fmul_rn(s, p), __fmul_rn(c, q));
}

// a: (n, d, d) row-major. PROJECT: out (n, d, d) projections. Otherwise:
// out (n, d, d) eigenvectors V (columns), ev_out (n, d) eigenvalues.
template <bool PROJECT>
__global__ void __launch_bounds__(kThreads)
jacobi_kernel(const float* __restrict__ a, float* __restrict__ out, float* __restrict__ ev_out,
              int64_t n, int d, int sweeps, float trace, float eps) {
  extern __shared__ float smem[];
  const int h = d / 2, ld = d + 1, dd = d * d;
  const int per_block = blockDim.x / h;
  const int mat = 2 * d * ld + d;  // A, V (padded rows) and d scaled eigenvalues
  const int64_t m0 = (int64_t)blockIdx.x * per_block;
  const int count = (int)(n - m0 < per_block ? n - m0 : per_block);

  for (int e = threadIdx.x; e < per_block * dd; e += blockDim.x) {
    const int m = e / dd, ij = e - m * dd, i = ij / d, j = ij - i * d;
    float* A = smem + m * mat;
    const float eye = i == j ? 1.0f : 0.0f;
    A[i * ld + j] = m < count ? a[m0 * dd + e] : eye;
    A[d * ld + i * ld + j] = eye;
  }
  __syncthreads();

  const int slot = threadIdx.x / h, k = threadIdx.x - slot * h;
  float* A = smem + slot * mat;
  float* V = A + d * ld;
  float* ev = V + d * ld;

  for (int sweep = 0; sweep < sweeps; ++sweep) {
    for (int round = 0; round < d - 1; ++round) {
      const int x = ring_at(k, round, d), y = ring_at(d - 1 - k, round, d);
      const int p = x < y ? x : y, q = x < y ? y : x;
      float c, s;
      rotation(A[p * ld + p], A[q * ld + q], A[p * ld + q], &c, &s);
      __syncthreads();  // every pivot read before any column moves
      for (int r = 0; r < d; ++r) {
        rotate(&A[r * ld + p], &A[r * ld + q], c, s);
        rotate(&V[r * ld + p], &V[r * ld + q], c, s);
      }
      __syncthreads();
      for (int r = 0; r < d; ++r) rotate(&A[p * ld + r], &A[q * ld + r], c, s);
      __syncthreads();
    }
  }

  if (PROJECT) {
    // clip, rescale to `trace`, rebuild V diag(ev) V^T into A's storage
    float tr = fmaxf(A[0], 0.0f);
    for (int i = 1; i < d; ++i) tr = __fadd_rn(tr, fmaxf(A[i * ld + i], 0.0f));
    const float scale = __fdiv_rn(trace, fmaxf(tr, eps));
    ev[k] = __fmul_rn(fmaxf(A[k * ld + k], 0.0f), scale);
    ev[k + h] = __fmul_rn(fmaxf(A[(k + h) * ld + k + h], 0.0f), scale);
    __syncthreads();
    // thread k rebuilds rows k and d-1-k: d + 1 upper-triangle entries
    for (int half = 0; half < 2; ++half) {
      const int i = half == 0 ? k : d - 1 - k;
      for (int j = i; j < d; ++j) {
        float acc = __fmul_rn(__fmul_rn(V[i * ld], ev[0]), V[j * ld]);
        for (int b = 1; b < d; ++b)
          acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(V[i * ld + b], ev[b]), V[j * ld + b]));
        A[i * ld + j] = acc;
        A[j * ld + i] = acc;
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < count * dd; e += blockDim.x) {
      const int m = e / dd, ij = e - m * dd, i = ij / d, j = ij - i * d;
      out[m0 * dd + e] = smem[m * mat + i * ld + j];
    }
  } else {
    __syncthreads();
    for (int e = threadIdx.x; e < count * dd; e += blockDim.x) {
      const int m = e / dd, ij = e - m * dd, i = ij / d, j = ij - i * d;
      out[m0 * dd + e] = smem[m * mat + d * ld + i * ld + j];
    }
    for (int e = threadIdx.x; e < count * d; e += blockDim.x) {
      const int m = e / d, i = e - m * d;
      ev_out[m0 * d + e] = smem[m * mat + i * ld + i];
    }
  }
}

template <bool PROJECT>
int launch(const float* a, float* out, float* ev_out, long long n, int d, int sweeps, float trace,
           float eps, void* stream) {
  if (n <= 0 || d < 2 || d > kMaxD || d % 2 != 0 || sweeps < 0) return (int)cudaErrorInvalidValue;
  const int h = d / 2;
  const int per_block = kThreads / h;
  const long long blocks = (n + per_block - 1) / per_block;
  const size_t smem = (size_t)per_block * (2 * d * (d + 1) + d) * sizeof(float);
  jacobi_kernel<PROJECT><<<(unsigned)blocks, per_block * h, smem, (cudaStream_t)stream>>>(
      a, out, ev_out, (int64_t)n, d, sweeps, trace, eps);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K5: the projection with each matrix in the registers of one warp.
//
// What bounds it on an H100: float32 operations. At d = 32 and 8 sweeps a
// matrix takes 8 x 31 rounds x 16 rotations x (18 d + 15) ~ 2.35e6
// separately rounded operations (no FMA contraction allowed), 1.2e11 for
// 50 000 matrices, ~3.5 ms at the card's 3.35e13 a second. The block
// kernel's shared-memory traffic (above) would hold it near 9 ms.
//
// What the design does about it: lane r of a warp holds row r of A and row
// r of V in registers (2 d floats), d a template parameter. The registers
// hold the row's entries in the ring's slot order: in round t of a sweep,
// register i holds column ring_at(i, t), so every pair of the round sits in
// the same two registers, (k, d - 1 - k), and the rounds run as a loop of
// one short body (unrolled rounds cost build time and registers, and ran
// slower: PERF.md). After each round the registers shift one slot along
// the ring (about 2 d moves per lane); after the d - 1 rounds of a sweep
// they are back in column order. Per round:
//   * each lane knows its row's slot; the mate's row sits in the opposite
//     slot (a closed form mirrored by
//     qinfer_tpu_torch/ops/jacobi.py::round_robin_mate); the lane picks
//     a_rr and a_r,mate out of its registers (a tree of selects over the
//     d/2 register pairs: the two always form one) and takes
//     a_pp, a_qq and a_pq of its pair by 3 shuffles; both lanes of a pair
//     then compute the same (c, s) with the same rounded operations;
//   * column rotations: pair k's c and signed sine s' come from the row in
//     slot k, with s' = -s if that row is the pair's p: lane k gathers
//     them (2 shuffles) and every lane reads them from lane k (2 shuffles
//     a pair); then u, w = registers k, d - 1 - k become c u + s' w and
//     c w - s' u: exactly c x_p - s x_q and s x_p + c x_q, whichever of
//     the two registers holds column p;
//   * row rotation: each lane takes its mate's registers by d shuffles and
//     sets a_rj = c a_rj + s' a_mate,j, with its own s': exactly
//     c a_pj - s a_qj on row p and s a_pj + c a_qj on row q.
// The warp needs no barrier but __syncwarp. Loads and stores of the
// matrices go through a (d, d + 1) tile of shared memory per warp, so that
// both device-memory copies are coalesced. The epilogue takes each lane's
// eigenvalue by a shuffle per column and rebuilds row r of V diag(ev) V^T
// with V's other rows by shuffles; an entry below the diagonal is computed
// in the order of its mirror above it, so the output is exactly symmetric.
// Every operation is the block kernel's, so the two agree to the bit.

constexpr int kWarpsPerBlock = 4;

// t[idx] for a runtime idx in [0, W), W a power of 2: one level of selects
// per bit of idx, each a loop of constant length, so that every index is a
// constant once unrolled and the arrays stay in registers
template <int W>
__device__ __forceinline__ float select_tree(const float (&t)[W], int idx) {
  if constexpr (W == 1) {
    return t[0];
  } else {
    float half[W / 2];
#pragma unroll
    for (int i = 0; i < W / 2; ++i) half[i] = (idx & 1) ? t[2 * i + 1] : t[2 * i];
    return select_tree<W / 2>(half, idx >> 1);
  }
}

// a[idx] for a runtime idx in [0, N)
template <int N>
__device__ __forceinline__ float pick(const float (&a)[N], int idx) {
  constexpr int kWidth = N <= 2 ? 2 : N <= 4 ? 4 : N <= 8 ? 8 : N <= 16 ? 16 : 32;
  float t[kWidth];
#pragma unroll
  for (int i = 0; i < kWidth; ++i) t[i] = a[i < N ? i : N - 1];
  return select_tree<kWidth>(t, idx);
}

// (u, w) <- (c u + s w, c w - s u), each operation rounded on its own
__device__ __forceinline__ void slot_rotate(float* u, float* w, float c, float s) {
  const float x = *u, y = *w;
  *u = __fadd_rn(__fmul_rn(c, x), __fmul_rn(s, y));
  *w = __fadd_rn(__fmul_rn(c, y), __fmul_rn(-s, x));
}

// Round t of a sweep, the registers in the round's slot order; `slot` is
// the slot of this lane's row r.
template <int D>
__device__ __forceinline__ void jacobi_round(float (&A)[D], float (&V)[D], int r, int lane, int t,
                                             int slot) {
  constexpr unsigned kAll = 0xffffffffu;
  const int opposite = D - 1 - slot;
  const int mate = ring_at(opposite, t, D);
  const int p = r < mate ? r : mate, q = r < mate ? mate : r;
  // a_rr and a_r,mate sit in the pair of slots (k, d - 1 - k) with
  // k = min(slot, opposite): one pick of a pair
  const int k_own = slot < opposite ? slot : opposite;
  float front[D / 2], back[D / 2];
#pragma unroll
  for (int k = 0; k < D / 2; ++k) {
    front[k] = A[k];
    back[k] = A[D - 1 - k];
  }
  const float u = pick(front, k_own), w = pick(back, k_own);
  const float diag = slot < opposite ? u : w, off = slot < opposite ? w : u;
  float c, s;
  rotation(__shfl_sync(kAll, diag, p), __shfl_sync(kAll, diag, q), __shfl_sync(kAll, off, p),
           &c, &s);
  const float s_row = r == p ? -s : s;
  // lane k gathers pair k's c and s' from the row in slot k; then every
  // lane reads them from lane k, a constant
  const int holder = ring_at(lane, t, D);
  const float c_k = __shfl_sync(kAll, c, holder), s_k = __shfl_sync(kAll, s_row, holder);
#pragma unroll
  for (int k = 0; k < D / 2; ++k) {
    const float ck = __shfl_sync(kAll, c_k, k), sk = __shfl_sync(kAll, s_k, k);
    slot_rotate(&A[k], &A[D - 1 - k], ck, sk);
    slot_rotate(&V[k], &V[D - 1 - k], ck, sk);
  }
#pragma unroll
  for (int j = 0; j < D; ++j) {
    const float mate_aj = __shfl_sync(kAll, A[j], mate);
    A[j] = __fadd_rn(__fmul_rn(c, A[j]), __fmul_rn(s_row, mate_aj));
  }
}

// the next round's slot order: slots 1 .. d - 1 move one along the ring,
// slot 0 stays
template <int D>
__device__ __forceinline__ void shift_ring(float (&X)[D]) {
  if constexpr (D > 2) {
    const float last = X[D - 1];
#pragma unroll
    for (int i = D - 1; i > 1; --i) X[i] = X[i - 1];
    X[1] = last;
  }
}

template <int D>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
jacobi_project_warp_kernel(const float* __restrict__ a, float* __restrict__ out, int64_t n,
                           int sweeps, float trace, float eps) {
  constexpr int LD = D + 1, DD = D * D;
  constexpr unsigned kAll = 0xffffffffu;
  __shared__ float stage[kWarpsPerBlock][D * LD];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t m = (int64_t)blockIdx.x * kWarpsPerBlock + warp;
  if (m >= n) return;  // whole warps only: no block barrier follows
  float* S = stage[warp];

  const float* src = a + m * DD;
  for (int e = lane; e < DD; e += 32) S[(e / D) * LD + e % D] = src[e];
  __syncwarp();
  // lane r holds row r; lanes past d hold a copy of row d - 1 and are
  // never read
  const int r = lane < D ? lane : D - 1;
  float A[D], V[D];
#pragma unroll
  for (int j = 0; j < D; ++j) {
    A[j] = S[r * LD + j];
    V[j] = j == r ? 1.0f : 0.0f;
  }

  for (int sweep = 0; sweep < sweeps; ++sweep) {
    int slot = r;  // round 0's ring is the column order
#pragma unroll 1
    for (int t = 0; t < D - 1; ++t) {
      jacobi_round<D>(A, V, r, lane, t, slot);
      shift_ring<D>(A);
      shift_ring<D>(V);
      slot = slot == 0 ? 0 : (slot == D - 1 ? 1 : slot + 1);
    }
  }

  // clip, rescale to `trace` (the clipped trace summed in index order)
  const float own = pick(A, r);
  float ev[D];
#pragma unroll
  for (int j = 0; j < D; ++j) ev[j] = fmaxf(__shfl_sync(kAll, own, j), 0.0f);
  float tr = ev[0];
#pragma unroll
  for (int j = 1; j < D; ++j) tr = __fadd_rn(tr, ev[j]);
  const float scale = __fdiv_rn(trace, fmaxf(tr, eps));
#pragma unroll
  for (int j = 0; j < D; ++j) ev[j] = __fmul_rn(ev[j], scale);

  // row r of V diag(ev) V^T; entry (r, j) below the diagonal as (j, r)
#pragma unroll 1
  for (int j = 0; j < D; ++j) {
    const bool upper = j >= r;
    float acc = 0.0f;
#pragma unroll
    for (int b = 0; b < D; ++b) {
      const float vjb = __shfl_sync(kAll, V[b], j);
      const float term = __fmul_rn(__fmul_rn(upper ? V[b] : vjb, ev[b]), upper ? vjb : V[b]);
      acc = b == 0 ? term : __fadd_rn(acc, term);
    }
    if (lane < D) S[r * LD + j] = acc;
  }
  __syncwarp();
  float* dst = out + m * DD;
  for (int e = lane; e < DD; e += 32) dst[e] = S[(e / D) * LD + e % D];
}

template <int D>
int launch_warp(const float* a, float* out, long long n, int sweeps, float trace, float eps,
                void* stream) {
  const long long blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  jacobi_project_warp_kernel<D><<<(unsigned)blocks, kWarpsPerBlock * 32, 0,
                                  (cudaStream_t)stream>>>(a, out, (int64_t)n, sweeps, trace, eps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K4 / K5: out (n, d, d) = PSD projection of each a (n, d, d), rescaled to
// trace `trace` (eps floors the clipped trace before the division).
int qk_jacobi_project(const float* a, float* out, long long n, int d, int sweeps, float trace,
                      float eps, void* stream) {
  return launch<true>(a, out, nullptr, n, d, sweeps, trace, eps, stream);
}

// K5: qk_jacobi_project's contract, by the warp kernel (d even, 2 .. 32).
int qk_jacobi_project_warp(const float* a, float* out, long long n, int d, int sweeps,
                           float trace, float eps, void* stream) {
  if (n <= 0 || sweeps < 0) return (int)cudaErrorInvalidValue;
  switch (d) {
#define QK_WARP_CASE(D) \
  case D:               \
    return launch_warp<D>(a, out, n, sweeps, trace, eps, stream);
    QK_WARP_CASE(2) QK_WARP_CASE(4) QK_WARP_CASE(6) QK_WARP_CASE(8)
    QK_WARP_CASE(10) QK_WARP_CASE(12) QK_WARP_CASE(14) QK_WARP_CASE(16)
    QK_WARP_CASE(18) QK_WARP_CASE(20) QK_WARP_CASE(22) QK_WARP_CASE(24)
    QK_WARP_CASE(26) QK_WARP_CASE(28) QK_WARP_CASE(30) QK_WARP_CASE(32)
#undef QK_WARP_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// K6: ev (n, d) unsorted eigenvalues and v (n, d, d) eigenvectors (columns)
// of each a (n, d, d), a ~= v diag(ev) v^T.
int qk_jacobi_eigh(const float* a, float* ev, float* v, long long n, int d, int sweeps,
                   void* stream) {
  return launch<false>(a, v, ev, n, d, sweeps, 0.0f, 0.0f, stream);
}

}  // extern "C"
