// Batched parallel-ordered cyclic Jacobi for small symmetric matrices: the
// eigensolver (K6) and the fused PSD-cone projection (K4, K5) of the
// tomography path.
//
// Replaces three Pallas kernels of qinfer_tpu/ops/jacobi.py:
//   K4 qinfer_tpu/ops/jacobi.py::jacobi_project_lanes        (_make_kernel, project=True)
//   K5 qinfer_tpu/ops/jacobi.py::jacobi_project_lanes_looped (_make_kernel_looped)
//   K6 qinfer_tpu/ops/jacobi.py::jacobi_eigh_lanes           (_make_kernel, project=False)
// All three run one warp kernel (jacobi_warp_kernel, below), K6 its
// PROJECT = false instantiation.
//
// What it computes, per (d, d) matrix, d even, 2 <= d <= 32: `sweeps` sweeps
// of d - 1 round-robin rounds (the circle-method schedule of
// _round_robin_rounds); in each round, d/2 disjoint plane rotations
// G = [[c, s], [-s, c]] on (p, q) with the angle that zeroes a_pq (skipped
// when |a_pq| <= 1e-30), applied as A <- G^T A G and V <- V G: the columns
// of A and V for every pair from the round's starting pivots, then the rows
// of A. K6 writes the diagonal of A (the eigenvalues, unsorted) and V.
// K4/K5 clip the eigenvalues at 0, rescale them to sum to `trace` and
// rebuild V diag(ev) V^T, computing each upper-triangle entry once and
// storing it to (i, j) and (j, i), so the output is exactly symmetric.
//
// What bounds it on an H100: float32 operations, issued one warp
// instruction at a time. A rotation of a pair takes ~15 operations for the
// angle and 18 d for the columns of A and V and the rows of A, each rounded
// on its own (no FMA contraction allowed): at (1e5, 8, 8) and 8 sweeps
// 3.6e9 operations, ~0.11 ms at the card's 3.35e13 a second; at
// (5e4, 32, 32) 1.2e11, ~3.5 ms. Device memory is touched twice (one read,
// one write of the batch) and is never the limit.
//
// What the design does about it: each matrix lives in the registers of d
// lanes of a warp, lane r holding row r of A and row r of V (2 d floats),
// d a template parameter. A warp packs G = floor(32 / d) matrices: lane l
// takes matrix g = l / d and row r = l mod d, and every shuffle reads
// inside the lane's own segment (lane g d + src), so the G matrices run
// side by side in the same instructions. Where d does not divide 32, the
// lanes past G d take a copy of the last row, are never read and write
// nothing. A warp's G matrices are contiguous in memory; they go through a
// (G d, d + 1) tile of shared memory, so that both device-memory copies are
// coalesced and the row reads hit 32 banks. A tail warp fills its empty
// segments with the identity, a fixed point, so every lane runs the same
// loop. The warp needs no barrier but __syncwarp. Per round:
//   * each lane finds its row's mate and picks a_rr and a_r,mate out of its
//     registers (a tree of selects, so every register index is a constant);
//     two shuffles bring the mate's diagonal and row p's a_pq; both lanes of
//     a pair compute the same (c, s) with the same rounded operations;
//   * column rotations: every lane takes pair k's (c, s) from a lane of the
//     pair and rotates its two registers of columns p_k, q_k, in A and V;
//   * row rotation: each lane takes its mate's row by d shuffles and sets
//     a_rj = c a_rj + s' a_mate,j with s' = -s on row p and s on row q:
//     exactly c a_pj - s a_qj and s a_pj + c a_qj.
// Two ways to find the pairs' registers: for d <= 8 with several matrices
// a warp, the d - 1 rounds of a sweep are unrolled, so pair k of round t
// sits in the constant registers of columns (p_k, q_k); for larger d
// (and K5's entry at any d) an unrolled sweep costs more registers than
// it saves, and the registers instead hold the row's entries in the
// ring's slot order: in round t of a sweep, register i holds column
// ring_at(i, t), so every pair of the round sits in the same two registers,
// (k, d - 1 - k), and the rounds run as a loop of one short body followed
// by a shift of the registers one slot along the ring; after the d - 1
// rounds of a sweep they are back in column order. The epilogue takes each
// lane's eigenvalue by a shuffle per column and rebuilds row r of
// V diag(ev) V^T with V's other rows by shuffles; an entry below the
// diagonal is computed in the order of its mirror above it, so the output
// is exactly symmetric.
//
// Numerics: every multiply, add and divide is an explicitly rounded
// intrinsic (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn), so no product is
// contracted into an FMA and each step rounds exactly as the plain PyTorch
// version's separate elementwise ops do: the kernel equals it to the bit.
// No fast math and no flush to zero: the pivot guard and the "theta^2
// overflows to inf, so t = 0" rule rely on IEEE denormals and infinities.
// Embedded Hermitian matrices have every eigenvalue twice; exact
// degeneracy is the normal case and needs nothing special (a zero pivot is
// skipped).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr unsigned kAll = 0xffffffffu;
// largest d whose sweep is unrolled: at d = 16 the unrolled sweep took
// 128 registers and ran slower than the ring's rolled rounds (PERF.md)
constexpr int kMaxUnrolledD = 8;

// i-th slot of the circle-method ring in round `round`: slot 0 stays 0, the
// others rotate right by one each round (qinfer_tpu/ops/jacobi.py:49)
__device__ __forceinline__ int ring_at(int i, int round, int d) {
  if (i == 0) return 0;
  int r = (i - 1 - round) % (d - 1);
  if (r < 0) r += d - 1;
  return 1 + r;
}

// the row paired with `row` in round `round` (round < d - 1): row 0 sits in
// slot 0, row i > 0 in slot 1 + (i - 1 + round) mod (d - 1); the mate is the
// row in the opposite slot (qinfer_tpu_torch/ops/jacobi.py::round_robin_mate)
template <int D>
__device__ __forceinline__ int ring_mate(int row, int round) {
  int slot = 0;
  if (row != 0) {
    slot = row - 1 + round;
    if (slot >= D - 1) slot -= D - 1;
    slot += 1;
  }
  const int opposite = D - 1 - slot;
  if (opposite == 0) return 0;
  int r = opposite - 1 - round;
  if (r < 0) r += D - 1;
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

// (x_p, x_q) <- (c x_p - s x_q, s x_p + c x_q), each operation rounded on its own
__device__ __forceinline__ void rotate(float* xp, float* xq, float c, float s) {
  const float p = *xp, q = *xq;
  *xp = __fsub_rn(__fmul_rn(c, p), __fmul_rn(s, q));
  *xq = __fadd_rn(__fmul_rn(s, p), __fmul_rn(c, q));
}

// (u, w) <- (c u + s w, c w - s u), each operation rounded on its own
__device__ __forceinline__ void slot_rotate(float* u, float* w, float c, float s) {
  const float x = *u, y = *w;
  *u = __fadd_rn(__fmul_rn(c, x), __fmul_rn(s, y));
  *w = __fadd_rn(__fmul_rn(c, y), __fmul_rn(-s, x));
}

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

// a_rj <- c a_rj + s' a_mate,j for every j, the mate's row by shuffles
template <int D>
__device__ __forceinline__ void rotate_row(float (&A)[D], int mate_lane, float c, float s_row) {
#pragma unroll
  for (int j = 0; j < D; ++j) {
    const float mate_aj = __shfl_sync(kAll, A[j], mate_lane);
    A[j] = __fadd_rn(__fmul_rn(c, A[j]), __fmul_rn(s_row, mate_aj));
  }
}

// Round T of a sweep, registers in column order (unrolled): pair k is
// (p_k, q_k), constant registers. `base` is the lane of the segment's row
// 0.
template <int D, int T>
__device__ __forceinline__ void round_unrolled(float (&A)[D], float (&V)[D], int r, int base) {
  const int mate = ring_mate<D>(r, T);
  const bool is_p = r < mate;
  const float diag = pick(A, r), off = pick(A, mate);
  const float mate_diag = __shfl_sync(kAll, diag, base + mate);
  const float apq = __shfl_sync(kAll, off, base + (is_p ? r : mate));  // row p's a_pq
  float c, s;
  rotation(is_p ? diag : mate_diag, is_p ? mate_diag : diag, apq, &c, &s);
#pragma unroll
  for (int k = 0; k < D / 2; ++k) {
    const int x = ring_at(k, T, D), y = ring_at(D - 1 - k, T, D);
    const int p = x < y ? x : y, q = x < y ? y : x;
    const float ck = __shfl_sync(kAll, c, base + p), sk = __shfl_sync(kAll, s, base + p);
    rotate(&A[p], &A[q], ck, sk);
    rotate(&V[p], &V[q], ck, sk);
  }
  rotate_row(A, base + mate, c, is_p ? -s : s);
}

template <int D, int T>
__device__ __forceinline__ void sweep_unrolled(float (&A)[D], float (&V)[D], int r, int base) {
  if constexpr (T < D - 1) {
    round_unrolled<D, T>(A, V, r, base);
    sweep_unrolled<D, T + 1>(A, V, r, base);
  }
}

// Round t of a sweep, the registers in the round's slot order (a rolled
// loop); `slot` is the slot of this lane's row r.
template <int D>
__device__ __forceinline__ void round_ring(float (&A)[D], float (&V)[D], int r, int base, int t,
                                           int slot) {
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
  rotation(__shfl_sync(kAll, diag, base + p), __shfl_sync(kAll, diag, base + q),
           __shfl_sync(kAll, off, base + p), &c, &s);
  const float s_row = r == p ? -s : s;
  // pair k's c and s' (s' = -s if slot k holds column p): lane k gathers
  // them from the row in slot k, then every lane reads them from lane k;
  // u, w = registers k, d - 1 - k become c u + s' w and c w - s' u: exactly
  // c x_p - s x_q and s x_p + c x_q, whichever register holds column p
  const int holder = base + ring_at(r, t, D);
  const float c_k = __shfl_sync(kAll, c, holder), s_k = __shfl_sync(kAll, s_row, holder);
#pragma unroll
  for (int k = 0; k < D / 2; ++k) {
    const float ck = __shfl_sync(kAll, c_k, base + k), sk = __shfl_sync(kAll, s_k, base + k);
    slot_rotate(&A[k], &A[D - 1 - k], ck, sk);
    slot_rotate(&V[k], &V[D - 1 - k], ck, sk);
  }
  rotate_row(A, base + mate, c, s_row);
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

// a: (n, d, d) row-major, G matrices a warp. PROJECT: out (n, d, d)
// projections. Otherwise: out (n, d, d) eigenvectors V (columns), ev_out
// (n, d) eigenvalues.
template <int D, int G, bool PROJECT>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
jacobi_warp_kernel(const float* __restrict__ a, float* __restrict__ out,
                   float* __restrict__ ev_out, int64_t n, int sweeps, float trace, float eps) {
  static_assert(G >= 1 && G * D <= 32, "G matrices of d rows fill at most a warp");
  constexpr int LD = D + 1, DD = D * D;
  __shared__ float stage[kWarpsPerBlock][G * D * LD];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t m0 = ((int64_t)blockIdx.x * kWarpsPerBlock + warp) * G;
  if (m0 >= n) return;  // whole warps only: no block barrier follows
  const int count = n - m0 < G ? (int)(n - m0) : G;
  float* S = stage[warp];

  const float* src = a + m0 * DD;
  for (int e = lane; e < count * DD; e += 32) S[(e / D) * LD + e % D] = src[e];
  __syncwarp();
  // lane l holds row r of matrix g; lanes past G d hold a copy of the
  // last row and are never read
  const bool real = lane < G * D;
  const int g = real ? lane / D : G - 1, r = real ? lane % D : D - 1;
  const int base = g * D;
  float A[D], V[D];
#pragma unroll
  for (int j = 0; j < D; ++j) {
    const float eye = j == r ? 1.0f : 0.0f;
    A[j] = g < count ? S[(base + r) * LD + j] : eye;
    V[j] = eye;
  }

  if constexpr (G > 1 && D <= kMaxUnrolledD) {
#pragma unroll 1
    for (int sweep = 0; sweep < sweeps; ++sweep) sweep_unrolled<D, 0>(A, V, r, base);
  } else {
    for (int sweep = 0; sweep < sweeps; ++sweep) {
      int slot = r;  // round 0's ring is the column order
#pragma unroll 1
      for (int t = 0; t < D - 1; ++t) {
        round_ring<D>(A, V, r, base, t, slot);
        shift_ring<D>(A);
        shift_ring<D>(V);
        slot = slot == 0 ? 0 : (slot == D - 1 ? 1 : slot + 1);
      }
    }
  }

  const float own = pick(A, r);  // the eigenvalue of row r
  const bool writes = real && g < count;
  if constexpr (PROJECT) {
    // clip, rescale to `trace` (the clipped trace summed in index order)
    float ev[D];
#pragma unroll
    for (int j = 0; j < D; ++j) ev[j] = fmaxf(__shfl_sync(kAll, own, base + j), 0.0f);
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
        const float vjb = __shfl_sync(kAll, V[b], base + j);
        const float term = __fmul_rn(__fmul_rn(upper ? V[b] : vjb, ev[b]), upper ? vjb : V[b]);
        acc = b == 0 ? term : __fadd_rn(acc, term);
      }
      if (writes) S[(base + r) * LD + j] = acc;
    }
  } else {
    if (writes) {
      ev_out[m0 * D + lane] = own;
#pragma unroll
      for (int j = 0; j < D; ++j) S[(base + r) * LD + j] = V[j];
    }
  }
  __syncwarp();
  float* dst = out + m0 * DD;
  for (int e = lane; e < count * DD; e += 32) dst[e] = S[(e / D) * LD + e % D];
}

template <int D, int G, bool PROJECT>
int launch(const float* a, float* out, float* ev_out, long long n, int sweeps, float trace,
           float eps, void* stream) {
  const long long warps = (n + G - 1) / G;
  const long long blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  jacobi_warp_kernel<D, G, PROJECT><<<(unsigned)blocks, kWarpsPerBlock * 32, 0,
                                      (cudaStream_t)stream>>>(a, out, ev_out, (int64_t)n,
                                                              sweeps, trace, eps);
  return (int)cudaGetLastError();
}

// PACK: floor(32 / d) matrices a warp; otherwise one
template <bool PACK, bool PROJECT>
int dispatch(const float* a, float* out, float* ev_out, long long n, int d, int sweeps,
             float trace, float eps, void* stream) {
  if (n <= 0 || sweeps < 0) return (int)cudaErrorInvalidValue;
  switch (d) {
#define QK_CASE(D) \
  case D:          \
    return launch<D, PACK ? 32 / D : 1, PROJECT>(a, out, ev_out, n, sweeps, trace, eps, stream);
    QK_CASE(2) QK_CASE(4) QK_CASE(6) QK_CASE(8) QK_CASE(10) QK_CASE(12) QK_CASE(14) QK_CASE(16)
    QK_CASE(18) QK_CASE(20) QK_CASE(22) QK_CASE(24) QK_CASE(26) QK_CASE(28) QK_CASE(30)
    QK_CASE(32)
#undef QK_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// K4: out (n, d, d) = PSD projection of each a (n, d, d), d even, 2 .. 32,
// rescaled to trace `trace` (eps floors the clipped trace before the
// division).
int qk_jacobi_project(const float* a, float* out, long long n, int d, int sweeps, float trace,
                      float eps, void* stream) {
  return dispatch<true, true>(a, out, nullptr, n, d, sweeps, trace, eps, stream);
}

// K5: qk_jacobi_project's contract with one matrix a warp at every d (the
// same kernel as K4's at d > 16).
int qk_jacobi_project_warp(const float* a, float* out, long long n, int d, int sweeps,
                           float trace, float eps, void* stream) {
  return dispatch<false, true>(a, out, nullptr, n, d, sweeps, trace, eps, stream);
}

// K6: ev (n, d) unsorted eigenvalues and v (n, d, d) eigenvectors (columns)
// of each a (n, d, d), d even, 2 .. 32, a ~= v diag(ev) v^T.
int qk_jacobi_eigh(const float* a, float* ev, float* v, long long n, int d, int sweeps,
                   void* stream) {
  return dispatch<true, false>(a, v, ev, n, d, sweeps, 0.0f, 0.0f, stream);
}

}  // extern "C"
