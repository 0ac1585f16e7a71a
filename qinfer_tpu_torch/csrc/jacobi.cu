// Batched parallel-ordered cyclic Jacobi for small symmetric matrices: the
// eigensolver (K6) and the fused PSD-cone projection (K4, K5) of the
// tomography path.
//
// Replaces three Pallas kernels of qinfer_tpu/ops/jacobi.py:
//   K4 qinfer_tpu/ops/jacobi.py::jacobi_project_lanes        (_make_kernel, project=True)
//   K5 qinfer_tpu/ops/jacobi.py::jacobi_project_lanes_looped (_make_kernel_looped)
//   K6 qinfer_tpu/ops/jacobi.py::jacobi_eigh_lanes           (_make_kernel, project=False)
// K4 and K5 differ on the TPU only in code shape (K5 loops over a schedule
// held in SMEM so that d = 32 compiles and fits VMEM); here one kernel
// serves both, and K6 is its PROJECT = false instantiation.
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
// What bounds it on an H100: shared-memory traffic. Each rotation reads and
// writes two columns and two rows of A and two columns of V: at d = 32 and
// 6 sweeps that is ~70k shared-memory accesses a thread, ~6e10 for 50 000
// matrices, against ~7e12 a second for the card. Device memory is touched
// twice (one read, one write of the batch).
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

}  // namespace

extern "C" {

// K4 / K5: out (n, d, d) = PSD projection of each a (n, d, d), rescaled to
// trace `trace` (eps floors the clipped trace before the division).
int qk_jacobi_project(const float* a, float* out, long long n, int d, int sweeps, float trace,
                      float eps, void* stream) {
  return launch<true>(a, out, nullptr, n, d, sweeps, trace, eps, stream);
}

// K6: ev (n, d) unsorted eigenvalues and v (n, d, d) eigenvectors (columns)
// of each a (n, d, d), a ~= v diag(ev) v^T.
int qk_jacobi_eigh(const float* a, float* ev, float* v, long long n, int d, int sweeps,
                   void* stream) {
  return launch<false>(a, v, ev, n, d, sweeps, 0.0f, 0.0f, stream);
}

}  // extern "C"
