// Precession-model kernels of the SMC main path (K1 and K2).
//
// Replaces qinfer_tpu/ops/precession.py::fused_precession_update (Pallas
// kernel _update_kernel) and qinfer_tpu/ops/precession.py::precession_pr0
// (Pallas kernel _pr0_kernel).
//
// What bounds them on an H100: device-memory bytes. K1 reads omega and w
// (8 bytes a particle) and writes h (4 bytes), with one cosf per particle;
// at 2^22 particles that is 50 MB a step against 3.35 TB/s. K2 reads omega
// and writes one float per (particle, experiment).
//
// What the design does about it:
// * K1 is one grid-stride pass that writes h and keeps the three step
//   reductions (sum h, sum h^2, sum h*omega) in registers, so the engine
//   needs no further sweep for the normalization, the ESS or the mean. The
//   TPU kernel carried one accumulator across its sequential grid; GPU
//   blocks run in parallel in no order, so each block writes its own
//   partials and a second one-block pass sums them in a fixed order. No
//   float atomics: the result is the same from run to run.
// * The grid is capped (K1_MAX_BLOCKS) so the partials stay tiny; the tail
//   is masked by the loop bound, so any n works.
// * omega is read with its stride, so a column of an (n, d) location
//   matrix needs no copy.
// * cosf is the accurate libdevice cosine with full range reduction. This
//   file must not be built with --use_fast_math and must not use __cosf:
//   PGH sets t = 1/separation, so omega*t/2 grows large as the posterior
//   narrows, and __cosf loses all accuracy there. The products are written
//   with __fmul_rn so that no multiply is contracted into an FMA and h
//   rounds exactly as the plain PyTorch version does; the argument keeps
//   the JAX order omega * (t * 0.5).

#include <cuda_runtime.h>
#include <stdint.h>

#define K1_THREADS 256
#define K1_MAX_BLOCKS 1024
#define K2_THREADS 256

namespace {

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Sum three values over a block of THREADS threads in a fixed order;
// thread 0 returns the totals.
template <int THREADS>
__device__ __forceinline__ void block_sum3(float& a, float& b, float& c) {
  __shared__ float sh[3][THREADS / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  a = warp_sum(a);
  b = warp_sum(b);
  c = warp_sum(c);
  if (lane == 0) {
    sh[0][warp] = a;
    sh[1][warp] = b;
    sh[2][warp] = c;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    a = 0.f;
    b = 0.f;
    c = 0.f;
    for (int w = 0; w < THREADS / 32; ++w) {
      a += sh[0][w];
      b += sh[1][w];
      c += sh[2][w];
    }
  }
}

__global__ void __launch_bounds__(K1_THREADS)
precession_update_partials(const float* __restrict__ omega, int64_t omega_stride,
                           const float* __restrict__ w, const float* __restrict__ t,
                           const int* __restrict__ outcome, float* __restrict__ h,
                           float* __restrict__ partials, int64_t n) {
  const float half_t = __fmul_rn(__ldg(t), 0.5f);
  const bool outcome_is_zero = __ldg(outcome) == 0;
  float s_h = 0.f, s_h2 = 0.f, s_hw = 0.f;
  const int64_t stride = (int64_t)gridDim.x * K1_THREADS;
  for (int64_t i = (int64_t)blockIdx.x * K1_THREADS + threadIdx.x; i < n; i += stride) {
    const float om = __ldg(omega + i * omega_stride);
    const float c = cosf(__fmul_rn(om, half_t));
    const float pr0 = __fmul_rn(c, c);
    const float ell = outcome_is_zero ? pr0 : 1.0f - pr0;
    const float hv = __fmul_rn(__ldg(w + i), ell);
    h[i] = hv;
    s_h += hv;
    s_h2 += hv * hv;
    s_hw += hv * om;
  }
  block_sum3<K1_THREADS>(s_h, s_h2, s_hw);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = s_h;
    partials[gridDim.x + blockIdx.x] = s_h2;
    partials[2 * gridDim.x + blockIdx.x] = s_hw;
  }
}

__global__ void __launch_bounds__(K1_MAX_BLOCKS)
precession_update_finish(const float* __restrict__ partials, int n_blocks,
                         float* __restrict__ sums) {
  float a = 0.f, b = 0.f, c = 0.f;
  if ((int)threadIdx.x < n_blocks) {
    a = partials[threadIdx.x];
    b = partials[n_blocks + threadIdx.x];
    c = partials[2 * n_blocks + threadIdx.x];
  }
  block_sum3<K1_MAX_BLOCKS>(a, b, c);
  if (threadIdx.x == 0) {
    sums[0] = a;
    sums[1] = b;
    sums[2] = c;
  }
}

__global__ void __launch_bounds__(K2_THREADS)
precession_pr0_kernel(const float* __restrict__ omega, int64_t omega_stride,
                      const float* __restrict__ t, float* __restrict__ out,
                      int64_t n, int64_t n_e) {
  const int64_t total = n * n_e;
  const int64_t stride = (int64_t)gridDim.x * K2_THREADS;
  for (int64_t k = (int64_t)blockIdx.x * K2_THREADS + threadIdx.x; k < total; k += stride) {
    const int64_t i = k / n_e;
    const int64_t j = k - i * n_e;
    const float c = cosf(__fmul_rn(__ldg(omega + i * omega_stride),
                                   __fmul_rn(__ldg(t + j), 0.5f)));
    out[k] = __fmul_rn(c, c);
  }
}

int grid_for(int64_t work, int threads, int cap) {
  int64_t blocks = (work + threads - 1) / threads;
  if (blocks > cap) blocks = cap;
  return blocks < 1 ? 1 : (int)blocks;
}

}  // namespace

extern "C" {

// K1. omega: n floats at stride omega_stride; w, h: n floats; t: 1 float
// and outcome: 1 int, both on the device; partials: 3 * n_blocks floats of
// scratch; sums: 3 floats out (sum h, sum h^2, sum h*omega).
int qk_fused_precession_update(const float* omega, long long omega_stride, const float* w,
                               const float* t, const int* outcome, float* h, float* partials,
                               float* sums, long long n, int n_blocks, void* stream) {
  if (n <= 0 || n_blocks < 1 || n_blocks > K1_MAX_BLOCKS) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  precession_update_partials<<<n_blocks, K1_THREADS, 0, s>>>(omega, omega_stride, w, t, outcome,
                                                             h, partials, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  precession_update_finish<<<1, K1_MAX_BLOCKS, 0, s>>>(partials, n_blocks, sums);
  return (int)cudaGetLastError();
}

int qk_fused_precession_max_blocks() { return K1_MAX_BLOCKS; }

int qk_fused_precession_threads() { return K1_THREADS; }

// K2. omega: n floats at stride omega_stride; t: n_e floats on the device;
// out: (n, n_e) row-major.
int qk_precession_pr0(const float* omega, long long omega_stride, const float* t, float* out,
                      long long n, long long n_e, void* stream) {
  if (n <= 0 || n_e <= 0) return (int)cudaErrorInvalidValue;
  const int blocks = grid_for(n * n_e, K2_THREADS, 132 * 16);
  precession_pr0_kernel<<<blocks, K2_THREADS, 0, (cudaStream_t)stream>>>(omega, omega_stride, t,
                                                                         out, n, n_e);
  return (int)cudaGetLastError();
}

const char* qk_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
