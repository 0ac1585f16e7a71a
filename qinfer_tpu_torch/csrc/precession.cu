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
// * K1 is one launch that writes h, the three step reductions (sum h,
//   sum h^2, sum h*omega) and the engine's epilogue, so a step runs no
//   other device work for the normalization, the ESS or the mean. The main
//   pass is grid-stride; where omega's stride is 1 and omega, w and h are
//   16-byte aligned it moves them as float4 (16-byte loads and stores, two
//   loads in flight per thread per iteration); otherwise (a strided column
//   of an (n, d) location matrix, which needs no copy) it reads element by
//   element. The grid is capped (K1_MAX_BLOCKS, about one wave) so the
//   partials stay tiny; the tail is masked by the loop bound, so any n works.
// * The reduction: the TPU kernel carried one accumulator across its
//   sequential grid; GPU blocks run in parallel in no order, so each block
//   writes its three partials, and the last block to finish (a
//   __threadfence and an atomic ticket in the scratch buffer, which it
//   resets for the next call) sums them in a fixed block order and writes
//   norm = sum h, ess = safe^2 / max(sum h^2, 1e-35) and mean =
//   sum h*omega / safe with safe = max(sum h, 1e-35), the wrapper's
//   epilogue. No float atomics: the result is the same from run to run.
// * t and the outcome come as device pointers in the engine's dtypes
//   (float32 t; int32 or int64 outcome), or by value, so no cast or fill
//   kernel runs beside K1.
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

// scratch of K1: 3 * K1_MAX_BLOCKS float partials, then the ticket
constexpr int kK1ScratchWords = 3 * K1_MAX_BLOCKS + 1;
constexpr float kSafe = 1e-35f;

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Sum three values over a block of K1_THREADS threads in a fixed order;
// thread 0 returns the totals. Ends with every thread past the barrier
// that follows its shared-memory reads.
__device__ __forceinline__ void block_sum3(float& a, float& b, float& c) {
  __shared__ float sh[3][K1_THREADS / 32];
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
    for (int w = 0; w < K1_THREADS / 32; ++w) {
      a += sh[0][w];
      b += sh[1][w];
      c += sh[2][w];
    }
  }
  __syncthreads();
}

struct K1Step {
  float half_t;
  bool outcome_is_zero;
  float s_h = 0.f, s_h2 = 0.f, s_hw = 0.f;

  // h of one particle, added to the three sums
  __device__ __forceinline__ float operator()(float om, float w) {
    const float c = cosf(__fmul_rn(om, half_t));
    const float pr0 = __fmul_rn(c, c);
    const float ell = outcome_is_zero ? pr0 : 1.0f - pr0;
    const float hv = __fmul_rn(w, ell);
    s_h += hv;
    s_h2 += hv * hv;
    s_hw += hv * om;
    return hv;
  }
};

// VEC: omega contiguous and omega, w, h 16-byte aligned
template <bool VEC>
__global__ void __launch_bounds__(K1_THREADS)
precession_update_kernel(const float* __restrict__ omega, int64_t omega_stride,
                         const float* __restrict__ w, const float* __restrict__ t_ptr,
                         float t_val, const void* __restrict__ outcome_ptr, int outcome_is_64,
                         long long outcome_val, float* __restrict__ h,
                         float* __restrict__ scratch, float* __restrict__ out, int64_t n) {
  const float t = t_ptr ? __ldg(t_ptr) : t_val;
  const long long outcome =
      outcome_ptr == nullptr ? outcome_val
      : outcome_is_64        ? __ldg(static_cast<const long long*>(outcome_ptr))
                             : (long long)__ldg(static_cast<const int*>(outcome_ptr));
  K1Step step{__fmul_rn(t, 0.5f), outcome == 0};
  const int64_t first = (int64_t)blockIdx.x * K1_THREADS + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * K1_THREADS;
  int64_t tail = 0;  // first element of the scalar loop
  if (VEC) {
    const float4* om4 = reinterpret_cast<const float4*>(omega);
    const float4* w4 = reinterpret_cast<const float4*>(w);
    float4* h4 = reinterpret_cast<float4*>(h);
    const int64_t n4 = n / 4;
    for (int64_t i = first; i < n4; i += stride) {
      const float4 o = __ldg(om4 + i), ww = __ldg(w4 + i);
      float4 hv;
      hv.x = step(o.x, ww.x);
      hv.y = step(o.y, ww.y);
      hv.z = step(o.z, ww.z);
      hv.w = step(o.w, ww.w);
      h4[i] = hv;
    }
    tail = 4 * n4;
  }
  for (int64_t i = tail + first; i < n; i += stride)
    h[i] = step(__ldg(omega + i * omega_stride), __ldg(w + i));

  float* partials = scratch;
  unsigned* ticket = reinterpret_cast<unsigned*>(scratch + 3 * K1_MAX_BLOCKS);
  float a = step.s_h, b = step.s_h2, c = step.s_hw;
  block_sum3(a, b, c);
  __shared__ bool last;
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = a;
    partials[K1_MAX_BLOCKS + blockIdx.x] = b;
    partials[2 * K1_MAX_BLOCKS + blockIdx.x] = c;
    __threadfence();  // the partials are visible before the ticket is taken
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;

  // the last block: every block's partials, summed in block order
  a = b = c = 0.f;
  for (int k = threadIdx.x; k < (int)gridDim.x; k += K1_THREADS) {
    a += __ldcg(partials + k);
    b += __ldcg(partials + K1_MAX_BLOCKS + k);
    c += __ldcg(partials + 2 * K1_MAX_BLOCKS + k);
  }
  block_sum3(a, b, c);
  if (threadIdx.x == 0) {
    const float safe = a < kSafe ? kSafe : a;  // NaN stays NaN, as clamp_min
    out[0] = a;
    out[1] = __fdiv_rn(__fmul_rn(safe, safe), b < kSafe ? kSafe : b);
    out[2] = __fdiv_rn(c, safe);
    out[3] = safe;
    *ticket = 0u;  // ready for the next call
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

// K1. omega: n floats at stride omega_stride; w, h: n floats; t: t_ptr (1
// float on the device) or, if t_ptr is null, t_val; outcome: outcome_ptr (1
// int32, or int64 if outcome_is_64, on the device) or, if it is null,
// outcome_val; scratch: qk_fused_precession_scratch_words() 32-bit words,
// zero before the first call and left zero by each call; out: 4 floats
// (sum h, ess, mean, max(sum h, 1e-35)).
int qk_fused_precession_update(const float* omega, long long omega_stride, const float* w,
                               const float* t_ptr, float t_val, const void* outcome_ptr,
                               int outcome_is_64, long long outcome_val, float* h, void* scratch,
                               float* out, long long n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const bool vec = omega_stride == 1 &&
                   (((uintptr_t)omega | (uintptr_t)w | (uintptr_t)h) & 15) == 0;
  const int blocks = grid_for(vec ? (n + 3) / 4 : n, K1_THREADS, K1_MAX_BLOCKS);
  cudaStream_t s = (cudaStream_t)stream;
  float* sc = static_cast<float*>(scratch);
  if (vec)
    precession_update_kernel<true><<<blocks, K1_THREADS, 0, s>>>(
        omega, omega_stride, w, t_ptr, t_val, outcome_ptr, outcome_is_64, outcome_val, h, sc,
        out, n);
  else
    precession_update_kernel<false><<<blocks, K1_THREADS, 0, s>>>(
        omega, omega_stride, w, t_ptr, t_val, outcome_ptr, outcome_is_64, outcome_val, h, sc,
        out, n);
  return (int)cudaGetLastError();
}

int qk_fused_precession_scratch_words() { return kK1ScratchWords; }

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
