// RMSNorm over the rows of an (N, d) tensor for Hopper (sm_90a):
//   y = x * rsqrt(mean(x^2) + eps) * scale, in fp32, cast back to x's type.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rmsnorm.py::_rmsnorm_kernel.
// The model runs it twice in every transformer block and once before the
// unembedding (models/layers.py::apply_norm).
//
// What bounds it: each element is read once and written once, with four
// fp32 operations, so it is memory-bound: at the prefill shape (2048, 3072)
// bf16 it moves 25.2 MB, 7.5 us at 3.35 TB/s. At the decode shape (4, 3072)
// it moves 49 KB and the launch sets the time.
//
// Design: one block per row, which is 12 KB of fp32 or 6 KB of bf16 at
// d = 3072, small enough to stay in L1 between the two passes. The first
// pass sums x^2 in fp32 (each thread over a strided set of packs, then warp
// shuffles, then one warp over the per-warp partials in shared memory); the
// second pass reads the row again, scales it and writes it in x's type. A
// pack is 16 bytes (4 fp32 or 8 bf16) when d is a multiple of the pack and
// the pointers are 16-byte aligned, else one element, so any d is taken.
// Any N is taken: the grid has one block per row. The Pallas kernel's
// N % block_n == 0 assert has no counterpart. Blocks of up to 256 threads
// are sized so that each thread handles the same number of packs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int mask = 16; mask > 0; mask >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, mask);
  return s;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
    rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                   T* __restrict__ y, int d, float eps) {
  using P = Pack<T, VEC>;
  const int n_pack = d / VEC;
  const size_t row = static_cast<size_t>(blockIdx.x) * d;
  const P* xr = reinterpret_cast<const P*>(x + row);
  const P* sr = reinterpret_cast<const P*>(scale);
  P* yr = reinterpret_cast<P*>(y + row);

  float ss = 0.f;
  for (int i = threadIdx.x; i < n_pack; i += blockDim.x) {
    const P p = xr[i];
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float f = to_f32(p.v[k]);
      ss += f * f;
    }
  }
  __shared__ float partial[kMaxThreads / 32];
  __shared__ float rstd;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  ss = warp_sum(ss);
  if (lane == 0) partial[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    ss = lane < static_cast<int>(blockDim.x >> 5) ? partial[lane] : 0.f;
    ss = warp_sum(ss);
    if (lane == 0) rstd = rsqrtf(ss / static_cast<float>(d) + eps);
  }
  __syncthreads();
  const float r = rstd;
  for (int i = threadIdx.x; i < n_pack; i += blockDim.x) {
    const P p = xr[i];
    const P s = sr[i];
    P o;
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      o.v[k] = from_f32<T>(to_f32(p.v[k]) * r * to_f32(s.v[k]));
    yr[i] = o;
  }
}

// Threads for a row of n_pack packs: a multiple of 32, at most kMaxThreads,
// with every thread given the same number of packs where that is possible.
inline int threads_for(int n_pack) {
  const int per_thread = (n_pack + kMaxThreads - 1) / kMaxThreads;
  const int t = (n_pack + per_thread - 1) / per_thread;
  return ((t + 31) / 32) * 32;
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename T>
int launch(const void* x, const void* scale, void* y, int N, int d, float eps,
           cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = d % kVec == 0 && aligned16(x) && aligned16(scale) &&
                   aligned16(y);
  const T* xt = static_cast<const T*>(x);
  const T* st = static_cast<const T*>(scale);
  T* yt = static_cast<T*>(y);
  if (vec) {
    rmsnorm_kernel<T, kVec><<<N, threads_for(d / kVec), 0, s>>>(xt, st, yt, d,
                                                                eps);
  } else {
    rmsnorm_kernel<T, 1><<<N, threads_for(d), 0, s>>>(xt, st, yt, d, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, scale and y all of it). Returns
// cudaGetLastError() after the launch (0 on success); the launch runs on
// `stream` and does not sync.
extern "C" int rmsnorm_fwd(const void* x, const void* scale, void* y, int N,
                           int d, float eps, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return launch<float>(x, scale, y, N, d, eps, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, scale, y, N, d, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
