// RMSNorm over the rows of an (N, d) tensor for Hopper (sm_90a), alone and
// fused with the residual add before it:
//   rmsnorm:      y = x * rsqrt(mean(x^2) + eps) * scale
//   add_rmsnorm:  s = x + delta (rounded to x's type, as a torch add rounds
//                 it), y = rmsnorm(s) computed from that rounded s
// in fp32, with y cast back to x's type.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rmsnorm.py::_rmsnorm_kernel.
// The model runs one norm after every residual add: add_rmsnorm for the
// norm after the attention add, the next block's norm after the MLP add and
// the final norm; plain rmsnorm only for the first block's first norm
// (models/transformer.py).
//
// What bounds it: rmsnorm reads x and writes y once, add_rmsnorm reads x and
// delta and writes s and y once, with a few fp32 operations per element, so
// both are memory-bound: at the prefill shape (2048, 3072) bf16
// add_rmsnorm moves 50.3 MB, 15 us at 3.35 TB/s. At the decode shape
// (4, 3072) it moves 98 KB, and the launch sets the time; there the decode
// step runs under a CUDA graph (serve/engine.py), so the launch is the
// graph's, and fusing the add removes one launch and one round trip of the
// residual row per norm.
//
// Design: one block per row, one pass. Each thread loads its share of the
// row and of scale into registers (PPT packs, pack i = thread + k *
// blockDim.x), adds delta there and writes s, sums the squares in fp32
// (its packs in order, then warp shuffles, then one warp over the per-warp
// partials in shared memory), and scales the packs it holds. Each element of x and delta is
// read from device memory once. At d = 3072 in bf16 a row is 384 16-byte
// packs: 128 threads of 3 packs. Both kernels are one template, so for one
// (N, d) the plain kernel sums in the same order as the fused one: the
// fused kernel's y equals rmsnorm(x + delta) bit for bit. A pack is 16
// bytes (4 fp32 or 8 bf16) when d is a multiple of it and every pointer is
// 16-byte aligned, else one element, so any d up to kMaxPPT * 1024 packs is
// taken. Any N is taken: the grid has one block per row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kBaseThreads = 128;  // threads per row while PPT <= kMaxPPT
constexpr int kMaxPPT = 8;         // packs per thread held in registers

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

// ADD: s = x + delta is written to s_out and normed; else x is normed.
template <typename T, int VEC, int PPT, bool ADD>
__global__ void __launch_bounds__(kMaxThreads)
    norm_kernel(const T* __restrict__ x, const T* __restrict__ delta,
                const T* __restrict__ scale, T* __restrict__ s_out,
                T* __restrict__ y, int d, float eps) {
  using P = Pack<T, VEC>;
  const int n_pack = d / VEC;
  const size_t row = static_cast<size_t>(blockIdx.x) * d;
  const P* xr = reinterpret_cast<const P*>(x + row);
  const P* sr = reinterpret_cast<const P*>(scale);
  P* yr = reinterpret_cast<P*>(y + row);

  P v[PPT], sc[PPT];
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    if (i < n_pack) {
      sc[k] = sr[i];  // loaded now, so its latency hides under the sum's
      v[k] = xr[i];
      if constexpr (ADD) {
        const P b = reinterpret_cast<const P*>(delta + row)[i];
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          v[k].v[e] = from_f32<T>(to_f32(v[k].v[e]) + to_f32(b.v[e]));
        reinterpret_cast<P*>(s_out + row)[i] = v[k];
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float f = to_f32(v[k].v[e]);
        ss += f * f;
      }
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
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    if (i < n_pack) {
      P o;
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        o.v[e] = from_f32<T>(to_f32(v[k].v[e]) * r * to_f32(sc[k].v[e]));
      yr[i] = o;
    }
  }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// Launch one row per block: kBaseThreads threads while the row fits in
// kMaxPPT packs each, more (a multiple of 32, at most kMaxThreads) beyond.
template <typename T, int VEC, bool ADD>
int launch_packs(const void* x, const void* delta, const void* scale,
                 void* s_out, void* y, int N, int d, float eps,
                 cudaStream_t s) {
  const int n_pack = d / VEC;
  int ppt = (n_pack + kBaseThreads - 1) / kBaseThreads;
  if (ppt > kMaxPPT) ppt = kMaxPPT;
  const int threads = ((n_pack + ppt - 1) / ppt + 31) / 32 * 32;
  if (threads > kMaxThreads) return static_cast<int>(cudaErrorInvalidValue);
  const T* xt = static_cast<const T*>(x);
  const T* dt = static_cast<const T*>(delta);
  const T* st = static_cast<const T*>(scale);
  T* ot = static_cast<T*>(s_out);
  T* yt = static_cast<T*>(y);
  switch (ppt) {
#define REPRO_NORM_CASE(K)                                                  \
  case K:                                                                   \
    norm_kernel<T, VEC, K, ADD><<<N, threads, 0, s>>>(xt, dt, st, ot, yt, d, \
                                                      eps);                 \
    break;
    REPRO_NORM_CASE(1)
    REPRO_NORM_CASE(2)
    REPRO_NORM_CASE(3)
    REPRO_NORM_CASE(4)
    REPRO_NORM_CASE(5)
    REPRO_NORM_CASE(6)
    REPRO_NORM_CASE(7)
    REPRO_NORM_CASE(8)
#undef REPRO_NORM_CASE
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool ADD>
int launch(const void* x, const void* delta, const void* scale, void* s_out,
           void* y, int N, int d, float eps, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  bool vec = d % kVec == 0 && aligned16(x) && aligned16(scale) &&
             aligned16(y);
  if (ADD) vec = vec && aligned16(delta) && aligned16(s_out);
  return vec ? launch_packs<T, kVec, ADD>(x, delta, scale, s_out, y, N, d,
                                          eps, s)
             : launch_packs<T, 1, ADD>(x, delta, scale, s_out, y, N, d, eps,
                                       s);
}

template <bool ADD>
int dispatch(const void* x, const void* delta, const void* scale,
             void* s_out, void* y, int N, int d, float eps, int dtype,
             void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch<float, ADD>(x, delta, scale, s_out, y, N, d, eps, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, ADD>(x, delta, scale, s_out, y, N, d, eps,
                                      s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (every tensor of the call). Each returns
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a row longer than the kernel holds; the launch
// runs on `stream` and does not sync.
extern "C" int rmsnorm_fwd(const void* x, const void* scale, void* y, int N,
                           int d, float eps, int dtype, void* stream) {
  return dispatch<false>(x, nullptr, scale, nullptr, y, N, d, eps, dtype,
                         stream);
}

// s_out = x + delta and y = rmsnorm(s_out) * scale; every tensor (N, d)
// but scale (d,).
extern "C" int add_rmsnorm_fwd(const void* x, const void* delta,
                               const void* scale, void* s_out, void* y, int N,
                               int d, float eps, int dtype, void* stream) {
  return dispatch<true>(x, delta, scale, s_out, y, N, d, eps, dtype, stream);
}
