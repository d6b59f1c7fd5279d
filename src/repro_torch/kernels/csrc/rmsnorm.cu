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
//
// Backward (the Pallas kernel has none; the JAX package differentiates its
// jnp norm): per row, with r = rsqrt(mean(x^2) + eps), xhat = x r, w =
// scale and dy the upstream gradient of y,
//   dx = r (dy w - xhat mean(dy w xhat)),   dscale = sum_rows dy xhat,
// in fp32; the add variant takes s (the saved x + delta) for x and adds the
// upstream gradient g_s of s, so d_s = g_s + dx, the gradient of both x and
// delta, is rounded once. norm_bwd_kernel keeps the forward's layout (the
// row, dy and the scale in registers, the same packs per thread) and walks
// rows blockIdx.x, blockIdx.x + gridDim.x, ...; each thread sums dy xhat
// for the columns it owns in registers and writes them to its block's row
// of an fp32 scratch (n_blocks, d) at the end. dscale is then the sum of
// those rows (dscale_kernel: 16 slices of rows per column, each summed in
// order, then the slices in order): a fixed assignment and a fixed order,
// no float atomics, so two launches give the same bits. The caller fixes
// n_blocks from N alone (min(N, 528), four blocks of 128 threads per SM).
// What bounds it: x (or s), dy and g_s read and dx written once, plus the
// scratch: at (2048, 3072) bf16 the add variant moves 50.3 MB (15.0 us at
// 3.35 TB/s) and the scratch 2 x 6.5 MB more, read back from L2 mostly.

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

// The backward of one row per iteration over rows blockIdx.x + k gridDim.x.
// ADD: g_s (the upstream gradient of s) is added to dx. partial gets this
// block's sum over its rows of dy xhat, per column.
template <typename T, int VEC, int PPT, bool ADD>
__global__ void __launch_bounds__(VEC == 1 ? kMaxThreads : 256)
    norm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                    const T* __restrict__ dy, const T* __restrict__ g_s,
                    T* __restrict__ dx, float* __restrict__ partial, int N,
                    int d, float eps) {
  using P = Pack<T, VEC>;
  const int n_pack = d / VEC;
  const P* sr = reinterpret_cast<const P*>(scale);
  P sc[PPT];
  float acc[PPT][VEC];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    if (i < n_pack) sc[k] = sr[i];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[k][e] = 0.f;
  }
  __shared__ float2 red[kMaxThreads / 32];
  __shared__ float2 tot;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int n = blockIdx.x; n < N; n += gridDim.x) {
    const size_t row = static_cast<size_t>(n) * d;
    const P* xr = reinterpret_cast<const P*>(x + row);
    const P* gr = reinterpret_cast<const P*>(dy + row);
    P v[PPT], g[PPT];
    float ss = 0.f, sd = 0.f;   // sum x^2, sum dy w x
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const int i = threadIdx.x + k * blockDim.x;
      if (i < n_pack) {
        v[k] = xr[i];
        g[k] = gr[i];
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float f = to_f32(v[k].v[e]);
          ss += f * f;
          sd += to_f32(g[k].v[e]) * to_f32(sc[k].v[e]) * f;
        }
      }
    }
    ss = warp_sum(ss);
    sd = warp_sum(sd);
    if (lane == 0) red[warp] = make_float2(ss, sd);
    __syncthreads();
    if (warp == 0) {
      float2 t = lane < static_cast<int>(blockDim.x >> 5)
                     ? red[lane] : make_float2(0.f, 0.f);
      t.x = warp_sum(t.x);
      t.y = warp_sum(t.y);
      if (lane == 0) tot = t;
    }
    __syncthreads();
    const float r = rsqrtf(tot.x / static_cast<float>(d) + eps);
    // mean(dy w xhat) = r sum(dy w x) / d
    const float c = r * tot.y / static_cast<float>(d);
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const int i = threadIdx.x + k * blockDim.x;
      if (i < n_pack) {
        P gs;
        if constexpr (ADD) gs = reinterpret_cast<const P*>(g_s + row)[i];
        P o;
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float xh = to_f32(v[k].v[e]) * r;
          const float gy = to_f32(g[k].v[e]);
          float t = r * (gy * to_f32(sc[k].v[e]) - xh * c);
          if constexpr (ADD) t = to_f32(gs.v[e]) + t;
          o.v[e] = from_f32<T>(t);
          acc[k][e] += gy * xh;
        }
        reinterpret_cast<P*>(dx + row)[i] = o;
      }
    }
  }
  float* pr = partial + static_cast<size_t>(blockIdx.x) * d;
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    if (i < n_pack) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) pr[i * VEC + e] = acc[k][e];
    }
  }
}

// dscale[c] = sum over b < n_blocks of partial[b][c]: a block of 32
// columns x kRedSlices slices, slice i summing rows b = i mod kRedSlices in
// order, then the slices' sums added in order of slice
constexpr int kRedCols = 32;
constexpr int kRedSlices = 16;

template <typename T>
__global__ void __launch_bounds__(kRedCols * kRedSlices)
    dscale_kernel(const float* __restrict__ partial, T* __restrict__ dscale,
                  int n_blocks, int d) {
  __shared__ float part[kRedSlices][kRedCols + 1];
  const int c = blockIdx.x * kRedCols + threadIdx.x;
  float s = 0.f;
  if (c < d) {
#pragma unroll 4
    for (int b = threadIdx.y; b < n_blocks; b += kRedSlices)
      s += partial[static_cast<size_t>(b) * d + c];
  }
  part[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && c < d) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < kRedSlices; ++i) t += part[i][threadIdx.x];
    dscale[c] = from_f32<T>(t);
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

template <typename T, int VEC, bool ADD>
int launch_bwd_packs(const void* x, const void* scale, const void* dy,
                     const void* g_s, void* dx, float* partial, void* dscale,
                     int N, int d, float eps, int n_blocks, cudaStream_t s) {
  const int n_pack = d / VEC;
  int ppt = (n_pack + kBaseThreads - 1) / kBaseThreads;
  if (ppt > kMaxPPT) ppt = kMaxPPT;
  const int threads = ((n_pack + ppt - 1) / ppt + 31) / 32 * 32;
  if (threads > (VEC == 1 ? kMaxThreads : 256))
    return static_cast<int>(cudaErrorInvalidValue);
  const T* xt = static_cast<const T*>(x);
  const T* st = static_cast<const T*>(scale);
  const T* gt = static_cast<const T*>(dy);
  const T* gst = static_cast<const T*>(g_s);
  T* dt = static_cast<T*>(dx);
  switch (ppt) {
#define REPRO_NORM_BWD_CASE(K)                                              \
  case K:                                                                   \
    norm_bwd_kernel<T, VEC, K, ADD><<<n_blocks, threads, 0, s>>>(           \
        xt, st, gt, gst, dt, partial, N, d, eps);                           \
    break;
    REPRO_NORM_BWD_CASE(1)
    REPRO_NORM_BWD_CASE(2)
    REPRO_NORM_BWD_CASE(3)
    REPRO_NORM_BWD_CASE(4)
    REPRO_NORM_BWD_CASE(5)
    REPRO_NORM_BWD_CASE(6)
    REPRO_NORM_BWD_CASE(7)
    REPRO_NORM_BWD_CASE(8)
#undef REPRO_NORM_BWD_CASE
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dscale_kernel<T><<<(d + kRedCols - 1) / kRedCols,
                     dim3(kRedCols, kRedSlices), 0, s>>>(
      partial, static_cast<T*>(dscale), n_blocks, d);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool ADD>
int launch_bwd(const void* x, const void* scale, const void* dy,
               const void* g_s, void* dx, float* partial, void* dscale,
               int N, int d, float eps, int n_blocks, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  bool vec = d % kVec == 0 && aligned16(x) && aligned16(scale) &&
             aligned16(dy) && aligned16(dx);
  if (ADD) vec = vec && aligned16(g_s);
  return vec ? launch_bwd_packs<T, kVec, ADD>(x, scale, dy, g_s, dx, partial,
                                              dscale, N, d, eps, n_blocks, s)
             : launch_bwd_packs<T, 1, ADD>(x, scale, dy, g_s, dx, partial,
                                           dscale, N, d, eps, n_blocks, s);
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

// The backward of rmsnorm_fwd (g_s null) or of add_rmsnorm_fwd (x is then
// the saved s, and g_s, which may be null when s went unused, the upstream
// gradient of s): dx (N, d) and dscale (d,) in the call's dtype. partial is
// an fp32 scratch of n_blocks x d, n_blocks in [1, N], the number of blocks
// the rows are spread over (the caller fixes it from N alone, so that two
// calls sum in one order).
extern "C" int rmsnorm_bwd(const void* x, const void* scale, const void* dy,
                           const void* g_s, void* dx, void* partial,
                           void* dscale, int N, int d, float eps,
                           int n_blocks, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= 0 || d <= 0 || n_blocks <= 0 || n_blocks > N)
    return static_cast<int>(cudaErrorInvalidValue);
  float* p = static_cast<float*>(partial);
  if (dtype == 0)
    return g_s ? launch_bwd<float, true>(x, scale, dy, g_s, dx, p, dscale, N,
                                         d, eps, n_blocks, s)
               : launch_bwd<float, false>(x, scale, dy, g_s, dx, p, dscale,
                                          N, d, eps, n_blocks, s);
  if (dtype == 1)
    return g_s ? launch_bwd<__nv_bfloat16, true>(x, scale, dy, g_s, dx, p,
                                                 dscale, N, d, eps, n_blocks,
                                                 s)
               : launch_bwd<__nv_bfloat16, false>(x, scale, dy, g_s, dx, p,
                                                  dscale, N, d, eps,
                                                  n_blocks, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
