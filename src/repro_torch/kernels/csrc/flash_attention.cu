// Causal / sliding-window attention forward with grouped KV heads, for
// Hopper (sm_90a): q (B, H, S, hd), k and v (B, KV, S, hd), H % KV == 0,
// -> o (B, H, S, hd) in q's type. Query head h reads KV head h / (H / KV),
// the grouping of src/repro/models/attention.py::gqa_attention, without
// copying K and V per query head. At KV = H it is the Pallas kernel's
// function exactly.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention.py::_flash_kernel. Its rules are kept:
// scale 1/sqrt(hd) applied to q, key j visible to query i when j <= i
// (causal) and j > i - window (when window > 0), an online softmax in fp32,
// o = acc / max(l, 1e-30), and KV tiles that no row of a query tile can see
// are not visited. Its S % block assert is not: ragged S is masked.
//
// What bounds it: at the serve path's prefill shape, q (4, 24, 512, 128) and
// k, v (4, 8, 512, 128) bf16, Q + K + V + O are 33.6 MB, 10.0 us at 3.35
// TB/s, and the causal QK^T and PV are 6.4 GFLOP, 6.5 us at 989 TFLOP/s on
// the bf16 tensor cores. This first version does its products on the fp32
// SIMT units instead (67 TFLOP/s peak), so it is bound by its own
// arithmetic and shared-memory traffic, far above both bounds; wgmma and TMA
// are left for later work.
//
// Design: one block of 8 warps per (query tile of 64 rows, batch x head),
// query tiles of the longest causal extent first. The query tile, pre-scaled,
// stays in shared memory as fp32; K and V tiles of 32 keys are staged there
// as fp32 through 16-byte loads (K rows padded by 4 floats, so that the 32
// lanes reading 32 different K rows hit different banks). Each warp owns 8
// query rows. For scores each lane owns one key of the tile (8 dot products
// of length hd); the row max is a warp-shuffle reduction, the row sum l is
// kept per lane and reduced once at the end. The probabilities go through
// a per-warp slice of shared memory, and for P V each lane owns hd/32
// output columns of the 8 rows, so the accumulator is 8 x hd/32 registers.
// Shared memory: 74,240 bytes at hd = 128 (the dynamic-shared-memory
// attribute is set above 48 KB), 41,472 at hd = 64.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockQ = 64;                // query rows per block
constexpr int kBlockK = 32;                // keys per tile, one per lane
constexpr int kWarps = 8;
constexpr int kRows = kBlockQ / kWarps;    // query rows per warp
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;          // running max before any key

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

template <int HD>
constexpr int smem_floats() {
  return kBlockQ * HD + kBlockK * (HD + 4) + kBlockK * HD +
         kWarps * kBlockK * kRows;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int mask = 16; mask > 0; mask >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, mask));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int mask = 16; mask > 0; mask >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, mask);
  return v;
}

// Rows [row0, row0 + nrows) of an (S, HD) matrix into shared memory as fp32
// times `mul`, `stride` floats apart; rows at or past S become zeros.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, int stride,
                                          const T* __restrict__ src,
                                          int row0, int nrows, int S,
                                          float mul) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = HD / kVec;
  for (int i = threadIdx.x; i < nrows * kPerRow; i += kThreads) {
    const int r = i / kPerRow, c = (i % kPerRow) * kVec;
    float f[kVec];
    if (row0 + r < S) {
      const Pack<T, kVec> p = *reinterpret_cast<const Pack<T, kVec>*>(
          src + static_cast<size_t>(row0 + r) * HD + c);
#pragma unroll
      for (int e = 0; e < kVec; ++e) f[e] = to_f32(p.v[e]) * mul;
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) f[e] = 0.f;
    }
    float* d = dst + r * stride + c;
#pragma unroll
    for (int e = 0; e < kVec; e += 4)
      *reinterpret_cast<float4*>(d + e) =
          make_float4(f[e], f[e + 1], f[e + 2], f[e + 3]);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int H, int KV,
                 int S, int causal, int window, float sm_scale) {
  constexpr int kStride = HD + 4;          // padded K row
  constexpr int kCols = HD / 32;           // output columns per lane
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + kBlockQ * HD;
  float* vs = ks + kBlockK * kStride;
  float* ps = vs + kBlockK * HD;

  const int qt = gridDim.x - 1 - blockIdx.x;   // longest causal rows first
  const int bh = blockIdx.y;
  const int b = bh / H, kvh = (bh % H) / (H / KV);
  const size_t kv_off = (static_cast<size_t>(b) * KV + kvh) * S * HD;
  const T* qb = q + static_cast<size_t>(bh) * S * HD;
  const T* kb = k + kv_off;
  const T* vb = v + kv_off;
  T* ob = o + static_cast<size_t>(bh) * S * HD;
  const int q0 = qt * kBlockQ;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = q0 + warp * kRows;      // this warp's first query row
  const float* qw = qs + warp * kRows * HD;
  float* pw = ps + warp * kBlockK * kRows;  // [key][row] probabilities

  load_tile<T, HD>(qs, HD, qb, q0, kBlockQ, S, sm_scale);

  // the keys some row of this tile can see: [k_begin, k_end)
  const int k_end = causal ? min(S, q0 + kBlockQ) : S;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;

  float m[kRows], l[kRows], acc[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = (k_begin / kBlockK) * kBlockK; k0 < k_end; k0 += kBlockK) {
    __syncthreads();   // the last tile's K, V and P are read (and Q loaded)
    load_tile<T, HD>(ks, kStride, kb, k0, kBlockK, S, 1.f);
    load_tile<T, HD>(vs, HD, vb, k0, kBlockK, S, 1.f);
    __syncthreads();

    float s[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) s[i] = 0.f;
    const float* kr = ks + lane * kStride;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      const float4 kk = *reinterpret_cast<const float4*>(kr + d);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float4 qq = *reinterpret_cast<const float4*>(qw + i * HD + d);
        s[i] = fmaf(qq.x, kk.x, s[i]);
        s[i] = fmaf(qq.y, kk.y, s[i]);
        s[i] = fmaf(qq.z, kk.z, s[i]);
        s[i] = fmaf(qq.w, kk.w, s[i]);
      }
    }

    const int kpos = k0 + lane;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qpos = row0 + i;
      const bool ok = kpos < S && (!causal || kpos <= qpos) &&
                      (window <= 0 || kpos > qpos - window);
      const float m_new = fmaxf(m[i], warp_max(ok ? s[i] : kNegInf));
      const float alpha = expf(m[i] - m_new);
      const float p = ok ? expf(s[i] - m_new) : 0.f;
      m[i] = m_new;
      l[i] = l[i] * alpha + p;             // this lane's keys only
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= alpha;
      pw[lane * kRows + i] = p;
    }
    __syncwarp();

#pragma unroll 4
    for (int c = 0; c < kBlockK; ++c) {
      const float4 p0 = *reinterpret_cast<const float4*>(pw + c * kRows);
      const float4 p1 = *reinterpret_cast<const float4*>(pw + c * kRows + 4);
      const float pr[kRows] = {p0.x, p0.y, p0.z, p0.w,
                               p1.x, p1.y, p1.z, p1.w};
      float vv[kCols];
      const float* vr = vs + c * HD + lane * kCols;
      if constexpr (kCols == 4) {
        const float4 t = *reinterpret_cast<const float4*>(vr);
        vv[0] = t.x; vv[1] = t.y; vv[2] = t.z; vv[3] = t.w;
      } else {
        const float2 t = *reinterpret_cast<const float2*>(vr);
        vv[0] = t.x; vv[1] = t.y;
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
#pragma unroll
        for (int j = 0; j < kCols; ++j)
          acc[i][j] = fmaf(pr[i], vv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const float denom = fmaxf(warp_sum(l[i]), 1e-30f);
    const int qpos = row0 + i;
    if (qpos < S) {
      T* orow = ob + static_cast<size_t>(qpos) * HD + lane * kCols;
#pragma unroll
      for (int j = 0; j < kCols; ++j) orow[j] = from_f32<T>(acc[i][j] / denom);
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int KV, int S, int causal, int window, float sm_scale,
           cudaStream_t s) {
  constexpr int kSmem = smem_floats<HD>() * sizeof(float);
  // above 48 KB of dynamic shared memory needs the attribute, which is per
  // device: set it before every launch (a host call, 28 per prefill)
  const cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBlockQ - 1) / kBlockQ, B * H);
  flash_kernel<T, HD><<<grid, kThreads, kSmem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, KV, S, causal, window,
      sm_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o all of it); hd 64 or 128;
// every pointer 16-byte aligned. Returns cudaGetLastError() after the
// launch (0 on success); the launch runs on `stream` and does not sync.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int B, int H,
                                   int KV, int S, int hd, int causal,
                                   int window, float sm_scale, int dtype,
                                   void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || KV <= 0 || H % KV != 0 || B * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0 && hd == 64)
    return launch<float, 64>(q, k, v, o, B, H, KV, S, causal, window,
                             sm_scale, s);
  if (dtype == 0 && hd == 128)
    return launch<float, 128>(q, k, v, o, B, H, KV, S, causal, window,
                              sm_scale, s);
  if (dtype == 1 && hd == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, o, B, H, KV, S, causal, window,
                                     sm_scale, s);
  if (dtype == 1 && hd == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, o, B, H, KV, S, causal,
                                      window, sm_scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
