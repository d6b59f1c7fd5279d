// Fused mutual-KD loss (paper Eqs. 33-34) for Hopper (sm_90a): forward and
// backward over (N, V) logits of the local model (x) and the LiteModel (y).
//
// Replaces the Pallas TPU kernel src/repro/kernels/kd_loss.py::_kd_kernel,
// which computes the forward only. The port trains through this kernel, so
// it adds the backward.
//
// Forward, per row: ce_x = lse_x - x[label], ce_y = lse_y - y[label],
//   kl_xy = e_x - lse_x + lse_y with e_x = E_{p_x}[x - y],
//   kl_yx = e_y - lse_y + lse_x with e_y = E_{p_y}[y - x],
// from one online-softmax sweep that keeps, for x and for y, the running max
// m, the scaled sum s = sum exp(a - m) and u = sum exp(a - m) * (a - b).
// It also writes lse_x, lse_y, e_x, e_y for the backward.
//
// Backward, per element, with upstream per-row gradients g_* and
// p_x = exp(x - lse_x), p_y = exp(y - lse_y):
//   dx = g_ce_x (p_x - onehot) + g_kl_xy p_x ((x - y) - e_x)
//   dy = g_ce_y (p_y - onehot) + g_kl_yx p_y ((y - x) - e_y)
// kl_xy sends no gradient to y and kl_yx none to x: the stop-gradients of
// Eqs. 33-34 (src/repro/core/distill.py::mutual_losses).
//
// What bounds it: the forward reads 2*N*V elements and the backward reads
// 2*N*V and writes 2*N*V, a few flops and one exp per element each, so both
// are memory-bound at vocabulary widths. At the CNN path's shape (N = C*B up
// to 8*32 rows, V = 10) each launch moves a few KB and is bound by launch
// latency instead.
//
// Design: one warp per row, kWarps rows per block, no shared memory. Lanes
// stride over V with kUnroll independent loads in flight each, neighbouring
// lanes on neighbouring addresses, and accumulate in fp32; a warp-shuffle
// butterfly merges the lanes' (m, s, u) with the rescaling rule
// m = max(m1, m2), s = s1 exp(m1 - m) + s2 exp(m2 - m), u likewise. Lanes
// past V are masked (their state stays empty) instead of padding the
// tensor, and ragged N is bounds-checked per warp. The label is read
// directly; an out-of-range label gives NaN terms and no out-of-bounds read.
// TMA and a persistent grid are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;          // rows per block, one warp each
constexpr int kUnroll = 4;         // strided loads in flight per lane
constexpr float kEmpty = -1e30f;   // running max of a lane that saw nothing

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

// Online softmax state of one tensor: running max, scaled sum of exp and
// scaled sum of exp * (this - other).
struct Online {
  float m, s, u;
};

__device__ __forceinline__ void push(Online& o, float a, float d) {
  if (a > o.m) {
    const float r = __expf(o.m - a);
    o.s = o.s * r + 1.f;
    o.u = o.u * r + d;
    o.m = a;
  } else {
    const float e = __expf(a - o.m);
    o.s += e;
    o.u += e * d;
  }
}

__device__ __forceinline__ void merge(Online& o, const Online& p) {
  const float m = fmaxf(o.m, p.m);
  const float ra = __expf(o.m - m), rb = __expf(p.m - m);
  o.s = o.s * ra + p.s * rb;
  o.u = o.u * ra + p.u * rb;
  o.m = m;
}

__device__ __forceinline__ Online shfl_xor(const Online& o, int mask) {
  return {__shfl_xor_sync(0xffffffffu, o.m, mask),
          __shfl_xor_sync(0xffffffffu, o.s, mask),
          __shfl_xor_sync(0xffffffffu, o.u, mask)};
}

// out is (8, N) fp32: rows ce_x, ce_y, kl_xy, kl_yx, lse_x, lse_y, e_x, e_y.
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    kd_fwd_kernel(const T* __restrict__ x, const T* __restrict__ y,
                  const int* __restrict__ labels, float* __restrict__ out,
                  int N, int V) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= N) return;  // the whole warp leaves; no block barrier follows
  const T* xr = x + static_cast<size_t>(row) * V;
  const T* yr = y + static_cast<size_t>(row) * V;
  Online ox{kEmpty, 0.f, 0.f}, oy{kEmpty, 0.f, 0.f};
  for (int base = lane; base < V; base += 32 * kUnroll) {
    float xv[kUnroll], yv[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int v = base + 32 * k;
      xv[k] = v < V ? to_f32(xr[v]) : 0.f;
      yv[k] = v < V ? to_f32(yr[v]) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      if (base + 32 * k < V) {
        const float d = xv[k] - yv[k];
        push(ox, xv[k], d);
        push(oy, yv[k], -d);
      }
    }
  }
#pragma unroll
  for (int mask = 16; mask > 0; mask >>= 1) {
    merge(ox, shfl_xor(ox, mask));
    merge(oy, shfl_xor(oy, mask));
  }
  if (lane == 0) {
    const int lab = labels[row];
    const bool ok = lab >= 0 && lab < V;
    const float xl = ok ? to_f32(xr[lab]) : __int_as_float(0x7fc00000);
    const float yl = ok ? to_f32(yr[lab]) : __int_as_float(0x7fc00000);
    const float lse_x = ox.m + logf(ox.s), lse_y = oy.m + logf(oy.s);
    const float e_x = ox.u / ox.s, e_y = oy.u / oy.s;
    out[0 * N + row] = lse_x - xl;
    out[1 * N + row] = lse_y - yl;
    out[2 * N + row] = e_x - lse_x + lse_y;
    out[3 * N + row] = e_y - lse_y + lse_x;
    out[4 * N + row] = lse_x;
    out[5 * N + row] = lse_y;
    out[6 * N + row] = e_x;
    out[7 * N + row] = e_y;
  }
}

// stats (4, N): lse_x, lse_y, e_x, e_y; grads (4, N): upstream gradients of
// ce_x, ce_y, kl_xy, kl_yx.
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    kd_bwd_kernel(const T* __restrict__ x, const T* __restrict__ y,
                  const int* __restrict__ labels,
                  const float* __restrict__ stats,
                  const float* __restrict__ grads, T* __restrict__ dx,
                  T* __restrict__ dy, int N, int V) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= N) return;
  const size_t off = static_cast<size_t>(row) * V;
  const float lse_x = stats[row], lse_y = stats[N + row];
  const float e_x = stats[2 * N + row], e_y = stats[3 * N + row];
  const float g_ce_x = grads[row], g_ce_y = grads[N + row];
  const float g_kl_xy = grads[2 * N + row], g_kl_yx = grads[3 * N + row];
  const int lab = labels[row];
  for (int base = lane; base < V; base += 32 * kUnroll) {
    float xv[kUnroll], yv[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int v = base + 32 * k;
      xv[k] = v < V ? to_f32(x[off + v]) : 0.f;
      yv[k] = v < V ? to_f32(y[off + v]) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int v = base + 32 * k;
      if (v < V) {
        const float d = xv[k] - yv[k];
        const float px = __expf(xv[k] - lse_x), py = __expf(yv[k] - lse_y);
        const float oh = v == lab ? 1.f : 0.f;
        dx[off + v] = from_f32<T>(g_ce_x * (px - oh) + g_kl_xy * px * (d - e_x));
        dy[off + v] = from_f32<T>(g_ce_y * (py - oh) + g_kl_yx * py * (-d - e_y));
      }
    }
  }
}

inline dim3 grid_for(int N) { return dim3((N + kWarps - 1) / kWarps); }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (0 on success); the launch runs on `stream` and does not sync.
extern "C" int kd_loss_fwd(const void* x, const void* y, const int* labels,
                           float* out, int N, int V, int dtype,
                           void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    kd_fwd_kernel<float><<<grid_for(N), kWarps * 32, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(y), labels,
        out, N, V);
  } else if (dtype == 1) {
    kd_fwd_kernel<__nv_bfloat16><<<grid_for(N), kWarps * 32, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(y), labels, out, N, V);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int kd_loss_bwd(const void* x, const void* y, const int* labels,
                           const float* stats, const float* grads, void* dx,
                           void* dy, int N, int V, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    kd_bwd_kernel<float><<<grid_for(N), kWarps * 32, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(y), labels,
        stats, grads, static_cast<float*>(dx), static_cast<float*>(dy), N, V);
  } else if (dtype == 1) {
    kd_bwd_kernel<__nv_bfloat16><<<grid_for(N), kWarps * 32, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(y), labels, stats, grads,
        static_cast<__nv_bfloat16*>(dx), static_cast<__nv_bfloat16*>(dy), N,
        V);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
