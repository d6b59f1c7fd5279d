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
//
// kd_loss_grad: the mutual-KD training step's loss, metrics and both logit
// gradients in one launch. The step's loss is a fixed combination of the
// four terms, each client's batch mean of
//   L = l1 ce_x + l2 kl_xy + l3 ce_y + l4 kl_yx
// (core/distill.py), so the upstream per-row gradients of the backward above
// are the constants l/B, and one kernel can write
//   dx = (l1/B)(p_x - onehot) + (l2/B) p_x ((x - y) - e_x)
//   dy = (l3/B)(p_y - onehot) + (l4/B) p_y ((y - x) - e_y)
// and, per client c, the batch means of ce_x, ce_y, kl_xy, kl_yx and the two
// argmax accuracies: out (6, C) fp32. That replaces the forward, the
// backward and about 30 small reductions around them per step.
//
// What bounds it: it reads x and y and writes dx and dy once, 4 N V
// elements, so it is memory-bound at vocabulary widths; at the CNN path's
// (C B, 10) rows the launch sets its time, and one launch is the design.
//
// Design. One warp per row (a stats sweep of the online (m, s, u) of the
// forward and the argmax with the first index kept on ties, then a gradient
// sweep), kWarps rows of one client per block, grid (row blocks, C). Each
// row's six values go to a scratch (6, N); the last block of a client to
// finish (an integer atomic per client, reset by that block) sums the
// client's B rows with one fixed assignment of rows to threads, so the
// result does not depend on which block came last and two runs are bitwise
// equal; no float atomics. Rows wider than kWideV take a
// block of kRowThreads each, with the same epilogue. Where the row pair
// fits in shared memory and rows are 16-byte aligned (bf16 up to V = 58k),
// the bulk-copy engine (cp.async.bulk) stages it in kChunks pieces, each on
// its own mbarrier; the stats sweep takes each piece as it lands, and the
// gradient sweep reads the staged pair again, so x and y are read from
// device memory once. Otherwise (fp32 at V = 32000) both sweeps read device
// memory, the second mostly from L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

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

// ---------------------------------------------------------------------- //
// kd_loss_grad
// ---------------------------------------------------------------------- //
constexpr int kWideV = 2048;       // wider rows take a block each
constexpr int kRowThreads = 512;   // threads of a wide row's block
constexpr int kChunks = 8;         // bulk-copy pieces of a staged row
constexpr int kSmemLimit = 232448; // shared memory a block can use
constexpr int kStageBase = 128;    // staged x begins here, after the barriers
constexpr int kNoIndex = 0x7fffffff;

// Online softmax state plus the running argmax (first index on ties).
struct Stat {
  float m, s, u;
  int arg;
};

__device__ __forceinline__ void push_stat(Stat& o, float a, float d, int v) {
  if (a > o.m) {
    const float r = __expf(o.m - a);
    o.s = o.s * r + 1.f;
    o.u = o.u * r + d;
    o.m = a;
    o.arg = v;
  } else {
    const float e = __expf(a - o.m);
    o.s += e;
    o.u += e * d;
  }
}

__device__ __forceinline__ void merge_stat(Stat& o, const Stat& p) {
  if (p.m > o.m || (p.m == o.m && p.arg < o.arg)) o.arg = p.arg;
  const float m = fmaxf(o.m, p.m);
  const float ra = __expf(o.m - m), rb = __expf(p.m - m);
  o.s = o.s * ra + p.s * rb;
  o.u = o.u * ra + p.u * rb;
  o.m = m;
}

__device__ __forceinline__ Stat shfl_stat(const Stat& o, int src, bool xor_) {
  if (xor_)
    return {__shfl_xor_sync(0xffffffffu, o.m, src),
            __shfl_xor_sync(0xffffffffu, o.s, src),
            __shfl_xor_sync(0xffffffffu, o.u, src),
            __shfl_xor_sync(0xffffffffu, o.arg, src)};
  return {__shfl_sync(0xffffffffu, o.m, src),
          __shfl_sync(0xffffffffu, o.s, src),
          __shfl_sync(0xffffffffu, o.u, src),
          __shfl_sync(0xffffffffu, o.arg, src)};
}

// merges the warp's states; every lane gets lane 0's result
__device__ __forceinline__ void warp_merge(Stat& o) {
#pragma unroll
  for (int mask = 16; mask > 0; mask >>= 1)
    merge_stat(o, shfl_stat(o, mask, true));
  o = shfl_stat(o, 0, false);
}

struct Lambdas {
  float ce_x, kl_xy, ce_y, kl_yx;  // each already divided by B
};

// The row's statistics from its two merged states; where dst is not null,
// its six values go to dst[0], dst[stride], ..., dst[5 * stride].
__device__ __forceinline__ void row_values(const Stat& sx, const Stat& sy,
                                           float xl, float yl, int lab,
                                           bool ok, float* dst, int stride,
                                           float& lse_x, float& lse_y,
                                           float& e_x, float& e_y) {
  lse_x = sx.m + logf(sx.s);
  lse_y = sy.m + logf(sy.s);
  e_x = sx.u / sx.s;
  e_y = sy.u / sy.s;
  if (dst == nullptr) return;
  const float nan = __int_as_float(0x7fc00000);
  dst[0 * stride] = ok ? lse_x - xl : nan;
  dst[1 * stride] = ok ? lse_y - yl : nan;
  dst[2 * stride] = e_x - lse_x + lse_y;
  dst[3 * stride] = e_y - lse_y + lse_x;
  dst[4 * stride] = sx.arg == lab ? 1.f : 0.f;
  dst[5 * stride] = sy.arg == lab ? 1.f : 0.f;
}

template <typename T>
__device__ __forceinline__ void grad_pair(float xv, float yv, bool hot,
                                          float lse_x, float lse_y, float e_x,
                                          float e_y, const Lambdas& l, T* dx,
                                          T* dy) {
  const float d = xv - yv;
  const float px = __expf(xv - lse_x), py = __expf(yv - lse_y);
  const float oh = hot ? 1.f : 0.f;
  *dx = from_f32<T>(l.ce_x * (px - oh) + l.kl_xy * px * (d - e_x));
  *dy = from_f32<T>(l.ce_y * (py - oh) + l.kl_yx * py * (-d - e_y));
}

// Called by every thread of every block once its rows are in `rows`: the
// last block of client c sums the client's B rows, in row order per
// thread and a fixed tree across threads, into out (6, C).
__device__ void client_epilogue(const float* rows, unsigned* counters,
                                float* out, int c, int C, int B, int N) {
  __shared__ bool last;
  __shared__ float partial[6][32];
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(&counters[c], 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  float acc[6];
#pragma unroll
  for (int q = 0; q < 6; ++q) acc[q] = 0.f;
  const size_t base = static_cast<size_t>(c) * B;
  for (int b = threadIdx.x; b < B; b += blockDim.x) {
#pragma unroll
    for (int q = 0; q < 6; ++q)
      acc[q] += __ldcg(rows + static_cast<size_t>(q) * N + base + b);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
#pragma unroll
  for (int q = 0; q < 6; ++q) {
#pragma unroll
    for (int mask = 16; mask > 0; mask >>= 1)
      acc[q] += __shfl_xor_sync(0xffffffffu, acc[q], mask);
    if (lane == 0) partial[q][warp] = acc[q];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int q = 0; q < 6; ++q) {
      float t = lane < warps ? partial[q][lane] : 0.f;
#pragma unroll
      for (int mask = 16; mask > 0; mask >>= 1)
        t += __shfl_xor_sync(0xffffffffu, t, mask);
      if (lane == 0) out[q * C + c] = t / static_cast<float>(B);
    }
    if (lane == 0) counters[c] = 0u;  // ready for the next launch
  }
}

// One warp's row: the stats sweep, the merge across lanes and the gradient
// sweep; lane 0 writes the row's six values to dst[0], dst[stride], ...
// A lane keeps its first kUnroll elements of x and y in registers for the
// gradient sweep, reads the label before the sweep and picks the labelled
// logits up on the way.
template <typename T>
__device__ __forceinline__ void warp_row(const T* __restrict__ x,
                                         const T* __restrict__ y, int lab,
                                         size_t off, int V, const Lambdas& l,
                                         T* __restrict__ dx,
                                         T* __restrict__ dy, float* dst,
                                         int stride) {
  const int lane = threadIdx.x & 31;
  const bool ok = lab >= 0 && lab < V;
  const T* xr = x + off;
  const T* yr = y + off;
  Stat sx{kEmpty, 0.f, 0.f, kNoIndex}, sy{kEmpty, 0.f, 0.f, kNoIndex};
  float hx[kUnroll], hy[kUnroll];
  float xl = 0.f, yl = 0.f;
  for (int base = lane; base < V; base += 32 * kUnroll) {
    float xv[kUnroll], yv[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int v = base + 32 * k;
      xv[k] = v < V ? to_f32(xr[v]) : 0.f;
      yv[k] = v < V ? to_f32(yr[v]) : 0.f;
    }
    if (base == lane) {
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        hx[k] = xv[k];
        hy[k] = yv[k];
      }
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int v = base + 32 * k;
      if (v < V) {
        const float d = xv[k] - yv[k];
        push_stat(sx, xv[k], d, v);
        push_stat(sy, yv[k], -d, v);
        if (v == lab) {
          xl = xv[k];
          yl = yv[k];
        }
      }
    }
  }
  warp_merge(sx);
  warp_merge(sy);
  // element v sits in lane v % 32
  xl = __shfl_sync(0xffffffffu, xl, lab & 31);
  yl = __shfl_sync(0xffffffffu, yl, lab & 31);
  float lse_x, lse_y, e_x, e_y;
  row_values(sx, sy, xl, yl, lab, ok, lane == 0 ? dst : nullptr, stride,
             lse_x, lse_y, e_x, e_y);
  for (int base = lane; base < V; base += 32 * kUnroll) {
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int v = base + 32 * k;
      if (v < V) {
        const bool held = base == lane;
        grad_pair<T>(held ? hx[k] : to_f32(xr[v]),
                     held ? hy[k] : to_f32(yr[v]), v == lab, lse_x, lse_y,
                     e_x, e_y, l, dx + off + v, dy + off + v);
      }
    }
  }
}

// One warp per row, kWarps rows of one client per block, and the
// last-block epilogue.
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    kd_grad_warp_kernel(const T* __restrict__ x, const T* __restrict__ y,
                        const int* __restrict__ labels, long long lab_stride,
                        int C, int B, int V, Lambdas l, T* __restrict__ dx,
                        T* __restrict__ dy, float* __restrict__ rows,
                        unsigned* __restrict__ counters,
                        float* __restrict__ out) {
  const int c = blockIdx.y;
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int N = C * B;
  if (b < B) {
    const int row = c * B + b;
    warp_row<T>(x, y, labels[static_cast<size_t>(c) * lab_stride + b],
                static_cast<size_t>(row) * V, V, l, dx, dy, rows + row, N);
  }
  client_epilogue(rows, counters, out, c, C, B, N);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One block of kRowThreads per row; STAGED: the row pair is staged in shared
// memory by the bulk-copy engine, else both sweeps read device memory.
template <typename T, bool STAGED>
__global__ void __launch_bounds__(kRowThreads)
    kd_grad_row_kernel(const T* __restrict__ x, const T* __restrict__ y,
                       const int* __restrict__ labels, long long lab_stride,
                       int C, int B, int V, Lambdas l, T* __restrict__ dx,
                       T* __restrict__ dy, float* __restrict__ rows,
                       unsigned* __restrict__ counters,
                       float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ Stat warp_stat[2][kRowThreads / 32];
  const int c = blockIdx.y, b = blockIdx.x;
  const int N = C * B, row = c * B + b;
  const size_t off = static_cast<size_t>(row) * V;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lab = labels[static_cast<size_t>(c) * lab_stride + b];
  const T* xr = x + off;
  const T* yr = y + off;
  // staged: piece k holds elements [k * piece, min((k + 1) * piece, V))
  const int piece = STAGED ? ((V + kChunks - 1) / kChunks + 7) / 8 * 8 : V;
  if constexpr (STAGED) {
    const size_t row_bytes = static_cast<size_t>(V) * sizeof(T);
    T* xs = reinterpret_cast<T*>(smem + kStageBase);
    T* ys = reinterpret_cast<T*>(smem + kStageBase +
                                 (row_bytes + 127) / 128 * 128);
    if (threadIdx.x == 0) {
      for (int k = 0; k < kChunks; ++k)
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                         smem_u32(smem + 8 * k))
                     : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      for (int k = 0; k < kChunks; ++k) {
        const int lo = min(k * piece, V), hi = min(lo + piece, V);
        const uint32_t bytes = static_cast<uint32_t>(hi - lo) * sizeof(T);
        const uint32_t bar = smem_u32(smem + 8 * k);
        asm volatile(
            "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
            "r"(2 * bytes)
            : "memory");
        if (bytes == 0) continue;
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
            " [%0], [%1], %2, [%3];" ::"r"(smem_u32(xs + lo)),
            "l"(xr + lo), "r"(bytes), "r"(bar)
            : "memory");
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
            " [%0], [%1], %2, [%3];" ::"r"(smem_u32(ys + lo)),
            "l"(yr + lo), "r"(bytes), "r"(bar)
            : "memory");
      }
    }
    __syncthreads();  // the barriers are initialised before anyone waits
    xr = xs;
    yr = ys;
  }
  Stat sx{kEmpty, 0.f, 0.f, kNoIndex}, sy{kEmpty, 0.f, 0.f, kNoIndex};
  for (int k = 0; k * piece < V; ++k) {
    if constexpr (STAGED) {
      const uint32_t bar = smem_u32(smem + 8 * k);
      uint32_t done = 0;
      do {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(bar)
            : "memory");
      } while (!done);
    }
    const int hi = min((k + 1) * piece, V);
    for (int v = k * piece + threadIdx.x; v < hi; v += kRowThreads) {
      const float xv = to_f32(xr[v]), yv = to_f32(yr[v]);
      const float d = xv - yv;
      push_stat(sx, xv, d, v);
      push_stat(sy, yv, -d, v);
    }
  }
  warp_merge(sx);
  warp_merge(sy);
  if (lane == 0) {
    warp_stat[0][warp] = sx;
    warp_stat[1][warp] = sy;
  }
  __syncthreads();
  sx = warp_stat[0][0];
  sy = warp_stat[1][0];
  for (int w = 1; w < kRowThreads / 32; ++w) {
    merge_stat(sx, warp_stat[0][w]);
    merge_stat(sy, warp_stat[1][w]);
  }
  const bool ok = lab >= 0 && lab < V;
  const float xl = ok ? to_f32(xr[lab]) : 0.f;
  const float yl = ok ? to_f32(yr[lab]) : 0.f;
  float lse_x, lse_y, e_x, e_y;
  row_values(sx, sy, xl, yl, lab, ok, threadIdx.x == 0 ? rows + row : nullptr,
             N, lse_x, lse_y, e_x, e_y);
  for (int v = threadIdx.x; v < V; v += kRowThreads)
    grad_pair<T>(to_f32(xr[v]), to_f32(yr[v]), v == lab, lse_x, lse_y, e_x,
                 e_y, l, dx + off + v, dy + off + v);
  client_epilogue(rows, counters, out, c, C, B, N);
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename T>
int launch_grad(const void* x, const void* y, const int* labels,
                long long lab_stride, int C, int B, int V, Lambdas l,
                void* dx, void* dy, float* rows, unsigned* counters,
                float* out, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const T* yt = static_cast<const T*>(y);
  T* dxt = static_cast<T*>(dx);
  T* dyt = static_cast<T*>(dy);
  if (V <= kWideV) {
    const dim3 grid((B + kWarps - 1) / kWarps, C);
    kd_grad_warp_kernel<T><<<grid, kWarps * 32, 0, s>>>(
        xt, yt, labels, lab_stride, C, B, V, l, dxt, dyt, rows, counters, out);
    return static_cast<int>(cudaGetLastError());
  }
  const dim3 grid(B, C);
  const size_t row_bytes = static_cast<size_t>(V) * sizeof(T);
  const size_t smem = kStageBase + 2 * ((row_bytes + 127) / 128 * 128);
  const size_t static_smem = 2 * (kRowThreads / 32) * sizeof(Stat) + 1024;
  const bool staged = row_bytes % 16 == 0 && aligned16(x) && aligned16(y) &&
                      smem + static_smem <= kSmemLimit;
  if (staged) {
    cudaError_t err = cudaFuncSetAttribute(
        kd_grad_row_kernel<T, true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    kd_grad_row_kernel<T, true><<<grid, kRowThreads, smem, s>>>(
        xt, yt, labels, lab_stride, C, B, V, l, dxt, dyt, rows, counters, out);
  } else {
    kd_grad_row_kernel<T, false><<<grid, kRowThreads, 0, s>>>(
        xt, yt, labels, lab_stride, C, B, V, l, dxt, dyt, rows, counters, out);
  }
  return static_cast<int>(cudaGetLastError());
}

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

// The mutual-KD step in one launch. x, y, dx, dy (C * B, V) in `dtype`;
// labels int32 (C, B) with a stride of lab_stride between clients and 1
// within; l_* the weights of ce_x, kl_xy, ce_y, kl_yx already divided by B;
// rows a (6, C * B) fp32 scratch; counters C zeroed uint32 (left zeroed);
// out (6, C) fp32. Returns cudaGetLastError() after the launch.
extern "C" int kd_loss_grad(const void* x, const void* y, const int* labels,
                            long long lab_stride, int C, int B, int V,
                            float l_ce_x, float l_kl_xy, float l_ce_y,
                            float l_kl_yx, void* dx, void* dy, float* rows,
                            unsigned* counters, float* out, int dtype,
                            void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C <= 0 || C > 65535 || B <= 0 || V <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Lambdas l{l_ce_x, l_kl_xy, l_ce_y, l_kl_yx};
  if (dtype == 0)
    return launch_grad<float>(x, y, labels, lab_stride, C, B, V, l, dx, dy,
                              rows, counters, out, s);
  if (dtype == 1)
    return launch_grad<__nv_bfloat16>(x, y, labels, lab_stride, C, B, V, l,
                                      dx, dy, rows, counters, out, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
