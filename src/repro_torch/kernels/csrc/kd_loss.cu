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
// What bounds them: the forward reads 2 N V elements, the backward reads
// 2 N V and writes 2 N V, each with two exps and about ten other operations
// per (x, y) pair, so both are memory-bound at vocabulary widths, where the
// rate they reach is set by the bytes each SM keeps in flight (Little's law:
// about 25 KB an SM for 3 TB/s at a microsecond of latency). Next comes the
// exp unit (16 a clock an SM): at (1024, 151936) bf16 the forward's 311 M
// exps need about half of its byte bound, so the instructions spent per
// element matter too. At the CNN path's rows (N = C*B up to 8*32, V = 10) a
// launch moves a few KB and launch latency sets the time.
//
// Design, forward. Three variants, chosen from V and the dtype alone, so that
// a row's result never depends on N or on the rows beside it in the launch:
//   - rows of at most kNarrowBytes a tensor: a warp per row, kWarps rows a
//     block;
//   - wider rows: a block of kFwdThreads per row, or a thread block cluster
//     of 2, 4 or 8 such blocks per row once a row is wider than kSliceBytes,
//     so that a few rows still fill the 132 SMs in one launch. Each block of
//     a cluster sweeps one contiguous slice of the row; the slices' (m, s, u)
//     meet in block 0 through distributed shared memory, merged in rank
//     order.
// Each lane loads 16 bytes at a time (8 bf16 or 4 fp32 values), kFwdUnroll
// such vectors of x and of y in flight before it uses any, with streaming
// cache hints. A step takes the max of all its values first (bf16 pairs
// compared packed), rescales (s, u) once and then computes every exp
// independently, as ex2 of one FFMA with log2(e) folded in: no branch and no
// chain through the running max. Rows whose length or base is not 16-byte
// aligned (V = 777, a row slice x[3:67] of V = 4099) take the same variants
// with scalar loads instead; the pointers' alignment picks that, and a row
// slice of an aligned tensor stays aligned. Lanes, warps and cluster blocks
// merge their states in one fixed order with the rescaling rule
// m = max(m1, m2), s = s1 exp(m1 - m) + s2 exp(m2 - m), u likewise, so two
// launches are bitwise equal; no float atomics. The label is read directly
// (its load issued before the sweep); an out-of-range label gives NaN terms
// and no out-of-bounds read.
//
// Design, backward. Elementwise given each row's eight scalars: a grid of
// (row, slice) blocks, each thread kBwdVecs 16-byte vectors of x and y (all
// loaded before any is used), the row's scalars read once a thread through
// the read-only cache, vector stores of dx and dy; streaming hints on loads
// and stores, since nothing reads x or y again. Unaligned rows take scalar
// loads and stores as in the forward. A narrow row takes a block of as few
// whole warps as cover it (one at V = 10).
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

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
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

// ---------------------------------------------------------------------- //
// kd_loss_fwd and kd_loss_bwd
// ---------------------------------------------------------------------- //
constexpr int kNarrowBytes = 4096;  // rows up to this, a tensor: a warp each
constexpr int kFwdThreads = 256;    // threads of a wide row's block
constexpr int kSliceBytes = 32768;  // a wide block's slice of a row, at most
constexpr int kMaxCluster = 8;      // blocks a row, at most (portable size)
constexpr int kBwdThreads = 256;    // threads of a backward block, at most
constexpr int kBwdVecs = 4;         // vectors a backward thread
constexpr float kLog2e = 1.4426950408889634f;

// 2^a; exp(a - m) is ex2(fmaf(a, kLog2e, -m * kLog2e))
__device__ __forceinline__ float ex2(float a) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(a));
  return r;
}

// the larger of two bf16 pairs, pairwise
__device__ __forceinline__ uint32_t max_bf16x2(uint32_t a, uint32_t b) {
  uint32_t r;
  asm("max.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

// two floats rounded to a bf16 pair, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// W consecutive values of T as the 32-bit words of one load: 16 bytes when
// W * sizeof(T) is 16, else one value (a bf16 already in the high half of
// its word, where it is an fp32)
template <typename T, int W>
struct Pack {
  static constexpr int kWords = W * sizeof(T) == 16 ? 4 : 1;
  uint32_t w[kWords];

  __device__ __forceinline__ void load(const T* row, int vi) {
    if constexpr (kWords == 4) {
      const uint4 q = __ldcs(reinterpret_cast<const uint4*>(row) + vi);
      w[0] = q.x; w[1] = q.y; w[2] = q.z; w[3] = q.w;
    } else if constexpr (sizeof(T) == 4) {
      w[0] = __float_as_uint(__ldcs(reinterpret_cast<const float*>(row) + vi));
    } else {
      w[0] = static_cast<uint32_t>(__ldcs(
                 reinterpret_cast<const unsigned short*>(row) + vi)) << 16;
    }
  }

  // value i of W
  __device__ __forceinline__ float get(int i) const {
    if constexpr (sizeof(T) == 2 && kWords == 4)
      return __uint_as_float(i % 2 ? w[i / 2] & 0xffff0000u : w[i / 2] << 16);
    else
      return __uint_as_float(w[i]);
  }
};

// the largest of the U packs' values
template <typename T, int W, int U>
__device__ __forceinline__ float pack_max(const Pack<T, W> (&p)[U]) {
  if constexpr (sizeof(T) == 2 && Pack<T, W>::kWords == 4) {
    uint32_t m = p[0].w[0];
#pragma unroll
    for (int k = 0; k < U; ++k)
#pragma unroll
      for (int j = k == 0 ? 1 : 0; j < 4; ++j) m = max_bf16x2(m, p[k].w[j]);
    return fmaxf(__uint_as_float(m << 16), __uint_as_float(m & 0xffff0000u));
  } else {
    float m = p[0].get(0);
#pragma unroll
    for (int k = 0; k < U; ++k)
#pragma unroll
      for (int i = k == 0 ? 1 : 0; i < W; ++i) m = fmaxf(m, p[k].get(i));
    return m;
  }
}

// W values from `v` into the row at vector vi, with a streaming hint
template <typename T, int W>
__device__ __forceinline__ void store_pack(T* row, int vi,
                                           const float (&v)[W]) {
  if constexpr (W * sizeof(T) == 16 && sizeof(T) == 4) {
    __stcs(reinterpret_cast<float4*>(row) + vi,
           make_float4(v[0], v[1], v[2], v[3]));
  } else if constexpr (W * sizeof(T) == 16) {
    __stcs(reinterpret_cast<uint4*>(row) + vi,
           make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]),
                      pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7])));
  } else if constexpr (sizeof(T) == 4) {
    __stcs(reinterpret_cast<float*>(row) + vi, v[0]);
  } else {
    __stcs(reinterpret_cast<unsigned short*>(row) + vi,
           __bfloat16_as_ushort(__float2bfloat16_rn(v[0])));
  }
}

// Online softmax state of one tensor: running max, scaled sum of exp and
// scaled sum of exp * (this - other).
struct Online {
  float m, s, u;
};

__device__ __forceinline__ void merge(Online& o, const Online& p) {
  const float m = fmaxf(o.m, p.m);
  // the differences are exact 0 where a max is m: an empty state against
  // an empty one keeps s = 0
  const float ra = ex2((o.m - m) * kLog2e), rb = ex2((p.m - m) * kLog2e);
  o.s = o.s * ra + p.s * rb;
  o.u = o.u * ra + p.u * rb;
  o.m = m;
}

__device__ __forceinline__ Online shfl_xor(const Online& o, int mask) {
  return {__shfl_xor_sync(0xffffffffu, o.m, mask),
          __shfl_xor_sync(0xffffffffu, o.s, mask),
          __shfl_xor_sync(0xffffffffu, o.u, mask)};
}

// lane 0 ends with the warp's states merged in a fixed butterfly
__device__ __forceinline__ void warp_merge(Online& ox, Online& oy) {
#pragma unroll
  for (int mask = 16; mask > 0; mask >>= 1) {
    merge(ox, shfl_xor(ox, mask));
    merge(oy, shfl_xor(oy, mask));
  }
}

// One step over U packs of x and of y: the max of all their values first,
// then (s, u) rescaled once and every exp computed independently.
template <typename T, int W, int U>
__device__ __forceinline__ void step(Online& ox, Online& oy,
                                     const Pack<T, W> (&px)[U],
                                     const Pack<T, W> (&py)[U]) {
  const float mx = fmaxf(ox.m, pack_max(px)), my = fmaxf(oy.m, pack_max(py));
  const float nx = mx * kLog2e, ny = my * kLog2e;
  float sx = 0.f, ux = 0.f, sy = 0.f, uy = 0.f;
#pragma unroll
  for (int k = 0; k < U; ++k) {
#pragma unroll
    for (int i = 0; i < W; ++i) {
      const float a = px[k].get(i), b = py[k].get(i), d = a - b;
      const float ea = ex2(fmaf(a, kLog2e, -nx));
      const float eb = ex2(fmaf(b, kLog2e, -ny));
      sx += ea;
      ux = fmaf(ea, d, ux);
      sy += eb;
      uy = fmaf(-eb, d, uy);
    }
  }
  const float rx = ex2((ox.m - mx) * kLog2e), ry = ex2((oy.m - my) * kLog2e);
  ox = {mx, fmaf(ox.s, rx, sx), fmaf(ox.u, rx, ux)};
  oy = {my, fmaf(oy.s, ry, sy), fmaf(oy.u, ry, uy)};
}

// Thread t of nt sweeps vectors [lo, hi) of W values of the row pair: U
// vectors of each tensor loaded before any is used, then single vectors.
template <typename T, int W, int U>
__device__ __forceinline__ void sweep(const T* __restrict__ xr,
                                      const T* __restrict__ yr, int lo, int hi,
                                      int t, int nt, Online& ox, Online& oy) {
  int v = lo + t;
  for (; v + (U - 1) * nt < hi; v += U * nt) {
    Pack<T, W> px[U], py[U];
#pragma unroll
    for (int k = 0; k < U; ++k) {
      px[k].load(xr, v + k * nt);
      py[k].load(yr, v + k * nt);
    }
    step<T, W, U>(ox, oy, px, py);
  }
  for (; v < hi; v += nt) {
    Pack<T, W> px[1], py[1];
    px[0].load(xr, v);
    py[0].load(yr, v);
    step<T, W, 1>(ox, oy, px, py);
  }
}

// vectors a step of a forward thread loads from each tensor: 4 of 16 bytes
// (32 bf16 or 16 fp32 values), or 8 scalars
template <int W>
constexpr int kFwdUnroll = W == 1 ? 8 : 4;

// The row's labelled logits, NaN for a label outside [0, V); loaded early
struct Label {
  float xl, yl;
};

template <typename T>
__device__ __forceinline__ Label read_label(const T* xr, const T* yr,
                                            int lab, int V) {
  const bool ok = lab >= 0 && lab < V;
  const float nan = __int_as_float(0x7fc00000);
  return {ok ? to_f32(xr[lab]) : nan, ok ? to_f32(yr[lab]) : nan};
}

// out is (8, N) fp32: rows ce_x, ce_y, kl_xy, kl_yx, lse_x, lse_y, e_x, e_y.
__device__ __forceinline__ void write_row(float* __restrict__ out, int N,
                                          int row, const Online& ox,
                                          const Online& oy, Label l) {
  const float lse_x = ox.m + logf(ox.s), lse_y = oy.m + logf(oy.s);
  const float e_x = ox.u / ox.s, e_y = oy.u / oy.s;
  out[0 * N + row] = lse_x - l.xl;
  out[1 * N + row] = lse_y - l.yl;
  out[2 * N + row] = e_x - lse_x + lse_y;
  out[3 * N + row] = e_y - lse_y + lse_x;
  out[4 * N + row] = lse_x;
  out[5 * N + row] = lse_y;
  out[6 * N + row] = e_x;
  out[7 * N + row] = e_y;
}

// Narrow rows: one warp per row, kWarps rows per block.
template <typename T, int W>
__global__ void __launch_bounds__(kWarps * 32)
    kd_fwd_warp_kernel(const T* __restrict__ x, const T* __restrict__ y,
                       const int* __restrict__ labels, float* __restrict__ out,
                       int N, int V) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= N) return;  // the whole warp leaves; no block barrier follows
  const T* xr = x + static_cast<size_t>(row) * V;
  const T* yr = y + static_cast<size_t>(row) * V;
  Online ox{kEmpty, 0.f, 0.f}, oy{kEmpty, 0.f, 0.f};
  sweep<T, W, kFwdUnroll<W>>(xr, yr, 0, V / W, lane, 32, ox, oy);
  warp_merge(ox, oy);
  if (lane == 0)
    write_row(out, N, row, ox, oy, read_label(xr, yr, labels[row], V));
}

// Wide rows: `cl` blocks per row (a cluster when cl > 1), block r of a row
// sweeping the r-th of cl contiguous slices of its vectors.
template <typename T, int W>
__global__ void __launch_bounds__(kFwdThreads)
    kd_fwd_row_kernel(const T* __restrict__ x, const T* __restrict__ y,
                      const int* __restrict__ labels, float* __restrict__ out,
                      int N, int V, int cl) {
  __shared__ Online warp_state[2][kFwdThreads / 32];
  __shared__ Online block_state[2];
  const int row = blockIdx.x / cl, rank = blockIdx.x % cl;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const T* xr = x + static_cast<size_t>(row) * V;
  const T* yr = y + static_cast<size_t>(row) * V;
  const bool writer = rank == 0 && threadIdx.x == 0;
  Label l{0.f, 0.f};
  if (writer) l = read_label(xr, yr, labels[row], V);
  const int nvec = V / W, per = (nvec + cl - 1) / cl;
  const int lo = min(rank * per, nvec), hi = min(lo + per, nvec);
  Online ox{kEmpty, 0.f, 0.f}, oy{kEmpty, 0.f, 0.f};
  sweep<T, W, kFwdUnroll<W>>(xr, yr, lo, hi, threadIdx.x, kFwdThreads,
                                  ox, oy);
  warp_merge(ox, oy);
  if (lane == 0) {
    warp_state[0][warp] = ox;
    warp_state[1][warp] = oy;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    ox = warp_state[0][0];
    oy = warp_state[1][0];
    for (int w = 1; w < kFwdThreads / 32; ++w) {
      merge(ox, warp_state[0][w]);
      merge(oy, warp_state[1][w]);
    }
    block_state[0] = ox;
    block_state[1] = oy;
  }
  if (cl > 1) {
    namespace cg = cooperative_groups;
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // every block's state is in its shared memory
    if (writer) {
      for (int r = 1; r < cl; ++r) {
        const Online* p = cluster.map_shared_rank(block_state, r);
        merge(ox, p[0]);
        merge(oy, p[1]);
      }
    }
    cluster.sync();  // no block leaves while block 0 reads its state
  }
  if (writer) write_row(out, N, row, ox, oy, l);
}

// stats (4, N): lse_x, lse_y, e_x, e_y; grads (4, N): upstream gradients of
// ce_x, ce_y, kl_xy, kl_yx. Block b is slice b % slices of row b / slices,
// each thread kBwdVecs vectors of it.
template <typename T, int W>
__global__ void __launch_bounds__(kBwdThreads)
    kd_bwd_kernel(const T* __restrict__ x, const T* __restrict__ y,
                  const int* __restrict__ labels,
                  const float* __restrict__ stats,
                  const float* __restrict__ grads, T* __restrict__ dx,
                  T* __restrict__ dy, int N, int V, int slices) {
  const int row = blockIdx.x / slices, slice = blockIdx.x % slices;
  const size_t off = static_cast<size_t>(row) * V;
  const int nvec = V / W;
  const int first = slice * blockDim.x * kBwdVecs + threadIdx.x;
  Pack<T, W> px[kBwdVecs], py[kBwdVecs];
#pragma unroll
  for (int k = 0; k < kBwdVecs; ++k) {
    const int vi = first + k * blockDim.x;
    if (vi < nvec) {
      px[k].load(x + off, vi);
      py[k].load(y + off, vi);
    }
  }
  const float nx = __ldg(stats + row) * kLog2e;
  const float ny = __ldg(stats + N + row) * kLog2e;
  const float e_x = __ldg(stats + 2 * N + row);
  const float e_y = __ldg(stats + 3 * N + row);
  const float g_ce_x = __ldg(grads + row), g_ce_y = __ldg(grads + N + row);
  const float g_kl_xy = __ldg(grads + 2 * N + row);
  const float g_kl_yx = __ldg(grads + 3 * N + row);
  const int lab = __ldg(labels + row);
  // dx = p_x (g_ce_x - g_kl_xy e_x + g_kl_xy d) - g_ce_x onehot, d = x - y
  const float cx = g_ce_x - g_kl_xy * e_x, cy = g_ce_y - g_kl_yx * e_y;
#pragma unroll
  for (int k = 0; k < kBwdVecs; ++k) {
    const int vi = first + k * blockDim.x;
    if (vi >= nvec) break;
    float gx[W], gy[W];
#pragma unroll
    for (int i = 0; i < W; ++i) {
      const float a = px[k].get(i), b = py[k].get(i), d = a - b;
      gx[i] = ex2(fmaf(a, kLog2e, -nx)) * fmaf(g_kl_xy, d, cx);
      gy[i] = ex2(fmaf(b, kLog2e, -ny)) * fmaf(-g_kl_yx, d, cy);
    }
    if (vi == lab / W) {  // taken by one thread of the row, if any
#pragma unroll
      for (int i = 0; i < W; ++i) {
        if (vi * W + i == lab) {
          gx[i] -= g_ce_x;
          gy[i] -= g_ce_y;
        }
      }
    }
    store_pack<T, W>(dx + off, vi, gx);
    store_pack<T, W>(dy + off, vi, gy);
  }
}

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


// the forward's blocks a row for rows of `row_bytes` a tensor: the fewest,
// a power of two up to kMaxCluster, that cut the row into slices of at most
// kSliceBytes
inline int fwd_cluster(size_t row_bytes) {
  int cl = 1;
  while (cl < kMaxCluster && row_bytes > static_cast<size_t>(cl) * kSliceBytes)
    cl *= 2;
  return cl;
}

template <typename T, int W>
int launch_fwd(const T* x, const T* y, const int* labels, float* out, int N,
               int V, cudaStream_t s) {
  const size_t row_bytes = static_cast<size_t>(V) * sizeof(T);
  if (row_bytes <= kNarrowBytes) {
    kd_fwd_warp_kernel<T, W><<<(N + kWarps - 1) / kWarps, kWarps * 32, 0, s>>>(
        x, y, labels, out, N, V);
    return static_cast<int>(cudaGetLastError());
  }
  // one cluster launch for every cl; a cluster of 1 is a plain block
  const int cl = fwd_cluster(row_bytes);
  if (N > INT_MAX / cl) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(N * cl);
  cfg.blockDim = dim3(kFwdThreads);
  cfg.stream = s;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cl;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kd_fwd_row_kernel<T, W>, x, y, labels, out, N, V, cl);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int W>
int launch_bwd(const T* x, const T* y, const int* labels, const float* stats,
               const float* grads, T* dx, T* dy, int N, int V,
               cudaStream_t s) {
  const int nvec = V / W;
  const int want = (nvec + kBwdVecs - 1) / kBwdVecs;
  const int threads = want < kBwdThreads ? (want + 31) / 32 * 32 : kBwdThreads;
  const int per = threads * kBwdVecs;
  const int slices = (nvec + per - 1) / per;
  if (N > INT_MAX / slices) return static_cast<int>(cudaErrorInvalidValue);
  kd_bwd_kernel<T, W><<<N * slices, threads, 0, s>>>(
      x, y, labels, stats, grads, dx, dy, N, V, slices);
  return static_cast<int>(cudaGetLastError());
}

// 16-byte vectors where every row of x and y starts on 16 bytes
template <typename T>
bool vector_rows(const void* x, const void* y, int V) {
  return static_cast<size_t>(V) * sizeof(T) % 16 == 0 && aligned16(x) &&
         aligned16(y);
}

template <typename T>
int kd_fwd(const void* x, const void* y, const int* labels, float* out, int N,
           int V, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const T* yt = static_cast<const T*>(y);
  if (vector_rows<T>(x, y, V))
    return launch_fwd<T, 16 / sizeof(T)>(xt, yt, labels, out, N, V, s);
  return launch_fwd<T, 1>(xt, yt, labels, out, N, V, s);
}

template <typename T>
int kd_bwd(const void* x, const void* y, const int* labels, const float* stats,
           const float* grads, void* dx, void* dy, int N, int V,
           cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const T* yt = static_cast<const T*>(y);
  T* dxt = static_cast<T*>(dx);
  T* dyt = static_cast<T*>(dy);
  if (vector_rows<T>(x, y, V) && aligned16(dx) && aligned16(dy))
    return launch_bwd<T, 16 / sizeof(T)>(xt, yt, labels, stats, grads, dxt,
                                          dyt, N, V, s);
  return launch_bwd<T, 1>(xt, yt, labels, stats, grads, dxt, dyt, N, V, s);
}
}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (0 on success); the launch runs on `stream` and does not sync.
extern "C" int kd_loss_fwd(const void* x, const void* y, const int* labels,
                           float* out, int N, int V, int dtype,
                           void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= 0 || V <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return kd_fwd<float>(x, y, labels, out, N, V, s);
  if (dtype == 1) return kd_fwd<__nv_bfloat16>(x, y, labels, out, N, V, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int kd_loss_bwd(const void* x, const void* y, const int* labels,
                           const float* stats, const float* grads, void* dx,
                           void* dy, int N, int V, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= 0 || V <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return kd_bwd<float>(x, y, labels, stats, grads, dx, dy, N, V, s);
  if (dtype == 1)
    return kd_bwd<__nv_bfloat16>(x, y, labels, stats, grads, dx, dy, N, V, s);
  return static_cast<int>(cudaErrorInvalidValue);
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
