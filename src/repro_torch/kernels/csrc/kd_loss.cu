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
// elements, so it is memory-bound at vocabulary widths, provided each row
// pair stays on chip between the stats sweep and the gradient sweep: at
// (2048, 128256) fp32 a row pair is 1.03 MB, and one in flight on each SM
// is far beyond the 50 MB L2, so a second sweep would come from HBM again.
// At the CNN path's (C B, 10) rows the launch sets its time, and one launch
// is the design.
//
// Design. Two variants, chosen from V alone, and for the row kernel a
// cluster size from V and the dtype, so that a row's dx, dy and six values
// never depend on N, C or the rows beside it:
//   - V <= kWarpV (128): a warp per row, the whole row pair in registers
//     (a lane holds elements lane + 32 k), kWarps rows of one client a
//     block;
//   - wider rows: a block of up to kRowThreads per row, or a thread block
//     cluster of 2-16 such blocks once the row pair passes kPairSlice
//     (108 KB), so that at least two blocks fit an SM and one block's
//     loads overlap another's sweeps and stores (fp32 V 32000 and 50304: 4
//     blocks; 128256 and 151936: 16, a non-portable size). Each block
//     holds its contiguous slice of x and y on chip: the bulk-copy engine
//     (cp.async.bulk) stages it in shared memory on an mbarrier; where
//     that would leave room for only two blocks an SM and holding each
//     thread's first 16-byte unit in registers makes room for three (fp32
//     V 151936, bf16 151936), those units are loaded into registers
//     instead. The stats sweep is the forward's max-first step on 16-byte
//     units plus the argmax with the first index kept on ties. The
//     slices' states, and the labelled logits, meet in every block through
//     distributed shared memory and merge in a fixed tree; each block then
//     writes its slice's dx and dy from its copy with 16-byte streaming
//     stores. So x and y are read from device memory once. The grid holds
//     as many clusters as fit the card at once, each taking rows in turn,
//     so that a loss_chunk call of a few hundred rows fills the SMs too.
//     Rows whose length or base is not 16-byte aligned (V = 777, 2049)
//     take the same kernel with a slice staged by scalar loads and scalar
//     stores.
// Each row's six values go to a scratch (6, N), written by the row's first
// block; the last block to finish (an integer atomic, reset by that block:
// a client's in the warp kernel, the launch's in the row kernel) sums each
// client's B rows with one fixed assignment of rows to threads, so the
// result does not depend on which block came last and two runs are
// bitwise equal; no float atomics.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"   // mbarriers, bulk copies

#include <climits>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kWarps = 8;          // rows per block, one warp each
constexpr int kUnroll = 4;         // elements a lane holds of a warp's row
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

  // the same from shared memory: no cache hint
  __device__ __forceinline__ void load_plain(const T* row, int vi) {
    if constexpr (kWords == 4) {
      const uint4 q = reinterpret_cast<const uint4*>(row)[vi];
      w[0] = q.x; w[1] = q.y; w[2] = q.z; w[3] = q.w;
    } else if constexpr (sizeof(T) == 4) {
      w[0] = reinterpret_cast<const uint32_t*>(row)[vi];
    } else {
      w[0] = static_cast<uint32_t>(
                 reinterpret_cast<const unsigned short*>(row)[vi]) << 16;
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

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// 16-byte vectors where every row of x and y starts on 16 bytes
template <typename T>
bool vector_rows(const void* x, const void* y, int V) {
  return static_cast<size_t>(V) * sizeof(T) % 16 == 0 && aligned16(x) &&
         aligned16(y);
}

// ---------------------------------------------------------------------- //
// kd_loss_grad
// ---------------------------------------------------------------------- //
constexpr int kWarpV = 32 * kUnroll;  // rows up to this take a warp each
constexpr int kRowThreads = 256;      // threads of a row block, at most
constexpr int kStageBase = 128;       // the staged slice begins here
constexpr int kPairSlice = 110592;    // a block's bytes of a row pair, at most
constexpr int kMaxGradCluster = 16;   // blocks a row, at most (non-portable)
// room for a row block's static arrays (about 2.3 KB; launch_rows refuses a
// build whose arrays outgrow it)
constexpr int kGradStaticSmem = 3072;
// dynamic shared memory a row block may ask for: the 227 KB a block can use
// less its static arrays
constexpr int kGradSmemMax = 232448 - kGradStaticSmem;
// an SM's shared memory, and what a row block takes beside its dynamic
// shared memory (its static arrays and the 1 KB the runtime reserves)
constexpr size_t kSmSmem = 233472;
constexpr size_t kBlockSmemExtra = kGradStaticSmem + 1024;
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
  // the state with the smaller max is rescaled to the other's
  const float r = __expf(-fabsf(o.m - p.m));
  if (p.m > o.m) {
    o.s = o.s * r + p.s;
    o.u = o.u * r + p.u;
    o.m = p.m;
  } else {
    o.s += p.s * r;
    o.u += p.u * r;
  }
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

// merges the states of lanes [0, width), width a power of two (the
// others hold empty states); every lane gets lane 0's result
__device__ __forceinline__ void warp_merge(Stat& o, int width = 32) {
  for (int mask = width / 2; mask > 0; mask >>= 1)
    merge_stat(o, shfl_stat(o, mask, true));
  o = shfl_stat(o, 0, false);
}

struct Lambdas {
  float ce_x, kl_xy, ce_y, kl_yx;  // each already divided by B
};

// what the gradients of a row need: lse_x, lse_y, e_x, e_y
struct RowScalars {
  float lse_x, lse_y, e_x, e_y;
};

// The row's scalars from its two merged states; where dst is not null, its
// six values go to dst[0], dst[stride], ..., dst[5 * stride].
__device__ __forceinline__ RowScalars row_values(const Stat& sx,
                                                 const Stat& sy, float xl,
                                                 float yl, int lab, bool ok,
                                                 float* dst, int stride) {
  const RowScalars r{sx.m + logf(sx.s), sy.m + logf(sy.s), sx.u / sx.s,
                     sy.u / sy.s};
  if (dst == nullptr) return r;
  const float nan = __int_as_float(0x7fc00000);
  dst[0 * stride] = ok ? r.lse_x - xl : nan;
  dst[1 * stride] = ok ? r.lse_y - yl : nan;
  dst[2 * stride] = r.e_x - r.lse_x + r.lse_y;
  dst[3 * stride] = r.e_y - r.lse_y + r.lse_x;
  dst[4 * stride] = sx.arg == lab ? 1.f : 0.f;
  dst[5 * stride] = sy.arg == lab ? 1.f : 0.f;
  return r;
}

// dx and dy of one element pair; `hot` where the element is the label
__device__ __forceinline__ void grad_vals(float xv, float yv, bool hot,
                                          const RowScalars& r,
                                          const Lambdas& l, float& gx,
                                          float& gy) {
  const float d = xv - yv;
  const float px = ex2((xv - r.lse_x) * kLog2e);
  const float py = ex2((yv - r.lse_y) * kLog2e);
  const float oh = hot ? 1.f : 0.f;
  gx = l.ce_x * (px - oh) + l.kl_xy * px * (d - r.e_x);
  gy = l.ce_y * (py - oh) + l.kl_yx * py * (-d - r.e_y);
}

// Whether this block is the last of `blocks` blocks to pass `counter`;
// every thread of the block gets the answer. The rows the blocks wrote are
// fenced by their writers before they pass.
__device__ __forceinline__ bool last_block(unsigned* counter,
                                           unsigned blocks) {
  __shared__ bool last;
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(counter, 1u) == blocks - 1;
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// The block sums client c's B rows of `rows` (6, N), in row order per
// thread and a fixed tree across threads, into out[:, c] (6, C), so the
// sums do not depend on which block came last.
__device__ void sum_client(const float* rows, float* out, int c, int C,
                           int B, int N) {
  __shared__ float partial[6][32];
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
  }
  __syncthreads();  // partial is free for the next client
}

// One warp's row of at most kWarpV elements, held in registers (lane i
// holds elements i, i + 32, ...): the stats sweep, the merge across lanes
// and the gradients; lane 0 writes the row's six values to dst[0],
// dst[stride], ... The labelled logits are picked up on the way.
template <typename T>
__device__ __forceinline__ void warp_row(const T* __restrict__ x,
                                         const T* __restrict__ y, int lab,
                                         size_t off, int V, const Lambdas& l,
                                         T* __restrict__ dx,
                                         T* __restrict__ dy, float* dst,
                                         int stride) {
  const int lane = threadIdx.x & 31;
  const bool ok = lab >= 0 && lab < V;
  Stat sx{kEmpty, 0.f, 0.f, kNoIndex}, sy{kEmpty, 0.f, 0.f, kNoIndex};
  float xv[kUnroll], yv[kUnroll];
  float xl = 0.f, yl = 0.f;
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const int v = lane + 32 * k;
    xv[k] = v < V ? to_f32(x[off + v]) : 0.f;
    yv[k] = v < V ? to_f32(y[off + v]) : 0.f;
  }
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const int v = lane + 32 * k;
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
  warp_merge(sx);
  warp_merge(sy);
  // element v sits in lane v % 32
  xl = __shfl_sync(0xffffffffu, xl, lab & 31);
  yl = __shfl_sync(0xffffffffu, yl, lab & 31);
  const RowScalars r = row_values(sx, sy, xl, yl, lab, ok,
                                  lane == 0 ? dst : nullptr, stride);
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const int v = lane + 32 * k;
    if (v < V) {
      float gx, gy;
      grad_vals(xv[k], yv[k], v == lab, r, l, gx, gy);
      dx[off + v] = from_f32<T>(gx);
      dy[off + v] = from_f32<T>(gy);
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
  // the last block of the client to finish sums its rows
  __threadfence();
  if (last_block(&counters[c], gridDim.x)) {
    sum_client(rows, out, c, C, B, N);
    if (threadIdx.x == 0) counters[c] = 0u;  // ready for the next launch
  }
}

using hopper::bulk_load;
using hopper::mbar_expect_tx;
using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::smem_u32;

// bytes a row block stages of one tensor: `per` units of W values, in
// whole 128-byte lines
template <typename T, int W>
__host__ __device__ constexpr size_t slice_bytes(int per) {
  return (static_cast<size_t>(per) * W * sizeof(T) + 127) / 128 * 128;
}

// One stats step over U units of W values of x and of y, unit k's first
// element at e0 + k * stride * W: the running argmax (first index on ties;
// a thread's units come in increasing order) and the forward's max-first
// step.
template <typename T, int W, int U>
__device__ __forceinline__ void stat_step(Online& ox, Online& oy, int& ax,
                                          int& ay, const Pack<T, W> (&px)[U],
                                          const Pack<T, W> (&py)[U], int e0,
                                          int stride) {
  const float mx = pack_max(px), my = pack_max(py);
  if (mx > ox.m) {
#pragma unroll
    for (int k = U - 1; k >= 0; --k)
#pragma unroll
      for (int i = W - 1; i >= 0; --i)
        if (px[k].get(i) == mx) ax = e0 + k * stride * W + i;
  }
  if (my > oy.m) {
#pragma unroll
    for (int k = U - 1; k >= 0; --k)
#pragma unroll
      for (int i = W - 1; i >= 0; --i)
        if (py[k].get(i) == my) ay = e0 + k * stride * W + i;
  }
  step<T, W, U>(ox, oy, px, py);
}

// what a row block tells the others of its slice: the states of x and y,
// and the labelled logits where the slice holds the label
struct BlockState {
  Stat x, y;
  float xl, yl;
};

// units a thread of a row block takes at once in either sweep
constexpr int kRowUnroll = 2;

// Thread t of nt sweeps units [0, cnt) of a staged slice whose unit 0 is
// element e0 of the row: kRowUnroll units at a time, then single ones.
template <typename T, int W>
__device__ __forceinline__ void stat_sweep(const T* xs, const T* ys, int cnt,
                                           int e0, int t, int nt, Online& ox,
                                           Online& oy, int& ax, int& ay) {
  constexpr int U = kRowUnroll;
  int v = t;
  for (; v + (U - 1) * nt < cnt; v += U * nt) {
    Pack<T, W> px[U], py[U];
#pragma unroll
    for (int k = 0; k < U; ++k) {
      px[k].load_plain(xs, v + k * nt);
      py[k].load_plain(ys, v + k * nt);
    }
    stat_step<T, W, U>(ox, oy, ax, ay, px, py, e0 + v * W, nt);
  }
  for (; v < cnt; v += nt) {
    Pack<T, W> px[1], py[1];
    px[0].load_plain(xs, v);
    py[0].load_plain(ys, v);
    stat_step<T, W, 1>(ox, oy, ax, ay, px, py, e0 + v * W, nt);
  }
}

// The gradients of unit v, from its x and y, to unit v of dx and dy; `hot`
// where the unit holds the label, at value hot_i.
template <typename T, int W>
__device__ __forceinline__ void grad_unit(const Pack<T, W>& px,
                                          const Pack<T, W>& py, bool hot,
                                          int hot_i, const RowScalars& rs,
                                          const Lambdas& l, T* dx, T* dy,
                                          int v) {
  float gx[W], gy[W];
#pragma unroll
  for (int i = 0; i < W; ++i)
    grad_vals(px.get(i), py.get(i), hot && i == hot_i, rs, l, gx[i], gy[i]);
  store_pack<T, W>(dx, v, gx);
  store_pack<T, W>(dy, v, gy);
}

// A block's slice of a row, `bytes` of x from xg and of y from yg, into
// xs and ys onto the mbarrier at `bar`, by the bulk-copy engine (one
// thread).
__device__ __forceinline__ void fetch_slice(uint32_t bar, void* xs, void* ys,
                                            const void* xg, const void* yg,
                                            uint32_t bytes) {
  mbar_expect_tx(bar, 2 * bytes);
  if (bytes == 0) return;
  bulk_load(smem_u32(xs), xg, bytes, bar);
  bulk_load(smem_u32(ys), yg, bytes, bar);
}

// Rows wider than kWarpV. Each cluster of `cl` blocks (a plain block when
// cl = 1) takes rows q, q + G, q + 2G, ... of the N, q its index among the
// grid's G clusters; block r of a cluster holds the r-th of cl contiguous
// slices of a row pair on chip, `per` units of W values a tensor: in
// shared memory, staged by the bulk-copy engine on one mbarrier (W > 1) or
// by the threads with scalar loads (W = 1, rows off 16 bytes); with REG,
// the slice's first nt units in registers instead, one a thread, so that
// three blocks fit an SM. Once a row's gradients are written, the next
// row's slice is fetched, while the SM's other blocks sweep theirs. The
// blocks' states meet in every block through distributed shared memory
// and merge in a fixed tree; each block then writes its slice's gradients
// from its copy. A row's results do not depend on which cluster takes it.
template <typename T, int W, bool REG>
__global__ void __launch_bounds__(kRowThreads, REG ? 3 : 4)
    kd_grad_row_kernel(const T* __restrict__ x, const T* __restrict__ y,
                       const int* __restrict__ labels, long long lab_stride,
                       int C, int B, int V, int cl, Lambdas l,
                       T* __restrict__ dx, T* __restrict__ dy,
                       float* __restrict__ rows,
                       unsigned* __restrict__ counters,
                       float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ Stat warp_stat[2][kRowThreads / 32];
  // the cluster's blocks' states, [row parity][rank]
  __shared__ BlockState cluster_state[2][kMaxGradCluster];
  __shared__ RowScalars scalars;
  const int N = C * B;
  const int rank = blockIdx.x % cl, G = gridDim.x / cl;
  const int t = threadIdx.x, nt = blockDim.x;
  const int lane = t & 31, warp = t >> 5;
  // this block's units [lo, lo + cnt) of a row's V / W
  const int nunit = V / W, per = (nunit + cl - 1) / cl;
  const int lo = min(rank * per, nunit), cnt = min(per, nunit - lo);
  // REG: units [0, R) of the slice stay in registers, thread t holding
  // unit t; units [R, cnt) are staged in shared memory
  const int R = REG ? min(nt, cnt) : 0;
  const size_t slice = slice_bytes<T, W>(REG ? max(per - nt, 0) : per);
  const uint32_t bytes = static_cast<uint32_t>(cnt - R) * W * sizeof(T);
  // the staged units: x at xs, y at ys, their mbarrier at bar
  T* xs = reinterpret_cast<T*>(smem + kStageBase);
  T* ys = reinterpret_cast<T*>(smem + kStageBase + slice);
  const uint32_t bar = smem_u32(smem);
  auto slice_of = [&](int r) {
    return static_cast<size_t>(r) * V + static_cast<size_t>(lo) * W;
  };
  Pack<T, W> rx, ry;  // unit t of the slice, where t < R
  // row r's staged units [R, cnt) onto the mbarrier (thread 0); its units
  // [0, R) go to rx and ry where the fetch is called
  auto stage = [&](int r) {
    if (t == 0)
      fetch_slice(bar, xs, ys, x + slice_of(r) + R * W,
                  y + slice_of(r) + R * W, bytes);
  };
  const Stat empty{kEmpty, 0.f, 0.f, kNoIndex};
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  int row = blockIdx.x / cl;
  // a row's label, loaded a row ahead
  auto label_of = [&](int r) {
    const int c = r / B;
    return labels[static_cast<size_t>(c) * lab_stride + (r - c * B)];
  };
  int lab_next = row < N ? label_of(row) : 0;
  if constexpr (W > 1) {
    if (t == 0) {
      mbar_init(bar, 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    if (row < N) {
      stage(row);
      if (t < R) {
        rx.load(x + slice_of(row), t);
        ry.load(y + slice_of(row), t);
      }
    }
  }
  // the mbarrier is initialised before anyone waits, and every block of
  // the cluster runs before any writes to another's shared memory
  if (cl > 1)
    cluster.sync();
  else
    __syncthreads();
  for (int j = 0; row < N; row += G, ++j) {
    const int par = j & 1;
    const int lab = lab_next;
    if (row + G < N) lab_next = label_of(row + G);
    const bool ok = lab >= 0 && lab < V;
    const size_t off = slice_of(row);
    if constexpr (W > 1) {
      mbar_wait(bar, par);
    } else {
      // raw words: 8 of each tensor in flight a thread
      using Raw = std::conditional_t<sizeof(T) == 4, unsigned, unsigned short>;
      const Raw* xg = reinterpret_cast<const Raw*>(x + off);
      const Raw* yg = reinterpret_cast<const Raw*>(y + off);
      Raw* xw = reinterpret_cast<Raw*>(xs);
      Raw* yw = reinterpret_cast<Raw*>(ys);
      for (int i0 = t; i0 < cnt; i0 += 8 * nt) {
        Raw a[8], e[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int i = i0 + k * nt;
          if (i < cnt) {
            a[k] = __ldcs(xg + i);
            e[k] = __ldcs(yg + i);
          }
        }
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int i = i0 + k * nt;
          if (i < cnt) {
            xw[i] = a[k];
            yw[i] = e[k];
          }
        }
      }
      __syncthreads();
    }
    Online ox{kEmpty, 0.f, 0.f}, oy{kEmpty, 0.f, 0.f};
    int ax = kNoIndex, ay = kNoIndex;
    if (t < R) {
      const Pack<T, W> px[1] = {rx}, py[1] = {ry};
      stat_step<T, W, 1>(ox, oy, ax, ay, px, py, (lo + t) * W, nt);
    }
    stat_sweep<T, W>(xs, ys, cnt - R, (lo + R) * W, t, nt, ox, oy, ax, ay);
    // the labelled logits where a register unit holds them
    __shared__ float reg_label[2];
    if (ok && t < R && lab / W == lo + t) {
#pragma unroll
      for (int i = 0; i < W; ++i)
        if (i == lab % W) {
          reg_label[0] = rx.get(i);
          reg_label[1] = ry.get(i);
        }
    }
    // lanes, then warps, then the cluster's blocks, each in a fixed tree
    Stat sx{ox.m, ox.s, ox.u, ax}, sy{oy.m, oy.s, oy.u, ay};
    warp_merge(sx);
    warp_merge(sy);
    if (lane == 0) {
      warp_stat[0][warp] = sx;
      warp_stat[1][warp] = sy;
    }
    __syncthreads();
    if (warp == 0) {
      sx = lane < nt / 32 ? warp_stat[0][lane] : empty;
      sy = lane < nt / 32 ? warp_stat[1][lane] : empty;
      warp_merge(sx, kRowThreads / 32);
      warp_merge(sy, kRowThreads / 32);
      // the labelled logits, from the block whose slice holds them
      const int at = ok ? lab - lo * W : -1;
      const bool in_reg = at >= 0 && at < R * W;
      const bool in_smem = at >= R * W && at < cnt * W;
      const int sat = in_smem ? at - R * W : 0;
      const BlockState st{sx, sy,
                          in_reg ? reg_label[0]
                                 : in_smem ? to_f32(xs[sat]) : 0.f,
                          in_reg ? reg_label[1]
                                 : in_smem ? to_f32(ys[sat]) : 0.f};
      // lane r writes the block's state into block r of the cluster
      if (lane < cl)
        *(cl > 1 ? cluster.map_shared_rank(&cluster_state[par][rank], lane)
                 : &cluster_state[par][rank]) = st;
    }
    if (cl > 1)
      cluster.sync();  // every block holds every block's state
    else
      __syncthreads();
    if (warp == 0) {
      sx = lane < cl ? cluster_state[par][lane].x : empty;
      sy = lane < cl ? cluster_state[par][lane].y : empty;
      warp_merge(sx, kMaxGradCluster);
      warp_merge(sy, kMaxGradCluster);
      if (lane == 0) {
        // the rank whose slice holds the label
        const BlockState& h = cluster_state[par][ok ? lab / W / per : 0];
        scalars = row_values(sx, sy, h.xl, h.yl, lab, ok,
                             rank == 0 ? rows + row : nullptr, N);
      }
    }
    __syncthreads();
    const RowScalars rs = scalars;
    // the label's unit in this slice, if any
    const int hot = ok ? lab / W - lo : -1, hot_i = ok ? lab % W : -1;
    if (t < R)
      grad_unit<T, W>(rx, ry, t == hot, hot_i, rs, l, dx + off, dy + off, t);
    // shared memory's unit v is the slice's unit R + v
    T* dxs = dx + off + R * W;
    T* dys = dy + off + R * W;
    const int sm = cnt - R, shot = hot - R;
    constexpr int U = kRowUnroll;
    int v = t;
    for (; v + (U - 1) * nt < sm; v += U * nt) {
      Pack<T, W> px[U], py[U];
#pragma unroll
      for (int k = 0; k < U; ++k) {
        px[k].load_plain(xs, v + k * nt);
        py[k].load_plain(ys, v + k * nt);
      }
#pragma unroll
      for (int k = 0; k < U; ++k)
        grad_unit<T, W>(px[k], py[k], v + k * nt == shot, hot_i, rs, l, dxs,
                        dys, v + k * nt);
    }
    for (; v < sm; v += nt) {
      Pack<T, W> px, py;
      px.load_plain(xs, v);
      py.load_plain(ys, v);
      grad_unit<T, W>(px, py, v == shot, hot_i, rs, l, dxs, dys, v);
    }
    __syncthreads();  // every thread is done with the slice
    // the next row's slice: the staged values were all consumed before the
    // barrier, so the copy cannot overtake a read of them
    if constexpr (W > 1) {
      if (row + G < N) {
        stage(row + G);
        if (t < R) {
          rx.load(x + slice_of(row + G), t);
          ry.load(y + slice_of(row + G), t);
        }
      }
    }
  }
  if (rank == 0) {
    // the last of the G first blocks to finish sums every client's rows
    if (t == 0) __threadfence();
    if (last_block(counters, G)) {
      for (int c = 0; c < C; ++c) sum_client(rows, out, c, C, B, N);
      if (t == 0) counters[0] = 0u;  // ready for the next launch
    }
  }
}

// kd_loss_grad's row blocks a row for a row pair of `pair_bytes`: the
// fewest, a power of two up to kMaxGradCluster, that cut it into slices of
// at most kPairSlice, so that two blocks fit an SM
inline int grad_cluster(size_t pair_bytes) {
  int cl = 1;
  while (cl < kMaxGradCluster &&
         pair_bytes > static_cast<size_t>(cl) * kPairSlice)
    cl *= 2;
  return cl;
}

// row blocks with `smem` bytes of dynamic shared memory that fit an SM by
// their shared memory
inline int blocks_by_smem(size_t smem) {
  return static_cast<int>(kSmSmem / (smem + kBlockSmemExtra));
}

template <typename T, int W, bool REG>
int launch_rows(const T* x, const T* y, const int* labels, long long lab_stride,
                int C, int B, int V, int cl, int threads, size_t smem,
                Lambdas l, T* dx, T* dy, float* rows, unsigned* counters,
                float* out, cudaStream_t s) {
  auto kernel = kd_grad_row_kernel<T, W, REG>;
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (fa.sharedSizeBytes > static_cast<size_t>(kGradStaticSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err == cudaSuccess && cl > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cl);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cl;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  // as many clusters as the card holds at once, at most one a row
  int active = 0;
  err = cudaOccupancyMaxActiveClusters(&active, kernel, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (active < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  cfg.gridDim = dim3(min(C * B, active) * cl);
  err = cudaLaunchKernelEx(&cfg, kernel, x, y, labels, lab_stride, C, B, V,
                           cl, l, dx, dy, rows, counters, out);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The row kernel's cluster size, threads and shared memory, from V and the
// dtype alone; a slice held partly in registers where that fits more blocks
// on an SM.
template <typename T, int W>
int launch_grad_rows(const T* x, const T* y, const int* labels,
                     long long lab_stride, int C, int B, int V, Lambdas l,
                     T* dx, T* dy, float* rows, unsigned* counters,
                     float* out, cudaStream_t s) {
  const int cl = grad_cluster(2 * static_cast<size_t>(V) * sizeof(T));
  const int per = (V / W + cl - 1) / cl;
  // about two units of each tensor a thread, in whole warps
  const int threads = min(kRowThreads, ((per + 1) / 2 + 31) / 32 * 32);
  const size_t smem = kStageBase + 2 * slice_bytes<T, W>(per);
  const size_t smem_reg =
      kStageBase + 2 * slice_bytes<T, W>(max(per - threads, 0));
  // rows wider than 16 blocks' shared memory hold are refused
  if (smem > kGradSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (W > 1)
    if (blocks_by_smem(smem) < 3 && blocks_by_smem(smem_reg) >= 3)
      return launch_rows<T, W, true>(x, y, labels, lab_stride, C, B, V, cl,
                                     threads, smem_reg, l, dx, dy, rows,
                                     counters, out, s);
  return launch_rows<T, W, false>(x, y, labels, lab_stride, C, B, V, cl,
                                  threads, smem, l, dx, dy, rows, counters,
                                  out, s);
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
  if (V <= kWarpV) {
    const dim3 grid((B + kWarps - 1) / kWarps, C);
    kd_grad_warp_kernel<T><<<grid, kWarps * 32, 0, s>>>(
        xt, yt, labels, lab_stride, C, B, V, l, dxt, dyt, rows, counters, out);
    return static_cast<int>(cudaGetLastError());
  }
  if (vector_rows<T>(x, y, V) && aligned16(dx) && aligned16(dy))
    return launch_grad_rows<T, 16 / sizeof(T)>(xt, yt, labels, lab_stride, C,
                                               B, V, l, dxt, dyt, rows,
                                               counters, out, s);
  return launch_grad_rows<T, 1>(xt, yt, labels, lab_stride, C, B, V, l, dxt,
                                dyt, rows, counters, out, s);
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
