// Causal / sliding-window attention forward with grouped KV heads, for
// Hopper (sm_90a): q (B, H, S, hd), k and v (B, KV, S, hd), H % KV == 0,
// -> o (B, H, S, hd) in q's type. Each of q, k, v and o is taken as a view
// with its own batch, head and row strides (in elements) and a unit stride
// on hd, so the transposed views of the model's (B, S, H, hd) tensors are
// read and written where they lie, with no copy. Query head h reads KV head
// h / (H / KV), the grouping of src/repro/models/attention.py::gqa_attention,
// without copying K and V per query head. At KV = H it is the Pallas
// kernel's function exactly.
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
// TB/s, and the causal QK^T and PV are 6.45 GFLOP, 6.5 us at 989 TFLOP/s on
// the bf16 tensor cores: bytes bound it, by a little.
//
// Two designs, one per type:
//
// * bfloat16: tensor cores through wgmma, fed by TMA (flash_wgmma_kernel).
//   A block is one consumer warpgroup and one producer warp (160 threads)
//   over 64 query rows, the m64 of one wgmma. The producer warp's lane 0
//   loads the block's Q once and keeps K and V tiles of 64 keys in flight
//   in two rings of two stages, each stage with a full and an empty
//   mbarrier: Q K^T starts while V still arrives, and a K stage is freed
//   as soon as its Q K^T is done, before the P V of its tile. Tiles land in
//   shared memory with the 128-byte swizzle, in panels of 64 columns (one
//   swizzle row is 64 bf16 values, so hd 128 is two panels); the wgmma
//   descriptors use the same swizzle. S = Q K^T is
//   an m64n64k16 wgmma with both operands in shared memory, K [key][hd]
//   being K-major already. P is rounded to bf16 in registers: the fp32
//   accumulator fragment of S is, pair for pair, the A-register fragment of
//   the next wgmma, so O += P V is an m64n{hd}k16 wgmma with A from
//   registers and V read MN-major ("transposed"), as it lies. Tile t's
//   Q K^T and tile t-1's P V are issued together, and the softmax of tile t
//   runs while P V is still on the tensor cores. The tensor maps carry the
//   caller's strides and do the addressing; their out-of-bounds zero fill
//   and clipped stores handle ragged S, and the kpos < S mask keeps the
//   zero-filled keys out of the softmax. O is normalised in registers,
//   written over the Q tile in the same swizzled layout and stored by TMA.
//   Shared memory: 1024 (alignment) + 16 KB Q + 2 x (16 + 16) KB K/V + 72
//   bytes of barriers = 83,016 bytes at hd 128, 42,056 at hd 64, so two
//   blocks share an SM. Registers (ptxas of CUDA 12.9): 149 at hd 128, 117
//   at hd 64, no spills.
//   hd 112 (zamba2-7b's shared block) runs on hd 128's tiles: the tensor
//   maps carry the true hd, so TMA zero-fills columns 112..127 of the
//   second panel on a load and clips them on the store of O
//   (hopper.cuh). Q K^T takes 7 k-steps of 16 and never reads the pad;
//   P V runs at n128, whose last 16 columns are P times V's zero pad and
//   are never stored. The mbarriers expect the whole boxes' bytes, the
//   zero fill included. So the kernel moves hd 112's bytes from device
//   memory and spends hd 128's shared memory and registers and 8/7 of its
//   P V products.
//   hd 224 (Zamba2-7B's shared blocks, scale (hd / 2)^-0.5) runs on tiles
//   of four panels, 256 wide, zero-filled past 224 as hd 112's are past
//   112: Q K^T takes 14 k-steps, P V two m64n128k16 products a k-step (the
//   second on V's panels 2-3, `wgmma_rs<256>`), and O is 128 fp32
//   registers a thread. Shared memory: 1024 + 32 KB Q + 2 x (32 + 32) KB
//   K/V + 72 bytes = 164,936 bytes, one block an SM, so one block's Q load
//   and O store are no longer hidden behind another's main loop. Forward
//   only: the backward keeps hd 64, 112 and 128.
//   Why one consumer warpgroup a block and not two over 128 rows: with two
//   (288 threads, about 150 registers) only one block fits an SM, and each
//   block's Q load and O store stall its SM; two independent 64-row blocks
//   per SM overlap one's prologue and epilogue with the other's main loop,
//   and 64-row tiles balance the causal waves more finely. The K/V tiles
//   are then read twice as often, from L2. Measured at the prefill shape
//   and three others, the 64-row block was the faster (PERF.md, Findings).
//
// * float32: the SIMT kernel (flash_simt_kernel). wgmma takes fp32 inputs
//   only as TF32, which keeps about three decimal digits; the fp32 path is
//   held to the plain version at 2e-5 and to the CPU at 1e-3, which TF32
//   would break. One block of 8 warps per (query tile of 64 rows, batch x
//   head). The query tile, pre-scaled, stays in shared memory; K and V tiles
//   of 32 keys are staged there through 16-byte loads (K rows padded by 4
//   floats, so that the 32 lanes reading 32 different K rows hit different
//   banks). Each warp owns 8 query rows. For scores each lane owns one key of
//   the tile; the row max is a warp-shuffle reduction, the row sum l is kept
//   per lane and reduced once at the end. The probabilities go through a
//   per-warp slice of shared memory, and for P V each lane owns W/32 output
//   columns of the 8 rows, W = hd rounded up to a multiple of 32 (the tiles
//   are W wide in shared memory, zeros past hd: at hd 112, W = 128 and
//   lanes 28..31 hold only pad columns, which are never stored). Shared
//   memory: 74,240 bytes at hd 128 and 112, 41,472 at hd 64.
//
// Both grids are (batch x head, query tiles) with the query tiles of the
// longest causal extent scheduled first, so that the short tiles fill the
// last wave.
//
// Given an lse pointer (fp32, (B, H, S) contiguous), both kernels also
// write each row's log-sum-exp of its scaled scores, m + log(l) in natural
// units, which the backward (flash_attention_bwd.cu) reads. The store is
// added after o is computed and changes nothing of it.
//
// The mbarrier, TMA and wgmma helpers, the swizzled tile layout and the
// tensor-map encoding are hopper.cuh's, shared with the backward.

#include "hopper.cuh"

#include <math.h>

namespace {

constexpr float kNegInf = -1e30f;          // running max before any key

// ------------------------------------------------------------------------
// float32: the SIMT kernel
// ------------------------------------------------------------------------
namespace simt {

constexpr int kBlockQ = 64;                // query rows per block
constexpr int kBlockK = 32;                // keys per tile, one per lane
constexpr int kWarps = 8;
constexpr int kRows = kBlockQ / kWarps;    // query rows per warp
constexpr int kThreads = kWarps * 32;

// the columns a row of hd takes in shared memory: whole lanes of 32
__host__ __device__ constexpr int width(int hd) {
  return (hd + 31) / 32 * 32;
}

template <int HD>
constexpr int smem_floats() {
  constexpr int W = width(HD);
  return kBlockQ * W + kBlockK * (W + 4) + kBlockK * W +
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

// Rows [row0, row0 + NROWS) of an (S, HD) matrix whose rows lie
// `row_stride` floats apart into shared memory times `mul`, `stride` floats
// apart, width(HD) columns a row; rows at or past S, and columns past HD,
// become zeros. Each thread keeps one 16-byte column and steps its one
// pointer by whole passes of the block, so that what it holds across the
// key loop does not grow with the row stride.
template <int HD, int NROWS>
__device__ __forceinline__ void load_tile(float* dst, int stride,
                                          const float* __restrict__ src,
                                          int row_stride, int row0, int S,
                                          float mul) {
  constexpr int kPerRow = width(HD) / 4;           // float4s per row
  constexpr int kPass = kThreads / kPerRow;        // rows per pass
  const int r0 = threadIdx.x / kPerRow, c = (threadIdx.x % kPerRow) * 4;
  static_assert(NROWS % kPass == 0, "whole passes");
  const bool col_ok = HD == width(HD) || c < HD;
  const float* p = src + static_cast<long long>(row0 + r0) * row_stride + c;
#pragma unroll
  for (int j = 0; j < NROWS / kPass; ++j) {
    const int r = r0 + j * kPass;
    float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
    if (col_ok && row0 + r < S) {
      f = *reinterpret_cast<const float4*>(p);
      f.x *= mul; f.y *= mul; f.z *= mul; f.w *= mul;
    }
    *reinterpret_cast<float4*>(dst + r * stride + c) = f;
    p += static_cast<long long>(kPass) * row_stride;
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
    flash_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o,
                      float* __restrict__ lse, Strides sq, Strides sk,
                      Strides sv, Strides so, int H, int KV, int S,
                      int causal, int window, float sm_scale) {
  constexpr int W = width(HD);             // a row's columns in smem
  constexpr int kStride = W + 4;           // padded K row
  constexpr int kCols = W / 32;            // output columns per lane
  static_assert(HD % kCols == 0, "a lane's columns are all or none past hd");
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + kBlockQ * W;
  float* vs = ks + kBlockK * kStride;
  float* ps = vs + kBlockK * W;

  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;   // longest causal rows first
  const int b = bh / H, h = bh % H, kvh = h / (H / KV);
  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + kvh * sk.h;
  const float* vb = v + b * sv.b + kvh * sv.h;
  const int k_row = static_cast<int>(sk.s), v_row = static_cast<int>(sv.s);
  const int q0 = qt * kBlockQ;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = q0 + warp * kRows;      // this warp's first query row
  const float* qw = qs + warp * kRows * W;
  float* pw = ps + warp * kBlockK * kRows;  // [key][row] probabilities

  load_tile<HD, kBlockQ>(qs, W, qb, static_cast<int>(sq.s), q0, S,
                         sm_scale);

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
    load_tile<HD, kBlockK>(ks, kStride, kb, k_row, k0, S, 1.f);
    load_tile<HD, kBlockK>(vs, W, vb, v_row, k0, S, 1.f);
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
        const float4 qq = *reinterpret_cast<const float4*>(qw + i * W + d);
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
      const float* vr = vs + c * W + lane * kCols;
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

  float* ob = o + b * so.b + h * so.h;     // not held across the loop
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const float l_row = warp_sum(l[i]);
    const float denom = fmaxf(l_row, 1e-30f);
    const int qpos = row0 + i;
    if (qpos < S) {
      float* orow = ob + qpos * so.s + lane * kCols;
      if (HD == W || lane * kCols < HD) {
#pragma unroll
        for (int j = 0; j < kCols; ++j) orow[j] = acc[i][j] / denom;
      }
      if (lse != nullptr && lane == 0)
        lse[static_cast<long long>(bh) * S + qpos] = m[i] + logf(l_row);
    }
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           const Strides* st, int B, int H, int KV, int S, int causal,
           int window, float sm_scale, cudaStream_t stream) {
  constexpr int kSmem = smem_floats<HD>() * sizeof(float);
  // above 48 KB of dynamic shared memory needs the attribute, which is per
  // device: set it before every launch (a host call, 28 per prefill)
  const cudaError_t err = cudaFuncSetAttribute(
      flash_simt_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (S + kBlockQ - 1) / kBlockQ);
  flash_simt_kernel<HD><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, st[0],
      st[1], st[2], st[3], H, KV, S, causal, window, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace simt

// ------------------------------------------------------------------------
// bfloat16: wgmma and TMA
// ------------------------------------------------------------------------
namespace wg {

using namespace hopper;

constexpr int kBM = 64;                    // query rows per block: one m64
constexpr int kBN = 64;                    // keys per K/V tile
constexpr int kStages = 2;                 // K tiles, and V tiles, in flight
constexpr int kConsumerWarps = 4;          // one warpgroup
constexpr int kThreads = 32 * kConsumerWarps + 32;   // + the producer warp

// shared-memory layout, in bytes from a 1024-aligned base; tiles whole
// panels wide (padded_hd)
template <int HD>
struct Layout {
  static constexpr int kQ = kBM * padded_hd(HD) * 2;     // Q, later O
  static constexpr int kTile = kBN * padded_hd(HD) * 2;  // one K or V tile
  static constexpr int kK = kQ;                      // K ring
  static constexpr int kV = kK + kStages * kTile;    // V ring
  static constexpr int kBar = kV + kStages * kTile;  // mbarriers
  // q_full, then per stage k_full, k_empty, v_full and v_empty
  static constexpr int kBytes = kBar + 8 * (1 + 4 * kStages);
  static constexpr int kAlloc = kBytes + 1024;       // room to align the base
};

// One tile's scores, in place, to unnormalised probabilities in log2 units:
// masks (where a key of the tile may be hidden from a row of the
// warpgroup, or lie past S), the new row max m, the factor alpha that
// rescales what was summed under the old max, and l, this lane's part of
// the row sums. Rows: `row` and row + 8; keys from k0.
__device__ __forceinline__ void online_softmax(
    float (&sc)[kBN / 2], float (&m)[2], float (&l)[2], float (&alpha)[2],
    int k0, int row, int r0, int lane, int S, int causal, int window,
    float scale_log2) {
  const bool masked = k0 + kBN > S || (causal && k0 + kBN - 1 > r0) ||
                      (window > 0 && k0 <= r0 + 63 - window);
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) {
    sc[i] *= scale_log2;
    if (masked) {
      const int qpos = row + 8 * ((i / 2) % 2);
      const int kpos = k0 + 8 * (i / 4) + 2 * (lane % 4) + i % 2;
      const bool ok = kpos < S && (!causal || kpos <= qpos) &&
                      (window <= 0 || kpos > qpos - window);
      if (!ok) sc[i] = -INFINITY;
    }
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i)
    mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {   // the 4 lanes of a row: one quad
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    alpha[r] = exp2f(m[r] - mx[r]);
    m[r] = mx[r];
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) {
    sc[i] = exp2f(sc[i] - mx[(i / 2) % 2]);   // masked: exp2(-inf) = 0
    l[(i / 2) % 2] += sc[i];
  }
}

// Fragment layouts (PTX ISA, wgmma m64nNk16): in a consumer warpgroup, warp
// w holds rows 16w + lane/4 and 16w + lane/4 + 8 of its 64; accumulator
// register i is at row + 8 * ((i / 2) % 2), column 8 * (i / 4) + 2 * (lane
// % 4) + i % 2. The bf16 A fragment of k-step kk (columns 16kk..16kk+15) is
// {i, i + 1} packed for i = 8kk, 8kk + 2, 8kk + 4, 8kk + 6: the S fragment
// itself, so P needs no shuffle.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap to,
                       float* __restrict__ lse, int H, int KV, int S,
                       int causal, int window, float scale_log2) {
  using L = Layout<HD>;
  constexpr int HDP = padded_hd(HD);         // O's and V's columns
  constexpr int kPanels = HDP / kPanel;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t sq = base, sk = base + L::kK, sv = base + L::kV;
  const uint32_t q_full = base + L::kBar;
  auto k_full = [&](int s) { return q_full + 8 * (1 + s); };
  auto k_empty = [&](int s) { return q_full + 8 * (1 + kStages + s); };
  auto v_full = [&](int s) { return q_full + 8 * (1 + 2 * kStages + s); };
  auto v_empty = [&](int s) { return q_full + 8 * (1 + 3 * kStages + s); };

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H, kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBM;   // longest rows first
  // the key tiles some row of the block can see: [t_lo, t_hi)
  const int t_lo = (window > 0 ? max(0, q0 - window + 1) : 0) / kBN;
  const int t_hi = ((causal ? min(S, q0 + kBM) : S) + kBN - 1) / kBN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      // an empty barrier takes lane 0 of each consumer warp
      mbar_init(k_empty(s), kConsumerWarps);
      mbar_init(v_empty(s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    // ---- producer: Q once, then K and V tiles through the ring ----
    if (lane == 0) {
      mbar_expect_tx(q_full, L::kQ);
      for (int p = 0; p < kPanels; ++p)
        tma_load(sq + p * kBM * kRowBytes, &tq, q_full, p * kPanel, q0, h, b);
      for (int it = 0; it < t_hi - t_lo; ++it) {
        const int k0 = (t_lo + it) * kBN;
        const int s = it % kStages;
        const uint32_t drained = ((it / kStages) & 1) ^ 1;
        mbar_wait(k_empty(s), drained);
        mbar_expect_tx(k_full(s), L::kTile);
        for (int p = 0; p < kPanels; ++p)
          tma_load(sk + s * L::kTile + p * kBN * kRowBytes, &tk, k_full(s),
                   p * kPanel, k0, kvh, b);
        mbar_wait(v_empty(s), drained);
        mbar_expect_tx(v_full(s), L::kTile);
        for (int p = 0; p < kPanels; ++p)
          tma_load(sv + s * L::kTile + p * kBN * kRowBytes, &tv, v_full(s),
                   p * kPanel, k0, kvh, b);
      }
    }
    return;
  }

  // ---- consumer: the warpgroup over query rows [q0, q0 + 64) ----
  const int row = q0 + 16 * warp + lane / 4;   // and row + 8
  // K and V tile t sit in stage (t - t_lo) % kStages of their rings,
  // filled for the ((t - t_lo) / kStages)-th time; lane 0 of each consumer
  // warp releases a stage after the warp's last read of it. K is released
  // as soon as its Q K^T is done, V after its P V, so the next K tile is
  // loaded a whole tile earlier.
  auto stage = [&](int t) { return (t - t_lo) % kStages; };
  auto parity = [&](int t) { return ((t - t_lo) / kStages) & 1; };
  auto wait_k = [&](int t) {
    mbar_wait(k_full(stage(t)), parity(t));
    __syncwarp();
  };
  auto wait_v = [&](int t) {
    mbar_wait(v_full(stage(t)), parity(t));
    __syncwarp();
  };
  auto release_k = [&](int t) {
    __syncwarp();
    if (lane == 0) mbar_arrive(k_empty(stage(t)));
  };
  auto release_v = [&](int t) {
    __syncwarp();
    if (lane == 0) mbar_arrive(v_empty(stage(t)));
  };

  float o[HDP / 2];
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, alpha[2];
  float sc[kBN / 2];
  uint32_t pa[kBN / 16][4];

  mbar_wait(q_full, 0);
  wait_k(t_lo);
  wgmma_fence();
  issue_abt<HD>(sc, sq, sk + stage(t_lo) * L::kTile);
  wgmma_wait<0>();
  fence_regs(sc);
  release_k(t_lo);
  online_softmax(sc, m, l, alpha, t_lo * kBN, row, q0, lane, S, causal,
                 window, scale_log2);
  to_a_fragments(sc, pa);
  // Tile t's Q K^T and tile t - 1's P V run on the tensor cores while the
  // softmax of tile t waits only for the first of them.
  for (int t = t_lo + 1; t < t_hi; ++t) {
    wait_k(t);
    wait_v(t - 1);
    wgmma_fence();
    issue_abt<HD>(sc, sq, sk + stage(t) * L::kTile);
    issue_pb<HDP>(o, pa, sv + stage(t - 1) * L::kTile);
    wgmma_wait<1>();                   // groups retire in order: S is done
    fence_regs(sc);
    release_k(t);
    online_softmax(sc, m, l, alpha, t * kBN, row, q0, lane, S, causal,
                   window, scale_log2);
    wgmma_wait<0>();                   // O += P V of tile t - 1 is done
    fence_regs(o);
    fence_regs(pa);
    release_v(t - 1);
#pragma unroll
    for (int i = 0; i < HDP / 2; ++i) o[i] *= alpha[(i / 2) % 2];
    to_a_fragments(sc, pa);
  }
  wait_v(t_hi - 1);
  wgmma_fence();
  issue_pb<HDP>(o, pa, sv + stage(t_hi - 1) * L::kTile);
  wgmma_wait<0>();
  fence_regs(o);
  fence_regs(pa);

  // ---- epilogue: O / l in bf16 over the Q tile, then a TMA store ----
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / fmaxf(l[r], 1e-30f);
  }
  if (lse != nullptr && lane % 4 == 0) {
    // m and l are in log2 units: lse = (m + log2 l) ln 2
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = row + 8 * r;
      if (qpos < S)
        lse[static_cast<long long>(bh) * S + qpos] =
            (m[r] + log2f(l[r])) * 0.6931471805599453f;
    }
  }
  write_tile<HDP>(smem, o, inv, warp, lane);
  // the generic-proxy writes above, visible to the TMA store
  fence_async_smem();
  named_sync(1, 128);   // the consumer warps
  if (threadIdx.x == 0) {
    for (int p = 0; p < kPanels; ++p)
      tma_store(&to, sq + p * kBM * kRowBytes, p * kPanel, q0, h, b);
    tma_store_wait();
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           const Strides* st, int B, int H, int KV, int S, int causal,
           int window, float sm_scale, cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mo;
  int res = make_map(&mq, q, st[0], B, H, S, HD, kBM);
  if (res == 0) res = make_map(&mk, k, st[1], B, KV, S, HD, kBN);
  if (res == 0) res = make_map(&mv, v, st[2], B, KV, S, HD, kBN);
  if (res == 0) res = make_map(&mo, o, st[3], B, H, S, HD, 64);
  if (res != 0) return kTensorMapError + res;
  constexpr int kSmem = Layout<HD>::kAlloc;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (S + kBM - 1) / kBM);
  flash_wgmma_kernel<HD><<<grid, kThreads, kSmem, stream>>>(
      mq, mk, mv, mo, lse, H, KV, S, causal, window,
      sm_scale * 1.4426950408889634f);   // exp(x) = exp2(x log2(e))
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

}  // namespace

// dtype: 0 = float32 (the SIMT kernel), 1 = bfloat16 (the wgmma kernel); q,
// k, v and o all of it; hd 64, 112 or 128, and 224 in bfloat16. `sm_scale`
// multiplies the scores (1/sqrt(hd), or Zamba2's (hd / 2)^-0.5). `strides` holds 12 element strides,
// (batch, head, row) of q, k, v and o in turn; hd's stride is 1. Every
// pointer and every stride is a multiple of 16 bytes; row strides fit in
// int32. lse, when not null, receives each row's log-sum-exp, (B, H, S)
// fp32 contiguous. Returns
// cudaGetLastError() after the launch (0 on success), or, where a tensor
// map is refused, 10000 + its CUresult; the launch runs on `stream`
// and does not sync.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, void* lse_out,
                                   int B, int H,
                                   int KV, int S, int hd,
                                   const long long* strides, int causal,
                                   int window, float sm_scale, int dtype,
                                   void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lse = static_cast<float*>(lse_out);
  if (B <= 0 || S <= 0 || KV <= 0 || H % KV != 0 ||
      (S + simt::kBlockQ - 1) / simt::kBlockQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Strides st[4];
  for (int i = 0; i < 4; ++i) {
    st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
    if (st[i].s > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 0 && hd == 64)
    return simt::launch<64>(q, k, v, o, lse, st, B, H, KV, S, causal, window,
                            sm_scale, s);
  if (dtype == 0 && hd == 112)
    return simt::launch<112>(q, k, v, o, lse, st, B, H, KV, S, causal, window,
                             sm_scale, s);
  if (dtype == 0 && hd == 128)
    return simt::launch<128>(q, k, v, o, lse, st, B, H, KV, S, causal, window,
                             sm_scale, s);
  if (dtype == 1 && hd == 64)
    return wg::launch<64>(q, k, v, o, lse, st, B, H, KV, S, causal, window,
                              sm_scale, s);
  if (dtype == 1 && hd == 112)
    return wg::launch<112>(q, k, v, o, lse, st, B, H, KV, S, causal, window,
                           sm_scale, s);
  if (dtype == 1 && hd == 128)
    return wg::launch<128>(q, k, v, o, lse, st, B, H, KV, S, causal, window,
                               sm_scale, s);
  if (dtype == 1 && hd == 224)
    return wg::launch<224>(q, k, v, o, lse, st, B, H, KV, S, causal, window,
                           sm_scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
