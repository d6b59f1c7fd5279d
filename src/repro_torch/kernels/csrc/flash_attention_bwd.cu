// The backward of flash_attention.cu's forward, for Hopper (sm_90a): from
// q (B, H, S, hd), k and v (B, KV, S, hd), the output o, its upstream
// gradient dO and the forward's row log-sum-exp lse (B, H, S) fp32, it
// writes dq, dk and dv in q's type. Every tensor is a view with its own
// batch, head and row strides (in elements) and a unit stride on hd, so the
// model's (B, S, H, hd) tensors are read, and its gradients written, where
// they lie.
//
// The Pallas TPU kernel src/repro/kernels/flash_attention.py::_flash_kernel
// has no backward (the JAX package differentiates its jnp gqa_attention);
// this one keeps the forward's rules: scale 1/sqrt(hd), key j visible to
// query i when j <= i (causal) and j > i - window (when window > 0), ragged
// S masked, and tiles that no pair of theirs can see never visited.
//
// FA2's scheme, in three kernels, with P = exp(S - lse) recomputed from the
// scores (nothing of size S x S is stored):
//   1. D = rowsum(dO o): flash_bwd_delta_kernel (fp32, one warp a row) or
//      flash_bwd_prep_kernel (bf16, 16-byte packs, which also writes the
//      lse in log2 units on rows padded to whole tiles).
//   2. dK/dV: one block per (batch, KV head, tile of 64 keys). It holds its
//      K and V tile and visits, for each of the G = H / KV query heads of
//      its group, the query tiles that can see a key of the tile: S = Q K^T,
//      P, dP = dO V^T, dS = P (dP - D); dV += P^T dO and dK += dS^T Q stay in
//      registers across the whole loop, so the group's sum needs no atomics
//      and dk, dv are written once.
//   3. dQ: one block per (batch, head, tile of 64 query rows), over the
//      visible key tiles: dQ += dS K. dQ is not summed with float atomics
//      (as FlashAttention-3 does) but recomputed here, so that every sum is
//      taken in one fixed order and two launches give the same bits.
//
// What bounds it: at the training path's (4, 24, 8, 512, 128) bf16 causal,
// the five products over the visible pairs are about 16.1 GFLOP (16 us on
// the bf16 tensor cores) and q, o, dO, dq, k, v, dk, dv about 67 MB (20 us
// at 3.35 TB/s): bytes bound it, by a little. Two designs, one per type:
//
// * bfloat16: wgmma fed by TMA, warp-specialised (namespace wg;
//   flash_bwd_dkdv_wgmma_kernel, flash_bwd_dq_wgmma_kernel). A block is
//   three warpgroups: warpgroup 0 produces (setmaxnreg down to 24 registers;
//   one thread issues every copy), warpgroups 1 and 2 consume (setmaxnreg
//   up to 240: at hd 128 the dK and dV sums alone are 128 fp32 registers a
//   thread). The producer loads the block's two fixed tiles once (dK/dV: K,
//   V; dQ: Q, dO) and keeps the streamed tiles (dK/dV: Q, dO and the 64
//   rows' lse and D; dQ: K, V) in flight through a ring of 4 stages, each
//   with a full and an empty mbarrier. Tiles land by TMA with the 128-byte
//   swizzle (hopper.cuh), the strided views' addressing done by the tensor
//   maps, rows past S zero-filled; lse (in log2 units) and D come by plain
//   bulk copies from rows padded to a multiple of 64 (the delta kernel
//   writes them so). The two score-like products (dK/dV: S^T = K Q^T and
//   dP^T = V dO^T; dQ: S = Q K^T and dP = dO V^T) are m64n64k16 wgmmas with
//   both operands K-major in shared memory; P and dS are rounded to bf16 in
//   registers, where the accumulator fragment of a 64 x 64 result is, pair
//   for pair, the A fragment of the next wgmma, so dV += P^T dO, dK += dS^T
//   Q and dQ += dS K are m64n{hd}k16 wgmmas with A from registers and B
//   (dO, Q or K, lying [row][hd]) read MN-major. dV's product runs while dS
//   is computed.
//   Grid fill: the two consumers of a block share its tile and split its
//   items (dK/dV: (query head, query tile) pairs; dQ: key tiles) even and
//   odd, each into its own fp32 sums; consumer 1 hands its sums to consumer
//   0 through shared memory, which adds them in that one order. So at the
//   LiteModel's (4, 4, 4, 512, 64), whose 64-row tiles give 128 blocks for
//   132 SMs, every block is on an SM of its own with two warpgroups on its
//   triangle of work, and the longest causal chain (key tile 0 and its 8
//   query tiles; query tile 7 and its 8 key tiles) takes 4 items per
//   warpgroup, not 8. Where a dQ grid has two blocks an SM or more (the
//   local model's 768), its blocks are short, and a block alone on its SM
//   would leave it idle through its prologue and epilogue: there dQ runs
//   with one consumer warpgroup and a producer warp (160 threads, a ring of
//   2 stages, 98,344 bytes and 157 registers at hd 128, 126 at hd 64, no
//   setmaxnreg), two blocks an SM. dK/dV blocks run key tile 0 first and dQ blocks query
//   tile S/64 - 1 first: the longest causal extents start first and the
//   short ones fill the last wave.
//   Shared memory (one block an SM): 1024 (alignment) + 2 fixed tiles + 4
//   stages of 2 tiles + 4 x 512 bytes of lse and D + 72 of barriers =
//   166,984 bytes at hd 128, 85,064 at hd 64. Registers (ptxas of CUDA
//   12.8): 168 a thread at launch for the three-warpgroup kernels (384
//   threads, one block an SM), no spills; setmaxnreg then moves them to
//   the consumers.
//   Measured (chip_smoke.py; NVIDIA H100 80GB HBM3, 700.00 W): 0.0921 ms
//   at the training path's (4, 24, 8, 512, 128), 4.6x its 0.0201 ms bound
//   (the D pass 0.011, dK/dV 0.039, dQ 0.038), against SDPA's backward at
//   0.1238 ms and the mma.sync design's 0.2654; 0.0253 ms at the
//   LiteModel's (4, 4, 4, 512, 64), against 0.0295 and 0.1051.
//   hd 112 (zamba2-7b's shared block) runs on hd 128's tiles, as the
//   forward does (hopper.cuh): the tensor maps carry the true hd, so TMA
//   zero-fills columns 112..127 of every tile's second panel and clips
//   them from the stores of dq, dk and dv. The four score-like products
//   contract over hd in 7 k-steps and never read the pad; dV, dK and dQ
//   run at n128, their pad columns products of zero columns. The prep
//   kernel gives a row 16 lanes, of which lanes 14 and 15 load nothing.
// * float32: SIMT (flash_bwd_dkdv_kernel, flash_bwd_dq_kernel), since the
//   tensor cores would take fp32 only as TF32; its floor is near 16.1 GFLOP
//   / 67 TFLOP/s = 0.24 ms. Tiles are staged as fp32 with rows padded to
//   hd + 1 floats, so that the 32 lanes reading 32 rows at one column hit
//   32 banks; each thread owns a 4 x 2 (S-like products) or 8 x
//   ceil(hd/32) (dK, dV, dQ) patch of outputs in registers, the columns
//   past hd (at hd 112, lanes 16..31 of the fourth) idle and never stored.
//   Shared memory at hd 128: 107,648 bytes (dK/dV) and 108,032 (dQ), two
//   blocks per SM.

#include "hopper.cuh"

#include <math.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// dK/dV kernel: keys per block, query rows per inner tile
constexpr int kKvBK = 64;
constexpr int kKvBQ = 32;
// dQ kernel: query rows per block, keys per inner tile
constexpr int kQBQ = 64;
constexpr int kQBK = 32;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// a lane's output columns: lane + 32 c for c < lane_cols(hd)
__host__ __device__ constexpr int lane_cols(int hd) {
  return (hd + 31) / 32;
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }

template <int HD>
constexpr int dkdv_smem_floats() {
  return 2 * kKvBK * (HD + 1) + 2 * kKvBQ * (HD + 1) +
         kKvBQ * (kKvBK + 1) + 2 * kKvBQ;
}
template <int HD>
constexpr int dq_smem_floats() {
  return 2 * kQBQ * (HD + 1) + 2 * kQBK * (HD + 1) + kQBQ * (kQBK + 1) +
         2 * kQBQ;
}

// Rows [row0, row0 + NROWS) of an (S, HD) matrix whose rows lie `rs`
// elements apart into shared memory as fp32, LD floats apart; rows at or
// past S become zeros.
template <typename T, int HD, int NROWS, int LD>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          long long rs, int row0, int S) {
  constexpr int kPerRow = HD / 4;
  for (int idx = threadIdx.x; idx < NROWS * kPerRow; idx += kThreads) {
    const int r = idx / kPerRow, c = (idx % kPerRow) * 4;
    float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < S) f = load4(src + (row0 + r) * rs + c);
    float* d = dst + r * LD + c;
    d[0] = f.x;
    d[1] = f.y;
    d[2] = f.z;
    d[3] = f.w;
  }
}

// out[a][b] = sum_d A[warp + 8a][d] B[lane + 32b][d]: an (MA x MB) tile of
// row-by-row dot products, A and B rows LD floats apart in shared memory
template <int HD, int MA, int MB, int LD>
__device__ __forceinline__ void dot_rows(float (&out)[MA / 8][MB / 32],
                                         const float* A, const float* Bm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int a = 0; a < MA / 8; ++a)
#pragma unroll
    for (int b = 0; b < MB / 32; ++b) out[a][b] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float av[MA / 8], bv[MB / 32];
#pragma unroll
    for (int a = 0; a < MA / 8; ++a) av[a] = A[(warp + 8 * a) * LD + d];
#pragma unroll
    for (int b = 0; b < MB / 32; ++b) bv[b] = Bm[(lane + 32 * b) * LD + d];
#pragma unroll
    for (int a = 0; a < MA / 8; ++a)
#pragma unroll
      for (int b = 0; b < MB / 32; ++b)
        out[a][b] = fmaf(av[a], bv[b], out[a][b]);
  }
}

// acc[r][c] += sum_k C(k, warp + 8r) X[k][lane + 32c] over k < NK, with
// C(k, row) = C[k][row] (TRANS) or C[row][k], LDC floats a row; X rows LDX
// floats apart, HD columns (a column past HD adds zeros)
template <int NR, int HD, int NK, int LDC, int LDX, bool TRANS>
__device__ __forceinline__ void acc_product(
    float (&acc)[NR / 8][lane_cols(HD)], const float* C, const float* X) {
  constexpr int kC = lane_cols(HD);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll 2
  for (int k = 0; k < NK; ++k) {
    float cv[NR / 8], xv[kC];
#pragma unroll
    for (int r = 0; r < NR / 8; ++r) {
      const int row = warp + 8 * r;
      cv[r] = TRANS ? C[k * LDC + row] : C[row * LDC + k];
    }
#pragma unroll
    for (int c = 0; c < kC; ++c)
      xv[c] = HD % 32 == 0 || lane + 32 * c < HD ? X[k * LDX + lane + 32 * c]
                                                 : 0.f;
#pragma unroll
    for (int r = 0; r < NR / 8; ++r)
#pragma unroll
      for (int c = 0; c < kC; ++c)
        acc[r][c] = fmaf(cv[r], xv[c], acc[r][c]);
  }
}

__device__ __forceinline__ bool visible(int i, int j, int S, int causal,
                                        int window) {
  return i < S && j < S && (!causal || j <= i) &&
         (window <= 0 || j > i - window);
}

// D[(b H + h) S + i] = sum_d dO[b, h, i, d] o[b, h, i, d]; one warp a row
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dO,
                           float* __restrict__ D, Strides so, Strides sdo,
                           int H, int S, long long rows) {
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const long long bh = row / S;
  const int i = static_cast<int>(row % S);
  const int b = static_cast<int>(bh / H), h = static_cast<int>(bh % H);
  const T* orow = o + b * so.b + h * so.h + i * so.s;
  const T* grow = dO + b * sdo.b + h * sdo.h + i * sdo.s;
  float s = 0.f;
  for (int c = lane * 4; c < HD; c += 128) {
    const float4 a = load4(orow + c), g = load4(grow + c);
    s += a.x * g.x + a.y * g.y + a.z * g.z + a.w * g.w;
  }
#pragma unroll
  for (int mask = 16; mask > 0; mask >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, mask);
  if (lane == 0) D[row] = s;
}

// the prep kernel's lanes a row: one 16-byte pack of o and of dO each, a
// power of two, so that a row's lanes reduce by shuffles within the row
__host__ __device__ constexpr int prep_lanes(int hd) {
  return hopper::padded_hd(hd) / 8;
}

// The bf16 kernels' D and lse in log2 units, for rows (b H + h) pitch + i:
// D = sum_d dO o and lse2 = lse log2(e) for i < S, 0 on the rows of [S,
// pitch), which the wgmma kernels copy 64 at a time. A row is
// prep_lanes(HD) lanes, each one 16-byte pack of o and of dO (at hd 112 the
// last two of 16 lanes load nothing); a warp holds 32 / prep_lanes(HD)
// rows.
template <int HD>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_prep_kernel(const __nv_bfloat16* __restrict__ o,
                          const __nv_bfloat16* __restrict__ dO,
                          const float* __restrict__ lse,
                          float* __restrict__ D, float* __restrict__ lse2,
                          Strides so, Strides sdo, int H, int S, int pitch,
                          long long rows) {
  constexpr int kLanes = prep_lanes(HD), kRowsPerWarp = 32 / kLanes;
  const int lane = threadIdx.x & 31, l = lane % kLanes;
  const long long row =
      (static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5)) *
          kRowsPerWarp + lane / kLanes;
  const long long bh = row / pitch;
  const int i = static_cast<int>(row % pitch);
  const bool live = row < rows && i < S;
  float s = 0.f;
  if (live && 8 * l < HD) {
    const int b = static_cast<int>(bh / H), h = static_cast<int>(bh % H);
    const uint4 a = *reinterpret_cast<const uint4*>(
        o + b * so.b + h * so.h + i * so.s + 8 * l);
    const uint4 g = *reinterpret_cast<const uint4*>(
        dO + b * sdo.b + h * sdo.h + i * sdo.s + 8 * l);
    const uint32_t av[4] = {a.x, a.y, a.z, a.w}, gv[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 af = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&av[j]));
      const float2 gf = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&gv[j]));
      s += af.x * gf.x + af.y * gf.y;
    }
  }
#pragma unroll
  for (int mask = kLanes / 2; mask > 0; mask >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, mask);
  if (row < rows && l == 0) {
    D[row] = live ? s : 0.f;
    lse2[row] = live ? lse[bh * S + i] * 1.4426950408889634f : 0.f;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 2)
    flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dO,
                          const float* __restrict__ lse,
                          const float* __restrict__ D, T* __restrict__ dk,
                          T* __restrict__ dv, Strides sq, Strides sk,
                          Strides sv, Strides sdo, Strides sdk, Strides sdv,
                          int H, int KV, int S, int causal, int window,
                          float sm_scale) {
  constexpr int LD = HD + 1, PLD = kKvBK + 1;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kKvBK * LD;
  float* Qs = Vs + kKvBK * LD;
  float* dOs = Qs + kKvBQ * LD;
  float* Ps = dOs + kKvBQ * LD;   // P, then dS, of one query tile
  float* ls = Ps + kKvBQ * PLD;
  float* Ds = ls + kKvBQ;

  const int b = blockIdx.x / KV, kvh = blockIdx.x % KV;
  const int k0 = blockIdx.y * kKvBK;   // the longest causal extents first
  const int G = H / KV;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  load_rows<T, HD, kKvBK, LD>(Ks, k + b * sk.b + kvh * sk.h, sk.s, k0, S);
  load_rows<T, HD, kKvBK, LD>(Vs, v + b * sv.b + kvh * sv.h, sv.s, k0, S);

  constexpr int kC = lane_cols(HD);
  float dk_acc[kKvBK / 8][kC], dv_acc[kKvBK / 8][kC];
#pragma unroll
  for (int r = 0; r < kKvBK / 8; ++r)
#pragma unroll
    for (int c = 0; c < kC; ++c) dk_acc[r][c] = dv_acc[r][c] = 0.f;

  // the query rows some key of the tile can see: [i_lo, i_hi)
  const int i_lo = causal ? k0 : 0;
  const int i_hi = window > 0 ? min(S, k0 + kKvBK - 1 + window) : S;
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const T* qb = q + b * sq.b + h * sq.h;
    const T* gb = dO + b * sdo.b + h * sdo.h;
    const float* lb = lse + (static_cast<long long>(b) * H + h) * S;
    const float* Db = D + (static_cast<long long>(b) * H + h) * S;
    for (int q0 = (i_lo / kKvBQ) * kKvBQ; q0 < i_hi; q0 += kKvBQ) {
      __syncthreads();   // the last tile's Q, dO and dS are read
      load_rows<T, HD, kKvBQ, LD>(Qs, qb, sq.s, q0, S);
      load_rows<T, HD, kKvBQ, LD>(dOs, gb, sdo.s, q0, S);
      if (threadIdx.x < kKvBQ) {
        const int i = q0 + threadIdx.x;
        ls[threadIdx.x] = i < S ? lb[i] : 0.f;
        Ds[threadIdx.x] = i < S ? Db[i] : 0.f;
      }
      __syncthreads();
      float p[kKvBQ / 8][kKvBK / 32], ds[kKvBQ / 8][kKvBK / 32];
      dot_rows<HD, kKvBQ, kKvBK, LD>(p, Qs, Ks);
      dot_rows<HD, kKvBQ, kKvBK, LD>(ds, dOs, Vs);
#pragma unroll
      for (int a = 0; a < kKvBQ / 8; ++a) {
        const int r = warp + 8 * a;
#pragma unroll
        for (int c = 0; c < kKvBK / 32; ++c) {
          const int jj = lane + 32 * c;
          const float pv = visible(q0 + r, k0 + jj, S, causal, window)
                               ? expf(p[a][c] * sm_scale - ls[r])
                               : 0.f;
          p[a][c] = pv;
          ds[a][c] = pv * (ds[a][c] - Ds[r]);
          Ps[r * PLD + jj] = pv;
        }
      }
      __syncthreads();
      // dV[j][:] += sum_i P[i][j] dO[i][:]
      acc_product<kKvBK, HD, kKvBQ, PLD, LD, true>(dv_acc, Ps, dOs);
      __syncthreads();
#pragma unroll
      for (int a = 0; a < kKvBQ / 8; ++a)
#pragma unroll
        for (int c = 0; c < kKvBK / 32; ++c)
          Ps[(warp + 8 * a) * PLD + lane + 32 * c] = ds[a][c];
      __syncthreads();
      // dK[j][:] += sum_i dS[i][j] Q[i][:]
      acc_product<kKvBK, HD, kKvBQ, PLD, LD, true>(dk_acc, Ps, Qs);
    }
  }
  T* dkb = dk + b * sdk.b + kvh * sdk.h;
  T* dvb = dv + b * sdv.b + kvh * sdv.h;
#pragma unroll
  for (int r = 0; r < kKvBK / 8; ++r) {
    const int j = k0 + warp + 8 * r;
    if (j < S) {
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        if (HD % 32 != 0 && lane + 32 * c >= HD) break;
        dkb[j * sdk.s + lane + 32 * c] = from_f32<T>(dk_acc[r][c] * sm_scale);
        dvb[j * sdv.s + lane + 32 * c] = from_f32<T>(dv_acc[r][c]);
      }
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 2)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dO,
                        const float* __restrict__ lse,
                        const float* __restrict__ D, T* __restrict__ dq,
                        Strides sq, Strides sk, Strides sv, Strides sdo,
                        Strides sdq, int H, int KV, int S, int causal,
                        int window, float sm_scale) {
  constexpr int LD = HD + 1, SLD = kQBK + 1;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + kQBQ * LD;
  float* Ks = dOs + kQBQ * LD;
  float* Vs = Ks + kQBK * LD;
  float* dSs = Vs + kQBK * LD;
  float* ls = dSs + kQBQ * SLD;
  float* Ds = ls + kQBQ;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H, kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kQBQ;   // longest rows first
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  load_rows<T, HD, kQBQ, LD>(Qs, q + b * sq.b + h * sq.h, sq.s, q0, S);
  load_rows<T, HD, kQBQ, LD>(dOs, dO + b * sdo.b + h * sdo.h, sdo.s, q0, S);
  if (threadIdx.x < kQBQ) {
    const int i = q0 + threadIdx.x;
    ls[threadIdx.x] = i < S ? lse[static_cast<long long>(bh) * S + i] : 0.f;
    Ds[threadIdx.x] = i < S ? D[static_cast<long long>(bh) * S + i] : 0.f;
  }
  const T* kb = k + b * sk.b + kvh * sk.h;
  const T* vb = v + b * sv.b + kvh * sv.h;

  constexpr int kC = lane_cols(HD);
  float dq_acc[kQBQ / 8][kC];
#pragma unroll
  for (int r = 0; r < kQBQ / 8; ++r)
#pragma unroll
    for (int c = 0; c < kC; ++c) dq_acc[r][c] = 0.f;

  // the keys some row of this tile can see: [k_begin, k_end)
  const int k_end = causal ? min(S, q0 + kQBQ) : S;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  for (int k0 = (k_begin / kQBK) * kQBK; k0 < k_end; k0 += kQBK) {
    __syncthreads();   // the last tile's K and dS are read (Q, dO loaded)
    load_rows<T, HD, kQBK, LD>(Ks, kb, sk.s, k0, S);
    load_rows<T, HD, kQBK, LD>(Vs, vb, sv.s, k0, S);
    __syncthreads();
    float p[kQBQ / 8][kQBK / 32], ds[kQBQ / 8][kQBK / 32];
    dot_rows<HD, kQBQ, kQBK, LD>(p, Qs, Ks);
    dot_rows<HD, kQBQ, kQBK, LD>(ds, dOs, Vs);
#pragma unroll
    for (int a = 0; a < kQBQ / 8; ++a) {
      const int r = warp + 8 * a;
#pragma unroll
      for (int c = 0; c < kQBK / 32; ++c) {
        const int jj = lane + 32 * c;
        const float pv = visible(q0 + r, k0 + jj, S, causal, window)
                             ? expf(p[a][c] * sm_scale - ls[r])
                             : 0.f;
        dSs[r * SLD + jj] = pv * (ds[a][c] - Ds[r]);
      }
    }
    __syncthreads();
    // dQ[i][:] += sum_j dS[i][j] K[j][:]
    acc_product<kQBQ, HD, kQBK, SLD, LD, false>(dq_acc, dSs, Ks);
  }
  T* dqb = dq + b * sdq.b + h * sdq.h;
#pragma unroll
  for (int r = 0; r < kQBQ / 8; ++r) {
    const int i = q0 + warp + 8 * r;
    if (i < S) {
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        if (HD % 32 != 0 && lane + 32 * c >= HD) break;
        dqb[i * sdq.s + lane + 32 * c] = from_f32<T>(dq_acc[r][c] * sm_scale);
      }
    }
  }
}

// ------------------------------------------------------------------------
// bfloat16: wgmma fed by TMA, one producer and two consumer warpgroups
// ------------------------------------------------------------------------
namespace wg {

using namespace hopper;

constexpr int kStages = 4;             // ring stages of streamed tiles
constexpr int kConsumers = 2;          // consumer warpgroups a block
constexpr int kThreads = 128 * (1 + kConsumers);   // warpgroup 0 produces
// registers a thread after setmaxnreg: 128 x 24 + 256 x 240 <= 65,536
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

// shared-memory layout, in bytes from a 1024-aligned base; tiles whole
// panels wide (padded_hd)
template <int HD, int STAGES = kStages>
struct Layout {
  static constexpr int kTile = kTileRows * padded_hd(HD) * 2;  // a bf16 tile
  // two fixed tiles (dK/dV: K, V; dQ: Q, dO), then the ring, whose stage s
  // holds two streamed tiles (dK/dV: Q, dO; dQ: K, V)
  static constexpr int kRing = 2 * kTile;
  static constexpr int kStage = 2 * kTile;
  // dK/dV: per stage the lse2 and D of its 64 query rows
  static constexpr int kRows = kRing + STAGES * kStage;
  static constexpr int kRowBytesF = kTileRows * 4;
  static constexpr int kBar = kRows + STAGES * 2 * kRowBytesF;
  // fixed_full, then per stage full and empty
  static constexpr int kBytes = kBar + 8 * (1 + 2 * STAGES);
  static constexpr int kAlloc = kBytes + 1024;         // room to align the base
};

// a 64-row tile of a (B, N, S, hd) map at (row, head, batch), panel by
// panel (columns past hd zero-filled)
template <int HD>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int row, int head,
                                          int batch) {
#pragma unroll
  for (int p = 0; p < padded_hd(HD) / kPanel; ++p)
    tma_load(dst + p * kTileRows * kRowBytes, map, bar, p * kPanel, row, head,
             batch);
}

// and back (columns past hd clipped)
template <int HD>
__device__ __forceinline__ void store_tile(const CUtensorMap* map,
                                           uint32_t src, int row, int head,
                                           int batch) {
#pragma unroll
  for (int p = 0; p < padded_hd(HD) / kPanel; ++p)
    tma_store(map, src + p * kTileRows * kRowBytes, p * kPanel, row, head,
              batch);
}

// whether a (64 query rows from q0) x (64 keys from k0) tile holds a pair
// that the masks hide or that lies past S
__device__ __forceinline__ bool tile_masked(int q0, int k0, int S, int causal,
                                            int window) {
  return q0 + kTileRows > S || k0 + kTileRows > S ||
         (causal && k0 + kTileRows - 1 > q0) ||
         (window > 0 && k0 <= q0 + kTileRows - 1 - window);
}

// The 1024-aligned base of the dynamic shared memory, as a pointer and a
// shared-space address; thread 0 initialises the barriers at `bar`:
// fixed_full, then per stage full (the producer's arrival with its bytes)
// and empty (lane 0 of each warp of the consuming warpgroup).
template <int STAGES>
__device__ __forceinline__ uint32_t setup(uint8_t* raw_ptr, uint8_t*& smem,
                                          int bar_offset) {
  const uint32_t raw = smem_u32(raw_ptr);
  const uint32_t base = (raw + 1023u) & ~1023u;
  smem = raw_ptr + (base - raw);
  if (threadIdx.x == 0) {
    const uint32_t bar = base + bar_offset;
    mbar_init(bar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar + 8 * (1 + s), 1);
      mbar_init(bar + 8 * (1 + STAGES + s), 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  return base;
}

template <int N>
__device__ __forceinline__ void put_partial(const float (&a)[N], float* red,
                                            int tid) {
#pragma unroll
  for (int i = 0; i < N; ++i) red[i * 128 + tid] = a[i];
}
template <int N>
__device__ __forceinline__ void add_partial(float (&a)[N], const float* red,
                                            int tid) {
#pragma unroll
  for (int i = 0; i < N; ++i) a[i] += red[i * 128 + tid];
}

// dK/dV: one block per (batch, KV head, 64 keys); key tile 0, the longest
// causal extent, first. The producer loads K and V once, then streams the
// items (query head g of the group, query tile qt) that can see a key of
// the tile: Q, dO and their rows' lse2 and D, item `it` into stage it %
// kStages. Consumer c takes items c, c + 2, ... and for each computes S^T =
// K Q^T and dP^T = V dO^T (both operands K-major in shared memory), P^T =
// exp2(S^T scale log2(e) - lse2) and dS^T = P^T (dP^T - D) in registers,
// then dV += P^T dO and dK += dS^T Q with P^T, dS^T as bf16 register A
// operands and dO, Q read MN-major. Consumer 1's dK, dV partial sums go
// through shared memory to consumer 0, which adds them to its own (one
// fixed order) and stores dk, dv by TMA.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                                const __grid_constant__ CUtensorMap tk,
                                const __grid_constant__ CUtensorMap tv,
                                const __grid_constant__ CUtensorMap tdo,
                                const __grid_constant__ CUtensorMap tdk,
                                const __grid_constant__ CUtensorMap tdv,
                                const float* __restrict__ lse2,
                                const float* __restrict__ D, int H, int KV,
                                int S, int pitch, int causal, int window,
                                float scale_log2, float sm_scale) {
  using L = Layout<HD>;
  constexpr int HDP = padded_hd(HD);   // the dK and dV accumulators' columns
  static_assert(kStages * L::kStage >= 2 * kTileRows * HDP * 4,
                "consumer 1's dK and dV sums fit the ring");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem;
  const uint32_t base = setup<kStages>(smem_raw, smem, L::kBar);
  const uint32_t sk = base, sv = base + L::kTile;
  const uint32_t fixed_full = base + L::kBar;
  auto full = [&](int s) { return fixed_full + 8 * (1 + s); };
  auto empty = [&](int s) { return fixed_full + 8 * (1 + kStages + s); };

  const int b = blockIdx.x / KV, kvh = blockIdx.x % KV, G = H / KV;
  const int k0 = blockIdx.y * kTileRows;
  // the query tiles some key of the tile can see, for each head of the
  // group: [qt_lo, qt_lo + nq); item it = (it / nq, qt_lo + it % nq)
  const int qt_lo = causal ? static_cast<int>(blockIdx.y) : 0;
  const int i_hi = window > 0 ? min(S, k0 + kTileRows - 1 + window) : S;
  const int nq = (i_hi + kTileRows - 1) / kTileRows - qt_lo;
  const int n_items = G * nq;

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread issues every copy ----
    regs_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(fixed_full, 2 * L::kTile);
      load_tile<HD>(sk, &tk, fixed_full, k0, kvh, b);
      load_tile<HD>(sv, &tv, fixed_full, k0, kvh, b);
      for (int it = 0; it < n_items; ++it) {
        const int s = it % kStages;
        const int h = kvh * G + it / nq, q0 = (qt_lo + it % nq) * kTileRows;
        const uint32_t sq = base + L::kRing + s * L::kStage;
        const uint32_t rows = base + L::kRows + s * 2 * L::kRowBytesF;
        const long long r0 = static_cast<long long>(b * H + h) * pitch + q0;
        mbar_wait(empty(s), ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * L::kTile + 2 * L::kRowBytesF);
        load_tile<HD>(sq, &tq, full(s), q0, h, b);
        load_tile<HD>(sq + L::kTile, &tdo, full(s), q0, h, b);
        bulk_load(rows, lse2 + r0, L::kRowBytesF, full(s));
        bulk_load(rows + L::kRowBytesF, D + r0, L::kRowBytesF, full(s));
      }
    }
    return;
  }

  // ---- consumer warpgroup c over the tile's 64 keys ----
  regs_inc<kConsumerRegs>();
  const int c = threadIdx.x / 128 - 1, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int key = k0 + 16 * warp + lane / 4;   // and key + 8
  float dv[HDP / 2], dk[HDP / 2];
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) dv[i] = dk[i] = 0.f;
  float st[kTileRows / 2], dpt[kTileRows / 2];
  uint32_t pa[kTileRows / 16][4], da[kTileRows / 16][4];

  mbar_wait(fixed_full, 0);
  for (int it = c; it < n_items; it += kConsumers) {
    const int s = it % kStages;
    const int q0 = (qt_lo + it % nq) * kTileRows;
    const uint32_t sq = base + L::kRing + s * L::kStage, sdo = sq + L::kTile;
    const float* lrow = reinterpret_cast<const float*>(
        smem + L::kRows + s * 2 * L::kRowBytesF);
    const float* drow = lrow + kTileRows;
    mbar_wait(full(s), (it / kStages) & 1);
    __syncwarp();
    wgmma_fence();
    issue_abt<HD>(st, sk, sq);      // S^T = K Q^T
    issue_abt<HD>(dpt, sv, sdo);    // dP^T = V dO^T
    fence_regs(dpt);
    wgmma_wait<1>();                // groups retire in order: S^T is done
    fence_regs(st);
    // P^T: register r is key `key` + 8 ((r / 2) % 2), query q0 + col(r)
    const bool masked = tile_masked(q0, k0, S, causal, window);
#pragma unroll
    for (int r = 0; r < kTileRows / 2; r += 2) {
      const int col = 8 * (r / 4) + 2 * (lane % 4);
      const int j = key + 8 * ((r / 2) % 2);
      const float2 l2 = *reinterpret_cast<const float2*>(lrow + col);
      float p0 = exp2f(st[r] * scale_log2 - l2.x);
      float p1 = exp2f(st[r + 1] * scale_log2 - l2.y);
      if (masked) {
        if (!visible(q0 + col, j, S, causal, window)) p0 = 0.f;
        if (!visible(q0 + col + 1, j, S, causal, window)) p1 = 0.f;
      }
      st[r] = p0;
      st[r + 1] = p1;
    }
    to_a_fragments(st, pa);
    wgmma_fence();
    issue_pb<HDP>(dv, pa, sdo);     // dV += P^T dO
    fence_regs(dv);
    wgmma_wait<1>();                // dP^T is done
    fence_regs(dpt);
#pragma unroll
    for (int r = 0; r < kTileRows / 2; r += 2) {
      const int col = 8 * (r / 4) + 2 * (lane % 4);
      const float2 d2 = *reinterpret_cast<const float2*>(drow + col);
      dpt[r] = st[r] * (dpt[r] - d2.x);
      dpt[r + 1] = st[r + 1] * (dpt[r + 1] - d2.y);
    }
    to_a_fragments(dpt, da);
    wgmma_fence();
    issue_pb<HDP>(dk, da, sq);      // dK += dS^T Q
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    fence_regs(pa);
    fence_regs(da);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));
  }

  // ---- epilogue: consumer 0 adds consumer 1's sums, then TMA stores ----
  named_sync(1, 128 * kConsumers);   // both are done with the ring
  float* red = reinterpret_cast<float*>(smem + L::kRing);
  if (c == 1) {
    put_partial(dv, red, tid);
    put_partial(dk, red + (HDP / 2) * 128, tid);
  }
  named_sync(1, 128 * kConsumers);
  if (c == 1) return;
  add_partial(dv, red, tid);
  add_partial(dk, red + (HDP / 2) * 128, tid);
  const float one[2] = {1.f, 1.f}, scale[2] = {sm_scale, sm_scale};
  write_tile<HDP>(smem, dk, scale, warp, lane);            // over K
  write_tile<HDP>(smem + L::kTile, dv, one, warp, lane);   // over V
  fence_async_smem();
  named_sync(2, 128);
  if (tid == 0) {
    store_tile<HD>(&tdk, sk, k0, kvh, b);
    store_tile<HD>(&tdv, sv, k0, kvh, b);
    tma_store_wait();
  }
}

// dQ: one block per (batch, head, 64 query rows); the longest causal rows
// first. The producer loads Q and dO once, then streams the visible K and V
// tiles, tile kt_lo + it into stage it % STAGES. A consumer computes, for
// each tile it takes, S = Q K^T and dP = dO V^T (K-major in shared memory),
// P and dS = P (dP - D) in registers (its rows' lse2 and D held in
// registers), then dQ += dS K with dS a bf16 register A operand and K read
// MN-major. CONS = 2: warpgroup 0 produces and two consumers take tiles c,
// c + 2, ..., consumer 1's partial dQ going to consumer 0 through shared
// memory, as in dK/dV (one block an SM; for grids too small to fill the
// card). CONS = 1: warpgroup 0 consumes every tile and warp 4 produces,
// with a ring of 2 stages: 160 threads and 97 KB at hd 128, so that two
// blocks share an SM and one's prologue and epilogue overlap the other's
// products (for grids of two blocks an SM or more).
template <int HD, int CONS>
__global__ void __launch_bounds__(CONS == 2 ? kThreads : 160,
                                  CONS == 2 ? 1 : 2)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const __grid_constant__ CUtensorMap tdo,
                              const __grid_constant__ CUtensorMap tdq,
                              const float* __restrict__ lse2,
                              const float* __restrict__ D, int H, int KV,
                              int S, int pitch, int causal, int window,
                              float scale_log2, float sm_scale) {
  constexpr int kSt = CONS == 2 ? kStages : 2;
  using L = Layout<HD, kSt>;
  constexpr int HDP = padded_hd(HD);   // the dQ accumulator's columns
  static_assert(CONS == 1 || kSt * L::kStage >= kTileRows * HDP * 4,
                "consumer 1's dQ sums fit the ring");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem;
  const uint32_t base = setup<kSt>(smem_raw, smem, L::kBar);
  const uint32_t sq = base, sdo = base + L::kTile;
  const uint32_t fixed_full = base + L::kBar;
  auto full = [&](int s) { return fixed_full + 8 * (1 + s); };
  auto empty = [&](int s) { return fixed_full + 8 * (1 + kSt + s); };

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H, kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTileRows;
  // the key tiles some row of the tile can see: [kt_lo, kt_lo + n_items)
  const int kt_lo = (window > 0 ? max(0, q0 - window + 1) : 0) / kTileRows;
  const int k_end = causal ? min(S, q0 + kTileRows) : S;
  const int n_items = (k_end + kTileRows - 1) / kTileRows - kt_lo;

  const int producer = CONS == 2 ? 0 : 128;   // its first thread
  if (threadIdx.x >= producer && threadIdx.x < producer + (CONS == 2 ? 128 : 32)) {
    if constexpr (CONS == 2) regs_dec<kProducerRegs>();
    if (threadIdx.x == producer) {
      mbar_expect_tx(fixed_full, 2 * L::kTile);
      load_tile<HD>(sq, &tq, fixed_full, q0, h, b);
      load_tile<HD>(sdo, &tdo, fixed_full, q0, h, b);
      for (int it = 0; it < n_items; ++it) {
        const int s = it % kSt, k0 = (kt_lo + it) * kTileRows;
        const uint32_t sk = base + L::kRing + s * L::kStage;
        mbar_wait(empty(s), ((it / kSt) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * L::kTile);
        load_tile<HD>(sk, &tk, full(s), k0, kvh, b);
        load_tile<HD>(sk + L::kTile, &tv, full(s), k0, kvh, b);
      }
    }
    return;
  }

  if constexpr (CONS == 2) regs_inc<kConsumerRegs>();
  const int c = CONS == 2 ? threadIdx.x / 128 - 1 : 0;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int row = q0 + 16 * warp + lane / 4;   // and row + 8
  const long long r0 = static_cast<long long>(bh) * pitch + row;
  const float lr[2] = {lse2[r0], lse2[r0 + 8]};   // rows < pitch
  const float dr[2] = {D[r0], D[r0 + 8]};
  float dq[HDP / 2];
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) dq[i] = 0.f;
  float sc[kTileRows / 2], dp[kTileRows / 2];
  uint32_t da[kTileRows / 16][4];

  mbar_wait(fixed_full, 0);
  for (int it = c; it < n_items; it += CONS) {
    const int s = it % kSt, k0 = (kt_lo + it) * kTileRows;
    const uint32_t sk = base + L::kRing + s * L::kStage, sv = sk + L::kTile;
    mbar_wait(full(s), (it / kSt) & 1);
    __syncwarp();
    wgmma_fence();
    issue_abt<HD>(sc, sq, sk);      // S = Q K^T
    issue_abt<HD>(dp, sdo, sv);     // dP = dO V^T
    fence_regs(dp);
    wgmma_wait<1>();
    fence_regs(sc);
    const bool masked = tile_masked(q0, k0, S, causal, window);
#pragma unroll
    for (int r = 0; r < kTileRows / 2; ++r) {
      float p = exp2f(sc[r] * scale_log2 - lr[(r / 2) % 2]);
      if (masked && !visible(row + 8 * ((r / 2) % 2),
                             k0 + 8 * (r / 4) + 2 * (lane % 4) + r % 2, S,
                             causal, window))
        p = 0.f;
      sc[r] = p;
    }
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int r = 0; r < kTileRows / 2; ++r)
      dp[r] = sc[r] * (dp[r] - dr[(r / 2) % 2]);
    to_a_fragments(dp, da);
    wgmma_fence();
    issue_pb<HDP>(dq, da, sk);      // dQ += dS K
    wgmma_wait<0>();
    fence_regs(dq);
    fence_regs(da);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));
  }

  if constexpr (CONS == 2) {
    named_sync(1, 128 * CONS);
    float* red = reinterpret_cast<float*>(smem + L::kRing);
    if (c == 1) put_partial(dq, red, tid);
    named_sync(1, 128 * CONS);
    if (c == 1) return;
    add_partial(dq, red, tid);
  }
  const float scale[2] = {sm_scale, sm_scale};
  write_tile<HDP>(smem, dq, scale, warp, lane);   // over Q
  fence_async_smem();
  named_sync(2, 128);
  if (tid == 0) {
    store_tile<HD>(&tdq, sq, q0, h, b);
    tma_store_wait();
  }
}

// the two kernels after the delta kernel; D and lse2 as it wrote them
template <int HD>
int launch(const void* q, const void* k, const void* v, const void* dO,
           const float* lse2, const float* D, void* dq, void* dk, void* dv,
           const Strides* st, int B, int H, int KV, int S, int pitch,
           int causal, int window, float sm_scale, cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mdo, mdq, mdk, mdv;
  int res = make_map(&mq, q, st[0], B, H, S, HD, kTileRows);
  if (res == 0) res = make_map(&mk, k, st[1], B, KV, S, HD, kTileRows);
  if (res == 0) res = make_map(&mv, v, st[2], B, KV, S, HD, kTileRows);
  if (res == 0) res = make_map(&mdo, dO, st[4], B, H, S, HD, kTileRows);
  if (res == 0) res = make_map(&mdq, dq, st[5], B, H, S, HD, kTileRows);
  if (res == 0) res = make_map(&mdk, dk, st[6], B, KV, S, HD, kTileRows);
  if (res == 0) res = make_map(&mdv, dv, st[7], B, KV, S, HD, kTileRows);
  if (res != 0) return kTensorMapError + res;
  constexpr int kSmem = Layout<HD>::kAlloc;
  constexpr int kSmemDq1 = Layout<HD, 2>::kAlloc;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_wgmma_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_dq_wgmma_kernel<HD, 2>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_dq_wgmma_kernel<HD, 1>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemDq1);
  int device = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (S + kTileRows - 1) / kTileRows;
  const float scale_log2 = sm_scale * 1.4426950408889634f;
  flash_bwd_dkdv_wgmma_kernel<HD>
      <<<dim3(B * KV, tiles), kThreads, kSmem, stream>>>(
          mq, mk, mv, mdo, mdk, mdv, lse2, D, H, KV, S, pitch, causal,
          window, scale_log2, sm_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_q(B * H, tiles);
  if (B * H * tiles >= 2 * sms)   // two blocks an SM: one consumer each
    flash_bwd_dq_wgmma_kernel<HD, 1><<<grid_q, 160, kSmemDq1, stream>>>(
        mq, mk, mv, mdo, mdq, lse2, D, H, KV, S, pitch, causal, window,
        scale_log2, sm_scale);
  else
    flash_bwd_dq_wgmma_kernel<HD, 2><<<grid_q, kThreads, kSmem, stream>>>(
        mq, mk, mv, mdo, mdq, lse2, D, H, KV, S, pitch, causal, window,
        scale_log2, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

// D (and for bf16 lse2), then the type's dK/dV and dQ kernels. fp32: D is
// (B H, S); bf16: D and then lse2, each (B H, pitch) with pitch S rounded
// up to 64, so that the wgmma kernels copy whole 64-row slices of them.
template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dO, const float* lse, float* D, void* dq, void* dk,
           void* dv, const Strides* st, int B, int H, int KV, int S,
           int causal, int window, float sm_scale, cudaStream_t stream) {
  constexpr bool kBf16 = std::is_same_v<T, __nv_bfloat16>;
  const T* gt = static_cast<const T*>(dO);
  if constexpr (kBf16) {
    const int pitch = (S + hopper::kTileRows - 1) / hopper::kTileRows *
                      hopper::kTileRows;
    const long long rows = static_cast<long long>(B) * H * pitch;
    constexpr int kRowsPerBlock = kWarps * 32 / prep_lanes(HD);
    float* lse2 = D + rows;
    flash_bwd_prep_kernel<HD><<<static_cast<unsigned>(
                                    (rows + kRowsPerBlock - 1) /
                                    kRowsPerBlock),
                                kThreads, 0, stream>>>(
        static_cast<const T*>(o), gt, lse, D, lse2, st[3], st[4], H, S,
        pitch, rows);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    return wg::launch<HD>(q, k, v, dO, lse2, D, dq, dk, dv, st, B, H, KV, S,
                          pitch, causal, window, sm_scale, stream);
  } else {
    const long long rows = static_cast<long long>(B) * H * S;
    flash_bwd_delta_kernel<T, HD><<<static_cast<unsigned>(
                                        (rows + kWarps - 1) / kWarps),
                                    kThreads, 0, stream>>>(
        static_cast<const T*>(o), gt, D, st[3], st[4], H, S, rows);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const T* qt = static_cast<const T*>(q);
    const T* kt = static_cast<const T*>(k);
    const T* vt = static_cast<const T*>(v);
    constexpr int kSmemKv = dkdv_smem_floats<HD>() * sizeof(float);
    err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemKv);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid_kv(B * KV, (S + kKvBK - 1) / kKvBK);
    flash_bwd_dkdv_kernel<T, HD><<<grid_kv, kThreads, kSmemKv, stream>>>(
        qt, kt, vt, gt, lse, D, static_cast<T*>(dk), static_cast<T*>(dv),
        st[0], st[1], st[2], st[4], st[6], st[7], H, KV, S, causal, window,
        sm_scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);

    constexpr int kSmemQ = dq_smem_floats<HD>() * sizeof(float);
    err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemQ);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid_q(B * H, (S + kQBQ - 1) / kQBQ);
    flash_bwd_dq_kernel<T, HD><<<grid_q, kThreads, kSmemQ, stream>>>(
        qt, kt, vt, gt, lse, D, static_cast<T*>(dq), st[0], st[1], st[2],
        st[4], st[5], H, KV, S, causal, window, sm_scale);
    return static_cast<int>(cudaGetLastError());
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, o, dO, dq, dk, dv all of it);
// hd 64, 112 or 128. `strides` holds 24 element strides, (batch, head, row) of
// q, k, v, o, dO, dq, dk and dv in turn; hd's stride is 1, every pointer
// and stride a multiple of 16 bytes. lse (B, H, S) fp32 is the forward's.
// D is an fp32 scratch of B H S floats (float32) or 2 B H pitch floats,
// pitch = S rounded up to a multiple of 64 (bfloat16). Returns
// cudaGetLastError() after the launches (0 on success), or, where a tensor
// map is refused, 10000 + its CUresult; they run on `stream` and do not
// sync.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dO, const void* lse, void* D,
                                   void* dq, void* dk, void* dv, int B, int H,
                                   int KV, int S, int hd,
                                   const long long* strides, int causal,
                                   int window, float sm_scale, int dtype,
                                   void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || KV <= 0 || H % KV != 0 ||
      (S + kKvBK - 1) / kKvBK > 65535 || (S + kQBQ - 1) / kQBQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Strides st[8];
  for (int i = 0; i < 8; ++i)
    st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(D);
  if (dtype == 0 && hd == 64)
    return launch<float, 64>(q, k, v, o, dO, l, d, dq, dk, dv, st, B, H, KV,
                             S, causal, window, sm_scale, s);
  if (dtype == 0 && hd == 112)
    return launch<float, 112>(q, k, v, o, dO, l, d, dq, dk, dv, st, B, H, KV,
                              S, causal, window, sm_scale, s);
  if (dtype == 0 && hd == 128)
    return launch<float, 128>(q, k, v, o, dO, l, d, dq, dk, dv, st, B, H, KV,
                              S, causal, window, sm_scale, s);
  if (dtype == 1 && hd == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, o, dO, l, d, dq, dk, dv, st, B,
                                     H, KV, S, causal, window, sm_scale, s);
  if (dtype == 1 && hd == 112)
    return launch<__nv_bfloat16, 112>(q, k, v, o, dO, l, d, dq, dk, dv, st,
                                      B, H, KV, S, causal, window, sm_scale,
                                      s);
  if (dtype == 1 && hd == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, o, dO, l, d, dq, dk, dv, st,
                                      B, H, KV, S, causal, window, sm_scale,
                                      s);
  return static_cast<int>(cudaErrorInvalidValue);
}
