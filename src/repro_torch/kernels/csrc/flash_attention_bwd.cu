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
//   1. flash_bwd_delta_kernel: D = rowsum(dO o), one warp per row, (B, H, S)
//      fp32.
//   2. dK/dV: one block per (batch, KV head, tile of 64 keys). It holds its
//      K and V tile and loops over the G = H / KV query heads of its group
//      and, for each, over the query tiles of 32 rows that can see a key of
//      the tile: S = Q K^T, P, dP = dO V^T, dS = P (dP - D); dV += P^T dO
//      and dK += dS^T Q stay in registers across the whole loop, so the
//      group's sum needs no atomics and dk, dv are written once.
//   3. dQ: one block per (batch, head, tile of 64 query rows), looping over
//      the visible key tiles of 32: dQ += dS K.
// Every sum is taken in one fixed order, so two launches give the same bits.
//
// What bounds it: at the training path's (4, 24, 8, 512, 128) bf16 causal,
// the five products over the visible pairs are about 16.1 GFLOP (16 us on
// the bf16 tensor cores) and q, o, dO, dq, k, v, dk, dv about 67 MB (20 us
// at 3.35 TB/s): bytes bound it. Two designs, one per type:
//
// * bfloat16: the tensor cores through mma.sync m16n8k16 with fp32 sums
//   (flash_bwd_dkdv_mma_kernel, flash_bwd_dq_mma_kernel), four warps a
//   block, each over 16 rows (keys for dK/dV, query rows for dQ). Tiles are
//   staged in shared memory as bf16 with rows padded by 16 bytes and read by
//   ldmatrix (transposed for the operands that lie [k][n]). The dK/dV
//   kernel computes S^T = K Q^T and dP^T = V dO^T, so that P^T and dS^T
//   come out as accumulator fragments that, rounded to bf16 in pairs, are
//   the A fragments of dV += P^T dO and dK += dS^T Q; the dQ kernel does the
//   same with S = Q K^T. Shared memory at hd 128: 52,480 and 52,736 bytes.
//   P and dS are rounded to bf16 for the tensor cores, as FA2 rounds them.
// * float32: SIMT (flash_bwd_dkdv_kernel, flash_bwd_dq_kernel), since the
//   tensor cores would take fp32 only as TF32; its floor is near 16.1 GFLOP
//   / 67 TFLOP/s = 0.24 ms. Tiles are staged as fp32 with rows padded to
//   hd + 1 floats, so that the 32 lanes reading 32 rows at one column hit
//   32 banks; each thread owns a 4 x 2 (S-like products) or 8 x hd/32 (dK,
//   dV, dQ) patch of outputs in registers. Shared memory at hd 128: 107,648
//   bytes (dK/dV) and 108,032 (dQ), two blocks per SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

// element strides of one (batch, head, row, hd) view; hd's stride is 1
struct Strides {
  long long b, h, s;
};

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
// floats apart
template <int NR, int HD, int NK, int LDC, int LDX, bool TRANS>
__device__ __forceinline__ void acc_product(float (&acc)[NR / 8][HD / 32],
                                            const float* C, const float* X) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll 2
  for (int k = 0; k < NK; ++k) {
    float cv[NR / 8], xv[HD / 32];
#pragma unroll
    for (int r = 0; r < NR / 8; ++r) {
      const int row = warp + 8 * r;
      cv[r] = TRANS ? C[k * LDC + row] : C[row * LDC + k];
    }
#pragma unroll
    for (int c = 0; c < HD / 32; ++c) xv[c] = X[k * LDX + lane + 32 * c];
#pragma unroll
    for (int r = 0; r < NR / 8; ++r)
#pragma unroll
      for (int c = 0; c < HD / 32; ++c)
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

  float dk_acc[kKvBK / 8][HD / 32], dv_acc[kKvBK / 8][HD / 32];
#pragma unroll
  for (int r = 0; r < kKvBK / 8; ++r)
#pragma unroll
    for (int c = 0; c < HD / 32; ++c) dk_acc[r][c] = dv_acc[r][c] = 0.f;

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
      for (int c = 0; c < HD / 32; ++c) {
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

  float dq_acc[kQBQ / 8][HD / 32];
#pragma unroll
  for (int r = 0; r < kQBQ / 8; ++r)
#pragma unroll
    for (int c = 0; c < HD / 32; ++c) dq_acc[r][c] = 0.f;

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
      for (int c = 0; c < HD / 32; ++c)
        dqb[i * sdq.s + lane + 32 * c] = from_f32<T>(dq_acc[r][c] * sm_scale);
    }
  }
}

// ------------------------------------------------------------------------
// bfloat16: the tensor cores through mma.sync (m16n8k16, fp32 sums)
// ------------------------------------------------------------------------
namespace tc {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kKvBK = 64;    // dK/dV block: keys, 16 per warp
constexpr int kKvBQ = 32;    // query rows per inner tile
constexpr int kQBQ = 64;     // dQ block: query rows, 16 per warp
constexpr int kQBK = 32;     // keys per inner tile

using bf16 = __nv_bfloat16;

template <int HD>
constexpr int kLd = HD + 8;  // bf16 a staged row: 16 bytes of padding, so
                             // the 8 rows of an ldmatrix hit 8 bank groups

template <int HD>
constexpr int dkdv_smem_bytes() {
  return (2 * kKvBK + 2 * kKvBQ) * kLd<HD> * 2 + 2 * kKvBQ * 4;
}
template <int HD>
constexpr int dq_smem_bytes() {
  return (2 * kQBQ + 2 * kQBK) * kLd<HD> * 2 + 2 * kQBQ * 4;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d (16 x 8, fp32) += a (16 x 16, bf16, row) b (16 x 8, bf16, col)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&t);
}

// Fragment layouts (PTX ISA, mma.m16n8k16), g = lane / 4, t = lane % 4:
// A (16 x 16): a0 (g, 2t..2t+1), a1 (g + 8, ...), a2 (g, 2t + 8..), a3
// (g + 8, 2t + 8..); B (16 x 8): b0 (k 2t..2t+1, n g), b1 (k 2t + 8..);
// C (16 x 8): c0, c1 (g, 2t..2t+1), c2, c3 (g + 8, ...). The C fragments
// of two neighbouring n-tiles, rounded to bf16 in pairs, are the A
// fragment of one k-step, so P and dS feed the next products from
// registers.

// the A fragment of rows [r0, r0 + 16) x cols [c0, c0 + 16) of a staged
// row-major matrix
template <int LD>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* m,
                                       int r0, int c0, int lane) {
  const int q = lane >> 3;
  ldsm_x4(a, m + (r0 + (q & 1) * 8 + (lane & 7)) * LD + c0 + (q >> 1) * 8);
}

// the B fragments of n-tiles n0 and n0 + 8 for k-step [k0, k0 + 16) of a
// matrix staged as [n][k]: (b0, b1) of the first in b[0..1], of the second
// in b[2..3]
template <int LD>
__device__ __forceinline__ void load_b_nk(uint32_t (&b)[4], const bf16* m,
                                          int n0, int k0, int lane) {
  const int q = lane >> 3;
  ldsm_x4(b, m + (n0 + (q >> 1) * 8 + (lane & 7)) * LD + k0 + (q & 1) * 8);
}

// the same of a matrix staged as [k][n], transposed by ldmatrix
template <int LD>
__device__ __forceinline__ void load_b_kn(uint32_t (&b)[4], const bf16* m,
                                          int k0, int n0, int lane) {
  const int q = lane >> 3;
  ldsm_x4_trans(b,
                m + (k0 + (q & 1) * 8 + (lane & 7)) * LD + n0 + (q >> 1) * 8);
}

// rows [row0, row0 + NROWS) of an (S, HD) bf16 matrix whose rows lie `rs`
// elements apart into shared memory, LD elements a row; rows at or past S
// become zeros. 16-byte copies.
template <int HD, int NROWS, int LD>
__device__ __forceinline__ void stage(bf16* dst, const bf16* src,
                                      long long rs, int row0, int S) {
  constexpr int kPerRow = HD / 8;
  for (int idx = threadIdx.x; idx < NROWS * kPerRow; idx += kThreads) {
    const int r = idx / kPerRow, c = (idx % kPerRow) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < S)
      v = *reinterpret_cast<const uint4*>(src + (row0 + r) * rs + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = v;
  }
}

// out[n] (n-tiles over the rows of `bm`) = A rows of `am` (from row r0) .
// rows of `bm`, over HD: S = A B^T for two [row][hd] matrices
template <int HD, int NT, int LD>
__device__ __forceinline__ void rows_dot(float (&out)[NT][4], const bf16* am,
                                         int r0, const bf16* bm, int lane) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) out[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t a[4];
    load_a<LD>(a, am, r0, kk * 16, lane);
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
      uint32_t b[4];
      load_b_nk<LD>(b, bm, n * 8, kk * 16, lane);
      mma(out[n], a, b[0], b[1]);
      mma(out[n + 1], a, b[2], b[3]);
    }
  }
}

// acc (16 x HD) += C (16 x 16 KT, the C fragments c) . X (16 KT x HD, a
// [row][hd] matrix staged as [k][n])
template <int HD, int KT, int LD>
__device__ __forceinline__ void acc_cx(float (&acc)[HD / 8][4],
                                       const float (&c)[2 * KT][4],
                                       const bf16* xm, int lane) {
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    const uint32_t a[4] = {pack(c[2 * kk][0], c[2 * kk][1]),
                           pack(c[2 * kk][2], c[2 * kk][3]),
                           pack(c[2 * kk + 1][0], c[2 * kk + 1][1]),
                           pack(c[2 * kk + 1][2], c[2 * kk + 1][3])};
#pragma unroll
    for (int n = 0; n < HD / 8; n += 2) {
      uint32_t b[4];
      load_b_kn<LD>(b, xm, kk * 16, n * 8, lane);
      mma(acc[n], a, b[0], b[1]);
      mma(acc[n + 1], a, b[2], b[3]);
    }
  }
}

// a warp's 16 rows x HD of fp32 sums times `mul`, stored as bf16 pairs at
// rows row0 + g (+ 8) of a view with row stride rs, rows past S skipped
template <int HD>
__device__ __forceinline__ void store_rows(bf16* dst, long long rs,
                                           const float (&acc)[HD / 8][4],
                                           int row0, int S, float mul,
                                           int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + g + 8 * h;
    if (row >= S) continue;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<uint32_t*>(dst + row * rs + n * 8 + 2 * t) =
          pack(acc[n][2 * h] * mul, acc[n][2 * h + 1] * mul);
  }
}

// One block per (batch, KV head, 64 keys): warp w owns keys 16w..16w+15
// and computes S^T = K Q^T, dP^T = V dO^T for each query tile, so that
// P^T and dS^T come out in registers as the A operands of dV += P^T dO and
// dK += dS^T Q.
template <int HD>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkdv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dO,
                const float* __restrict__ lse, const float* __restrict__ D,
                bf16* __restrict__ dk, bf16* __restrict__ dv, Strides sq,
                Strides sk, Strides sv, Strides sdo, Strides sdk, Strides sdv,
                int H, int KV, int S, int causal, int window,
                float sm_scale) {
  constexpr int LD = kLd<HD>;
  constexpr int NT = kKvBQ / 8;
  extern __shared__ uint4 smem_tc[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_tc);
  bf16* Vs = Ks + kKvBK * LD;
  bf16* Qs = Vs + kKvBK * LD;
  bf16* dOs = Qs + kKvBQ * LD;
  float* ls = reinterpret_cast<float*>(dOs + kKvBQ * LD);
  float* Ds = ls + kKvBQ;

  const int b = blockIdx.x / KV, kvh = blockIdx.x % KV;
  const int k0 = blockIdx.y * kKvBK;   // the longest causal extents first
  const int G = H / KV;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3, jr = 16 * warp;
  stage<HD, kKvBK, LD>(Ks, k + b * sk.b + kvh * sk.h, sk.s, k0, S);
  stage<HD, kKvBK, LD>(Vs, v + b * sv.b + kvh * sv.h, sv.s, k0, S);

  float dk_acc[HD / 8][4], dv_acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  const int i_lo = causal ? k0 : 0;
  const int i_hi = window > 0 ? min(S, k0 + kKvBK - 1 + window) : S;
  for (int gh = 0; gh < G; ++gh) {
    const int h = kvh * G + gh;
    const bf16* qb = q + b * sq.b + h * sq.h;
    const bf16* gb = dO + b * sdo.b + h * sdo.h;
    const float* lb = lse + (static_cast<long long>(b) * H + h) * S;
    const float* Db = D + (static_cast<long long>(b) * H + h) * S;
    for (int q0 = (i_lo / kKvBQ) * kKvBQ; q0 < i_hi; q0 += kKvBQ) {
      __syncthreads();   // the last tile's Q and dO are read (K, V staged)
      stage<HD, kKvBQ, LD>(Qs, qb, sq.s, q0, S);
      stage<HD, kKvBQ, LD>(dOs, gb, sdo.s, q0, S);
      if (threadIdx.x < kKvBQ) {
        const int i = q0 + threadIdx.x;
        ls[threadIdx.x] = i < S ? lb[i] : 0.f;
        Ds[threadIdx.x] = i < S ? Db[i] : 0.f;
      }
      __syncthreads();
      float p[NT][4], ds[NT][4];
      rows_dot<HD, NT, LD>(p, Ks, jr, Qs, lane);    // S^T
      rows_dot<HD, NT, LD>(ds, Vs, jr, dOs, lane);  // dP^T
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = k0 + jr + g + (e >> 1) * 8;
          const int il = n * 8 + 2 * t + (e & 1);
          const float pv = visible(q0 + il, j, S, causal, window)
                               ? expf(p[n][e] * sm_scale - ls[il])
                               : 0.f;
          p[n][e] = pv;
          ds[n][e] = pv * (ds[n][e] - Ds[il]);
        }
      acc_cx<HD, NT / 2, LD>(dv_acc, p, dOs, lane);   // dV += P^T dO
      acc_cx<HD, NT / 2, LD>(dk_acc, ds, Qs, lane);   // dK += dS^T Q
    }
  }
  store_rows<HD>(dk + b * sdk.b + kvh * sdk.h, sdk.s, dk_acc, k0 + jr, S,
                 sm_scale, lane);
  store_rows<HD>(dv + b * sdv.b + kvh * sdv.h, sdv.s, dv_acc, k0 + jr, S,
                 1.f, lane);
}

// One block per (batch, head, 64 query rows): warp w owns rows 16w..16w+15;
// S = Q K^T and dP = dO V^T for each key tile give dS in registers, the A
// operand of dQ += dS K.
template <int HD>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ dO,
              const float* __restrict__ lse, const float* __restrict__ D,
              bf16* __restrict__ dq, Strides sq, Strides sk, Strides sv,
              Strides sdo, Strides sdq, int H, int KV, int S, int causal,
              int window, float sm_scale) {
  constexpr int LD = kLd<HD>;
  constexpr int NT = kQBK / 8;
  extern __shared__ uint4 smem_tc[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_tc);
  bf16* dOs = Qs + kQBQ * LD;
  bf16* Ks = dOs + kQBQ * LD;
  bf16* Vs = Ks + kQBK * LD;
  float* ls = reinterpret_cast<float*>(Vs + kQBK * LD);
  float* Ds = ls + kQBQ;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H, kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kQBQ;   // longest rows first
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3, ir = 16 * warp;
  stage<HD, kQBQ, LD>(Qs, q + b * sq.b + h * sq.h, sq.s, q0, S);
  stage<HD, kQBQ, LD>(dOs, dO + b * sdo.b + h * sdo.h, sdo.s, q0, S);
  if (threadIdx.x < kQBQ) {
    const int i = q0 + threadIdx.x;
    ls[threadIdx.x] = i < S ? lse[static_cast<long long>(bh) * S + i] : 0.f;
    Ds[threadIdx.x] = i < S ? D[static_cast<long long>(bh) * S + i] : 0.f;
  }
  const bf16* kb = k + b * sk.b + kvh * sk.h;
  const bf16* vb = v + b * sv.b + kvh * sv.h;

  float dq_acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[n][e] = 0.f;

  const int k_end = causal ? min(S, q0 + kQBQ) : S;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  for (int k0 = (k_begin / kQBK) * kQBK; k0 < k_end; k0 += kQBK) {
    __syncthreads();   // the last tile's K and V are read (Q, dO staged)
    stage<HD, kQBK, LD>(Ks, kb, sk.s, k0, S);
    stage<HD, kQBK, LD>(Vs, vb, sv.s, k0, S);
    __syncthreads();
    float p[NT][4], ds[NT][4];
    rows_dot<HD, NT, LD>(p, Qs, ir, Ks, lane);    // S
    rows_dot<HD, NT, LD>(ds, dOs, ir, Vs, lane);  // dP
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int il = ir + g + (e >> 1) * 8;
        const int j = k0 + n * 8 + 2 * t + (e & 1);
        const float pv = visible(q0 + il, j, S, causal, window)
                             ? expf(p[n][e] * sm_scale - ls[il])
                             : 0.f;
        ds[n][e] = pv * (ds[n][e] - Ds[il]);
      }
    acc_cx<HD, NT / 2, LD>(dq_acc, ds, Ks, lane);   // dQ += dS K
  }
  store_rows<HD>(dq + b * sdq.b + h * sdq.h, sdq.s, dq_acc, q0 + ir, S,
                 sm_scale, lane);
}

template <int HD>
int launch(const bf16* q, const bf16* k, const bf16* v, const bf16* dO,
           const float* lse, const float* D, bf16* dq, bf16* dk, bf16* dv,
           const Strides* st, int B, int H, int KV, int S, int causal,
           int window, float sm_scale, cudaStream_t stream) {
  constexpr int kSmemKv = dkdv_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_mma_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemKv);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_kv(B * KV, (S + kKvBK - 1) / kKvBK);
  flash_bwd_dkdv_mma_kernel<HD><<<grid_kv, kThreads, kSmemKv, stream>>>(
      q, k, v, dO, lse, D, dk, dv, st[0], st[1], st[2], st[4], st[6], st[7],
      H, KV, S, causal, window, sm_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int kSmemQ = dq_smem_bytes<HD>();
  err = cudaFuncSetAttribute(
      flash_bwd_dq_mma_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemQ);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_q(B * H, (S + kQBQ - 1) / kQBQ);
  flash_bwd_dq_mma_kernel<HD><<<grid_q, kThreads, kSmemQ, stream>>>(
      q, k, v, dO, lse, D, dq, st[0], st[1], st[2], st[4], st[5], H, KV, S,
      causal, window, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dO, const float* lse, float* D, void* dq, void* dk,
           void* dv, const Strides* st, int B, int H, int KV, int S,
           int causal, int window, float sm_scale, cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gt = static_cast<const T*>(dO);
  const long long rows = static_cast<long long>(B) * H * S;
  flash_bwd_delta_kernel<T, HD><<<static_cast<unsigned>(
                                      (rows + kWarps - 1) / kWarps),
                                  kThreads, 0, stream>>>(
      static_cast<const T*>(o), gt, D, st[3], st[4], H, S, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if constexpr (std::is_same_v<T, __nv_bfloat16>)
    return tc::launch<HD>(qt, kt, vt, gt, lse, D, static_cast<T*>(dq),
                          static_cast<T*>(dk), static_cast<T*>(dv), st, B, H,
                          KV, S, causal, window, sm_scale, stream);
  else {
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
// hd 64 or 128. `strides` holds 24 element strides, (batch, head, row) of
// q, k, v, o, dO, dq, dk and dv in turn; hd's stride is 1, every pointer
// and stride a multiple of 16 bytes. lse (B, H, S) fp32 is the forward's;
// D is an fp32 scratch of B * H * S. Returns cudaGetLastError() after the
// launches (0 on success); they run on `stream` and do not sync.
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
  if (dtype == 0 && hd == 128)
    return launch<float, 128>(q, k, v, o, dO, l, d, dq, dk, dv, st, B, H, KV,
                              S, causal, window, sm_scale, s);
  if (dtype == 1 && hd == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, o, dO, l, d, dq, dk, dv, st, B,
                                     H, KV, S, causal, window, sm_scale, s);
  if (dtype == 1 && hd == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, o, dO, l, d, dq, dk, dv, st,
                                      B, H, KV, S, causal, window, sm_scale,
                                      s);
  return static_cast<int>(cudaErrorInvalidValue);
}
