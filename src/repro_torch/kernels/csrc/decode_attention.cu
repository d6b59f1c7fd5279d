// One-token decode attention over a KV cache for Hopper (sm_90a), read in
// place and only over the filled slots: for each batch row b and query head
// h, o = softmax(scale q . K[t]) V over the slots t < kv_valid =
// min(cache_index + 1, L) of the (B, L, KV, hd) caches, with query head h
// reading KV head h / G (G = H / KV).
//
// Replaces no Pallas kernel: the JAX package's decode is plain jnp
// (src/repro/models/attention.py, gqa_attention over the whole cache under
// a mask), which XLA fuses. The port's plain version, which the CPU takes,
// is kernels/ref.py's decode_attention_ref: that same call, whose einsums
// make a contiguous (B, KV, L, hd) copy of each cache every step and
// multiply over all L slots.
//
// What bounds it: bytes. It must read K and V over the filled slots, 2
// kv_valid hd elements a (b, KV head), and q; it writes o. Each element
// takes 2 G multiply-adds, at most 16 for the configs' G <= 8: under the
// card's balance point. At the MoE serve cell's decode, (32, 1024, 4, 128)
// with G 8 at kv_valid 545, that is 35.7 MB, 10.7 us at 3.35 TB/s; at
// Zamba2-7B's, (32, 1024, 32, 224) with G 1, 500 MB, 149 us.
//
// Design: one launch on the caller's stream, no host sync, the same grid at
// every position (so one CUDA graph replays it). Grid (KV x ceil(G / 8),
// B): a block serves one KV head's tile of up to 8 query rows, and its W
// warps split that head's filled slots into W parts of ceil(kv_valid / W),
// kv_valid read from the device's 0-d cache_index (a warp past kv_valid
// has an empty part). The wrapper chooses W from the shapes and the card's
// occupancy so that the blocks fill whole waves of the card. All 8 rows are
// served from one read of each chunk, so each K and V byte is read once a
// step where G <= 8 (all the configs but granite-20b's MQA, whose 48 rows
// take 6 blocks). Each warp streams its part through a ring of kStages
// chunks of 16 slots in its own shared memory, one bulk async copy a row
// (each row's hd elements are one contiguous run, read through the
// caches' strides) completing on the stage's mbarrier, so a lane issues at
// most one copy a chunk; rows are padded by 16 bytes so that no two rows
// of an 8 x 8 fragment share a bank. Per chunk: the scores of its 16 slots
// and 8 rows (bf16: m16n8k16 mma.sync from ldmatrix, q's fragments held in
// registers, fp32 sums; fp32: CUDA-core FMAs in the same fragment layout),
// the online softmax in fp32 (base 2) with the row reductions among the 8
// lanes that hold a row, then o = o alpha + p V: bf16, O^T's mma tiles from
// V^T by ldmatrix.trans with p split into a bf16 hi and lo term (16
// significant bits; two products, fp32 sums); fp32, CUDA-core FMAs with p
// and alpha through shared memory. The last chunk's unloaded V rows are
// zeroed. Then the warps write their (m, l, o) to shared memory and the
// block merges the W parts in warp order and writes o in q's dtype.
// Scores, the softmax and every sum stay in fp32; bf16's p enters p V as
// hi + lo, and o is rounded once at the end. No atomics: every launch gives
// the same bits, graphed or eager.

#include "hopper.cuh"

#include <cmath>
#include <cstdint>

namespace {

using namespace hopper;

constexpr int kChunk = 16;        // slots a pipeline stage holds: one m16 tile
constexpr int kRows = 8;          // query rows a block serves: one n8 tile
constexpr int kMaxWarps = 8;      // warps (parts) a block, at most
constexpr int kBarBytes = 64;     // a warp's stage mbarriers, first

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const long long* index;  // the 0-d cache_index on the card
  void* out;               // (B, 1, H, hd) contiguous, in q's dtype
  long long qb, qh, kb, kl, kh, vb, vl, vh;  // element strides
  int H, G, L, n_tiles;
  float scale_log2;        // the scores' scale times log2(e)
};

template <typename T, int HD>
struct Traits {
  static constexpr bool kBf16 = sizeof(T) == 2;
  static constexpr int kRowBytes = HD * static_cast<int>(sizeof(T));
  // bf16 tiles: whole 64-column panels of kChunk rows x 128 bytes, swizzled
  // (128 B) by TMA; fp32 tiles: rows padded by 16 bytes
  static constexpr int kPanels = padded_hd(HD) / kPanel;
  static constexpr int kRow = HD + 16 / static_cast<int>(sizeof(T));  // fp32
  static constexpr int kTile =
      kBf16 ? kPanels * kChunk * hopper::kRowBytes : kChunk * kRow * 4;
  static constexpr int kStages = 2 * kTile <= 12288 ? 3 : 2;
  static constexpr int kMT = HD / 16;                    // 16-column steps
  static constexpr int kNV4 = HD / 4;                    // fp32: 4-col vectors
  static constexpr int kNVL = (kNV4 + 31) / 32;          // of them a lane
  // a warp's shared memory, 1024-aligned: the ring (then its (m, l, o) for
  // the merge); the stages' mbarriers; p (kChunk x kRows) and the rows'
  // rescale; fp32 q rows
  static constexpr int kBars = kStages * 2 * kTile;
  static constexpr int kP = kBars + kBarBytes;
  static constexpr int kQ = kP + (kChunk * kRows + kRows) * 4;
  static constexpr int kWarp =
      (kQ + (kBf16 ? 0 : kRows * kRow * 4) + 1023) / 1024 * 1024;
  static_assert(HD % 16 == 0 && kStages * 8 <= kBarBytes &&
                    (2 * kRows + kRows * HD) * 4 <= kStages * 2 * kTile,
                "layout");
};

// the address of 16-byte column chunk `chunk` (of hd / 8) of row r in a bf16
// tile: its panel, then the row's 128 bytes with the chunks XOR-swizzled by
// r % 8, as TMA's 128-byte swizzle writes them
__device__ __forceinline__ const unsigned char* swizzled(
    const unsigned char* tile, int r, int chunk) {
  return tile + (chunk >> 3) * (kChunk * hopper::kRowBytes) +
         r * hopper::kRowBytes + (((chunk & 7) ^ (r & 7)) << 4);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* src,
                                            bool trans) {
  const uint32_t a = smem_u32(src);
  if (trans)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(a));
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(a));
}

// c += A B, A 16 x 16 bf16 (row), B 16 x 8 bf16 (col), c 16 x 8 fp32
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// (x0, x1) as two bf16 pairs whose sum is x to about 16 significant bits:
// hi rounded to bf16, lo the remainder rounded
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

__device__ __forceinline__ void load4(const float* src, float (&x)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(src);
  x[0] = f.x;
  x[1] = f.y;
  x[2] = f.z;
  x[3] = f.w;
}

__device__ __forceinline__ void store4(float* dst, const float (&x)[4]) {
  *reinterpret_cast<float4*>(dst) = make_float4(x[0], x[1], x[2], x[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* dst,
                                       const float (&x)[4]) {
  uint2 u;
  u.x = as_u32(__floats2bfloat162_rn(x[0], x[1]));
  u.y = as_u32(__floats2bfloat162_rn(x[2], x[3]));
  *reinterpret_cast<uint2*>(dst) = u;
}

// the sum (or max) over the 8 lanes that share lane % 4
__device__ __forceinline__ float group_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  x += __shfl_xor_sync(0xffffffffu, x, 8);
  return x + __shfl_xor_sync(0xffffffffu, x, 16);
}

__device__ __forceinline__ float group_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 8));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 16));
}

// Block: KV head blockIdx.x / n_tiles, its query rows tile blockIdx.x %
// n_tiles (8 rows), batch row blockIdx.y; warp w takes the w-th of W parts
// of the filled slots. GT: the rows fp32's CUDA-core product keeps (bf16's
// mma tiles hold all 8).
template <typename T, int HD, int GT>
__global__ void __launch_bounds__(kMaxWarps * 32)
    decode_attention_kernel(const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const Params p) {
  using Tr = Traits<T, HD>;
  constexpr int S = Tr::kStages, ROW = Tr::kRow, MT = Tr::kMT;
  const int W = blockDim.x / 32, warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32, b = blockIdx.y;
  const int kvh = blockIdx.x / p.n_tiles, tile = blockIdx.x % p.n_tiles;
  const long long idx = *p.index;
  const int kv_valid = static_cast<int>(idx + 1 < p.L ? idx + 1 : p.L);
  const int per = (kv_valid + W - 1) / W;             // slots a part
  const int lo = warp * per;
  const int hi = min(lo + per, kv_valid);
  const int n_chunks = lo < hi ? (hi - lo + kChunk - 1) / kChunk : 0;
  const int row0 = tile * kRows;                      // of the G rows
  const int rows = min(kRows, p.G - row0);            // valid rows here
  const int h0 = kvh * p.G + row0;                    // its first query head

  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem_all =
      smem_raw + (((smem_u32(smem_raw) + 1023u) & ~1023u) - smem_u32(smem_raw));
  unsigned char* smem = smem_all + warp * Tr::kWarp;
  T* ring = reinterpret_cast<T*>(smem);               // S x {K, V} tiles
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + Tr::kBars);
  float* pt = reinterpret_cast<float*>(smem + Tr::kP);  // [16 slots][8 rows]
  float* alpha = pt + kChunk * kRows;                 // [8]
  float* qs = reinterpret_cast<float*>(smem + Tr::kQ);  // fp32: [8][ROW]

  const T* K = static_cast<const T*>(p.k) + b * p.kb + kvh * p.kh;
  const T* V = static_cast<const T*>(p.v) + b * p.vb + kvh * p.vh;
  const T* Q = static_cast<const T*>(p.q) + b * p.qb + h0 * p.qh;

  if (lane == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) mbar_init(smem_u32(&bars[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncwarp();

  // a chunk: bf16, one TMA box (16 rows x 64 columns, 2 KB) a panel of K
  // and of V, a lane each, the rows past L zero-filled and those in [hi, L)
  // read and masked; fp32, one bulk copy a row below hi, lanes 0-15 K's,
  // 16-31 V's. Lane 0 arms the stage's barrier with the bytes.
  const int t_row = lane % kChunk, which = lane / kChunk;
  const long long step = which ? p.vl : p.kl;
  const T* src_row = (which ? V : K) + t_row * step;
  auto load_chunk = [&](int c) {
    const int st = c % S, base = lo + c * kChunk;
    const uint32_t bar = smem_u32(&bars[st]);
    unsigned char* tiles = reinterpret_cast<unsigned char*>(ring) +
                           st * 2 * Tr::kTile;
    if constexpr (Tr::kBf16) {
      if (lane == 0) mbar_expect_tx(bar, 2 * Tr::kTile);
      if (lane < 2 * Tr::kPanels) {
        const int w = lane / Tr::kPanels, pn = lane % Tr::kPanels;
        tma_load(smem_u32(tiles + w * Tr::kTile +
                          pn * kChunk * hopper::kRowBytes),
                 w ? &tv : &tk, bar, pn * kPanel, base, kvh, b);
      }
    } else {
      const int n = min(kChunk, hi - base);
      if (lane == 0) mbar_expect_tx(bar, 2 * n * Tr::kRowBytes);
      if (t_row < n)
        bulk_load(smem_u32(tiles + which * Tr::kTile + t_row * ROW * 4),
                  src_row + base * step, Tr::kRowBytes, bar);
    }
  };
#pragma unroll
  for (int c = 0; c < S - 1; ++c)
    if (c < n_chunks) load_chunk(c);

  // q: bf16, each k-step's B fragment (row lane / 4, zero past `rows`);
  // fp32, the 8 rows in shared memory
  uint32_t qf[Tr::kBf16 ? MT : 1][2];
  if constexpr (Tr::kBf16) {
    const int g = lane / 4;
#pragma unroll
    for (int kk = 0; kk < MT; ++kk)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        qf[kk][j] = g < rows ? *reinterpret_cast<const uint32_t*>(
                                   Q + g * p.qh + kk * 16 + j * 8 +
                                   (lane % 4) * 2)
                             : 0u;
  } else {
    for (int i = lane; i < kRows * (HD / 4); i += 32) {
      const int g = i / (HD / 4), c4 = i % (HD / 4);
      float x[4] = {0.f, 0.f, 0.f, 0.f};
      if (g < rows) load4(reinterpret_cast<const float*>(Q) + g * p.qh +
                              c4 * 4, x);
      store4(qs + g * ROW + c4 * 4, x);
    }
    __syncwarp();
  }

  // this lane's two rows (lane % 4) * 2 + j: running max (base 2) and sum
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  // o: bf16, O^T's mma tiles (hd rows lane / 4 + 8 r of step mt, query rows
  // (lane % 4) * 2 + j at [mt][2 r + j]); fp32, GT rows of 4-column vectors
  float o[Tr::kBf16 ? MT : GT][Tr::kBf16 ? 4 : Tr::kNVL * 4];
#pragma unroll
  for (int i = 0; i < (Tr::kBf16 ? MT : GT); ++i)
#pragma unroll
    for (int e = 0; e < (Tr::kBf16 ? 4 : Tr::kNVL * 4); ++e) o[i][e] = 0.f;

  for (int c = 0; c < n_chunks; ++c) {
    const int st = c % S;
    mbar_wait(smem_u32(&bars[st]), (c / S) & 1);
    __syncwarp();   // every lane is past chunk c - 1: its stage and p free
    if (c + S - 1 < n_chunks) load_chunk(c + S - 1);
    const unsigned char* Kt =
        reinterpret_cast<const unsigned char*>(ring) + st * 2 * Tr::kTile;
    unsigned char* Vt =
        reinterpret_cast<unsigned char*>(ring) + (st * 2 + 1) * Tr::kTile;
    const int valid = hi - (lo + c * kChunk);
    if (!Tr::kBf16 && valid < kChunk) {
      // the last chunk's unloaded V rows: zeros, so that p = 0 meets no
      // stale NaN (its K rows' scores are masked)
      constexpr int kU4 = ROW * 4 / 16;
      for (int i = lane; i < (kChunk - valid) * kU4; i += 32)
        reinterpret_cast<uint4*>(Vt + valid * ROW * 4)[i] =
            make_uint4(0, 0, 0, 0);
    }

    // s[i][j]: slot lane / 4 + 8 i, row (lane % 4) * 2 + j
    float s[2][2];
    if constexpr (Tr::kBf16) {
      float c0[4] = {0.f, 0.f, 0.f, 0.f}, c1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < MT; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(a, swizzled(Kt, lane & 15, 2 * kk + (lane >> 4)), false);
        if (kk % 2)
          mma_bf16(c1, a, qf[kk][0], qf[kk][1]);
        else
          mma_bf16(c0, a, qf[kk][0], qf[kk][1]);
      }
      s[0][0] = c0[0] + c1[0];
      s[0][1] = c0[1] + c1[1];
      s[1][0] = c0[2] + c1[2];
      s[1][1] = c0[3] + c1[3];
    } else {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) s[i][j] = 0.f;
      for (int d = 0; d < HD; d += 4) {
        float k4[2][4], q4[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          load4(reinterpret_cast<const float*>(Kt) + (lane / 4 + 8 * i) * ROW +
                    d,
                k4[i]);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          load4(qs + ((lane % 4) * 2 + j) * ROW + d, q4[j]);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              s[i][j] = fmaf(k4[i][e], q4[j][e], s[i][j]);
      }
    }

    // the online softmax over the chunk's valid slots, rows in fp32
    float a[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
        s[i][j] = lane / 4 + 8 * i < valid ? s[i][j] * p.scale_log2
                                           : -INFINITY;
      const float m_new = fmaxf(m[j], group_max(fmaxf(s[0][j], s[1][j])));
      a[j] = exp2f(m[j] - m_new);
      const float p0 = exp2f(s[0][j] - m_new), p1 = exp2f(s[1][j] - m_new);
      l[j] = l[j] * a[j] + group_sum(p0 + p1);
      m[j] = m_new;
      const int g = (lane % 4) * 2 + j;
      pt[(lane / 4) * kRows + g] = p0;
      pt[(lane / 4 + 8) * kRows + g] = p1;
      if (lane < 4) alpha[g] = a[j];
    }
    __syncwarp();

    if constexpr (Tr::kBf16) {
      // O^T += V^T P^T: V^T's tiles by ldmatrix.trans, p's B fragment
      // (query row lane / 4, slots (lane % 4) * 2 + {0, 1}, + 8) split into
      // bf16 hi and lo terms, fp32 sums
      uint32_t bh[2], bl[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int t = (lane % 4) * 2 + half * 8;
        split_bf16(pt[t * kRows + lane / 4], pt[(t + 1) * kRows + lane / 4],
                   bh[half], bl[half]);
      }
      const int v_r = (lane & 7) + ((lane >> 4) << 3);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        o[mt][0] *= a[0];
        o[mt][1] *= a[1];
        o[mt][2] *= a[0];
        o[mt][3] *= a[1];
        uint32_t f[4];
        ldmatrix_x4(f, swizzled(Vt, v_r, 2 * mt + ((lane >> 3) & 1)), true);
        mma_bf16(o[mt], f, bh[0], bh[1]);
        mma_bf16(o[mt], f, bl[0], bl[1]);
      }
    } else {
      // o = o alpha + p V over the chunk on CUDA cores
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        const float ag = alpha[g];
#pragma unroll
        for (int e = 0; e < Tr::kNVL * 4; ++e) o[g][e] *= ag;
      }
#pragma unroll 4
      for (int t = 0; t < kChunk; ++t) {
        float pr[GT];
#pragma unroll
        for (int g = 0; g < GT; ++g) pr[g] = pt[t * kRows + g];
#pragma unroll
        for (int j = 0; j < Tr::kNVL; ++j) {
          const int v4 = lane + 32 * j;
          if (v4 < Tr::kNV4) {
            float x[4];
            load4(reinterpret_cast<const float*>(Vt) + t * ROW + v4 * 4, x);
#pragma unroll
            for (int g = 0; g < GT; ++g)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                o[g][j * 4 + e] = fmaf(pr[g], x[e], o[g][j * 4 + e]);
          }
        }
      }
    }
  }

  // the warp's part, (m, l) and o unnormalised, into its ring (every copy
  // has landed); an empty part leaves m = -inf, l = 0, o = 0
  float* mm = reinterpret_cast<float*>(ring);         // [8]
  float* ll = mm + kRows;                             // [8]
  float* oo = ll + kRows;                             // [8][HD]
  if (lane < 4) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      mm[lane * 2 + j] = m[j];
      ll[lane * 2 + j] = l[j];
    }
  }
  if constexpr (Tr::kBf16) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          oo[((lane % 4) * 2 + j) * HD + mt * 16 + lane / 4 + 8 * r] =
              o[mt][2 * r + j];
  } else {
#pragma unroll
    for (int g = 0; g < GT; ++g)
#pragma unroll
      for (int j = 0; j < Tr::kNVL; ++j) {
        const int v4 = lane + 32 * j;
        if (v4 < Tr::kNV4) {
          float x[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) x[e] = o[g][j * 4 + e];
          store4(oo + g * HD + v4 * 4, x);
        }
      }
  }
  __syncthreads();

  // merge the W parts in warp order: a thread a (row, 4 columns)
  const int nv4 = HD / 4;
  for (int i = threadIdx.x; i < rows * nv4; i += blockDim.x) {
    const int g = i / nv4, c4 = (i - g * nv4) * 4;
    float mx = -INFINITY;
    for (int w = 0; w < W; ++w)
      mx = fmaxf(mx, reinterpret_cast<const float*>(
                         smem_all + w * Tr::kWarp)[g]);
    float den = 0.f, acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int w = 0; w < W; ++w) {
      const float* part =
          reinterpret_cast<const float*>(smem_all + w * Tr::kWarp);
      const float wt = exp2f(part[g] - mx);
      float x[4];
      load4(part + 2 * kRows + g * HD + c4, x);
      den = fmaf(wt, part[kRows + g], den);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[e] = fmaf(wt, x[e], acc[e]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[e] /= den;
    store4(static_cast<T*>(p.out) + (static_cast<long long>(b) * p.H + h0 + g)
                                        * HD + c4,
           acc);
  }
}

template <typename T, int HD, int GT>
int launch(const CUtensorMap& tk, const CUtensorMap& tv, const Params& p,
           dim3 grid, int W, cudaStream_t st, bool query, int* per_sm) {
  auto kernel = decode_attention_kernel<T, HD, GT>;
  const int smem = W * Traits<T, HD>::kWarp + 1024;   // + room to align
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (query)
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, kernel, W * 32, smem));
  kernel<<<grid, W * 32, smem, st>>>(tk, tv, p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int run_hd(const Params& p, int B, int KV, int W, cudaStream_t st,
           bool query, int* per_sm) {
  const dim3 grid(KV * p.n_tiles, B);
  // bf16: the caches as (B, KV, L, hd) views for TMA, boxes of kChunk rows
  CUtensorMap tk{}, tv{};
  if (Traits<T, HD>::kBf16 && !query) {
    int res = make_map(&tk, p.k, Strides{p.kb, p.kh, p.kl}, B, KV, p.L, HD,
                       kChunk);
    if (res == 0)
      res = make_map(&tv, p.v, Strides{p.vb, p.vh, p.vl}, B, KV, p.L, HD,
                     kChunk);
    if (res != 0) return kTensorMapError + res;
  }
  // bf16's tiles hold 8 rows whatever G; fp32 keeps G rounded up to a
  // power of two (at most 8) on CUDA cores
  if constexpr (Traits<T, HD>::kBf16) {
    return launch<T, HD, 8>(tk, tv, p, grid, W, st, query, per_sm);
  } else {
    switch (p.G == 1 ? 1 : p.G == 2 ? 2 : p.G <= 4 ? 4 : 8) {
      case 1: return launch<T, HD, 1>(tk, tv, p, grid, W, st, query,
                                    per_sm);
      case 2: return launch<T, HD, 2>(tk, tv, p, grid, W, st, query,
                                    per_sm);
      case 4: return launch<T, HD, 4>(tk, tv, p, grid, W, st, query,
                                    per_sm);
      default: return launch<T, HD, 8>(tk, tv, p, grid, W, st, query,
                                       per_sm);
    }
  }
}

template <typename T>
int run(const Params& p, int B, int KV, int hd, int W, cudaStream_t st,
        bool query, int* per_sm) {
  switch (hd) {
    case 64: return run_hd<T, 64>(p, B, KV, W, st, query, per_sm);
    case 112: return run_hd<T, 112>(p, B, KV, W, st, query, per_sm);
    case 128: return run_hd<T, 128>(p, B, KV, W, st, query, per_sm);
    case 224: return run_hd<T, 224>(p, B, KV, W, st, query, per_sm);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Blocks of W warps an SM holds at once for this head dim, group G and
// dtype (0 fp32, 1 bf16): 0 where one does not fit; negative: the CUDA
// error.
int decode_attention_blocks_per_sm(int hd, int G, int dtype, int W) {
  if (W < 1 || W > kMaxWarps || G < 1)
    return -static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.G = G;
  int per_sm = 0;
  const int err =
      dtype == 1 ? run<__nv_bfloat16>(p, 1, 1, hd, W, nullptr, true, &per_sm)
                 : run<float>(p, 1, 1, hd, W, nullptr, true, &per_sm);
  // a block past the card's shared memory is refused, not an error here
  return err == static_cast<int>(cudaErrorInvalidValue) ? 0
         : err                                          ? -err
                                                        : per_sm;
}

// o (B, 1, H, hd) contiguous = decode attention of q (B, 1, H, hd) over the
// caches k, v (B, L, KV, hd) at the 0-d int64 position *index (all on the
// card, one dtype: 0 fp32, 1 bf16), each (b, KV head)'s filled slots cut
// into W parts, one warp each. strides: q's b and h, k's and v's b, l and
// kv, in elements (hd's stride 1, every stride and pointer on 16 bytes).
int decode_attention(const void* q, const void* k, const void* v,
                     const void* index, void* out, int B, int H, int KV,
                     int L, int hd, const long long* strides, int W,
                     float scale, int dtype, void* stream) {
  if (B <= 0 || KV <= 0 || H % KV || L <= 0 || W < 1 || W > kMaxWarps ||
      B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.index = static_cast<const long long*>(index);
  p.out = out;
  p.qb = strides[0];
  p.qh = strides[1];
  p.kb = strides[2];
  p.kl = strides[3];
  p.kh = strides[4];
  p.vb = strides[5];
  p.vl = strides[6];
  p.vh = strides[7];
  p.H = H;
  p.G = H / KV;
  p.L = L;
  p.n_tiles = (p.G + kRows - 1) / kRows;
  p.scale_log2 = scale * 1.4426950408889634f;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 1
             ? run<__nv_bfloat16>(p, B, KV, hd, W, st, false, nullptr)
             : run<float>(p, B, KV, hd, W, st, false, nullptr);
}

}  // extern "C"
