// Hopper (sm_90a) building blocks shared by the kernels of this directory,
// above all the flash-attention forward (flash_attention.cu) and backward
// (flash_attention_bwd.cu): named barriers, mbarriers, TMA
// loads and stores through tensor maps and plain bulk copies, wgmma on bf16
// with fp32 sums, the 128-byte-swizzled tile layout both kernels use, and
// the host-side tensor-map encoding of a strided (B, N, S, hd) view.
//
// Tiles: every tile is 64 rows (the m64 of one wgmma) by hd bf16 columns,
// stored as padded_hd(hd) / 64 panels of 64 rows x 128 bytes, one panel per
// 64 columns, with the 128-byte swizzle that TMA writes and the wgmma
// descriptors read. A tile is K-major for an operand whose contraction runs
// along hd, MN-major ("transposed") for one whose contraction runs along its
// rows. An hd that is not a multiple of 64 (112: zamba2's shared block) is
// padded to whole panels (224, Zamba2-7B's shared blocks: four panels, 256
// wide): the tensor map knows the true hd, so TMA fills the
// last panel's columns past it with zeros on a load and clips them on a
// store. A product that contracts over hd runs hd / 16 k-steps and never
// reads the pad; one whose N is hd runs at the padded width, and its pad
// columns, zero products of zero columns, are never stored.
#pragma once

#include <cuda.h>          // CUtensorMap and its enums; libcuda is not linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// element strides of one (batch, head, row, hd) view; hd's stride is 1
struct Strides {
  long long b, h, s;
};

namespace hopper {

constexpr int kTileRows = 64;              // rows of a tile: one m64
constexpr int kPanel = 64;                 // bf16 columns per 128-byte row
constexpr int kRowBytes = 128;             // one swizzled row of a panel
constexpr int kTensorMapError = 10000;     // + the CUresult of a refused map

// the columns a tile of hd columns takes in shared memory and in a wgmma
// accumulator: whole 64-column panels (64 -> 64, 112 -> 128, 128 -> 128,
// 224 -> 256)
__host__ __device__ constexpr int padded_hd(int hd) {
  return (hd + kPanel - 1) / kPanel * kPanel;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// returns once the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// box at coordinates (hd, row, head, batch) of `map` into shared memory at
// `dst`, completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// `bytes` (a multiple of 16) of contiguous global memory at `src` (16-byte
// aligned) into shared memory at `dst`, completing on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// the issuing thread's TMA stores, committed and read out of shared memory
__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// generic-proxy writes to shared memory, visible to a following TMA store
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// named barrier `id` over `threads` threads (id 0 is __syncthreads')
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// a warpgroup's register budget: every warp of it runs this together
template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(N));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keeps the compiler from touching wgmma registers across the async window
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// wgmma shared-memory descriptor of an operand laid out with the 128-byte
// swizzle: start address, leading and stride byte offsets (16-byte units),
// layout type 1 (128B) in bits 62-63; base offset 0, since every swizzle
// atom (8 rows of 128 bytes) starts 1024-aligned
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(1) << 62;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&t);
}

// S[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// O[64 x 64] += P[64 x 16] V[16 x 64], P in registers, V MN-major in
// shared memory
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// O[64 x 128] += P[64 x 16] V[16 x 128], P in registers, V MN-major in
// shared memory
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int HD>
__device__ __forceinline__ void wgmma_rs(float (&o)[HD / 2],
                                         const uint32_t (&a)[4], uint64_t b);
template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&o)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  wgmma_rs_n64(o, a, b);
}
template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&o)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  wgmma_rs_n128(o, a, b);
}
// n256 as two n128 products: accumulator registers 64.. hold columns 128..
// in the n256 fragment layout, and their V columns start two panels on
// (the descriptor's start address, in 16-byte units, moves by 2 x 8 KB)
template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&o)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  wgmma_rs_n128(*reinterpret_cast<float(*)[64]>(&o[0]), a, b);
  wgmma_rs_n128(*reinterpret_cast<float(*)[64]>(&o[64]), a,
                b + ((2 * kTileRows * kRowBytes) >> 4));
}

// issues and commits C[64 x 64] = A B^T for two tiles A, B (rows x hd,
// both K-major): hd / 16 k-steps, each advancing 32 bytes along a swizzled
// row and to the next panel every 4 steps
template <int HD>
__device__ __forceinline__ void issue_abt(float (&c)[kTileRows / 2],
                                          uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t col = (kk % 4) * 32;   // 16 columns: 32 bytes
    wgmma_ss_n64(c,
                 desc_sw128(a + (kk / 4) * kTileRows * kRowBytes + col, 16,
                            1024),
                 desc_sw128(b + (kk / 4) * kTileRows * kRowBytes + col, 16,
                            1024),
                 kk > 0);
  }
  wgmma_commit();
}

// issues and commits C[64 x hd] += P X for P (64 x 64) in registers as the
// A fragments of 4 k-steps and a tile X (64 rows x hd) MN-major: 16 rows
// per k-step, LBO steps between the hd panels, SBO between groups of 8 rows
template <int HD>
__device__ __forceinline__ void issue_pb(float (&c)[HD / 2],
                                         const uint32_t (&pa)[kTileRows / 16][4],
                                         uint32_t x) {
#pragma unroll
  for (int kk = 0; kk < kTileRows / 16; ++kk)
    wgmma_rs<HD>(c, pa[kk], desc_sw128(x + kk * 16 * kRowBytes,
                                       kTileRows * kRowBytes, 1024));
  wgmma_commit();
}

// Fragment layouts (PTX ISA, wgmma m64nNk16): in a warpgroup, warp w holds
// rows 16w + lane/4 and 16w + lane/4 + 8 of its 64; accumulator register i
// is at row + 8 * ((i / 2) % 2), column 8 * (i / 4) + 2 * (lane % 4) + i %
// 2. The bf16 A fragment of k-step kk (columns 16kk..16kk+15) is {i, i + 1}
// packed for i = 8kk, 8kk + 2, 8kk + 4, 8kk + 6: the accumulator fragment
// itself, so a 64 x 64 result feeds the next product from registers with no
// shuffle.
__device__ __forceinline__ void to_a_fragments(
    const float (&c)[kTileRows / 2], uint32_t (&pa)[kTileRows / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kTileRows / 16; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      pa[kk][j] = pack_bf16(c[8 * kk + 2 * j], c[8 * kk + 2 * j + 1]);
}

// a warpgroup's 64 x hd accumulator times mul[r] (r = 0 for a thread's
// first row, 1 for its row + 8), rounded to bf16 into a tile at `tile` in
// the swizzled panel layout, ready for a TMA store; warp is the warp's
// index in its warpgroup
template <int HD>
__device__ __forceinline__ void write_tile(uint8_t* tile,
                                           const float (&acc)[HD / 2],
                                           const float (&mul)[2], int warp,
                                           int lane) {
#pragma unroll
  for (int i = 0; i < HD / 2; i += 2) {
    const int rr = 16 * warp + lane / 4 + 8 * ((i / 2) % 2);
    const int c = 8 * (i / 4) + 2 * (lane % 4);
    const int cc = c % kPanel;
    const int off = (c / kPanel) * kTileRows * kRowBytes + rr * kRowBytes +
                    (((cc / 8) ^ (rr % 8)) * 16) + (cc % 8) * 2;
    const float f = mul[(i / 2) % 2];
    *reinterpret_cast<uint32_t*>(tile + off) =
        pack_bf16(acc[i] * f, acc[i + 1] * f);
  }
}

// cuTensorMapEncodeTiled, fetched through the runtime (libcuda is not
// linked)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A map of the bf16 (B, N, S, hd) view at `ptr` with element strides `st`,
// cut into boxes of 64 hd columns (one 128-byte swizzle row) by `rows` rows.
// Rows past S, and columns past hd in a box that straddles it, read as zeros
// and are not written. A box's transaction bytes are the whole box's, the
// zero fill included. Returns 0 or the CUresult of the refusal.
inline int make_map(CUtensorMap* map, const void* ptr, const Strides& st,
                    int B, int N, int S, int hd, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(CUDA_ERROR_NOT_FOUND);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(N),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st.s) * 2,
                                 static_cast<cuuint64_t>(st.h) * 2,
                                 static_cast<cuuint64_t>(st.b) * 2};
  const cuuint32_t box[4] = {kPanel, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return static_cast<int>(encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE));
}

}  // namespace hopper
