// The optimizer's two passes over a parameter tree for Hopper (sm_90a), each
// one launch over every leaf:
//   sumsq_kernel + sumsq_finish_kernel: gn = sqrt(sum over the leaves of
//     sum(g^2)), the gradients' global norm, as a 0-d fp32 device tensor;
//   adamw_kernel: AdamW in place, m = b1 m + (1 - b1) g, v = b2 v + (1 -
//     b2) g g, p += -lr ((m / bc1) / (sqrt(v / bc2) + eps) [+ wd p]), with g
//     the gradient times the clip factor.
//
// Replaces no Pallas kernel: the JAX package's AdamW and global norm are
// plain jnp (src/repro/optim/optimizers.py), which XLA fuses. The port's
// plain versions are repro_torch/optim/optimizers.py's global_norm_plain (a
// sum per leaf) and adamw_plain_ (per leaf, per slice of 2^26 elements,
// some 19 PyTorch operations, each a pass over fp32 temporaries: about 130
// bytes of traffic a parameter).
//
// What bounds them: bytes. The update must read g, p, m and v and write p, m
// and v: 22 bytes a parameter for bf16 params and gradients with fp32 m and
// v (2 + 2 + 4 + 4 read, 2 + 4 + 4 written); the norm must read g, 2 bytes.
// At the MoE training cut's 3.19 B parameters that is 70.3 GB, 21.0 ms at
// 3.35 TB/s, and 6.4 GB, 1.9 ms. A handful of fp32 operations an element
// (three divisions and a square root, correctly rounded) stays below that.
//
// Design: each byte moves once. The wrapper (kernels/adamw.py) cuts every
// leaf into chunks of kChunk elements, the last one ragged, numbers them
// leaf after leaf, and hands the leaves (pointers, length, first chunk,
// dtypes) to the kernel as a __grid_constant__ parameter: no table is
// copied to the card, nothing waits for the host, and a launch replays in a
// CUDA graph. A persistent grid (every block resident at once, from the
// occupancy API) walks the chunks round robin, block b taking chunks b, b +
// grid, ...; a thread takes 8 elements at once as 16-byte loads of each
// tensor (one of a bf16 tensor, two of an fp32 one), computes in registers
// and stores p, m and v in place, with a scalar loop for a leaf's ragged
// tail. Leaves must be contiguous and 16-byte aligned; a chunk starts at a
// multiple of 8 elements, so every vector is aligned.
//
// The update gives the plain version's bits: every fp32 operation is
// rounded on its own, in the plain version's order (__fmul_rn, __fadd_rn,
// __fdiv_rn, __fsqrt_rn: no FMA contraction), the Python scalars b1, 1 - b1,
// b2, 1 - b2, eps and wd arrive rounded to fp32 as PyTorch rounds them, and
// for bf16 params -lr u is rounded to bf16, added in fp32 and the sum
// rounded again (to nearest even), as `(-lr * u).to(bf16)` and a bf16 add_
// do. The norm sums in another order than torch.sum: squares in fp32 within
// a chunk's share of a thread, those in fp64 per thread, then a fixed tree
// over the block and a second one-block launch over the blocks' partials,
// in fixed order. No atomics: two calls give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxLeaves = 64;    // leaves a launch takes
constexpr int kChunk = 1 << 16;   // elements of a chunk; a multiple of kVec
constexpr int kVec = 8;           // elements a thread takes at once
constexpr int kThreads = 256;     // threads of a block

// One leaf: its gradient g and, for the update, its param p and fp32
// moments m and v, all of n elements.
struct Leaf {
  const void* g;
  void* p;
  float* m;
  float* v;
  long long n;
  int first;   // its first chunk
  int kinds;   // bit 0: g is bf16 (else fp32); bit 1: p is bf16
};
static_assert(sizeof(Leaf) == 48, "Leaf must match kernels/adamw.py's _Leaf");

struct Table {
  Leaf leaf[kMaxLeaves];
  int n_leaves;
  int n_chunks;
};
static_assert(sizeof(Table) < 4000, "a kernel parameter holds 4 KB");

// the update's scalars: lr, bc1, bc2 and the clip factor (null: none) on the
// card, lr given as a value when its pointer is null
struct Hyper {
  const float* lr;
  const float* bc1;
  const float* bc2;
  const float* scale;
  float lr_value, b1, c1, b2, c2, eps, wd;
  int decay;
};

struct Coef {
  float neg_lr, bc1, bc2, scale, b1, c1, b2, c2, eps, wd;
  bool has_scale, decay;
};

__device__ __forceinline__ void load8(const float* src, float (&x)[kVec]) {
  const float4 a = reinterpret_cast<const float4*>(src)[0];
  const float4 b = reinterpret_cast<const float4*>(src)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* src,
                                      float (&x)[kVec]) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < kVec / 2; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    x[2 * k] = f.x;
    x[2 * k + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* dst, const float (&x)[kVec]) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(x[4], x[5], x[6], x[7]);
}

// x holds values already rounded to bf16, so the conversion is exact
__device__ __forceinline__ void store8(__nv_bfloat16* dst,
                                       const float (&x)[kVec]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < kVec / 2; ++k)
    h[k] = __floats2bfloat162_rn(x[2 * k], x[2 * k + 1]);
  *reinterpret_cast<uint4*>(dst) = u;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// one element of the update, in the plain version's order of operations
template <bool kBf16P>
__device__ __forceinline__ void adamw_elem(float g, float& p, float& m,
                                           float& v, const Coef& c) {
  if (c.has_scale) g = __fmul_rn(g, c.scale);
  m = __fadd_rn(__fmul_rn(c.b1, m), __fmul_rn(c.c1, g));
  v = __fadd_rn(__fmul_rn(c.b2, v), __fmul_rn(c.c2, __fmul_rn(g, g)));
  float u = __fdiv_rn(__fdiv_rn(m, c.bc1),
                      __fadd_rn(__fsqrt_rn(__fdiv_rn(v, c.bc2)), c.eps));
  if (c.decay) u = __fadd_rn(u, __fmul_rn(c.wd, p));
  const float d = __fmul_rn(c.neg_lr, u);
  p = kBf16P ? round_bf16(__fadd_rn(p, round_bf16(d))) : __fadd_rn(p, d);
}

template <typename TG, typename TP>
__device__ __forceinline__ void adamw_chunk(const Leaf& leaf, long long off,
                                            int len, const Coef& c) {
  constexpr bool kBf16P = sizeof(TP) == 2;
  const TG* __restrict__ g = static_cast<const TG*>(leaf.g) + off;
  TP* __restrict__ p = static_cast<TP*>(leaf.p) + off;
  float* __restrict__ m = leaf.m + off;
  float* __restrict__ v = leaf.v + off;
  const int n_vec = len / kVec;
  for (int i = threadIdx.x; i < n_vec; i += kThreads) {
    const int e = i * kVec;
    float gx[kVec], px[kVec], mx[kVec], vx[kVec];
    load8(g + e, gx);
    load8(p + e, px);
    load8(m + e, mx);
    load8(v + e, vx);
#pragma unroll
    for (int k = 0; k < kVec; ++k)
      adamw_elem<kBf16P>(gx[k], px[k], mx[k], vx[k], c);
    store8(p + e, px);
    store8(m + e, mx);
    store8(v + e, vx);
  }
  for (int e = n_vec * kVec + threadIdx.x; e < len; e += kThreads) {
    float px = to_float(p[e]), mx = m[e], vx = v[e];
    adamw_elem<kBf16P>(to_float(g[e]), px, mx, vx, c);
    p[e] = from_float<TP>(px);
    m[e] = mx;
    v[e] = vx;
  }
}

// The chunk's leaf, from the block's last one (a block's chunks rise), its
// offset in the leaf and its length: kernels/adamw.py::chunk_table.
__device__ __forceinline__ int chunk_leaf(const Table& t, int chunk,
                                          int leaf) {
  while (leaf + 1 < t.n_leaves && chunk >= t.leaf[leaf + 1].first) ++leaf;
  return leaf;
}

__device__ __forceinline__ void chunk_span(const Leaf& leaf, int chunk,
                                           long long* off, int* len) {
  *off = static_cast<long long>(chunk - leaf.first) * kChunk;
  const long long rest = leaf.n - *off;
  *len = static_cast<int>(rest < kChunk ? rest : kChunk);
}

__global__ void __launch_bounds__(kThreads)
    adamw_kernel(const __grid_constant__ Table t, const Hyper h) {
  Coef c;
  c.neg_lr = -(h.lr ? *h.lr : h.lr_value);
  c.bc1 = *h.bc1;
  c.bc2 = *h.bc2;
  c.has_scale = h.scale != nullptr;
  c.scale = c.has_scale ? *h.scale : 1.f;
  c.b1 = h.b1;
  c.c1 = h.c1;
  c.b2 = h.b2;
  c.c2 = h.c2;
  c.eps = h.eps;
  c.wd = h.wd;
  c.decay = h.decay != 0;
  int leaf = 0;
  for (int chunk = blockIdx.x; chunk < t.n_chunks; chunk += gridDim.x) {
    leaf = chunk_leaf(t, chunk, leaf);
    const Leaf& L = t.leaf[leaf];
    long long off;
    int len;
    chunk_span(L, chunk, &off, &len);
    switch (L.kinds) {
      case 0: adamw_chunk<float, float>(L, off, len, c); break;
      case 1: adamw_chunk<__nv_bfloat16, float>(L, off, len, c); break;
      case 2: adamw_chunk<float, __nv_bfloat16>(L, off, len, c); break;
      default: adamw_chunk<__nv_bfloat16, __nv_bfloat16>(L, off, len, c);
    }
  }
}

// a thread's sum of squares over its elements of one chunk, in fp32
template <typename TG>
__device__ __forceinline__ float sumsq_chunk(const Leaf& leaf, long long off,
                                             int len) {
  const TG* __restrict__ g = static_cast<const TG*>(leaf.g) + off;
  const int n_vec = len / kVec;
  float acc = 0.f;
  for (int i = threadIdx.x; i < n_vec; i += kThreads) {
    float gx[kVec];
    load8(g + i * kVec, gx);
#pragma unroll
    for (int k = 0; k < kVec; ++k) acc = fmaf(gx[k], gx[k], acc);
  }
  for (int e = n_vec * kVec + threadIdx.x; e < len; e += kThreads) {
    const float x = to_float(g[e]);
    acc = fmaf(x, x, acc);
  }
  return acc;
}

// the sum over a block's threads, in a fixed tree; valid in thread 0
template <int kN>
__device__ __forceinline__ double block_sum(double x) {
  __shared__ double warp_sums[kN / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    x = lane < kN / 32 ? warp_sums[lane] : 0.0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  }
  return x;
}

__global__ void __launch_bounds__(kThreads)
    sumsq_kernel(const __grid_constant__ Table t, double* partial) {
  double total = 0.0;
  int leaf = 0;
  for (int chunk = blockIdx.x; chunk < t.n_chunks; chunk += gridDim.x) {
    leaf = chunk_leaf(t, chunk, leaf);
    const Leaf& L = t.leaf[leaf];
    long long off;
    int len;
    chunk_span(L, chunk, &off, &len);
    total += (L.kinds & 1) ? sumsq_chunk<__nv_bfloat16>(L, off, len)
                           : sumsq_chunk<float>(L, off, len);
  }
  total = block_sum<kThreads>(total);
  if (threadIdx.x == 0) partial[blockIdx.x] = total;
}

__global__ void __launch_bounds__(kThreads)
    sumsq_finish_kernel(const double* partial, int n, float* gn) {
  double total = 0.0;
  for (int i = threadIdx.x; i < n; i += kThreads) total += partial[i];
  total = block_sum<kThreads>(total);
  if (threadIdx.x == 0) *gn = static_cast<float>(sqrt(total));
}

// The table of leaves [0, n_leaves), each chunk numbered as chunk_table
// numbers them; false if it is not.
bool make_table(const Leaf* leaves, int n_leaves, int n_chunks, Table* t) {
  if (n_leaves <= 0 || n_leaves > kMaxLeaves || n_chunks <= 0) return false;
  long long next = 0;
  for (int i = 0; i < n_leaves; ++i) {
    const Leaf& L = leaves[i];
    if (L.n <= 0 || L.first != next || L.kinds < 0 || L.kinds > 3 ||
        L.g == nullptr)
      return false;
    next += (L.n + kChunk - 1) / kChunk;
    t->leaf[i] = L;
  }
  t->n_leaves = n_leaves;
  t->n_chunks = n_chunks;
  return next == n_chunks;
}

int blocks_per_sm(const void* kernel) {
  int n = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, 0);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

}  // namespace

extern "C" {

// Blocks of sumsq_kernel (which 0) or adamw_kernel (1) an SM holds at once
// (negative: the CUDA error). The wrapper's grid is this times the SMs, at
// most one block a chunk, so that every block is resident.
int adamw_blocks_per_sm(int which) {
  return which == 0 ? blocks_per_sm(reinterpret_cast<const void*>(sumsq_kernel))
                    : blocks_per_sm(reinterpret_cast<const void*>(adamw_kernel));
}

// partial[b] = the sum of squares of block b's chunks, b < grid; leaves is
// an array of n_leaves Leaf (the signatures take void pointers: a type of
// the unnamed namespace would make the symbol local).
int sumsq_partials(const void* leaves, int n_leaves, int n_chunks, int grid,
                   void* partial, void* stream) {
  Table t;
  if (grid <= 0 || grid > n_chunks ||
      !make_table(static_cast<const Leaf*>(leaves), n_leaves, n_chunks, &t))
    return static_cast<int>(cudaErrorInvalidValue);
  sumsq_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      t, static_cast<double*>(partial));
  return static_cast<int>(cudaGetLastError());
}

// *gn = sqrt of the sum of partial[0, n) (n >= 0), in fixed order.
int sumsq_finish(const void* partial, int n, void* gn, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  sumsq_finish_kernel<<<1, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(partial), n, static_cast<float*>(gn));
  return static_cast<int>(cudaGetLastError());
}

// The AdamW step in place over the leaves; lr (or lr_value when lr is
// null), bc1, bc2 and scale (null: none) are fp32 on the card.
int adamw_step(const void* leaves, int n_leaves, int n_chunks, int grid,
               const void* lr, float lr_value, const void* bc1,
               const void* bc2, const void* scale, float b1, float c1,
               float b2, float c2, float eps, float wd, int decay,
               void* stream) {
  Table t;
  if (grid <= 0 || grid > n_chunks || bc1 == nullptr || bc2 == nullptr ||
      !make_table(static_cast<const Leaf*>(leaves), n_leaves, n_chunks, &t))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < n_leaves; ++i)
    if (!t.leaf[i].p || !t.leaf[i].m || !t.leaf[i].v)
      return static_cast<int>(cudaErrorInvalidValue);
  const Hyper h{static_cast<const float*>(lr), static_cast<const float*>(bc1),
                static_cast<const float*>(bc2),
                static_cast<const float*>(scale),
                lr_value, b1, c1, b2, c2, eps, wd, decay};
  adamw_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(t, h);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
