// RMSNorm over the rows of an (N, d) tensor for Hopper (sm_90a), alone and
// fused with the residual add before it:
//   rmsnorm:      y = x * rsqrt(mean(x^2) + eps) * scale
//   add_rmsnorm:  s = x + delta (rounded to x's type, as a torch add rounds
//                 it), y = rmsnorm(s) computed from that rounded s
// in fp32, with y cast back to x's type.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rmsnorm.py::_rmsnorm_kernel.
// The model runs one norm after every residual add: add_rmsnorm for the
// norm after the attention add, the next block's norm after the MLP add and
// the final norm; plain rmsnorm only for the first block's first norm
// (models/transformer.py).
//
// What bounds it: rmsnorm reads x and writes y once, add_rmsnorm reads x and
// delta and writes s and y once, with a few fp32 operations per element, so
// both are memory-bound: at the prefill shape (2048, 3072) bf16
// add_rmsnorm moves 50.3 MB, 15 us at 3.35 TB/s. At the decode shape
// (4, 3072) it moves 98 KB, and the launch sets the time; there the decode
// step runs under a CUDA graph (serve/engine.py), so the launch is the
// graph's, and fusing the add removes one launch and one round trip of the
// residual row per norm.
//
// Design: one block per row, one pass. Each thread loads its share of the
// row and of scale into registers (PPT packs, pack i = thread + k *
// blockDim.x), adds delta there and writes s, sums the squares in fp32
// (its packs in order, then warp shuffles, then one warp over the per-warp
// partials in shared memory), and scales the packs it holds. Each element of x and delta is
// read from device memory once. At d = 3072 in bf16 a row is 384 16-byte
// packs: 128 threads of 3 packs. Both kernels are one template, so for one
// (N, d) the plain kernel sums in the same order as the fused one: the
// fused kernel's y equals rmsnorm(x + delta) bit for bit. A pack is 16
// bytes (4 fp32 or 8 bf16) when d is a multiple of it and every pointer is
// 16-byte aligned, else one element, so any d up to kMaxPPT * 1024 packs is
// taken. Any N is taken: the grid has one block per row.
//
// Backward (the Pallas kernel has none; the JAX package differentiates its
// jnp norm): per row, with r = rsqrt(mean(x^2) + eps), xhat = x r, w =
// scale and dy the upstream gradient of y,
//   dx = r (dy w - xhat mean(dy w xhat)),   dscale = sum_rows dy xhat,
// in fp32; the add variant takes s (the saved x + delta) for x and adds the
// upstream gradient g_s of s, so d_s = g_s + dx, the gradient of both x and
// delta, is rounded once.
//
// What bounds it: x (or s), dy and g_s read and dx written once: at (2048,
// 3072) bf16 37.7 MB (11.3 us at 3.35 TB/s), the add variant 50.3 MB (15.0
// us). Rows are independent but dscale sums over all of them, so the
// blocks must meet once, and that meeting is on the critical path.
//
// Design (norm_bwd_kernel), one launch: a persistent grid of one block of
// 512 threads an SM (rmsnorm.py::bwd_grid; cut by the kernel to what fits
// at once, should that be less), each block four 128-thread teams at d =
// 3072, a team a row with the forward's packs per thread (83 and 88
// registers a thread in ptxas of CUDA 12.8, no spills); a team's warps
// meet at a named barrier of their own, so a block reduces four rows at
// once. A thread copies the
// packs of its team's next row into a two-stage ring in shared memory with
// cp.async while it reduces the current one, and waits only for its own
// copies; x, dy and g_s are read from device memory once. dy xhat is summed
// per thread in registers over the team's rows, then over the teams, into
// one fp32 row a block; after a grid barrier (the launch is cooperative, so
// every block is resident; its counter resets itself, so the launch
// replays in a CUDA graph) every block sums its slice of columns over the
// blocks' rows, in row order and a fixed tree: no float atomics, one order
// for a given grid, two launches with the same bits.
// Why a barrier and not a chain of last-arriving blocks: a tree of groups
// puts several dependent round trips to L2 (a fence, an atomic, the
// group's rows) after the slowest block; the barrier puts one, shared by
// every block. Why teams: with one 384-thread row a block, an SM reduced
// only one or two rows at once.
// Shared memory: 4,608 static bytes and the teams' rings, 4 x 2 x 2 (the
// add variant 3) rows of d, 98,304 (147,456) bytes at d = 3072 in bf16.
// Measured (chip_smoke.py; NVIDIA H100 80GB HBM3, 700.00 W), bf16: at
// (2048, 3072) 0.0219 ms, 51% of its 0.0113 ms bound, against F.rms_norm's
// backward at 0.0287 and the parent's two launches at 0.0304 + 0.0036; the
// add variant 0.0281, 53% of its 0.0150 ms bound; at (2048, 256) 0.0086
// and 0.0085.

#include "hopper.cuh"   // named_sync

#include <cstdint>

namespace {

using hopper::named_sync;

constexpr int kMaxThreads = 1024;
constexpr int kBaseThreads = 128;  // threads per row while PPT <= kMaxPPT
constexpr int kMaxPPT = 8;         // packs per thread held in registers
constexpr int kBwdBlock = 512;       // the backward's block: whole rows
constexpr int kStages = 2;           // rows a team holds: current and next
constexpr int kMaxBwdThreads = 512;  // a row's threads at most, 16-byte packs

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

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int mask = 16; mask > 0; mask >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, mask);
  return s;
}

// ADD: s = x + delta is written to s_out and normed; else x is normed.
template <typename T, int VEC, int PPT, bool ADD>
__global__ void __launch_bounds__(kMaxThreads)
    norm_kernel(const T* __restrict__ x, const T* __restrict__ delta,
                const T* __restrict__ scale, T* __restrict__ s_out,
                T* __restrict__ y, int d, float eps) {
  using P = Pack<T, VEC>;
  const int n_pack = d / VEC;
  const size_t row = static_cast<size_t>(blockIdx.x) * d;
  const P* xr = reinterpret_cast<const P*>(x + row);
  const P* sr = reinterpret_cast<const P*>(scale);
  P* yr = reinterpret_cast<P*>(y + row);

  P v[PPT], sc[PPT];
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    if (i < n_pack) {
      sc[k] = sr[i];  // loaded now, so its latency hides under the sum's
      v[k] = xr[i];
      if constexpr (ADD) {
        const P b = reinterpret_cast<const P*>(delta + row)[i];
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          v[k].v[e] = from_f32<T>(to_f32(v[k].v[e]) + to_f32(b.v[e]));
        reinterpret_cast<P*>(s_out + row)[i] = v[k];
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float f = to_f32(v[k].v[e]);
        ss += f * f;
      }
    }
  }
  __shared__ float partial[kMaxThreads / 32];
  __shared__ float rstd;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  ss = warp_sum(ss);
  if (lane == 0) partial[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    ss = lane < static_cast<int>(blockDim.x >> 5) ? partial[lane] : 0.f;
    ss = warp_sum(ss);
    if (lane == 0) rstd = rsqrtf(ss / static_cast<float>(d) + eps);
  }
  __syncthreads();
  const float r = rstd;
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    if (i < n_pack) {
      P o;
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        o.v[e] = from_f32<T>(to_f32(v[k].v[e]) * r * to_f32(sc[k].v[e]));
      yr[i] = o;
    }
  }
}

// dscale[c] = the sum over the blocks of their acc[c], in one order for a
// given grid. Each block writes its acc as row blockIdx.x of `scratch`
// (n_blocks x d fp32) and waits at a grid barrier; then block b sums the
// columns of slice b, [b w, (b + 1) w) for w = ceil(d / n_blocks), over
// all n rows: its threads are (row lane, column) pairs, the column
// fastest, so that a warp reads whole runs of a row; lane l sums rows l,
// l + R, ... in order, and the R lanes of a column meet in a fixed tree in
// shared memory. So every block shares the last step, and two launches give
// the same bits. The launch is cooperative: every block is resident at
// once, or the launch is refused.
// The barrier: counters[0] counts arrivals and counters[kGenWord] (on
// another cache line) is a generation number; the last block to arrive
// sets counters[0] back to 0 (so the launch can be replayed, as from a
// CUDA graph) and then moves the generation on, which the others wait for.
constexpr int kGenWord = 32;

__device__ void grid_barrier(unsigned* counters) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned* gen = counters + kGenWord;
    const unsigned seen = *gen;
    // this block's stores, then its arrival: thread 0's fence after the
    // barrier orders every thread's stores (the fence is cumulative)
    __threadfence();
    if (atomicAdd(counters, 1u) == gridDim.x - 1) {
      counters[0] = 0u;
      __threadfence();
      atomicAdd(counters + kGenWord, 1u);
    } else {
      while (*gen == seen) __nanosleep(32);
    }
    __threadfence();   // the other blocks' rows, before this block's reads
  }
  __syncthreads();
}

template <typename T>
__device__ void reduce_dscale(const float* acc, float* scratch,
                              unsigned* counters, T* dscale, int n, int d) {
  if (n == 1) {   // one block: its acc is dscale
    for (int c = threadIdx.x; c < d; c += blockDim.x)
      dscale[c] = from_f32<T>(acc[c]);
    return;
  }
  float* row = scratch + static_cast<size_t>(blockIdx.x) * d;
  for (int c = threadIdx.x; c < d; c += blockDim.x) row[c] = acc[c];
  grid_barrier(counters);
  __shared__ float part[kMaxThreads];
  const int w = (d + n - 1) / n;
  const int lo = min(d, static_cast<int>(blockIdx.x) * w);
  const int hi = min(d, lo + w);
  const int nt = blockDim.x;
  for (int c0 = lo; c0 < hi; c0 += nt) {
    const int cw = min(hi - c0, nt);
    int lanes = 1;   // row lanes: a power of 2, lanes x cw <= threads
    while (2 * lanes * cw <= nt) lanes *= 2;
    const int c = threadIdx.x % cw, rl = threadIdx.x / cw;
    __syncthreads();   // part is free
    if (rl < lanes) {
      float t = 0.f;
#pragma unroll 4
      for (int r = rl; r < n; r += lanes)
        t += __ldcg(scratch + static_cast<size_t>(r) * d + c0 + c);
      part[rl * cw + c] = t;
    }
    for (int half = lanes / 2; half > 0; half /= 2) {
      __syncthreads();
      if (rl < half) part[rl * cw + c] += part[(rl + half) * cw + c];
    }
    __syncthreads();
    if (static_cast<int>(threadIdx.x) < cw)
      dscale[c0 + threadIdx.x] = from_f32<T>(part[threadIdx.x]);
  }
}

// one pack of a row into this thread's slot of the shared ring: cp.async
// for a 16-byte pack (it lands while the thread works on the row before),
// a plain copy otherwise
template <typename T, int VEC>
__device__ __forceinline__ void copy_pack(T* dst, const T* src) {
  if constexpr (sizeof(T) * VEC == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                     static_cast<unsigned>(__cvta_generic_to_shared(dst))),
                 "l"(src)
                 : "memory");
  } else {
    *reinterpret_cast<Pack<T, VEC>*>(dst) =
        *reinterpret_cast<const Pack<T, VEC>*>(src);
  }
}

// The backward, one launch. A persistent grid of blocks, each of `teams`
// teams of tpt threads, one row's worth (a team's warps meet at a named
// barrier of their own); a team walks rows team_id, team_id + teams in
// all, ...: so a block reduces several rows at once, while its sums of
// dscale are one partial row. Each
// thread copies the packs of the team's next row (x or s, dy and, ADD,
// g_s) into its own slots of a two-stage ring in shared memory with
// cp.async while it reduces and writes the current row, and waits only for
// its own copies (cp.async.wait_group): no barrier guards the ring. ADD:
// g_s (the upstream gradient of s) is added to dx before its one rounding.
// Each thread sums dy xhat for the columns of its packs in registers; at
// the end the teams' sums are added in team order, and dscale is reduced
// across the blocks (reduce_dscale).
template <typename T, int VEC, int PPT, bool ADD>
__global__ void __launch_bounds__(VEC == 1 ? kMaxThreads : kMaxBwdThreads)
    norm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                    const T* __restrict__ dy, const T* __restrict__ g_s,
                    T* __restrict__ dx, float* __restrict__ scratch,
                    unsigned* __restrict__ counters, T* __restrict__ dscale,
                    int N, int d, int tpt, float eps) {
  using P = Pack<T, VEC>;
  constexpr int kTensors = ADD ? 3 : 2;
  const int n_pack = d / VEC;
  const int teams = blockDim.x / tpt;   // tpt: threads a team, a row's
  const int team = threadIdx.x / tpt, tt = threadIdx.x % tpt;
  extern __shared__ float4 smem4[];
  // this team's ring: stage s, tensor j at ring + (s * kTensors + j) * d
  T* ring = reinterpret_cast<T*>(smem4) + team * kStages * kTensors * d;
  const P* sr = reinterpret_cast<const P*>(scale);
  P sc[PPT];
  float acc[PPT][VEC];   // this thread's columns of sum dy xhat
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int i = tt + k * tpt;
    if (i < n_pack) sc[k] = sr[i];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[k][e] = 0.f;
  }
  auto issue = [&](int n, int s) {
    const size_t row = static_cast<size_t>(n) * d;
    T* st = ring + s * kTensors * d;
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const int i = tt + k * tpt;
      if (i < n_pack) {
        copy_pack<T, VEC>(st + i * VEC, x + row + i * VEC);
        copy_pack<T, VEC>(st + d + i * VEC, dy + row + i * VEC);
        if constexpr (ADD)
          copy_pack<T, VEC>(st + 2 * d + i * VEC, g_s + row + i * VEC);
      }
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
  __shared__ float2 red[kMaxThreads / 32];
  __shared__ float2 tot[kMaxThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int team_warps = tpt >> 5, first_warp = team * team_warps;
  const int stride = gridDim.x * teams;
  int n = blockIdx.x * teams + team;
  // rows n, n + stride, ... alternate between the two stages: the next
  // row is in flight while this one is reduced; a group is committed for
  // every row slot, empty past N, so that waiting for all but the newest
  // group is waiting for the current row
  if (n < N) issue(n, 0);
  for (int s = 0; n < N; n += stride, s ^= 1) {
    if (n + stride < N)
      issue(n + stride, s ^ 1);
    else
      asm volatile("cp.async.commit_group;" ::: "memory");
    asm volatile("cp.async.wait_group 1;" ::: "memory");
    const T* xs = ring + s * kTensors * d;
    float ss = 0.f, sd = 0.f;   // sum x^2, sum dy w x
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const int i = tt + k * tpt;
      if (i < n_pack) {
        const P v = *reinterpret_cast<const P*>(xs + i * VEC);
        const P g = *reinterpret_cast<const P*>(xs + d + i * VEC);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float f = to_f32(v.v[e]);
          ss += f * f;
          sd += to_f32(g.v[e]) * to_f32(sc[k].v[e]) * f;
        }
      }
    }
    ss = warp_sum(ss);
    sd = warp_sum(sd);
    if (team_warps > 1) {   // the team's warps meet at its own barrier
      if (lane == 0) red[warp] = make_float2(ss, sd);
      named_sync(1 + team, tpt);
      if (warp == first_warp) {
        float2 t = lane < team_warps ? red[first_warp + lane]
                                     : make_float2(0.f, 0.f);
        t.x = warp_sum(t.x);
        t.y = warp_sum(t.y);
        if (lane == 0) tot[team] = t;
      }
      named_sync(1 + team, tpt);
      ss = tot[team].x;
      sd = tot[team].y;
    }
    const float r = rsqrtf(ss / static_cast<float>(d) + eps);
    // mean(dy w xhat) = r sum(dy w x) / d
    const float c = r * sd / static_cast<float>(d);
    const size_t row = static_cast<size_t>(n) * d;
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const int i = tt + k * tpt;
      if (i < n_pack) {
        const P v = *reinterpret_cast<const P*>(xs + i * VEC);
        const P g = *reinterpret_cast<const P*>(xs + d + i * VEC);
        P gs;
        if constexpr (ADD) gs = *reinterpret_cast<const P*>(xs + 2 * d + i * VEC);
        P o;
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float xh = to_f32(v.v[e]) * r;
          const float gy = to_f32(g.v[e]);
          float t = r * (gy * to_f32(sc[k].v[e]) - xh * c);
          if constexpr (ADD) t = to_f32(gs.v[e]) + t;
          o.v[e] = from_f32<T>(t);
          acc[k][e] += gy * xh;
        }
        reinterpret_cast<P*>(dx + row)[i] = o;
      }
    }
  }
  // the teams' sums, as rows of d floats over the ring
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  __syncthreads();
  float* block_acc = reinterpret_cast<float*>(smem4);
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int i = tt + k * tpt;
    if (i < n_pack) {
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        block_acc[team * d + i * VEC + e] = acc[k][e];
    }
  }
  __syncthreads();
  if (teams > 1) {
    for (int col = threadIdx.x; col < d; col += blockDim.x) {
      float t = block_acc[col];
      for (int j = 1; j < teams; ++j) t += block_acc[j * d + col];
      block_acc[col] = t;
    }
    __syncthreads();
  }
  reduce_dscale<T>(block_acc, scratch, counters, dscale, gridDim.x, d);
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// Launch one row per block: kBaseThreads threads while the row fits in
// kMaxPPT packs each, more (a multiple of 32, at most kMaxThreads) beyond.
template <typename T, int VEC, bool ADD>
int launch_packs(const void* x, const void* delta, const void* scale,
                 void* s_out, void* y, int N, int d, float eps,
                 cudaStream_t s) {
  const int n_pack = d / VEC;
  int ppt = (n_pack + kBaseThreads - 1) / kBaseThreads;
  if (ppt > kMaxPPT) ppt = kMaxPPT;
  const int threads = ((n_pack + ppt - 1) / ppt + 31) / 32 * 32;
  if (threads > kMaxThreads) return static_cast<int>(cudaErrorInvalidValue);
  const T* xt = static_cast<const T*>(x);
  const T* dt = static_cast<const T*>(delta);
  const T* st = static_cast<const T*>(scale);
  T* ot = static_cast<T*>(s_out);
  T* yt = static_cast<T*>(y);
  switch (ppt) {
#define REPRO_NORM_CASE(K)                                                  \
  case K:                                                                   \
    norm_kernel<T, VEC, K, ADD><<<N, threads, 0, s>>>(xt, dt, st, ot, yt, d, \
                                                      eps);                 \
    break;
    REPRO_NORM_CASE(1)
    REPRO_NORM_CASE(2)
    REPRO_NORM_CASE(3)
    REPRO_NORM_CASE(4)
    REPRO_NORM_CASE(5)
    REPRO_NORM_CASE(6)
    REPRO_NORM_CASE(7)
    REPRO_NORM_CASE(8)
#undef REPRO_NORM_CASE
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool ADD>
int launch(const void* x, const void* delta, const void* scale, void* s_out,
           void* y, int N, int d, float eps, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  bool vec = d % kVec == 0 && aligned16(x) && aligned16(scale) &&
             aligned16(y);
  if (ADD) vec = vec && aligned16(delta) && aligned16(s_out);
  return vec ? launch_packs<T, kVec, ADD>(x, delta, scale, s_out, y, N, d,
                                          eps, s)
             : launch_packs<T, 1, ADD>(x, delta, scale, s_out, y, N, d, eps,
                                       s);
}

template <bool ADD>
int dispatch(const void* x, const void* delta, const void* scale,
             void* s_out, void* y, int N, int d, float eps, int dtype,
             void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch<float, ADD>(x, delta, scale, s_out, y, N, d, eps, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, ADD>(x, delta, scale, s_out, y, N, d, eps,
                                      s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The backward's teams: kBaseThreads threads a row while it fits in
// bwd_max_ppt(VEC) packs each, more beyond, a multiple of 32 (as the
// forward), and as many rows a block as fit in kBwdBlock threads.
// repro_torch/kernels/rmsnorm.py::bwd_threads and bwd_teams compute the
// same.
constexpr int bwd_max_ppt(int vec) { return vec == 1 ? kMaxPPT : 4; }
inline int bwd_teams(int tpt) { return tpt < kBwdBlock ? kBwdBlock / tpt : 1; }

template <typename T, int VEC, int PPT, bool ADD>
int launch_bwd_kernel(const T* x, const T* scale, const T* dy, const T* g_s,
                      T* dx, float* scratch, unsigned* counters, T* dscale,
                      int N, int d, float eps, int n_blocks, int tpt,
                      cudaStream_t s) {
  const int threads = bwd_teams(tpt) * tpt;
  // the teams' rings, which at the end hold their sums (d floats each)
  const int smem = bwd_teams(tpt) * d * kStages * (ADD ? 3 : 2) *
                   static_cast<int>(sizeof(T));
  // cooperative: all blocks resident at once, or an error (the grid
  // barrier of reduce_dscale needs every block running); n_blocks is cut
  // to what fits the card, a function of the kernel and the card alone.
  // The shared-memory attribute and the fit are kept from the last launch
  // of the same shape, as they cost host time a call.
  static int last_device = -1, last_threads = 0, last_smem = -1, fit = 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device != last_device || threads != last_threads ||
      smem != last_smem) {
    int per_sm = 0, sms = 0;
    err = cudaFuncSetAttribute(norm_bwd_kernel<T, VEC, PPT, ADD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, norm_bwd_kernel<T, VEC, PPT, ADD>, threads, smem);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   device);
    if (err != cudaSuccess) return static_cast<int>(err);
    last_device = device;
    last_threads = threads;
    last_smem = smem;
    fit = per_sm * sms;
  }
  n_blocks = min(n_blocks, fit);
  if (n_blocks <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, norm_bwd_kernel<T, VEC, PPT, ADD>, x, scale,
                           dy, g_s, dx, scratch, counters, dscale, N, d, tpt,
                           eps);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC, bool ADD>
int launch_bwd_packs(const void* x, const void* scale, const void* dy,
                     const void* g_s, void* dx, float* scratch,
                     unsigned* counters, void* dscale, int N, int d,
                     float eps, int n_blocks, cudaStream_t s) {
  const int n_pack = d / VEC;
  int ppt = (n_pack + kBaseThreads - 1) / kBaseThreads;
  if (ppt > bwd_max_ppt(VEC)) ppt = bwd_max_ppt(VEC);
  const int tpt = ((n_pack + ppt - 1) / ppt + 31) / 32 * 32;
  if (tpt > (VEC == 1 ? kMaxThreads : kMaxBwdThreads))
    return static_cast<int>(cudaErrorInvalidValue);
  const T* xt = static_cast<const T*>(x);
  const T* st = static_cast<const T*>(scale);
  const T* gt = static_cast<const T*>(dy);
  const T* gst = static_cast<const T*>(g_s);
  T* dt = static_cast<T*>(dx);
  T* ds = static_cast<T*>(dscale);
  switch (ppt) {
#define REPRO_NORM_BWD_CASE(K)                                              \
  case K:                                                                   \
    return launch_bwd_kernel<T, VEC, K, ADD>(xt, st, gt, gst, dt, scratch,  \
                                             counters, ds, N, d, eps,       \
                                             n_blocks, tpt, s);
    REPRO_NORM_BWD_CASE(1)
    REPRO_NORM_BWD_CASE(2)
    REPRO_NORM_BWD_CASE(3)
    REPRO_NORM_BWD_CASE(4)
#undef REPRO_NORM_BWD_CASE
  }
  if constexpr (VEC == 1) {
    switch (ppt) {
#define REPRO_NORM_BWD_CASE(K)                                              \
  case K:                                                                   \
    return launch_bwd_kernel<T, 1, K, ADD>(xt, st, gt, gst, dt, scratch,    \
                                           counters, ds, N, d, eps,         \
                                           n_blocks, tpt, s);
      REPRO_NORM_BWD_CASE(5)
      REPRO_NORM_BWD_CASE(6)
      REPRO_NORM_BWD_CASE(7)
      REPRO_NORM_BWD_CASE(8)
#undef REPRO_NORM_BWD_CASE
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, bool ADD>
int launch_bwd(const void* x, const void* scale, const void* dy,
               const void* g_s, void* dx, float* scratch, unsigned* counters,
               void* dscale, int N, int d, float eps, int n_blocks,
               cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  bool vec = d % kVec == 0 && aligned16(x) && aligned16(scale) &&
             aligned16(dy) && aligned16(dx);
  if (ADD) vec = vec && aligned16(g_s);
  return vec ? launch_bwd_packs<T, kVec, ADD>(x, scale, dy, g_s, dx, scratch,
                                              counters, dscale, N, d, eps,
                                              n_blocks, s)
             : launch_bwd_packs<T, 1, ADD>(x, scale, dy, g_s, dx, scratch,
                                           counters, dscale, N, d, eps,
                                           n_blocks, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (every tensor of the call). Each returns
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a row longer than the kernel holds; the launch
// runs on `stream` and does not sync.
extern "C" int rmsnorm_fwd(const void* x, const void* scale, void* y, int N,
                           int d, float eps, int dtype, void* stream) {
  return dispatch<false>(x, nullptr, scale, nullptr, y, N, d, eps, dtype,
                         stream);
}

// s_out = x + delta and y = rmsnorm(s_out) * scale; every tensor (N, d)
// but scale (d,).
extern "C" int add_rmsnorm_fwd(const void* x, const void* delta,
                               const void* scale, void* s_out, void* y, int N,
                               int d, float eps, int dtype, void* stream) {
  return dispatch<true>(x, delta, scale, s_out, y, N, d, eps, dtype, stream);
}

// The backward of rmsnorm_fwd (g_s null) or of add_rmsnorm_fwd (x is then
// the saved s, and g_s, which may be null when s went unused, the upstream
// gradient of s): dx (N, d) and dscale (d,) in the call's dtype, in one
// launch of at most n_blocks blocks, n_blocks in [1, N] (the caller fixes
// it from N, d and the card, so that two calls sum in one order; a block of
// 32-thread rows holds 4 of them), fewer if not all of them fit the card at
// once. scratch is fp32, n_blocks x d; counters 64 uint32: the first
// zeroed (and left zeroed), the 33rd the grid barrier's generation, any
// value.
extern "C" int rmsnorm_bwd(const void* x, const void* scale, const void* dy,
                           const void* g_s, void* dx, void* scratch,
                           void* counters, void* dscale, int N, int d,
                           float eps, int n_blocks, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= 0 || d <= 0 || n_blocks <= 0 || n_blocks > N)
    return static_cast<int>(cudaErrorInvalidValue);
  float* p = static_cast<float*>(scratch);
  unsigned* c = static_cast<unsigned*>(counters);
  if (dtype == 0)
    return g_s ? launch_bwd<float, true>(x, scale, dy, g_s, dx, p, c, dscale,
                                         N, d, eps, n_blocks, s)
               : launch_bwd<float, false>(x, scale, dy, g_s, dx, p, c,
                                          dscale, N, d, eps, n_blocks, s);
  if (dtype == 1)
    return g_s ? launch_bwd<__nv_bfloat16, true>(x, scale, dy, g_s, dx, p, c,
                                                 dscale, N, d, eps, n_blocks,
                                                 s)
               : launch_bwd<__nv_bfloat16, false>(x, scale, dy, g_s, dx, p,
                                                  c, dscale, N, d, eps,
                                                  n_blocks, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
