// K2: per-component sum / max over all sites of a field, in two passes.
//
// Replaces the TPU kernel core/reduce.py::_reduce (inner kern :106,
// pallas_call :128).  That kernel initialises a (ncomp, vvl) accumulator at
// program 0 and read-modify-writes it from every later program, which is
// well defined only because a Pallas grid runs in order on one core.  Here
// blocks run in any order, so every reduction is two passes with no
// atomics, and a fixed plan gives the same bits on every run.
//
// Bound on the H100: bytes.  Pass 1 reads each input element once (96 B a
// site for a 24-component field) and does one add per element; pass 2
// reads a partial table (pass 1's: 1/4096 of its input; a fused kernel's:
// one row per vvl sites).  So the design is about bytes in flight and
// coalescing.
//
// Pass 1, rt_reduce_partials: the sites are cut into chunks of
// RT_REDUCE_CHUNK (4096), fixed here and independent of the plan's vvl, and
// each (chunk, component) is folded in one canonical order, a function of
// the (component, site) pairs alone.  Local site l of a chunk is
// l = 256 j + 4 t + i (step j < 16, virtual thread t < 64, lane i < 4):
//
//   q(j, t)  = (v(j,t,0) + v(j,t,1)) + (v(j,t,2) + v(j,t,3))
//   a0(t)    = q(0,t) + q(2,t) + ... + q(14,t)   (in order)
//   a1(t)    = q(1,t) + q(3,t) + ... + q(15,t)
//   x(t)     = a0(t) + a1(t)
//   w(g)     = the warp fold (shfl_down 16, 8, 4, 2, 1) of x(32 g .. 32 g + 31)
//   partial  = w(0) + w(1)
//
// sites past nsites hold the identity.  A chunk is 4096 sites so that a
// block reads 16 KB of a component (16 float4 loads a thread, all in
// flight before the first add), the grid keeps several blocks an SM busy
// at 16^4 sites and up, and pass 1's table is 1/4096 of the field.  Two
// shapes of block compute that order:
//
//   direct  block (chunk, component), 64 threads = the virtual threads:
//           thread t loads its 4 sites of each step as one float4 where the
//           4 lie at consecutive addresses (SoA, AoSoA with SAL >= 4; the
//           chunk whole and the address 16-byte aligned), else 4 scalar
//           loads (a tail chunk, a misaligned field, RT_K_ANY: mixed or
//           non-power-of-two layouts, AoS beyond RT_STAGE_MAX_COMP).  In SoA
//           a warp's float4s cover 512 contiguous bytes.
//   staged  block (chunk), 256 threads, for AoS and AoSoA with SAL <= 16,
//           where a component's runs are at most 64 B long: each step
//           (256 sites x ncomp components, a contiguous run of the field in
//           its own layout) is copied to shared memory with coalesced
//           float4 loads, the next step's loads in flight while this one is
//           folded; thread p then folds the items (c, t) = (m % ncomp,
//           m / ncomp), m = p + 256 u, reading each item's 4 sites from
//           shared memory at INDEX in the tile, and keeps their a0, a1 in
//           registers across the steps.  The warps then fold x(c, t) from
//           shared memory in the direct block's tree.
//
// Both compute the same adds in the same order, so every layout is bitwise
// SoA's, and a sum's bits depend on ncomp and nsites alone.  Max is exact.
//
// Pass 2, rt_reduce_fold: a table of nrows rows of ncomp (pass 1's, or the
// partial rows of the fused kernels, fused_flat.cu and wilson_normal.cuh,
// one row per vvl sites) -> (ncomp,).  A fold level runs blocks of
// T = R * ncomp threads (R = max(1, threads / ncomp)): thread (r, c) =
// (tid / ncomp, tid % ncomp), so a block's threads read consecutive
// addresses of its slab of rows, each keeping column c.  Thread (r, c)
// folds rows r, r + R, r + 2R, ... of the slab into an accumulator that
// starts at the identity (rows past the slab or the table add the
// identity); then the R threads of a column fold in a fixed tree (n -> h =
// ceil(n / 2): v[r] += v[r + h] for r < n - h).  A table of more than
// 16 R2 rows (R2 = 1024 / ncomp) takes two launches of the same kernel:
// level 1, blocks of R1 * ncomp threads (R1 = 256 / ncomp) on slabs of
// 16 R1 rows, writes one row a slab into a scratch table, and level 2, one
// block of R2 * ncomp threads, folds those rows; a smaller table is one
// launch of level 2.  No atomics, no arrival counter: the bits depend on
// nrows and ncomp alone.  Either way it is one call of the C entry point
// (one launch counted).
//
// K2B, the batch instance (the reduction of a BatchedField, _reduce's batch
// grid axis :92-98): the same kernels with the slot as blockIdx.z (pass 1)
// or blockIdx.y (pass 2).  Slot b's field, partial rows and scratch rows
// are offset by whole fields and tables, nothing else in a block depends
// on the slot, so row b is bitwise the single launch on slot b.
//
// K2's compensated instance (_reduce's accumulate branch, acc_dt / comp
// :86-91, :140: a sum under a DtypePolicy whose accumulate slot resolves to
// compensated fp32) folds (hi, lo) pairs (comp.cuh) through the same
// partition and trees: a value enters as (v, 0), every + above is
// rt_pair_add, pass 1 writes pairs partials[(row * ncomp + c) * 2 + {0,1}]
// and pass 2 returns hi.  The wilson_normal kernel's policy instance
// (wilson_normal_mixed.cu) writes pairs of the same shape and reuses pass 2.
//
// core/reduce.py repeats these adds in this order on the CPU (reduce_tree,
// fold_tree and their compensated twins), the kernels' bitwise reference.

#include "comp.cuh"

#define RT_REDUCE_CHUNK 4096    // sites a pass-1 block folds (a component's, or all)
#define RT_REDUCE_THREADS 64    // the canonical fold's virtual threads (two warps)
#define RT_REDUCE_STEPS (RT_REDUCE_CHUNK / (4 * RT_REDUCE_THREADS))   // 16
#define RT_STAGE_THREADS 256    // a staged block
#define RT_STAGE_MAX_COMP 32    // staged when ncomp <= this (items in registers)
#define RT_STAGE_ITEMS (RT_STAGE_MAX_COMP * RT_REDUCE_THREADS / RT_STAGE_THREADS)   // 8
#define RT_STAGE_MAX_SHIFT 4    // AoSoA staged when SAL <= 16 (AoS: SAL 1)
#define RT_FOLD_THREADS 256     // pass 2, level 1: a block's threads at most
#define RT_FOLD_THREADS_ONE 1024   // pass 2, level 2 (the last): one block
#define RT_FOLD_ITERS 16        // level 1: rows a thread folds
#define RT_FOLD_ITERS_ONE 16    // a table of more than R2 * this rows takes level 1

// -- the monoids: plain sum, max, compensated sum --------------------------------

template <int OP>
struct rt_mono {
  typedef float T;
  static __device__ __forceinline__ T id() { return rt_identity(OP); }
  static __device__ __forceinline__ float pad() { return rt_identity(OP); }
  static __device__ __forceinline__ T of(float v) { return v; }
  static __device__ __forceinline__ T add(T a, T b) { return rt_combine(a, b, OP); }
  static __device__ __forceinline__ T shfl_down(T x, int off) {
    return __shfl_down_sync(0xffffffffu, x, off);
  }
  static __device__ __forceinline__ T load(const float* p, long long e) { return p[e]; }
  static __device__ __forceinline__ void store(float* p, long long e, T v) { p[e] = v; }
  static __device__ __forceinline__ float result(T v) { return v; }
};

struct rt_comp_mono {
  typedef rt_pair T;
  static __device__ __forceinline__ T id() { return rt_pair{0.0f, 0.0f}; }
  static __device__ __forceinline__ float pad() { return 0.0f; }
  static __device__ __forceinline__ T of(float v) { return rt_pair{v, 0.0f}; }
  static __device__ __forceinline__ T add(T a, T b) { return rt_pair_add(a, b); }
  static __device__ __forceinline__ T shfl_down(T x, int off) {
    return rt_pair{__shfl_down_sync(0xffffffffu, x.hi, off),
                   __shfl_down_sync(0xffffffffu, x.lo, off)};
  }
  static __device__ __forceinline__ T load(const float* p, long long e) {
    return rt_pair{p[2 * e], p[2 * e + 1]};
  }
  static __device__ __forceinline__ void store(float* p, long long e, T v) {
    p[2 * e] = v.hi;
    p[2 * e + 1] = v.lo;
  }
  static __device__ __forceinline__ float result(T v) { return v.hi; }
};

template <class M>
__device__ __forceinline__ typename M::T rt_fold_warp(typename M::T x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = M::add(x, M::shfl_down(x, off));
  return x;
}

template <class M>
__device__ __forceinline__ typename M::T rt_quad(float e0, float e1, float e2, float e3) {
  return M::add(M::add(M::of(e0), M::of(e1)), M::add(M::of(e2), M::of(e3)));
}

__device__ __forceinline__ bool rt_aligned16(const float* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15ull) == 0;
}

// -- pass 1, direct: block (chunk, component[, slot]), 64 threads --------------------

template <class M, int K>
__device__ __forceinline__ void rt_partials_direct(const float* __restrict__ x,
                                                   float* __restrict__ partials, int ncomp,
                                                   long long nsites, const rt_layout& lx) {
  typedef typename M::T T;
  __shared__ T warp_part[RT_REDUCE_THREADS / 32];
  const int c = blockIdx.y;
  const int t = threadIdx.x;
  const long long nchunks = gridDim.x;
  const long long chunk0 = (long long)blockIdx.x * RT_REDUCE_CHUNK;
  x += blockIdx.z * (long long)ncomp * nsites;
  const bool consecutive = K == RT_K_SOA || (K == RT_K_AOSOA && lx.shift >= 2);
  const bool vec = consecutive && chunk0 + RT_REDUCE_CHUNK <= nsites &&
                   rt_aligned16(x + rt_at<K>(lx, c, chunk0, ncomp, nsites));
  T q[RT_REDUCE_STEPS];
  if (vec) {
    float4 v[RT_REDUCE_STEPS];
#pragma unroll
    for (int j = 0; j < RT_REDUCE_STEPS; ++j)
      v[j] = __ldg(reinterpret_cast<const float4*>(
          x + rt_at<K>(lx, c, chunk0 + 4 * RT_REDUCE_THREADS * j + 4 * t, ncomp, nsites)));
#pragma unroll
    for (int j = 0; j < RT_REDUCE_STEPS; ++j) q[j] = rt_quad<M>(v[j].x, v[j].y, v[j].z, v[j].w);
  } else {
#pragma unroll
    for (int j = 0; j < RT_REDUCE_STEPS; ++j) {
      float e[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const long long s = chunk0 + 4 * RT_REDUCE_THREADS * j + 4 * t + i;
        e[i] = s < nsites ? __ldg(x + rt_at<K>(lx, c, s, ncomp, nsites)) : M::pad();
      }
      q[j] = rt_quad<M>(e[0], e[1], e[2], e[3]);
    }
  }
  T a0 = q[0], a1 = q[1];
#pragma unroll
  for (int j = 2; j < RT_REDUCE_STEPS; j += 2) {
    a0 = M::add(a0, q[j]);
    a1 = M::add(a1, q[j + 1]);
  }
  const T w = rt_fold_warp<M>(M::add(a0, a1));
  if ((t & 31) == 0) warp_part[t >> 5] = w;
  __syncthreads();
  if (t == 0)
    M::store(partials, (blockIdx.z * nchunks + blockIdx.x) * ncomp + c,
             M::add(warp_part[0], warp_part[1]));
}

// -- pass 1, staged: block (chunk[, slot]), 256 threads, AoS / AoSoA (SAL <= 16) ------

// The offset of (component c, local site ls) in a tile of 256 sites that
// starts at a SAL boundary (AoS: shift 0).
__device__ __forceinline__ int rt_tile_at(int c, int ls, int ncomp, int shift) {
  return (((ls >> shift) * ncomp + c) << shift) + (ls & ((1 << shift) - 1));
}

// Load step j's tile (256 sites x ncomp floats, contiguous in the field's
// layout from site chunk0 + 256 j) into registers: float4 g = p + 256 u of
// the tile, pad where the site is past nsites.
template <class M>
__device__ __forceinline__ void rt_stage_load(float4 (&r)[RT_STAGE_ITEMS],
                                              const float* __restrict__ x, long long site0,
                                              int ncomp, long long nsites, bool vec) {
  const int tile_vecs = RT_REDUCE_THREADS * ncomp;   // 256 * ncomp / 4
  const float* tile = x + site0 * ncomp;
  const long long valid = (nsites - site0) * ncomp;  // floats of the tile before nsites
#pragma unroll
  for (int u = 0; u < RT_STAGE_ITEMS; ++u) {
    const int g = threadIdx.x + RT_STAGE_THREADS * u;
    if (g >= tile_vecs) continue;
    if (vec) {
      r[u] = __ldg(reinterpret_cast<const float4*>(tile) + g);
    } else {
      float e[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) e[i] = 4 * g + i < valid ? __ldg(tile + 4 * g + i) : M::pad();
      r[u] = make_float4(e[0], e[1], e[2], e[3]);
    }
  }
}

template <class M>
__device__ __forceinline__ void rt_partials_staged(const float* __restrict__ x,
                                                   float* __restrict__ partials, int ncomp,
                                                   long long nsites, int shift) {
  typedef typename M::T T;
  extern __shared__ float4 rt_stage_smem[];   // one tile: 256 * ncomp floats
  float* tile = reinterpret_cast<float*>(rt_stage_smem);
  const int p = threadIdx.x;
  const int nitems = RT_REDUCE_THREADS * ncomp;
  const long long nchunks = gridDim.x;
  const long long chunk0 = (long long)blockIdx.x * RT_REDUCE_CHUNK;
  x += blockIdx.z * (long long)ncomp * nsites;
  const bool vec = rt_aligned16(x) && chunk0 + RT_REDUCE_CHUNK <= nsites;
  // the items (c, t) = (m % ncomp, m / ncomp), m = p + 256 u: where their
  // 4 sites 4t + i lie in a tile (off + d[i])
  int off[RT_STAGE_ITEMS];
#pragma unroll
  for (int u = 0; u < RT_STAGE_ITEMS; ++u) {
    const int m = p + RT_STAGE_THREADS * u;
    off[u] = rt_tile_at(m % ncomp, 4 * (m / ncomp), ncomp, shift);
  }
  int d[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] = rt_tile_at(0, i, ncomp, shift);
  T a0[RT_STAGE_ITEMS], a1[RT_STAGE_ITEMS];
  float4 r[RT_STAGE_ITEMS];
  rt_stage_load<M>(r, x, chunk0, ncomp, nsites, vec);
#pragma unroll 1   // a step's registers once: several blocks an SM
  for (int j = 0; j < RT_REDUCE_STEPS; ++j) {
#pragma unroll
    for (int u = 0; u < RT_STAGE_ITEMS; ++u)
      if (p + RT_STAGE_THREADS * u < nitems) rt_stage_smem[p + RT_STAGE_THREADS * u] = r[u];
    __syncthreads();
    if (j + 1 < RT_REDUCE_STEPS)   // the next step's loads fly while this one folds
      rt_stage_load<M>(r, x, chunk0 + 4 * RT_REDUCE_THREADS * (j + 1), ncomp, nsites, vec);
#pragma unroll
    for (int u = 0; u < RT_STAGE_ITEMS; ++u) {
      if (p + RT_STAGE_THREADS * u >= nitems) continue;
      T q;
      if (shift >= 2) {
        const float4 v = *reinterpret_cast<const float4*>(tile + off[u]);
        q = rt_quad<M>(v.x, v.y, v.z, v.w);
      } else {
        const float* e = tile + off[u];
        q = rt_quad<M>(e[d[0]], e[d[1]], e[d[2]], e[d[3]]);
      }
      if (j == 0) a0[u] = q;
      else if (j == 1) a1[u] = q;
      else if (j & 1) a1[u] = M::add(a1[u], q);
      else a0[u] = M::add(a0[u], q);
    }
    __syncthreads();
  }
  // x(c, t) into shared memory, then the direct block's warp tree
  T* xs = reinterpret_cast<T*>(tile);          // (ncomp, 64)
  T* ws = xs + RT_REDUCE_THREADS * ncomp;      // (ncomp, 2)
#pragma unroll
  for (int u = 0; u < RT_STAGE_ITEMS; ++u) {
    const int m = p + RT_STAGE_THREADS * u;
    if (m < nitems) xs[(m % ncomp) * RT_REDUCE_THREADS + m / ncomp] = M::add(a0[u], a1[u]);
  }
  __syncthreads();
  const int lane = p & 31, warp = p >> 5;
  for (int task = warp; task < 2 * ncomp; task += RT_STAGE_THREADS / 32) {
    const T w = rt_fold_warp<M>(xs[(task >> 1) * RT_REDUCE_THREADS + 32 * (task & 1) + lane]);
    if (lane == 0) ws[task] = w;
  }
  __syncthreads();
  for (int c = p; c < ncomp; c += RT_STAGE_THREADS)
    M::store(partials, (blockIdx.z * nchunks + blockIdx.x) * ncomp + c,
             M::add(ws[2 * c], ws[2 * c + 1]));
}

template <int OP, int K, bool STAGED>
__global__ void __launch_bounds__(STAGED ? RT_STAGE_THREADS : RT_REDUCE_THREADS, STAGED ? 3 : 1)
    reduce_partials_kernel(const float* __restrict__ x, float* __restrict__ partials, int ncomp,
                           long long nsites, rt_layout lx) {
  if (STAGED)
    rt_partials_staged<rt_mono<OP>>(x, partials, ncomp, nsites, lx.shift < 0 ? 0 : lx.shift);
  else
    rt_partials_direct<rt_mono<OP>, K>(x, partials, ncomp, nsites, lx);
}

template <int K, bool STAGED>
__global__ void __launch_bounds__(STAGED ? RT_STAGE_THREADS : RT_REDUCE_THREADS, STAGED ? 2 : 1)
    reduce_partials_comp_kernel(const float* __restrict__ x, float* __restrict__ partials,
                                int ncomp, long long nsites, rt_layout lx) {
  if (STAGED)
    rt_partials_staged<rt_comp_mono>(x, partials, ncomp, nsites, lx.shift < 0 ? 0 : lx.shift);
  else
    rt_partials_direct<rt_comp_mono, K>(x, partials, ncomp, nsites, lx);
}

// -- pass 2: one fold level -----------------------------------------------------------

// Block (slab s, slot b) of R * ncomp threads folds rows [s * slab_rows,
// (s + 1) * slab_rows) of slot b's table (nrows, ncomp) into row s of out
// (nslabs, ncomp), or, where last, into out[b * ncomp + c] (the result).
template <class M>
__device__ __forceinline__ void rt_fold_level(const float* __restrict__ in,
                                              float* __restrict__ out, long long nrows,
                                              int ncomp, long long slab_rows, bool last) {
  typedef typename M::T T;
  __shared__ T vals[RT_FOLD_THREADS_ONE];
  const int R = blockDim.x / ncomp;
  const int tid = threadIdx.x;
  const int r = tid / ncomp;
  const int c = tid - r * ncomp;
  const long long nslabs = gridDim.x;
  in += blockIdx.y * nrows * ncomp * (long long)(sizeof(T) / sizeof(float));
  const long long row0 = blockIdx.x * slab_rows;
  const long long end = min(row0 + slab_rows, nrows);
  const long long nit = (slab_rows + R - 1) / R;
  T acc = M::id();
#pragma unroll 8
  for (long long it = 0; it < nit; ++it) {
    const long long row = row0 + it * R + r;
    acc = M::add(acc, row < end ? M::load(in, row * ncomp + c) : M::id());
  }
  vals[tid] = acc;
  __syncthreads();
  for (int n = R; n > 1;) {
    const int h = (n + 1) >> 1;
    if (r < n - h) vals[tid] = M::add(vals[tid], vals[tid + h * ncomp]);
    __syncthreads();
    n = h;
  }
  if (r != 0) return;
  if (last)
    out[blockIdx.y * (long long)ncomp + c] = M::result(vals[c]);
  else
    M::store(out, (blockIdx.y * nslabs + blockIdx.x) * ncomp + c, vals[c]);
}

template <int OP>
__global__ void reduce_fold_kernel(const float* __restrict__ in, float* __restrict__ out,
                                   long long nrows, int ncomp, long long slab_rows, bool last) {
  rt_fold_level<rt_mono<OP>>(in, out, nrows, ncomp, slab_rows, last);
}

__global__ void reduce_fold_comp_kernel(const float* __restrict__ in, float* __restrict__ out,
                                        long long nrows, int ncomp, long long slab_rows,
                                        bool last) {
  rt_fold_level<rt_comp_mono>(in, out, nrows, ncomp, slab_rows, last);
}

// -- host side ------------------------------------------------------------------------

static inline long long rt_cdiv(long long a, long long b) { return (a + b - 1) / b; }

// Pass 2's plan for a table of nrows x ncomp: the rows of level 1's slab
// (0: one launch, level 2 alone) and the number of its slabs.
static inline void rt_fold_plan(long long nrows, int ncomp, long long* slab_rows,
                                long long* nslabs) {
  const int r1 = RT_FOLD_THREADS / ncomp > 1 ? RT_FOLD_THREADS / ncomp : 1;
  const int r2 = RT_FOLD_THREADS_ONE / ncomp > 1 ? RT_FOLD_THREADS_ONE / ncomp : 1;
  if (nrows <= (long long)r2 * RT_FOLD_ITERS_ONE) {
    *slab_rows = 0;
    *nslabs = 0;
  } else {
    *slab_rows = (long long)r1 * RT_FOLD_ITERS;
    *nslabs = rt_cdiv(nrows, *slab_rows);
  }
}

// Launch pass 2 with fold kernel F (a __global__ with the fold level's
// signature) on partials (batch, nrows, ncomp[, 2]); scratch holds level
// 1's (batch, nslabs, ncomp[, 2]) rows (rt_reduce_fold_scratch).
template <typename F>
static int rt_fold_launch(F kernel, const float* partials, float* out, float* scratch,
                          long long nrows, int ncomp, int batch, cudaStream_t stream) {
  if (ncomp <= 0 || ncomp > RT_FOLD_THREADS_ONE) return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  long long slab_rows, nslabs;
  rt_fold_plan(nrows, ncomp, &slab_rows, &nslabs);
  const int r1 = RT_FOLD_THREADS / ncomp > 1 ? RT_FOLD_THREADS / ncomp : 1;
  const int r2 = RT_FOLD_THREADS_ONE / ncomp > 1 ? RT_FOLD_THREADS_ONE / ncomp : 1;
  if (nslabs > 0) {
    kernel<<<dim3((unsigned)nslabs, batch), r1 * ncomp, 0, stream>>>(partials, scratch, nrows,
                                                                      ncomp, slab_rows, false);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    partials = scratch;
    nrows = nslabs;
  }
  kernel<<<dim3(1, batch), r2 * ncomp, 0, stream>>>(partials, out, nrows, ncomp,
                                                    nrows > 0 ? nrows : 1, true);
  RT_LAUNCH_RESULT();
}

// Pass 1's launch: the staged block for AoS and AoSoA (SAL <= 16) up to
// RT_STAGE_MAX_COMP components, else the direct one.
#define RT_PARTIALS_LAUNCH(KERN, ...)                                                        \
  do {                                                                                       \
    const bool staged = (k == RT_K_AOS || (k == RT_K_AOSOA && L.shift <= RT_STAGE_MAX_SHIFT)) \
                        && ncomp <= RT_STAGE_MAX_COMP;                                       \
    const unsigned nchunks = (unsigned)rt_cdiv(nsites, RT_REDUCE_CHUNK);                     \
    if (staged) {                                                                            \
      const size_t smem = sizeof(float) * 4 * RT_REDUCE_THREADS * ncomp;                     \
      if (k == RT_K_AOS)                                                                     \
        KERN<__VA_ARGS__ RT_K_AOS, true><<<dim3(nchunks, 1, batch), RT_STAGE_THREADS, smem,  \
                                           stream>>>(x, partials, ncomp, nsites, L);         \
      else                                                                                   \
        KERN<__VA_ARGS__ RT_K_AOSOA, true><<<dim3(nchunks, 1, batch), RT_STAGE_THREADS,     \
                                             smem, stream>>>(x, partials, ncomp, nsites, L); \
    } else {                                                                                 \
      RT_WITH_CLASS(k, KERN<__VA_ARGS__ RT_K, false><<<dim3(nchunks, ncomp, batch),          \
                                                       RT_REDUCE_THREADS, 0, stream>>>(      \
                           x, partials, ncomp, nsites, L));                                  \
    }                                                                                        \
  } while (0)

extern "C" {

// The pass-1 chunk (sites a block folds): core/reduce.py sizes the partial
// tables from the same constant and checks the library agrees.
int rt_reduce_chunk(void) { return RT_REDUCE_CHUNK; }

// x: batch fields of ncomp x nsites, one after another, each in layout lx
// (descriptor); partials: (batch, ceil(nsites / RT_REDUCE_CHUNK), ncomp).
int rt_reduce_partials_batched(const float* x, float* partials, int ncomp, long long nsites,
                               int batch, int op, int lx, cudaStream_t stream) {
  const rt_layout L = rt_make_layout(lx);
  const int k = rt_launch_class(&L, 1);
  if (k < 0) return RT_BAD_LAYOUT;
  if (nsites == 0 || ncomp == 0 || batch == 0) return 0;
  if (op == RT_OP_MAX)
    RT_PARTIALS_LAUNCH(reduce_partials_kernel, RT_OP_MAX, );
  else
    RT_PARTIALS_LAUNCH(reduce_partials_kernel, RT_OP_SUM, );
  RT_LAUNCH_RESULT();
}

// The compensated pass 1: x as rt_reduce_partials_batched; partials:
// (batch, ceil(nsites / RT_REDUCE_CHUNK), ncomp, 2).
int rt_reduce_partials_comp(const float* x, float* partials, int ncomp, long long nsites,
                            int batch, int lx, cudaStream_t stream) {
  const rt_layout L = rt_make_layout(lx);
  const int k = rt_launch_class(&L, 1);
  if (k < 0) return RT_BAD_LAYOUT;
  if (nsites == 0 || ncomp == 0 || batch == 0) return 0;
  RT_PARTIALS_LAUNCH(reduce_partials_comp_kernel, );
  RT_LAUNCH_RESULT();
}

// x: one field; partials: (ceil(nsites / RT_REDUCE_CHUNK), ncomp).
int rt_reduce_partials(const float* x, float* partials, int ncomp, long long nsites, int op,
                       int lx, cudaStream_t stream) {
  return rt_reduce_partials_batched(x, partials, ncomp, nsites, 1, op, lx, stream);
}

// The floats of pass 2's scratch for one slot's table of nrows x ncomp
// pairs-or-values (times 2 for the compensated fold): 0 when one launch
// folds it.
long long rt_reduce_fold_scratch(long long nrows, int ncomp) {
  if (ncomp <= 0) return 0;
  long long slab_rows, nslabs;
  rt_fold_plan(nrows, ncomp, &slab_rows, &nslabs);
  return nslabs * ncomp;
}

// partials: (batch, nrows, ncomp) -> out: (batch, ncomp); scratch:
// batch * rt_reduce_fold_scratch(nrows, ncomp) floats.
int rt_reduce_fold_batched(const float* partials, float* out, float* scratch, long long nrows,
                           int ncomp, int batch, int op, cudaStream_t stream) {
  if (op == RT_OP_MAX)
    return rt_fold_launch(reduce_fold_kernel<RT_OP_MAX>, partials, out, scratch, nrows, ncomp,
                          batch, stream);
  return rt_fold_launch(reduce_fold_kernel<RT_OP_SUM>, partials, out, scratch, nrows, ncomp,
                        batch, stream);
}

int rt_reduce_fold(const float* partials, float* out, float* scratch, long long nrows,
                   int ncomp, int op, cudaStream_t stream) {
  return rt_reduce_fold_batched(partials, out, scratch, nrows, ncomp, 1, op, stream);
}

// The compensated pass 2: partials (batch, nrows, ncomp, 2) -> out (batch,
// ncomp), the his; scratch: 2 * batch * rt_reduce_fold_scratch floats.
int rt_reduce_fold_comp(const float* partials, float* out, float* scratch, long long nrows,
                        int ncomp, int batch, cudaStream_t stream) {
  return rt_fold_launch(reduce_fold_comp_kernel, partials, out, scratch, nrows, ncomp, batch,
                        stream);
}

}  // extern "C"
