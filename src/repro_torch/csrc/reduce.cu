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
// K2S, the split fold (a plan's rsplit > 1: _reduce's split grid :74-79,
// combine_partials core/fuse.py:209, the fused lowerings' _split_specs
// :1992): a table of R rows folds in S segments, segment s the rows
// [floor(s R / S), floor((s + 1) R / S)), each by the fold tree above (a
// segment of more than 16 R2 rows takes level 1 on its own slabs; an empty
// one is the identity), and the last launch, one block a slot, folds the
// segments one after the other and combines their values in index order,
// ((v0 + v1) + v2) + ...; the compensated instance combines the pairs by
// rt_pair_add.  The unsplit entry points are S = 1 of the same kernels, so
// their bits are the tree's as before.  On the TPU the split is a grid
// axis whose segments accumulate their own partial row, combined after the
// call in the same order.
//
// The int32 and bf16 instances (_reduce on a non-fp32 field, which keeps
// its dtype): pass 1 and the fold are the same templates over another
// element type.  int32 sums add in uint32 and reinterpret the result, so a
// sum past 2^31 wraps as the reference's int32 sum does, with no signed
// overflow (undefined in C++); int32 max starts at INT32_MIN.  Both are
// exact, so any order gives their bits.  A bf16 field's values are widened
// to fp32 as they load (8-byte vectors of 4 values in the direct block, so
// a thread keeps the canonical order's 4 sites a step; 16-byte pieces of
// the tile in the staged one), summed or maxed through the fp32 trees, and
// the fold rounds the result once to bf16 (__float2bfloat16_rn): the fp32
// field's tree on the widened values, rounded.
//
// core/reduce.py repeats these adds in this order on the CPU (reduce_tree,
// fold_tree, fold_tree_split and their compensated twins), the kernels'
// bitwise reference.

#include "bf16.cuh"
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

// rt_reduce_fold_split's table kinds (core/reduce.py's _FOLD_*)
#define RT_FOLD_F32 0    // fp32 values -> fp32
#define RT_FOLD_COMP 1   // (hi, lo) pairs -> fp32
#define RT_FOLD_I32 2    // int32 values -> int32
#define RT_FOLD_BF16 3   // fp32 values -> bf16, rounded once

#define RT_INT32_MIN (-2147483647 - 1)

// -- the monoids: plain sum and max (fp32, int32), compensated sum ---------------
//
// S is a value's type, T the accumulator's (S, or a pair); a table holds
// WORDS S a value.

template <int OP>
struct rt_mono {
  typedef float S;
  typedef float T;
  static constexpr int WORDS = 1;
  static __device__ __forceinline__ T id() { return rt_identity(OP); }
  static __device__ __forceinline__ S pad() { return rt_identity(OP); }
  static __device__ __forceinline__ T of(S v) { return v; }
  static __device__ __forceinline__ T add(T a, T b) { return rt_combine(a, b, OP); }
  static __device__ __forceinline__ T shfl_down(T x, int off) {
    return __shfl_down_sync(0xffffffffu, x, off);
  }
  static __device__ __forceinline__ T load(const S* p, long long e) { return p[e]; }
  static __device__ __forceinline__ void store(S* p, long long e, T v) { p[e] = v; }
  static __device__ __forceinline__ S result(T v) { return v; }
};

template <int OP>
struct rt_imono {
  typedef int S;
  typedef int T;
  static constexpr int WORDS = 1;
  static __device__ __forceinline__ T id() { return OP == RT_OP_MAX ? RT_INT32_MIN : 0; }
  static __device__ __forceinline__ S pad() { return id(); }
  static __device__ __forceinline__ T of(S v) { return v; }
  // the sum wraps: added as uint32, reinterpreted
  static __device__ __forceinline__ T add(T a, T b) {
    return OP == RT_OP_MAX ? max(a, b)
                           : static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
  }
  static __device__ __forceinline__ T shfl_down(T x, int off) {
    return __shfl_down_sync(0xffffffffu, x, off);
  }
  static __device__ __forceinline__ T load(const S* p, long long e) { return p[e]; }
  static __device__ __forceinline__ void store(S* p, long long e, T v) { p[e] = v; }
  static __device__ __forceinline__ S result(T v) { return v; }
};

struct rt_comp_mono {
  typedef float S;
  typedef rt_pair T;
  static constexpr int WORDS = 2;
  static __device__ __forceinline__ T id() { return rt_pair{0.0f, 0.0f}; }
  static __device__ __forceinline__ S pad() { return 0.0f; }
  static __device__ __forceinline__ T of(S v) { return rt_pair{v, 0.0f}; }
  static __device__ __forceinline__ T add(T a, T b) { return rt_pair_add(a, b); }
  static __device__ __forceinline__ T shfl_down(T x, int off) {
    return rt_pair{__shfl_down_sync(0xffffffffu, x.hi, off),
                   __shfl_down_sync(0xffffffffu, x.lo, off)};
  }
  static __device__ __forceinline__ T load(const S* p, long long e) {
    return rt_pair{p[2 * e], p[2 * e + 1]};
  }
  static __device__ __forceinline__ void store(S* p, long long e, T v) {
    p[2 * e] = v.hi;
    p[2 * e + 1] = v.lo;
  }
  static __device__ __forceinline__ S result(T v) { return v.hi; }
};

// -- the element types: fp32, int32, bf16 ----------------------------------------------

// An element as a value of its monoid (bf16 widened to fp32, exactly).
__device__ __forceinline__ float rt_cvt(float v) { return v; }
__device__ __forceinline__ int rt_cvt(int v) { return v; }
__device__ __forceinline__ float rt_cvt(__nv_bfloat16 v) { return __bfloat162float(v); }

// A value as an element of type E (the first argument only names E): the
// pad of a staged tile's tail, exact for 0, -inf and INT32_MIN.
__device__ __forceinline__ float rt_elem(const float*, float v) { return v; }
__device__ __forceinline__ int rt_elem(const int*, int v) { return v; }
__device__ __forceinline__ __nv_bfloat16 rt_elem(const __nv_bfloat16*, float v) {
  return __float2bfloat16_rn(v);
}

// Four consecutive elements as one load: 16 bytes (fp32, int32) or 8 (bf16).
template <typename E>
struct rt_vec4 {
  typedef float4 V;
};
template <>
struct rt_vec4<int> {
  typedef int4 V;
};
template <>
struct rt_vec4<__nv_bfloat16> {
  typedef uint2 V;
};

template <class M>
__device__ __forceinline__ typename M::T rt_quad(typename M::S e0, typename M::S e1,
                                                 typename M::S e2, typename M::S e3) {
  return M::add(M::add(M::of(e0), M::of(e1)), M::add(M::of(e2), M::of(e3)));
}

template <class M>
__device__ __forceinline__ typename M::T rt_quad_of(float4 v) {
  return rt_quad<M>(v.x, v.y, v.z, v.w);
}
template <class M>
__device__ __forceinline__ typename M::T rt_quad_of(int4 v) {
  return rt_quad<M>(v.x, v.y, v.z, v.w);
}
template <class M>
__device__ __forceinline__ typename M::T rt_quad_of(uint2 v) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  return rt_quad<M>(a.x, a.y, b.x, b.y);
}

// A result stored in the output's type (bf16: rounded once).
__device__ __forceinline__ void rt_out(float* p, long long i, float v) { p[i] = v; }
__device__ __forceinline__ void rt_out(int* p, long long i, int v) { p[i] = v; }
__device__ __forceinline__ void rt_out(__nv_bfloat16* p, long long i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

template <class M>
__device__ __forceinline__ typename M::T rt_fold_warp(typename M::T x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = M::add(x, M::shfl_down(x, off));
  return x;
}

__device__ __forceinline__ bool rt_aligned_to(const void* p, unsigned bytes) {
  return (reinterpret_cast<unsigned long long>(p) & (bytes - 1ull)) == 0;
}

// -- pass 1, direct: block (chunk, component[, slot]), 64 threads --------------------

template <class M, typename E, int K>
__device__ __forceinline__ void rt_partials_direct(const E* __restrict__ x,
                                                   typename M::S* __restrict__ partials,
                                                   int ncomp, long long nsites,
                                                   const rt_layout& lx) {
  typedef typename M::T T;
  typedef typename rt_vec4<E>::V V;
  __shared__ T warp_part[RT_REDUCE_THREADS / 32];
  const int c = blockIdx.y;
  const int t = threadIdx.x;
  const long long nchunks = gridDim.x;
  const long long chunk0 = (long long)blockIdx.x * RT_REDUCE_CHUNK;
  x += blockIdx.z * (long long)ncomp * nsites;
  const bool consecutive = K == RT_K_SOA || (K == RT_K_AOSOA && lx.shift >= 2);
  const bool vec = consecutive && chunk0 + RT_REDUCE_CHUNK <= nsites &&
                   rt_aligned_to(x + rt_at<K>(lx, c, chunk0, ncomp, nsites), sizeof(V));
  T q[RT_REDUCE_STEPS];
  if (vec) {
    V v[RT_REDUCE_STEPS];
#pragma unroll
    for (int j = 0; j < RT_REDUCE_STEPS; ++j)
      v[j] = __ldg(reinterpret_cast<const V*>(
          x + rt_at<K>(lx, c, chunk0 + 4 * RT_REDUCE_THREADS * j + 4 * t, ncomp, nsites)));
#pragma unroll
    for (int j = 0; j < RT_REDUCE_STEPS; ++j) q[j] = rt_quad_of<M>(v[j]);
  } else {
#pragma unroll
    for (int j = 0; j < RT_REDUCE_STEPS; ++j) {
      typename M::S e[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const long long s = chunk0 + 4 * RT_REDUCE_THREADS * j + 4 * t + i;
        e[i] = s < nsites ? rt_cvt(__ldg(x + rt_at<K>(lx, c, s, ncomp, nsites))) : M::pad();
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

// Load step j's tile (256 sites x ncomp elements, contiguous in the field's
// layout from site site0) into registers as 16-byte pieces: piece g = p +
// 256 u of the tile, the pad where an element lies past nsites.
template <class M, typename E>
__device__ __forceinline__ void rt_stage_load(uint4 (&r)[RT_STAGE_ITEMS],
                                              const E* __restrict__ x, long long site0,
                                              int ncomp, long long nsites, bool vec) {
  constexpr int PER = 16 / sizeof(E);     // elements a piece
  const int tile_vecs = RT_STAGE_THREADS * ncomp / PER;
  const E* tile = x + site0 * ncomp;
  const long long valid = (nsites - site0) * ncomp;  // elements of the tile before nsites
#pragma unroll
  for (int u = 0; u < RT_STAGE_ITEMS; ++u) {
    const int g = threadIdx.x + RT_STAGE_THREADS * u;
    if (g >= tile_vecs) continue;
    if (vec) {
      r[u] = __ldg(reinterpret_cast<const uint4*>(tile) + g);
    } else {
      uint4 w;
      E* e = reinterpret_cast<E*>(&w);
#pragma unroll
      for (int i = 0; i < PER; ++i)
        e[i] = PER * g + i < valid ? __ldg(tile + PER * g + i) : rt_elem(tile, M::pad());
      r[u] = w;
    }
  }
}

template <class M, typename E>
__device__ __forceinline__ void rt_partials_staged(const E* __restrict__ x,
                                                   typename M::S* __restrict__ partials,
                                                   int ncomp, long long nsites, int shift) {
  typedef typename M::T T;
  typedef typename rt_vec4<E>::V V;
  constexpr int PER = 16 / sizeof(E);
  extern __shared__ uint4 rt_stage_smem[];   // one tile: 256 * ncomp elements
  E* tile = reinterpret_cast<E*>(rt_stage_smem);
  const int p = threadIdx.x;
  const int nitems = RT_REDUCE_THREADS * ncomp;
  const int tile_vecs = RT_STAGE_THREADS * ncomp / PER;
  const long long nchunks = gridDim.x;
  const long long chunk0 = (long long)blockIdx.x * RT_REDUCE_CHUNK;
  x += blockIdx.z * (long long)ncomp * nsites;
  const bool vec = rt_aligned_to(x, 16) && chunk0 + RT_REDUCE_CHUNK <= nsites;
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
  uint4 r[RT_STAGE_ITEMS];
  rt_stage_load<M, E>(r, x, chunk0, ncomp, nsites, vec);
#pragma unroll 1   // a step's registers once: several blocks an SM
  for (int j = 0; j < RT_REDUCE_STEPS; ++j) {
#pragma unroll
    for (int u = 0; u < RT_STAGE_ITEMS; ++u)
      if (p + RT_STAGE_THREADS * u < tile_vecs) rt_stage_smem[p + RT_STAGE_THREADS * u] = r[u];
    __syncthreads();
    if (j + 1 < RT_REDUCE_STEPS)   // the next step's loads fly while this one folds
      rt_stage_load<M, E>(r, x, chunk0 + 4 * RT_REDUCE_THREADS * (j + 1), ncomp, nsites, vec);
#pragma unroll
    for (int u = 0; u < RT_STAGE_ITEMS; ++u) {
      if (p + RT_STAGE_THREADS * u >= nitems) continue;
      T q;
      if (shift >= 2) {
        q = rt_quad_of<M>(*reinterpret_cast<const V*>(tile + off[u]));
      } else {
        const E* e = tile + off[u];
        q = rt_quad<M>(rt_cvt(e[d[0]]), rt_cvt(e[d[1]]), rt_cvt(e[d[2]]), rt_cvt(e[d[3]]));
      }
      if (j == 0) a0[u] = q;
      else if (j == 1) a1[u] = q;
      else if (j & 1) a1[u] = M::add(a1[u], q);
      else a0[u] = M::add(a0[u], q);
    }
    __syncthreads();
  }
  // x(c, t) into shared memory, then the direct block's warp tree
  T* xs = reinterpret_cast<T*>(rt_stage_smem);   // (ncomp, 64)
  T* ws = xs + RT_REDUCE_THREADS * ncomp;        // (ncomp, 2)
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

template <class M, typename E, int K, bool STAGED>
__global__ void __launch_bounds__(STAGED ? RT_STAGE_THREADS : RT_REDUCE_THREADS,
                                  STAGED ? (M::WORDS == 2 ? 2 : 3) : 1)
    reduce_partials_kernel(const E* __restrict__ x, typename M::S* __restrict__ partials,
                           int ncomp, long long nsites, rt_layout lx) {
  if (STAGED)
    rt_partials_staged<M, E>(x, partials, ncomp, nsites, lx.shift < 0 ? 0 : lx.shift);
  else
    rt_partials_direct<M, E, K>(x, partials, ncomp, nsites, lx);
}

// -- pass 2: the fold levels ------------------------------------------------------------

// The block's threads (r, c) = (tid / ncomp, tid % ncomp), R = blockDim.x /
// ncomp of them a column, fold rows [0, rows) of table t (rows of ncomp
// values) in slabs of slab_rows >= rows: thread (r, c) folds rows r, r + R,
// ... from the identity, then the R threads of a column fold in the tree
// n -> h = ceil(n / 2).  Returns column c's value (in every thread); must
// be reached by every thread of the block.
template <class M>
__device__ __forceinline__ typename M::T rt_fold_rows(const typename M::S* __restrict__ t,
                                                      long long rows, int ncomp,
                                                      long long slab_rows) {
  typedef typename M::T T;
  __shared__ T vals[RT_FOLD_THREADS_ONE];
  const int R = blockDim.x / ncomp;
  const int tid = threadIdx.x;
  const int r = tid / ncomp;
  const int c = tid - r * ncomp;
  const long long nit = (slab_rows + R - 1) / R;
  T acc = M::id();
#pragma unroll 8
  for (long long it = 0; it < nit; ++it) {
    const long long row = it * R + r;
    acc = M::add(acc, row < rows ? M::load(t, row * ncomp + c) : M::id());
  }
  vals[tid] = acc;
  __syncthreads();
  for (int n = R; n > 1;) {
    const int h = (n + 1) >> 1;
    if (r < n - h) vals[tid] = M::add(vals[tid], vals[tid + h * ncomp]);
    __syncthreads();
    n = h;
  }
  const T v = vals[c];
  __syncthreads();   // vals is reused by the caller's next fold
  return v;
}

// Segment s of S of a table of nrows rows: rows [lo, lo + n).
__device__ __forceinline__ void rt_segment(long long nrows, int s, int S, long long* lo,
                                           long long* n) {
  if (S == 1) {   // the unsplit fold: no 64-bit divisions
    *lo = 0;
    *n = nrows;
    return;
  }
  *lo = s * nrows / S;
  *n = (s + 1) * nrows / S - *lo;
}

// Level 1: block (x, slot * S + segment) folds slab x (slab_rows rows) of
// its segment, where the segment has more than thr rows, into scratch row
// (slot * S + segment) * gridDim.x + x.
template <class M>
__global__ void reduce_fold_kernel_level1(const typename M::S* __restrict__ in,
                                          typename M::S* __restrict__ scratch, long long nrows,
                                          int ncomp, int S, long long slab_rows, long long thr) {
  const int y = blockIdx.y;
  const int b = y / S;
  long long lo, n;
  rt_segment(nrows, y - b * S, S, &lo, &n);
  const long long row0 = blockIdx.x * slab_rows;
  if (n <= thr || row0 >= n) return;   // the whole block, before any barrier
  const typename M::T v =
      rt_fold_rows<M>(in + ((long long)b * nrows + lo + row0) * ncomp * M::WORDS,
                      min(slab_rows, n - row0), ncomp, slab_rows);
  const int c = threadIdx.x % ncomp;
  if (threadIdx.x < ncomp)
    M::store(scratch, ((long long)y * gridDim.x + blockIdx.x) * ncomp + c, v);
}

// The last level: block (0, slot) folds each segment in turn (its level-1
// rows where it took level 1, else its rows of the table) and combines the
// segments' values in index order into out[slot * ncomp + c].
template <class M, typename O>
__global__ void reduce_fold_kernel(const typename M::S* __restrict__ in,
                                        const typename M::S* __restrict__ scratch,
                                        O* __restrict__ out, long long nrows, int ncomp, int S,
                                        long long slab_rows, long long max_slabs, long long thr) {
  const int b = blockIdx.y;
  typename M::T total = M::id();
  for (int s = 0; s < S; ++s) {
    long long lo, n;
    rt_segment(nrows, s, S, &lo, &n);
    const typename M::S* t;
    long long rows;
    if (n > thr) {
      t = scratch + ((long long)b * S + s) * max_slabs * ncomp * M::WORDS;
      rows = (n + slab_rows - 1) / slab_rows;
    } else {
      t = in + ((long long)b * nrows + lo) * ncomp * M::WORDS;
      rows = n;
    }
    const typename M::T v = rt_fold_rows<M>(t, rows, ncomp, rows > 0 ? rows : 1);
    total = s == 0 ? v : M::add(total, v);
  }
  if (threadIdx.x < ncomp) rt_out(out, (long long)b * ncomp + threadIdx.x, M::result(total));
}

// -- host side ------------------------------------------------------------------------

static inline long long rt_cdiv(long long a, long long b) { return (a + b - 1) / b; }

// Pass 2's plan for a table of nrows x ncomp in S segments: level 1's
// threads a column (r1) and slab rows, level 2's threads a column (r2),
// the segment size above which a segment takes level 1 (thr), and the most
// level-1 slabs a segment has (0: no level 1).
struct rt_fold_plan {
  int r1, r2;
  long long slab_rows, thr, max_slabs;
};

static inline rt_fold_plan rt_make_fold_plan(long long nrows, int ncomp, int S) {
  rt_fold_plan P;
  P.r1 = RT_FOLD_THREADS / ncomp > 1 ? RT_FOLD_THREADS / ncomp : 1;
  P.r2 = RT_FOLD_THREADS_ONE / ncomp > 1 ? RT_FOLD_THREADS_ONE / ncomp : 1;
  P.slab_rows = (long long)P.r1 * RT_FOLD_ITERS;
  P.thr = (long long)P.r2 * RT_FOLD_ITERS_ONE;
  P.max_slabs = 0;
  const long long sizes[2] = {nrows / S, rt_cdiv(nrows, S)};   // a segment's rows
  for (long long n : sizes)
    if (n > P.thr && rt_cdiv(n, P.slab_rows) > P.max_slabs) P.max_slabs = rt_cdiv(n, P.slab_rows);
  return P;
}

// Launch pass 2 of monoid M on partials (batch, nrows, ncomp[, 2]) in S
// segments -> out (batch, ncomp) of type O; scratch holds level 1's (batch,
// S, max_slabs, ncomp[, 2]) rows (rt_reduce_fold_split_scratch).
template <class M, typename O>
static int rt_fold_launch(const typename M::S* partials, O* out, typename M::S* scratch,
                          long long nrows, int ncomp, int batch, int S, cudaStream_t stream) {
  if (ncomp <= 0 || ncomp > RT_FOLD_THREADS_ONE || S < 1 || nrows < 0 ||
      (long long)batch * S > 65535)
    return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  const rt_fold_plan P = rt_make_fold_plan(nrows, ncomp, S);
  if (P.max_slabs > 0) {
    reduce_fold_kernel_level1<M><<<dim3((unsigned)P.max_slabs, batch * S), P.r1 * ncomp, 0,
                                   stream>>>(partials, scratch, nrows, ncomp, S, P.slab_rows,
                                             P.thr);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  reduce_fold_kernel<M, O><<<dim3(1, batch), P.r2 * ncomp, 0, stream>>>(
      partials, scratch, out, nrows, ncomp, S, P.slab_rows, P.max_slabs, P.thr);
  RT_LAUNCH_RESULT();
}

// Pass 1's launch of monoid M over elements E: the staged block for AoS
// and AoSoA (SAL <= 16) up to RT_STAGE_MAX_COMP components, else the
// direct one.
template <class M, typename E>
static int rt_partials_launch(const E* x, typename M::S* partials, int ncomp, long long nsites,
                              int batch, int lx, cudaStream_t stream) {
  const rt_layout L = rt_make_layout(lx);
  const int k = rt_launch_class(&L, 1);
  if (k < 0) return RT_BAD_LAYOUT;
  if (nsites == 0 || ncomp == 0 || batch == 0) return 0;
  const bool staged =
      (k == RT_K_AOS || (k == RT_K_AOSOA && L.shift <= RT_STAGE_MAX_SHIFT)) &&
      ncomp <= RT_STAGE_MAX_COMP;
  const unsigned nchunks = (unsigned)rt_cdiv(nsites, RT_REDUCE_CHUNK);
  if (staged) {
    // the tile, and after the steps x(c, t) and the warp values
    const size_t tile = sizeof(E) * RT_STAGE_THREADS * ncomp;
    const size_t fold = sizeof(typename M::T) * (RT_REDUCE_THREADS + 2) * ncomp;
    const size_t smem = tile > fold ? tile : fold;
    if (k == RT_K_AOS)
      reduce_partials_kernel<M, E, RT_K_AOS, true>
          <<<dim3(nchunks, 1, batch), RT_STAGE_THREADS, smem, stream>>>(x, partials, ncomp,
                                                                         nsites, L);
    else
      reduce_partials_kernel<M, E, RT_K_AOSOA, true>
          <<<dim3(nchunks, 1, batch), RT_STAGE_THREADS, smem, stream>>>(x, partials, ncomp,
                                                                         nsites, L);
  } else {
    RT_WITH_CLASS(k, reduce_partials_kernel<M, E, RT_K, false>
                         <<<dim3(nchunks, ncomp, batch), RT_REDUCE_THREADS, 0, stream>>>(
                             x, partials, ncomp, nsites, L));
  }
  RT_LAUNCH_RESULT();
}

extern "C" {

// The pass-1 chunk (sites a block folds): core/reduce.py sizes the partial
// tables from the same constant and checks the library agrees.
int rt_reduce_chunk(void) { return RT_REDUCE_CHUNK; }

// x: batch fields of ncomp x nsites, one after another, each in layout lx
// (descriptor); partials: (batch, ceil(nsites / RT_REDUCE_CHUNK), ncomp).
int rt_reduce_partials_batched(const float* x, float* partials, int ncomp, long long nsites,
                               int batch, int op, int lx, cudaStream_t stream) {
  if (op == RT_OP_MAX)
    return rt_partials_launch<rt_mono<RT_OP_MAX>>(x, partials, ncomp, nsites, batch, lx, stream);
  return rt_partials_launch<rt_mono<RT_OP_SUM>>(x, partials, ncomp, nsites, batch, lx, stream);
}

// The compensated pass 1: x as rt_reduce_partials_batched; partials:
// (batch, ceil(nsites / RT_REDUCE_CHUNK), ncomp, 2).
int rt_reduce_partials_comp(const float* x, float* partials, int ncomp, long long nsites,
                            int batch, int lx, cudaStream_t stream) {
  return rt_partials_launch<rt_comp_mono>(x, partials, ncomp, nsites, batch, lx, stream);
}

// x: one field; partials: (ceil(nsites / RT_REDUCE_CHUNK), ncomp).
int rt_reduce_partials(const float* x, float* partials, int ncomp, long long nsites, int op,
                       int lx, cudaStream_t stream) {
  return rt_reduce_partials_batched(x, partials, ncomp, nsites, 1, op, lx, stream);
}

// The int32 pass 1: x int32 as rt_reduce_partials_batched; partials int32.
int rt_reduce_partials_i32(const int* x, int* partials, int ncomp, long long nsites, int batch,
                           int op, int lx, cudaStream_t stream) {
  if (op == RT_OP_MAX)
    return rt_partials_launch<rt_imono<RT_OP_MAX>>(x, partials, ncomp, nsites, batch, lx,
                                                   stream);
  return rt_partials_launch<rt_imono<RT_OP_SUM>>(x, partials, ncomp, nsites, batch, lx, stream);
}

// The bf16 pass 1: x bf16 as rt_reduce_partials_batched; partials fp32.
int rt_reduce_partials_bf16(const __nv_bfloat16* x, float* partials, int ncomp,
                            long long nsites, int batch, int op, int lx, cudaStream_t stream) {
  if (op == RT_OP_MAX)
    return rt_partials_launch<rt_mono<RT_OP_MAX>>(x, partials, ncomp, nsites, batch, lx, stream);
  return rt_partials_launch<rt_mono<RT_OP_SUM>>(x, partials, ncomp, nsites, batch, lx, stream);
}

// The values (pairs, for the compensated fold) of pass 2's scratch for one
// slot's table of nrows x ncomp in rsplit segments: rsplit x the largest
// segment's level-1 slabs x ncomp (0 when no segment takes level 1).
long long rt_reduce_fold_split_scratch(long long nrows, int ncomp, int rsplit) {
  if (ncomp <= 0 || rsplit < 1) return 0;
  return rsplit * rt_make_fold_plan(nrows, ncomp, rsplit).max_slabs * ncomp;
}

long long rt_reduce_fold_scratch(long long nrows, int ncomp) {
  return rt_reduce_fold_split_scratch(nrows, ncomp, 1);
}

// K2S: partials (batch, nrows, ncomp[, 2]) of table kind `kind` (RT_FOLD_*)
// -> out (batch, ncomp), folded in rsplit segments combined in index order;
// scratch: batch * rt_reduce_fold_split_scratch(nrows, ncomp, rsplit)
// values (pairs).
int rt_reduce_fold_split(const void* partials, void* out, void* scratch, long long nrows,
                         int ncomp, int batch, int rsplit, int op, int kind,
                         cudaStream_t stream) {
  const float* pf = static_cast<const float*>(partials);
  float* sf = static_cast<float*>(scratch);
  const bool mx = op == RT_OP_MAX;
  switch (kind) {
    case RT_FOLD_F32:
      return mx ? rt_fold_launch<rt_mono<RT_OP_MAX>>(pf, static_cast<float*>(out), sf, nrows,
                                                     ncomp, batch, rsplit, stream)
                : rt_fold_launch<rt_mono<RT_OP_SUM>>(pf, static_cast<float*>(out), sf, nrows,
                                                     ncomp, batch, rsplit, stream);
    case RT_FOLD_COMP:
      if (mx) return (int)cudaErrorInvalidValue;
      return rt_fold_launch<rt_comp_mono>(pf, static_cast<float*>(out), sf, nrows, ncomp, batch,
                                          rsplit, stream);
    case RT_FOLD_I32: {
      const int* pi = static_cast<const int*>(partials);
      int* si = static_cast<int*>(scratch);
      return mx ? rt_fold_launch<rt_imono<RT_OP_MAX>>(pi, static_cast<int*>(out), si, nrows,
                                                      ncomp, batch, rsplit, stream)
                : rt_fold_launch<rt_imono<RT_OP_SUM>>(pi, static_cast<int*>(out), si, nrows,
                                                      ncomp, batch, rsplit, stream);
    }
    case RT_FOLD_BF16:
      return mx ? rt_fold_launch<rt_mono<RT_OP_MAX>>(pf, static_cast<__nv_bfloat16*>(out), sf,
                                                     nrows, ncomp, batch, rsplit, stream)
                : rt_fold_launch<rt_mono<RT_OP_SUM>>(pf, static_cast<__nv_bfloat16*>(out), sf,
                                                     nrows, ncomp, batch, rsplit, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// partials: (batch, nrows, ncomp) -> out: (batch, ncomp); scratch:
// batch * rt_reduce_fold_scratch(nrows, ncomp) floats.  K2S with one segment.
int rt_reduce_fold_batched(const float* partials, float* out, float* scratch, long long nrows,
                           int ncomp, int batch, int op, cudaStream_t stream) {
  return rt_reduce_fold_split(partials, out, scratch, nrows, ncomp, batch, 1, op, RT_FOLD_F32,
                              stream);
}

int rt_reduce_fold(const float* partials, float* out, float* scratch, long long nrows,
                   int ncomp, int op, cudaStream_t stream) {
  return rt_reduce_fold_batched(partials, out, scratch, nrows, ncomp, 1, op, stream);
}

// The compensated pass 2: partials (batch, nrows, ncomp, 2) -> out (batch,
// ncomp), the his; scratch: 2 * batch * rt_reduce_fold_scratch floats.
int rt_reduce_fold_comp(const float* partials, float* out, float* scratch, long long nrows,
                        int ncomp, int batch, cudaStream_t stream) {
  return rt_reduce_fold_split(partials, out, scratch, nrows, ncomp, batch, 1, RT_OP_SUM,
                              RT_FOLD_COMP, stream);
}

}  // extern "C"
