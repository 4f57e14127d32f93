// Compensated fp32 sums: the accumulate slot of a DtypePolicy ("float64",
// which resolves to compensated fp32, or "compensated"; core/plan.py::
// resolve_accumulate).
//
// The JAX package folds a block's sites plainly and carries a Kahan (sum,
// compensation) pair from one grid step to the next (core/fuse.py::
// _kahan_combine :253, core/reduce.py:140), which relies on the TPU's
// grid running in order.  CUDA blocks run concurrently, so here every
// partial is a pair (hi, lo) whose sum hi + lo carries the rounding error
// along: values enter as (x, 0), two pairs combine by TwoSum of the high
// parts (exact) with the low parts added to its error, then renormalise
// (hi = fl(hi + lo)).  Each block folds its sites into one pair a component
// in a fixed tree (warp shuffles, then the warps in order); reduce.cu's
// compensated passes fold pairs in its fixed trees.  No atomics:
// a fixed plan gives the same bits on every run.  The error of the result
// is a few fp32 ulps of the sum plus O(eps^2) of the sum of |x|, against
// Kahan's 2 eps of the sum of |x|.
//
// Every operation is an __f*_rn intrinsic: nvcc may not contract a product
// into the adds (an FMA would change which error TwoSum recovers) nor
// reorder them, whatever its flags.  A product that feeds a pair is
// written __fmul_rn by its caller for the same reason.
#pragma once

#include "common.cuh"

struct rt_pair {
  float hi, lo;  // the sum hi + lo, hi = fl(hi + lo)
};

__device__ __forceinline__ rt_pair rt_pair_add(rt_pair a, rt_pair b) {
  const float s = __fadd_rn(a.hi, b.hi);
  const float bv = __fsub_rn(s, a.hi);
  const float av = __fsub_rn(s, bv);
  const float e = __fadd_rn(__fsub_rn(a.hi, av), __fsub_rn(b.hi, bv));  // s + e = a.hi + b.hi
  const float lo = __fadd_rn(__fadd_rn(a.lo, b.lo), e);
  const float hi = __fadd_rn(s, lo);
  return {hi, __fsub_rn(lo, __fsub_rn(hi, s))};
}

// Fold a pair across the 32 lanes of a warp (result in lane 0), in the same
// tree order as rt_warp_fold.  Every lane of the warp must take part.
__device__ __forceinline__ rt_pair rt_warp_fold_pair(rt_pair x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = rt_pair_add(x, rt_pair{__shfl_down_sync(0xffffffffu, x.hi, off),
                               __shfl_down_sync(0xffffffffu, x.lo, off)});
  return x;
}

// rt_block_partials with compensation: fold NCOMP per-thread values over the
// block and write the block's pairs row[2 c + {0, 1}] = (hi, lo).  Must be
// reached by every thread of the block; threads without a site pass 0.
template <int NCOMP>
__device__ __forceinline__ void rt_block_partials_comp(const float (&v)[NCOMP],
                                                       float* __restrict__ row) {
  __shared__ rt_pair smem[NCOMP * RT_MAX_WARPS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int c = 0; c < NCOMP; ++c) {
    const rt_pair x = rt_warp_fold_pair(rt_pair{v[c], 0.0f});
    if (lane == 0) smem[c * RT_MAX_WARPS + warp] = x;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < NCOMP; c += blockDim.x) {
    rt_pair acc = smem[c * RT_MAX_WARPS];
    for (int w = 1; w < nwarps; ++w) acc = rt_pair_add(acc, smem[c * RT_MAX_WARPS + w]);
    row[2 * c] = acc.hi;
    row[2 * c + 1] = acc.lo;
  }
}
