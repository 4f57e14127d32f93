// Shared helpers of the hand-written kernels: reduction monoids and the
// deterministic per-block fold that replaces the TPU's grid-sequential
// accumulator.
//
// On the TPU a Pallas grid runs in order on one core, so the JAX package
// initialises an accumulator at program 0 and read-modify-writes it from
// every later program (core/reduce.py:106, core/fuse.py:2032).  CUDA blocks
// run concurrently in no order, so that idiom is a race here.  Every
// reduction in this library is instead two passes with no atomics: each
// block writes its own partial row, and a second kernel folds the rows in a
// fixed order (reduce.cu).  A fixed plan therefore gives the same bits on
// every run.
#pragma once

#include <cuda_runtime.h>

#define RT_OP_SUM 0
#define RT_OP_MAX 1
#define RT_MAX_WARPS 32  // 1024 threads per block at most

__device__ __forceinline__ float rt_combine(float a, float b, int op) {
  return op == RT_OP_MAX ? fmaxf(a, b) : a + b;
}

__device__ __forceinline__ float rt_identity(int op) {
  return op == RT_OP_MAX ? __int_as_float(0xff800000) : 0.0f;  // -inf or 0
}

// Fold a value across the 32 lanes of a warp (result in lane 0), always in
// the same tree order.  Every lane of the warp must take part.
__device__ __forceinline__ float rt_warp_fold(float x, int op) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = rt_combine(x, __shfl_down_sync(0xffffffffu, x, off), op);
  return x;
}

// Fold NCOMP per-thread values over the whole block and write the block's
// partial row partials[blockIdx.x * NCOMP + c].  blockDim.x must be a whole
// number of warps; threads without a site pass the identity.  Must be
// reached by every thread of the block.
template <int NCOMP>
__device__ __forceinline__ void rt_block_partials(const float (&v)[NCOMP], int op,
                                                  float* __restrict__ partials) {
  __shared__ float smem[NCOMP * RT_MAX_WARPS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int c = 0; c < NCOMP; ++c) {
    const float x = rt_warp_fold(v[c], op);
    if (lane == 0) smem[c * RT_MAX_WARPS + warp] = x;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < NCOMP; c += blockDim.x) {
    float acc = smem[c * RT_MAX_WARPS];
    for (int w = 1; w < nwarps; ++w) acc = rt_combine(acc, smem[c * RT_MAX_WARPS + w], op);
    partials[(long long)blockIdx.x * NCOMP + c] = acc;
  }
}

// Blocks needed to give each of n items one thread.
static inline unsigned int rt_grid(long long n, int block) {
  return static_cast<unsigned int>((n + block - 1) / block);
}

// Returned by every C entry point: the launch's cudaGetLastError().
#define RT_LAUNCH_RESULT() return static_cast<int>(cudaGetLastError())
