// bf16 storage for the kernels' mixed-precision instances (a DtypePolicy
// with storage "bfloat16" and compute "float32", core/plan.py).
//
// The JAX package rounds a policy launch's float inputs to the storage dtype
// before its pallas_call and widens them to the compute dtype
// (core/fuse.py::_stage_in_cast :349); its kernels write float field outputs
// in the storage dtype.  Here the kernels read the caller's fp32 tensors and
// round each value in registers as they load it: the same values, without a
// pass over device memory to make a bf16 copy.  Rounding is
// __float2bfloat16_rn (round to nearest, ties to even), the conversion
// torch's .to(torch.bfloat16) makes on the card, so the rounded values and
// every bf16 output are bitwise torch's, -0.0, infinities, subnormals and
// NaN included.  (On the CPU, torch and jnp round finite values the same
// way but give NaN other payloads.)
#pragma once

#include <cuda_bf16.h>

#include "common.cuh"

// x rounded to bf16 and widened back to fp32 when RB, else x.
template <bool RB>
__device__ __forceinline__ float rt_bf16_if(float x) {
  return RB ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

// A load and a store in the storage type T (float or __nv_bfloat16) with
// fp32 in registers.
__device__ __forceinline__ float rt_ld(const float* __restrict__ p, long long i) { return p[i]; }
__device__ __forceinline__ float rt_ld(const __nv_bfloat16* __restrict__ p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void rt_st(float* __restrict__ p, long long i, float v) { p[i] = v; }
__device__ __forceinline__ void rt_st(__nv_bfloat16* __restrict__ p, long long i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

// The storage type of a kernel's float outputs: bf16 when BF.
template <bool BF>
struct rt_storage {
  typedef float type;
};
template <>
struct rt_storage<true> {
  typedef __nv_bfloat16 type;
};

// Whether T is the bf16 storage type.
template <typename T>
struct rt_is_bf16 {
  static constexpr bool value = false;
};
template <>
struct rt_is_bf16<__nv_bfloat16> {
  static constexpr bool value = true;
};
