// The two kernels of K5, the fused normal operator of the CG solve,
//
//   wilson_normal_t_kernel   t  = g5(p - kappa D p)       (scratch, SoA, fp32)
//   wilson_normal_ap_kernel  ap = g5(t - kappa D t)       (= M^dag M p)
//                            and the per-block partials of pap[c] = p[c] . ap[c]
//
// shared by the policy-free instance (wilson_normal.cu) and the DtypePolicy
// instance (wilson_normal_mixed.cu), each of which instantiates its own
// flags.  Template flags, all off in the policy-free instance:
//
//   BATCH  offset p, t, ap and the partials to the slot blockIdx.y (K5B);
//          a launch of one slot takes the instantiation without offsets.
//   RB     round every load of p and u to bf16 and widen it back in
//          registers (the stage-in of a bf16-storage policy; bf16.cuh).
//          t is never rounded: the reference keeps it in VMEM in fp32.
//   TAP    ap's storage type (float, or __nv_bfloat16 under a bf16
//          storage policy).  pap takes ap in fp32, before the write's
//          rounding, as the reference refolds its reduction's fp32 source.
//   COMP   write pap's partials as compensated (hi, lo) pairs (comp.cuh)
//          for reduce.cu's compensated pass 2; the product that feeds a
//          pair is __fmul_rn, so nvcc cannot contract it into the pair's
//          adds.
//
// With every flag off the kernels compile to the policy-free code: RB's
// rounding and COMP's branch are compile-time, and rt_st to a float is a
// plain store.
#pragma once

#include "comp.cuh"
#include "wilson.cuh"

__device__ __forceinline__ float rt_g5_sign(int c) { return c >= 12 ? -1.0f : 1.0f; }

// t's layout: SoA, in every instantiation.
__device__ __forceinline__ rt_layout rt_soa() { return rt_layout{RT_SOA, 1, -1}; }

template <int K, bool BATCH, bool RB = false>
__global__ void wilson_normal_t_kernel(const float* __restrict__ p, const float* __restrict__ u,
                                       float* __restrict__ t, float kappa, rt_lattice L,
                                       rt_layout lp, rt_layout lu) {
  const long long V = (long long)L.X * L.Y * L.Z * L.T;
  const long long s = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (s >= V) return;
  if (BATCH) {
    p += blockIdx.y * 24 * V;
    t += blockIdx.y * 24 * V;
  }
  float d[24];
  rt_wilson_hop<K, K, RB, RB>(rt_wfield{p, lp}, rt_wfield{u, lu}, L, s, d);
#pragma unroll
  for (int c = 0; c < 24; ++c)
    t[(long long)c * V + s] =
        rt_g5_sign(c) * (rt_bf16_if<RB>(p[rt_at<K>(lp, c, s, 24, V)]) - kappa * d[c]);
}

template <int K, bool BATCH, bool RB = false, typename TAP = float, bool COMP = false>
__global__ void wilson_normal_ap_kernel(const float* __restrict__ p, const float* __restrict__ t,
                                        const float* __restrict__ u, TAP* __restrict__ ap,
                                        float* __restrict__ partials, float kappa,
                                        rt_lattice L, rt_layout lp, rt_layout lu,
                                        rt_layout lap) {
  const long long V = (long long)L.X * L.Y * L.Z * L.T;
  const long long s = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (BATCH) {
    p += blockIdx.y * 24 * V;
    t += blockIdx.y * 24 * V;
    ap += blockIdx.y * 24 * V;
    partials += blockIdx.y * (long long)gridDim.x * 24 * (COMP ? 2 : 1);
  }
  float prod[24];
#pragma unroll
  for (int c = 0; c < 24; ++c) prod[c] = 0.0f;
  if (s < V) {
    float d[24];
    rt_wilson_hop<RT_K_SOA, K, false, RB>(rt_wfield{t, rt_soa()}, rt_wfield{u, lu}, L, s, d);
#pragma unroll
    for (int c = 0; c < 24; ++c) {
      const float a = rt_g5_sign(c) * (t[(long long)c * V + s] - kappa * d[c]);
      rt_st(ap, rt_at<K>(lap, c, s, 24, V), a);
      const float pv = rt_bf16_if<RB>(p[rt_at<K>(lp, c, s, 24, V)]);
      if constexpr (COMP)
        prod[c] = __fmul_rn(pv, a);
      else
        prod[c] = pv * a;
    }
  }
  if constexpr (COMP)
    rt_block_partials_comp<24>(prod, partials);
  else
    rt_block_partials<24>(prod, RT_OP_SUM, partials);
}
