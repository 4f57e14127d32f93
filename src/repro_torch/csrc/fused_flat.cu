// K3: the site-local fused chains of the CG iteration.
//
// Replaces the TPU kernel core/fuse.py::LaunchGraph._build_flat (inner
// fused_kernel :1411, pallas_call :1447, accumulating through _accumulate
// :2032) for the two graph signatures the solve runs; runtime scalars arrive
// as device pointers (the Pallas kernel took them as (1,1) inputs), so the
// host never reads alpha or beta:
//
//   rt_cg_update  x_new = x + alpha p,  r_new = r + neg_alpha ap,  and the
//                 per-block partials of sum_sites r_new^2 per component
//                 (folded by reduce.cu's pass 2; no atomics, no race).
//   rt_cg_xpay    out = y + a x.
//
// Bound on the H100: bytes.  cg_update reads 4 and writes 2 spinors per
// site (576 B) for 3 flops per component; cg_xpay reads 2 and writes 1
// (288 B).  One thread per site for cg_update (it folds all 24 components
// of its site), one per element for cg_xpay; both coalesce on SoA.
//
// nvcc contracts y + a*x into one fused multiply-add, so these fields match
// the plain two-rounding torch version to a tolerance, not bitwise.

#include "common.cuh"

#define RT_SPINOR 24

__global__ void cg_update_kernel(const float* __restrict__ x, const float* __restrict__ r,
                                 const float* __restrict__ p, const float* __restrict__ ap,
                                 const float* __restrict__ alpha,
                                 const float* __restrict__ neg_alpha,
                                 float* __restrict__ x_new, float* __restrict__ r_new,
                                 float* __restrict__ partials, long long nsites) {
  const long long s = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const bool live = s < nsites;
  const float a = *alpha;
  const float na = *neg_alpha;
  float sq[RT_SPINOR];
#pragma unroll
  for (int c = 0; c < RT_SPINOR; ++c) {
    sq[c] = 0.0f;
    if (live) {
      const long long i = (long long)c * nsites + s;
      x_new[i] = x[i] + a * p[i];
      const float rn = r[i] + na * ap[i];
      r_new[i] = rn;
      sq[c] = rn * rn;
    }
  }
  rt_block_partials<RT_SPINOR>(sq, RT_OP_SUM, partials);
}

__global__ void cg_xpay_kernel(const float* __restrict__ x, const float* __restrict__ y,
                               const float* __restrict__ a, float* __restrict__ out,
                               long long n) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = y[i] + *a * x[i];
}

extern "C" {

// x, r, p, ap, x_new, r_new: (24, nsites) SoA; alpha, neg_alpha: one fp32 on
// the device each; partials: (ceil(nsites / block), 24).
int rt_cg_update(const float* x, const float* r, const float* p, const float* ap,
                 const float* alpha, const float* neg_alpha, float* x_new, float* r_new,
                 float* partials, long long nsites, int block, cudaStream_t stream) {
  if (nsites == 0) return 0;
  cg_update_kernel<<<rt_grid(nsites, block), block, 0, stream>>>(
      x, r, p, ap, alpha, neg_alpha, x_new, r_new, partials, nsites);
  RT_LAUNCH_RESULT();
}

// x, y, out: n fp32 each; a: one fp32 on the device.
int rt_cg_xpay(const float* x, const float* y, const float* a, float* out, long long n,
               int block, cudaStream_t stream) {
  if (n == 0) return 0;
  cg_xpay_kernel<<<rt_grid(n, block), block, 0, stream>>>(x, y, a, out, n);
  RT_LAUNCH_RESULT();
}

}  // extern "C"
