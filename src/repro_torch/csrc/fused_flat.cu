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
// of its site), one per element for cg_xpay.
//
// Layouts: every tensor comes with its own layout descriptor (SoA, AoS or
// AoSoA; common.cuh).  cg_update addresses component c of its site at
// INDEX(c, s) in each tensor's layout; its block folds the same sites in
// the same order in every layout, so fields and partials are bitwise the
// SoA launch's.  cg_xpay walks the flat arrays when its three operands
// share a layout (layout-free, coalesced in any layout) and otherwise
// recovers each output element's (component, site) from the output's
// layout.  Under AoS the per-site loads of cg_update are ncomp floats apart
// across a warp: every load touches a sector of its own.
//
// nvcc contracts y + a*x into one fused multiply-add, so these fields match
// the plain two-rounding torch version to a tolerance, not bitwise.

#include "common.cuh"

#define RT_SPINOR 24

// Layouts of cg_update's tensors, in argument order.
struct rt_cg_layouts {
  rt_layout x, r, p, ap, x_new, r_new;
};

template <int K>
__global__ void cg_update_kernel(const float* __restrict__ x, const float* __restrict__ r,
                                 const float* __restrict__ p, const float* __restrict__ ap,
                                 const float* __restrict__ alpha,
                                 const float* __restrict__ neg_alpha,
                                 float* __restrict__ x_new, float* __restrict__ r_new,
                                 float* __restrict__ partials, long long nsites,
                                 rt_cg_layouts L) {
  const long long s = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const bool live = s < nsites;
  const float a = *alpha;
  const float na = *neg_alpha;
  float sq[RT_SPINOR];
#pragma unroll
  for (int c = 0; c < RT_SPINOR; ++c) {
    sq[c] = 0.0f;
    if (live) {
      x_new[rt_at<K>(L.x_new, c, s, RT_SPINOR, nsites)] =
          x[rt_at<K>(L.x, c, s, RT_SPINOR, nsites)] +
          a * p[rt_at<K>(L.p, c, s, RT_SPINOR, nsites)];
      const float rn = r[rt_at<K>(L.r, c, s, RT_SPINOR, nsites)] +
                       na * ap[rt_at<K>(L.ap, c, s, RT_SPINOR, nsites)];
      r_new[rt_at<K>(L.r_new, c, s, RT_SPINOR, nsites)] = rn;
      sq[c] = rn * rn;
    }
  }
  rt_block_partials<RT_SPINOR>(sq, RT_OP_SUM, partials);
}

// MIXED: the three operands' layouts differ.
template <bool MIXED>
__global__ void cg_xpay_kernel(const float* __restrict__ x, const float* __restrict__ y,
                               const float* __restrict__ a, float* __restrict__ out, int ncomp,
                               long long nsites, rt_layout lx, rt_layout ly, rt_layout lo) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= (long long)ncomp * nsites) return;
  if (!MIXED) {
    out[i] = y[i] + *a * x[i];
    return;
  }
  int c;
  long long s;
  rt_coords(lo, i, ncomp, nsites, c, s);
  out[i] = y[rt_index(ly, c, s, ncomp, nsites)] + *a * x[rt_index(lx, c, s, ncomp, nsites)];
}

extern "C" {

// x, r, p, ap, x_new, r_new: 24 x nsites fields, each in the layout of its
// descriptor (lx ... lrn); alpha, neg_alpha: one fp32 on the device each;
// partials: (ceil(nsites / block), 24).
int rt_cg_update(const float* x, const float* r, const float* p, const float* ap,
                 const float* alpha, const float* neg_alpha, float* x_new, float* r_new,
                 float* partials, long long nsites, int lx, int lr, int lp, int lap, int lxn,
                 int lrn, int block, cudaStream_t stream) {
  const rt_layout L[6] = {rt_make_layout(lx),  rt_make_layout(lr),  rt_make_layout(lp),
                          rt_make_layout(lap), rt_make_layout(lxn), rt_make_layout(lrn)};
  const int k = rt_launch_class(L, 6);
  if (k < 0) return RT_BAD_LAYOUT;
  if (nsites == 0) return 0;
  const rt_cg_layouts cl{L[0], L[1], L[2], L[3], L[4], L[5]};
  RT_WITH_CLASS(k, cg_update_kernel<RT_K><<<rt_grid(nsites, block), block, 0, stream>>>(
                       x, r, p, ap, alpha, neg_alpha, x_new, r_new, partials, nsites, cl));
  RT_LAUNCH_RESULT();
}

// x, y, out: ncomp x nsites fields in layouts lx, ly, lo; a: one fp32 on the
// device.
int rt_cg_xpay(const float* x, const float* y, const float* a, float* out, int ncomp,
               long long nsites, int lx, int ly, int lo, int block, cudaStream_t stream) {
  const long long n = (long long)ncomp * nsites;
  const rt_layout L[3] = {rt_make_layout(lx), rt_make_layout(ly), rt_make_layout(lo)};
  if (rt_launch_class(L, 3) < 0) return RT_BAD_LAYOUT;
  if (n == 0) return 0;
  if (rt_same_layout(L[0], L[2]) && rt_same_layout(L[1], L[2]))
    cg_xpay_kernel<false><<<rt_grid(n, block), block, 0, stream>>>(x, y, a, out, ncomp, nsites,
                                                                    L[0], L[1], L[2]);
  else
    cg_xpay_kernel<true><<<rt_grid(n, block), block, 0, stream>>>(x, y, a, out, ncomp, nsites,
                                                                   L[0], L[1], L[2]);
  RT_LAUNCH_RESULT();
}

}  // extern "C"
