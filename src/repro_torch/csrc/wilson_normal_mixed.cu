// K5 and K5B under a DtypePolicy: the policy instance of the fused normal
// operator of the CG solve (wilson_normal.cu),
//
//   t  = g5(p - kappa D p)            p and u as stored in the policy's dtype
//   ap = g5(t - kappa D t)            written in the storage dtype
//   pap[c] = sum_sites p[c] * ap[c]   ap before its write's rounding
//
// Replaces the policy instance of the TPU kernel core/fuse.py::
// LaunchGraph._build_nd (fused_kernel :1721, finish_tile :1697; the policy:
// _stage_in_cast :349 and :1514-1542, the outputs' dtypes :960-985) for the
// wilson_normal graph, which the refined solve (apps/milc/cg.py::cg_refined)
// and refined serving run every iteration under storage "bfloat16",
// compute "float32", accumulate "float64".  What the reference does, and
// what these kernels do for it:
//
//   - p and u are rounded to bf16 before the pallas_call and widened to
//     fp32 (the stage-in cast).  Here every load of p and u is rounded in
//     registers (RB; bf16.cuh): the same values, with no bf16 copy made.
//   - t lives in VMEM in fp32 and is never rounded: the t scratch here
//     stays fp32 (SoA), and the ap kernel reads it as it is.
//   - ap is computed in fp32 and written in bf16; pap_prod = p * ap takes
//     the fp32 ap, before the write's rounding (the reference refolds the
//     fp32 source of the reduction, :1525-1535).
//   - pap accumulates compensated (accumulate "float64" resolves to
//     compensated fp32): each block folds its sites into (hi, lo) pairs
//     (comp.cuh), which reduce.cu's compensated pass 2 folds.  The
//     reference folds a block plainly and carries Kahan pairs across the
//     grid (_kahan_combine :253); this is held to the fp64 sum instead.
//
// The kernels are wilson_normal.cuh's templates, the policy-free code,
// instantiated here with the policy flags (RB, TAP, COMP) on.  Entry points:
//   rt_wilson_normal_t_mixed   t with p and u rounded to bf16 (storage
//                              "bfloat16"; under an fp32 storage the
//                              policy-free rt_wilson_normal_t is t's kernel);
//   rt_wilson_normal_ap_mixed  ap and pap's partials; bf16 != 0 rounds u
//                              and p at load and writes ap in bf16, comp
//                              != 0 writes compensated pairs.  Without
//                              either it refuses: the caller runs the
//                              policy-free kernels (the empty policy is the
//                              policy-free code).
// Both take the slot as blockIdx.y (K5B); a launch of one slot runs the
// same instantiation with batch 1, so each slot is bitwise the one-slot
// launch on that slot.  Under bf16 0 the ap kernel's fields are those of
// wilson_normal.cu bitwise (the same template with RB off).
//
// Bound on the H100: bytes.  The reference's traffic model counts a policy
// launch at the storage itemsize, 240 B a site (p, u in and ap out in bf16)
// against 480; these kernels read the caller's fp32 p and u, so they move
// 96 + 288 + 48 = 432 compulsory bytes a site, plus t's round trip as K5
// does.  A bf16 copy of u made once per operator would bring the reads to
// 96 + 144 (ROADMAP perf item).  The rounding is 3 integer operations a
// value loaded, well under the memory time.  These instantiations live in
// a translation unit of their own, compiled beside wilson_normal.cu, so
// the policy-free unit's build time does not grow.

#include "wilson_normal.cuh"

extern "C" {

// p: batch spinors, u: one 72 x V field, in the layouts of descriptors lp,
// lu; t: (batch, 24, V) SoA, fp32.
int rt_wilson_normal_t_mixed(const float* p, const float* u, float* t, float kappa, int X, int Y,
                             int Z, int T, int batch, int lp, int lu, int block,
                             cudaStream_t stream) {
  const long long V = (long long)X * Y * Z * T;
  const rt_layout L[2] = {rt_make_layout(lp), rt_make_layout(lu)};
  const int k = rt_launch_class(L, 2);
  if (k < 0) return RT_BAD_LAYOUT;
  if (V == 0 || batch == 0) return 0;
  const dim3 grid(rt_grid(V, block), batch);
  RT_WITH_CLASS(k, wilson_normal_t_kernel<RT_K, true, true><<<grid, block, 0, stream>>>(
                       p, u, t, kappa, rt_lattice{X, Y, Z, T}, L[0], L[1]));
  RT_LAUNCH_RESULT();
}

// p: batch spinors, u: one 72 x V field, ap: batch spinors (bf16 when bf16,
// else fp32), in the layouts of descriptors lp, lu, lap; t: (batch, 24, V)
// SoA fp32; partials: (batch, ceil(V / block), 24) and a trailing (2,) when
// comp.
int rt_wilson_normal_ap_mixed(const float* p, const float* t, const float* u, void* ap,
                              float* partials, float kappa, int X, int Y, int Z, int T,
                              int batch, int bf16, int comp, int lp, int lu, int lap, int block,
                              cudaStream_t stream) {
  const long long V = (long long)X * Y * Z * T;
  const rt_layout L[3] = {rt_make_layout(lp), rt_make_layout(lu), rt_make_layout(lap)};
  const int k = rt_launch_class(L, 3);
  if (k < 0) return RT_BAD_LAYOUT;
  if (V == 0 || batch == 0) return 0;
  const dim3 grid(rt_grid(V, block), batch);
  const rt_lattice lat{X, Y, Z, T};
  __nv_bfloat16* ap16 = static_cast<__nv_bfloat16*>(ap);
  if (bf16 && comp)
    RT_WITH_CLASS(k, wilson_normal_ap_kernel<RT_K, true, true, __nv_bfloat16, true>
                  <<<grid, block, 0, stream>>>(p, t, u, ap16, partials, kappa, lat, L[0], L[1],
                                               L[2]))
  else if (bf16)
    RT_WITH_CLASS(k, wilson_normal_ap_kernel<RT_K, true, true, __nv_bfloat16, false>
                  <<<grid, block, 0, stream>>>(p, t, u, ap16, partials, kappa, lat, L[0], L[1],
                                               L[2]))
  else if (comp)
    RT_WITH_CLASS(k, wilson_normal_ap_kernel<RT_K, true, false, float, true>
                  <<<grid, block, 0, stream>>>(p, t, u, static_cast<float*>(ap), partials, kappa,
                                               lat, L[0], L[1], L[2]))
  else
    return static_cast<int>(cudaErrorInvalidValue);  // no policy: wilson_normal.cu's kernels
  RT_LAUNCH_RESULT();
}

}  // extern "C"
