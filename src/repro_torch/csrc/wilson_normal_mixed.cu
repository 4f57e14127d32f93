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
//     fp32 (the stage-in cast).  Here u arrives as a bf16 copy, made once
//     per operator (apps/milc/cg.py::make_fused_normal, with bf16.cuh's
//     rounding: rt_bf16_pack, fused_flat.cu), and is widened at load (TU);
//     every load of p is rounded in registers (RB).  The same values as the
//     reference's cast, with no copy of p.
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
//   rt_wilson_normal_t_mixed   t with p rounded to bf16 and u the bf16
//                              copy (storage "bfloat16"; under an fp32
//                              storage the policy-free rt_wilson_normal_t is
//                              t's kernel);
//   rt_wilson_normal_ap_mixed  ap and pap's partials; bf16 != 0 takes u as
//                              the bf16 copy, rounds p at load and writes
//                              ap in bf16, comp != 0 writes compensated
//                              pairs.  Without either it refuses: the
//                              caller runs the policy-free kernels (the
//                              empty policy is the policy-free code).
//   rt_wilson_normal_t_tiled_mixed, rt_wilson_normal_ap_tiled_mixed
//                              K5T's policy instance: the same under a
//                              tiled plan, the blocks walking its tile
//                              (wilson_normal.cuh, rt_walk).
// All run the slots as K5B does (rt_order), one slot a thread
// (RT_NORMAL_SLOTS_POLICY), so a launch of one slot and a launch of many run
// one instantiation, and each slot is bitwise the one-slot launch on that
// slot.
// Under bf16 0 the ap kernel's fields are those of wilson_normal.cu bitwise
// (the same template with RB off).
//
// Bound on the H100: bytes.  The reference's traffic model counts a policy
// launch at the storage itemsize, 240 B a site (p, u in and ap out in bf16)
// against 480; these kernels read the caller's fp32 p and the bf16 u, so
// they move 96 + 144 + 48 = 288 compulsory bytes a site, and the two
// launches 720 B a site with t's round trip (1,008 B with an fp32 u).  The
// rounding of p is 3 integer operations a value loaded, well under the
// memory time.  These instantiations live in a translation unit of their
// own, compiled beside wilson_normal.cu, so the policy-free unit's build
// time does not grow.

#include "wilson_normal.cuh"

// The policy t launch, untiled (tile[0] 0) or walking the tile.
static int rt_normal_t_mixed(const float* p, const __nv_bfloat16* u, float* t, float kappa,
                             int X, int Y, int Z, int T, int batch, const int (&tile)[3], int lp,
                             int lu, int block, cudaStream_t stream) {
  const rt_lattice lat{X, Y, Z, T};
  const rt_layout L[2] = {rt_make_layout(lp), rt_make_layout(lu)};
  const int k = rt_launch_class(L, 2);
  if (k < 0 || !rt_normal_block_ok(block)) return RT_BAD_LAYOUT;
  if (tile[0] && !rt_normal_tile_ok(lat, tile)) return static_cast<int>(cudaErrorInvalidValue);
  if ((long long)X * Y * Z * T == 0 || batch == 0) return 0;
  RT_NORMAL_DISPATCH(k, lat, batch, RT_NORMAL_SLOTS_POLICY,
                     (rt_launch_normal_t<RT_K, RT_IDX, RT_SB, true, __nv_bfloat16>(
                         p, u, t, kappa, lat, L, batch, block, tile, stream)))
  RT_LAUNCH_RESULT();
}

// The policy ap launch of one instantiation: BF (bf16 u, p rounded, bf16
// ap) and COMP, untiled or walking the tile.
template <bool BF, bool COMP>
static void rt_normal_ap_mixed_launch(int k, const rt_lattice& lat, int batch, const float* p,
                                      const float* t, const void* u, void* ap, float* partials,
                                      float kappa, const rt_layout (&L)[3], int block,
                                      const int (&tile)[3], cudaStream_t stream) {
  typedef typename rt_storage<BF>::type TS;
  const TS* us = static_cast<const TS*>(u);
  TS* aps = static_cast<TS*>(ap);
  RT_NORMAL_DISPATCH(k, lat, batch, RT_NORMAL_SLOTS_POLICY,
                     (rt_launch_normal_ap<RT_K, RT_IDX, RT_SB, BF, TS, COMP, TS>(
                         p, t, us, aps, partials, kappa, lat, L, batch, block, tile, stream)))
}

static int rt_normal_ap_mixed(const float* p, const float* t, const void* u, void* ap,
                              float* partials, float kappa, int X, int Y, int Z, int T, int batch,
                              int bf16, int comp, const int (&tile)[3], int lp, int lu, int lap,
                              int block, cudaStream_t stream) {
  const rt_lattice lat{X, Y, Z, T};
  const rt_layout L[3] = {rt_make_layout(lp), rt_make_layout(lu), rt_make_layout(lap)};
  const int k = rt_launch_class(L, 3);
  if (k < 0 || !rt_normal_block_ok(block)) return RT_BAD_LAYOUT;
  if (tile[0] && !rt_normal_tile_ok(lat, tile)) return static_cast<int>(cudaErrorInvalidValue);
  if ((long long)X * Y * Z * T == 0 || batch == 0) return 0;
  if (!bf16 && !comp) return static_cast<int>(cudaErrorInvalidValue);  // wilson_normal.cu's
  if (bf16 && comp)
    rt_normal_ap_mixed_launch<true, true>(k, lat, batch, p, t, u, ap, partials, kappa, L, block,
                                          tile, stream);
  else if (bf16)
    rt_normal_ap_mixed_launch<true, false>(k, lat, batch, p, t, u, ap, partials, kappa, L, block,
                                           tile, stream);
  else
    rt_normal_ap_mixed_launch<false, true>(k, lat, batch, p, t, u, ap, partials, kappa, L,
                                           block, tile, stream);
  RT_LAUNCH_RESULT();
}

extern "C" {

// p: batch spinors in the layout of descriptor lp, u: one 72 x V field of
// bf16 in lu; t: (batch, 24, V) SoA, fp32.
int rt_wilson_normal_t_mixed(const float* p, const __nv_bfloat16* u, float* t, float kappa,
                             int X, int Y, int Z, int T, int batch, int lp, int lu, int block,
                             cudaStream_t stream) {
  return rt_normal_t_mixed(p, u, t, kappa, X, Y, Z, T, batch, RT_NO_TILE, lp, lu, block, stream);
}

// p: batch spinors, u: one 72 x V field (bf16 when bf16, else fp32), ap:
// batch spinors (bf16 when bf16, else fp32), in the layouts of descriptors
// lp, lu, lap; t: (batch, 24, V) SoA fp32; partials: (batch, ceil(V /
// block), 24) and a trailing (2,) when comp.
int rt_wilson_normal_ap_mixed(const float* p, const float* t, const void* u, void* ap,
                              float* partials, float kappa, int X, int Y, int Z, int T,
                              int batch, int bf16, int comp, int lp, int lu, int lap, int block,
                              cudaStream_t stream) {
  return rt_normal_ap_mixed(p, t, u, ap, partials, kappa, X, Y, Z, T, batch, bf16, comp,
                            RT_NO_TILE, lp, lu, lap, block, stream);
}

// K5T's policy instance: as rt_wilson_normal_t_mixed, walking the tile
// (bx, by, bz), each >= 1 and dividing its dim.
int rt_wilson_normal_t_tiled_mixed(const float* p, const __nv_bfloat16* u, float* t, float kappa,
                                   int X, int Y, int Z, int T, int batch, int bx, int by, int bz,
                                   int lp, int lu, int block, cudaStream_t stream) {
  const int tile[3] = {bx, by, bz};
  if (bx < 1) return static_cast<int>(cudaErrorInvalidValue);
  return rt_normal_t_mixed(p, u, t, kappa, X, Y, Z, T, batch, tile, lp, lu, block, stream);
}

// K5T's policy instance: as rt_wilson_normal_ap_mixed, walking the tile.
int rt_wilson_normal_ap_tiled_mixed(const float* p, const float* t, const void* u, void* ap,
                                    float* partials, float kappa, int X, int Y, int Z, int T,
                                    int batch, int bx, int by, int bz, int bf16, int comp, int lp,
                                    int lu, int lap, int block, cudaStream_t stream) {
  const int tile[3] = {bx, by, bz};
  if (bx < 1) return static_cast<int>(cudaErrorInvalidValue);
  return rt_normal_ap_mixed(p, t, u, ap, partials, kappa, X, Y, Z, T, batch, bf16, comp, tile,
                            lp, lu, lap, block, stream);
}

}  // extern "C"
