// K5: the fused normal operator of the CG solve,
//
//   t  = g5(p - kappa D p)
//   ap = g5(t - kappa D t)          (= M^dag M p)
//   pap[c] = sum_sites p[c] * ap[c]
//
// Replaces the TPU kernel core/fuse.py::LaunchGraph._build_nd (inner
// fused_kernel :1721, tail finish_tile :1697, pallas_call :1914) for the
// wilson_normal graph of apps/milc/cg.py.  The TPU kernel stages the whole
// ring-2 halo'd lattice in VMEM and recomputes t on the halo ring so both
// dslash stages run in one program (fuse.py:1741-1779).  A Hopper block has
// at most 227 KB of shared memory and blocks cannot see each other's
// results, so neither is possible here.  The simple design is two launches
// that share K4's site function (wilson.cuh) with periodic indexing:
//
//   rt_wilson_normal_t   writes t to a scratch spinor;
//   rt_wilson_normal_ap  writes ap and the per-block partials of p . ap,
//                        which reduce.cu's pass 2 folds (no atomics).
//
// No halo copy is made.  p, u and ap each come with a layout descriptor
// (SoA, AoS or AoSoA) and are addressed through INDEX (rt_at, common.cuh);
// the intermediate t is the kernels' own scratch and stays SoA.  The
// reference's staged-nd view relayouts non-SoA inputs with XLA ops outside
// its kernel (fuse.py:1518-1524); loading through INDEX in the kernel gives
// the same bits without that relayout's two passes over device memory.
// The ap kernel's block folds the same sites in the same order in every
// layout, so ap and the pap partials are bitwise the SoA launch's.
//
// Bound on the H100: bytes.  Compulsory traffic is p + u in, ap out: 480 B
// a site (1.20 ms at (64, 64, 64, 32)).  The two launches need 1,056 B a
// site (the t launch: p, u in, t out, 480 B; the ap launch: t, u, p in, ap
// out, 576 B), a design floor of 2.64 ms there.  One launch that recomputed
// t on a one-site halo in shared memory would not save them: the halo is
// 4-D, t costs 96 B a site, so a 227 KB block holds t for at most 2,420
// sites with their halo, and a 4^4 tile needs t on 6^4 = 1,296 sites (5.1x
// the t work) and p on 8^4.  So the design is the two launches run near
// their own bytes: the blocks run in a brick order (rt_order,
// wilson_normal.cuh) whose reuse distances fit the 50 MB L2, where the
// linear order re-read every x-neighbour from device memory, and a slot's
// fields are addressed with 32-bit offsets (64-bit where 72 V >= 2^31).
//
// K5B, the batch instance (_build_nd's fused_kernel on the leading batch
// grid axis, the serving path's one operator launch for every slot): the
// same two kernels with a thread computing its site for a group of
// RT_NORMAL_SLOTS slots, each link loaded once for the group, and the
// groups of a chunk next to each other in the block order.  p, t and ap
// are batch spinors one after another, u is one field shared by every
// slot, and each slot writes its own table of pap partials.  A slot's adds
// are the single kernel's, in its order, so each slot's ap and partials are
// bitwise the single launch's on that slot; the single entry points are the
// batch entry with one slot, which runs the kernels' one-slot instantiation
// (SB = 1).  Design floor at B = 4, u read once: 1,056 + 1,440 B a site,
// 6.25 ms.
//
// K5T, the tiled instance (_build_nd's dma_kernel :1804, pallas_call
// :1914, for the wilson_normal graph under a tiled plan): the same two
// kernels with their blocks taking the sites in the plan's tile walk
// (wilson_normal.cuh, rt_walk), single and batched.  The TPU kernel
// DMAs each tile's halo'd window (ring 2, t whole) into VMEM and
// recomputes t on the window's ring; here t stays a whole-lattice scratch
// written by the first launch, so nothing is recomputed and no window is
// staged: K5T holds no shared memory beyond the partials' fold (3 KB), so
// no budget limits it.  t and ap are bitwise K5's; pap's partial rows are
// the walk's units, folded by K2 in walk order.  At the finest tile the
// walk is the linear order (the order K5 left for its brick order at
// 5.25 against 4.30 ms, PERF.md §6).
//
// The two kernels are templates in wilson_normal.cuh, whose policy flags
// this file leaves off; wilson_normal_mixed.cu instantiates the policy
// instance from the same templates.

#include "wilson_normal.cuh"

// The t launch of K5 (no tile) or K5T (a tile), checked.
static int rt_normal_t(const float* p, const float* u, float* t, float kappa, int X, int Y, int Z,
                       int T, int batch, const int (&tile)[3], int lp, int lu, int block,
                       cudaStream_t stream) {
  const rt_lattice lat{X, Y, Z, T};
  const rt_layout L[2] = {rt_make_layout(lp), rt_make_layout(lu)};
  const int k = rt_launch_class(L, 2);
  if (k < 0 || !rt_normal_block_ok(block)) return RT_BAD_LAYOUT;
  if (tile[0] && !rt_normal_tile_ok(lat, tile)) return static_cast<int>(cudaErrorInvalidValue);
  if ((long long)X * Y * Z * T == 0 || batch == 0) return 0;
  RT_NORMAL_DISPATCH(k, lat, batch, RT_NORMAL_SLOTS,
                     (rt_launch_normal_t<RT_K, RT_IDX, RT_SB, false, float>(
                         p, u, t, kappa, lat, L, batch, block, tile, stream)))
  RT_LAUNCH_RESULT();
}

// The ap launch, likewise.
static int rt_normal_ap(const float* p, const float* t, const float* u, float* ap,
                        float* partials, float kappa, int X, int Y, int Z, int T, int batch,
                        const int (&tile)[3], int lp, int lu, int lap, int block,
                        cudaStream_t stream) {
  const rt_lattice lat{X, Y, Z, T};
  const rt_layout L[3] = {rt_make_layout(lp), rt_make_layout(lu), rt_make_layout(lap)};
  const int k = rt_launch_class(L, 3);
  if (k < 0 || !rt_normal_block_ok(block)) return RT_BAD_LAYOUT;
  if (tile[0] && !rt_normal_tile_ok(lat, tile)) return static_cast<int>(cudaErrorInvalidValue);
  if ((long long)X * Y * Z * T == 0 || batch == 0) return 0;
  RT_NORMAL_DISPATCH(k, lat, batch, RT_NORMAL_SLOTS,
                     (rt_launch_normal_ap<RT_K, RT_IDX, RT_SB, false, float, false, float>(
                         p, t, u, ap, partials, kappa, lat, L, batch, block, tile, stream)))
  RT_LAUNCH_RESULT();
}

extern "C" {

// p: batch spinors (24 x V each, one after another), u: one 72 x V field, in
// the layouts of descriptors lp, lu; t: (batch, 24, V) SoA.  block: the
// sites of a chunk (a whole number of warps).
int rt_wilson_normal_t_batched(const float* p, const float* u, float* t, float kappa, int X,
                               int Y, int Z, int T, int batch, int lp, int lu, int block,
                               cudaStream_t stream) {
  return rt_normal_t(p, u, t, kappa, X, Y, Z, T, batch, RT_NO_TILE, lp, lu, block, stream);
}

// p, ap: batch spinors, u: one 72 x V field, in the layouts of descriptors
// lp, lu, lap; t: (batch, 24, V) SoA; partials: (batch, ceil(V / block), 24),
// row q the chunk of sites [q block, (q + 1) block).
int rt_wilson_normal_ap_batched(const float* p, const float* t, const float* u, float* ap,
                                float* partials, float kappa, int X, int Y, int Z, int T,
                                int batch, int lp, int lu, int lap, int block,
                                cudaStream_t stream) {
  return rt_normal_ap(p, t, u, ap, partials, kappa, X, Y, Z, T, batch, RT_NO_TILE, lp, lu, lap,
                      block, stream);
}

// p: 24 x V, u: 72 x V in the layouts of descriptors lp, lu; t: (24, V) SoA.
int rt_wilson_normal_t(const float* p, const float* u, float* t, float kappa, int X, int Y,
                       int Z, int T, int lp, int lu, int block, cudaStream_t stream) {
  return rt_wilson_normal_t_batched(p, u, t, kappa, X, Y, Z, T, 1, lp, lu, block, stream);
}

// p, ap: 24 x V, u: 72 x V in the layouts of descriptors lp, lu, lap;
// t: (24, V) SoA; partials: (ceil(V / block), 24).
int rt_wilson_normal_ap(const float* p, const float* t, const float* u, float* ap,
                        float* partials, float kappa, int X, int Y, int Z, int T, int lp, int lu,
                        int lap, int block, cudaStream_t stream) {
  return rt_wilson_normal_ap_batched(p, t, u, ap, partials, kappa, X, Y, Z, T, 1, lp, lu, lap,
                                     block, stream);
}

// K5T: as rt_wilson_normal_t_batched, the blocks walking the tile (bx, by,
// bz), each >= 1 and dividing its dim (T whole); cudaErrorInvalidValue for
// any other.
int rt_wilson_normal_t_tiled(const float* p, const float* u, float* t, float kappa, int X, int Y,
                             int Z, int T, int batch, int bx, int by, int bz, int lp, int lu,
                             int block, cudaStream_t stream) {
  const int tile[3] = {bx, by, bz};
  if (bx < 1) return static_cast<int>(cudaErrorInvalidValue);
  return rt_normal_t(p, u, t, kappa, X, Y, Z, T, batch, tile, lp, lu, block, stream);
}

// K5T: as rt_wilson_normal_ap_batched, walking the tile; partials: (batch,
// ceil(V / block), 24), row q the walk positions [q block, (q + 1) block).
int rt_wilson_normal_ap_tiled(const float* p, const float* t, const float* u, float* ap,
                              float* partials, float kappa, int X, int Y, int Z, int T, int batch,
                              int bx, int by, int bz, int lp, int lu, int lap, int block,
                              cudaStream_t stream) {
  const int tile[3] = {bx, by, bz};
  if (bx < 1) return static_cast<int>(cudaErrorInvalidValue);
  return rt_normal_ap(p, t, u, ap, partials, kappa, X, Y, Z, T, batch, tile, lp, lu, lap, block,
                      stream);
}

}  // extern "C"
