// K4H, K5H and K5HO: the Wilson hopping term on pre-exchanged halos (the
// sharded MILC solve, apps/milc/driver.py::make_sharded_solver).
//
// K4H rt_dslash_halo replaces kernels/wilson_dslash/kernel.py::
//   dslash_site_pallas (pallas_call :53) as kernels/wilson_dslash/ops.py::
//   dslash_halo (:73) calls it: D psi on the interior (X, Y, Z, T) of a
//   spinor psi_h and a gauge field u_h padded by `width` sites a side
//   (halos exchanged by the caller).  The TPU path gathers the 192-
//   component neighbour pack and the backward links of the whole halo'd
//   array in jnp, crops them and runs the site math on SoA arrays; here one
//   thread a site reads its 8 neighbour spinors and 8 links straight from
//   the halo'd arrays at their own strides (a neighbour is a site +- a
//   stride, never wrapped), so nothing is gathered.
//
// K5H rt_wilson_normal_pre_t / _ap and K5HO rt_wilson_normal_t_boxes /
//   _ap_boxes replace core/fuse.py::LaunchGraph._build_nd (fused_kernel
//   :1721, pallas_call :1914) for the wilson_normal graph under halo="pre"
//   (:794-870) and on the halo="overlap" split's boxes (:986-992,
//   core/overlap.py:83-406): ap = M^dag M p on the interior from p and u
//   padded by 2.  Each is two kernels, as K5, because a site's ap needs t =
//   g5(p - kappa D p) at its 8 neighbours and a block cannot see another's
//   t.  K5H's kernels run on the whole arrays; K5HO's take a table of at
//   most RT_HTAB_MAX boxes and run it in one launch (rt_htab: a box's
//   origin, extents and block range; blockIdx -> box by the prefix of block
//   counts):
//
//     t kernel   t = g5(p - kappa D p) on boxes of ring 1, the
//                (X+2)(Y+2)(Z+2)(T+2) sites around the interior, written
//                into one ring-1 array (SoA, fp32), from p and u at ring 2
//     ap kernel  ap = g5(t - kappa D t) on boxes of the interior, from t
//                and u, written into the whole interior's ap
//
//   K5H launches the whole-array kernels (wilson_normal_pre_*) on the
//   whole ring-1 array, then the whole interior: a table's site map cost
//   them 5-8% (tools/k5h_designs.py, H100 80GB HBM3, 700.00 W).  K5HO is
//   the split of one operator in four launches of the table kernels
//   (wilson_normal_box_*), no t site computed twice: after the fill, t on
//   the interior box grown by 1 (it reads p at owned sites only) and ap on
//   the interior; after the exchange, t on the shell (the ring-1 array less
//   that grown box, at most 8 boxes carved in split_boxes' order) and ap on
//   every boundary box.  Every site's
//   arithmetic is the whole launch's, so the split gives the "pre" launch's
//   bits.  The sharded solve takes <p, Ap> from core dot on the assembled
//   Fields (as the JAX package's does), so no partial rows.
//
// K5TH rt_wilson_normal_pre_t_tiled / _ap_tiled replace the tiled plan's
//   dma_kernel (core/fuse.py:1804, pallas_call :1914) for wilson_normal
//   under halo="pre": K5H's two kernels, their sites walked in K5T's tile
//   order (wilson_normal.cuh::rt_walk_site; T whole in every tile) instead
//   of the brick order, one thread a site, blocks cut linearly.  The ap
//   launch walks the interior; the t launch walks the ring-1 array by its
//   rows, each whole along T: the interior's rows in the walk (each placed
//   1 in), then the rows of the shell (rt_ring1_walk_site).  A first
//   design walked the interior's sites and then the shell's axis by axis:
//   its T faces (a site a row, SoA's fastest axis) took K5TH to 11.77 ms
//   against this design's 6.20 at (64, 64, 64, 32) (chip_smoke.py D1, H100
//   80GB HBM3, 700.00 W).  kernels/wilson_dslash/kernel.py::normal_walk(ring=1)
//   mirrors the walk.  The reference's tiled program stages
//   each tile's halo'd window and recomputes t on the tile's ring; here, as
//   in K5T, nothing is staged and t is computed once a site, so the tile
//   only orders the sites.  Each site's arithmetic is K5H's, so ap is
//   K5H's bits.  K5H's own entry points stay for the untiled plan: the walk
//   is a site map, which cost the whole-array launches 5-8% (above).
//
// Tiled K5HO: a table box may carry its sub-plan's tile (core/plan.py::
//   sub_lattice_plan keeps the outer plan's y/z tiles where they divide the
//   box); its rows then run in that tile's walk (rt_htab).  The split's
//   ap tables carry them (kernel.py::split_tables); the t tables cover the
//   grown interior and the shell, which are no sub-launch's boxes, and stay
//   in the brick order.  Four launches an operator, the T-slab pairing
//   kept; the bits are K5H's.
//
// Both kernels and K4H share wilson.cuh's hop (rt_hop_mu, the direction
// order and the adds of rt_wilson_hop), fed by loaders that read a halo'd
// SoA array; on wrap-padded inputs their fields equal K4's and K5's SoA
// launches' bits where nvcc contracts the same products.
//
// Bound on the H100: bytes.  K4H moves (24 + 72) 4 bytes a halo'd site in
// and 96 an interior site out; K5H the same at ring 2 (1.35x the interior
// at (64, 64, 64, 32)), plus t's traffic, which the design floor counts
// and the bound does not.  A thin box is bound by the 32-byte sectors its
// values lie in (kernel.py::table_footprint): T is the fastest axis of
// every SoA array, so the split's two T-slabs (rows of 2 sites in rows of
// 34-36) use 2 of a sector's 8 floats (sectors over 3.35 TB/s: 0.85 ms for
// their t and ap at (64, 64, 64, 32), bytes 0.34), and a warp's load of one
// component touches 8 or more 128-byte lines where a whole row's touches
// 1-2.  They take 5.1-5.3 ms of the split's 11.0 (H100 80GB HBM3, 700.00
// W).  Pairing the two slabs (below) is 1.6-1.7x faster than one box a
// slab; a thread walking its row's T sites, a warp along z (32 lines a
// load), was 3.6x slower than the pairing (PERF.md section 6,
// tools/k5h_designs.py).
//
// Block order and thread map: a box's x-planes each split into chunks of
// `block` thread slots, run in K5's brick order (wilson_normal.cuh::
// rt_order_chunk: x fastest in a brick of RT_BRICK_X planes), so that a
// site is read again as an x-neighbour one block later.  A row of at most
// RT_HROW_LANES_MAX sites takes a power-of-two run of slots (the rest idle),
// so that a warp never straddles two rows a gap apart (the interior's rows
// of 28 and 30 in arrays of 32-36); longer rows are cut linearly.  The two
// T-slabs of a table are taken as one box with a gap (tsplit, tgap: a
// row's 2 lo sites, then its 2 hi), so that a warp's 32 sites hold 8 rows
// and one row's hi slab shares a line with the next row's lo slab.  Fields
// are fp32 and SoA; offsets are 32-bit where every one fits (72 values of
// the largest box).
//
// A one-launch K5H that streamed x-planes of a tile's t through a shared-
// memory ring (t never in HBM) took 7.87-13.08 ms against this design's
// 5.53-5.64 (H100 80GB HBM3, 700.00 W) and was deleted (PERF.md section
// 6).

#include "wilson_normal.cuh"

#define RT_HTAB_MAX 8            // boxes of a table launch
#define RT_HROW_LANES_MAX 32     // rows up to this long take whole runs of lanes

// A box of sites in an array: the box's extents, the array's extents and
// the box's origin in the array, per axis.
struct rt_hbox {
  rt_lattice box, arr, org;
};

// The brick order over the box's planes of whole chunks (see the header).
struct rt_horder {
  int nq;        // chunks an x-plane: ceil(P / block)
  int X;         // x-planes
  long long P;   // sites an x-plane
};

static inline rt_horder rt_make_horder(const rt_lattice& box, int block) {
  const long long P = (long long)box.Y * box.Z * box.T;
  return rt_horder{(int)((P + block - 1) / block), box.X, P};
}

// The site (linear over the box) of this thread of block i of the box's
// grid, false where it has none.
template <typename I>
__device__ __forceinline__ bool rt_horder_site(const rt_horder& o, int i, I& s) {
  const int per = RT_BRICK_X * o.nq;
  const int brick = i / per;
  const int x0 = RT_BRICK_X * brick;
  const int w = min(RT_BRICK_X, o.X - x0);
  const int r = i - per * brick;
  const I q = (I)(r / w) * blockDim.x + threadIdx.x;
  if (q >= (I)o.P) return false;
  s = (I)(x0 + r % w) * (I)o.P + q;
  return true;
}

// A table of at most RT_HTAB_MAX boxes launched as one grid: box k at
// origin org[k] of the array it is computed in, of extents ext[k]; its T
// index j lies at T = j, or j + tgap[k] from j = tsplit[k] on (two T-slabs
// of one row range taken as one box: tsplit the first slab's width, tgap
// the T sites between them; tsplit = ext.T for a plain box); its blocks are
// [start[k], start[k + 1]) of the grid, nq[k] chunks an x-plane (the brick
// order of rt_horder over the box's thread slots).  A row of ext.T <= 32
// sites takes lanes[k] slots (ext.T rounded up to a power of two), so that
// no warp holds parts of two rows a lane run apart (the rest of its slots
// idle); a row longer than RT_HROW_LANES_MAX is cut linearly (lanes 0).
//
// A box with a tile (tx[k] > 0: its sub-plan's (tx, ty, tz), each dividing
// the box's x, y, z extent; T whole) runs its rows in that tile's walk
// (wilson_normal.cuh::rt_walk_site over the box's x, y, z): its thread
// slots, lanes[k] (or ext.T) a row, are cut linearly into blocks, and slot
// row j is the j-th (x, y, z) of the walk.  Rows keep their T sites
// together, so the lanes and the T-slab pairing are the untiled box's.
struct rt_htab {
  int n;
  rt_lattice org[RT_HTAB_MAX], ext[RT_HTAB_MAX];
  int tsplit[RT_HTAB_MAX], tgap[RT_HTAB_MAX], nq[RT_HTAB_MAX], lanes[RT_HTAB_MAX];
  int tx[RT_HTAB_MAX], ty[RT_HTAB_MAX], tz[RT_HTAB_MAX];
  int start[RT_HTAB_MAX + 1];
};

// The slots a row of T sites takes (see rt_htab): 0 for a linear cut.
static inline int rt_row_lanes(int T) {
  if (T > RT_HROW_LANES_MAX) return 0;
  int g = 1;
  while (g < T) g *= 2;
  return g;
}

// One box of a table, as a thread reads it.
struct rt_hent {
  rt_lattice org, ext;
  int tsplit, tgap, nq, lanes, start, tx, ty, tz;
};

// The box of block i of a table's grid (start[] ascending, start[0] = 0),
// selected with constant indices only: a run-time index into the
// parameter struct would have the compiler copy it to local memory.
__device__ __forceinline__ rt_hent rt_htab_entry(const rt_htab& tb, int i) {
  rt_hent h{tb.org[0], tb.ext[0], tb.tsplit[0], tb.tgap[0], tb.nq[0], tb.lanes[0], tb.start[0],
            tb.tx[0], tb.ty[0], tb.tz[0]};
#pragma unroll
  for (int j = 1; j < RT_HTAB_MAX; ++j)
    if (j < tb.n && i >= tb.start[j])
      h = rt_hent{tb.org[j], tb.ext[j], tb.tsplit[j], tb.tgap[j], tb.nq[j], tb.lanes[j],
                  tb.start[j], tb.tx[j], tb.ty[j], tb.tz[j]};
  return h;
}

// The coordinates of box site s (linear over the box).
template <typename I>
__device__ __forceinline__ rt_lattice rt_hcoord(const rt_lattice& box, I s) {
  rt_lattice c;
  c.T = (int)(s % box.T);
  I r = s / box.T;
  c.Z = (int)(r % box.Z);
  r /= box.Z;
  c.Y = (int)(r % box.Y);
  c.X = (int)(r / box.Y);
  return c;
}

// The array site of box coordinates c.
template <typename I>
__device__ __forceinline__ I rt_hidx(const rt_hbox& b, const rt_lattice& c) {
  return (((I)(c.X + b.org.X) * b.arr.Y + (c.Y + b.org.Y)) * b.arr.Z + (c.Z + b.org.Z)) *
             b.arr.T + (c.T + b.org.T);
}

// The array site of box site s.
template <typename I>
__device__ __forceinline__ I rt_hsite(const rt_hbox& b, I s) {
  return rt_hidx<I>(b, rt_hcoord<I>(b.box, s));
}

template <typename I>
__device__ __forceinline__ I rt_hvol(const rt_lattice& L) {
  return (I)L.X * L.Y * L.Z * L.T;
}

// This thread's site of a table launch: its coordinates c in the array the
// boxes are given in (the box's origin added, the gap applied), false
// where it has none.
template <typename I>
__device__ __forceinline__ bool rt_htab_site(const rt_htab& tb, rt_lattice& c) {
  const rt_hent h = rt_htab_entry(tb, (int)blockIdx.x);
  const rt_lattice e = h.ext;
  const int g = h.lanes;
  if (h.tx) {   // the box's tile walk: slots cut linearly, rows in walk order
    const int w = g ? g : e.T;   // slots a row
    const I q = (I)((int)blockIdx.x - h.start) * blockDim.x + threadIdx.x;
    const I row = q / w;
    const int lane = (int)(q - row * w);
    if (row >= (I)e.X * e.Y * e.Z || lane >= e.T) return false;
    const rt_walk wk{h.tx, h.ty, h.tz, e.Y, e.Z, 1, e.Y / h.ty, e.Z / h.tz, h.tx * h.ty * h.tz};
    const I xyz = rt_walk_site<I>(wk, row);   // ((x Y + y) Z + z) over the box
    c = rt_lattice{(int)(xyz / ((I)e.Y * e.Z)), (int)((xyz / e.Z) % e.Y), (int)(xyz % e.Z), lane};
  } else {
    const long long P = (long long)e.Y * e.Z * (g ? g : e.T);   // slots an x-plane
    const rt_horder o{h.nq, e.X, P};
    I s;
    if (!rt_horder_site<I>(o, (int)blockIdx.x - h.start, s)) return false;
    if (g) {   // slot -> site: row s / g, lane s % g (g a power of two)
      const int lane = (int)(s & (I)(g - 1));
      if (lane >= e.T) return false;
      s = (s >> (__ffs(g) - 1)) * e.T + lane;
    }
    c = rt_hcoord<I>(e, s);
  }
  if (c.T >= h.tsplit) c.T += h.tgap;
  c = rt_lattice{c.X + h.org.X, c.Y + h.org.Y, c.Z + h.org.Z, c.T + h.org.T};
  return true;
}

// The stride of axis MU in an array of extents e.
template <int MU, typename I>
__device__ __forceinline__ I rt_hstride(const rt_lattice& e) {
  return MU == 0 ? (I)e.Y * e.Z * e.T : (MU == 1 ? (I)e.Z * e.T : (MU == 2 ? (I)e.T : (I)1));
}

// acc += direction MU's hop at psi's array site sp and u's array site su
// (psi and u SoA over their own arrays, of extents ep and eu).
template <int MU, typename I>
__device__ __forceinline__ void rt_halo_dir(const float* __restrict__ psi, const rt_lattice& ep,
                                            I sp, const float* __restrict__ u,
                                            const rt_lattice& eu, I su,
                                            rt_cplx (&acc)[4][3]) {
  const rt_layout soa = rt_soa();
  const I Vp = rt_hvol<I>(ep), Vu = rt_hvol<I>(eu);
  const I dp = rt_hstride<MU, I>(ep), du = rt_hstride<MU, I>(eu);
  rt_cplx mf[3][3], mb[3][3];
  const rt_wf<float> uw{u, soa};
  rt_load_link<MU, RT_K_SOA, false>(uw, Vu, su, mf);
  rt_load_link<MU, RT_K_SOA, false>(uw, Vu, su - du, mb);
  const I fwd = sp + dp, bwd = sp - dp;
  rt_hop_mu<MU>(
      mf, mb,
      [&](int comp) { return rt_load_c<RT_K_SOA, false, float, I>(psi, soa, 24, comp, Vp, fwd); },
      [&](int comp) { return rt_load_c<RT_K_SOA, false, float, I>(psi, soa, 24, comp, Vp, bwd); },
      acc);
}

// D psi at psi's array site sp, u's su, into d (component order of the
// spinor field): rt_wilson_hop's directions and adds.
template <typename I>
__device__ __forceinline__ void rt_halo_hop(const float* __restrict__ psi, const rt_lattice& ep,
                                            I sp, const float* __restrict__ u,
                                            const rt_lattice& eu, I su, float (&d)[24]) {
  rt_cplx acc[4][3];
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int c = 0; c < 3; ++c) acc[s][c] = {0.0f, 0.0f};
  rt_halo_dir<0>(psi, ep, sp, u, eu, su, acc);
  rt_halo_dir<1>(psi, ep, sp, u, eu, su, acc);
  rt_halo_dir<2>(psi, ep, sp, u, eu, su, acc);
  rt_halo_dir<3>(psi, ep, sp, u, eu, su, acc);
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      d[(s * 3 + c) * 2] = acc[s][c].re;
      d[(s * 3 + c) * 2 + 1] = acc[s][c].im;
    }
}

// K4H: out (SoA over the interior box b.box) = D psi, psi and u SoA over
// b.arr.
template <typename I>
__global__ void dslash_halo_kernel(const float* __restrict__ psi, const float* __restrict__ u,
                                   float* __restrict__ out, rt_hbox b, rt_horder o) {
  I s;
  if (!rt_horder_site<I>(o, (int)blockIdx.x, s)) return;
  const I a = rt_hsite<I>(b, s);
  float d[24];
  rt_halo_hop<I>(psi, b.arr, a, u, b.arr, a, d);
  const I V = rt_hvol<I>(b.box);
#pragma unroll
  for (int c = 0; c < 24; ++c) out[(I)c * V + s] = d[c];
}

// K5TH's walk over the ring-1 array of the interior `in` (extents et = in +
// 2), by its (x, y, z) rows, each whole along T (et.T sites, T the fastest
// axis): first the interior's rows in K5T's tile walk (w: rt_walk_site over
// the interior's x, y, z, T 1), each placed 1 in, then the other rows (the
// ring of the x, y, z box grown by 1, common.cuh::rt_shell3_site).  A warp
// takes consecutive T sites of one row or two, so every load coalesces as
// in K5H.  The site (linear over the ring-1 array) of this thread's
// position, false past the array.
template <typename I>
__device__ __forceinline__ bool rt_ring1_walk_site(const rt_walk& w, const rt_lattice& in,
                                                   const rt_lattice& et, I& s) {
  const I g = (I)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= rt_hvol<I>(et)) return false;
  const I row = g / et.T;
  const int lane = (int)(g - row * et.T);
  const I nin = (I)in.X * in.Y * in.Z;
  int3 r;
  if (row < nin) {
    const I xyz = rt_walk_site<I>(w, row);   // ((x Y + y) Z + z) over the interior
    r = make_int3((int)(xyz / ((I)in.Y * in.Z)) + 1, (int)((xyz / in.Z) % in.Y) + 1,
                  (int)(xyz % in.Z) + 1);
  } else {
    r = rt_shell3_site<I>(in.X, in.Y, in.Z, row - nin);
  }
  s = (((I)r.x * et.Y + r.y) * et.Z + r.z) * et.T + lane;
  return true;
}

// K5H's t kernel: t on the whole ring-1 array (extents bt.box, SoA) =
// g5(p - kappa D p), p and u SoA over bt.arr (ring 2; bt.org 1).  W: K5TH,
// the sites in rt_ring1_walk_site's order (w over the interior), else in
// the brick order o.
template <typename I, bool W>
__global__ void wilson_normal_pre_t_kernel(const float* __restrict__ p,
                                           const float* __restrict__ u, float* __restrict__ t,
                                           float kappa, rt_hbox bt, rt_horder o, rt_walk w) {
  I s;
  if (W) {
    const rt_lattice e = bt.box;
    if (!rt_ring1_walk_site<I>(w, rt_lattice{e.X - 2, e.Y - 2, e.Z - 2, e.T - 2}, e, s)) return;
  } else if (!rt_horder_site<I>(o, (int)blockIdx.x, s)) {
    return;
  }
  const I a = rt_hsite<I>(bt, s);
  float d[24];
  rt_halo_hop<I>(p, bt.arr, a, u, bt.arr, a, d);
  const I V = rt_hvol<I>(bt.box), Va = rt_hvol<I>(bt.arr);
#pragma unroll
  for (int c = 0; c < 24; ++c)
    t[(I)c * V + s] = rt_g5_sign(c) * (p[(I)c * Va + a] - kappa * d[c]);
}

// K5H's ap kernel: ap on the whole interior (bap.arr, SoA) = g5(t - kappa
// D t), t over the ring-1 array (bt: origin 1), u over b.arr (ring 2; b.org
// 2).  W: K5TH, the interior's sites in K5T's tile walk w, else in the
// brick order o.
template <typename I, bool W>
__global__ void wilson_normal_pre_ap_kernel(const float* __restrict__ t,
                                            const float* __restrict__ u, float* __restrict__ ap,
                                            float kappa, rt_hbox b, rt_hbox bt, rt_hbox bap,
                                            rt_horder o, rt_walk w) {
  I s;
  if (W) {
    const I g = (I)blockIdx.x * blockDim.x + threadIdx.x;
    if (g >= rt_hvol<I>(b.box)) return;
    s = rt_walk_site<I>(w, g);
  } else if (!rt_horder_site<I>(o, (int)blockIdx.x, s)) {
    return;
  }
  const rt_lattice c = rt_hcoord<I>(b.box, s);
  const I a = rt_hidx<I>(b, c);     // u's site
  const I at = rt_hidx<I>(bt, c);   // t's site
  const I ao = rt_hidx<I>(bap, c);  // ap's site
  float d[24];
  rt_halo_hop<I>(t, bt.arr, at, u, b.arr, a, d);
  const I V = rt_hvol<I>(bap.arr), Vt = rt_hvol<I>(bt.arr);
#pragma unroll
  for (int k = 0; k < 24; ++k)
    ap[(I)k * V + ao] = rt_g5_sign(k) * (t[(I)k * Vt + at] - kappa * d[k]);
}

// K5HO's t kernel on a table of boxes of the ring-1 array (extents et; p
// and u over ep, ring 2, where t's site c is p's c + 1): t = g5(p - kappa
// D p) on each box's sites, written into the one ring-1 t array (SoA).
template <typename I>
__global__ void wilson_normal_box_t_kernel(const float* __restrict__ p,
                                           const float* __restrict__ u, float* __restrict__ t,
                                           float kappa, rt_lattice et, rt_lattice ep,
                                           const rt_htab tb) {
  rt_lattice c;
  if (!rt_htab_site<I>(tb, c)) return;
  const I a = rt_hidx<I>(rt_hbox{ep, ep, rt_lattice{1, 1, 1, 1}}, c);
  const I st = rt_hidx<I>(rt_hbox{et, et, rt_lattice{0, 0, 0, 0}}, c);
  float d[24];
  rt_halo_hop<I>(p, ep, a, u, ep, a, d);
  const I V = rt_hvol<I>(et), Va = rt_hvol<I>(ep);
#pragma unroll
  for (int k = 0; k < 24; ++k)
    t[(I)k * V + st] = rt_g5_sign(k) * (p[(I)k * Va + a] - kappa * d[k]);
}

// K5HO's ap kernel on a table of boxes of the interior (extents in): ap =
// g5(t - kappa D t) on each box's sites, t over the ring-1 array (extents
// et, site c + 1), u over ring 2 (eu, c + 2); ap SoA over the interior.
template <typename I>
__global__ void wilson_normal_box_ap_kernel(const float* __restrict__ t,
                                            const float* __restrict__ u, float* __restrict__ ap,
                                            float kappa, rt_lattice in, rt_lattice et,
                                            rt_lattice eu, const rt_htab tb) {
  rt_lattice c;
  if (!rt_htab_site<I>(tb, c)) return;
  const I a = rt_hidx<I>(rt_hbox{eu, eu, rt_lattice{2, 2, 2, 2}}, c);   // u's site
  const I at = rt_hidx<I>(rt_hbox{et, et, rt_lattice{1, 1, 1, 1}}, c);  // t's site
  const I ao = rt_hidx<I>(rt_hbox{in, in, rt_lattice{0, 0, 0, 0}}, c);  // ap's site
  float d[24];
  rt_halo_hop<I>(t, et, at, u, eu, a, d);
  const I V = rt_hvol<I>(in), Vt = rt_hvol<I>(et);
#pragma unroll
  for (int k = 0; k < 24; ++k)
    ap[(I)k * V + ao] = rt_g5_sign(k) * (t[(I)k * Vt + at] - kappa * d[k]);
}

// -- host side ------------------------------------------------------------------------

static inline rt_lattice rt_grow(const rt_lattice& L, int w) {
  return rt_lattice{L.X + 2 * w, L.Y + 2 * w, L.Z + 2 * w, L.T + 2 * w};
}

// Whether the box (origin o, extents b) lies inside L.
static inline bool rt_box_in(const rt_lattice& L, const rt_lattice& o, const rt_lattice& b) {
  return o.X >= 0 && o.Y >= 0 && o.Z >= 0 && o.T >= 0 && b.X >= 1 && b.Y >= 1 && b.Z >= 1 &&
         b.T >= 1 && o.X + b.X <= L.X && o.Y + b.Y <= L.Y && o.Z + b.Z <= L.Z &&
         o.T + b.T <= L.T;
}

// Whether every offset of a 72-component field over L fits an int.
static inline bool rt_halo_narrow(const rt_lattice& L) {
  return 72LL * L.X * L.Y * L.Z * L.T < (1LL << 31);
}

static inline unsigned rt_horder_grid(const rt_horder& o) {
  return (unsigned)((long long)o.nq * o.X);
}

// A table from `boxes` (RT_HBOX_INTS ints a box: origin, extents, tsplit,
// tgap, the tile tx, ty, tz or 0 0 0) of boxes inside L, `block` threads a
// block; false for a table the kernels do not take (too many boxes, a box
// outside L, a gap that leaves L, a tile that does not divide its box, a
// grid past 2^31 blocks).
#define RT_HBOX_INTS 13
static bool rt_make_htab(const int* boxes, int nbox, const rt_lattice& L, int block,
                         rt_htab& tb) {
  if (nbox < 1 || nbox > RT_HTAB_MAX) return false;
  tb.n = nbox;
  long long start = 0;
  for (int k = 0; k < nbox; ++k) {
    const int* b = boxes + RT_HBOX_INTS * k;
    tb.org[k] = rt_lattice{b[0], b[1], b[2], b[3]};
    tb.ext[k] = rt_lattice{b[4], b[5], b[6], b[7]};
    tb.tsplit[k] = b[8];
    tb.tgap[k] = b[9];
    if (b[8] < 1 || b[8] > b[7] || b[9] < 0 || (b[8] == b[7] && b[9] != 0)) return false;
    // the box with its gap spans T from org.T to org.T + ext.T + tgap
    const rt_lattice span{b[4], b[5], b[6], b[7] + b[9]};
    if (!rt_box_in(L, tb.org[k], span)) return false;
    tb.start[k] = (int)start;
    tb.lanes[k] = rt_row_lanes(b[7]);
    const int g = tb.lanes[k];
    tb.tx[k] = b[10], tb.ty[k] = b[11], tb.tz[k] = b[12];
    if (b[10] || b[11] || b[12]) {
      const int tile[3] = {b[10], b[11], b[12]};
      if (!rt_normal_tile_ok(tb.ext[k], tile)) return false;
      tb.nq[k] = 0;
      start += rt_grid((long long)b[4] * b[5] * b[6] * (g ? g : b[7]), block);
    } else {
      const rt_horder o = rt_make_horder(rt_lattice{b[4], b[5], b[6], g ? g : b[7]}, block);
      tb.nq[k] = o.nq;
      start += rt_horder_grid(o);
    }
    if (start >= (1LL << 31)) return false;
  }
  tb.start[nbox] = (int)start;
  return true;
}

// K5H's walk (none: the brick order) or K5TH's under `tile` (bx > 0), with
// T sites a row: the interior's T for the ap launch, 1 for the t launch's
// row walk.
static inline rt_walk rt_pre_walk(const rt_lattice& in, const int (&tile)[3], int T) {
  const int bx = tile[0], by = tile[1], bz = tile[2];
  return bx ? rt_walk{bx, by, bz, in.Y, in.Z, T, in.Y / by, in.Z / bz, bx * by * bz * T}
            : rt_walk{};
}

// K5H's (tile[0] 0) or K5TH's t launch.
static int rt_pre_t_launch(const float* p_h, const float* u_h, float* t, float kappa,
                           const rt_lattice& in, const int (&tile)[3], int block,
                           cudaStream_t stream) {
  if (block < 1 || block > 1024) return RT_BAD_LAYOUT;
  if ((long long)in.X * in.Y * in.Z * in.T == 0) return 0;
  const rt_lattice et = rt_grow(in, 1), ep = rt_grow(in, 2);
  const rt_hbox bt{et, ep, rt_lattice{1, 1, 1, 1}};
  const rt_horder o = rt_make_horder(et, block);
  const rt_walk w = rt_pre_walk(in, tile, 1);
  const unsigned grid = w.bx ? rt_grid((long long)et.X * et.Y * et.Z * et.T, block)
                             : rt_horder_grid(o);
  const bool narrow = rt_halo_narrow(ep);
  if (w.bx && narrow)
    wilson_normal_pre_t_kernel<int, true><<<grid, block, 0, stream>>>(p_h, u_h, t, kappa, bt, o,
                                                                      w);
  else if (w.bx)
    wilson_normal_pre_t_kernel<long long, true><<<grid, block, 0, stream>>>(p_h, u_h, t, kappa,
                                                                            bt, o, w);
  else if (narrow)
    wilson_normal_pre_t_kernel<int, false><<<grid, block, 0, stream>>>(p_h, u_h, t, kappa, bt,
                                                                       o, w);
  else
    wilson_normal_pre_t_kernel<long long, false><<<grid, block, 0, stream>>>(p_h, u_h, t, kappa,
                                                                             bt, o, w);
  RT_LAUNCH_RESULT();
}

// K5H's (tile[0] 0) or K5TH's ap launch.
static int rt_pre_ap_launch(const float* t, const float* u_h, float* ap, float kappa,
                            const rt_lattice& in, const int (&tile)[3], int block,
                            cudaStream_t stream) {
  if (block < 1 || block > 1024) return RT_BAD_LAYOUT;
  if ((long long)in.X * in.Y * in.Z * in.T == 0) return 0;
  const rt_lattice et = rt_grow(in, 1), ep = rt_grow(in, 2);
  const rt_hbox b{in, ep, rt_lattice{2, 2, 2, 2}}, bt{in, et, rt_lattice{1, 1, 1, 1}},
      bap{in, in, rt_lattice{0, 0, 0, 0}};
  const rt_horder o = rt_make_horder(in, block);
  const rt_walk w = rt_pre_walk(in, tile, in.T);
  const unsigned grid = w.bx ? rt_grid((long long)in.X * in.Y * in.Z * in.T, block)
                             : rt_horder_grid(o);
  const bool narrow = rt_halo_narrow(ep);
  if (w.bx && narrow)
    wilson_normal_pre_ap_kernel<int, true><<<grid, block, 0, stream>>>(t, u_h, ap, kappa, b, bt,
                                                                       bap, o, w);
  else if (w.bx)
    wilson_normal_pre_ap_kernel<long long, true><<<grid, block, 0, stream>>>(t, u_h, ap, kappa,
                                                                             b, bt, bap, o, w);
  else if (narrow)
    wilson_normal_pre_ap_kernel<int, false><<<grid, block, 0, stream>>>(t, u_h, ap, kappa, b,
                                                                        bt, bap, o, w);
  else
    wilson_normal_pre_ap_kernel<long long, false><<<grid, block, 0, stream>>>(t, u_h, ap, kappa,
                                                                              b, bt, bap, o, w);
  RT_LAUNCH_RESULT();
}

// Whether a box of the table (RT_HBOX_INTS ints a box) carries a tile.
static bool rt_htab_tiled(const int* boxes, int nbox) {
  for (int k = 0; k < nbox; ++k) {
    const int* b = boxes + RT_HBOX_INTS * k;
    if (b[10] || b[11] || b[12]) return true;
  }
  return false;
}

// K5HO's ap launch on the interior `in` (tiled or not).
static int rt_ap_boxes_launch(const float* t, const float* u_h, float* ap, float kappa,
                              const rt_lattice& in, const int* boxes, int nbox, int block,
                              cudaStream_t stream) {
  if (block < 1 || block > 1024) return RT_BAD_LAYOUT;
  if ((long long)in.X * in.Y * in.Z * in.T == 0) return 0;
  const rt_lattice et = rt_grow(in, 1), ep = rt_grow(in, 2);
  rt_htab tb;
  if (!rt_make_htab(boxes, nbox, in, block, tb)) return RT_BAD_LAYOUT;
  const unsigned grid = (unsigned)tb.start[nbox];
  if (rt_halo_narrow(ep))
    wilson_normal_box_ap_kernel<int><<<grid, block, 0, stream>>>(t, u_h, ap, kappa, in, et, ep,
                                                                 tb);
  else
    wilson_normal_box_ap_kernel<long long><<<grid, block, 0, stream>>>(t, u_h, ap, kappa, in, et,
                                                                       ep, tb);
  RT_LAUNCH_RESULT();
}

extern "C" {

// psi_h: 24 x Vh, u_h: 72 x Vh over the interior (X, Y, Z, T) padded by
// `width` a side (Vh its sites), SoA; out: 24 x X Y Z T, SoA.
int rt_dslash_halo(const float* psi_h, const float* u_h, float* out, int X, int Y, int Z, int T,
                   int width, int block, cudaStream_t stream) {
  if (width < 1 || block < 1 || block > 1024) return RT_BAD_LAYOUT;
  if ((long long)X * Y * Z * T == 0) return 0;
  const rt_lattice box{X, Y, Z, T};
  const rt_hbox b{box, rt_grow(box, width), rt_lattice{width, width, width, width}};
  const rt_horder o = rt_make_horder(box, block);
  if (rt_halo_narrow(b.arr))
    dslash_halo_kernel<int><<<rt_horder_grid(o), block, 0, stream>>>(psi_h, u_h, out, b, o);
  else
    dslash_halo_kernel<long long><<<rt_horder_grid(o), block, 0, stream>>>(psi_h, u_h, out, b, o);
  RT_LAUNCH_RESULT();
}

// K5H's t launch: p_h: 24 x Vh, u_h: 72 x Vh over the interior (X, Y, Z, T)
// padded by 2 a side; t: 24 x (X+2)(Y+2)(Z+2)(T+2), the whole ring-1
// array; all SoA.
int rt_wilson_normal_pre_t(const float* p_h, const float* u_h, float* t, float kappa, int X,
                           int Y, int Z, int T, int block, cudaStream_t stream) {
  return rt_pre_t_launch(p_h, u_h, t, kappa, rt_lattice{X, Y, Z, T}, RT_NO_TILE, block,
                         stream);
}

// K5H's ap launch: t from rt_wilson_normal_pre_t, u_h as there; ap: 24 x X
// Y Z T, SoA.
int rt_wilson_normal_pre_ap(const float* t, const float* u_h, float* ap, float kappa, int X,
                            int Y, int Z, int T, int block, cudaStream_t stream) {
  return rt_pre_ap_launch(t, u_h, ap, kappa, rt_lattice{X, Y, Z, T}, RT_NO_TILE, block,
                          stream);
}

// K5TH's t launch: rt_wilson_normal_pre_t's arrays, the ring-1 array's
// sites walked as rt_ring1_walk_site says under the tile (bx, by, bz), each
// >= 1 and dividing its dim (T whole).
int rt_wilson_normal_pre_t_tiled(const float* p_h, const float* u_h, float* t, float kappa,
                                 int X, int Y, int Z, int T, int bx, int by, int bz, int block,
                                 cudaStream_t stream) {
  const int tile[3] = {bx, by, bz};
  if (!rt_normal_tile_ok(rt_lattice{X, Y, Z, T}, tile)) return RT_BAD_LAYOUT;
  return rt_pre_t_launch(p_h, u_h, t, kappa, rt_lattice{X, Y, Z, T}, tile, block, stream);
}

// K5TH's ap launch: rt_wilson_normal_pre_ap's arrays, the interior's sites
// in K5T's walk under the tile (bx, by, bz).
int rt_wilson_normal_pre_ap_tiled(const float* t, const float* u_h, float* ap, float kappa,
                                  int X, int Y, int Z, int T, int bx, int by, int bz, int block,
                                  cudaStream_t stream) {
  const int tile[3] = {bx, by, bz};
  if (!rt_normal_tile_ok(rt_lattice{X, Y, Z, T}, tile)) return RT_BAD_LAYOUT;
  return rt_pre_ap_launch(t, u_h, ap, kappa, rt_lattice{X, Y, Z, T}, tile, block, stream);
}

// K5HO's t launch: p_h and u_h as for rt_wilson_normal_pre_t; t: the
// ring-1 array, written on the boxes' sites; boxes: nbox boxes of the
// ring-1 array (RT_HBOX_INTS ints each).
int rt_wilson_normal_t_boxes(const float* p_h, const float* u_h, float* t, float kappa, int X,
                             int Y, int Z, int T, const int* boxes, int nbox, int block,
                             cudaStream_t stream) {
  if (block < 1 || block > 1024) return RT_BAD_LAYOUT;
  if ((long long)X * Y * Z * T == 0) return 0;
  const rt_lattice in{X, Y, Z, T}, et = rt_grow(in, 1), ep = rt_grow(in, 2);
  rt_htab tb;
  if (!rt_make_htab(boxes, nbox, et, block, tb)) return RT_BAD_LAYOUT;
  const unsigned grid = (unsigned)tb.start[nbox];
  if (rt_halo_narrow(ep))
    wilson_normal_box_t_kernel<int><<<grid, block, 0, stream>>>(p_h, u_h, t, kappa, et, ep, tb);
  else
    wilson_normal_box_t_kernel<long long><<<grid, block, 0, stream>>>(p_h, u_h, t, kappa, et, ep,
                                                                      tb);
  RT_LAUNCH_RESULT();
}

// K5HO's ap launch: t from rt_wilson_normal_t_boxes (the ring-1 array, its
// sites around the boxes computed), u_h as there; ap: 24 x X Y Z T, SoA,
// written on the boxes' sites (boxes of the interior), no box tiled.
int rt_wilson_normal_ap_boxes(const float* t, const float* u_h, float* ap, float kappa, int X,
                              int Y, int Z, int T, const int* boxes, int nbox, int block,
                              cudaStream_t stream) {
  if (rt_htab_tiled(boxes, nbox)) return RT_BAD_LAYOUT;
  return rt_ap_boxes_launch(t, u_h, ap, kappa, rt_lattice{X, Y, Z, T}, boxes, nbox, block,
                            stream);
}

// Tiled K5HO's ap launch: as rt_wilson_normal_ap_boxes, at least one box
// carrying its sub-plan's tile, whose sites it walks in that tile's order.
int rt_wilson_normal_ap_boxes_tiled(const float* t, const float* u_h, float* ap, float kappa,
                                    int X, int Y, int Z, int T, const int* boxes, int nbox,
                                    int block, cudaStream_t stream) {
  if (!rt_htab_tiled(boxes, nbox)) return RT_BAD_LAYOUT;
  return rt_ap_boxes_launch(t, u_h, ap, kappa, rt_lattice{X, Y, Z, T}, boxes, nbox, block,
                            stream);
}

}  // extern "C"

