// K4H and K5H: the Wilson hopping term on pre-exchanged halos (the sharded
// MILC solve, apps/milc/driver.py::make_sharded_solver).
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
// K5H rt_wilson_normal_pre_t / _ap replaces core/fuse.py::LaunchGraph.
//   _build_nd (fused_kernel :1721, pallas_call :1914) for the
//   wilson_normal graph under halo="pre": ap = M^dag M p on the interior
//   from p and u padded by 2.  As K5 it is two kernels, because a site's
//   ap needs t = g5(p - kappa D p) at its 8 neighbours and a block cannot
//   see another's t:
//
//     t kernel   t = g5(p - kappa D p) on ring 1, the (X+2)(Y+2)(Z+2)(T+2)
//                sites around the interior (1.17x the interior at
//                (64, 64, 64, 32)), from p and u at ring 2; t is SoA over
//                that box, fp32
//     ap kernel  ap = g5(t - kappa D t) on the interior, from t and u
//
//   The sharded solve takes <p, Ap> from core dot on the assembled Fields
//   (as the JAX package's does), so K5H writes no partial rows.
//
// K5HO rt_wilson_normal_box_t / _ap replaces the same _build_nd
//   fused_kernel as core/overlap.py's sub-launches call it under
//   halo="overlap": K5H on one box of the interior (a per-axis origin and
//   extents), the box's window read in place from the whole ring-2 halo'd
//   p and u.  The t kernel covers the box grown by 1 into a scratch buffer
//   of the box's own (SoA over the grown box); the ap kernel writes the
//   box's sites of the whole-interior ap, so the split's sub-launches
//   assemble ap in place.  Each site's arithmetic is the whole launch's, so
//   every box gives the whole "pre" launch's bits on its sites; the whole
//   entry points are the one-box case.  A boundary slab of width 2
//   recomputes t over its grown box, 2.3x its volume at (64, 64, 64, 32).
//
// Both kernels and K4H share wilson.cuh's hop (rt_hop_mu, the direction
// order and the adds of rt_wilson_hop), fed by loaders that read a halo'd
// SoA array; on wrap-padded inputs their fields equal K4's and K5's SoA
// launches' bits where nvcc contracts the same products.
//
// Bound on the H100: bytes.  K4H moves (24 + 72) 4 bytes a halo'd site in
// and 96 an interior site out; K5H the same at ring 2 (1.35x the interior
// at (64, 64, 64, 32)), plus t's traffic, which the design floor counts
// and the bound does not.
//
// Block order: the computed box's x-planes of P sites each split into
// ceil(P / block) chunks (the last one partial: no warp multiple divides
// the halo'd planes, 66 x 66 x 34 sites at ring 1), run in K5's brick
// order (wilson_normal.cuh::rt_order_chunk: x fastest in a brick of
// RT_BRICK_X planes), so that a site is read again as an x-neighbour one
// block later.  Fields are fp32 and SoA; offsets are 32-bit where every
// one fits (72 values of the largest box).

#include "wilson_normal.cuh"

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

// This thread's site of the box (linear over the box), false where it has
// none.
template <typename I>
__device__ __forceinline__ bool rt_horder_site(const rt_horder& o, I& s) {
  const int i = blockIdx.x;
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
  if (!rt_horder_site<I>(o, s)) return;
  const I a = rt_hsite<I>(b, s);
  float d[24];
  rt_halo_hop<I>(psi, b.arr, a, u, b.arr, a, d);
  const I V = rt_hvol<I>(b.box);
#pragma unroll
  for (int c = 0; c < 24; ++c) out[(I)c * V + s] = d[c];
}

// K5H's t kernel: t (SoA over the box bt.box, the computed box grown by 1)
// = g5(p - kappa D p), p and u SoA over bt.arr (ring 2; bt.org the grown
// box's origin there).
template <typename I>
__global__ void wilson_normal_pre_t_kernel(const float* __restrict__ p,
                                           const float* __restrict__ u, float* __restrict__ t,
                                           float kappa, rt_hbox bt, rt_horder o) {
  I s;
  if (!rt_horder_site<I>(o, s)) return;
  const I a = rt_hsite<I>(bt, s);
  float d[24];
  rt_halo_hop<I>(p, bt.arr, a, u, bt.arr, a, d);
  const I V = rt_hvol<I>(bt.box), Va = rt_hvol<I>(bt.arr);
#pragma unroll
  for (int c = 0; c < 24; ++c)
    t[(I)c * V + s] = rt_g5_sign(c) * (p[(I)c * Va + a] - kappa * d[c]);
}

// K5H's ap kernel: ap (SoA over bap.arr, the interior; the box at
// bap.org) = g5(t - kappa D t) on the box, t SoA over the box grown by 1
// (bt: origin 1 in t's array), u over b.arr (ring 2; b.org the box's
// origin + 2).
template <typename I>
__global__ void wilson_normal_pre_ap_kernel(const float* __restrict__ t,
                                            const float* __restrict__ u, float* __restrict__ ap,
                                            float kappa, rt_hbox b, rt_hbox bt, rt_hbox bap,
                                            rt_horder o) {
  I s;
  if (!rt_horder_site<I>(o, s)) return;
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

// -- host side ------------------------------------------------------------------------

static inline rt_lattice rt_grow(const rt_lattice& L, int w) {
  return rt_lattice{L.X + 2 * w, L.Y + 2 * w, L.Z + 2 * w, L.T + 2 * w};
}

static inline rt_lattice rt_shift(const rt_lattice& o, int w) {
  return rt_lattice{o.X + w, o.Y + w, o.Z + w, o.T + w};
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

// K5HO's t launch: p_h: 24 x Vh, u_h: 72 x Vh over the interior (X, Y, Z,
// T) padded by 2 a side; the box at origin (ox, oy, oz, ot) of the
// interior, of extents (bx, by, bz, bt); t: 24 x (bx+2)(by+2)(bz+2)(bt+2),
// the box grown by 1; all SoA.
int rt_wilson_normal_box_t(const float* p_h, const float* u_h, float* t, float kappa, int X,
                           int Y, int Z, int T, int ox, int oy, int oz, int ot, int bx, int by,
                           int bz, int bt, int block, cudaStream_t stream) {
  if (block < 1 || block > 1024) return RT_BAD_LAYOUT;
  if ((long long)X * Y * Z * T == 0) return 0;
  const rt_lattice in{X, Y, Z, T}, org{ox, oy, oz, ot}, box{bx, by, bz, bt};
  if (!rt_box_in(in, org, box)) return RT_BAD_LAYOUT;
  // the grown box starts one site before the box, at org + 1 in p's array
  const rt_hbox b{rt_grow(box, 1), rt_grow(in, 2), rt_shift(org, 1)};
  const rt_horder o = rt_make_horder(b.box, block);
  if (rt_halo_narrow(b.arr))
    wilson_normal_pre_t_kernel<int><<<rt_horder_grid(o), block, 0, stream>>>(p_h, u_h, t, kappa,
                                                                            b, o);
  else
    wilson_normal_pre_t_kernel<long long><<<rt_horder_grid(o), block, 0, stream>>>(
        p_h, u_h, t, kappa, b, o);
  RT_LAUNCH_RESULT();
}

// K5HO's ap launch: t from rt_wilson_normal_box_t on the same box, u_h as
// there; ap: 24 x X Y Z T, SoA, written on the box's sites only.
int rt_wilson_normal_box_ap(const float* t, const float* u_h, float* ap, float kappa, int X,
                            int Y, int Z, int T, int ox, int oy, int oz, int ot, int bx, int by,
                            int bz, int bt, int block, cudaStream_t stream) {
  if (block < 1 || block > 1024) return RT_BAD_LAYOUT;
  if ((long long)X * Y * Z * T == 0) return 0;
  const rt_lattice in{X, Y, Z, T}, org{ox, oy, oz, ot}, box{bx, by, bz, bt};
  if (!rt_box_in(in, org, box)) return RT_BAD_LAYOUT;
  const rt_hbox b{box, rt_grow(in, 2), rt_shift(org, 2)};
  const rt_hbox bt_{box, rt_grow(box, 1), rt_lattice{1, 1, 1, 1}};
  const rt_hbox bap{box, in, org};
  const rt_horder o = rt_make_horder(box, block);
  if (rt_halo_narrow(b.arr))
    wilson_normal_pre_ap_kernel<int><<<rt_horder_grid(o), block, 0, stream>>>(
        t, u_h, ap, kappa, b, bt_, bap, o);
  else
    wilson_normal_pre_ap_kernel<long long><<<rt_horder_grid(o), block, 0, stream>>>(
        t, u_h, ap, kappa, b, bt_, bap, o);
  RT_LAUNCH_RESULT();
}

// K5H's t launch: the one-box case of rt_wilson_normal_box_t (the whole
// interior); t: 24 x (X+2)(Y+2)(Z+2)(T+2).
int rt_wilson_normal_pre_t(const float* p_h, const float* u_h, float* t, float kappa, int X,
                           int Y, int Z, int T, int block, cudaStream_t stream) {
  return rt_wilson_normal_box_t(p_h, u_h, t, kappa, X, Y, Z, T, 0, 0, 0, 0, X, Y, Z, T, block,
                                stream);
}

// K5H's ap launch: the one-box case of rt_wilson_normal_box_ap.
int rt_wilson_normal_pre_ap(const float* t, const float* u_h, float* ap, float kappa, int X,
                            int Y, int Z, int T, int block, cudaStream_t stream) {
  return rt_wilson_normal_box_ap(t, u_h, ap, kappa, X, Y, Z, T, 0, 0, 0, 0, X, Y, Z, T, block,
                                 stream);
}

}  // extern "C"
