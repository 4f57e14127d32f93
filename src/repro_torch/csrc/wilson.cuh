// The Wilson hopping term at one site, shared by dslash.cu (K4) and
// wilson_normal.cuh (K5, K5B).
//
//   D psi(x) = sum_mu [ (1 - gamma_mu) U_mu(x)        psi(x + mu)
//                     + (1 + gamma_mu) U_mu^dag(x-mu) psi(x - mu) ]
//
// in the DeGrand-Rossi basis, as kernels/wilson_dslash/ref.py::
// dslash_site_chunk computes it: spin-project to a half spinor, multiply by
// the SU(3) link, reconstruct.  Storage is fp32 with split re/im:
//   spinor  24 components: (spin*3 + color)*2 + reim
//   gauge   72 components: ((mu*3 + a)*3 + b)*2 + reim
// over a periodic (X, Y, Z, T) lattice, site = ((x*Y + y)*Z + z)*T + t,
// each field in its own layout: component c of site s lies at INDEX(c, s)
// (rt_at, common.cuh), in the layout class K of the field's template
// argument (KP for psi, KU for u).
//
// The neighbours are found by periodic index arithmetic, so neither the
// 192-component neighbour pack nor the backward-link copy of the TPU path
// (ops.py:53-54) is ever materialised.  rt_hop_mu, one direction of the
// hop, takes its two links loaded and reads psi through loaders (ld(comp));
// rt_wilson_hop runs it with loaders that read each thread's 8 neighbour
// spinors and 4 backward links straight from psi and u through INDEX (K5,
// K5B and K4's per-thread loads), and dslash.cu with its own (a warp's
// staged runs in shared memory): the arithmetic, and so the bits, are the
// same whatever loads the values.
//
// The RB template flags (RBP for psi, RBU for u; false unless a kernel
// asks) round every value read to bf16 and widen it back in registers:
// the stage-in of a bf16-storage DtypePolicy (wilson_normal_mixed.cu).  A
// false flag compiles to the loads alone.
#pragma once

#include "bf16.cuh"

struct rt_cplx {
  float re, im;
};

__device__ __forceinline__ rt_cplx rt_cadd(rt_cplx a, rt_cplx b) { return {a.re + b.re, a.im + b.im}; }
__device__ __forceinline__ rt_cplx rt_csub(rt_cplx a, rt_cplx b) { return {a.re - b.re, a.im - b.im}; }

// Multiply by a unit: 0 -> +1, 1 -> -1, 2 -> +i, 3 -> -i (exact in fp32).
__device__ __forceinline__ rt_cplx rt_unit(rt_cplx a, int k) {
  switch (k) {
    case 0: return a;
    case 1: return {-a.re, -a.im};
    case 2: return {-a.im, a.re};
    default: return {a.im, -a.re};
  }
}

#define RT_ONE 0
#define RT_MONE 1
#define RT_I 2
#define RT_MI 3

// The projector (1 - gamma_mu) keeps h0 = p0 + A0 p[J0], h1 = p1 + A1 p[J1];
// (1 + gamma_mu) negates A.  Reconstruction of (1 - gamma_mu) psi sets
// row 2 = B2 h[K2], row 3 = B3 h[K3]; (1 + gamma_mu) negates B.  The tables
// are su3.project_minus / reconstruct_minus of the reference, per mu.
template <int MU> struct rt_gamma;
template <> struct rt_gamma<0> {  // x
  enum { J0 = 3, A0 = RT_MI, J1 = 2, A1 = RT_MI, K2 = 1, B2 = RT_I, K3 = 0, B3 = RT_I };
};
template <> struct rt_gamma<1> {  // y
  enum { J0 = 3, A0 = RT_ONE, J1 = 2, A1 = RT_MONE, K2 = 1, B2 = RT_MONE, K3 = 0, B3 = RT_ONE };
};
template <> struct rt_gamma<2> {  // z
  enum { J0 = 2, A0 = RT_MI, J1 = 3, A1 = RT_I, K2 = 0, B2 = RT_I, K3 = 1, B3 = RT_MI };
};
template <> struct rt_gamma<3> {  // t
  enum { J0 = 2, A0 = RT_MONE, J1 = 3, A1 = RT_MONE, K2 = 0, B2 = RT_MONE, K3 = 1, B3 = RT_MONE };
};

// The negated unit: +1 <-> -1, +i <-> -i.
__device__ __forceinline__ int rt_neg_unit(int k) { return k ^ 1; }

// One value of a field through the read-only path, widened to fp32.
__device__ __forceinline__ float rt_ldg(const float* p) { return __ldg(p); }
__device__ __forceinline__ float rt_ldg(const __nv_bfloat16* p) { return __bfloat162float(__ldg(p)); }

// Complex component `comp` (real part at 2 comp, imaginary at 2 comp + 1)
// of site `site` of a field of ncomp components in layout L, stored as T
// (fp32, or bf16 widened at load); RB rounds both parts to bf16.  Sites
// and offsets are of type I: long long, or int where every offset of the
// field fits one (K5).
template <int K, bool RB, typename T, typename I>
__device__ __forceinline__ rt_cplx rt_load_c(const T* __restrict__ f, const rt_layout& L,
                                             int ncomp, int comp, I V, I site) {
  return {rt_bf16_if<RB>(rt_ldg(f + rt_at<K, I>(L, 2 * comp, site, ncomp, V))),
          rt_bf16_if<RB>(rt_ldg(f + rt_at<K, I>(L, 2 * comp + 1, site, ncomp, V)))};
}

// A field as the hopping term reads it (through __ldg, the read-only path):
// its data, stored as T, and its layout.
template <typename T>
struct rt_wf {
  const T* p;
  rt_layout L;
};

// Upper two spin rows of (1 -/+ gamma_mu) psi: h[s][color], complex
// component comp of psi read through ld(comp) (the loader: a field's
// global loads here; K4's shared-memory tile in dslash.cu).
template <int MU, bool PLUS, typename LD>
__device__ __forceinline__ void rt_project(const LD& ld, rt_cplx (&h)[2][3]) {
  typedef rt_gamma<MU> G;
  const int a0 = PLUS ? rt_neg_unit(G::A0) : G::A0;
  const int a1 = PLUS ? rt_neg_unit(G::A1) : G::A1;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    h[0][c] = rt_cadd(ld(0 * 3 + c), rt_unit(ld(G::J0 * 3 + c), a0));
    h[1][c] = rt_cadd(ld(1 * 3 + c), rt_unit(ld(G::J1 * 3 + c), a1));
  }
}

// The link of direction MU at `site` into m[a][b].
template <int MU, int K, bool RB, typename T, typename I>
__device__ __forceinline__ void rt_load_link(const rt_wf<T>& u, I V, I site,
                                             rt_cplx (&m)[3][3]) {
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b)
      m[a][b] = rt_load_c<K, RB, T, I>(u.p, u.L, 72, (MU * 3 + a) * 3 + b, V, site);
}

// out[s][a] = sum_b U[a][b] h[s][b]      (ADJ = false)
// out[s][a] = sum_b conj(U[b][a]) h[s][b] (ADJ = true)
template <bool ADJ>
__device__ __forceinline__ void rt_su3_apply(const rt_cplx (&m)[3][3], const rt_cplx (&h)[2][3],
                                             rt_cplx (&out)[2][3]) {
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      float re = 0.0f, im = 0.0f;
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        const rt_cplx w = ADJ ? m[b][a] : m[a][b];
        const rt_cplx v = h[s][b];
        if (ADJ) {  // conj(w) * v
          re += w.re * v.re + w.im * v.im;
          im += w.re * v.im - w.im * v.re;
        } else {
          re += w.re * v.re - w.im * v.im;
          im += w.re * v.im + w.im * v.re;
        }
      }
      out[s][a] = {re, im};
    }
}

// acc += the reconstruction of uh + uhb for the gamma table G.
template <typename G>
__device__ __forceinline__ void rt_hop_acc(const rt_cplx (&uh)[2][3], const rt_cplx (&uhb)[2][3],
                                           rt_cplx (&acc)[4][3]) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    acc[0][c] = rt_cadd(acc[0][c], rt_cadd(uh[0][c], uhb[0][c]));
    acc[1][c] = rt_cadd(acc[1][c], rt_cadd(uh[1][c], uhb[1][c]));
    // B*x + (-B)*y == B*(x - y) exactly: units multiply exactly
    acc[2][c] = rt_cadd(acc[2][c], rt_unit(rt_csub(uh[G::K2][c], uhb[G::K2][c]), G::B2));
    acc[3][c] = rt_cadd(acc[3][c], rt_unit(rt_csub(uh[G::K3][c], uhb[G::K3][c]), G::B3));
  }
}

// acc += (1 - gamma_mu) mf psi(fwd) + (1 + gamma_mu) mb^dag psi(bwd), the
// two links loaded, psi(fwd) and psi(bwd) read through the loaders lf, lb.
template <int MU, typename LF, typename LB>
__device__ __forceinline__ void rt_hop_mu(const rt_cplx (&mf)[3][3], const rt_cplx (&mb)[3][3],
                                          const LF& lf, const LB& lb, rt_cplx (&acc)[4][3]) {
  rt_cplx h[2][3], uh[2][3], hb[2][3], uhb[2][3];
  rt_project<MU, false>(lf, h);
  rt_su3_apply<false>(mf, h, uh);
  rt_project<MU, true>(lb, hb);
  rt_su3_apply<true>(mb, hb, uhb);
  rt_hop_acc<rt_gamma<MU>>(uh, uhb, acc);
}

// acc[b] += (1 - gamma_mu) U_mu(site) psi[b](fwd) + (1 + gamma_mu) U_mu^dag(bwd) psi[b](bwd)
// for nb <= SB spinors psi[b] of one layout (the slots of K5B; one for K4's
// general path and K5) against one u: the two links are loaded first, once
// for every slot, and each slot's adds are in the same order whatever SB is.
template <int MU, int KP, int KU, bool RBP, bool RBU, int SB, typename TP, typename TU,
          typename I>
__device__ __forceinline__ void rt_hop_dir(const TP* const (&psi)[SB], const rt_layout& lp,
                                           const rt_wf<TU>& u, int nb, I V, I site, I fwd, I bwd,
                                           rt_cplx (&acc)[SB][4][3]) {
  rt_cplx mf[3][3], mb[3][3];
  rt_load_link<MU, KU, RBU>(u, V, site, mf);
  rt_load_link<MU, KU, RBU>(u, V, bwd, mb);
#pragma unroll
  for (int b = 0; b < SB; ++b) {
    if (b >= nb) break;
    const TP* const pb = psi[b];
    rt_hop_mu<MU>(
        mf, mb, [&](int comp) { return rt_load_c<KP, RBP, TP, I>(pb, lp, 24, comp, V, fwd); },
        [&](int comp) { return rt_load_c<KP, RBP, TP, I>(pb, lp, 24, comp, V, bwd); }, acc[b]);
  }
}

struct rt_lattice {
  int X, Y, Z, T;
};

// The neighbours of `site` on the periodic lattice: fwd[mu], bwd[mu].
template <typename I>
__device__ __forceinline__ void rt_neighbours(rt_lattice L, I site, I (&fwd)[4], I (&bwd)[4]) {
  const I st = 1, sz = L.T, sy = (I)L.Z * L.T, sx = (I)L.Y * sy;
  const int t = (int)(site % L.T);
  const int z = (int)((site / sz) % L.Z);
  const int y = (int)((site / sy) % L.Y);
  const int x = (int)(site / sx);
  fwd[0] = site + (x == L.X - 1 ? -(L.X - 1) * sx : sx);
  bwd[0] = site - (x == 0 ? -(L.X - 1) * sx : sx);
  fwd[1] = site + (y == L.Y - 1 ? -(L.Y - 1) * sy : sy);
  bwd[1] = site - (y == 0 ? -(L.Y - 1) * sy : sy);
  fwd[2] = site + (z == L.Z - 1 ? -(L.Z - 1) * sz : sz);
  bwd[2] = site - (z == 0 ? -(L.Z - 1) * sz : sz);
  fwd[3] = site + (t == L.T - 1 ? -(L.T - 1) * st : st);
  bwd[3] = site - (t == 0 ? -(L.T - 1) * st : st);
}

// D psi[b] at `site` into d[b] (component order of the spinor field) for
// nb <= SB spinors psi[b] of layout lp (K4 and K5 pass one, K5B a group of
// slots), each slot's adds in one order whatever SB is; psi in layout class
// KP, u in KU, each rounded to bf16 at load where RBP, RBU; psi and u
// stored as TP, TU (fp32 or bf16); sites of type I (long long, or int where
// every offset of a field fits one).
template <int KP, int KU, bool RBP, bool RBU, int SB, typename I, typename TP, typename TU>
__device__ __forceinline__ void rt_wilson_hop(const TP* const (&psi)[SB], const rt_layout& lp,
                                              const rt_wf<TU>& u, int nb, rt_lattice L, I site,
                                              float (&d)[SB][24]) {
  const I V = (I)L.X * L.Y * L.Z * L.T;
  I fwd[4], bwd[4];
  rt_neighbours(L, site, fwd, bwd);
  rt_cplx acc[SB][4][3];
#pragma unroll
  for (int b = 0; b < SB; ++b)
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int c = 0; c < 3; ++c) acc[b][s][c] = {0.0f, 0.0f};
  rt_hop_dir<0, KP, KU, RBP, RBU, SB>(psi, lp, u, nb, V, site, fwd[0], bwd[0], acc);
  rt_hop_dir<1, KP, KU, RBP, RBU, SB>(psi, lp, u, nb, V, site, fwd[1], bwd[1], acc);
  rt_hop_dir<2, KP, KU, RBP, RBU, SB>(psi, lp, u, nb, V, site, fwd[2], bwd[2], acc);
  rt_hop_dir<3, KP, KU, RBP, RBU, SB>(psi, lp, u, nb, V, site, fwd[3], bwd[3], acc);
#pragma unroll
  for (int b = 0; b < SB; ++b)
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        d[b][(s * 3 + c) * 2] = acc[b][s][c].re;
        d[b][(s * 3 + c) * 2 + 1] = acc[b][s][c].im;
      }
}
