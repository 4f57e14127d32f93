// The D3Q19 velocity set and the BGK collision with Guo forcing at one site,
// shared by lb.cu's K7 (collide) and K5L (the fused LB step) and by
// lb_tiled.cu's K9 (the tiled LB step).
//
// The tables are Ludwig's ordering (maths/d3q19.py): rest, 6 faces, 12
// edges.  They are compile-time constants: every loop over velocities is
// fully unrolled, so c_i and w_i fold into the instructions and a dot
// product with c_i becomes adds and subtracts, as in the reference's
// unrolled oracle (kernels/lb_collision/ref.py::collide_chunk).
//
// rt_collide_site follows collide_chunk term by term and in its order.  The
// Python-float coefficients of the reference reach it as fp32 values: the
// weights w_i are fp32(w_i) here; omega = 1/tau and pref * w_i (three
// values, one per weight class) are computed in double by the host and
// passed as fp32, which is what the reference's weak-typed Python floats
// become.
//
// Every multiply, add and divide is written as its round-to-nearest
// intrinsic (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn), which ptxas never
// contracts into a fused multiply-add.  Written as operators, ptxas fused
// the unrounded products into FMAs as the code around each call allowed, so
// the bits depended on the kernel that inlined the function (K5L's grouped
// stores moved dist2 by an ulp; PERF.md).  Pinned, every caller rounds each
// operation once, in the reference's order, as the plain version's
// single-rounded torch ops do: K7, K5L (both instances) and K9 equal their
// plain versions bitwise on the card (tests/test_torch_cuda.py).
#pragma once

#include "common.cuh"

#define RT_NVEL 19

// The velocity table c_ia, row i, as an initializer.
#define RT_D3Q19_CV                                                    \
  {                                                                    \
    {0, 0, 0},                                                         \
    {1, 0, 0},  {-1, 0, 0}, {0, 1, 0},  {0, -1, 0}, {0, 0, 1},  {0, 0, -1}, \
    {1, 1, 0},  {1, -1, 0}, {-1, 1, 0}, {-1, -1, 0},                   \
    {1, 0, 1},  {1, 0, -1}, {-1, 0, 1}, {-1, 0, -1},                   \
    {0, 1, 1},  {0, 1, -1}, {0, -1, 1}, {0, -1, -1},                   \
  }

// c_ia of velocity i on axis a (constant once the caller's loops unroll).
__host__ __device__ constexpr int rt_cv(int i, int a) {
  constexpr int t[RT_NVEL][3] = RT_D3Q19_CV;
  return t[i][a];
}

// Weight class of velocity i: 0 rest (1/3), 1 face (1/18), 2 edge (1/36).
__host__ __device__ constexpr int rt_wclass(int i) { return i == 0 ? 0 : (i < 7 ? 1 : 2); }

__device__ __forceinline__ float rt_w(int i) {
  const int k = rt_wclass(i);
  return k == 0 ? (float)(1.0 / 3.0) : (k == 1 ? (float)(1.0 / 18.0) : (float)(1.0 / 36.0));
}

// What the host computes from tau: omega = 1/tau, pw[k] = (1 - 0.5/tau) w_k.
struct rt_lb_params {
  float omega;
  float pw[3];
};

static inline rt_lb_params rt_make_lb_params(float omega, float pw0, float pw1, float pw2) {
  rt_lb_params p;
  p.omega = omega;
  p.pw[0] = pw0;
  p.pw[1] = pw1;
  p.pw[2] = pw2;
  return p;
}

// Periodic neighbour coordinate v + d for |d| <= 1 on an axis of extent n >= 1.
__device__ __forceinline__ int rt_wrap(int v, int n) {
  return v < 0 ? v + n : (v >= n ? v - n : v);
}

// c_i . v, the reference's _cdot: signed terms added in axis order; 0 for the
// rest velocity.
__device__ __forceinline__ float rt_cdot(int i, const float (&v)[3]) {
  float out = 0.0f;
  bool started = false;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const int c = rt_cv(i, a);
    if (c == 0) continue;
    const float term = c == 1 ? v[a] : -v[a];
    out = started ? __fadd_rn(out, term) : term;
    started = true;
  }
  return out;
}

// rho = sum_i f_i in velocity order.
__device__ __forceinline__ float rt_density(const float (&f)[RT_NVEL]) {
  float rho = f[0];
#pragma unroll
  for (int i = 1; i < RT_NVEL; ++i) rho = __fadd_rn(rho, f[i]);
  return rho;
}

// mom_a = sum_i c_ia f_i, unrolled in velocity order.
__device__ __forceinline__ void rt_momentum(const float (&f)[RT_NVEL], float (&mom)[3]) {
  bool started[3] = {false, false, false};
#pragma unroll
  for (int a = 0; a < 3; ++a) mom[a] = 0.0f;
#pragma unroll
  for (int i = 0; i < RT_NVEL; ++i) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const int c = rt_cv(i, a);
      if (c == 0) continue;
      const float term = c == 1 ? f[i] : -f[i];
      mom[a] = started[a] ? __fadd_rn(mom[a], term) : term;
      started[a] = true;
    }
  }
}

// Post-collision distributions of one site (collide_chunk), each operation
// rounded once in the reference's order:
//   u    = (mom + 0.5 frc) / rho
//   feq  = ((w rho) (((1 + 3 cu) + (4.5 cu) cu) - 1.5 usq))
//   fi   = pw (3 (cf - uf) + (9 cu) cf)
//   out  = (f - omega (f - feq)) + fi
__device__ __forceinline__ void rt_collide_site(const float (&f)[RT_NVEL], const float (&frc)[3],
                                                const rt_lb_params& p,
                                                float (&out)[RT_NVEL]) {
  const float rho = rt_density(f);
  float mom[3];
  rt_momentum(f, mom);
  float u[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) u[a] = __fdiv_rn(__fadd_rn(mom[a], __fmul_rn(0.5f, frc[a])), rho);
  const float usq = __fadd_rn(__fadd_rn(__fmul_rn(u[0], u[0]), __fmul_rn(u[1], u[1])),
                              __fmul_rn(u[2], u[2]));
  const float uf = __fadd_rn(__fadd_rn(__fmul_rn(u[0], frc[0]), __fmul_rn(u[1], frc[1])),
                             __fmul_rn(u[2], frc[2]));
  const float usq15 = __fmul_rn(1.5f, usq);
#pragma unroll
  for (int i = 0; i < RT_NVEL; ++i) {
    const float cu = rt_cdot(i, u);
    const float cf = rt_cdot(i, frc);
    const float poly = __fsub_rn(__fadd_rn(__fadd_rn(1.0f, __fmul_rn(3.0f, cu)),
                                           __fmul_rn(__fmul_rn(4.5f, cu), cu)),
                                 usq15);
    const float feq = __fmul_rn(__fmul_rn(rt_w(i), rho), poly);
    const float fi = __fmul_rn(p.pw[rt_wclass(i)],
                               __fadd_rn(__fmul_rn(3.0f, __fsub_rn(cf, uf)),
                                         __fmul_rn(__fmul_rn(9.0f, cu), cf)));
    out[i] = __fadd_rn(__fsub_rn(f[i], __fmul_rn(p.omega, __fsub_rn(f[i], feq))), fi);
  }
}

// -- K9's tile walk and launch layouts (lb_tiled.cu's K9, lb_halo.cu's K9H) --

// A lattice (or a box) cut into tiles walked in the reference's grid order:
// tile t = (i nty + j) ntz + k (x-slab outermost, z-tile fastest), and in a
// tile x, y, then z fastest.
struct rt_tiling {
  int X, Y, Z;     // the lattice
  int bx, by, bz;  // tile extents (each divides its dim)
  int nty, ntz;    // tiles along y and along z
  int tsites;      // bx * by * bz
  int V;           // X * Y * Z
};

static inline rt_tiling rt_make_tiling(int X, int Y, int Z, int bx, int by, int bz) {
  rt_tiling T;
  T.X = X, T.Y = Y, T.Z = Z;
  T.bx = bx, T.by = by, T.bz = bz;
  T.nty = Y / by, T.ntz = Z / bz;
  T.tsites = bx * by * bz;
  T.V = X * Y * Z;
  return T;
}

// Whether (bx, by, bz) tiles an (X, Y, Z) lattice of fewer than 2^31 sites.
static inline bool rt_tiling_ok(int X, int Y, int Z, int bx, int by, int bz) {
  return X >= 1 && Y >= 1 && Z >= 1 && bx >= 1 && by >= 1 && bz >= 1 && X % bx == 0 &&
         Y % by == 0 && Z % bz == 0 && (long long)X * Y * Z < (1LL << 31);
}

// Lattice coordinates of walk position g.
__device__ __forceinline__ int3 rt_tile_site(const rt_tiling& T, int g) {
  const int t = g / T.tsites;
  int l = g - t * T.tsites;
  const int lz = l % T.bz;
  l /= T.bz;
  const int ly = l % T.by;
  const int lx = l / T.by;
  const int tz = t % T.ntz;
  const int r = t / T.ntz;
  const int ty = r % T.nty;
  const int tx = r / T.nty;
  return make_int3(tx * T.bx + lx, ty * T.by + ly, tz * T.bz + lz);
}

// Layouts of a K9 or K9H launch's tensors: dist in, force in, dist2 out, u
// out.
struct rt_k9_layouts {
  rt_layout f, force, out, u;
};
