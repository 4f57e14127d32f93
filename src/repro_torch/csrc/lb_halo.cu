// K8H and K5LH: D3Q19 streaming on pre-exchanged halos (the sharded Ludwig
// step, apps/ludwig/driver.py::make_sharded_step).
//
// K8H rt_lb_propagate_halo replaces kernels/lb_propagation/kernel.py::
//   propagate_pallas (pallas_call :58) as kernels/lb_propagation/ops.py::
//   propagate_halo (:85) calls it: out_i(r) = f_i(r - c_i) for every site r
//   of the interior (X, Y, Z), from f over the interior padded by `width`
//   a side (any width >= 1; halos exchanged by the caller).  A pull, one
//   thread an interior site: its 19 values read from f's halo'd array at
//   its own strides, velocity i at a constant offset from the site's place
//   there.  A warp's loads of one velocity are 32 consecutive z-sites
//   shifted by a constant, so they coalesce; no wrap is computed (K8's
//   SoA path without the wrap).  A first design took a thread a value
//   (velocity g / V, site g % V) and measured 2.5448 ms at (256, 256, 256)
//   against its plain version's 1.5090 (PERF.md §6).  Pure data movement,
//   bitwise its plain version (core.stencil.shifted_window per velocity).
//
// K5LH rt_lb_step_pre replaces core/fuse.py::LaunchGraph._build_nd
//   (fused_kernel :1721, pallas_call :1914) for the ludwig_lb_step graph
//   under halo="pre": dist2 and u on the interior from dist and force
//   padded by 1.  Interior site r needs the post-collision value of
//   r - c_i, which for r on the interior's edge lies on the halo ring, so
//   the ring's sites collide too.  Like K5L (lb.cu) it streams by push: the
//   thread of each site s of the halo'd box (the interior and its ring)
//   reads f(s) and force(s) once, collides in registers with
//   d3q19.cuh::rt_collide_site (the pinned roundings, so the ring's values
//   are the bits the neighbour rank's own collision gives) and writes
//   dist2_i(s + c_i) where s + c_i is interior; an interior s also writes
//   u(s), K5L's formula.  Every output is written exactly once: (X+2)(Y+2)
//   (Z+2) threads, 1.02x the interior at (256, 256, 256).  On wrap-padded
//   inputs dist2 and u equal K5L's SoA launch bitwise.
//
// K5LHO rt_lb_step_box replaces the same _build_nd fused_kernel as
//   core/overlap.py's sub-launches call it under halo="overlap": K5LH on
//   one box of the interior (a per-axis origin and extents), read in place
//   from the whole halo'd dist and force.  One thread a site of the box
//   grown by 1: each collides its site (the box's own ring too, as each
//   reference sub-launch recomputes it) and pushes only into the box; the
//   box's sites write u.  dist2 and u are the whole interior's, so the
//   split's sub-launches assemble them in place.  Each site's arithmetic is
//   the whole launch's: every box gives the whole "pre" launch's bits on
//   its sites, and the whole entry point is the one-box case.
//
// Bound on the H100: bytes.  K8H reads 19 values a halo'd site and writes
// 19 an interior site; K5LH reads 22 a halo'd site and writes 22 an
// interior site.  Fields are fp32 and SoA; offsets are 32-bit where 19 of
// the halo'd box's sites fit.

#include "d3q19.cuh"

struct rt_box3 {
  int X, Y, Z;
};

static inline bool rt_lb_halo_narrow(const rt_box3& L) {
  return 19LL * L.X * L.Y * L.Z < (1LL << 31);
}

// K8H: one thread a site s of the interior L, its 19 pulls from f over
// the interior padded by w, each at a constant offset from the site's own
// place in the halo'd array (the loop unrolls, so each offset folds into
// its load).
template <typename I>
__global__ void lb_propagate_halo_kernel(const float* __restrict__ f, float* __restrict__ out,
                                         rt_box3 L, int w) {
  const I V = (I)L.X * L.Y * L.Z;
  const I s = (I)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= V) return;
  const int z = (int)(s % L.Z);
  const int y = (int)((s / L.Z) % L.Y);
  const int x = (int)(s / ((I)L.Y * L.Z));
  const I HY = L.Y + 2 * w, HZ = L.Z + 2 * w;
  const I Vh = (I)(L.X + 2 * w) * HY * HZ;
  const I a = ((I)(x + w) * HY + (y + w)) * HZ + (z + w);
#pragma unroll
  for (int i = 0; i < RT_NVEL; ++i) {
    const I src = a - ((I)rt_cv(i, 0) * HY + rt_cv(i, 1)) * HZ - rt_cv(i, 2);
    out[(I)i * V + s] = f[(I)i * Vh + src];
  }
}

// K5LH and K5LHO: one thread a site of the box (origin org, extents b, in
// the interior L) grown by 1, which starts at org in the halo'd array
// (ring 1).
template <typename I>
__global__ void lb_step_pre_kernel(const float* __restrict__ f, const float* __restrict__ force,
                                   float* __restrict__ dist2, float* __restrict__ u, rt_box3 L,
                                   rt_box3 org, rt_box3 b, rt_lb_params p) {
  const int GX = b.X + 2, GY = b.Y + 2, GZ = b.Z + 2;
  const I s = (I)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= (I)GX * GY * GZ) return;
  // the site's place in the grown box, then in the halo'd array
  const int gz = (int)(s % GZ);
  const int gy = (int)((s / GZ) % GY);
  const int gx = (int)(s / ((I)GY * GZ));
  const int x = org.X + gx, y = org.Y + gy, z = org.Z + gz;
  const int HY = L.Y + 2, HZ = L.Z + 2;
  const I Vh = (I)(L.X + 2) * HY * HZ;
  const I a = ((I)x * HY + y) * HZ + z;
  float fl[RT_NVEL], fr[3], o[RT_NVEL];
#pragma unroll
  for (int i = 0; i < RT_NVEL; ++i) fl[i] = f[(I)i * Vh + a];
#pragma unroll
  for (int k = 0; k < 3; ++k) fr[k] = force[(I)k * Vh + a];
  const I V = (I)L.X * L.Y * L.Z;
  const bool inside = gx >= 1 && gx <= b.X && gy >= 1 && gy <= b.Y && gz >= 1 && gz <= b.Z;
  if (u != nullptr && inside) {
    const float rho = rt_density(fl);
    float mom[3];
    rt_momentum(fl, mom);
    const I r = ((I)(x - 1) * L.Y + (y - 1)) * L.Z + (z - 1);
#pragma unroll
    for (int k = 0; k < 3; ++k) u[(I)k * V + r] = mom[k] / rho + 0.5f * fr[k] / rho;
  }
  rt_collide_site(fl, fr, p, o);
#pragma unroll
  for (int i = 0; i < RT_NVEL; ++i) {
    // the destination's place in the grown box: inside the box, or skipped
    const int dx = gx + rt_cv(i, 0), dy = gy + rt_cv(i, 1), dz = gz + rt_cv(i, 2);
    if (dx < 1 || dx > b.X || dy < 1 || dy > b.Y || dz < 1 || dz > b.Z) continue;
    dist2[(I)i * V + ((I)(org.X + dx - 1) * L.Y + (org.Y + dy - 1)) * L.Z + (org.Z + dz - 1)] =
        o[i];
  }
}

extern "C" {

// f: 19 x Vh over the interior (X, Y, Z) padded by `width` a side, SoA;
// out: 19 x X Y Z, SoA.
int rt_lb_propagate_halo(const float* f, float* out, int X, int Y, int Z, int width, int block,
                         cudaStream_t stream) {
  if (width < 1 || block < 1 || block > 1024) return RT_BAD_LAYOUT;
  const long long V = (long long)X * Y * Z;
  if (V == 0) return 0;
  const rt_box3 L{X, Y, Z};
  const rt_box3 H{X + 2 * width, Y + 2 * width, Z + 2 * width};
  if (rt_lb_halo_narrow(H))
    lb_propagate_halo_kernel<int><<<rt_grid(V, block), block, 0, stream>>>(f, out, L, width);
  else
    lb_propagate_halo_kernel<long long><<<rt_grid(V, block), block, 0, stream>>>(f, out, L,
                                                                                 width);
  RT_LAUNCH_RESULT();
}

// K5LHO: f: 19 x Vh, force: 3 x Vh over the interior (X, Y, Z) padded by 1
// a side; the box at origin (ox, oy, oz) of the interior, of extents (bx,
// by, bz); dist2: 19 x X Y Z; u: 3 x X Y Z or null (then not written); all
// SoA; only the box's sites of dist2 and u are written.
int rt_lb_step_box(const float* f, const float* force, float* dist2, float* u, int X, int Y,
                   int Z, int ox, int oy, int oz, int bx, int by, int bz, float omega, float pw0,
                   float pw1, float pw2, int block, cudaStream_t stream) {
  if (block < 1 || block > 1024) return RT_BAD_LAYOUT;
  if ((long long)X * Y * Z == 0) return 0;
  if (ox < 0 || oy < 0 || oz < 0 || bx < 1 || by < 1 || bz < 1 || ox + bx > X || oy + by > Y ||
      oz + bz > Z)
    return RT_BAD_LAYOUT;
  const rt_box3 L{X, Y, Z};
  const rt_box3 H{X + 2, Y + 2, Z + 2};
  const long long Vg = (long long)(bx + 2) * (by + 2) * (bz + 2);
  const rt_lb_params p = rt_make_lb_params(omega, pw0, pw1, pw2);
  if (rt_lb_halo_narrow(H))
    lb_step_pre_kernel<int><<<rt_grid(Vg, block), block, 0, stream>>>(
        f, force, dist2, u, L, rt_box3{ox, oy, oz}, rt_box3{bx, by, bz}, p);
  else
    lb_step_pre_kernel<long long><<<rt_grid(Vg, block), block, 0, stream>>>(
        f, force, dist2, u, L, rt_box3{ox, oy, oz}, rt_box3{bx, by, bz}, p);
  RT_LAUNCH_RESULT();
}

// K5LH: the one-box case of rt_lb_step_box (the whole interior).
int rt_lb_step_pre(const float* f, const float* force, float* dist2, float* u, int X, int Y,
                   int Z, float omega, float pw0, float pw1, float pw2, int block,
                   cudaStream_t stream) {
  return rt_lb_step_box(f, force, dist2, u, X, Y, Z, 0, 0, 0, X, Y, Z, omega, pw0, pw1, pw2,
                        block, stream);
}

}  // extern "C"
