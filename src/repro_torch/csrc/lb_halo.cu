// K8H and K9H (with its instances K5LH and K5LHO): D3Q19 streaming on
// pre-exchanged halos (the sharded Ludwig step, apps/ludwig/driver.py::
// make_sharded_step).
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
// K9H rt_lb_step_halo replaces core/fuse.py::LaunchGraph._build_nd
//   (fused_kernel :1721 and the tiled plan's dma_kernel :1804, pallas_call
//   :1914) for the ludwig_lb_step graph and, with u null, for
//   lb_collide_propagate, under halo="pre" and on the halo="overlap"
//   split's boxes (core/overlap.py's sub-launches): dist2 and u on one box
//   of the interior (a per-axis origin and extents; the whole interior
//   under "pre") from dist and force over the interior padded by 1, read
//   in place from the whole halo'd arrays.  Interior site r needs the
//   post-collision value of r - c_i, which for r on the box's edge lies on
//   the box's ring, so the ring's sites collide too (each reference
//   sub-launch recomputes its own ring).  Like K5L (lb.cu) it streams by
//   push: the thread of each site s of the box grown by 1 reads f(s) and
//   force(s) once, collides in registers with d3q19.cuh::rt_collide_site
//   (the pinned roundings, so the ring's values are the bits the
//   neighbour rank's own collision gives) and writes dist2_i(s + c_i)
//   where s + c_i is in the box; a box site also writes u(s), K5L's
//   formula.  Every output site of the box is written exactly once: (X+2)
//   (Y+2)(Z+2) threads for an X Y Z box, 1.02x the interior at (256, 256,
//   256).  Each site's arithmetic is the whole launch's, so every box
//   gives the whole "pre" launch's bits on its sites, and on wrap-padded
//   inputs dist2 and u equal K5L's and K9's launches bitwise.
//   - The walk.  Untiled (the tile 0), position g is site g of the grown
//     box in linear order.  Under a tiled plan (the box's tile, each
//     extent dividing the box's) positions [0, box) walk the box's sites
//     in K9's tile order (d3q19.cuh::rt_tile_site) and the ring follows,
//     in the order of common.cuh::rt_shell3_site: the x faces (lo, then
//     hi) whole, the y faces over the box's x range, the z faces over its
//     x and y ranges.  kernels/lb_propagation/kernel.py::tiled_walk(ring=1)
//     mirrors it (tests/test_torch_sharded_plans.py shows every site
//     walked once).  As in K9 there is no shared memory and no window: the
//     tile only orders the work, so the shared-memory budget that picks it
//     does not limit K9H's blocks an SM.
//   - Every layout.  Each value is addressed through INDEX (rt_at,
//     common.cuh) in the launch's layout class, dist and force on the
//     halo'd lattice and dist2 and u on the interior, as K9 addresses the
//     periodic lattice.  So AoSoA is read and written in place, and a plan
//     under view="block" runs this same kernel.
//   K5LH rt_lb_step_pre (the whole interior) and K5LHO rt_lb_step_box (one
//   box, core/overlap.py's split) are K9H's untiled SoA instances: the same
//   template, launched with SoA descriptors and no tile.

// Bound on the H100: bytes.  K8H reads 19 values a halo'd site and writes
// 19 an interior site; K9H reads 22 a site of the grown box and writes 22 a
// site of the box.  Fields are fp32, K8H's SoA; offsets are 32-bit where 19
// of the halo'd box's sites fit.

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

// K9H's walk over a box (extents b) grown by 1: untiled (T.bx 0) the grown
// box in linear order, else the box in its tile order, then the ring.
struct rt_k9h_walk {
  rt_box3 b;
  rt_tiling T;   // over the box; T.bx 0: untiled
  int Vb;        // the box's sites
};

// The grown-box coordinates of walk position g; TILED false: the linear
// order (T.bx 0), compiled without the tile walk.
template <typename I, bool TILED>
__device__ __forceinline__ int3 rt_k9h_site(const rt_k9h_walk& w, I g) {
  const int GY = w.b.Y + 2, GZ = w.b.Z + 2;
  if (!TILED)
    return make_int3((int)(g / ((I)GY * GZ)), (int)((g / GZ) % GY), (int)(g % GZ));
  if (g < (I)w.Vb) {
    const int3 c = rt_tile_site(w.T, (int)g);
    return make_int3(c.x + 1, c.y + 1, c.z + 1);
  }
  return rt_shell3_site<I>(w.b.X, w.b.Y, w.b.Z, g - (I)w.Vb);
}

// K9H in layout class K: one thread a site of the box (origin org in the
// interior L) grown by 1, which starts at org in the halo'd array (ring 1),
// in the walk w (TILED: the box's tile order, then the ring).  Its untiled
// SoA instance is K5LH's and K5LHO's arithmetic and addressing alone.
template <int K, typename I, bool TILED>
__global__ void lb_step_halo_kernel(const float* __restrict__ f, const float* __restrict__ force,
                                    float* __restrict__ dist2, float* __restrict__ u, rt_box3 L,
                                    rt_box3 org, rt_k9h_walk w, rt_lb_params p,
                                    rt_k9_layouts ll) {
  const rt_box3 b = w.b;
  const I g = (I)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= (I)(b.X + 2) * (b.Y + 2) * (b.Z + 2)) return;
  // the site's place in the grown box, then in the halo'd array
  const int3 gc = rt_k9h_site<I, TILED>(w, g);
  const int gx = gc.x, gy = gc.y, gz = gc.z;
  const int x = org.X + gx, y = org.Y + gy, z = org.Z + gz;
  const int HY = L.Y + 2, HZ = L.Z + 2;
  const I Vh = (I)(L.X + 2) * HY * HZ;
  const I a = ((I)x * HY + y) * HZ + z;
  float fl[RT_NVEL], fr[3], o[RT_NVEL];
#pragma unroll
  for (int i = 0; i < RT_NVEL; ++i) fl[i] = f[rt_at<K, I>(ll.f, i, a, RT_NVEL, Vh)];
#pragma unroll
  for (int k = 0; k < 3; ++k) fr[k] = force[rt_at<K, I>(ll.force, k, a, 3, Vh)];
  const I V = (I)L.X * L.Y * L.Z;
  const bool inside = gx >= 1 && gx <= b.X && gy >= 1 && gy <= b.Y && gz >= 1 && gz <= b.Z;
  if (u != nullptr && inside) {
    const float rho = rt_density(fl);
    float mom[3];
    rt_momentum(fl, mom);
    const I r = ((I)(x - 1) * L.Y + (y - 1)) * L.Z + (z - 1);
#pragma unroll
    for (int k = 0; k < 3; ++k)
      u[rt_at<K, I>(ll.u, k, r, 3, V)] = mom[k] / rho + 0.5f * fr[k] / rho;
  }
  rt_collide_site(fl, fr, p, o);
#pragma unroll
  for (int i = 0; i < RT_NVEL; ++i) {
    // the destination's place in the grown box: inside the box, or skipped
    const int dx = gx + rt_cv(i, 0), dy = gy + rt_cv(i, 1), dz = gz + rt_cv(i, 2);
    if (dx < 1 || dx > b.X || dy < 1 || dy > b.Y || dz < 1 || dz > b.Z) continue;
    const I dst = ((I)(org.X + dx - 1) * L.Y + (org.Y + dy - 1)) * L.Z + (org.Z + dz - 1);
    dist2[rt_at<K, I>(ll.out, i, dst, RT_NVEL, V)] = o[i];
  }
}

// K9H's launch, checked as rt_lb_step_halo documents.
static int rt_lb_step_halo_launch(const float* f, const float* force, float* dist2, float* u,
                                  int X, int Y, int Z, int ox, int oy, int oz, int bx, int by,
                                  int bz, int tx, int ty, int tz, float omega, float pw0,
                                  float pw1, float pw2, const int (&desc)[4], int block,
                                  cudaStream_t stream) {
  if (block < 1 || block > 1024) return RT_BAD_LAYOUT;
  if ((long long)X * Y * Z == 0) return 0;
  if (ox < 0 || oy < 0 || oz < 0 || bx < 1 || by < 1 || bz < 1 || ox + bx > X || oy + by > Y ||
      oz + bz > Z)
    return RT_BAD_LAYOUT;
  const bool tiled = tx || ty || tz;
  if (tiled && !rt_tiling_ok(bx, by, bz, tx, ty, tz)) return RT_BAD_LAYOUT;
  const rt_layout Ls[4] = {rt_make_layout(desc[0]), rt_make_layout(desc[1]),
                           rt_make_layout(desc[2]), rt_make_layout(desc[3])};
  const int k = rt_launch_class(Ls, u != nullptr ? 4 : 3);
  if (k < 0) return RT_BAD_LAYOUT;
  const rt_k9_layouts ll{Ls[0], Ls[1], Ls[2], Ls[3]};
  rt_k9h_walk w;
  w.b = rt_box3{bx, by, bz};
  w.T = tiled ? rt_make_tiling(bx, by, bz, tx, ty, tz) : rt_tiling{};   // T.bx 0: untiled
  w.Vb = bx * by * bz;
  const rt_box3 L{X, Y, Z};
  const rt_box3 H{X + 2, Y + 2, Z + 2};
  const rt_box3 org{ox, oy, oz};
  const long long Vg = (long long)(bx + 2) * (by + 2) * (bz + 2);
  const rt_lb_params p = rt_make_lb_params(omega, pw0, pw1, pw2);
  const unsigned grid = rt_grid(Vg, block);
  if (rt_lb_halo_narrow(H) && tiled) {
    RT_WITH_CLASS(k, lb_step_halo_kernel<RT_K, int, true>
                  <<<grid, block, 0, stream>>>(f, force, dist2, u, L, org, w, p, ll));
  } else if (rt_lb_halo_narrow(H)) {
    RT_WITH_CLASS(k, lb_step_halo_kernel<RT_K, int, false>
                  <<<grid, block, 0, stream>>>(f, force, dist2, u, L, org, w, p, ll));
  } else if (tiled) {
    RT_WITH_CLASS(k, lb_step_halo_kernel<RT_K, long long, true>
                  <<<grid, block, 0, stream>>>(f, force, dist2, u, L, org, w, p, ll));
  } else {
    RT_WITH_CLASS(k, lb_step_halo_kernel<RT_K, long long, false>
                  <<<grid, block, 0, stream>>>(f, force, dist2, u, L, org, w, p, ll));
  }
  RT_LAUNCH_RESULT();
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

// K9H: f: 19 x Vh, force: 3 x Vh over the interior (X, Y, Z) padded by 1 a
// side, in the layouts of descriptors lf, lfr (over the Vh sites); the box
// at origin (ox, oy, oz) of the interior, of extents (bx, by, bz); its tile
// (tx, ty, tz), each dividing the box's extent, or (0, 0, 0) for the
// untiled walk; dist2: 19 x X Y Z and u: 3 x X Y Z or null (then not
// written), in the layouts of ld2, lu; only the box's sites of dist2 and u
// are written.  Returns cudaErrorInvalidValue for a box outside the
// interior, a tile that does not divide it, a block out of range or a
// descriptor that names no layout.
int rt_lb_step_halo(const float* f, const float* force, float* dist2, float* u, int X, int Y,
                    int Z, int ox, int oy, int oz, int bx, int by, int bz, int tx, int ty, int tz,
                    float omega, float pw0, float pw1, float pw2, int lf, int lfr, int ld2,
                    int lu, int block, cudaStream_t stream) {
  const int desc[4] = {lf, lfr, ld2, lu};
  return rt_lb_step_halo_launch(f, force, dist2, u, X, Y, Z, ox, oy, oz, bx, by, bz, tx, ty, tz,
                                omega, pw0, pw1, pw2, desc, block, stream);
}

// K5LHO, K9H's untiled SoA instance on one box: the arrays as for
// rt_lb_step_halo, all SoA.
int rt_lb_step_box(const float* f, const float* force, float* dist2, float* u, int X, int Y,
                   int Z, int ox, int oy, int oz, int bx, int by, int bz, float omega, float pw0,
                   float pw1, float pw2, int block, cudaStream_t stream) {
  const int soa[4] = {RT_SOA, RT_SOA, RT_SOA, RT_SOA};
  return rt_lb_step_halo_launch(f, force, dist2, u, X, Y, Z, ox, oy, oz, bx, by, bz, 0, 0, 0,
                                omega, pw0, pw1, pw2, soa, block, stream);
}

// K5LH: K5LHO's one-box case (the whole interior).
int rt_lb_step_pre(const float* f, const float* force, float* dist2, float* u, int X, int Y,
                   int Z, float omega, float pw0, float pw1, float pw2, int block,
                   cudaStream_t stream) {
  return rt_lb_step_box(f, force, dist2, u, X, Y, Z, 0, 0, 0, X, Y, Z, omega, pw0, pw1, pw2,
                        block, stream);
}

}  // extern "C"
