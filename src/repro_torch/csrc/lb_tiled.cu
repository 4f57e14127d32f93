// K9 rt_lb_step_tiled: the D3Q19 LB step under a tiled plan.
//
// Replaces core/fuse.py::LaunchGraph._build_nd's dma_kernel (:1804,
// pallas_call :1914) for the ludwig_lb_step graph (moments, collision,
// streaming; outputs dist2 and u) and, with u null, for lb_collide_propagate.
// The TPU kernel runs one program per (bx, by, bz) tile in grid order; each
// program waits for its halo'd window of the inputs, which
// pltpu.make_async_copy brought into one of two VMEM slots while the previous
// tile computed, collides every window site and pull-streams the interior:
// a Pallas program cannot scatter, so it needs the post-collision ring.
//
// Design for Hopper:
// - Push, with no ring.  A Hopper thread can scatter, so each site is
//   collided once, in registers, and streamed by push to dist2_i(s + c_i)
//   with the periodic wrap on the destination, as K5L (lb.cu) does: the
//   compulsory 176 B a site (88 read, 88 written) and no window.  u, for
//   lb_step, is written from the pre-collision values (_moments_body's
//   mom/rho + 0.5 force/rho, as K5L).  rt_k9_site is K5L's arithmetic
//   (rt_density, rt_momentum, rt_collide_site), so dist2 and u equal K5L's
//   bitwise (tests/test_torch_cuda.py): streaming only moves the values.
// - Every layout.  Each value is addressed through INDEX (rt_at,
//   common.cuh) in the launch's layout class, as K5L's site-by-site path
//   does: dist, force, dist2 and u each come with a layout descriptor, and
//   a launch of one layout is instantiated for its class (RT_K_SOA is the
//   SoA address alone).  The walk and the arithmetic do not depend on the
//   layout, so every output is bitwise the SoA launch's, repacked, and
//   K5L's launch in that layout.  In AoS a warp's load of one velocity
//   spans 32 records (76 B apart) and its push stores land on 32 records:
//   K5L's site-by-site cost in AoS (PERF.md §6).  A tiled plan under
//   view="block" runs this same kernel: it reads AoSoA in place.
// - The policy instance (rt_lb_step_tiled_bf16; BF): dist and force
//   rounded to bf16 as they are loaded (bf16.cuh), the arithmetic in fp32,
//   dist2 and u written in bf16, as K5L's rt_lb_step_bf16: the reference
//   rounds the inputs before its pallas_call and writes its outputs in the
//   storage dtype.  dist2 and u equal K5L's policy instance bitwise.
// - The tile order.  Sites are walked in the reference's grid order: tile
//   t = (i * nty + j) * ntz + k (x-slab outermost, z-tile fastest), and in
//   a tile x, y, then z fastest.  Position g of that walk is site
//   rt_tile_site(g).  A block's unit of work is `block` consecutive
//   positions, one a thread: one tile at the 227 KiB budget's (1, 4, 64)
//   with 256 threads, a run of consecutive tiles when a tile has fewer
//   sites (T3's (1, 1, 2)), part of a tile when it has more.
//   kernels/lb_propagation/kernel.py::tiled_walk mirrors the walk
//   (tests/test_torch_tile.py shows every output written once).
// - Direct loads.  Each thread loads its site's 22 values (19
//   distributions, 3 force) from device memory into registers, as K5L
//   does site by site; in SoA a warp reads 32 consecutive z of one tile
//   row (bz >= 32) a component, so every load coalesces.  No shared memory, so the budget
//   that picks the tile does not limit K9's blocks an SM.  A design that
//   staged each unit through shared memory with 16-byte cp.async, two units
//   in flight a block, computed the same bits and took 1.39 against 1.16 ms
//   at (256, 256, 256) (chip_smoke.py T1, H100 80GB HBM3 at 700 W; PERF.md
//   §6): staging only adds a round trip to a kernel that reads each value
//   once.
// - Bound.  176 B a site: 0.881 ms at (256, 256, 256) on 3.35 TB/s (the
//   policy instance reads 88 B and writes 44: 132 B, 0.661 ms).
// Offsets are 64-bit; a walk position fits an int (V < 2^31).

#include "bf16.cuh"
#include "d3q19.cuh"

#define RT_K9_MAX_THREADS 1024

__device__ __forceinline__ long long rt_site_index(const rt_tiling& T, int3 c) {
  return ((long long)c.x * T.Y + c.y) * T.Z + c.z;
}

// K5L's arithmetic at site c (index s) from its pre-collision values: u
// (unless null), then the collision, pushed to the neighbours, each output
// at INDEX of its layout in the storage type TS.
template <int K, typename TS>
__device__ __forceinline__ void rt_k9_site(const float (&fl)[RT_NVEL], const float (&fr)[3],
                                           int3 c, long long s, const rt_tiling& T,
                                           const rt_lb_params& p, const rt_k9_layouts& ll,
                                           TS* __restrict__ dist2, TS* __restrict__ u) {
  const long long V = T.V;
  if (u != nullptr) {
    const float rho = rt_density(fl);
    float mom[3];
    rt_momentum(fl, mom);
#pragma unroll
    for (int a = 0; a < 3; ++a)
      rt_st(u, rt_at<K>(ll.u, a, s, 3, V), mom[a] / rho + 0.5f * fr[a] / rho);
  }
  float out[RT_NVEL];
  rt_collide_site(fl, fr, p, out);
#pragma unroll
  for (int i = 0; i < RT_NVEL; ++i) {
    const long long dst = ((long long)rt_wrap(c.x + rt_cv(i, 0), T.X) * T.Y +
                           rt_wrap(c.y + rt_cv(i, 1), T.Y)) * T.Z +
                          rt_wrap(c.z + rt_cv(i, 2), T.Z);
    rt_st(dist2, rt_at<K>(ll.out, i, dst, RT_NVEL, V), out[i]);
  }
}

// K9 in layout class K; BF: the policy instance (bf16 stage-in, bf16
// outputs).
template <int K, bool BF>
__global__ void __launch_bounds__(RT_K9_MAX_THREADS)
    lb_tiled_kernel(const float* __restrict__ f, const float* __restrict__ force,
                    typename rt_storage<BF>::type* __restrict__ dist2,
                    typename rt_storage<BF>::type* __restrict__ u, rt_tiling T, rt_lb_params p,
                    rt_k9_layouts ll) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= T.V) return;
  const int3 c = rt_tile_site(T, (int)g);
  const long long s = rt_site_index(T, c);
  const long long V = T.V;
  float fl[RT_NVEL], fr[3];
#pragma unroll
  for (int i = 0; i < RT_NVEL; ++i) fl[i] = rt_bf16_if<BF>(f[rt_at<K>(ll.f, i, s, RT_NVEL, V)]);
#pragma unroll
  for (int a = 0; a < 3; ++a) fr[a] = rt_bf16_if<BF>(force[rt_at<K>(ll.force, a, s, 3, V)]);
  rt_k9_site<K>(fl, fr, c, s, T, p, ll, dist2, u);
}

// K9's launch (BF: the policy instance), checked as the entry points
// document.
template <bool BF>
static int rt_lb_step_tiled_launch(const float* f, const float* force,
                                   typename rt_storage<BF>::type* dist2,
                                   typename rt_storage<BF>::type* u, int X, int Y, int Z, int bx,
                                   int by, int bz, float omega, float pw0, float pw1, float pw2,
                                   const int (&desc)[4], int block, cudaStream_t stream) {
  if (!rt_tiling_ok(X, Y, Z, bx, by, bz) || block < 32 || block % 32 ||
      block > RT_K9_MAX_THREADS)
    return static_cast<int>(cudaErrorInvalidValue);
  const rt_layout L[4] = {rt_make_layout(desc[0]), rt_make_layout(desc[1]),
                          rt_make_layout(desc[2]), rt_make_layout(desc[3])};
  const int k = rt_launch_class(L, u != nullptr ? 4 : 3);
  if (k < 0) return RT_BAD_LAYOUT;
  const rt_k9_layouts ll{L[0], L[1], L[2], L[3]};
  const rt_tiling T = rt_make_tiling(X, Y, Z, bx, by, bz);
  const rt_lb_params p = rt_make_lb_params(omega, pw0, pw1, pw2);
  const int nunits = (T.V + block - 1) / block;
  RT_WITH_CLASS(k, lb_tiled_kernel<RT_K, BF><<<nunits, block, 0, stream>>>(f, force, dist2, u,
                                                                          T, p, ll));
  RT_LAUNCH_RESULT();
}

extern "C" {

// f, dist2: 19 x (X*Y*Z); force: 3 x (X*Y*Z); u: 3 x (X*Y*Z) or null (then
// not written); in the layouts of descriptors lf, lfr, ld2, lu (lu unread
// when u is null).  (bx, by, bz): the tile, each >= 1 and dividing its dim.
// dist2 must not alias f.  block: threads a block, a multiple of 32 and at
// most RT_K9_MAX_THREADS.  Returns cudaErrorInvalidValue for a tile that
// does not divide the lattice, a lattice of 2^31 sites or more, a block out
// of range or a descriptor that names no layout, and the launch's error
// otherwise.
int rt_lb_step_tiled(const float* f, const float* force, float* dist2, float* u, int X, int Y,
                     int Z, int bx, int by, int bz, float omega, float pw0, float pw1, float pw2,
                     int lf, int lfr, int ld2, int lu, int block, cudaStream_t stream) {
  const int desc[4] = {lf, lfr, ld2, lu};
  return rt_lb_step_tiled_launch<false>(f, force, dist2, u, X, Y, Z, bx, by, bz, omega, pw0, pw1,
                                        pw2, desc, block, stream);
}

// The policy instance: as rt_lb_step_tiled, with dist2 and u (or null) bf16.
int rt_lb_step_tiled_bf16(const float* f, const float* force, void* dist2, void* u, int X, int Y,
                          int Z, int bx, int by, int bz, float omega, float pw0, float pw1,
                          float pw2, int lf, int lfr, int ld2, int lu, int block,
                          cudaStream_t stream) {
  const int desc[4] = {lf, lfr, ld2, lu};
  return rt_lb_step_tiled_launch<true>(f, force, static_cast<__nv_bfloat16*>(dist2),
                                       static_cast<__nv_bfloat16*>(u), X, Y, Z, bx, by, bz, omega,
                                       pw0, pw1, pw2, desc, block, stream);
}

// cudaDevAttrMaxSharedMemoryPerBlockOptin of device, in bytes, or minus the
// CUDA error.
int rt_smem_per_block_optin(int device) {
  int v = 0;
  const cudaError_t e = cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return e == cudaSuccess ? v : -static_cast<int>(e);
}

}  // extern "C"
