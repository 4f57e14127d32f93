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
//   does; a warp reads 32 consecutive z of one tile row (bz >= 32) a
//   component, so every load coalesces.  No shared memory, so the budget
//   that picks the tile does not limit K9's blocks an SM.  A design that
//   staged each unit through shared memory with 16-byte cp.async, two units
//   in flight a block, computed the same bits and took 1.39 against 1.16 ms
//   at (256, 256, 256) (chip_smoke.py T1, H100 80GB HBM3 at 700 W; PERF.md
//   §6): staging only adds a round trip to a kernel that reads each value
//   once.
// - Bound.  176 B a site: 0.881 ms at (256, 256, 256) on 3.35 TB/s.
// Offsets are 64-bit; a walk position fits an int (V < 2^31).

#include "d3q19.cuh"

#define RT_K9_MAX_THREADS 1024

struct rt_tiling {
  int X, Y, Z;     // the lattice
  int bx, by, bz;  // tile extents (each divides its dim)
  int nty, ntz;    // tiles along y and along z
  int tsites;      // bx * by * bz
  int V;           // X * Y * Z
};

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

__device__ __forceinline__ long long rt_site_index(const rt_tiling& T, int3 c) {
  return ((long long)c.x * T.Y + c.y) * T.Z + c.z;
}

// K5L's arithmetic at site c (index s) from its pre-collision values: u
// (unless null), then the collision, pushed to the neighbours.
__device__ __forceinline__ void rt_k9_site(const float (&fl)[RT_NVEL], const float (&fr)[3],
                                           int3 c, long long s, const rt_tiling& T,
                                           const rt_lb_params& p, float* __restrict__ dist2,
                                           float* __restrict__ u) {
  const long long V = T.V;
  if (u != nullptr) {
    const float rho = rt_density(fl);
    float mom[3];
    rt_momentum(fl, mom);
#pragma unroll
    for (int a = 0; a < 3; ++a) u[(long long)a * V + s] = mom[a] / rho + 0.5f * fr[a] / rho;
  }
  float out[RT_NVEL];
  rt_collide_site(fl, fr, p, out);
#pragma unroll
  for (int i = 0; i < RT_NVEL; ++i) {
    const long long dst = ((long long)rt_wrap(c.x + rt_cv(i, 0), T.X) * T.Y +
                           rt_wrap(c.y + rt_cv(i, 1), T.Y)) * T.Z +
                          rt_wrap(c.z + rt_cv(i, 2), T.Z);
    dist2[(long long)i * V + dst] = out[i];
  }
}

__global__ void __launch_bounds__(RT_K9_MAX_THREADS)
    lb_tiled_kernel(const float* __restrict__ f, const float* __restrict__ force,
                           float* __restrict__ dist2, float* __restrict__ u, rt_tiling T,
                           rt_lb_params p) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= T.V) return;
  const int3 c = rt_tile_site(T, (int)g);
  const long long s = rt_site_index(T, c);
  const long long V = T.V;
  float fl[RT_NVEL], fr[3];
#pragma unroll
  for (int i = 0; i < RT_NVEL; ++i) fl[i] = f[(long long)i * V + s];
#pragma unroll
  for (int a = 0; a < 3; ++a) fr[a] = force[(long long)a * V + s];
  rt_k9_site(fl, fr, c, s, T, p, dist2, u);
}

extern "C" {

// f, dist2: (19, X*Y*Z) SoA; force: (3, X*Y*Z); u: (3, X*Y*Z) or null (then
// not written).  (bx, by, bz): the tile, each >= 1 and dividing its dim.
// dist2 must not alias f.  block: threads a block, a multiple of 32 and at
// most RT_K9_MAX_THREADS.  Returns cudaErrorInvalidValue for a tile that
// does not divide the lattice, a lattice of 2^31 sites or more or a block
// out of range, and the launch's error otherwise.
int rt_lb_step_tiled(const float* f, const float* force, float* dist2, float* u, int X, int Y,
                     int Z, int bx, int by, int bz, float omega, float pw0, float pw1, float pw2,
                     int block, cudaStream_t stream) {
  if (X < 1 || Y < 1 || Z < 1 || bx < 1 || by < 1 || bz < 1 || X % bx || Y % by || Z % bz ||
      (long long)X * Y * Z >= (1LL << 31) || block < 32 || block % 32 ||
      block > RT_K9_MAX_THREADS)
    return static_cast<int>(cudaErrorInvalidValue);
  rt_tiling T;
  T.X = X, T.Y = Y, T.Z = Z;
  T.bx = bx, T.by = by, T.bz = bz;
  T.nty = Y / by, T.ntz = Z / bz;
  T.tsites = bx * by * bz;
  T.V = X * Y * Z;
  const rt_lb_params p = rt_make_lb_params(omega, pw0, pw1, pw2);
  const int nunits = (T.V + block - 1) / block;
  lb_tiled_kernel<<<nunits, block, 0, stream>>>(f, force, dist2, u, T, p);
  RT_LAUNCH_RESULT();
}

// cudaDevAttrMaxSharedMemoryPerBlockOptin of device, in bytes, or minus the
// CUDA error.
int rt_smem_per_block_optin(int device) {
  int v = 0;
  const cudaError_t e = cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return e == cudaSuccess ? v : -static_cast<int>(e);
}

}  // extern "C"
