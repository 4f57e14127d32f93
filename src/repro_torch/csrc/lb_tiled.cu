// K9 rt_lb_step_tiled: the D3Q19 LB step under a tiled plan.
//
// Replaces core/fuse.py::LaunchGraph._build_nd's dma_kernel (:1804,
// pallas_call :1914) for the ludwig_lb_step graph (moments, collision,
// streaming; outputs dist2 and u) and, with u null, for lb_collide_propagate.
// The TPU kernel runs one program per (bx, by, bz) tile in grid order; each
// program waits for its halo'd window of the inputs, which
// pltpu.make_async_copy brought into one of two VMEM slots while the previous
// tile computed, then runs the fused chain on it (finish_tile): collision on
// every window site, the streaming gather for the interior, the tile's
// outputs written.
//
// Design for Hopper:
// - Persistent blocks.  A block's two window slots take most of an SM's
//   shared memory (209,088 B at the tile (1, 4, 64) the 227 KiB budget
//   picks), so the grid is as many blocks as fit on the card at once (one an
//   SM there) and each block loops over the linear tiles t = blockIdx.x,
//   blockIdx.x + gridDim.x, ...  (t = (i * nty + j) * ntz + k: x-slab
//   outermost, z-tile fastest, the reference's grid order).
// - The window copy.  Before it computes tile t, a block starts the copy of
//   its next tile's window into the other slot with cp.async (4 bytes a
//   value: the window's first z is zs - 1, so rows are not 16-byte aligned)
//   and waits only for the copy of tile t.  A warp copies a window row at
//   a time.  The periodic wrap is computed on the source indices, as in K8
//   (lb.cu), so no halo'd copy of the lattice is made.  Every iteration
//   commits one copy group, empty when the block has no next tile, so "all
//   groups but the newest" is always the current tile's, and the block
//   drains its pipeline after the loop.
// - Compute.  Collision runs on every window site (ring included) in place
//   in the slot, through the same rt_collide_site as K5L and K7, so that the
//   streaming pull dist2_i(r) = f*_i(r - c_i) of the interior finds
//   post-collision neighbours in shared memory.  u, for lb_step, is written
//   for the interior from the pre-collision values (_moments_body's
//   mom/rho + 0.5 force/rho, as K5L).  Both outputs go from registers to
//   device memory: there is no output tile in shared memory.
// - Hazards.  A barrier after the copy wait (slot complete for every
//   thread), one after the collision (in-place writes visible), one after
//   streaming (the slot is refilled at the next iteration's start).
// - Bound.  The compulsory traffic is K5L's, 176 B a site (88 read, 88
//   written), 0.881 ms at (256, 256, 256) on 3.35 TB/s.  The windows read
//   (bx+2)(by+2)(bz+2) / (bx by bz) = 4.6x the interior at (1, 4, 64), most
//   of it from L2, and the collision runs on 4.6x the sites: this kernel is
//   the simple one, slower than K5L.
// dist2 and u equal K5L's bitwise (tests/test_torch_cuda.py): the same
// collision code, and streaming only moves its values.  Offsets are 64-bit.

#include "d3q19.cuh"

#define RT_LB_NIN 22           // values a window site holds: 19 distributions, 3 force
#define RT_K9_MAX_THREADS 512  // the wrapper's block size may not exceed this

__constant__ int rt_k9_cv[RT_NVEL][3] = RT_D3Q19_CV;

struct rt_tiling {
  int X, Y, Z;     // the lattice
  int bx, by, bz;  // tile extents (each divides its dim)
  int nty, ntz;    // tiles along y and along z
  int WX, WY, WZ;  // window extents: the tile and a ring of 1
  int wsites;      // WX * WY * WZ
  int ntiles;
};

__device__ __forceinline__ void rt_cp_async4(float* dst, const float* src) {
  const unsigned int d = static_cast<unsigned int>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void rt_cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until every copy group of this thread but the newest has landed.
__device__ __forceinline__ void rt_cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void rt_cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Lattice coordinates of tile t's first interior site.
__device__ __forceinline__ int3 rt_tile_origin(const rt_tiling& T, int t) {
  return make_int3((t / (T.nty * T.ntz)) * T.bx, ((t / T.ntz) % T.nty) * T.by,
                   (t % T.ntz) * T.bz);
}

// Start the copies of tile t's halo'd window of f (19) and force (3) into
// slot[c * wsites + w], window site w = (wx * WY + wy) * WZ + wz.  A warp
// copies one window row (c, wx, wy) at a time: the row's source is computed
// once, and the lanes run along z, where only the first and last values wrap.
__device__ __forceinline__ void rt_window_copy(const float* __restrict__ f,
                                               const float* __restrict__ force, long long V,
                                               const rt_tiling& T, int t, float* slot) {
  const int3 o = rt_tile_origin(T, t);
  const int plane = T.WX * T.WY;
  const int nrows = RT_LB_NIN * plane;
  const int lane = threadIdx.x & 31;
  for (int row = threadIdx.x >> 5; row < nrows; row += blockDim.x >> 5) {
    const int c = row / plane;
    const int r = row - c * plane;
    const int wx = r / T.WY;
    const int wy = r - wx * T.WY;
    const float* src =
        (c < RT_NVEL ? f + (long long)c * V : force + (long long)(c - RT_NVEL) * V) +
        ((long long)rt_wrap(o.x - 1 + wx, T.X) * T.Y + rt_wrap(o.y - 1 + wy, T.Y)) * T.Z;
    float* dst = slot + row * T.WZ;
    for (int wz = lane; wz < T.WZ; wz += 32)
      rt_cp_async4(dst + wz, src + rt_wrap(o.z - 1 + wz, T.Z));
  }
}

__global__ void __launch_bounds__(RT_K9_MAX_THREADS)
    lb_step_tiled_kernel(const float* __restrict__ f, const float* __restrict__ force,
                         float* __restrict__ dist2, float* __restrict__ u, long long V,
                         rt_tiling T, rt_lb_params p) {
  extern __shared__ float rt_k9_slots[];
  const int slot_floats = RT_LB_NIN * T.wsites;
  const int tsites = T.bx * T.by * T.bz;
  int t = blockIdx.x;
  if (t < T.ntiles) rt_window_copy(f, force, V, T, t, rt_k9_slots);
  rt_cp_async_commit();
  for (int it = 0; t < T.ntiles; t += gridDim.x, ++it) {
    float* cur = rt_k9_slots + (it & 1) * slot_floats;
    const int next = t + gridDim.x;
    if (next < T.ntiles)
      rt_window_copy(f, force, V, T, next, rt_k9_slots + ((it + 1) & 1) * slot_floats);
    rt_cp_async_commit();
    rt_cp_async_wait_prev();
    __syncthreads();
    const int3 o = rt_tile_origin(T, t);

    // collision on every window site, in place; u of the interior first
    for (int w = threadIdx.x; w < T.wsites; w += blockDim.x) {
      float fl[RT_NVEL], fr[3], out[RT_NVEL];
#pragma unroll
      for (int i = 0; i < RT_NVEL; ++i) fl[i] = cur[i * T.wsites + w];
#pragma unroll
      for (int a = 0; a < 3; ++a) fr[a] = cur[(RT_NVEL + a) * T.wsites + w];
      if (u != nullptr) {
        const int wz = w % T.WZ;
        const int r = w / T.WZ;
        const int wy = r % T.WY;
        const int wx = r / T.WY;
        if (wx >= 1 && wx <= T.bx && wy >= 1 && wy <= T.by && wz >= 1 && wz <= T.bz) {
          const long long s =
              ((long long)(o.x + wx - 1) * T.Y + (o.y + wy - 1)) * T.Z + (o.z + wz - 1);
          const float rho = rt_density(fl);
          float mom[3];
          rt_momentum(fl, mom);
#pragma unroll
          for (int a = 0; a < 3; ++a) u[(long long)a * V + s] = mom[a] / rho + 0.5f * fr[a] / rho;
        }
      }
      rt_collide_site(fl, fr, p, out);
#pragma unroll
      for (int i = 0; i < RT_NVEL; ++i) cur[i * T.wsites + w] = out[i];
    }
    __syncthreads();

    // streaming: dist2_i(r) = f*_i(r - c_i) for the interior, z fastest
    for (int idx = threadIdx.x; idx < RT_NVEL * tsites; idx += blockDim.x) {
      const int i = idx / tsites;
      const int l = idx - i * tsites;
      const int lz = l % T.bz;
      const int r = l / T.bz;
      const int ly = r % T.by;
      const int lx = r / T.by;
      const int w = ((lx + 1 - rt_k9_cv[i][0]) * T.WY + (ly + 1 - rt_k9_cv[i][1])) * T.WZ +
                    (lz + 1 - rt_k9_cv[i][2]);
      const long long s = ((long long)(o.x + lx) * T.Y + (o.y + ly)) * T.Z + (o.z + lz);
      dist2[(long long)i * V + s] = cur[i * T.wsites + w];
    }
    __syncthreads();
  }
  rt_cp_async_wait_all();
}

extern "C" {

// f, dist2: (19, X*Y*Z) SoA; force: (3, X*Y*Z); u: (3, X*Y*Z) or null (then
// not written).  (bx, by, bz): the tile, each >= 1 and dividing its dim.
// dist2 must not alias f.  block: threads a block, a multiple of 32 and at
// most RT_K9_MAX_THREADS.  Returns cudaErrorInvalidValue for a tile that does
// not divide the lattice or a block out of range, and the error of the
// shared-memory opt-in or of the launch otherwise.
int rt_lb_step_tiled(const float* f, const float* force, float* dist2, float* u, int X, int Y,
                     int Z, int bx, int by, int bz, float omega, float pw0, float pw1, float pw2,
                     int block, cudaStream_t stream) {
  if (X < 1 || Y < 1 || Z < 1 || bx < 1 || by < 1 || bz < 1 || X % bx || Y % by || Z % bz ||
      block < 32 || block % 32 || block > RT_K9_MAX_THREADS)
    return static_cast<int>(cudaErrorInvalidValue);
  rt_tiling T;
  T.X = X, T.Y = Y, T.Z = Z;
  T.bx = bx, T.by = by, T.bz = bz;
  T.nty = Y / by, T.ntz = Z / bz;
  T.WX = bx + 2, T.WY = by + 2, T.WZ = bz + 2;
  T.wsites = T.WX * T.WY * T.WZ;
  T.ntiles = (X / bx) * T.nty * T.ntz;
  const long long V = (long long)X * Y * Z;
  const int smem = 2 * RT_LB_NIN * T.wsites * (int)sizeof(float);
  // the opt-in only grows, so it is set once for the largest window seen
  // (one device a process)
  static int smem_set = 0;
  cudaError_t e;
  if (smem > smem_set) {
    e = cudaFuncSetAttribute(lb_step_tiled_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = smem;
  }
  int dev = 0, nsm = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(e);
  if ((e = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(e);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, lb_step_tiled_kernel, block, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long resident = (long long)per_sm * nsm;
  const unsigned int grid =
      static_cast<unsigned int>(T.ntiles < resident ? T.ntiles : resident);
  lb_step_tiled_kernel<<<grid, block, smem, stream>>>(f, force, dist2, u, V, T,
                                                      rt_make_lb_params(omega, pw0, pw1, pw2));
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
