// K1: site-local launches over fields in any layout (SoA, AoS, AoSoA).
//
// Replaces the TPU kernel core/target.py::TargetKernel._run_pallas (inner
// pallas_kernel, pallas_call at :398), which traces any Python body into a
// kernel over one layout block of vvl sites, unpacks the block to canonical
// (ncomp, vvl), runs the body and packs each output into its own layout.
// CUDA cannot trace a Python body, so each body on the solve's path has its
// own entry point here, registered against the body in
// repro_torch.core.target:
//
//   rt_site_g5    gamma5: out = x with components >= flip_from negated (cg.g5)
//   rt_site_mul   out = x * y   (the product in cg.dot; over a batch of
//                 slots, blockIdx.y, the product of cg.batched_dot, the
//                 dot_prod instance of core/fuse.py::_build_flat's
//                 fused_kernel :1411 with its batch axis, _batch_specs :2009)
//   rt_site_axpy  out = x * a + y, a a static param   (cg.axpy)
//
// Bound on the H100: bytes.  Each is a streaming pass with well under one
// flop per byte (g5 reads and writes 24 fp32 per site, 192 B; the product
// reads two and writes one, 288 B), far below the card's ~20 flop/byte
// fp32 ridge.  The design is the plain one for that: one thread per
// element of the output, consecutive threads on consecutive output
// addresses, no shared memory.  When every operand shares one layout the
// product and axpy walk the flat arrays, which is layout-free, and every
// warp's loads and stores coalesce in any layout.  Otherwise (g5 outside
// SoA, which needs each element's component, and mixed in/out layouts) a
// thread recovers its element's (component, site) from the output's
// layout (rt_coords) and reads each input at INDEX(component, site) in the
// input's own layout (rt_index, common.cuh).  The values do not depend on
// the layout: out is bitwise the SoA launch's, repacked.

#include "common.cuh"

// MIXED: the operands' layouts differ (g5: any layout but SoA).
template <bool MIXED>
__global__ void site_g5_kernel(const float* __restrict__ x, float* __restrict__ out, int ncomp,
                               long long nsites, int flip_from, rt_layout lx, rt_layout lo) {
  const long long n = (long long)ncomp * nsites;
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (!MIXED) {
    const float v = x[i];
    out[i] = i >= (long long)flip_from * nsites ? -v : v;
    return;
  }
  int c;
  long long s;
  rt_coords(lo, i, ncomp, nsites, c, s);
  const float v = x[rt_index(lx, c, s, ncomp, nsites)];
  out[i] = c >= flip_from ? -v : v;
}

// The slot is blockIdx.y (one slot for the single product); sx, sy: per-slot
// element offsets of x and y (0 for a shared one), out one field a slot.
template <bool MIXED>
__global__ void site_mul_kernel(const float* __restrict__ x, const float* __restrict__ y,
                                float* __restrict__ out, int ncomp, long long nsites,
                                rt_layout lx, rt_layout ly, rt_layout lo, long long sx,
                                long long sy) {
  const long long b = blockIdx.y;
  const long long n = (long long)ncomp * nsites;
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  x += b * sx;
  y += b * sy;
  out += b * n;
  if (!MIXED) {
    out[i] = x[i] * y[i];
    return;
  }
  int c;
  long long s;
  rt_coords(lo, i, ncomp, nsites, c, s);
  out[i] = x[rt_index(lx, c, s, ncomp, nsites)] * y[rt_index(ly, c, s, ncomp, nsites)];
}

template <bool MIXED>
__global__ void site_axpy_kernel(float a, const float* __restrict__ x,
                                 const float* __restrict__ y, float* __restrict__ out, int ncomp,
                                 long long nsites, rt_layout lx, rt_layout ly, rt_layout lo) {
  const long long n = (long long)ncomp * nsites;
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (!MIXED) {
    out[i] = x[i] * a + y[i];
    return;
  }
  int c;
  long long s;
  rt_coords(lo, i, ncomp, nsites, c, s);
  out[i] = x[rt_index(lx, c, s, ncomp, nsites)] * a + y[rt_index(ly, c, s, ncomp, nsites)];
}

extern "C" {

// x, out: ncomp x nsites fields in layouts lx, lo (descriptors); components
// [flip_from, ncomp) change sign.
int rt_site_g5(const float* x, float* out, int ncomp, long long nsites, int flip_from, int lx,
               int lo, int block, cudaStream_t stream) {
  const long long n = (long long)ncomp * nsites;
  const rt_layout L[2] = {rt_make_layout(lx), rt_make_layout(lo)};
  const int k = rt_launch_class(L, 2);
  if (k < 0) return RT_BAD_LAYOUT;
  if (n == 0) return 0;
  if (k != RT_K_SOA)
    site_g5_kernel<true><<<rt_grid(n, block), block, 0, stream>>>(x, out, ncomp, nsites,
                                                                   flip_from, L[0], L[1]);
  else
    site_g5_kernel<false><<<rt_grid(n, block), block, 0, stream>>>(x, out, ncomp, nsites,
                                                                    flip_from, L[0], L[1]);
  RT_LAUNCH_RESULT();
}

// x, y: batch fields one after another in layouts lx, ly (or one shared
// field where its stride sx, sy is 0); out: batch fields in lo.  The single
// product is batch 1 with both strides 0.
int rt_site_mul(const float* x, const float* y, float* out, int ncomp, long long nsites,
                int batch, long long sx, long long sy, int lx, int ly, int lo, int block,
                cudaStream_t stream) {
  const long long n = (long long)ncomp * nsites;
  const rt_layout L[3] = {rt_make_layout(lx), rt_make_layout(ly), rt_make_layout(lo)};
  if (rt_launch_class(L, 3) < 0) return RT_BAD_LAYOUT;
  if (n == 0 || batch == 0) return 0;
  const dim3 grid(rt_grid(n, block), batch);
  if (rt_same_layout(L[0], L[2]) && rt_same_layout(L[1], L[2]))
    site_mul_kernel<false><<<grid, block, 0, stream>>>(x, y, out, ncomp, nsites, L[0], L[1],
                                                       L[2], sx, sy);
  else
    site_mul_kernel<true><<<grid, block, 0, stream>>>(x, y, out, ncomp, nsites, L[0], L[1],
                                                      L[2], sx, sy);
  RT_LAUNCH_RESULT();
}

int rt_site_axpy(float a, const float* x, const float* y, float* out, int ncomp,
                 long long nsites, int lx, int ly, int lo, int block, cudaStream_t stream) {
  const long long n = (long long)ncomp * nsites;
  const rt_layout L[3] = {rt_make_layout(lx), rt_make_layout(ly), rt_make_layout(lo)};
  if (rt_launch_class(L, 3) < 0) return RT_BAD_LAYOUT;
  if (n == 0) return 0;
  if (rt_same_layout(L[0], L[2]) && rt_same_layout(L[1], L[2]))
    site_axpy_kernel<false><<<rt_grid(n, block), block, 0, stream>>>(a, x, y, out, ncomp,
                                                                      nsites, L[0], L[1], L[2]);
  else
    site_axpy_kernel<true><<<rt_grid(n, block), block, 0, stream>>>(a, x, y, out, ncomp,
                                                                     nsites, L[0], L[1], L[2]);
  RT_LAUNCH_RESULT();
}

const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
