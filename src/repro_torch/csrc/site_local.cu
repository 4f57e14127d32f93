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
// fp32 ridge, so the design is about bytes in flight.
//
// Same layout (every operand in one layout: every launch of the solve):
// the op is elementwise on the flat arrays, whatever the layout.  A block
// of RT_SITE_THREADS threads takes RT_SITE_VECS float4s a thread (8 KB of
// each operand a block, every load issued before the first store;
// consecutive threads on consecutive 16-byte words), with 32-bit indices
// where a field has fewer than 2^31 elements; the last partial vector of a
// field whose size is not a multiple of 4 is done element by element.  g5
// negates an element by its component: in SoA the elements from
// flip_from * nsites on, element by element within a vector, so a vector
// that straddles that boundary is split exactly; in AoS and AoSoA the
// component of each element from its flat index.  A field whose pointer (or
// a slot's offset) is not 16-byte aligned takes the general path below.
//
// Mixed layouts (and the misaligned case): one thread per element of the
// output, which recovers its element's (component, site) from the output's
// layout (rt_coords) and reads each input at INDEX(component, site) in the
// input's own layout (rt_index, common.cuh).
//
// The arithmetic of an element does not depend on the path (axpy is x * a
// + y, one FMA, in both), so out is bitwise the same on every path and in
// every layout: the SoA launch's, repacked.

#include "common.cuh"

#define RT_SITE_THREADS 256
#define RT_SITE_VECS 2   // float4s a thread takes: a block covers 2048 elements

#define RT_SITE_MUL 0
#define RT_SITE_AXPY 1

__device__ __forceinline__ float rt_site_op(int op, float a, float x, float y) {
  return op == RT_SITE_AXPY ? x * a + y : x * y;
}

// g5's sign of flat element e (the same layout in and out): -1 where its
// component is >= flip_from.
template <int K, typename I>
__device__ __forceinline__ bool rt_g5_flips(I e, int ncomp, I nsites, int flip_from,
                                            const rt_layout& L) {
  if (K == RT_K_SOA) return e >= (I)flip_from * nsites;
  if (K == RT_K_AOS) return (int)(e % ncomp) >= flip_from;
  if (K == RT_K_AOSOA) return (int)((e >> L.shift) % ncomp) >= flip_from;
  int c;
  long long s;
  rt_coords(L, e, ncomp, nsites, c, s);
  return c >= flip_from;
}

// -- same layout, aligned: RT_SITE_VECS float4s a thread ------------------------------

template <int K, typename I>
__global__ void __launch_bounds__(RT_SITE_THREADS)
    site_g5_kernel(const float* __restrict__ x, float* __restrict__ out, int ncomp, I nsites,
                   int flip_from, rt_layout L) {
  const I n = (I)ncomp * nsites;
  const I nv = n >> 2;
  const I v0 = (I)blockIdx.x * (RT_SITE_THREADS * RT_SITE_VECS) + threadIdx.x;
  float4 r[RT_SITE_VECS];
#pragma unroll
  for (int u = 0; u < RT_SITE_VECS; ++u) {
    const I v = v0 + u * RT_SITE_THREADS;
    if (v < nv) r[u] = __ldg(reinterpret_cast<const float4*>(x) + v);
  }
#pragma unroll
  for (int u = 0; u < RT_SITE_VECS; ++u) {
    const I v = v0 + u * RT_SITE_THREADS;
    if (v >= nv) continue;
    float4 o = r[u];
    if (rt_g5_flips<K>(4 * v, ncomp, nsites, flip_from, L)) o.x = -o.x;
    if (rt_g5_flips<K>(4 * v + 1, ncomp, nsites, flip_from, L)) o.y = -o.y;
    if (rt_g5_flips<K>(4 * v + 2, ncomp, nsites, flip_from, L)) o.z = -o.z;
    if (rt_g5_flips<K>(4 * v + 3, ncomp, nsites, flip_from, L)) o.w = -o.w;
    reinterpret_cast<float4*>(out)[v] = o;
  }
  if (blockIdx.x == gridDim.x - 1) {   // the elements after the last whole vector
    const I e = 4 * nv + threadIdx.x;
    if (e < n) out[e] = rt_g5_flips<K>(e, ncomp, nsites, flip_from, L) ? -x[e] : x[e];
  }
}

// The product (OP = RT_SITE_MUL) and axpy (RT_SITE_AXPY); the slot is blockIdx.y (one slot
// for the single launch), sx, sy: per-slot element offsets of x and y (0
// for a shared one), out one field a slot.
template <int OP, typename I>
__global__ void __launch_bounds__(RT_SITE_THREADS)
    site_binary_kernel(float a, const float* __restrict__ x, const float* __restrict__ y,
                       float* __restrict__ out, I n, long long sx, long long sy) {
  const long long b = blockIdx.y;
  x += b * sx;
  y += b * sy;
  out += b * (long long)n;
  const I nv = n >> 2;
  const I v0 = (I)blockIdx.x * (RT_SITE_THREADS * RT_SITE_VECS) + threadIdx.x;
  float4 xr[RT_SITE_VECS], yr[RT_SITE_VECS];
#pragma unroll
  for (int u = 0; u < RT_SITE_VECS; ++u) {
    const I v = v0 + u * RT_SITE_THREADS;
    if (v < nv) {
      xr[u] = __ldg(reinterpret_cast<const float4*>(x) + v);
      yr[u] = __ldg(reinterpret_cast<const float4*>(y) + v);
    }
  }
#pragma unroll
  for (int u = 0; u < RT_SITE_VECS; ++u) {
    const I v = v0 + u * RT_SITE_THREADS;
    if (v >= nv) continue;
    reinterpret_cast<float4*>(out)[v] =
        make_float4(rt_site_op(OP, a, xr[u].x, yr[u].x), rt_site_op(OP, a, xr[u].y, yr[u].y),
                    rt_site_op(OP, a, xr[u].z, yr[u].z), rt_site_op(OP, a, xr[u].w, yr[u].w));
  }
  if (blockIdx.x == gridDim.x - 1) {
    const I e = 4 * nv + threadIdx.x;
    if (e < n) out[e] = rt_site_op(OP, a, x[e], y[e]);
  }
}

// -- the general path: mixed layouts, or a misaligned operand --------------------------

__global__ void __launch_bounds__(RT_SITE_THREADS)
    site_g5_mixed_kernel(const float* __restrict__ x, float* __restrict__ out, int ncomp,
                         long long nsites, int flip_from, rt_layout lx, rt_layout lo) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= (long long)ncomp * nsites) return;
  int c;
  long long s;
  rt_coords(lo, i, ncomp, nsites, c, s);
  const float v = x[rt_index(lx, c, s, ncomp, nsites)];
  out[i] = c >= flip_from ? -v : v;
}

template <int OP>
__global__ void __launch_bounds__(RT_SITE_THREADS)
    site_binary_mixed_kernel(float a, const float* __restrict__ x, const float* __restrict__ y,
                             float* __restrict__ out, int ncomp, long long nsites, rt_layout lx,
                             rt_layout ly, rt_layout lo, long long sx, long long sy) {
  const long long b = blockIdx.y;
  const long long n = (long long)ncomp * nsites;
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  x += b * sx;
  y += b * sy;
  out += b * n;
  int c;
  long long s;
  rt_coords(lo, i, ncomp, nsites, c, s);
  out[i] = rt_site_op(OP, a, x[rt_index(lx, c, s, ncomp, nsites)],
                      y[rt_index(ly, c, s, ncomp, nsites)]);
}

// -- host side ------------------------------------------------------------------------

// Blocks of the vector path for n elements (at least one, for the tail).
static inline unsigned rt_site_grid(long long n) {
  const long long per = RT_SITE_THREADS * RT_SITE_VECS * 4;
  return (unsigned)((n + per - 1) / per > 0 ? (n + per - 1) / per : 1);
}

// 32-bit element indices when a field's elements fit an int.
static inline bool rt_small(long long n) { return n < (1ll << 31) - 4 * RT_SITE_THREADS; }

template <int OP>
static int rt_site_binary(float a, const float* x, const float* y, float* out, int ncomp,
                          long long nsites, int batch, long long sx, long long sy, int lx,
                          int ly, int lo, cudaStream_t stream) {
  const long long n = (long long)ncomp * nsites;
  const rt_layout L[3] = {rt_make_layout(lx), rt_make_layout(ly), rt_make_layout(lo)};
  if (rt_launch_class(L, 3) < 0) return RT_BAD_LAYOUT;
  if (n == 0 || batch == 0) return 0;
  const bool vec = rt_same_layout(L[0], L[2]) && rt_same_layout(L[1], L[2]) && rt_aligned(x) &&
                   rt_aligned(y) && rt_aligned(out) && sx % 4 == 0 && sy % 4 == 0 &&
                   (batch == 1 || n % 4 == 0);
  if (!vec) {
    site_binary_mixed_kernel<OP><<<dim3(rt_grid(n, RT_SITE_THREADS), batch), RT_SITE_THREADS, 0,
                                   stream>>>(a, x, y, out, ncomp, nsites, L[0], L[1], L[2], sx,
                                             sy);
  } else if (rt_small(n)) {
    site_binary_kernel<OP, int><<<dim3(rt_site_grid(n), batch), RT_SITE_THREADS, 0, stream>>>(
        a, x, y, out, (int)n, sx, sy);
  } else {
    site_binary_kernel<OP, long long><<<dim3(rt_site_grid(n), batch), RT_SITE_THREADS, 0,
                                        stream>>>(a, x, y, out, n, sx, sy);
  }
  RT_LAUNCH_RESULT();
}

extern "C" {

// x, out: ncomp x nsites fields in layouts lx, lo (descriptors); components
// [flip_from, ncomp) change sign.
int rt_site_g5(const float* x, float* out, int ncomp, long long nsites, int flip_from, int lx,
               int lo, cudaStream_t stream) {
  const long long n = (long long)ncomp * nsites;
  const rt_layout L[2] = {rt_make_layout(lx), rt_make_layout(lo)};
  const int k = rt_launch_class(L, 2);
  if (k < 0) return RT_BAD_LAYOUT;
  if (n == 0) return 0;
  if (k == RT_K_ANY || !rt_aligned(x) || !rt_aligned(out)) {
    site_g5_mixed_kernel<<<rt_grid(n, RT_SITE_THREADS), RT_SITE_THREADS, 0, stream>>>(
        x, out, ncomp, nsites, flip_from, L[0], L[1]);
  } else if (rt_small(n)) {
    RT_WITH_CLASS(k, site_g5_kernel<RT_K, int><<<rt_site_grid(n), RT_SITE_THREADS, 0, stream>>>(
                         x, out, ncomp, (int)nsites, flip_from, L[0]));
  } else {
    RT_WITH_CLASS(k, site_g5_kernel<RT_K, long long><<<rt_site_grid(n), RT_SITE_THREADS, 0,
                                                       stream>>>(x, out, ncomp, nsites,
                                                                 flip_from, L[0]));
  }
  RT_LAUNCH_RESULT();
}

// x, y: batch fields one after another in layouts lx, ly (or one shared
// field where its stride sx, sy is 0); out: batch fields in lo.  The single
// product is batch 1 with both strides 0.
int rt_site_mul(const float* x, const float* y, float* out, int ncomp, long long nsites,
                int batch, long long sx, long long sy, int lx, int ly, int lo,
                cudaStream_t stream) {
  return rt_site_binary<RT_SITE_MUL>(0.0f, x, y, out, ncomp, nsites, batch, sx, sy, lx, ly, lo,
                                   stream);
}

int rt_site_axpy(float a, const float* x, const float* y, float* out, int ncomp,
                 long long nsites, int lx, int ly, int lo, cudaStream_t stream) {
  return rt_site_binary<RT_SITE_AXPY>(a, x, y, out, ncomp, nsites, 1, 0, 0, lx, ly, lo, stream);
}

const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
