// K1: site-local launches over SoA fields.
//
// Replaces the TPU kernel core/target.py::TargetKernel._run_pallas (inner
// pallas_kernel, pallas_call at :398), which traces any Python body into a
// kernel over (ncomp, vvl) site blocks.  CUDA cannot trace a Python body, so
// each body on the solve's path has its own entry point here, registered
// against the body in repro_torch.core.target:
//
//   rt_site_g5    gamma5: out = x with components >= flip_from negated (cg.g5)
//   rt_site_mul   out = x * y                         (the product in cg.dot)
//   rt_site_axpy  out = x * a + y, a a static param   (cg.axpy)
//
// Bound on the H100: bytes.  Each is a streaming pass with well under one
// flop per byte (g5 reads and writes 24 fp32 per site, 192 B; the product
// reads two and writes one, 288 B), far below the card's ~20 flop/byte
// fp32 ridge.  The design is the plain one for that: one thread per
// element of the flat SoA array, consecutive threads on consecutive
// addresses so every warp's loads and stores coalesce, no shared memory.

#include "common.cuh"

__global__ void site_g5_kernel(const float* __restrict__ x, float* __restrict__ out,
                               long long n, long long flip_start) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float v = x[i];
  out[i] = i >= flip_start ? -v : v;
}

__global__ void site_mul_kernel(const float* __restrict__ x, const float* __restrict__ y,
                                float* __restrict__ out, long long n) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = x[i] * y[i];
}

__global__ void site_axpy_kernel(float a, const float* __restrict__ x,
                                 const float* __restrict__ y, float* __restrict__ out,
                                 long long n) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = x[i] * a + y[i];
}

extern "C" {

// x, out: (ncomp, nsites) SoA; components [flip_from, ncomp) change sign.
int rt_site_g5(const float* x, float* out, int ncomp, long long nsites, int flip_from,
               int block, cudaStream_t stream) {
  const long long n = (long long)ncomp * nsites;
  if (n == 0) return 0;
  site_g5_kernel<<<rt_grid(n, block), block, 0, stream>>>(x, out, n,
                                                           (long long)flip_from * nsites);
  RT_LAUNCH_RESULT();
}

int rt_site_mul(const float* x, const float* y, float* out, long long n, int block,
                cudaStream_t stream) {
  if (n == 0) return 0;
  site_mul_kernel<<<rt_grid(n, block), block, 0, stream>>>(x, y, out, n);
  RT_LAUNCH_RESULT();
}

int rt_site_axpy(float a, const float* x, const float* y, float* out, long long n, int block,
                 cudaStream_t stream) {
  if (n == 0) return 0;
  site_axpy_kernel<<<rt_grid(n, block), block, 0, stream>>>(a, x, y, out, n);
  RT_LAUNCH_RESULT();
}

const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
