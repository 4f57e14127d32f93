// K4: the Wilson hopping term D psi on a periodic lattice.
//
// Replaces the TPU kernel kernels/wilson_dslash/kernel.py::dslash_site_pallas
// (pallas_call :53) together with its gather prologue (ops.py:53-54): the
// TPU path first materialises the 192-component neighbour pack and the
// backward links (6.4 GB and 2.4 GB at (64,64,64,32)), then runs the site
// math over (ncomp, vvl) blocks.  Here one thread per site gathers its
// neighbours by periodic index arithmetic inside the kernel (wilson.cuh).
//
// Bound on the H100: bytes.  Compulsory traffic is psi + u in, D psi out:
// (24 + 72 + 24) * 4 = 480 B a site for about 1320 flops, 2.75 flop/byte,
// under the ~20 flop/byte fp32 ridge.  Each neighbour spinor is read by 8
// sites; the design leaves that reuse to the 50 MB L2 (a later PR can stage
// tiles in shared memory).

#include "wilson.cuh"

__global__ void dslash_kernel(const float* __restrict__ psi, const float* __restrict__ u,
                              float* __restrict__ out, rt_lattice L) {
  const long long V = (long long)L.X * L.Y * L.Z * L.T;
  const long long s = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (s >= V) return;
  float d[24];
  rt_wilson_hop(psi, u, L, s, d);
#pragma unroll
  for (int c = 0; c < 24; ++c) out[(long long)c * V + s] = d[c];
}

extern "C" {

// psi, out: (24, V) SoA; u: (72, V) SoA; V = X*Y*Z*T.
int rt_dslash(const float* psi, const float* u, float* out, int X, int Y, int Z, int T,
              int block, cudaStream_t stream) {
  const long long V = (long long)X * Y * Z * T;
  if (V == 0) return 0;
  dslash_kernel<<<rt_grid(V, block), block, 0, stream>>>(psi, u, out, rt_lattice{X, Y, Z, T});
  RT_LAUNCH_RESULT();
}

}  // extern "C"
