// K4: the Wilson hopping term D psi on a periodic lattice.
//
// Replaces the TPU kernel kernels/wilson_dslash/kernel.py::dslash_site_pallas
// (pallas_call :53) together with its gather prologue (ops.py:53-54): the
// TPU path first materialises the 192-component neighbour pack and the
// backward links (6.4 GB and 2.4 GB at (64,64,64,32)), then runs the site
// math over (ncomp, vvl) blocks in the field's layout.  Here one thread per
// site gathers its neighbours by periodic index arithmetic inside the
// kernel (wilson.cuh).
//
// Layouts: psi, u and out each come with a layout descriptor (SoA, AoS or
// AoSoA); every load and store goes through INDEX (rt_at, common.cuh), and
// the arithmetic is the same in every layout, so out is bitwise the SoA
// launch's, repacked.  The kernel is instantiated for each layout class
// (common.cuh); the all-SoA one is SoA's addresses alone.
//
// Bound on the H100: bytes.  Compulsory traffic is psi + u in, D psi out:
// (24 + 72 + 24) * 4 = 480 B a site for about 1320 flops, 2.75 flop/byte,
// under the ~20 flop/byte fp32 ridge.  Each neighbour spinor is read by 8
// sites; the design leaves that reuse to the 50 MB L2 (a later PR can stage
// tiles in shared memory).  Under AoS a warp's 32 sites lie 96 B (psi) and
// 288 B (u) apart, so every load touches 32 sectors; AoSoA with SAL >= 32
// coalesces as SoA does.

#include "wilson.cuh"

template <int K>
__global__ void dslash_kernel(const float* __restrict__ psi, const float* __restrict__ u,
                              float* __restrict__ out, rt_lattice L, rt_layout lpsi,
                              rt_layout lu, rt_layout lout) {
  const long long V = (long long)L.X * L.Y * L.Z * L.T;
  const long long s = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (s >= V) return;
  const float* const ps[1] = {psi};
  float d[1][24];
  rt_wilson_hop<K, K, false, false, 1>(ps, lpsi, rt_wf<float>{u, lu}, 1, L, s, d);
#pragma unroll
  for (int c = 0; c < 24; ++c) out[rt_at<K>(lout, c, s, 24, V)] = d[0][c];
}

extern "C" {

// psi, out: 24 x V, u: 72 x V, in the layouts of descriptors lpsi, lu, lout;
// V = X*Y*Z*T.
int rt_dslash(const float* psi, const float* u, float* out, int X, int Y, int Z, int T,
              int lpsi, int lu, int lout, int block, cudaStream_t stream) {
  const long long V = (long long)X * Y * Z * T;
  const rt_layout L[3] = {rt_make_layout(lpsi), rt_make_layout(lu), rt_make_layout(lout)};
  const int k = rt_launch_class(L, 3);
  if (k < 0) return RT_BAD_LAYOUT;
  if (V == 0) return 0;
  RT_WITH_CLASS(k, dslash_kernel<RT_K><<<rt_grid(V, block), block, 0, stream>>>(
                       psi, u, out, rt_lattice{X, Y, Z, T}, L[0], L[1], L[2]));
  RT_LAUNCH_RESULT();
}

}  // extern "C"
