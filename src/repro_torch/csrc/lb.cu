// K7, K8 and K5L: the D3Q19 lattice-Boltzmann kernels of the Ludwig step.
//
// Fields are SoA fp32 over a periodic (X, Y, Z) lattice,
// site = (x*Y + y)*Z + z, component c of site s at c*V + s.  One thread per
// site; consecutive threads take consecutive sites, so every warp's loads
// and stores of one component coalesce.  Offsets are 64-bit: 19 * V reaches
// 3.2e8 at (256, 256, 256).
//
// K7 rt_lb_collide replaces kernels/lb_collision/kernel.py::collide_pallas
//   (pallas_call :53): BGK collision + Guo forcing, site-local.  Reads 19 + 3
//   values a site and writes 19: 164 compulsory bytes a site for about 450
//   flops, under 3 flop/byte and far below the ~20 flop/byte fp32 ridge of
//   the H100, so it is bound by bytes.  The design is the plain one for
//   that: no shared memory, every value read once into registers.
//
// K8 rt_lb_propagate replaces kernels/lb_propagation/kernel.py::
//   propagate_pallas (pallas_call :58): streaming out_i(r) = f_i(r - c_i), a
//   pull gather with the periodic wrap computed in the kernel.  The TPU path
//   first builds a halo'd copy of the whole lattice (19 (X+2)(Y+2)(Z+2)
//   floats, ops.py:32) and stages it in VMEM; no such copy is made here.
//   Pure data movement, 152 bytes a site: bound by bytes.  It must equal its
//   plain version bitwise.
//
// K5L rt_lb_step replaces core/fuse.py::LaunchGraph._build_nd (fused_kernel
//   :1721, pallas_call :1914) for the ludwig_lb_step graph (moments,
//   collision, streaming; outputs dist2 and u) and, with u null, for
//   lb_collide_propagate.  The TPU kernel stages the halo'd lattice in VMEM
//   and recomputes collision on the ring-1 halo, so that streaming gathers
//   post-collision neighbours; a Hopper block cannot see other blocks'
//   results.  This kernel streams by PUSH instead: the thread of site s
//   reads f(s) and force(s) once, writes u(s) (the _moments_body formula,
//   mom/rho + 0.5 force/rho, which is not collision's (mom + 0.5 force)/rho),
//   collides in registers and writes dist2_i(s + c_i).  Every output is
//   written exactly once, nothing is recomputed, the post-collision
//   distributions never reach device memory, and the traffic is the
//   compulsory 176 bytes a site (88 read, 88 written).  A pull design would
//   recompute the collision of 19 neighbours per site.  The stores of one
//   velocity are shifted by a constant, so they still coalesce away from the
//   wrap.  dist2 uses the same rt_collide_site as K7 and moves data only
//   after it, and equals K8(K7(f)) bitwise (tests/test_torch_cuda.py).
//   Registers (-Xptxas -v, sm_90a, CUDA 12.8): collide 48, propagate 40,
//   lb_step 56, no spills.

#include "d3q19.cuh"

struct rt_lattice3 {
  int X, Y, Z;
};

__device__ __forceinline__ void rt_load_site(const float* __restrict__ f,
                                             const float* __restrict__ force, long long V,
                                             long long s, float (&fl)[RT_NVEL], float (&fr)[3]) {
#pragma unroll
  for (int i = 0; i < RT_NVEL; ++i) fl[i] = f[(long long)i * V + s];
#pragma unroll
  for (int a = 0; a < 3; ++a) fr[a] = force[(long long)a * V + s];
}

__global__ void lb_collide_kernel(const float* __restrict__ f, const float* __restrict__ force,
                                  float* __restrict__ out, long long V, rt_lb_params p) {
  const long long s = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (s >= V) return;
  float fl[RT_NVEL], fr[3], o[RT_NVEL];
  rt_load_site(f, force, V, s, fl, fr);
  rt_collide_site(fl, fr, p, o);
#pragma unroll
  for (int i = 0; i < RT_NVEL; ++i) out[(long long)i * V + s] = o[i];
}

__global__ void lb_propagate_kernel(const float* __restrict__ f, float* __restrict__ out,
                                    rt_lattice3 L) {
  const long long V = (long long)L.X * L.Y * L.Z;
  const long long s = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (s >= V) return;
  const int z = (int)(s % L.Z);
  const int y = (int)((s / L.Z) % L.Y);
  const int x = (int)(s / ((long long)L.Y * L.Z));
#pragma unroll
  for (int i = 0; i < RT_NVEL; ++i) {
    const long long src = ((long long)rt_wrap(x - rt_cv(i, 0), L.X) * L.Y +
                           rt_wrap(y - rt_cv(i, 1), L.Y)) * L.Z +
                          rt_wrap(z - rt_cv(i, 2), L.Z);
    out[(long long)i * V + s] = f[(long long)i * V + src];
  }
}

__global__ void lb_step_kernel(const float* __restrict__ f, const float* __restrict__ force,
                               float* __restrict__ dist2, float* __restrict__ u,
                               rt_lattice3 L, rt_lb_params p) {
  const long long V = (long long)L.X * L.Y * L.Z;
  const long long s = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (s >= V) return;
  float fl[RT_NVEL], fr[3], o[RT_NVEL];
  rt_load_site(f, force, V, s, fl, fr);
  if (u != nullptr) {
    const float rho = rt_density(fl);
    float mom[3];
    rt_momentum(fl, mom);
#pragma unroll
    for (int a = 0; a < 3; ++a) u[(long long)a * V + s] = mom[a] / rho + 0.5f * fr[a] / rho;
  }
  rt_collide_site(fl, fr, p, o);
  const int z = (int)(s % L.Z);
  const int y = (int)((s / L.Z) % L.Y);
  const int x = (int)(s / ((long long)L.Y * L.Z));
#pragma unroll
  for (int i = 0; i < RT_NVEL; ++i) {
    const long long dst = ((long long)rt_wrap(x + rt_cv(i, 0), L.X) * L.Y +
                           rt_wrap(y + rt_cv(i, 1), L.Y)) * L.Z +
                          rt_wrap(z + rt_cv(i, 2), L.Z);
    dist2[(long long)i * V + dst] = o[i];
  }
}

extern "C" {

// f, out: (19, V) SoA; force: (3, V) SoA.
int rt_lb_collide(const float* f, const float* force, float* out, long long V, float omega,
                  float pw0, float pw1, float pw2, int block, cudaStream_t stream) {
  if (V == 0) return 0;
  lb_collide_kernel<<<rt_grid(V, block), block, 0, stream>>>(
      f, force, out, V, rt_make_lb_params(omega, pw0, pw1, pw2));
  RT_LAUNCH_RESULT();
}

// f, out: (19, X*Y*Z) SoA; out must not alias f.
int rt_lb_propagate(const float* f, float* out, int X, int Y, int Z, int block,
                    cudaStream_t stream) {
  const long long V = (long long)X * Y * Z;
  if (V == 0) return 0;
  lb_propagate_kernel<<<rt_grid(V, block), block, 0, stream>>>(f, out, rt_lattice3{X, Y, Z});
  RT_LAUNCH_RESULT();
}

// f, dist2: (19, V) SoA; force: (3, V); u: (3, V) or null (then not written).
// dist2 must not alias f.
int rt_lb_step(const float* f, const float* force, float* dist2, float* u, int X, int Y, int Z,
               float omega, float pw0, float pw1, float pw2, int block, cudaStream_t stream) {
  const long long V = (long long)X * Y * Z;
  if (V == 0) return 0;
  lb_step_kernel<<<rt_grid(V, block), block, 0, stream>>>(
      f, force, dist2, u, rt_lattice3{X, Y, Z}, rt_make_lb_params(omega, pw0, pw1, pw2));
  RT_LAUNCH_RESULT();
}

}  // extern "C"
