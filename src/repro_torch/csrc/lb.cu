// K7, K8 and K5L: the D3Q19 lattice-Boltzmann kernels of the Ludwig step.
//
// Fields are fp32 over a periodic (X, Y, Z) lattice, site = (x*Y + y)*Z + z,
// each in the layout of its descriptor: component c of site s at INDEX(c, s)
// (rt_at, common.cuh), c*V + s under SoA.  One thread per site; consecutive
// threads take consecutive sites, so under SoA (and AoSoA with SAL >= 32)
// every warp's loads and stores of one component coalesce; under AoS they
// lie 76 B (dist) apart and each touches a sector of its own.  The
// arithmetic is the same in every layout, so every output is bitwise the
// SoA launch's, repacked.  Each kernel is instantiated for each layout class
// (common.cuh); the all-SoA one is SoA's addresses alone.  Offsets are 64-bit: 19 * V reaches
// 3.2e8 at (256, 256, 256).
//
// K7 rt_lb_collide replaces kernels/lb_collision/kernel.py::collide_pallas
//   (pallas_call :53): BGK collision + Guo forcing, site-local, with dist,
//   force and out each in its own layout (the TPU kernel takes force's
//   layout apart from dist's).  Reads 19 + 3
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
//   Registers of the SoA instantiations (-Xptxas -v, sm_90a, CUDA 12.8):
//   collide 48, propagate 40, lb_step 56, no spills.
//
// K5L's policy instance rt_lb_step_bf16 (the same _build_nd fused_kernel
//   under a DtypePolicy with storage "bfloat16", compute "float32": the
//   Ludwig step's LB half-step with LudwigConfig.storage = "bfloat16"):
//   dist and force rounded to bf16 as they are loaded (bf16.cuh; the
//   reference rounds them before its pallas_call), moments, collision and
//   streaming in fp32, dist2 and u written in bf16.  The graph has no
//   sums.  It is lb_step_kernel with BF set, so its fp32 arithmetic is the
//   policy-free kernel's on the rounded values.  It reads the caller's fp32
//   dist and force (88 B a site) and writes 44: 132 B a site against the
//   policy-free 176 (the reference's model counts 88).  Under an fp32
//   storage the policy-free rt_lb_step runs: its outputs are already the
//   policy's.

#include "bf16.cuh"
#include "d3q19.cuh"

struct rt_lattice3 {
  int X, Y, Z;
};

// RB rounds every value to bf16 as it is loaded.
template <int K, bool RB = false>
__device__ __forceinline__ void rt_load_site(const float* __restrict__ f, const rt_layout& lf,
                                             const float* __restrict__ force,
                                             const rt_layout& lfr, long long V, long long s,
                                             float (&fl)[RT_NVEL], float (&fr)[3]) {
#pragma unroll
  for (int i = 0; i < RT_NVEL; ++i) fl[i] = rt_bf16_if<RB>(f[rt_at<K>(lf, i, s, RT_NVEL, V)]);
#pragma unroll
  for (int a = 0; a < 3; ++a) fr[a] = rt_bf16_if<RB>(force[rt_at<K>(lfr, a, s, 3, V)]);
}

// Layouts of an LB launch's tensors: dist in, force in, dist out, u out.
struct rt_lb_layouts {
  rt_layout f, force, out, u;
};

template <int K>
__global__ void lb_collide_kernel(const float* __restrict__ f, const float* __restrict__ force,
                                  float* __restrict__ out, long long V, rt_lb_params p,
                                  rt_lb_layouts ll) {
  const long long s = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (s >= V) return;
  float fl[RT_NVEL], fr[3], o[RT_NVEL];
  rt_load_site<K>(f, ll.f, force, ll.force, V, s, fl, fr);
  rt_collide_site(fl, fr, p, o);
#pragma unroll
  for (int i = 0; i < RT_NVEL; ++i) out[rt_at<K>(ll.out, i, s, RT_NVEL, V)] = o[i];
}

template <int K>
__global__ void lb_propagate_kernel(const float* __restrict__ f, float* __restrict__ out,
                                    rt_lattice3 L, rt_layout lf, rt_layout lout) {
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
    out[rt_at<K>(lout, i, s, RT_NVEL, V)] = f[rt_at<K>(lf, i, src, RT_NVEL, V)];
  }
}

// BF: the policy instance (bf16 stage-in and bf16 dist2 and u).
template <int K, bool BF = false>
__global__ void lb_step_kernel(const float* __restrict__ f, const float* __restrict__ force,
                               typename rt_storage<BF>::type* __restrict__ dist2,
                               typename rt_storage<BF>::type* __restrict__ u, rt_lattice3 L,
                               rt_lb_params p, rt_lb_layouts ll) {
  const long long V = (long long)L.X * L.Y * L.Z;
  const long long s = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (s >= V) return;
  float fl[RT_NVEL], fr[3], o[RT_NVEL];
  rt_load_site<K, BF>(f, ll.f, force, ll.force, V, s, fl, fr);
  if (u != nullptr) {
    const float rho = rt_density(fl);
    float mom[3];
    rt_momentum(fl, mom);
#pragma unroll
    for (int a = 0; a < 3; ++a)
      rt_st(u, rt_at<K>(ll.u, a, s, 3, V), mom[a] / rho + 0.5f * fr[a] / rho);
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
    rt_st(dist2, rt_at<K>(ll.out, i, dst, RT_NVEL, V), o[i]);
  }
}

extern "C" {

// f, out: 19 x V, force: 3 x V, in the layouts of descriptors lf, lfr, lout.
int rt_lb_collide(const float* f, const float* force, float* out, long long V, float omega,
                  float pw0, float pw1, float pw2, int lf, int lfr, int lout, int block,
                  cudaStream_t stream) {
  const rt_layout L[3] = {rt_make_layout(lf), rt_make_layout(lfr), rt_make_layout(lout)};
  const int k = rt_launch_class(L, 3);
  if (k < 0) return RT_BAD_LAYOUT;
  if (V == 0) return 0;
  const rt_lb_layouts ll{L[0], L[1], L[2], L[2]};
  const rt_lb_params p = rt_make_lb_params(omega, pw0, pw1, pw2);
  RT_WITH_CLASS(k, lb_collide_kernel<RT_K><<<rt_grid(V, block), block, 0, stream>>>(
                       f, force, out, V, p, ll));
  RT_LAUNCH_RESULT();
}

// f, out: 19 x (X*Y*Z) in the layouts of descriptors lf, lout; out must not
// alias f.
int rt_lb_propagate(const float* f, float* out, int X, int Y, int Z, int lf, int lout,
                    int block, cudaStream_t stream) {
  const long long V = (long long)X * Y * Z;
  const rt_layout L[2] = {rt_make_layout(lf), rt_make_layout(lout)};
  const int k = rt_launch_class(L, 2);
  if (k < 0) return RT_BAD_LAYOUT;
  if (V == 0) return 0;
  RT_WITH_CLASS(k, lb_propagate_kernel<RT_K><<<rt_grid(V, block), block, 0, stream>>>(
                       f, out, rt_lattice3{X, Y, Z}, L[0], L[1]));
  RT_LAUNCH_RESULT();
}

// f, dist2: 19 x V; force: 3 x V; u: 3 x V or null (then not written); in
// the layouts of descriptors lf, lfr, ld2, lu (lu unread when u is null).
// dist2 must not alias f.
int rt_lb_step(const float* f, const float* force, float* dist2, float* u, int X, int Y, int Z,
               float omega, float pw0, float pw1, float pw2, int lf, int lfr, int ld2, int lu,
               int block, cudaStream_t stream) {
  const long long V = (long long)X * Y * Z;
  const rt_layout L[4] = {rt_make_layout(lf), rt_make_layout(lfr), rt_make_layout(ld2),
                          rt_make_layout(lu)};
  const int k = rt_launch_class(L, u != nullptr ? 4 : 3);
  if (k < 0) return RT_BAD_LAYOUT;
  if (V == 0) return 0;
  const rt_lb_layouts ll{L[0], L[1], L[2], L[3]};
  const rt_lb_params p = rt_make_lb_params(omega, pw0, pw1, pw2);
  RT_WITH_CLASS(k, lb_step_kernel<RT_K><<<rt_grid(V, block), block, 0, stream>>>(
                       f, force, dist2, u, rt_lattice3{X, Y, Z}, p, ll));
  RT_LAUNCH_RESULT();
}

// The policy instance: as rt_lb_step, with dist2 and u (or null) bf16.
int rt_lb_step_bf16(const float* f, const float* force, void* dist2, void* u, int X, int Y,
                    int Z, float omega, float pw0, float pw1, float pw2, int lf, int lfr, int ld2,
                    int lu, int block, cudaStream_t stream) {
  const long long V = (long long)X * Y * Z;
  const rt_layout L[4] = {rt_make_layout(lf), rt_make_layout(lfr), rt_make_layout(ld2),
                          rt_make_layout(lu)};
  const int k = rt_launch_class(L, u != nullptr ? 4 : 3);
  if (k < 0) return RT_BAD_LAYOUT;
  if (V == 0) return 0;
  const rt_lb_layouts ll{L[0], L[1], L[2], L[3]};
  const rt_lb_params p = rt_make_lb_params(omega, pw0, pw1, pw2);
  RT_WITH_CLASS(k, lb_step_kernel<RT_K, true><<<rt_grid(V, block), block, 0, stream>>>(
                       f, force, static_cast<__nv_bfloat16*>(dist2),
                       static_cast<__nv_bfloat16*>(u), rt_lattice3{X, Y, Z}, p, ll));
  RT_LAUNCH_RESULT();
}

}  // extern "C"
