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
// (common.cuh); the all-SoA one is SoA's addresses alone.  K7 and K8 address
// with 64-bit offsets; K5L with 32-bit ones where 19 V < 2^31 (19 V is
// 3.2e8 at (256, 256, 256)), 64-bit above.
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
//
//   Loads.  One thread a site, block q on the chunk of vvl consecutive
//   sites [q vvl, (q + 1) vvl).  Where every tensor of the launch shares one
//   layout, a chunk's values lie in contiguous runs: 19 + 3 runs of vvl
//   floats in SoA, one run of 19 vvl and one of 3 vvl floats in AoS and in
//   AoSoA whose SAL divides vvl.  The block moves them into shared memory as
//   float4s (88 vvl B, 11,264 at vvl 128), coalesced in every layout, and
//   each thread reads its site's 22 values there (AoS: at a stride of 19
//   floats, which is odd, so free of bank conflicts); the policy instance
//   rounds them as it reads.  Loaded site by site, a warp's load of one
//   velocity spans 32 x 76 B in AoS and touches 32 sectors.  u, 3 values at
//   the site itself, goes out through shared memory as 16-byte (bf16:
//   8-byte) stores in AoS and AoSoA.  The last, partial chunk, mixed
//   layouts, a SAL that does not divide vvl, a misaligned field and a
//   lattice with 19 V >= 2^31 load site by site through INDEX.
//   kernels/lb_propagation/kernel.py (lb_stage_copy, lb_stage_read)
//   mirrors the staging.
//
//   Stores.  The push: each velocity's store from registers at the site's
//   destination, 32-bit offsets.  In AoS a warp's store of one velocity
//   lands on 32 records 76 B apart; each destination record takes its 19
//   values from 9 source rows, so no block holds a whole record.  A design
//   that grouped the stores (each warp store instruction writing the 1-3
//   velocities of one (c_x, c_y) group into at most 12 neighbouring
//   records, values exchanged by shuffles or through shared memory, in
//   the kernel or in an instantiation of its own) took 0.79x the time in
//   AoS and was deleted (PERF.md): around it the collision compiled to other
//   fused multiply-adds (FFMA 192, FMUL 59 against 189 and 65; ptxas fuses
//   the unrounded multiplies and adds as the code around them allows), so
//   dist2 was no longer bitwise the SoA launch's, pinned values or not.
//   With the collision out of line (__noinline__) the bits held, at 2.5x
//   the SoA time (the call's arrays go through local memory).
//   Registers (-Xptxas -v, sm_90a, CUDA 12.8): collide 48 and propagate 40
//   in SoA, lb_step 48 staged in SoA and 56 in AoS, no spills.
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

// The staged loads of K5L's full chunks (see the header): a block's vvl sites
// take at most this many threads and (19 + 3 + 3) vvl floats of shared
// memory.
#define RT_LB_MAX_VVL 256

// Offset of the e-th float4 of a chunk's (ncomp, vvl) values starting at site
// s0: SoA, component c's run of vvl floats (c = e / (vvl / 4)); else the
// chunk's one run of ncomp vvl floats.  Its offset in the staged copy is 4 e.
template <int K, typename I>
__device__ __forceinline__ I rt_lb_vec_at(int e, int ncomp, int vvl, I s0, I V) {
  if (K == RT_K_SOA) {
    const int c = e / (vvl >> 2);
    return (I)c * V + s0 + (4 * e - c * vvl);
  }
  return (I)ncomp * s0 + 4 * e;
}

// Four values as the storage type T, one 16-byte (fp32) or 8-byte (bf16)
// store.
__device__ __forceinline__ void rt_st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ void rt_st4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __halves2bfloat162(__float2bfloat16_rn(v.x), __float2bfloat16_rn(v.y));
  const __nv_bfloat162 hi = __halves2bfloat162(__float2bfloat16_rn(v.z), __float2bfloat16_rn(v.w));
  *reinterpret_cast<uint2*>(p) = make_uint2(*reinterpret_cast<const unsigned*>(&lo),
                                            *reinterpret_cast<const unsigned*>(&hi));
}

// K5L.  ST: a full chunk's dist and force move into shared memory as float4s
// and each thread reads its site's 22 values there (every tensor in layout
// class K; I int); else each thread loads its site's values through INDEX.
// Sites and offsets of type I (int where 19 V < 2^31).  BF: the policy
// instance (bf16 stage-in and bf16 dist2 and u).
template <int K, typename I, bool ST, bool BF = false>
__global__ void lb_step_kernel(const float* __restrict__ f, const float* __restrict__ force,
                               typename rt_storage<BF>::type* __restrict__ dist2,
                               typename rt_storage<BF>::type* __restrict__ u, rt_lattice3 L,
                               rt_lb_params p, rt_lb_layouts ll) {
  extern __shared__ __align__(16) float rt_lb_stage[];   // ST: (19 + 3 + 3) vvl floats
  const I V = (I)L.X * L.Y * L.Z;
  const int vvl = blockDim.x, l = threadIdx.x;
  const I s0 = (I)blockIdx.x * vvl;
  const I s = s0 + l;
  // ST: whole chunks staged; a last, partial one loads site by site
  const bool staged = ST && V - s0 >= vvl;
  float fl[RT_NVEL], fr[3], o[RT_NVEL];
  if (staged) {
    const int nd = RT_NVEL * vvl / 4, n4 = (RT_NVEL + 3) * vvl / 4;
    float4 v[6];   // ceil(22 / 4) float4s a thread
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      const int e = l + k * vvl;
      if (e < nd)
        v[k] = __ldg(reinterpret_cast<const float4*>(f + rt_lb_vec_at<K, I>(e, RT_NVEL, vvl, s0,
                                                                           V)));
      else if (e < n4)
        v[k] = __ldg(reinterpret_cast<const float4*>(
            force + rt_lb_vec_at<K, I>(e - nd, 3, vvl, s0, V)));
    }
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      const int e = l + k * vvl;
      if (e < n4) *reinterpret_cast<float4*>(rt_lb_stage + 4 * e) = v[k];
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RT_NVEL; ++i)
      fl[i] = rt_bf16_if<BF>(rt_lb_stage[rt_at<K, int>(ll.f, i, l, RT_NVEL, vvl)]);
#pragma unroll
    for (int a = 0; a < 3; ++a)
      fr[a] = rt_bf16_if<BF>(rt_lb_stage[RT_NVEL * vvl + rt_at<K, int>(ll.force, a, l, 3, vvl)]);
  } else {
    if (s >= V) return;
#pragma unroll
    for (int i = 0; i < RT_NVEL; ++i)
      fl[i] = rt_bf16_if<BF>(f[rt_at<K, I>(ll.f, i, s, RT_NVEL, V)]);
#pragma unroll
    for (int a = 0; a < 3; ++a) fr[a] = rt_bf16_if<BF>(force[rt_at<K, I>(ll.force, a, s, 3, V)]);
  }
  if (u != nullptr) {
    const float rho = rt_density(fl);
    float mom[3];
    rt_momentum(fl, mom);
    float uv[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) uv[a] = mom[a] / rho + 0.5f * fr[a] / rho;
    if (staged && K != RT_K_SOA) {
      // u's chunk is one run of 3 vvl values: through shared memory, 4 a store
      float* us = rt_lb_stage + (RT_NVEL + 3) * vvl;
#pragma unroll
      for (int a = 0; a < 3; ++a) us[rt_at<K, int>(ll.u, a, l, 3, vvl)] = uv[a];
      __syncthreads();
      for (int e = l; e < 3 * vvl / 4; e += vvl)
        rt_st4(u + 3 * s0 + 4 * e, *reinterpret_cast<const float4*>(us + 4 * e));
    } else {
#pragma unroll
      for (int a = 0; a < 3; ++a) rt_st(u, rt_at<K, I>(ll.u, a, s, 3, V), uv[a]);
    }
  }
  rt_collide_site(fl, fr, p, o);
  const int z = (int)(s % L.Z);
  const int y = (int)((s / L.Z) % L.Y);
  const int x = (int)(s / ((I)L.Y * L.Z));
#pragma unroll
  for (int i = 0; i < RT_NVEL; ++i) {
    const I dst = ((I)rt_wrap(x + rt_cv(i, 0), L.X) * L.Y + rt_wrap(y + rt_cv(i, 1), L.Y)) * L.Z +
                  rt_wrap(z + rt_cv(i, 2), L.Z);
    rt_st(dist2, rt_at<K, I>(ll.out, i, dst, RT_NVEL, V), o[i]);
  }
}

// Whether K5L's staged loads take a launch of class k (every tensor in
// layout l) over V sites in blocks of `block`: whole float4s a chunk, 16-byte
// aligned fields (u 8-byte aligned in bf16), 32-bit offsets.
static bool rt_lb_stages(int k, const rt_layout& l, long long V, int block, const void* f,
                         const void* force, const void* u, bool bf16_u) {
  if (k == RT_K_ANY) return false;
  if (block % 4 || block > RT_LB_MAX_VVL || 19 * V >= (1LL << 31)) return false;
  if ((k == RT_K_SOA && V % 4) || (k == RT_K_AOSOA && block % l.sal)) return false;
  const unsigned long long ua = reinterpret_cast<unsigned long long>(u);
  return rt_aligned(f) && rt_aligned(force) && (ua % (bf16_u ? 8 : 16)) == 0;
}

// K5L's launch (BF: the policy instance): staged where rt_lb_stages takes it,
// else site by site with 32-bit offsets where 19 V < 2^31.
template <bool BF>
static int rt_lb_step_launch(const float* f, const float* force,
                             typename rt_storage<BF>::type* dist2,
                             typename rt_storage<BF>::type* u, const rt_lattice3& lat,
                             const rt_lb_params& p, const rt_layout (&L)[4], int block,
                             cudaStream_t stream) {
  const long long V = (long long)lat.X * lat.Y * lat.Z;
  const int k = rt_launch_class(L, u != nullptr ? 4 : 3);
  if (k < 0 || block < 1 || block > 1024) return RT_BAD_LAYOUT;
  if (V == 0) return 0;
  const rt_lb_layouts ll{L[0], L[1], L[2], L[3]};
  const unsigned grid = rt_grid(V, block);
  if (rt_lb_stages(k, L[0], V, block, f, force, u, BF)) {
    const int smem = (RT_NVEL + 6) * block * (int)sizeof(float);
    switch (k) {
      case RT_K_SOA:
        lb_step_kernel<RT_K_SOA, int, true, BF><<<grid, block, smem, stream>>>(f, force, dist2,
                                                                               u, lat, p, ll);
        break;
      case RT_K_AOS:
        lb_step_kernel<RT_K_AOS, int, true, BF><<<grid, block, smem, stream>>>(f, force, dist2,
                                                                               u, lat, p, ll);
        break;
      default:
        lb_step_kernel<RT_K_AOSOA, int, true, BF><<<grid, block, smem, stream>>>(f, force, dist2,
                                                                                 u, lat, p, ll);
    }
  } else if (19 * V < (1LL << 31)) {
    RT_WITH_CLASS(k, lb_step_kernel<RT_K, int, false, BF><<<grid, block, 0, stream>>>(
                         f, force, dist2, u, lat, p, ll));
  } else {
    RT_WITH_CLASS(k, lb_step_kernel<RT_K, long long, false, BF><<<grid, block, 0, stream>>>(
                         f, force, dist2, u, lat, p, ll));
  }
  RT_LAUNCH_RESULT();
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
  const rt_layout L[4] = {rt_make_layout(lf), rt_make_layout(lfr), rt_make_layout(ld2),
                          rt_make_layout(lu)};
  return rt_lb_step_launch<false>(f, force, dist2, u, rt_lattice3{X, Y, Z},
                                  rt_make_lb_params(omega, pw0, pw1, pw2), L, block, stream);
}

// The policy instance: as rt_lb_step, with dist2 and u (or null) bf16.
int rt_lb_step_bf16(const float* f, const float* force, void* dist2, void* u, int X, int Y,
                    int Z, float omega, float pw0, float pw1, float pw2, int lf, int lfr, int ld2,
                    int lu, int block, cudaStream_t stream) {
  const rt_layout L[4] = {rt_make_layout(lf), rt_make_layout(lfr), rt_make_layout(ld2),
                          rt_make_layout(lu)};
  return rt_lb_step_launch<true>(f, force, static_cast<__nv_bfloat16*>(dist2),
                                 static_cast<__nv_bfloat16*>(u), rt_lattice3{X, Y, Z},
                                 rt_make_lb_params(omega, pw0, pw1, pw2), L, block, stream);
}

}  // extern "C"
