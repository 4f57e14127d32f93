// K7, K8 and K5L: the D3Q19 lattice-Boltzmann kernels of the Ludwig step.
//
// Fields are fp32 over a periodic (X, Y, Z) lattice, site = (x*Y + y)*Z + z,
// each in the layout of its descriptor: component c of site s at INDEX(c, s)
// (rt_at, common.cuh), c*V + s under SoA.  The arithmetic is the same in
// every layout, so every output is bitwise the SoA launch's, repacked.  Each
// kernel is instantiated for each layout class (common.cuh); the all-SoA
// one is SoA's addresses alone.  Loaded site by site through INDEX, a
// warp's load of one velocity spans 32 x 76 B in AoS and touches 32
// sectors; every design below moves whole 16-byte pieces instead.
//
// The collision (d3q19.cuh::rt_collide_site, shared by K7, K5L and K9) is
// written with round-to-nearest intrinsics that ptxas never fuses, so its
// bits no longer depend on the code around it: K7, K5L and K9 equal their
// plain versions bitwise on the card, and dist2 = K8(K7(f)) holds bitwise
// whatever K7's or K5L's loads and stores look like.  The pin alone cost
// nothing (K7 and K5L in SoA in turns with the parent, PERF.md §6).
//
// K7 rt_lb_collide replaces kernels/lb_collision/kernel.py::collide_pallas
//   (pallas_call :53): BGK collision + Guo forcing, site-local, with dist,
//   force and out each in its own layout (the TPU kernel takes force's
//   layout apart from dist's).  Reads 19 + 3 values a site and writes 19:
//   164 compulsory bytes a site for about 450 flops, under 3 flop/byte and
//   far below the ~20 flop/byte fp32 ridge of the H100, so it is bound by
//   bytes: 0.821 ms at (256, 256, 256) on 3.35 TB/s.  Design: block q, a
//   thread a site, on the chunk of vvl consecutive sites [q vvl, (q + 1)
//   vvl).  Where dist, force and out share one layout (AoSoA: its SAL
//   dividing vvl), the chunk's values lie in contiguous runs (K5L's loads,
//   below) and move through shared memory both ways: in as float4s, each
//   thread reads its 22 values, collides, writes its 19 back at INDEX over
//   the chunk, and the block stores the chunk's runs as float4s.  22 vvl
//   floats of shared memory (11,264 B at vvl 128).  0.96 ms in SoA, 0.93–
//   0.95 in AoS and aosoa4 (parent 0.98, 4.56, 1.45).  A design of
//   persistent blocks fed by a 3-stage ring of 1-D bulk copies (TMA, one
//   thread issuing, mbarrier completion) and drained by bulk stores took
//   1.00, 0.98, 1.00 ms and was deleted.  The last, partial chunk, mixed
//   layouts, a SAL that does not divide vvl and a misaligned field go site
//   by site through INDEX; offsets are 32-bit where 19 V < 2^31.
//
// K8 rt_lb_propagate replaces kernels/lb_propagation/kernel.py::
//   propagate_pallas (pallas_call :58): streaming out_i(r) = f_i(r - c_i), a
//   pull gather with the periodic wrap computed in the kernel.  The TPU path
//   first builds a halo'd copy of the whole lattice (19 (X+2)(Y+2)(Z+2)
//   floats, ops.py:32) and stages it in VMEM; no such copy is made here.
//   Pure data movement, 152 bytes a site, 0.761 ms at (256, 256, 256): bound
//   by bytes.  It equals its plain version bitwise.
//   - SoA and AoSoA with SAL > RT_K8_MAX_SAL: a thread a site through INDEX,
//     64-bit offsets; each velocity's loads are a shifted run, so they
//     coalesce (0.91 ms in SoA; aosoa8 0.99, aosoa16 0.91).
//   - AoS and AoSoA with SAL <= RT_K8_MAX_SAL, Z a multiple of RT_K8_W and
//     Y of RT_K8_TY: staged tiles.  A block of 128 threads takes TY = 4
//     y-rows x W = 32 z-sites and walks RT_K8_XS = 16 x-planes.  For each
//     x-plane it stages the TY + 2 rows y0 - 1 .. y0 + TY: each row's 32
//     records (one 16-byte aligned run of 608 floats in every such layout)
//     with 16-byte cp.async, and the 5 values of the records at z0 - 1 and
//     z0 + W that the tile pulls (velocities with c_z = +1, -1; periodic)
//     with 4-byte cp.async.  A ring of 4 plane slots holds x - 1, x, x + 1
//     while x + 2 loads.  Each thread composes its 19 values from the rows
//     of its sources (AoS: stride 19 floats, free of bank conflicts), writes
//     them to an out stage, and the block stores the tile's TY row runs as
//     float4s.  69,248 B of shared memory (3 blocks an SM), 96 registers in
//     AoS, 64 in AoSoA; a record is read into shared memory about 1.7 times.
//     1.01–1.02 ms in AoS and aosoa4 (parent 5.11, 2.48).  Measured and
//     deleted (PERF.md): rows staged as their 16-byte aligned span of the
//     records z0 - 1 .. z0 + W (AoS 1.07; aosoa4 1.23 at 2 blocks an SM; as
//     such, walks of 1 and 2 planes 1.51 and 1.18), walks of 4 and 8 planes
//     (1.03, 1.02), tiles for SAL 8–32 (1.02–1.05 against 0.89–0.99 site by
//     site).
//   - Lattices whose Y or Z does not tile, and misaligned fields, go site
//     by site.  kernels/lb_propagation/kernel.py (k8_row_copies,
//     k8_stage_reads, k8_tiled_emulate) mirrors the tiles.
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
//   rounds them as it reads.  u, 3 values at the site itself, goes out
//   through shared memory as 16-byte (bf16: 8-byte) stores in AoS and
//   AoSoA.  The last, partial chunk, mixed layouts, a SAL that does not
//   divide vvl, a misaligned field and a lattice with 19 V >= 2^31 load
//   site by site through INDEX.  kernels/lb_propagation/kernel.py
//   (lb_stage_copy, lb_stage_read) mirrors the staging.
//
//   Stores.  The push: each velocity's store from registers at the site's
//   destination, 32-bit offsets.  In AoS a warp's store of one velocity
//   lands on 32 records 76 B apart; each destination record takes its 19
//   values from 9 source rows, so no block holds a whole record.  A design
//   that grouped the stores (each warp store instruction writing the 1-3
//   velocities of one (c_x, c_y) group into at most 12 neighbouring
//   records) took 0.79x the time in AoS but moved dist2 by an ulp while the
//   collision was unpinned, and was deleted (PERF.md); with the roundings
//   pinned it can come back.
//   Registers (-Xptxas -v, sm_90a, CUDA 12.8): collide 48 staged, 40–48
//   site by site; propagate 40–64 site by site, 96 (AoS) and 64 (AoSoA)
//   tiled; lb_step 48 staged in SoA and 56 in AoS; no spills.
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

#include <cstdint>

#include "bf16.cuh"
#include "d3q19.cuh"

struct rt_lattice3 {
  int X, Y, Z;
};

// Layouts of an LB launch's tensors: dist in, force in, dist out (K7: out),
// u out.
struct rt_lb_layouts {
  rt_layout f, force, out, u;
};

// A site's 19 + 3 values through INDEX; RB rounds each to bf16 as it is
// loaded.
template <int K, typename I, bool RB = false>
__device__ __forceinline__ void rt_load_site(const float* __restrict__ f,
                                             const float* __restrict__ force,
                                             const rt_lb_layouts& ll,
                                             typename rt_same<I>::type V,
                                             typename rt_same<I>::type s, float (&fl)[RT_NVEL],
                                             float (&fr)[3]) {
#pragma unroll
  for (int i = 0; i < RT_NVEL; ++i) fl[i] = rt_bf16_if<RB>(f[rt_at<K, I>(ll.f, i, s, RT_NVEL, V)]);
#pragma unroll
  for (int a = 0; a < 3; ++a) fr[a] = rt_bf16_if<RB>(force[rt_at<K, I>(ll.force, a, s, 3, V)]);
}

// The staged chunks of K7 and K5L (see the header): a block's vvl sites take
// at most this many threads and (19 + 3 + 3) vvl floats of shared memory.
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

// A full chunk's dist (19 vvl floats) and force (3 vvl) into the stage as
// float4s, coalesced in layout class K (not RT_K_ANY): dist's values at
// [0, 19 vvl), force's at [19 vvl, 22 vvl), each in its layout over the
// chunk's vvl sites.  The caller synchronises before the stage is read.
template <int K, typename I>
__device__ __forceinline__ void rt_lb_stage_in(const float* __restrict__ f,
                                               const float* __restrict__ force, float* stage,
                                               I s0, I V, int vvl, int l) {
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
    if (e < n4) *reinterpret_cast<float4*>(stage + 4 * e) = v[k];
  }
}

// Site l's 19 + 3 values from a staged chunk (RB: rounded to bf16).
template <int K, bool RB = false>
__device__ __forceinline__ void rt_lb_stage_read(const float* stage, const rt_lb_layouts& ll,
                                                 int vvl, int l, float (&fl)[RT_NVEL],
                                                 float (&fr)[3]) {
#pragma unroll
  for (int i = 0; i < RT_NVEL; ++i)
    fl[i] = rt_bf16_if<RB>(stage[rt_at<K, int>(ll.f, i, l, RT_NVEL, vvl)]);
#pragma unroll
  for (int a = 0; a < 3; ++a)
    fr[a] = rt_bf16_if<RB>(stage[RT_NVEL * vvl + rt_at<K, int>(ll.force, a, l, 3, vvl)]);
}

// -- K7 ----------------------------------------------------------------------

// K7.  ST: a full chunk's dist and force are staged (rt_lb_stage_in) and its
// 19 vvl outputs go back through the same shared memory as float4 stores
// (every tensor in layout class K; I int); else each thread loads and stores
// its site through INDEX.
template <int K, typename I, bool ST>
__global__ void lb_collide_kernel(const float* __restrict__ f, const float* __restrict__ force,
                                  float* __restrict__ out, I V, rt_lb_params p,
                                  rt_lb_layouts ll) {
  extern __shared__ __align__(16) float rt_lb_stage[];   // ST: (19 + 3) vvl floats
  const int vvl = blockDim.x, l = threadIdx.x;
  const I s0 = (I)blockIdx.x * vvl;
  const I s = s0 + l;
  // ST: whole chunks staged; a last, partial one site by site
  const bool staged = ST && V - s0 >= vvl;
  float fl[RT_NVEL], fr[3], o[RT_NVEL];
  if (staged) {
    rt_lb_stage_in<K, I>(f, force, rt_lb_stage, s0, V, vvl, l);
    __syncthreads();
    rt_lb_stage_read<K>(rt_lb_stage, ll, vvl, l, fl, fr);
  } else {
    if (s >= V) return;
    rt_load_site<K, I>(f, force, ll, V, s, fl, fr);
  }
  rt_collide_site(fl, fr, p, o);
  if (staged) {
    __syncthreads();   // every site read: the stage takes the outputs
#pragma unroll
    for (int i = 0; i < RT_NVEL; ++i) rt_lb_stage[rt_at<K, int>(ll.out, i, l, RT_NVEL, vvl)] = o[i];
    __syncthreads();
    for (int e = l; e < RT_NVEL * vvl / 4; e += vvl)
      rt_st4(out + rt_lb_vec_at<K, I>(e, RT_NVEL, vvl, s0, V),
             *reinterpret_cast<const float4*>(rt_lb_stage + 4 * e));
  } else {
#pragma unroll
    for (int i = 0; i < RT_NVEL; ++i) out[rt_at<K, I>(ll.out, i, s, RT_NVEL, V)] = o[i];
  }
}

// -- K8 ----------------------------------------------------------------------

// K8 through INDEX, a thread a site, 64-bit offsets.
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

// K8's staged tiles (AoS, AoSoA with SAL <= RT_K8_MAX_SAL): a block's tile
// is RT_K8_TY y-rows x RT_K8_W z-sites, walked over RT_K8_XS x-planes.
#define RT_K8_TY 4
#define RT_K8_W 32
#define RT_K8_XS 16
#define RT_K8_MAX_SAL 4
// plane slots of the ring: the plane after next loads while a plane computes
#define RT_K8_SLOTS 4
#define RT_K8_THREADS (RT_K8_TY * RT_K8_W)
// velocities with c_z = +1 (5, 11, 13, 15, 17), and as many with c_z = -1
#define RT_K8_EDGE 5
// floats of a staged row: its W records, then the EDGE values of the record
// before them and the EDGE of the record after (16-byte rows)
#define RT_K8_ROW ((RT_K8_W * RT_NVEL + 2 * RT_K8_EDGE + 3) & ~3)

// Ordinal of velocity i among the velocities of its c_z = +1 or -1.
__host__ __device__ constexpr int rt_k8_edge(int i) {
  return i <= 6 ? 0 : (i - 9 - (i % 2 == 0)) / 2;
}

__device__ __forceinline__ uint32_t rt_smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void rt_cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(rt_smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void rt_cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(rt_smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void rt_cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void rt_cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The staged tile (see the header).  A plane slot holds the TY + 2 rows
// y0 - 1 .. y0 + TY of one x-plane, row q at q * RT_K8_ROW: the W records
// z0 .. z0 + W - 1 as they lie in device memory (whole short arrays, one
// 16-byte aligned run), then the c_z = +1 velocities of the record at z0 - 1
// and the c_z = -1 ones of the record at z0 + W (periodic).
template <int K>
__global__ void __launch_bounds__(RT_K8_THREADS)
    lb_propagate_tiled_kernel(const float* __restrict__ f, float* __restrict__ out,
                              rt_lattice3 L, rt_layout lay) {
  extern __shared__ __align__(16) float rt_k8_stage[];
  constexpr int TY = RT_K8_TY, W = RT_K8_W, R = TY + 2, ROW = RT_K8_ROW;
  constexpr int RUN4 = W * RT_NVEL / 4;   // float4s of a row's W records
  static_assert(RT_K8_SLOTS == 4 && RT_K8_XS > 1, "the ring indexes its slots with & 3");
  float* ostage = rt_k8_stage + RT_K8_SLOTS * R * ROW;   // TY x W records
  const int V = L.X * L.Y * L.Z;
  const int l = threadIdx.x, tz = l % W, ty = l / W;
  const int ntz = L.Z / W, nty = L.Y / TY;
  int b = blockIdx.x;
  const int z0 = (b % ntz) * W;
  b /= ntz;
  const int y0 = (b % nty) * TY;
  const int x0 = (b / nty) * RT_K8_XS;
  const int xs = min(RT_K8_XS, L.X - x0);
  // first site of staged row q of plane pi (x0 - 1 + pi)
  auto row_site = [&](int pi, int q) {
    return (rt_wrap(x0 - 1 + pi, L.X) * L.Y + rt_wrap(y0 - 1 + q, L.Y)) * L.Z;
  };
  auto load_plane = [&](int pi) {
    float* dst = rt_k8_stage + (pi & 3) * R * ROW;
    for (int e = l; e < R * RUN4; e += RT_K8_THREADS) {
      const int q = e / RUN4, k = e - q * RUN4;
      rt_cp_async16(dst + q * ROW + 4 * k, f + (row_site(pi, q) + z0) * RT_NVEL + 4 * k);
    }
    if (l < R * 2 * RT_K8_EDGE) {   // a value of an edge record
      const int q = l / (2 * RT_K8_EDGE), k = l - q * 2 * RT_K8_EDGE;
      const int side = k / RT_K8_EDGE, ord = k - side * RT_K8_EDGE;
      const int i = (ord == 0 ? 5 : 9 + 2 * ord) + side;   // c_z = +1, or -1 on side 1
      const int z = side ? rt_wrap(z0 + W, L.Z) : rt_wrap(z0 - 1, L.Z);
      rt_cp_async4(dst + q * ROW + W * RT_NVEL + k,
                   f + rt_at<K, int>(lay, i, row_site(pi, q) + z, RT_NVEL, V));
    }
    rt_cp_commit();
  };
  for (int pi = 0; pi < 3; ++pi) load_plane(pi);
  for (int j = 0; j < xs; ++j) {
    if (j + 3 <= xs + 1) {
      load_plane(j + 3);
      rt_cp_wait<1>();
    } else {
      rt_cp_wait<0>();
    }
    __syncthreads();
    float o[RT_NVEL];
#pragma unroll
    for (int i = 0; i < RT_NVEL; ++i) {
      const int cx = rt_cv(i, 0), cy = rt_cv(i, 1), cz = rt_cv(i, 2);
      const float* row = rt_k8_stage + (((j + 1 - cx) & 3) * R + ty + 1 - cy) * ROW;
      const int zs = tz - cz;
      if (cz == 0 || (zs >= 0 && zs < W))
        o[i] = row[rt_at<K, int>(lay, i, zs, RT_NVEL, 0)];
      else
        o[i] = row[W * RT_NVEL + (cz > 0 ? 0 : RT_K8_EDGE) + rt_k8_edge(i)];
    }
    // the out stage: row ty's W records from ty W 19, in the layout
#pragma unroll
    for (int i = 0; i < RT_NVEL; ++i)
      ostage[ty * W * RT_NVEL + rt_at<K, int>(lay, i, tz, RT_NVEL, 0)] = o[i];
    __syncthreads();
    const int x = x0 + j;
    for (int e = l; e < TY * RUN4; e += RT_K8_THREADS) {
      const int r = e / RUN4, k = e - r * RUN4;
      const int dst = ((x * L.Y + y0 + r) * L.Z + z0) * RT_NVEL + 4 * k;
      *reinterpret_cast<float4*>(out + dst) = *reinterpret_cast<const float4*>(ostage + 4 * e);
    }
  }
}

// Whether K8 takes the staged tiles for a launch of class k (dist and out in
// layout l): AoS or AoSoA with SAL <= RT_K8_MAX_SAL, whole tiles along y and
// z, 32-bit offsets and 16-byte aligned fields.
static bool rt_k8_tiles(int k, const rt_layout& l, const rt_lattice3& L, const void* f,
                        const void* out) {
  if (k != RT_K_AOS && !(k == RT_K_AOSOA && l.sal <= RT_K8_MAX_SAL && l.sal <= RT_K8_W))
    return false;
  if (L.Z % RT_K8_W || L.Y % RT_K8_TY) return false;
  return 19LL * L.X * L.Y * L.Z < (1LL << 31) && rt_aligned(f) && rt_aligned(out);
}

// -- K5L ---------------------------------------------------------------------

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
    rt_lb_stage_in<K, I>(f, force, rt_lb_stage, s0, V, vvl, l);
    __syncthreads();
    rt_lb_stage_read<K, BF>(rt_lb_stage, ll, vvl, l, fl, fr);
  } else {
    if (s >= V) return;
    rt_load_site<K, I, BF>(f, force, ll, V, s, fl, fr);
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
  if (k < 0 || block < 1 || block > 1024) return RT_BAD_LAYOUT;
  if (V == 0) return 0;
  const rt_lb_layouts ll{L[0], L[1], L[2], L[2]};
  const rt_lb_params p = rt_make_lb_params(omega, pw0, pw1, pw2);
  const unsigned grid = rt_grid(V, block);
  if (rt_lb_stages(k, L[0], V, block, f, force, out, false)) {
    const int smem = (RT_NVEL + 3) * block * (int)sizeof(float);
    switch (k) {
      case RT_K_SOA:
        lb_collide_kernel<RT_K_SOA, int, true><<<grid, block, smem, stream>>>(f, force, out,
                                                                             (int)V, p, ll);
        break;
      case RT_K_AOS:
        lb_collide_kernel<RT_K_AOS, int, true><<<grid, block, smem, stream>>>(f, force, out,
                                                                             (int)V, p, ll);
        break;
      default:
        lb_collide_kernel<RT_K_AOSOA, int, true><<<grid, block, smem, stream>>>(f, force, out,
                                                                               (int)V, p, ll);
    }
  } else if (19 * V < (1LL << 31)) {
    RT_WITH_CLASS(k, lb_collide_kernel<RT_K, int, false><<<grid, block, 0, stream>>>(
                         f, force, out, (int)V, p, ll));
  } else {
    RT_WITH_CLASS(k, lb_collide_kernel<RT_K, long long, false><<<grid, block, 0, stream>>>(
                         f, force, out, V, p, ll));
  }
  RT_LAUNCH_RESULT();
}

// f, out: 19 x (X*Y*Z) in the layouts of descriptors lf, lout; out must not
// alias f.
int rt_lb_propagate(const float* f, float* out, int X, int Y, int Z, int lf, int lout,
                    int block, cudaStream_t stream) {
  const long long V = (long long)X * Y * Z;
  const rt_layout L[2] = {rt_make_layout(lf), rt_make_layout(lout)};
  const int k = rt_launch_class(L, 2);
  if (k < 0 || block < 1 || block > 1024) return RT_BAD_LAYOUT;
  if (V == 0) return 0;
  const rt_lattice3 lat{X, Y, Z};
  if (rt_k8_tiles(k, L[0], lat, f, out)) {
    const int smem = (RT_K8_SLOTS * (RT_K8_TY + 2) * RT_K8_ROW + RT_K8_TY * RT_K8_W * RT_NVEL) *
                     (int)sizeof(float);
    const unsigned grid =
        (unsigned)((Z / RT_K8_W) * (Y / RT_K8_TY) * ((X + RT_K8_XS - 1) / RT_K8_XS));
    static int set_aos = 0, set_aosoa = 0;
    if (k == RT_K_AOS) {
      if (const int e = rt_smem_optin(lb_propagate_tiled_kernel<RT_K_AOS>, smem, set_aos))
        return e;
      lb_propagate_tiled_kernel<RT_K_AOS><<<grid, RT_K8_THREADS, smem, stream>>>(f, out, lat,
                                                                               L[0]);
    } else {
      if (const int e = rt_smem_optin(lb_propagate_tiled_kernel<RT_K_AOSOA>, smem, set_aosoa))
        return e;
      lb_propagate_tiled_kernel<RT_K_AOSOA><<<grid, RT_K8_THREADS, smem, stream>>>(f, out, lat,
                                                                                 L[0]);
    }
  } else {
    RT_WITH_CLASS(k, lb_propagate_kernel<RT_K><<<rt_grid(V, block), block, 0, stream>>>(
                         f, out, lat, L[0], L[1]));
  }
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
