// K3: the site-local fused chains of the CG iteration.
//
// Replaces the TPU kernel core/fuse.py::LaunchGraph._build_flat (inner
// fused_kernel :1411, pallas_call :1447, accumulating through _accumulate
// :2032) for the two graph signatures the solve runs; runtime scalars arrive
// as device pointers (the Pallas kernel took them as (1,1) inputs), so the
// host never reads alpha or beta:
//
//   rt_cg_update  x_new = x + alpha p,  r_new = r + neg_alpha ap,  and the
//                 per-block partials of sum_sites r_new^2 per component
//                 (folded by reduce.cu's pass 2; no atomics, no race).
//   rt_cg_xpay    out = y + a x.
//
// Bound on the H100: bytes.  cg_update reads 4 and writes 2 spinors per
// site (576 B) for 3 flops per component; cg_xpay reads 2 and writes 1
// (288 B).  So the design is about bytes in flight and coalescing.
//
// Layouts: every tensor comes with its own layout descriptor (SoA, AoS or
// AoSoA; common.cuh).  Where every operand shares one layout (every launch
// of the solve) both chains are elementwise on the flat arrays, whatever
// the layout, and move 16-byte vectors:
//
//   cg_xpay    as K1's site_local.cu: blocks of RT_XPAY_THREADS threads,
//              RT_XPAY_VECS float4s of each operand a thread, every load
//              issued before the first store, 32-bit offsets inside a
//              field and a 64-bit slot base; the last partial vector of a
//              field whose size is not a multiple of 4 element by element.
//   cg_update  block q computes the chunk of vvl (blockDim.x) sites [q vvl,
//              (q + 1) vvl), as the one-thread-a-site design did.  In a
//              same-layout launch those sites' 24 vvl elements lie in 24
//              runs of vvl floats (SoA) or in one run of 24 vvl floats
//              (AoS, and AoSoA whose SAL divides vvl: whole short arrays),
//              so the block moves them as float4s (a bf16 ap as 8-byte
//              vectors), coalesced in every layout, 6 of each operand a
//              thread.  Each r_new^2 goes to shared memory at (component,
//              site), and the fold then runs as before: thread t takes
//              site t's 24 values and the block folds them with
//              rt_block_partials, the same adds in the same order.
//
// So x_new, r_new and the partial rows are bitwise the one-thread-a-site
// kernel's (cg_update_kernel below), which stays as the general path: mixed
// layouts, a SAL that is not a power of two or does not divide vvl, a
// misaligned operand or slot base, vvl beyond RT_CG_MAX_VVL, and fields
// whose offsets do not fit an int.  It addresses component c of its site at
// INDEX(c, s) in each tensor's layout; under AoS its loads lie ncomp floats
// apart across a warp.  cg_xpay's general path recovers each output
// element's (component, site) from the output's layout.  Every layout is
// bitwise SoA's.
//
// K3B, the batch instances (the serving chains of apps/milc/cg.py,
// _build_flat's leading batch grid axis, _batch_specs :2009): the slot is
// blockIdx.y; a batched operand is offset by whole fields, a shared one
// (batch stride 0) is not; the scalars are (batch,) device vectors read at
// the slot, so the host never reads alpha, beta or the mask:
//
//   rt_cg_update_masked  where(m[b] > 0, x + alpha[b] p, x),
//                        where(m[b] > 0, r + neg_alpha[b] ap, r), and the
//                        per-(block, slot) partials of sum_sites r_new^2,
//                        folded per slot by reduce.cu's pass 2;
//   rt_cg_xpay_masked    where(m[b] > 0, y + a[b] x, y).
//
// The third batch instance, dot_prod (x * y, summed by reduce.cu's batch
// instance), is site_local.cu's product with its slot axis.
//
// The mask is a select: a frozen slot's output is its y input as loaded, so
// -0.0 and NaN pass through untouched (y + 0 * x would turn -0.0 into +0.0
// and take on a NaN of x; apps/milc/cg.py::_masked_fma_body).  A live slot
// computes y + a*x through rt_xpay, the one function the unmasked chains
// use too, so it has the single launch's bits.  The single entry points are
// the same kernels with one slot and no mask.  Bound: bytes, as above per
// slot; a frozen slot reads no p, ap or x.
//
// y + a*x is one fused multiply-add (one rounding), written out so that the
// unmasked and the masked chains cannot be contracted differently: the
// fields match the plain two-rounding torch version to a tolerance, not
// bitwise.
//
// K3 and K3B fed a bf16 ap (rt_cg_update_ap16, rt_cg_update_masked_ap16):
// in the refined inner CG (apps/milc/cg.py::cg_refined, and refined
// serving) the operator's policy instance returns ap in bf16, while the
// update chain runs policy-free on fp32 x, r and p.  The reference's jnp
// promotes bf16 x fp32 to fp32, so the outputs stay fp32 and only ap's load
// widens (exactly).  The same kernel with TAP = __nv_bfloat16: 48 fewer
// bytes a site (528 against 576).
//
// K3's policy instance (rt_cg_update_policy): the cg_update graph under a
// DtypePolicy (core/fuse.py::_build_flat under _stage_in_cast :349, output
// dtypes :960-985) and under the policy-free launch whose inputs are not
// all fp32.  Each of x, r, p, ap is fp32 or bf16 (bit k of in16: x, r, p,
// ap).  A bf16 input is widened as it is loaded (exactly); an fp32 one is
// rounded to bf16 first where rb is set (the policy's bf16 storage: the
// stage-in round, __float2bfloat16_rn as torch's .to(bfloat16)), so a bf16
// input is read as it comes, the round being the identity on it.  The
// arithmetic is fp32 and the same rt_xpay as the policy-free kernels;
// OUT16 writes x_new and r_new in bf16 (one rounding of the fp32 result),
// and r_new^2 folds from the fp32 r_new, as the reference's reduction
// reads the compute-dtype value.  COMP folds the partial rows as (hi, lo)
// pairs (comp.cuh), folded by reduce.cu's compensated pass 2.  With rb,
// OUT16 and COMP off and every input fp32 it is the policy-free kernel's
// arithmetic, so under the accumulate-only policy (COMP alone) x_new and
// r_new are bitwise the policy-free kernel's.  Same-layout launches take
// the vector path (float4s of fp32 operands, 8-byte runs of four bf16; a
// launch whose inputs are all fp32, the sweep's and the tuned solve's,
// loads them with no type branch), which folds a compensated rr one pair
// add an element (rt_cg_table_partials_comp); the rest the one-thread-a-
// site path, with comp.cuh's tree fold.  Bound: bytes; fp32 in and bf16
// out, 4 x 96 + 2 x 48 = 480 B a site (576 policy-free).

#include "bf16.cuh"
#include "comp.cuh"

#define RT_SPINOR 24
#define RT_XPAY_THREADS 256
#define RT_XPAY_VECS 2       // float4s of each operand a thread: 2048 elements a block
#define RT_CG_VECS 6         // float4s of each operand a cg_update thread: 24 vvl / 4 / vvl
#define RT_CG_MAX_VVL 256    // the vector cg_update's (24, vvl) shared r_new^2 (24 KB)

__device__ __forceinline__ float rt_xpay(float y, float a, float x) { return __fmaf_rn(a, x, y); }

// Layouts of cg_update's tensors, in argument order.
struct rt_cg_layouts {
  rt_layout x, r, p, ap, x_new, r_new;
};

// Per-slot element offsets of cg_update's inputs (0 for a shared input); the
// outputs are batched, one whole field a slot.
struct rt_cg_strides {
  long long x, r, p, ap, out;
};

// TAP: ap's storage type (float, or __nv_bfloat16 under the refined solve).
template <int K, bool MASKED, typename TAP = float>
__global__ void cg_update_kernel(const float* __restrict__ x, const float* __restrict__ r,
                                 const float* __restrict__ p, const TAP* __restrict__ ap,
                                 const float* __restrict__ alpha,
                                 const float* __restrict__ neg_alpha,
                                 const float* __restrict__ m, float* __restrict__ x_new,
                                 float* __restrict__ r_new, float* __restrict__ partials,
                                 long long nsites, rt_cg_layouts L, rt_cg_strides S) {
  const long long b = blockIdx.y;
  x += b * S.x;
  r += b * S.r;
  p += b * S.p;
  ap += b * S.ap;
  x_new += b * S.out;
  r_new += b * S.out;
  partials += b * gridDim.x * RT_SPINOR;
  const long long s = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const bool live = s < nsites;
  const bool on = !MASKED || m[b] > 0.0f;
  const float a = alpha[b];
  const float na = neg_alpha[b];
  float sq[RT_SPINOR];
#pragma unroll
  for (int c = 0; c < RT_SPINOR; ++c) {
    sq[c] = 0.0f;
    if (live) {
      float xn = x[rt_at<K>(L.x, c, s, RT_SPINOR, nsites)];
      float rn = r[rt_at<K>(L.r, c, s, RT_SPINOR, nsites)];
      if (on) {
        xn = rt_xpay(xn, a, p[rt_at<K>(L.p, c, s, RT_SPINOR, nsites)]);
        rn = rt_xpay(rn, na, rt_ld(ap, rt_at<K>(L.ap, c, s, RT_SPINOR, nsites)));
      }
      x_new[rt_at<K>(L.x_new, c, s, RT_SPINOR, nsites)] = xn;
      r_new[rt_at<K>(L.r_new, c, s, RT_SPINOR, nsites)] = rn;
      sq[c] = rn * rn;
    }
  }
  rt_block_partials<RT_SPINOR>(sq, RT_OP_SUM, partials + (long long)blockIdx.x * RT_SPINOR);
}

// Four consecutive values as fp32: a float4, or four bf16 (8 bytes) widened
// (exactly: a bf16 is the high half of its fp32).
__device__ __forceinline__ float4 rt_ld4(const float* __restrict__ p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 rt_ld4(const __nv_bfloat16* __restrict__ p) {
  const uint2 w = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(w.x << 16), __uint_as_float(w.x & 0xffff0000u),
                     __uint_as_float(w.y << 16), __uint_as_float(w.y & 0xffff0000u));
}

// Element e of a full block's 24 vvl elements (same layout, layout class K,
// SAL dividing vvl): its component c and local site l, and its offset from
// the block's base (SoA: from component 0 of the block's first site).
template <int K>
__device__ __forceinline__ void rt_cg_elem(int e, int vvl, int nsites, int shift, int& c,
                                           int& l, int& off) {
  if (K == RT_K_SOA) {
    c = e / vvl;
    l = e - c * vvl;
    off = c * nsites + l;
  } else {
    const int blk = e >> shift;   // AoS: shift 0
    c = blk % RT_SPINOR;
    l = ((blk / RT_SPINOR) << shift) + (e & ((1 << shift) - 1));
    off = e;
  }
}

// The vector path of cg_update (see the header): block q, vvl threads, a
// (24, vvl) shared table of r_new^2.  A full block moves float4s; the last
// block, where it has fewer than vvl sites, moves its elements one by one.
template <int K, bool MASKED, typename TAP>
__global__ void cg_update_vec_kernel(const float* __restrict__ x, const float* __restrict__ r,
                                     const float* __restrict__ p, const TAP* __restrict__ ap,
                                     const float* __restrict__ alpha,
                                     const float* __restrict__ neg_alpha,
                                     const float* __restrict__ m, float* __restrict__ x_new,
                                     float* __restrict__ r_new, float* __restrict__ partials,
                                     int nsites, rt_layout L, rt_cg_strides S) {
  extern __shared__ float rt_cg_sq[];
  const int shift = K == RT_K_AOSOA ? L.shift : 0;
  const int vvl = blockDim.x;
  const long long b = blockIdx.y;
  x += b * S.x;
  r += b * S.r;
  p += b * S.p;
  ap += b * S.ap;
  x_new += b * S.out;
  r_new += b * S.out;
  partials += b * gridDim.x * RT_SPINOR;
  const int s0 = blockIdx.x * vvl;
  const int ns = min(vvl, nsites - s0);
  const bool on = !MASKED || m[b] > 0.0f;
  const float a = alpha[b];
  const float na = neg_alpha[b];
  // the block's base: SoA, component 0 of site s0; else the run of its 24 vvl elements
  const int base = K == RT_K_SOA ? s0 : s0 * RT_SPINOR;
  if (ns == vvl) {
    float4 xv[RT_CG_VECS], rv[RT_CG_VECS], pv[RT_CG_VECS], apv[RT_CG_VECS];
    int cs[RT_CG_VECS], ls[RT_CG_VECS], offs[RT_CG_VECS];
#pragma unroll
    for (int k = 0; k < RT_CG_VECS; ++k) {
      rt_cg_elem<K>(4 * (threadIdx.x + k * vvl), vvl, nsites, shift, cs[k], ls[k], offs[k]);
      const int o = base + offs[k];
      xv[k] = rt_ld4(x + o);
      rv[k] = rt_ld4(r + o);
      if (on) {
        pv[k] = rt_ld4(p + o);
        apv[k] = rt_ld4(ap + o);
      }
    }
#pragma unroll
    for (int k = 0; k < RT_CG_VECS; ++k) {
      if (on) {
        xv[k] = make_float4(rt_xpay(xv[k].x, a, pv[k].x), rt_xpay(xv[k].y, a, pv[k].y),
                            rt_xpay(xv[k].z, a, pv[k].z), rt_xpay(xv[k].w, a, pv[k].w));
        rv[k] = make_float4(rt_xpay(rv[k].x, na, apv[k].x), rt_xpay(rv[k].y, na, apv[k].y),
                            rt_xpay(rv[k].z, na, apv[k].z), rt_xpay(rv[k].w, na, apv[k].w));
      }
      const int o = base + offs[k];
      *reinterpret_cast<float4*>(x_new + o) = xv[k];
      *reinterpret_cast<float4*>(r_new + o) = rv[k];
      const float q[4] = {rv[k].x, rv[k].y, rv[k].z, rv[k].w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        int c = cs[k], l = ls[k], off;
        if (i) rt_cg_elem<K>(4 * (threadIdx.x + k * vvl) + i, vvl, nsites, shift, c, l, off);
        rt_cg_sq[c * vvl + l] = q[i] * q[i];
      }
    }
  } else {
    for (int e = threadIdx.x; e < RT_SPINOR * ns; e += vvl) {
      const int c = e / ns, l = e - c * ns;
      const int xi = rt_at<K, int>(L, c, s0 + l, RT_SPINOR, nsites);
      float xn = x[xi], rn = r[xi];
      if (on) {
        xn = rt_xpay(xn, a, p[xi]);
        rn = rt_xpay(rn, na, rt_ld(ap, xi));
      }
      x_new[xi] = xn;
      r_new[xi] = rn;
      rt_cg_sq[c * vvl + l] = rn * rn;
    }
  }
  __syncthreads();
  float sq[RT_SPINOR];
#pragma unroll
  for (int c = 0; c < RT_SPINOR; ++c)
    sq[c] = (int)threadIdx.x < ns ? rt_cg_sq[c * vvl + threadIdx.x] : 0.0f;
  rt_block_partials<RT_SPINOR>(sq, RT_OP_SUM, partials + (long long)blockIdx.x * RT_SPINOR);
}

// -- K3's policy instance ------------------------------------------------------------

// Value i of an fp32 or bf16 (is16) operand as fp32: a bf16 one widened, an
// fp32 one rounded to bf16 first where rb.
__device__ __forceinline__ float rt_ldt(const void* __restrict__ p, long long i, bool is16,
                                        bool rb) {
  if (is16) return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  const float v = static_cast<const float*>(p)[i];
  return rb ? rt_bf16_if<true>(v) : v;
}

// Four consecutive values of such an operand from element o (16-byte
// aligned fp32, 8-byte aligned bf16).
__device__ __forceinline__ float4 rt_ld4t(const void* __restrict__ p, int o, bool is16, bool rb) {
  if (is16) return rt_ld4(static_cast<const __nv_bfloat16*>(p) + o);
  float4 v = rt_ld4(static_cast<const float*>(p) + o);
  if (rb)
    v = make_float4(rt_bf16_if<true>(v.x), rt_bf16_if<true>(v.y), rt_bf16_if<true>(v.z),
                    rt_bf16_if<true>(v.w));
  return v;
}

// The same loads where the launch's inputs are all fp32 (!ANY16): no branch
// on the type, so the loads issue back to back.
template <bool ANY16>
__device__ __forceinline__ float rt_ldt(const void* __restrict__ p, long long i, bool is16,
                                        bool rb) {
  if (ANY16) return rt_ldt(p, i, is16, rb);
  const float v = static_cast<const float*>(p)[i];
  return rb ? rt_bf16_if<true>(v) : v;
}
template <bool ANY16>
__device__ __forceinline__ float4 rt_ld4t(const void* __restrict__ p, int o, bool is16, bool rb) {
  return rt_ld4t(p, o, ANY16 && is16, rb);
}

// A store of one value or four (from element o) in the output type: bf16
// (rounded) where OUT16, else fp32.
template <bool OUT16>
__device__ __forceinline__ void rt_stt(void* __restrict__ p, long long i, float v) {
  if (OUT16) rt_st(static_cast<__nv_bfloat16*>(p), i, v);
  else static_cast<float*>(p)[i] = v;
}
template <bool OUT16>
__device__ __forceinline__ void rt_st4t(void* __restrict__ p, int o, float4 v) {
  if (OUT16) {
    const __nv_bfloat162 lo = __halves2bfloat162(__float2bfloat16_rn(v.x),
                                                 __float2bfloat16_rn(v.y));
    const __nv_bfloat162 hi = __halves2bfloat162(__float2bfloat16_rn(v.z),
                                                 __float2bfloat16_rn(v.w));
    *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(p) + o) =
        make_uint2(*reinterpret_cast<const unsigned*>(&lo),
                   *reinterpret_cast<const unsigned*>(&hi));
  } else {
    *reinterpret_cast<float4*>(static_cast<float*>(p) + o) = v;
  }
}

// The block's partial row from its threads' r_new^2: plain, or (hi, lo)
// pairs where COMP (a row of 2 x 24 floats).
template <bool COMP>
__device__ __forceinline__ void rt_cg_partials(const float (&sq)[RT_SPINOR],
                                               float* __restrict__ partials) {
  if (COMP) rt_block_partials_comp<RT_SPINOR>(sq, partials + (long long)blockIdx.x * 2 * RT_SPINOR);
  else rt_block_partials<RT_SPINOR>(sq, RT_OP_SUM, partials + (long long)blockIdx.x * RT_SPINOR);
}

// The policy instance's one-thread-a-site path (any layouts, any vvl).
template <int K, bool OUT16, bool COMP>
__global__ void cg_update_policy_kernel(const void* __restrict__ x, const void* __restrict__ r,
                                        const void* __restrict__ p, const void* __restrict__ ap,
                                        const float* __restrict__ alpha,
                                        const float* __restrict__ neg_alpha,
                                        void* __restrict__ x_new, void* __restrict__ r_new,
                                        float* __restrict__ partials, long long nsites,
                                        rt_cg_layouts L, unsigned in16, bool rb) {
  const long long s = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const bool live = s < nsites;
  const float a = alpha[0];
  const float na = neg_alpha[0];
  float sq[RT_SPINOR];
#pragma unroll
  for (int c = 0; c < RT_SPINOR; ++c) {
    sq[c] = 0.0f;
    if (live) {
      const float xn = rt_xpay(rt_ldt(x, rt_at<K>(L.x, c, s, RT_SPINOR, nsites), in16 & 1u, rb),
                               a, rt_ldt(p, rt_at<K>(L.p, c, s, RT_SPINOR, nsites), in16 & 4u, rb));
      const float rn = rt_xpay(rt_ldt(r, rt_at<K>(L.r, c, s, RT_SPINOR, nsites), in16 & 2u, rb),
                               na, rt_ldt(ap, rt_at<K>(L.ap, c, s, RT_SPINOR, nsites), in16 & 8u, rb));
      rt_stt<OUT16>(x_new, rt_at<K>(L.x_new, c, s, RT_SPINOR, nsites), xn);
      rt_stt<OUT16>(r_new, rt_at<K>(L.r_new, c, s, RT_SPINOR, nsites), rn);
      sq[c] = rn * rn;
    }
  }
  rt_cg_partials<COMP>(sq, partials);
}

// The compensated partial row of a block's (24, vvl) table of r_new^2 (row
// stride S, n live sites): thread t folds component t % 24 over the sites
// t / 24, t / 24 + G, ... in order as a (hi, lo) pair (G = blockDim.x / 24
// threads a component), then thread c combines its component's G pairs in
// order.  One pair add an element: the tree fold of rt_block_partials_comp,
// 5 shuffled pair adds a component a thread, costs ~1,400 instructions a
// site and held this path at 1.36x the policy-free kernel's time (H100 80GB
// HBM3, 700 W, milc_small; PERF.md).
__device__ __forceinline__ void rt_cg_table_partials_comp(const float* __restrict__ tab, int S,
                                                          int n, float* __restrict__ row) {
  __shared__ rt_pair part[RT_CG_MAX_VVL];
  const int G = blockDim.x / RT_SPINOR;
  const int t = threadIdx.x, c = t % RT_SPINOR, g = t / RT_SPINOR;
  if (g < G) {
    rt_pair acc{0.0f, 0.0f};
    for (int l = g; l < n; l += G) acc = rt_pair_add(acc, rt_pair{tab[c * S + l], 0.0f});
    part[g * RT_SPINOR + c] = acc;
  }
  __syncthreads();
  if (t < RT_SPINOR) {
    rt_pair acc = part[t];
    for (int k = 1; k < G; ++k) acc = rt_pair_add(acc, part[k * RT_SPINOR + t]);
    row[2 * t] = acc.hi;
    row[2 * t + 1] = acc.lo;
  }
}

// The policy instance's vector path: cg_update_vec_kernel's chunks and
// shared r_new^2 table (a row a component, padded to vvl + 1 against bank
// conflicts) with typed loads and stores; ANY16: some input is bf16.
template <int K, bool OUT16, bool COMP, bool ANY16>
__global__ void cg_update_policy_vec_kernel(const void* __restrict__ x, const void* __restrict__ r,
                                            const void* __restrict__ p,
                                            const void* __restrict__ ap,
                                            const float* __restrict__ alpha,
                                            const float* __restrict__ neg_alpha,
                                            void* __restrict__ x_new, void* __restrict__ r_new,
                                            float* __restrict__ partials, int nsites, rt_layout L,
                                            unsigned in16, bool rb) {
  extern __shared__ float rt_cg_sq[];
  const int shift = K == RT_K_AOSOA ? L.shift : 0;
  const int vvl = blockDim.x;
  const int S = vvl + 1;
  const int s0 = blockIdx.x * vvl;
  const int ns = min(vvl, nsites - s0);
  const float a = alpha[0];
  const float na = neg_alpha[0];
  const bool x16 = in16 & 1u, r16 = in16 & 2u, p16 = in16 & 4u, ap16 = in16 & 8u;
  const int base = K == RT_K_SOA ? s0 : s0 * RT_SPINOR;
  if (ns == vvl) {
    float4 xv[RT_CG_VECS], rv[RT_CG_VECS], pv[RT_CG_VECS], apv[RT_CG_VECS];
    int cs[RT_CG_VECS], ls[RT_CG_VECS], offs[RT_CG_VECS];
#pragma unroll
    for (int k = 0; k < RT_CG_VECS; ++k) {
      rt_cg_elem<K>(4 * (threadIdx.x + k * vvl), vvl, nsites, shift, cs[k], ls[k], offs[k]);
      const int o = base + offs[k];
      xv[k] = rt_ld4t<ANY16>(x, o, x16, rb);
      rv[k] = rt_ld4t<ANY16>(r, o, r16, rb);
      pv[k] = rt_ld4t<ANY16>(p, o, p16, rb);
      apv[k] = rt_ld4t<ANY16>(ap, o, ap16, rb);
    }
#pragma unroll
    for (int k = 0; k < RT_CG_VECS; ++k) {
      xv[k] = make_float4(rt_xpay(xv[k].x, a, pv[k].x), rt_xpay(xv[k].y, a, pv[k].y),
                          rt_xpay(xv[k].z, a, pv[k].z), rt_xpay(xv[k].w, a, pv[k].w));
      rv[k] = make_float4(rt_xpay(rv[k].x, na, apv[k].x), rt_xpay(rv[k].y, na, apv[k].y),
                          rt_xpay(rv[k].z, na, apv[k].z), rt_xpay(rv[k].w, na, apv[k].w));
      const int o = base + offs[k];
      rt_st4t<OUT16>(x_new, o, xv[k]);
      rt_st4t<OUT16>(r_new, o, rv[k]);
      const float q[4] = {rv[k].x, rv[k].y, rv[k].z, rv[k].w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        int c = cs[k], l = ls[k], off;
        if (i) rt_cg_elem<K>(4 * (threadIdx.x + k * vvl) + i, vvl, nsites, shift, c, l, off);
        rt_cg_sq[c * S + l] = q[i] * q[i];
      }
    }
  } else {
    for (int e = threadIdx.x; e < RT_SPINOR * ns; e += vvl) {
      const int c = e / ns, l = e - c * ns;
      const int xi = rt_at<K, int>(L, c, s0 + l, RT_SPINOR, nsites);
      const float xn = rt_xpay(rt_ldt<ANY16>(x, xi, x16, rb), a, rt_ldt<ANY16>(p, xi, p16, rb));
      const float rn = rt_xpay(rt_ldt<ANY16>(r, xi, r16, rb), na,
                               rt_ldt<ANY16>(ap, xi, ap16, rb));
      rt_stt<OUT16>(x_new, xi, xn);
      rt_stt<OUT16>(r_new, xi, rn);
      rt_cg_sq[c * S + l] = rn * rn;
    }
  }
  __syncthreads();
  if (COMP) {
    rt_cg_table_partials_comp(rt_cg_sq, S, ns, partials + (long long)blockIdx.x * 2 * RT_SPINOR);
    return;
  }
  float sq[RT_SPINOR];
#pragma unroll
  for (int c = 0; c < RT_SPINOR; ++c)
    sq[c] = (int)threadIdx.x < ns ? rt_cg_sq[c * S + threadIdx.x] : 0.0f;
  rt_block_partials<RT_SPINOR>(sq, RT_OP_SUM, partials + (long long)blockIdx.x * RT_SPINOR);
}

// Whether p is aligned for the vector path's runs of an operand: 16 bytes
// (four fp32) or 8 (four bf16).
static inline bool rt_aligned_t(const void* p, bool is16) {
  return (reinterpret_cast<unsigned long long>(p) & (is16 ? 7ull : 15ull)) == 0;
}

template <bool OUT16, bool COMP>
static int rt_cg_update_policy_launch(const void* x, const void* r, const void* p,
                                      const void* ap, const float* alpha,
                                      const float* neg_alpha, void* x_new, void* r_new,
                                      float* partials, long long nsites, unsigned in16, bool rb,
                                      const int* desc, int block, cudaStream_t stream) {
  rt_layout L[6];
  for (int k = 0; k < 6; ++k) L[k] = rt_make_layout(desc[k]);
  const int k = rt_launch_class(L, 6);
  if (k < 0) return RT_BAD_LAYOUT;
  if (nsites == 0) return 0;
  const rt_cg_layouts cl{L[0], L[1], L[2], L[3], L[4], L[5]};
  bool vec = k != RT_K_ANY && block % 32 == 0 && block <= RT_CG_MAX_VVL &&
             block % L[0].sal == 0 && RT_SPINOR * nsites < (1LL << 31) &&
             (k != RT_K_SOA || nsites % 4 == 0);
  const void* ins[4] = {x, r, p, ap};
  for (int i = 0; i < 4; ++i) vec = vec && rt_aligned_t(ins[i], in16 & (1u << i));
  vec = vec && rt_aligned_t(x_new, OUT16) && rt_aligned_t(r_new, OUT16);
  if (vec) {
    const size_t smem = sizeof(float) * RT_SPINOR * (block + 1);
    const unsigned grid = rt_grid(nsites, block);
#define RT_CG_POL_VEC(KK, A16)                                                                 \
  cg_update_policy_vec_kernel<KK, OUT16, COMP, A16><<<grid, block, smem, stream>>>(            \
      x, r, p, ap, alpha, neg_alpha, x_new, r_new, partials, (int)nsites, L[0], in16, rb)
    if (in16) {
      if (k == RT_K_SOA) RT_CG_POL_VEC(RT_K_SOA, true);
      else if (k == RT_K_AOS) RT_CG_POL_VEC(RT_K_AOS, true);
      else RT_CG_POL_VEC(RT_K_AOSOA, true);
    } else {
      if (k == RT_K_SOA) RT_CG_POL_VEC(RT_K_SOA, false);
      else if (k == RT_K_AOS) RT_CG_POL_VEC(RT_K_AOS, false);
      else RT_CG_POL_VEC(RT_K_AOSOA, false);
    }
#undef RT_CG_POL_VEC
    RT_LAUNCH_RESULT();
  }
  RT_WITH_CLASS(k, cg_update_policy_kernel<RT_K, OUT16, COMP><<<rt_grid(nsites, block), block, 0,
                                                                stream>>>(
                       x, r, p, ap, alpha, neg_alpha, x_new, r_new, partials, nsites, cl, in16,
                       rb))
  RT_LAUNCH_RESULT();
}

// cg_xpay's vector path (see the header); the slot is blockIdx.y, sx, sy:
// per-slot element offsets of x and y (0 for a shared one), out one field
// of n elements a slot.  A frozen slot reads no x.
template <bool MASKED>
__global__ void __launch_bounds__(RT_XPAY_THREADS)
    cg_xpay_vec_kernel(const float* __restrict__ x, const float* __restrict__ y,
                       const float* __restrict__ a, const float* __restrict__ m,
                       float* __restrict__ out, int n, long long sx, long long sy) {
  const long long b = blockIdx.y;
  x += b * sx;
  y += b * sy;
  out += b * (long long)n;
  const bool on = !MASKED || m[b] > 0.0f;
  const float av = a[b];
  const int nv = n >> 2;
  const int v0 = blockIdx.x * (RT_XPAY_THREADS * RT_XPAY_VECS) + threadIdx.x;
  float4 xr[RT_XPAY_VECS], yr[RT_XPAY_VECS];
#pragma unroll
  for (int k = 0; k < RT_XPAY_VECS; ++k) {
    const int v = v0 + k * RT_XPAY_THREADS;
    if (v < nv) {
      yr[k] = __ldg(reinterpret_cast<const float4*>(y) + v);
      if (on) xr[k] = __ldg(reinterpret_cast<const float4*>(x) + v);
    }
  }
#pragma unroll
  for (int k = 0; k < RT_XPAY_VECS; ++k) {
    const int v = v0 + k * RT_XPAY_THREADS;
    if (v >= nv) continue;
    reinterpret_cast<float4*>(out)[v] =
        on ? make_float4(rt_xpay(yr[k].x, av, xr[k].x), rt_xpay(yr[k].y, av, xr[k].y),
                         rt_xpay(yr[k].z, av, xr[k].z), rt_xpay(yr[k].w, av, xr[k].w))
           : yr[k];
  }
  if (blockIdx.x == gridDim.x - 1) {   // the elements after the last whole vector
    const int e = 4 * nv + threadIdx.x;
    if (e < n) out[e] = on ? rt_xpay(y[e], av, x[e]) : y[e];
  }
}

// The general path.  MIXED: the three operands' layouts differ.  sx, sy:
// per-slot element offsets of x and y (0 for a shared one).
template <bool MIXED, bool MASKED>
__global__ void cg_xpay_kernel(const float* __restrict__ x, const float* __restrict__ y,
                               const float* __restrict__ a, const float* __restrict__ m,
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
  const bool on = !MASKED || m[b] > 0.0f;
  if (!MIXED) {
    out[i] = on ? rt_xpay(y[i], a[b], x[i]) : y[i];
    return;
  }
  int c;
  long long s;
  rt_coords(lo, i, ncomp, nsites, c, s);
  const float yv = y[rt_index(ly, c, s, ncomp, nsites)];
  out[i] = on ? rt_xpay(yv, a[b], x[rt_index(lx, c, s, ncomp, nsites)]) : yv;
}

template <typename TAP>
static int rt_cg_update_launch(const float* x, const float* r, const float* p, const TAP* ap,
                               const float* alpha, const float* neg_alpha, const float* m,
                               float* x_new, float* r_new, float* partials, long long nsites,
                               int batch, const int* desc, rt_cg_strides S, int block,
                               cudaStream_t stream) {
  rt_layout L[6];
  for (int k = 0; k < 6; ++k) L[k] = rt_make_layout(desc[k]);
  const int k = rt_launch_class(L, 6);
  if (k < 0) return RT_BAD_LAYOUT;
  if (nsites == 0 || batch == 0) return 0;
  const rt_cg_layouts cl{L[0], L[1], L[2], L[3], L[4], L[5]};
  const dim3 grid(rt_grid(nsites, block), batch);
  const void* ptrs[5] = {x, r, p, x_new, r_new};
  bool vec = k != RT_K_ANY && block % 32 == 0 && block <= RT_CG_MAX_VVL &&
             block % L[0].sal == 0 && RT_SPINOR * nsites < (1LL << 31) &&
             (k != RT_K_SOA || nsites % 4 == 0) && S.x % 4 == 0 && S.r % 4 == 0 &&
             S.p % 4 == 0 && S.ap % 4 == 0 &&
             (reinterpret_cast<unsigned long long>(ap) & (4 * sizeof(TAP) - 1)) == 0;
  for (int i = 0; i < 5; ++i) vec = vec && rt_aligned(ptrs[i]);
  if (vec) {
    const size_t smem = sizeof(float) * RT_SPINOR * block;
#define RT_CG_VEC(KK, MASKED)                                                                    \
  cg_update_vec_kernel<KK, MASKED, TAP><<<grid, block, smem, stream>>>(                          \
      x, r, p, ap, alpha, neg_alpha, m, x_new, r_new, partials, (int)nsites, L[0], S)
    if (m) {
      if (k == RT_K_SOA) RT_CG_VEC(RT_K_SOA, true);
      else if (k == RT_K_AOS) RT_CG_VEC(RT_K_AOS, true);
      else RT_CG_VEC(RT_K_AOSOA, true);
    } else {
      if (k == RT_K_SOA) RT_CG_VEC(RT_K_SOA, false);
      else if (k == RT_K_AOS) RT_CG_VEC(RT_K_AOS, false);
      else RT_CG_VEC(RT_K_AOSOA, false);
    }
#undef RT_CG_VEC
    RT_LAUNCH_RESULT();
  }
  if (m)
    RT_WITH_CLASS(k, cg_update_kernel<RT_K, true, TAP><<<grid, block, 0, stream>>>(
                         x, r, p, ap, alpha, neg_alpha, m, x_new, r_new, partials, nsites, cl, S))
  else
    RT_WITH_CLASS(k, cg_update_kernel<RT_K, false, TAP><<<grid, block, 0, stream>>>(
                         x, r, p, ap, alpha, neg_alpha, m, x_new, r_new, partials, nsites, cl, S))
  RT_LAUNCH_RESULT();
}

// x rounded to bf16 and widened back, elementwise: the stage-in of the
// policy instances (rt_bf16_if, bf16.cuh) as a kernel of its own, so that the
// card tests can hold the rounding itself bitwise to torch's (ties, -0.0,
// infinities, NaN, subnormals).
__global__ void bf16_round_kernel(const float* __restrict__ x, float* __restrict__ out,
                                  long long n) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i < n) out[i] = rt_bf16_if<true>(x[i]);
}

// x rounded to bf16 and stored as bf16 with the same rounding: the copy of
// the gauge field that K5's policy instance reads (made once per operator,
// apps/milc/cg.py::make_fused_normal), in place of rounding u at every load.
// VEC: a float4 in and four bf16 (8 bytes) out a thread, the elements after
// the last whole vector by the thread after it; else one element a thread
// (a misaligned operand).
template <bool VEC>
__global__ void bf16_pack_kernel(const float* __restrict__ x, __nv_bfloat16* __restrict__ out,
                                 long long n) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (!VEC) {
    if (i < n) rt_st(out, i, x[i]);
    return;
  }
  const long long nv = n >> 2;
  if (i < nv) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(x) + i);
    const __nv_bfloat162 lo = __halves2bfloat162(__float2bfloat16_rn(f.x),
                                                 __float2bfloat16_rn(f.y));
    const __nv_bfloat162 hi = __halves2bfloat162(__float2bfloat16_rn(f.z),
                                                 __float2bfloat16_rn(f.w));
    reinterpret_cast<uint2*>(out)[i] = make_uint2(*reinterpret_cast<const unsigned*>(&lo),
                                                  *reinterpret_cast<const unsigned*>(&hi));
  } else if (i == nv) {
    for (long long e = 4 * nv; e < n; ++e) rt_st(out, e, x[e]);
  }
}

static int rt_xpay_launch(const float* x, const float* y, const float* a, const float* m,
                          float* out, int ncomp, long long nsites, int batch, long long sx,
                          long long sy, int lx, int ly, int lo, int block, cudaStream_t stream) {
  const long long n = (long long)ncomp * nsites;
  const rt_layout L[3] = {rt_make_layout(lx), rt_make_layout(ly), rt_make_layout(lo)};
  if (rt_launch_class(L, 3) < 0) return RT_BAD_LAYOUT;
  if (n == 0 || batch == 0) return 0;
  const bool mixed = !(rt_same_layout(L[0], L[2]) && rt_same_layout(L[1], L[2]));
  if (!mixed && rt_aligned(x) && rt_aligned(y) && rt_aligned(out) && sx % 4 == 0 &&
      sy % 4 == 0 && (batch == 1 || n % 4 == 0) && n < (1LL << 31) - 4 * RT_XPAY_THREADS) {
    const long long per = RT_XPAY_THREADS * RT_XPAY_VECS * 4;
    const dim3 vgrid((unsigned)((n + per - 1) / per), batch);
    if (m)
      cg_xpay_vec_kernel<true><<<vgrid, RT_XPAY_THREADS, 0, stream>>>(x, y, a, m, out, (int)n,
                                                                      sx, sy);
    else
      cg_xpay_vec_kernel<false><<<vgrid, RT_XPAY_THREADS, 0, stream>>>(x, y, a, m, out, (int)n,
                                                                       sx, sy);
    RT_LAUNCH_RESULT();
  }
  const dim3 grid(rt_grid(n, block), batch);
#define RT_XPAY(MIXED, MASKED)                                                                 \
  cg_xpay_kernel<MIXED, MASKED><<<grid, block, 0, stream>>>(x, y, a, m, out, ncomp, nsites, L[0], \
                                                            L[1], L[2], sx, sy)
  if (mixed) {
    if (m) RT_XPAY(true, true); else RT_XPAY(true, false);
  } else {
    if (m) RT_XPAY(false, true); else RT_XPAY(false, false);
  }
#undef RT_XPAY
  RT_LAUNCH_RESULT();
}

extern "C" {

// K3's policy instance.  x, r, p, ap: fp32 or bf16 (bit 0 ... 3 of in16)
// 24 x nsites fields; rb: round fp32 inputs to bf16 at load; out16: x_new,
// r_new in bf16 (else fp32); comp: partials (ceil(nsites / block), 24, 2)
// (hi, lo) pairs (else (ceil(nsites / block), 24)); layouts and scalars as
// rt_cg_update's.
int rt_cg_update_policy(const void* x, const void* r, const void* p, const void* ap,
                        const float* alpha, const float* neg_alpha, void* x_new, void* r_new,
                        float* partials, long long nsites, int in16, int rb, int out16, int comp,
                        int lx, int lr, int lp, int lap, int lxn, int lrn, int block,
                        cudaStream_t stream) {
  const int desc[6] = {lx, lr, lp, lap, lxn, lrn};
#define RT_CG_POL(O16, C)                                                                      \
  return rt_cg_update_policy_launch<O16, C>(x, r, p, ap, alpha, neg_alpha, x_new, r_new,     \
                                            partials, nsites, (unsigned)in16, rb != 0, desc,  \
                                            block, stream)
  if (out16) {
    if (comp) RT_CG_POL(true, true);
    RT_CG_POL(true, false);
  }
  if (comp) RT_CG_POL(false, true);
  RT_CG_POL(false, false);
#undef RT_CG_POL
}

// x, r, p, ap, x_new, r_new: 24 x nsites fields, each in the layout of its
// descriptor (lx ... lrn); alpha, neg_alpha: one fp32 on the device each;
// partials: (ceil(nsites / block), 24).
int rt_cg_update(const float* x, const float* r, const float* p, const float* ap,
                 const float* alpha, const float* neg_alpha, float* x_new, float* r_new,
                 float* partials, long long nsites, int lx, int lr, int lp, int lap, int lxn,
                 int lrn, int block, cudaStream_t stream) {
  const int desc[6] = {lx, lr, lp, lap, lxn, lrn};
  return rt_cg_update_launch(x, r, p, ap, alpha, neg_alpha, nullptr, x_new, r_new, partials,
                             nsites, 1, desc, rt_cg_strides{0, 0, 0, 0, 0}, block, stream);
}

// The batch instance: x, r, p, ap are batch fields one after another (or one
// shared field where its stride sx ... sap is 0), x_new and r_new batch
// fields; alpha, neg_alpha, m: (batch,) fp32 on the device; partials:
// (batch, ceil(nsites / block), 24).
int rt_cg_update_masked(const float* x, const float* r, const float* p, const float* ap,
                        const float* alpha, const float* neg_alpha, const float* m, float* x_new,
                        float* r_new, float* partials, long long nsites, int batch, long long sx,
                        long long sr, long long sp, long long sap, int lx, int lr, int lp, int lap,
                        int lxn, int lrn, int block, cudaStream_t stream) {
  const int desc[6] = {lx, lr, lp, lap, lxn, lrn};
  return rt_cg_update_launch(x, r, p, ap, alpha, neg_alpha, m, x_new, r_new, partials, nsites,
                             batch, desc, rt_cg_strides{sx, sr, sp, sap, 24LL * nsites}, block,
                             stream);
}

// rt_cg_update and rt_cg_update_masked with ap in bf16 (the other fields fp32).
int rt_cg_update_ap16(const float* x, const float* r, const float* p, const __nv_bfloat16* ap,
                      const float* alpha, const float* neg_alpha, float* x_new, float* r_new,
                      float* partials, long long nsites, int lx, int lr, int lp, int lap, int lxn,
                      int lrn, int block, cudaStream_t stream) {
  const int desc[6] = {lx, lr, lp, lap, lxn, lrn};
  return rt_cg_update_launch(x, r, p, ap, alpha, neg_alpha, nullptr, x_new, r_new, partials,
                             nsites, 1, desc, rt_cg_strides{0, 0, 0, 0, 0}, block, stream);
}

int rt_cg_update_masked_ap16(const float* x, const float* r, const float* p,
                             const __nv_bfloat16* ap, const float* alpha,
                             const float* neg_alpha, const float* m, float* x_new, float* r_new,
                             float* partials, long long nsites, int batch, long long sx,
                             long long sr, long long sp, long long sap, int lx, int lr, int lp,
                             int lap, int lxn, int lrn, int block, cudaStream_t stream) {
  const int desc[6] = {lx, lr, lp, lap, lxn, lrn};
  return rt_cg_update_launch(x, r, p, ap, alpha, neg_alpha, m, x_new, r_new, partials, nsites,
                             batch, desc, rt_cg_strides{sx, sr, sp, sap, 24LL * nsites}, block,
                             stream);
}

// x, out: n fp32 values.
int rt_bf16_round(const float* x, float* out, long long n, int block, cudaStream_t stream) {
  if (n == 0) return 0;
  bf16_round_kernel<<<rt_grid(n, block), block, 0, stream>>>(x, out, n);
  RT_LAUNCH_RESULT();
}

// x: n fp32 values; out: n bf16.
int rt_bf16_pack(const float* x, __nv_bfloat16* out, long long n, int block,
                 cudaStream_t stream) {
  if (n == 0) return 0;
  const long long threads = n / 4 + 1;   // a vector a thread, and one for the tail
  if (rt_aligned(x) && (reinterpret_cast<unsigned long long>(out) & 7ull) == 0)
    bf16_pack_kernel<true><<<rt_grid(threads, block), block, 0, stream>>>(x, out, n);
  else
    bf16_pack_kernel<false><<<rt_grid(n, block), block, 0, stream>>>(x, out, n);
  RT_LAUNCH_RESULT();
}

// x, y, out: ncomp x nsites fields in layouts lx, ly, lo; a: one fp32 on the
// device.
int rt_cg_xpay(const float* x, const float* y, const float* a, float* out, int ncomp,
               long long nsites, int lx, int ly, int lo, int block, cudaStream_t stream) {
  return rt_xpay_launch(x, y, a, nullptr, out, ncomp, nsites, 1, 0, 0, lx, ly, lo, block, stream);
}

// The batch instance: x, y batch fields (or shared where sx, sy is 0), out
// batch fields; a, m: (batch,) fp32 on the device.
int rt_cg_xpay_masked(const float* x, const float* y, const float* a, const float* m, float* out,
                      int ncomp, long long nsites, int batch, long long sx, long long sy, int lx,
                      int ly, int lo, int block, cudaStream_t stream) {
  return rt_xpay_launch(x, y, a, m, out, ncomp, nsites, batch, sx, sy, lx, ly, lo, block, stream);
}

}  // extern "C"
