// K3L and K1L: the site-local liquid-crystal kernels of the Ludwig step.
//
// K3L replaces core/fuse.py::LaunchGraph._build_flat (fused_kernel :1411,
// pallas_call :1447) for the two flat graphs of apps/ludwig/driver.py:
//
//   rt_ludwig_chem_stress  ludwig_chem_stress: h = molecular_field(q, lapq),
//                          sigma = stress(q, h, dq); writes h and sigma.
//   rt_ludwig_lc_update    ludwig_lc_update: rhs = beris_edwards_rhs(q, h, w),
//                          q_new = q_update(q, rhs, adv); rhs stays in
//                          registers.
//
// K1L replaces core/target.py::TargetKernel._run_pallas (pallas_call :398)
// for diagnostics' free-energy body:
//
//   rt_ludwig_fed          fed = free_energy_density(q, dq), one value a site,
//                          folded by reduce.cu's two passes.
//
// K3C replaces the same _build_flat fused_kernel for the benchmarks' third
// flat graph, ludwig_lc_chain (the paper's Fig. 3 fused LC chain):
//
//   rt_ludwig_lc_chain     h = molecular_field(q, lapq), rhs =
//                          beris_edwards_rhs(q, h, w), q_new = q_update(q,
//                          rhs, adv); h and rhs stay in registers.  It is
//                          the K3L pair's device functions in one kernel:
//                          the rhs reads h's 5 stored components, as the
//                          graph's rhs stage reads the h value the first
//                          stage produced.  Once inlined, nvcc may contract
//                          h's last multiply into the rhs's first add, so
//                          q_new is held to its plain version within a
//                          tolerance; whether it is bitwise the K3L pair's
//                          composition is measured on the card (PERF.md).
//
// K3L's policy instances (rt_ludwig_chem_stress_policy,
// rt_ludwig_lc_update_policy) are the same two kernels with POL set: the
// ludwig_chem_stress and ludwig_lc_update graphs under a DtypePolicy
// (_build_flat under _stage_in_cast :349, output dtypes :960-985), and
// under the policy-free launch whose inputs are not all fp32.  Each input
// is fp32 or bf16 (bit k of in16, in argument order); a bf16 input is
// widened as it is loaded (exactly), an fp32 one rounded to bf16 first
// where rb is set (the policy's bf16 storage: __float2bfloat16_rn, torch's
// .to(bfloat16)), so a bf16 input is read as it comes, the round being the
// identity on it; a launch whose inputs are all fp32 (the sweep's twin, a
// tuned step's launches) takes an instance with no type branch on its
// loads.  The arithmetic is the fp32 device functions below,
// unchanged; OUT16 writes the fields in bf16 (one rounding of the fp32
// result), and the stress reads h's fp32 values, as the reference's stress
// stage reads the compute-dtype h.  With POL off the loads and stores are
// the fp32 ones, so the policy-free kernels compile as before.  Bound:
// bytes; fp32 in and bf16 out, chem_stress 100 + 28 = 128 B a site (156
// policy-free), lc_update 96 + 10 = 106 B (116).
//
// No flat graph has a terminal reduction, so each is one launch, one
// thread per site, fields only.  Every tensor comes with its own layout
// descriptor (SoA, AoS or AoSoA) and is loaded and stored through INDEX
// (rt_load_q, rt_store_q5 and rt_at, common.cuh), so one launch may mix
// layouts: the driver's temporaries fall back to SoA where an AoSoA SAL
// does not divide the lattice.  The arithmetic is the same in every
// layout, so the outputs are bitwise the SoA launch's, repacked.  Each
// kernel is instantiated for each layout class (common.cuh); the all-SoA
// one is SoA's addresses alone.  The Q
// tensor arrives as 5 components (XX, XY, XZ, YY, YZ; ZZ = -XX - YY) and
// the 3x3 algebra of
// apps/ludwig/lc.py is unrolled in registers in the reference's order of
// operations; every Python-float coefficient of the reference is computed in
// double by the host and passed as fp32.  nvcc contracts a*b + c into fused
// multiply-adds, so the results agree with the plain versions to a
// tolerance, not bitwise.
//
// Bound on the H100: bytes.  Compulsory traffic a site: chem_stress reads
// 5 + 5 + 15 and writes 5 + 9 values (156 B) for about 600 flops;
// lc_update reads 5 + 5 + 9 + 5 and writes 5 (116 B) for about 320 flops;
// lc_chain reads q, lapq, w, adv (5 + 5 + 9 + 5) and writes 5 (116 B: 0.581
// ms at (256, 256, 256) on 3.35 TB/s) for about 440 flops;
// fed reads 5 + 15 and writes 1 (84 B) for about 160 flops.  The heaviest,
// chem_stress, is under 4 flop/byte, far below the ~20 flop/byte fp32
// ridge.
// The stress needs Q, H, Q + I/3, three 3x3 products and the three 3x3
// gradient matrices at once; built with -Xptxas -v for sm_90a (CUDA 12.8)
// the kernels use 40 (chem_stress), 40 (lc_update) and 32 (fed) registers,
// with no spills, so registers do not limit occupancy at 128 threads a
// block.

#include "bf16.cuh"

struct rt_m3 {
  float m[3][3];
};

__device__ __forceinline__ rt_m3 rt_q5_to_mat(float q0, float q1, float q2, float q3, float q4) {
  const float qzz = -q0 - q3;
  return rt_m3{{{q0, q1, q2}, {q1, q3, q4}, {q2, q4, qzz}}};
}

// The 5 components comp0 ... comp0 + 4 of site s of a field of ncomp
// components in layout L, as the symmetric traceless 3x3 matrix.
template <int K>
__device__ __forceinline__ rt_m3 rt_load_q(const float* __restrict__ x, const rt_layout& L,
                                           int ncomp, long long V, long long s, int comp0) {
  float q[5];
#pragma unroll
  for (int c = 0; c < 5; ++c) q[c] = x[rt_at<K>(L, comp0 + c, s, ncomp, V)];
  return rt_q5_to_mat(q[0], q[1], q[2], q[3], q[4]);
}

// The 5 stored components of a into site s of a 5-component field.
template <int K>
__device__ __forceinline__ void rt_store_q5(float* __restrict__ x, const rt_layout& L,
                                            long long V, long long s, const rt_m3& a) {
  x[rt_at<K>(L, 0, s, 5, V)] = a.m[0][0];
  x[rt_at<K>(L, 1, s, 5, V)] = a.m[0][1];
  x[rt_at<K>(L, 2, s, 5, V)] = a.m[0][2];
  x[rt_at<K>(L, 3, s, 5, V)] = a.m[1][1];
  x[rt_at<K>(L, 4, s, 5, V)] = a.m[1][2];
}

// Value i of an input: fp32 where !POL; else fp32 or bf16 (is16, looked at
// only where the launch has a bf16 input: ANY16), a bf16 one widened and an
// fp32 one rounded to bf16 first where rb.
template <bool POL, bool ANY16>
__device__ __forceinline__ float rt_lc_ld(const void* __restrict__ x, long long i, bool is16,
                                          bool rb) {
  if (POL && ANY16 && is16) return __bfloat162float(static_cast<const __nv_bfloat16*>(x)[i]);
  const float v = static_cast<const float*>(x)[i];
  return POL && rb ? rt_bf16_if<true>(v) : v;
}

// A store in the output type: bf16 (rounded) where OUT16, else fp32.
template <bool OUT16>
__device__ __forceinline__ void rt_lc_st(void* __restrict__ x, long long i, float v) {
  if (OUT16) rt_st(static_cast<__nv_bfloat16*>(x), i, v);
  else static_cast<float*>(x)[i] = v;
}

// rt_load_q and rt_store_q5 through rt_lc_ld and rt_lc_st.
template <int K, bool POL, bool ANY16>
__device__ __forceinline__ rt_m3 rt_load_qt(const void* __restrict__ x, const rt_layout& L,
                                            int ncomp, long long V, long long s, int comp0,
                                            bool is16, bool rb) {
  float q[5];
#pragma unroll
  for (int c = 0; c < 5; ++c)
    q[c] = rt_lc_ld<POL, ANY16>(x, rt_at<K>(L, comp0 + c, s, ncomp, V), is16, rb);
  return rt_q5_to_mat(q[0], q[1], q[2], q[3], q[4]);
}

template <int K, bool OUT16>
__device__ __forceinline__ void rt_store_q5t(void* __restrict__ x, const rt_layout& L,
                                             long long V, long long s, const rt_m3& a) {
  rt_lc_st<OUT16>(x, rt_at<K>(L, 0, s, 5, V), a.m[0][0]);
  rt_lc_st<OUT16>(x, rt_at<K>(L, 1, s, 5, V), a.m[0][1]);
  rt_lc_st<OUT16>(x, rt_at<K>(L, 2, s, 5, V), a.m[0][2]);
  rt_lc_st<OUT16>(x, rt_at<K>(L, 3, s, 5, V), a.m[1][1]);
  rt_lc_st<OUT16>(x, rt_at<K>(L, 4, s, 5, V), a.m[1][2]);
}

// sum(a[i][k] * b[k][j] for k in range(3)), as Python's sum adds them.
__device__ __forceinline__ rt_m3 rt_mul(const rt_m3& a, const rt_m3& b) {
  rt_m3 o;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      o.m[i][j] = a.m[i][0] * b.m[0][j] + a.m[i][1] * b.m[1][j] + a.m[i][2] * b.m[2][j];
  return o;
}

__device__ __forceinline__ rt_m3 rt_add(const rt_m3& a, const rt_m3& b) {
  rt_m3 o;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) o.m[i][j] = a.m[i][j] + b.m[i][j];
  return o;
}

__device__ __forceinline__ rt_m3 rt_sub(const rt_m3& a, const rt_m3& b) {
  rt_m3 o;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) o.m[i][j] = a.m[i][j] - b.m[i][j];
  return o;
}

__device__ __forceinline__ rt_m3 rt_scale(const rt_m3& a, float s) {
  rt_m3 o;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) o.m[i][j] = a.m[i][j] * s;
  return o;
}

__device__ __forceinline__ float rt_trace(const rt_m3& a) {
  return a.m[0][0] + a.m[1][1] + a.m[2][2];
}

__device__ __forceinline__ rt_m3 rt_transpose(const rt_m3& a) {
  rt_m3 o;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) o.m[i][j] = a.m[j][i];
  return o;
}

__device__ __forceinline__ rt_m3 rt_add_diag(rt_m3 a, float s) {
#pragma unroll
  for (int i = 0; i < 3; ++i) a.m[i][i] = a.m[i][i] + s;
  return a;
}

// Symmetric traceless projection (lc.traceless_sym).
__device__ __forceinline__ rt_m3 rt_traceless_sym(const rt_m3& a) {
  rt_m3 sym;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) sym.m[i][j] = 0.5f * (a.m[i][j] + a.m[j][i]);
  const float tr3 = rt_trace(sym) / 3.0f;
  return rt_add_diag(sym, -tr3);
}

// Coefficients of lc.molecular_field_chunk, host-computed:
// c_q = -a0 (1 - gamma/3), c_b = a0 gamma, c_t = -a0 gamma, kappa.
struct rt_mol_params {
  float c_q, c_b, c_t, kappa;
};

__device__ __forceinline__ rt_m3 rt_molecular_field(const rt_m3& Q, const rt_m3& lapQ,
                                                    const rt_mol_params& p) {
  const rt_m3 QQ = rt_mul(Q, Q);
  const float trQ2 = rt_trace(QQ);
  const rt_m3 bulk2 = rt_add_diag(QQ, -trQ2 / 3.0f);
  rt_m3 H = rt_add(rt_scale(Q, p.c_q), rt_scale(bulk2, p.c_b));
  H = rt_add(H, rt_scale(Q, p.c_t * trQ2));
  H = rt_add(H, rt_scale(lapQ, p.kappa));
  return rt_traceless_sym(H);
}

// Coefficients of lc.stress_chunk: neg_xi = -xi, two_xi = 2 xi, kappa (p0 = 0).
struct rt_stress_params {
  float neg_xi, two_xi, kappa;
};

// sigma_ab row-major into sig[9] (lc.stress_chunk).
__device__ __forceinline__ void rt_stress(const rt_m3& Q, const rt_m3& H, const rt_m3 (&dQ)[3],
                                          const rt_stress_params& p, float (&sig)[9]) {
  const rt_m3 Qi = rt_add_diag(Q, (float)(1.0 / 3.0));
  const float trQH = rt_trace(rt_mul(Q, H));
  rt_m3 s = rt_scale(rt_add(rt_mul(H, Qi), rt_mul(Qi, H)), p.neg_xi);
  s = rt_add(s, rt_scale(Qi, p.two_xi * trQH));
  s = rt_add(s, rt_sub(rt_mul(Q, H), rt_mul(H, Q)));
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      float grad2 = 0.0f;
#pragma unroll
      for (int g = 0; g < 3; ++g)
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          const float t = dQ[a].m[g][d] * dQ[b].m[g][d];
          grad2 = (g == 0 && d == 0) ? t : grad2 + t;
        }
      sig[a * 3 + b] = s.m[a][b] - p.kappa * grad2;
    }
}

// Coefficients of lc.beris_edwards_rhs_chunk and lc.q_update_chunk.
struct rt_update_params {
  float gamma_rot, xi, neg_two_xi, dt;
};

__device__ __forceinline__ rt_m3 rt_beris_edwards_rhs(const rt_m3& Q, const rt_m3& H,
                                                      const rt_m3& W,
                                                      const rt_update_params& p) {
  const rt_m3 Wt = rt_transpose(W);
  const rt_m3 D = rt_scale(rt_add(W, Wt), 0.5f);
  const rt_m3 Om = rt_scale(rt_sub(W, Wt), 0.5f);
  const rt_m3 Qi = rt_add_diag(Q, (float)(1.0 / 3.0));
  const rt_m3 t1 = rt_mul(rt_add(rt_scale(D, p.xi), Om), Qi);
  const rt_m3 t2 = rt_mul(Qi, rt_sub(rt_scale(D, p.xi), Om));
  const float trQW = rt_trace(rt_mul(Q, W));
  const rt_m3 t3 = rt_scale(Qi, p.neg_two_xi * trQW);
  const rt_m3 S = rt_add(rt_add(t1, t2), t3);
  return rt_traceless_sym(rt_add(rt_scale(H, p.gamma_rot), S));
}

// Coefficients of lc.free_energy_density_chunk: c1 = 0.5 a0 (1 - gamma/3),
// c2 = a0 gamma / 3, c3 = 0.25 a0 gamma, half_kappa = 0.5 kappa.
struct rt_fed_params {
  float c1, c2, c3, half_kappa;
};

// Layouts of a launch's tensors, in argument order (a launch uses the
// first three or all five).
struct rt_lc_layouts {
  rt_layout a, b, c, d, e;
};

// q, lapq, dq -> h, sigma: layouts a ... e.  POL, OUT16, ANY16, in16 (q
// 1, lapq 2, dq 4) and rb: the policy instance (see the header).
template <int K, bool POL = false, bool OUT16 = false, bool ANY16 = false>
__global__ void ludwig_chem_stress_kernel(const void* __restrict__ q,
                                          const void* __restrict__ lapq,
                                          const void* __restrict__ dq, void* __restrict__ h,
                                          void* __restrict__ sigma, long long V,
                                          rt_mol_params mp, rt_stress_params sp,
                                          rt_lc_layouts L, unsigned in16, bool rb) {
  const long long s = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (s >= V) return;
  const bool q16 = in16 & 1u, lap16 = in16 & 2u, dq16 = in16 & 4u;
  const rt_m3 Q = rt_load_qt<K, POL, ANY16>(q, L.a, 5, V, s, 0, q16, rb);
  const rt_m3 H =
      rt_molecular_field(Q, rt_load_qt<K, POL, ANY16>(lapq, L.b, 5, V, s, 0, lap16, rb), mp);
  rt_store_q5t<K, OUT16>(h, L.d, V, s, H);
  // the graph's stress stage reads the 5 stored components of h back
  const rt_m3 Hs = rt_q5_to_mat(H.m[0][0], H.m[0][1], H.m[0][2], H.m[1][1], H.m[1][2]);
  const rt_m3 dQ[3] = {rt_load_qt<K, POL, ANY16>(dq, L.c, 15, V, s, 0, dq16, rb),
                       rt_load_qt<K, POL, ANY16>(dq, L.c, 15, V, s, 5, dq16, rb),
                       rt_load_qt<K, POL, ANY16>(dq, L.c, 15, V, s, 10, dq16, rb)};
  float sig[9];
  rt_stress(Q, Hs, dQ, sp, sig);
#pragma unroll
  for (int c = 0; c < 9; ++c) rt_lc_st<OUT16>(sigma, rt_at<K>(L.e, c, s, 9, V), sig[c]);
}

// q, h, w, adv -> q_new: layouts a ... e.  POL, OUT16, ANY16, in16 (q 1, h
// 2, w 4, adv 8) and rb: the policy instance (see the header).
template <int K, bool POL = false, bool OUT16 = false, bool ANY16 = false>
__global__ void ludwig_lc_update_kernel(const void* __restrict__ q, const void* __restrict__ h,
                                        const void* __restrict__ w, const void* __restrict__ adv,
                                        void* __restrict__ q_new, long long V,
                                        rt_update_params p, rt_lc_layouts L, unsigned in16,
                                        bool rb) {
  const long long s = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (s >= V) return;
  const bool q16 = in16 & 1u, h16 = in16 & 2u, w16 = in16 & 4u, adv16 = in16 & 8u;
  const rt_m3 Q = rt_load_qt<K, POL, ANY16>(q, L.a, 5, V, s, 0, q16, rb);
  rt_m3 W;
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b)
      W.m[a][b] = rt_lc_ld<POL, ANY16>(w, rt_at<K>(L.c, a * 3 + b, s, 9, V), w16, rb);
  const rt_m3 rhs =
      rt_beris_edwards_rhs(Q, rt_load_qt<K, POL, ANY16>(h, L.b, 5, V, s, 0, h16, rb), W, p);
  // q0 = q5 + dt (rhs5 - adv5) on the 5 stored components, then projected
  float q0[5];
  const float r5[5] = {rhs.m[0][0], rhs.m[0][1], rhs.m[0][2], rhs.m[1][1], rhs.m[1][2]};
#pragma unroll
  for (int c = 0; c < 5; ++c)
    q0[c] = rt_lc_ld<POL, ANY16>(q, rt_at<K>(L.a, c, s, 5, V), q16, rb) +
            p.dt * (r5[c] - rt_lc_ld<POL, ANY16>(adv, rt_at<K>(L.d, c, s, 5, V), adv16, rb));
  rt_store_q5t<K, OUT16>(q_new, L.e, V, s,
                         rt_traceless_sym(rt_q5_to_mat(q0[0], q0[1], q0[2], q0[3], q0[4])));
}

// q, lapq, w, adv -> q_new: layouts a ... e (K3C).  The molecular field of
// chem_stress, then lc_update's body with the h it would have stored.
template <int K>
__global__ void ludwig_lc_chain_kernel(const float* __restrict__ q,
                                       const float* __restrict__ lapq,
                                       const float* __restrict__ w, const float* __restrict__ adv,
                                       float* __restrict__ q_new, long long V, rt_mol_params mp,
                                       rt_update_params p, rt_lc_layouts L) {
  const long long s = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (s >= V) return;
  const rt_m3 Q = rt_load_q<K>(q, L.a, 5, V, s, 0);
  const rt_m3 H = rt_molecular_field(Q, rt_load_q<K>(lapq, L.b, 5, V, s, 0), mp);
  // the rhs stage reads h's 5 components (zz = -xx - yy), as chem_stress stores them
  const rt_m3 Hs = rt_q5_to_mat(H.m[0][0], H.m[0][1], H.m[0][2], H.m[1][1], H.m[1][2]);
  rt_m3 W;
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b) W.m[a][b] = w[rt_at<K>(L.c, a * 3 + b, s, 9, V)];
  const rt_m3 rhs = rt_beris_edwards_rhs(Q, Hs, W, p);
  float q0[5];
  const float r5[5] = {rhs.m[0][0], rhs.m[0][1], rhs.m[0][2], rhs.m[1][1], rhs.m[1][2]};
#pragma unroll
  for (int c = 0; c < 5; ++c)
    q0[c] = q[rt_at<K>(L.a, c, s, 5, V)] + p.dt * (r5[c] - adv[rt_at<K>(L.d, c, s, 5, V)]);
  rt_store_q5<K>(q_new, L.e, V, s,
                 rt_traceless_sym(rt_q5_to_mat(q0[0], q0[1], q0[2], q0[3], q0[4])));
}

// q, dq -> fed: layouts a, b, c (fed has one component, so its address is
// s in every layout).
template <int K>
__global__ void ludwig_fed_kernel(const float* __restrict__ q, const float* __restrict__ dq,
                                  float* __restrict__ fed, long long V, rt_fed_params p,
                                  rt_lc_layouts L) {
  const long long s = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (s >= V) return;
  const rt_m3 Q = rt_load_q<K>(q, L.a, 5, V, s, 0);
  const rt_m3 QQ = rt_mul(Q, Q);
  const float trQ2 = rt_trace(QQ);
  const float trQ3 = rt_trace(rt_mul(QQ, Q));
  const float bulk = p.c1 * trQ2 - p.c2 * trQ3 + p.c3 * trQ2 * trQ2;
  float el = 0.0f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const rt_m3 dQ = rt_load_q<K>(dq, L.b, 15, V, s, 5 * a);
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float t = dQ.m[i][j] * dQ.m[i][j];
        el = (a == 0 && i == 0 && j == 0) ? t : el + t;
      }
  }
  fed[rt_at<K>(L.c, 0, s, 1, V)] = bulk + p.half_kappa * el;
}

// Decode n descriptors into L (unused slots SoA); the launch's layout
// class, or -1 for a descriptor that names no layout.
static inline int rt_lc_decode(const int* desc, int n, rt_lc_layouts* L) {
  rt_layout ls[5];
  for (int k = 0; k < 5; ++k) ls[k] = rt_make_layout(k < n ? desc[k] : RT_SOA);
  *L = rt_lc_layouts{ls[0], ls[1], ls[2], ls[3], ls[4]};
  return rt_launch_class(ls, n);
}

extern "C" {

// q, lapq, h: 5 x V; dq: 15 x V = [d/dx q, d/dy q, d/dz q]; sigma: 9 x V; in
// the layouts of descriptors lq, llap, ldq, lh, lsig.
int rt_ludwig_chem_stress(const float* q, const float* lapq, const float* dq, float* h,
                          float* sigma, long long V, float c_q, float c_b, float c_t,
                          float kappa_m, float neg_xi, float two_xi, float kappa_s, int lq,
                          int llap, int ldq, int lh, int lsig, int block, cudaStream_t stream) {
  const int desc[5] = {lq, llap, ldq, lh, lsig};
  rt_lc_layouts L;
  const int k = rt_lc_decode(desc, 5, &L);
  if (k < 0) return RT_BAD_LAYOUT;
  if (V == 0) return 0;
  const rt_mol_params mp{c_q, c_b, c_t, kappa_m};
  const rt_stress_params sp{neg_xi, two_xi, kappa_s};
  RT_WITH_CLASS(k, ludwig_chem_stress_kernel<RT_K><<<rt_grid(V, block), block, 0, stream>>>(
                       q, lapq, dq, h, sigma, V, mp, sp, L, 0u, false));
  RT_LAUNCH_RESULT();
}

// q, h, adv, q_new: 5 x V; w: 9 x V with W[a][b] = du_a/dx_b at a*3 + b; in
// the layouts of descriptors lq, lh, lw, ladv, lqn.
int rt_ludwig_lc_update(const float* q, const float* h, const float* w, const float* adv,
                        float* q_new, long long V, float gamma_rot, float xi, float neg_two_xi,
                        float dt, int lq, int lh, int lw, int ladv, int lqn, int block,
                        cudaStream_t stream) {
  const int desc[5] = {lq, lh, lw, ladv, lqn};
  rt_lc_layouts L;
  const int k = rt_lc_decode(desc, 5, &L);
  if (k < 0) return RT_BAD_LAYOUT;
  if (V == 0) return 0;
  const rt_update_params p{gamma_rot, xi, neg_two_xi, dt};
  RT_WITH_CLASS(k, ludwig_lc_update_kernel<RT_K><<<rt_grid(V, block), block, 0, stream>>>(
                       q, h, w, adv, q_new, V, p, L, 0u, false));
  RT_LAUNCH_RESULT();
}

// K3L's policy instances: rt_ludwig_chem_stress's and rt_ludwig_lc_update's
// arguments, each field fp32 or bf16 (bit k of in16, in argument order), rb:
// round fp32 inputs to bf16 at load, out16: write the fields in bf16.
int rt_ludwig_chem_stress_policy(const void* q, const void* lapq, const void* dq, void* h,
                                 void* sigma, long long V, float c_q, float c_b, float c_t,
                                 float kappa_m, float neg_xi, float two_xi, float kappa_s,
                                 int in16, int rb, int out16, int lq, int llap, int ldq, int lh,
                                 int lsig, int block, cudaStream_t stream) {
  const int desc[5] = {lq, llap, ldq, lh, lsig};
  rt_lc_layouts L;
  const int k = rt_lc_decode(desc, 5, &L);
  if (k < 0) return RT_BAD_LAYOUT;
  if (V == 0) return 0;
  const rt_mol_params mp{c_q, c_b, c_t, kappa_m};
  const rt_stress_params sp{neg_xi, two_xi, kappa_s};
#define RT_CS_POL(O16, A16)                                                                    \
  RT_WITH_CLASS(k, ludwig_chem_stress_kernel<RT_K, true, O16, A16><<<rt_grid(V, block), block, 0, \
                                                                     stream>>>(                  \
                       q, lapq, dq, h, sigma, V, mp, sp, L, (unsigned)in16, rb != 0))
  if (out16 && in16) RT_CS_POL(true, true)
  else if (out16) RT_CS_POL(true, false)
  else if (in16) RT_CS_POL(false, true)
  else RT_CS_POL(false, false)
#undef RT_CS_POL
  RT_LAUNCH_RESULT();
}

int rt_ludwig_lc_update_policy(const void* q, const void* h, const void* w, const void* adv,
                               void* q_new, long long V, float gamma_rot, float xi,
                               float neg_two_xi, float dt, int in16, int rb, int out16, int lq,
                               int lh, int lw, int ladv, int lqn, int block, cudaStream_t stream) {
  const int desc[5] = {lq, lh, lw, ladv, lqn};
  rt_lc_layouts L;
  const int k = rt_lc_decode(desc, 5, &L);
  if (k < 0) return RT_BAD_LAYOUT;
  if (V == 0) return 0;
  const rt_update_params p{gamma_rot, xi, neg_two_xi, dt};
#define RT_LU_POL(O16, A16)                                                                    \
  RT_WITH_CLASS(k, ludwig_lc_update_kernel<RT_K, true, O16, A16><<<rt_grid(V, block), block, 0,   \
                                                                   stream>>>(                    \
                       q, h, w, adv, q_new, V, p, L, (unsigned)in16, rb != 0))
  if (out16 && in16) RT_LU_POL(true, true)
  else if (out16) RT_LU_POL(true, false)
  else if (in16) RT_LU_POL(false, true)
  else RT_LU_POL(false, false)
#undef RT_LU_POL
  RT_LAUNCH_RESULT();
}

// K3C.  q, lapq, adv, q_new: 5 x V; w: 9 x V (as rt_ludwig_lc_update's); in
// the layouts of descriptors lq, llap, lw, ladv, lqn.
int rt_ludwig_lc_chain(const float* q, const float* lapq, const float* w, const float* adv,
                       float* q_new, long long V, float c_q, float c_b, float c_t, float kappa_m,
                       float gamma_rot, float xi, float neg_two_xi, float dt, int lq, int llap,
                       int lw, int ladv, int lqn, int block, cudaStream_t stream) {
  const int desc[5] = {lq, llap, lw, ladv, lqn};
  rt_lc_layouts L;
  const int k = rt_lc_decode(desc, 5, &L);
  if (k < 0) return RT_BAD_LAYOUT;
  if (V == 0) return 0;
  const rt_mol_params mp{c_q, c_b, c_t, kappa_m};
  const rt_update_params p{gamma_rot, xi, neg_two_xi, dt};
  RT_WITH_CLASS(k, ludwig_lc_chain_kernel<RT_K><<<rt_grid(V, block), block, 0, stream>>>(
                       q, lapq, w, adv, q_new, V, mp, p, L));
  RT_LAUNCH_RESULT();
}

// q: 5 x V; dq: 15 x V; fed: 1 x V; in the layouts of descriptors lq, ldq,
// lfed.
int rt_ludwig_fed(const float* q, const float* dq, float* fed, long long V, float c1, float c2,
                  float c3, float half_kappa, int lq, int ldq, int lfed, int block,
                  cudaStream_t stream) {
  const int desc[3] = {lq, ldq, lfed};
  rt_lc_layouts L;
  const int k = rt_lc_decode(desc, 3, &L);
  if (k < 0) return RT_BAD_LAYOUT;
  if (V == 0) return 0;
  const rt_fed_params p{c1, c2, c3, half_kappa};
  RT_WITH_CLASS(k, ludwig_fed_kernel<RT_K><<<rt_grid(V, block), block, 0, stream>>>(
                       q, dq, fed, V, p, L));
  RT_LAUNCH_RESULT();
}

}  // extern "C"
