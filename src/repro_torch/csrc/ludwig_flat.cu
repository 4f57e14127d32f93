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
// Neither flat graph has a terminal reduction, so each is one launch, one
// thread per site, fields only.  The Q tensor arrives as 5 SoA components
// (XX, XY, XZ, YY, YZ; ZZ = -XX - YY) and the 3x3 algebra of
// apps/ludwig/lc.py is unrolled in registers in the reference's order of
// operations; every Python-float coefficient of the reference is computed in
// double by the host and passed as fp32.  nvcc contracts a*b + c into fused
// multiply-adds, so the results agree with the plain versions to a
// tolerance, not bitwise.
//
// Bound on the H100: bytes.  Compulsory traffic a site: chem_stress reads
// 5 + 5 + 15 and writes 5 + 9 values (156 B) for about 600 flops;
// lc_update reads 5 + 5 + 9 + 5 and writes 5 (116 B) for about 320 flops;
// fed reads 5 + 15 and writes 1 (84 B) for about 160 flops.  The heaviest,
// chem_stress, is under 4 flop/byte, far below the ~20 flop/byte fp32
// ridge.
// The stress needs Q, H, Q + I/3, three 3x3 products and the three 3x3
// gradient matrices at once; built with -Xptxas -v for sm_90a (CUDA 12.8)
// the kernels use 40 (chem_stress), 40 (lc_update) and 32 (fed) registers,
// with no spills, so registers do not limit occupancy at 128 threads a
// block.

#include "common.cuh"

struct rt_m3 {
  float m[3][3];
};

__device__ __forceinline__ rt_m3 rt_q5_to_mat(float q0, float q1, float q2, float q3, float q4) {
  const float qzz = -q0 - q3;
  return rt_m3{{{q0, q1, q2}, {q1, q3, q4}, {q2, q4, qzz}}};
}

// Component c of site s of a SoA field with 5 components starting at comp0.
__device__ __forceinline__ rt_m3 rt_load_q(const float* __restrict__ x, long long V, long long s,
                                           int comp0) {
  const float* p = x + (long long)comp0 * V + s;
  return rt_q5_to_mat(p[0], p[V], p[2 * V], p[3 * V], p[4 * V]);
}

__device__ __forceinline__ void rt_store_q5(float* __restrict__ x, long long V, long long s,
                                            const rt_m3& a) {
  x[s] = a.m[0][0];
  x[V + s] = a.m[0][1];
  x[2 * V + s] = a.m[0][2];
  x[3 * V + s] = a.m[1][1];
  x[4 * V + s] = a.m[1][2];
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

__global__ void ludwig_chem_stress_kernel(const float* __restrict__ q,
                                          const float* __restrict__ lapq,
                                          const float* __restrict__ dq, float* __restrict__ h,
                                          float* __restrict__ sigma, long long V,
                                          rt_mol_params mp, rt_stress_params sp) {
  const long long s = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (s >= V) return;
  const rt_m3 Q = rt_load_q(q, V, s, 0);
  const rt_m3 H = rt_molecular_field(Q, rt_load_q(lapq, V, s, 0), mp);
  rt_store_q5(h, V, s, H);
  // the graph's stress stage reads the 5 stored components of h back
  const rt_m3 Hs = rt_q5_to_mat(H.m[0][0], H.m[0][1], H.m[0][2], H.m[1][1], H.m[1][2]);
  const rt_m3 dQ[3] = {rt_load_q(dq, V, s, 0), rt_load_q(dq, V, s, 5), rt_load_q(dq, V, s, 10)};
  float sig[9];
  rt_stress(Q, Hs, dQ, sp, sig);
#pragma unroll
  for (int c = 0; c < 9; ++c) sigma[(long long)c * V + s] = sig[c];
}

__global__ void ludwig_lc_update_kernel(const float* __restrict__ q, const float* __restrict__ h,
                                        const float* __restrict__ w, const float* __restrict__ adv,
                                        float* __restrict__ q_new, long long V,
                                        rt_update_params p) {
  const long long s = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (s >= V) return;
  const rt_m3 Q = rt_load_q(q, V, s, 0);
  rt_m3 W;
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b) W.m[a][b] = w[(long long)(a * 3 + b) * V + s];
  const rt_m3 rhs = rt_beris_edwards_rhs(Q, rt_load_q(h, V, s, 0), W, p);
  // q0 = q5 + dt (rhs5 - adv5) on the 5 stored components, then projected
  float q0[5];
  const float r5[5] = {rhs.m[0][0], rhs.m[0][1], rhs.m[0][2], rhs.m[1][1], rhs.m[1][2]};
#pragma unroll
  for (int c = 0; c < 5; ++c)
    q0[c] = q[(long long)c * V + s] + p.dt * (r5[c] - adv[(long long)c * V + s]);
  rt_store_q5(q_new, V, s, rt_traceless_sym(rt_q5_to_mat(q0[0], q0[1], q0[2], q0[3], q0[4])));
}

__global__ void ludwig_fed_kernel(const float* __restrict__ q, const float* __restrict__ dq,
                                  float* __restrict__ fed, long long V, rt_fed_params p) {
  const long long s = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (s >= V) return;
  const rt_m3 Q = rt_load_q(q, V, s, 0);
  const rt_m3 QQ = rt_mul(Q, Q);
  const float trQ2 = rt_trace(QQ);
  const float trQ3 = rt_trace(rt_mul(QQ, Q));
  const float bulk = p.c1 * trQ2 - p.c2 * trQ3 + p.c3 * trQ2 * trQ2;
  float el = 0.0f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const rt_m3 dQ = rt_load_q(dq, V, s, 5 * a);
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float t = dQ.m[i][j] * dQ.m[i][j];
        el = (a == 0 && i == 0 && j == 0) ? t : el + t;
      }
  }
  fed[s] = bulk + p.half_kappa * el;
}

extern "C" {

// q, lapq, h: (5, V) SoA; dq: (15, V) = [d/dx q, d/dy q, d/dz q]; sigma: (9, V).
int rt_ludwig_chem_stress(const float* q, const float* lapq, const float* dq, float* h,
                          float* sigma, long long V, float c_q, float c_b, float c_t,
                          float kappa_m, float neg_xi, float two_xi, float kappa_s, int block,
                          cudaStream_t stream) {
  if (V == 0) return 0;
  ludwig_chem_stress_kernel<<<rt_grid(V, block), block, 0, stream>>>(
      q, lapq, dq, h, sigma, V, rt_mol_params{c_q, c_b, c_t, kappa_m},
      rt_stress_params{neg_xi, two_xi, kappa_s});
  RT_LAUNCH_RESULT();
}

// q, h, adv, q_new: (5, V) SoA; w: (9, V) with W[a][b] = du_a/dx_b at a*3 + b.
int rt_ludwig_lc_update(const float* q, const float* h, const float* w, const float* adv,
                        float* q_new, long long V, float gamma_rot, float xi, float neg_two_xi,
                        float dt, int block, cudaStream_t stream) {
  if (V == 0) return 0;
  ludwig_lc_update_kernel<<<rt_grid(V, block), block, 0, stream>>>(
      q, h, w, adv, q_new, V, rt_update_params{gamma_rot, xi, neg_two_xi, dt});
  RT_LAUNCH_RESULT();
}

// q: (5, V) SoA; dq: (15, V); fed: (1, V).
int rt_ludwig_fed(const float* q, const float* dq, float* fed, long long V, float c1, float c2,
                  float c3, float half_kappa, int block, cudaStream_t stream) {
  if (V == 0) return 0;
  ludwig_fed_kernel<<<rt_grid(V, block), block, 0, stream>>>(
      q, dq, fed, V, rt_fed_params{c1, c2, c3, half_kappa});
  RT_LAUNCH_RESULT();
}

}  // extern "C"
