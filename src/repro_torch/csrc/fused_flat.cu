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
// (288 B).  One thread per site for cg_update (it folds all 24 components
// of its site), one per element for cg_xpay.
//
// Layouts: every tensor comes with its own layout descriptor (SoA, AoS or
// AoSoA; common.cuh).  cg_update addresses component c of its site at
// INDEX(c, s) in each tensor's layout; its block folds the same sites in
// the same order in every layout, so fields and partials are bitwise the
// SoA launch's.  cg_xpay walks the flat arrays when its three operands
// share a layout (layout-free, coalesced in any layout) and otherwise
// recovers each output element's (component, site) from the output's
// layout.  Under AoS the per-site loads of cg_update are ncomp floats apart
// across a warp: every load touches a sector of its own.
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

#include "bf16.cuh"

#define RT_SPINOR 24

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
  rt_block_partials<RT_SPINOR>(sq, RT_OP_SUM, partials);
}

// MIXED: the three operands' layouts differ.  sx, sy: per-slot element
// offsets of x and y (0 for a shared one).
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

static int rt_xpay_launch(const float* x, const float* y, const float* a, const float* m,
                          float* out, int ncomp, long long nsites, int batch, long long sx,
                          long long sy, int lx, int ly, int lo, int block, cudaStream_t stream) {
  const long long n = (long long)ncomp * nsites;
  const rt_layout L[3] = {rt_make_layout(lx), rt_make_layout(ly), rt_make_layout(lo)};
  if (rt_launch_class(L, 3) < 0) return RT_BAD_LAYOUT;
  if (n == 0 || batch == 0) return 0;
  const bool mixed = !(rt_same_layout(L[0], L[2]) && rt_same_layout(L[1], L[2]));
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
