// K10: the RWKV6 chunked WKV recurrence, as two kernels, rt_rwkv6_state
// (the state pass) and rt_rwkv6_output (the output pass).
//
// Replaces src/repro/kernels/rwkv6_scan/kernel.py::rwkv6_pallas (:31,
// pallas_call :63).  The TPU kernel's grid is (BH, T/C) with the chunk axis
// sequential on one core: a (dk, dv) state in VMEM scratch, set from s0 at
// chunk 0, carries each head across its chunks, and every program runs
// ref.chunk_body on its chunk.  Per chunk of C steps, with L = cumsum(log w)
// and Lprev = L - log w:
//   o = (r exp(Lprev)) S + (A * strict-lower mask) v + (sum_d r u k) v,
//   A[t,s] = sum_d r_td k_sd exp(min(Lprev_td - L_sd, 0)),
//   S <- exp(L_C) S + (k exp(L_C - L))^T v.
//
// Design for Hopper (FLA's chunk-parallel form):
// - Two passes.  Only the state carries from chunk to chunk, so the state
//   pass runs that recurrence alone and writes the state entering every
//   chunk, S_{c-1}, to a (BH, T/C, dk, dv) fp32 buffer (134 MB at
//   (4, 64, 2048)) and sT; the output pass then runs every (bh, chunk) as
//   a block of its own, BH x T/C blocks (8,192 at (4, 64, 2048)), not one
//   block a head looping over its chunks.
// - The state pass.  A block of 4 warps owns 32 rows d of one head's
//   state (RT_K10_ST_DT = 2 tiles of 16), warp w the rows 16 (w / 2) ..
//   and columns 32 (w % 2) .. in registers, and walks the chunks in order:
//   S <- exp(L_C) S + kd^T v, the reference's order of operations.  Chunk
//   c + 1's w, k and v tiles are copied into the block's other shared stage
//   with 16-byte cp.async while chunk c computes (plain loads where the rows
//   are not whole 16-byte runs).  L for the block's 32 columns is a scan
//   down the chunk by the block (4 segments of 16 rows, then the segments'
//   totals), and kd = k exp(L_C - L) is formed once in shared memory for
//   all its warps.  BH x ceil(dk / 32) blocks: 2 a head read v, where 1
//   (4 tiles) took 0.257 against 0.240 ms on the bf16 views at (4, 64,
//   2048) and 0.699 against 0.597 at (1, 64, 8192), and 4 (1 tile) 0.367
//   (tools/k10_ablate.py, H100 80GB HBM3 at 700 W; PERF.md §6).
// - The output pass.  8 warps: warp (I, h) owns the 16 rows of sub-chunk I
//   (C is cut into sub-chunks of RT_K10_SUB = 16 steps) and columns
//   32h .. 32h + 31 of o.  r, k, v (in the inputs' type) and S_{c-1} are
//   staged in shared memory with 16-byte cp.async (where C = dk = dv = 64
//   and the rows are aligned; plain loads and zero padding otherwise), L by
//   a scan of the whole block (256 threads, 4 segments of 16 rows, then the
//   segments' totals).  Lprev_t is L_{t-1} (L_{-1} = 0), which the
//   reference's L - log w equals up to rounding; it also spares the pairs
//   s = t - 1 the reference's cancellation (L_t - log w_t) - L_{t-1}, which
//   at the 1e-26 clamp (|L| ~ 3.8e3, spacing 2.4e-4) costs its fp32 form
//   more than the port's tolerance (tests/test_torch_rwkv.py).
//   - A's diagonal 16 x 16 blocks keep the pairwise form with the
//     reference's clamp: 120 causal pairs a block, each summed over d by
//     one lane (4-value loads), one exp a (pair, d): ~31k a chunk.
//   - A's off-diagonal blocks are factored: for t in sub-chunk I, s in an
//     earlier one and b = 16 I - 1 (the last step of sub-chunk I - 1),
//     exp(Lprev_t - L_s) = exp(Lprev_t - L_b) exp(L_b - L_s).  Lprev_t <=
//     L_b <= L_s wherever w <= 1 (L does not increase), so both factors
//     are at most 1 and nothing overflows, even at the 1e-26 clamp (where a
//     factor taken about a sub-chunk's start would reach e^958).  A's rows
//     I left of the diagonal are then one (16 x dk) (dk x 16 I) product of
//     r exp(Lprev - L_b) and (k exp(L_b - L))^T: ~9k exponentials a chunk
//     instead of the pairwise form's ~98k.  Each factor's exponent is
//     clamped at 0 (rt_min0), which changes nothing where log w keeps one
//     sign across the chunk (every w <= 1, which the model's decay
//     exp(-exp(.)) always gives, or every w >= 1); for w that mixes the two
//     the product of two clamped factors is not the reference's clamp of
//     their sum: finite, but not the reference.  q = r exp(Lprev) and
//     kd = k exp(L_C - L) are not clamped, as in the reference.
//   - A is written over L's rows (L is no longer needed), the
//     off-diagonal blocks spread so that the warps with the longest A v
//     take the fewest, and o = q S + A v + (sum_d r u k) v, stored two
//     neighbouring values at a time where o's layout allows.
// - Tensor cores.  q S, the off-diagonal A blocks, A v and kd^T v run on
//   mma.sync.m16n8k8 in 3xTF32 (each operand split into a TF32 hi and lo;
//   hi*hi + hi*lo + lo*hi in fp32 accumulators), which keeps fp32's
//   accuracy: TF32 alone (10 mantissa bits) would not hold the port's
//   rtol 1e-5 + atol 2e-5 x max|plain|.  A bf16 v is exact in TF32, so
//   kd^T v and A v skip the product with its (zero) lo half.  Shared rows are padded so that
//   fragment loads hit distinct banks (RT_K10_PF, _PB, _PL, _PV).
// - Inputs as the model has them.  r, k, v, w are fp32 or bf16 (B, H, T, d)
//   views with any (b, h, t) strides and d contiguous (the model's heads
//   are permuted views of (B, T, H, d)); o is written in fp32 or bf16
//   (__float2bfloat16_rn: round to nearest even, as Tensor.to) at any
//   (b, h, t) strides, so the model gets its (B, T, H, dv) order directly.
// - Logs and exps in base 2, the same function: exp2f, and rt_log2w (a
//   series near 1, lg2.approx elsewhere) in place of log2f and its
//   special-case handling.
// - Limits.  C, dk and dv are runtime values from 1 to 64 (padded with
//   zeros to 64); T a multiple of C.
//
// What bounds it (B 4, H 64, T 2048, C = dk = dv = 64: 8,192 chunks):
// - the reference's fp32 arithmetic (PERF.md keeps it as the bound):
//   17.6 G operations, 0.262 ms at 67 TFLOP/s;
// - this design's own floor (chip_smoke.py::wkv_floor): bf16 r, k, v, w
//   read and o written once with u, s0 and sT in fp32, 344 MB, 0.103 ms at
//   3.35 TB/s (fp32: 680 MB, 0.203 ms); 12.9 GFLOP of products, three
//   times on the TF32 tensor cores, 0.078 ms at 495 TFLOP/s; ~56k
//   exponentials and logarithms a chunk, 0.46 G, 0.110 ms at 16 a clock an
//   SM (1.98 GHz).  The states buffer adds 268 MB of traffic (0.080 ms).

#include <initializer_list>

#include "bf16.cuh"

#define RT_K10_MAX 64          // C, dk and dv may each be 1 .. RT_K10_MAX
#define RT_K10_SUB 16          // rows of a sub-chunk
#define RT_K10_OUT_THREADS 256 // the output pass: 8 warps, (sub-chunk I, column half h)
#define RT_K10_ST_DT 2         // the state pass: 16-row tiles of the state a block
#define RT_K10_ST_WARPS (2 * RT_K10_ST_DT)  // a warp a (16-row tile, 32-column half)
#define RT_K10_ST_DC (16 * RT_K10_ST_DT)    // columns d of w and k a block stages
#define RT_K10_PF 68           // fp32 pitch of tiles read as [m][k] or [n][k]: 4 g + q banks
#define RT_K10_PB 72           // pitch of [k][n] tiles (and of bf16 [m][k] ones): 8 q + g banks
#define RT_K10_PL (RT_K10_ST_DC + 8)  // the state pass's kd and w, k stages: 8 q + g banks
#define RT_K10_CLAMP 1e-26f    // w's floor before the log (ref.rwkv6_chunked)
// elements of one state-pass stage: w and k (64 x RT_K10_ST_DC), v (64 x 64)
#define RT_K10_PV (64 + 8)
#define RT_K10_STAGE (2 * RT_K10_MAX * RT_K10_PL + RT_K10_MAX * RT_K10_PV)

// The operands of one head: element (b, h, t, d) of r, k and w at
// b * sb + h * sh + t * st + d, of v at b * vsb + h * vsh + t * vst + d.
struct rt_wkv_in {
  const void* r;
  const void* k;
  const void* v;
  const void* w;
  long long sb, sh, st;
  long long vsb, vsh, vst;
  int B, H, C, dk, dv, nc;  // nc = T / C chunks
  int vec;                  // the 16-byte copy path (see the entry points)
};

// -- 3xTF32 on mma.sync -------------------------------------------------------

// x = hi + lo with hi = tf32(x) and lo = tf32(x - hi).
__device__ __forceinline__ void rt_tf32_split(float x, unsigned& hi, unsigned& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  const float rest = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(rest));
}

// A (16 x 8, row major) and B (8 x 8, column major) fragments of
// mma.m16n8k8, split.  Lane (g = lane / 4, q = lane % 4) holds A at
// (g, q), (g + 8, q), (g, q + 4), (g + 8, q + 4) and B at (q, g), (q + 4, g);
// C at (g, 2q), (g, 2q + 1), (g + 8, 2q), (g + 8, 2q + 1).
struct rt_fa {
  unsigned hi[4], lo[4];
};
struct rt_fb {
  unsigned hi[2], lo[2];
};

__device__ __forceinline__ void rt_mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                            const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d[n] += a b[n] for the first `n` of N tiles in 3xTF32, the small terms
// first: each round runs over the tiles, so that no product waits on the
// one issued just before it (same accumulator).  BEXACT: b is exact in
// TF32 (a bf16 input), its lo is 0 and the a.hi b.lo round adds nothing.
template <int N, bool BEXACT = false>
__device__ __forceinline__ void rt_mma3(float (&d)[N][4], const rt_fa& a, const rt_fb (&b)[N],
                                        int n = N) {
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (i < n) rt_mma_tf32(d[i], a.lo, b[i].hi);
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (!BEXACT && i < n) rt_mma_tf32(d[i], a.hi, b[i].lo);
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (i < n) rt_mma_tf32(d[i], a.hi, b[i].hi);
}

// min(x, 0), NaN kept (torch.clamp's), in one instruction.
__device__ __forceinline__ float rt_min0(float x) {
  float r;
  asm("min.NaN.f32 %0, %1, 0f00000000;" : "=f"(r) : "f"(x));
  return r;
}

// log2 of w clamped at RT_K10_CLAMP (NaN kept), to a few ulp and with no
// branch: near 1 (|w - 1| <= 1/8, where the model's decays lie and log w
// is small) the series of log(1 + f), f = w - 1 exact, to f^8 (the rest is
// under 2^-29 of the sum); elsewhere lg2.approx, whose relative error there
// is under 2^-20.  log2f's own special cases cost ~3x these instructions.
__device__ __forceinline__ float rt_log2w(float w) {
  const float x = w < RT_K10_CLAMP ? RT_K10_CLAMP : w;
  const float f = x - 1.0f;
  float p = -0.125f;
  p = fmaf(p, f, 0.14285714f);
  p = fmaf(p, f, -0.16666667f);
  p = fmaf(p, f, 0.2f);
  p = fmaf(p, f, -0.25f);
  p = fmaf(p, f, 0.33333334f);
  p = fmaf(p, f, -0.5f);
  p = fmaf(p, f, 1.0f);
  float far;
  asm("lg2.approx.f32 %0, %1;" : "=f"(far) : "f"(x));
  return fabsf(f) <= 0.125f ? f * p * 1.44269504f : far;
}

// A value of a shared tile as fp32.
__device__ __forceinline__ float rt_lds(const float* p) { return *p; }
__device__ __forceinline__ float rt_lds(const __nv_bfloat16* p) { return __bfloat162float(*p); }

__device__ __forceinline__ void rt_k10_cp16(void* dst, const void* src) {
  const unsigned int d = static_cast<unsigned int>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void rt_k10_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void rt_k10_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Four consecutive values of a shared row as fp32 (8-byte aligned for bf16,
// 16-byte for fp32).
__device__ __forceinline__ float4 rt_ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 rt_ld4(const __nv_bfloat16* p) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&w.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&w.y);
  return make_float4(__low2float(a), __high2float(a), __low2float(b), __high2float(b));
}

// Row pitch of the output pass's r, k and v tiles, stored as the inputs
// are: rows start 16-byte aligned (cp.async) and fragment loads hit
// distinct banks.
template <typename IN>
struct rt_k10_pitch {
  static constexpr int rk = sizeof(IN) == 2 ? RT_K10_PB : RT_K10_PF;
};

// -- the state pass ---------------------------------------------------------------

// A state-pass block: RT_K10_ST_WARPS warps on one head and RT_K10_ST_DC
// rows d of its state, warp w on rows 16 (w / 2) .. and columns
// 32 (w % 2) ...  Chunk c's w and k (64 x RT_K10_ST_DC from column d0) and
// v (64 x 64) go into a stage: 16-byte cp.async copies of the rows under
// a.vec (whole tiles, aligned), else plain loads; rows past C (and columns
// past dk, dv) are not written, and the readers mask them.
template <typename IN>
__device__ __forceinline__ void rt_k10_state_copy(const rt_wkv_in& a, const IN* wp, const IN* kp,
                                                  const IN* vp, long long t0, int d0, IN* stage) {
  IN* sw = stage;
  IN* sk = stage + RT_K10_MAX * RT_K10_PL;
  IN* sv = stage + 2 * RT_K10_MAX * RT_K10_PL;
  const int tid = threadIdx.x, nthr = 32 * RT_K10_ST_WARPS;
  if (a.vec) {
    constexpr int per = 16 / sizeof(IN);  // values a copy
    constexpr int wq = RT_K10_ST_DC / per, vq = 64 / per;
    for (int i = tid; i < a.C * wq; i += nthr) {
      const int t = i / wq, part = i - t * wq;
      const long long src = (t0 + t) * a.st + d0 + part * per;
      rt_k10_cp16(sw + t * RT_K10_PL + part * per, wp + src);
      rt_k10_cp16(sk + t * RT_K10_PL + part * per, kp + src);
    }
    for (int i = tid; i < a.C * vq; i += nthr) {
      const int t = i / vq, part = i - t * vq;
      rt_k10_cp16(sv + t * RT_K10_PV + part * per, vp + (t0 + t) * a.vst + part * per);
    }
  } else {
    for (int i = tid; i < a.C * RT_K10_ST_DC; i += nthr) {
      const int t = i / RT_K10_ST_DC, dd = i - t * RT_K10_ST_DC;
      if (d0 + dd < a.dk) {
        sw[t * RT_K10_PL + dd] = wp[(t0 + t) * a.st + d0 + dd];
        sk[t * RT_K10_PL + dd] = kp[(t0 + t) * a.st + d0 + dd];
      }
    }
    for (int i = tid; i < a.C * 64; i += nthr) {
      const int t = i >> 6, j = i & 63;
      if (j < a.dv) sv[t * RT_K10_PV + j] = vp[(t0 + t) * a.vst + j];
    }
  }
}

template <typename IN>
__global__ void __launch_bounds__(32 * RT_K10_ST_WARPS)
    rwkv6_state_kernel(rt_wkv_in a, const float* __restrict__ s0, float* __restrict__ states,
                       float* __restrict__ sT) {
  extern __shared__ float4 rt_k10_st_smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int nbd = (a.dk + RT_K10_ST_DC - 1) / RT_K10_ST_DC;  // blocks a head
  const long long bh = blockIdx.x / nbd;
  const int db = (int)(blockIdx.x % nbd) * RT_K10_ST_DC;      // the block's first row d
  const int b = (int)(bh / a.H), h = (int)(bh % a.H);
  const int dl = (warp >> 1) * 16;                             // the warp's rows, in the block
  const int d0 = db + dl, j0 = (warp & 1) * 32;
  const IN* kp = static_cast<const IN*>(a.k) + b * a.sb + h * a.sh;
  const IN* wp = static_cast<const IN*>(a.w) + b * a.sb + h * a.sh;
  const IN* vp = static_cast<const IN*>(a.v) + b * a.vsb + h * a.vsh;
  IN* stages = reinterpret_cast<IN*>(rt_k10_st_smem);  // two stages
  float* KD = reinterpret_cast<float*>(stages + 2 * RT_K10_STAGE);  // kd (64 x RT_K10_ST_DC)
  float* part = KD + RT_K10_MAX * RT_K10_PL;                        // the scan's totals
  const long long SZ = (long long)a.dk * a.dv;

  // the state tile in C fragments: rows d0 + g (+ 8), columns j0 + 8 nt + 2q (+ 1)
  float S[4][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = d0 + g + (e & 2 ? 8 : 0), col = j0 + 8 * nt + 2 * q + (e & 1);
      S[nt][e] = s0 != nullptr && row < a.dk && col < a.dv ? s0[bh * SZ + row * a.dv + col] : 0.0f;
    }

  // the scan: thread (column lcol of the block's, segment) takes ROWS rows
  constexpr int SEGS = 32 * RT_K10_ST_WARPS / RT_K10_ST_DC, ROWS = RT_K10_MAX / SEGS;
  const int lcol = tid % RT_K10_ST_DC, seg = tid / RT_K10_ST_DC;
  const bool dcol = db + lcol < a.dk;
  rt_k10_state_copy(a, wp, kp, vp, 0, db, stages);
  rt_k10_commit();
  for (int c = 0; c < a.nc; ++c) {
    const long long t0 = (long long)c * a.C;
    rt_k10_wait_all();
    __syncthreads();  // chunk c's stage is whole; chunk c - 1's readers are done
    // chunk c + 1's copies (into chunk c - 1's stage) go out before chunk c's arithmetic
    if (c + 1 < a.nc) {
      rt_k10_state_copy(a, wp, kp, vp, t0 + a.C, db, stages + ((c + 1) & 1) * RT_K10_STAGE);
      rt_k10_commit();
    }
    const IN* sw = stages + (c & 1) * RT_K10_STAGE;
    const IN* sk = sw + RT_K10_MAX * RT_K10_PL;
    const IN* sv = sw + 2 * RT_K10_MAX * RT_K10_PL;
    // L = cumsum of log2 w down the chunk for the block's columns (masked
    // values are selected, not branched around: log2 1 = 0)
    float lw[ROWS];
    float acc = 0.0f;
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int t = seg * ROWS + i;
      const float wv = rt_lds(sw + t * RT_K10_PL + lcol);
      acc += rt_log2w(t < a.C && dcol ? wv : 1.0f);
      lw[i] = acc;
    }
    part[seg * RT_K10_ST_DC + lcol] = acc;
    __syncthreads();
    float below = 0.0f, total = 0.0f;
#pragma unroll
    for (int s2 = 0; s2 < SEGS; ++s2) {
      const float x = part[s2 * RT_K10_ST_DC + lcol];
      below += s2 < seg ? x : 0.0f;
      total += x;
    }
    // kd = k 2^(L_C - L) in fp32 (masked rows and columns 0)
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int t = seg * ROWS + i;
      const float kd = rt_lds(sk + t * RT_K10_PL + lcol) * exp2f(total - (lw[i] + below));
      KD[t * RT_K10_PL + lcol] = t < a.C && dcol ? kd : 0.0f;
    }
    // exp(L_C) of this lane's rows g, g + 8 (the totals summed in total's order)
    float tot0 = 0.0f, tot8 = 0.0f;
#pragma unroll
    for (int s2 = 0; s2 < SEGS; ++s2) {
      tot0 += part[s2 * RT_K10_ST_DC + dl + g];
      tot8 += part[s2 * RT_K10_ST_DC + dl + g + 8];
    }
    const float dec0 = exp2f(tot0), dec8 = exp2f(tot8);
    __syncthreads();

    // kd^T v: A(m = d, k = t) = kd(t, d), B(k = t, n = j) = v(t, j)
    float P[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) P[nt][e] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < RT_K10_MAX / 8; ++ks) {
      rt_fa fa;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        rt_tf32_split(KD[(ks * 8 + q + (e & 2 ? 4 : 0)) * RT_K10_PL + dl + g + (e & 1 ? 8 : 0)],
                      fa.hi[e], fa.lo[e]);
      rt_fb fb[4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int t = ks * 8 + q + (e ? 4 : 0), j = j0 + 8 * nt + g;
          const float x = rt_lds(sv + t * RT_K10_PV + j);
          rt_tf32_split(t < a.C && j < a.dv ? x : 0.0f, fb[nt].hi[e], fb[nt].lo[e]);
        }
      rt_mma3<4, sizeof(IN) == 2>(P, fa, fb);
    }

    // the state entering chunk c, then S <- exp(L_C) S + kd^T v
    float* out = states + (bh * a.nc + c) * SZ;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = d0 + g + (e & 2 ? 8 : 0), col = j0 + 8 * nt + 2 * q + (e & 1);
        if (row < a.dk && col < a.dv) out[row * a.dv + col] = S[nt][e];
        S[nt][e] = (e & 2 ? dec8 : dec0) * S[nt][e] + P[nt][e];
      }
  }
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = d0 + g + (e & 2 ? 8 : 0), col = j0 + 8 * nt + 2 * q + (e & 1);
      if (row < a.dk && col < a.dv) sT[bh * SZ + row * a.dv + col] = S[nt][e];
    }
}

// -- the output pass --------------------------------------------------------------

// Bytes of the output pass's shared memory: r, k, v in the inputs' type;
// L (then A of each sub-chunk's rows) and S_{c-1} in fp32; the bonus row
// sums and the scan's segment totals.
template <typename IN>
static constexpr int rt_k10_out_smem() {
  return (2 * RT_K10_MAX * rt_k10_pitch<IN>::rk + RT_K10_MAX * RT_K10_PB) * (int)sizeof(IN) +
         RT_K10_MAX * RT_K10_PF * 4 + RT_K10_MAX * RT_K10_PB * 4 + (64 + 256) * 4;
}

template <typename IN>
__global__ void __launch_bounds__(RT_K10_OUT_THREADS, sizeof(IN) == 2 ? 3 : 2)
    rwkv6_output_kernel(rt_wkv_in a, const float* __restrict__ u, long long usb, long long ush,
                        const float* __restrict__ states, void* __restrict__ o, long long osb,
                        long long osh, long long ost, int out_bf16, int opair) {
  constexpr int P = rt_k10_pitch<IN>::rk;
  extern __shared__ float4 rt_k10_smem4[];
  IN* R = reinterpret_cast<IN*>(rt_k10_smem4);
  IN* K = R + RT_K10_MAX * P;
  IN* Vs = K + RT_K10_MAX * P;
  float* L = reinterpret_cast<float*>(Vs + RT_K10_MAX * RT_K10_PB);  // L, then A
  float* Ss = L + RT_K10_MAX * RT_K10_PF;
  float* bonus = Ss + RT_K10_MAX * RT_K10_PB;
  float* part = bonus + 64;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int I = warp & 3, hc = warp >> 2;
  const long long bh = blockIdx.x / a.nc;
  const int c = (int)(blockIdx.x % a.nc);
  const int b = (int)(bh / a.H), h = (int)(bh % a.H);
  const long long t0 = (long long)c * a.C;
  const IN* rp = static_cast<const IN*>(a.r) + b * a.sb + h * a.sh;
  const IN* kp = static_cast<const IN*>(a.k) + b * a.sb + h * a.sh;
  const IN* wp = static_cast<const IN*>(a.w) + b * a.sb + h * a.sh;
  const IN* vp = static_cast<const IN*>(a.v) + b * a.vsb + h * a.vsh;
  const float* sp = states + (bh * a.nc + c) * a.dk * a.dv;

  // r, k (C x dk), v (C x dv) and S_{c-1} (dk x dv), zero-padded to 64 x 64:
  // 16-byte cp.async copies of whole rows under a.vec (C = dk = dv = 64,
  // aligned), else plain loads
  if (a.vec) {
    constexpr int per = 16 / sizeof(IN), rq = RT_K10_MAX / per;
    for (int i = tid; i < RT_K10_MAX * rq; i += RT_K10_OUT_THREADS) {
      const int t = i / rq, part_ = i - t * rq;
      const int d = part_ * per;
      rt_k10_cp16(R + t * P + d, rp + (t0 + t) * a.st + d);
      rt_k10_cp16(K + t * P + d, kp + (t0 + t) * a.st + d);
      rt_k10_cp16(Vs + t * RT_K10_PB + d, vp + (t0 + t) * a.vst + d);
    }
    for (int i = tid; i < RT_K10_MAX * 16; i += RT_K10_OUT_THREADS) {
      const int t = i >> 4, d = (i & 15) * 4;
      rt_k10_cp16(Ss + t * RT_K10_PB + d, sp + t * RT_K10_MAX + d);
    }
    rt_k10_commit();
  } else {
    for (int i = tid; i < RT_K10_MAX * RT_K10_MAX; i += RT_K10_OUT_THREADS) {
      const int t = i >> 6, d = i & 63;
      const bool rk = t < a.C && d < a.dk;
      rt_st(R, t * P + d, rk ? rt_ld(rp, (t0 + t) * a.st + d) : 0.0f);
      rt_st(K, t * P + d, rk ? rt_ld(kp, (t0 + t) * a.st + d) : 0.0f);
      rt_st(Vs, t * RT_K10_PB + d, t < a.C && d < a.dv ? rt_ld(vp, (t0 + t) * a.vst + d) : 0.0f);
      Ss[t * RT_K10_PB + d] = t < a.dk && d < a.dv ? sp[t * a.dv + d] : 0.0f;
    }
  }
  // L = cumsum of log2 w down the chunk, by the whole block: thread
  // (column d, segment) adds 16 rows, then the earlier segments' totals
  {
    const int d = tid & 63, seg = tid >> 6;
    float lw[16];
    float acc = 0.0f;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int t = seg * 16 + i;
      acc += rt_log2w(t < a.C && d < a.dk ? rt_ld(wp, (t0 + t) * a.st + d) : 1.0f);
      lw[i] = acc;
    }
    part[seg * 64 + d] = acc;
    rt_k10_wait_all();
    __syncthreads();
    float below = 0.0f;
    for (int s = 0; s < seg; ++s) below += part[s * 64 + d];
#pragma unroll
    for (int i = 0; i < 16; ++i) L[(seg * 16 + i) * RT_K10_PF + d] = lw[i] + below;
  }
  __syncthreads();

  // the bonus row sums, sum_d r u k: four lanes a row, then two shuffles
  {
    const int t = tid >> 2, qq = tid & 3;
    const float* up = u + b * usb + h * ush;
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int d = qq + 4 * i;
      if (d < a.dk) s += rt_lds(R + t * P + d) * up[d] * rt_lds(K + t * P + d);
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    if (qq == 0) bonus[t] = s;
  }

  const int tA = RT_K10_SUB * I + g;  // this lane's rows of o and A: tA, tA + 8
  // q S: A(t, d) = r(t, d) 2^Lprev(t, d), B(d, j) = S(d, j)
  float acc[4][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;
#pragma unroll
  for (int ks = 0; ks < RT_K10_MAX / 8; ++ks) {
    rt_fa fa;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = tA + (e & 1 ? 8 : 0), d = ks * 8 + q + (e & 2 ? 4 : 0);
      const float lp = t > 0 ? L[(t - 1) * RT_K10_PF + d] : 0.0f;
      rt_tf32_split(rt_lds(R + t * P + d) * exp2f(lp), fa.hi[e], fa.lo[e]);
    }
    rt_fb fb[4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        rt_tf32_split(Ss[(ks * 8 + q + (e ? 4 : 0)) * RT_K10_PB + 32 * hc + 8 * nt + g],
                      fb[nt].hi[e], fb[nt].lo[e]);
    rt_mma3(acc, fa, fb);
  }

  // A left of the diagonal blocks, rows of sub-chunk Io factored about
  // b = 16 Io - 1.  Its 12 n-tiles (columns s = 8 nt + g < 16 Io) go to
  // the warps whose A v is shortest: warp (I, hc) takes sub-chunk
  // Io = {3, 2, -, 1}[I] and cnt = {3, 2, 0, 1}[I] of its n-tiles from hc cnt
  const int Io = I == 0 ? 3 : (I == 1 ? 2 : (I == 3 ? 1 : 0));
  const int cnt = I == 0 ? 3 : (I == 1 ? 2 : (I == 3 ? 1 : 0));
  const int nt0 = hc * cnt, tO = RT_K10_SUB * Io + g;
  float offA[3][4];
#pragma unroll
  for (int m = 0; m < 3; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) offA[m][e] = 0.0f;
  if (cnt > 0) {
    const int tb = RT_K10_SUB * Io - 1;
#pragma unroll
    for (int ks = 0; ks < RT_K10_MAX / 8; ++ks) {
      rt_fa fa;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = tO + (e & 1 ? 8 : 0), d = ks * 8 + q + (e & 2 ? 4 : 0);
        const float f = exp2f(rt_min0(L[(t - 1) * RT_K10_PF + d] - L[tb * RT_K10_PF + d]));
        rt_tf32_split(rt_lds(R + t * P + d) * f, fa.hi[e], fa.lo[e]);
      }
      rt_fb fb[3];
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        if (m >= cnt) break;
        const int s = 8 * (nt0 + m) + g;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int d = ks * 8 + q + (e ? 4 : 0);
          const float f = exp2f(rt_min0(L[tb * RT_K10_PF + d] - L[s * RT_K10_PF + d]));
          rt_tf32_split(rt_lds(K + s * P + d) * f, fb[m].hi[e], fb[m].lo[e]);
        }
      }
      rt_mma3(offA, fa, fb, cnt);
    }
  }

  // A's diagonal block, pairwise: pair p = tl (tl - 1) / 2 + sl (sl < tl) of
  // the 120 is lane 32 hc + lane's, p < 64, and p + 64's
  float dg[2] = {0.0f, 0.0f};
  int dt[2] = {0, 0}, ds[2] = {0, 0};
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int p = 32 * hc + lane + 64 * m;
    if (p >= RT_K10_SUB * (RT_K10_SUB - 1) / 2) continue;
    int tl = (int)((1.0f + sqrtf(1.0f + 8.0f * p)) * 0.5f);
    while (tl * (tl - 1) / 2 > p) --tl;
    while (tl * (tl + 1) / 2 <= p) ++tl;
    const int t = RT_K10_SUB * I + tl, s = RT_K10_SUB * I + p - tl * (tl - 1) / 2;
    dt[m] = t, ds[m] = s;
    float4 sum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);  // four chains: d mod 4
#pragma unroll 4
    for (int d = 0; d < RT_K10_MAX; d += 4) {
      const float4 rr = rt_ld4(R + t * P + d), kk = rt_ld4(K + s * P + d);
      const float4 lp = rt_ld4(L + (t - 1) * RT_K10_PF + d), ls = rt_ld4(L + s * RT_K10_PF + d);
      sum.x += rr.x * kk.x * exp2f(rt_min0(lp.x - ls.x));
      sum.y += rr.y * kk.y * exp2f(rt_min0(lp.y - ls.y));
      sum.z += rr.z * kk.z * exp2f(rt_min0(lp.z - ls.z));
      sum.w += rr.w * kk.w * exp2f(rt_min0(lp.w - ls.w));
    }
    dg[m] = (sum.x + sum.y) + (sum.z + sum.w);
  }
  __syncthreads();  // every reader of L is done

  // A over L's rows: the factored blocks (of sub-chunk Io), the pairs and
  // 0 on and above the diagonal (of sub-chunk I)
  float* A = L;
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    if (m >= cnt) break;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      A[(tO + (e & 2 ? 8 : 0)) * RT_K10_PF + 8 * (nt0 + m) + 2 * q + (e & 1)] = offA[m][e];
  }
#pragma unroll
  for (int m = 0; m < 2; ++m)
    if (32 * hc + lane + 64 * m < RT_K10_SUB * (RT_K10_SUB - 1) / 2)
      A[dt[m] * RT_K10_PF + ds[m]] = dg[m];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int e = 32 * hc + lane + 64 * m, tl = e >> 4, sl = e & 15;
    if (sl >= tl) A[(RT_K10_SUB * I + tl) * RT_K10_PF + RT_K10_SUB * I + sl] = 0.0f;
  }
  __syncthreads();

  // A v over the steps s < 16 (I + 1)
#pragma unroll
  for (int ks = 0; ks < 2 * (RT_K10_MAX / RT_K10_SUB); ++ks) {
    if (ks >= 2 * (I + 1)) break;
    rt_fa fa;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      rt_tf32_split(A[(tA + (e & 1 ? 8 : 0)) * RT_K10_PF + ks * 8 + q + (e & 2 ? 4 : 0)],
                    fa.hi[e], fa.lo[e]);
    rt_fb fb[4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        rt_tf32_split(rt_lds(Vs + (ks * 8 + q + (e ? 4 : 0)) * RT_K10_PB + 32 * hc + 8 * nt + g),
                      fb[nt].hi[e], fb[nt].lo[e]);
    rt_mma3<4, sizeof(IN) == 2>(acc, fa, fb);
  }

  // o = q S + A v + bonus v: a lane's two neighbouring columns j, j + 1 as
  // one store where o's layout allows (opair), else one at a time
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      const int t = tA + (e & 2 ? 8 : 0), j = 32 * hc + 8 * nt + 2 * q;
      if (t >= a.C || j >= a.dv) continue;
      const long long at = b * osb + h * osh + (t0 + t) * ost + j;
      const float v0 = acc[nt][e] + bonus[t] * rt_lds(Vs + t * RT_K10_PB + j);
      const float v1 = acc[nt][e + 1] + bonus[t] * rt_lds(Vs + t * RT_K10_PB + j + 1);
      if (out_bf16) {
        __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(o);
        if (opair) {
          *reinterpret_cast<__nv_bfloat162*>(ob + at) = __floats2bfloat162_rn(v0, v1);
        } else {
          rt_st(ob, at, v0);
          if (j + 1 < a.dv) rt_st(ob, at + 1, v1);
        }
      } else {
        float* of = static_cast<float*>(o);
        if (opair) {
          *reinterpret_cast<float2*>(of + at) = make_float2(v0, v1);
        } else {
          of[at] = v0;
          if (j + 1 < a.dv) of[at + 1] = v1;
        }
      }
    }
}

// -- entry points ---------------------------------------------------------------

static bool rt_k10_bad(int B, int H, int T, int C, int dk, int dv) {
  return B < 1 || H < 1 || T < 1 || C < 1 || dk < 1 || dv < 1 || C > RT_K10_MAX ||
         dk > RT_K10_MAX || dv > RT_K10_MAX || T % C;
}

// Whether the strides and pointers allow 16-byte copies of rows of itemsize
// values.
static bool rt_k10_aligned(int itemsize, std::initializer_list<long long> strides,
                           std::initializer_list<const void*> ptrs) {
  const int per = 16 / itemsize;
  for (long long s : strides)
    if (s % per) return false;
  for (const void* p : ptrs)
    if (reinterpret_cast<size_t>(p) % 16) return false;
  return true;
}

template <typename IN>
static int rt_k10_state(const rt_wkv_in& a, const float* s0, float* states, float* sT,
                        cudaStream_t stream) {
  const int smem = 2 * RT_K10_STAGE * (int)sizeof(IN) +
                   (RT_K10_MAX * RT_K10_PL + 32 * RT_K10_ST_WARPS) * (int)sizeof(float);
  static bool opted = false;  // once an instance (one device a process)
  if (!opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        rwkv6_state_kernel<IN>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted = true;
  }
  const long long blocks = (long long)a.B * a.H * ((a.dk + RT_K10_ST_DC - 1) / RT_K10_ST_DC);
  rwkv6_state_kernel<IN><<<(unsigned)blocks, 32 * RT_K10_ST_WARPS, smem, stream>>>(a, s0, states,
                                                                                   sT);
  RT_LAUNCH_RESULT();
}

template <typename IN>
static int rt_k10_output(const rt_wkv_in& a, const float* u, long long usb, long long ush,
                         const float* states, void* o, long long osb, long long osh,
                         long long ost, int out_bf16, cudaStream_t stream) {
  // pairs of o's values move as one store where every pair is aligned
  const int opair = a.dv % 2 == 0 && osb % 2 == 0 && osh % 2 == 0 && ost % 2 == 0 &&
                    reinterpret_cast<size_t>(o) % (out_bf16 ? 4 : 8) == 0;
  const int smem = rt_k10_out_smem<IN>();
  static bool opted = false;  // once an instance (one device a process)
  if (!opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        rwkv6_output_kernel<IN>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted = true;
  }
  const long long blocks = (long long)a.B * a.H * a.nc;
  rwkv6_output_kernel<IN><<<(unsigned)blocks, RT_K10_OUT_THREADS, smem, stream>>>(
      a, u, usb, ush, states, o, osb, osh, ost, out_bf16, opair);
  RT_LAUNCH_RESULT();
}

extern "C" {

// The state pass.  k, w: (B, H, T, dk) and v: (B, H, T, dv) at strides (sb,
// sh, st) and (vsb, vsh, vst) with d contiguous, fp32 or (in_bf16) bf16;
// s0: (B, H, dk, dv) fp32 contiguous, or null for zeros.  Writes states
// (B H, T / C, dk, dv), the state entering each chunk, and sT (B, H, dk,
// dv), fp32 contiguous.  Rows move as 16-byte copies where dk % 16 == 0,
// dv % 32 == 0 and the strides and pointers allow.  Returns
// cudaErrorInvalidValue unless 1 <= C, dk, dv <= 64 and C divides T, else
// the shared-memory opt-in's or the launch's error.
int rt_rwkv6_state(const void* k, const void* v, const void* w, const float* s0, float* states,
                   float* sT, int B, int H, int T, int C, int dk, int dv, long long sb,
                   long long sh, long long st, long long vsb, long long vsh, long long vst,
                   int in_bf16, cudaStream_t stream) {
  if (rt_k10_bad(B, H, T, C, dk, dv)) return static_cast<int>(cudaErrorInvalidValue);
  const int vec = dk % RT_K10_ST_DC == 0 && dv == 64 &&
                  rt_k10_aligned(in_bf16 ? 2 : 4, {sb, sh, st, vsb, vsh, vst}, {k, v, w});
  const rt_wkv_in a{nullptr, k, v, w, sb, sh, st, vsb, vsh, vst, B, H, C, dk, dv, T / C, vec};
  return in_bf16 ? rt_k10_state<__nv_bfloat16>(a, s0, states, sT, stream)
                 : rt_k10_state<float>(a, s0, states, sT, stream);
}

// The output pass.  r as k above; u: element (b, h, d) at b * usb + h * ush
// + d, fp32; states: the state pass's.  Writes o (B, H, T, dv) at strides
// (osb, osh, ost), d contiguous, fp32 or (out_bf16) bf16.  Rows move as
// 16-byte copies where C = dk = dv = 64 and the strides and pointers allow.
// Returns as rt_rwkv6_state.
int rt_rwkv6_output(const void* r, const void* k, const void* v, const void* w, const float* u,
                    const float* states, void* o, int B, int H, int T, int C, int dk, int dv,
                    long long sb, long long sh, long long st, long long vsb, long long vsh,
                    long long vst, long long usb, long long ush, long long osb, long long osh,
                    long long ost, int in_bf16, int out_bf16, cudaStream_t stream) {
  if (rt_k10_bad(B, H, T, C, dk, dv)) return static_cast<int>(cudaErrorInvalidValue);
  const int vec = C == RT_K10_MAX && dk == RT_K10_MAX && dv == RT_K10_MAX &&
                  rt_k10_aligned(in_bf16 ? 2 : 4, {sb, sh, st, vsb, vsh, vst}, {r, k, v}) &&
                  reinterpret_cast<size_t>(states) % 16 == 0;
  const rt_wkv_in a{r, k, v, w, sb, sh, st, vsb, vsh, vst, B, H, C, dk, dv, T / C, vec};
  return in_bf16 ? rt_k10_output<__nv_bfloat16>(a, u, usb, ush, states, o, osb, osh, ost,
                                                out_bf16, stream)
                 : rt_k10_output<float>(a, u, usb, ush, states, o, osb, osh, ost, out_bf16,
                                        stream);
}

}  // extern "C"
