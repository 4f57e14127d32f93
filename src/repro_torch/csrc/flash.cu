// K11 rt_flash and K12 rt_flash_kvchunk: GQA causal/windowed softmax
// attention.
//
// K11 replaces src/repro/kernels/flash_attention/kernel.py::flash_pallas
// (:47, pallas_call :71).  Its TPU grid is (BG, S/qb); each program holds
// its q block and the WHOLE k and v rows of its kv head in VMEM, forms the
// (qb, S) fp32 scores, takes each row's exact max, then p = exp(s - m),
// l = sum p and o = (p v) / l, with no rescaling.
// K12 replaces ::flash_pallas_kvchunk (:86, pallas_call :140): the same
// function with an online softmax.  Its grid (BG, S/qb, S/kvb) runs the kv
// axis in order on one core and carries acc (qb, dh), m and l (qb, 1) in
// VMEM scratch across it: m_new = max(m, rowmax s), p = exp(s - m_new),
// corr = exp(m - m_new), l = l corr + sum p, acc = acc corr + p v.
//
// Design for Hopper:
// - Blocks.  One block owns one (batch, q head) and one q tile of 64 rows;
//   the kv loop runs inside the block (the TPU's sequential kv axis).  Query
//   head h reads kv head h / rep, so GQA never materialises the repeat.
//   Tiles are launched longest causal rows first, so the short ones fill
//   the tail of the grid.
// - Shared memory.  K11's whole k and v rows (2 MiB in fp32 at S 2048,
//   dh 128) cannot sit in the 227 KiB a block may have, so K11 keeps the TPU
//   kernel's arithmetic and streams the keys in tiles of 64: sweep 1 over
//   the k tiles finds each row's exact max, sweep 2 over the k and v tiles
//   forms p, l and p v.  QK^T is computed twice.  K12 streams tiles of kvb
//   keys (1 to 64) once.  The q, k and v tiles are held in fp32, converted
//   from their own dtype (fp32 or bf16) as they are loaded: no copy of
//   the inputs is made.  Once a tile's scores are in registers, P is written
//   over the k tile; 101,376 B at dh 128, two blocks an SM.
// - Threads.  256 threads as a 16 x 16 grid.  A thread owns the scores of
//   rows ty + 16 i and keys tx + 16 j (4 x 4), read as float4 runs of q and
//   k rows; the row lengths are padded to 4 x an odd number of floats so
//   that the eight lanes of a 16-byte load hit eight bank groups.  It owns
//   o at rows ty + 16 i and columns 4 tx + e, 64 + 4 tx + e (4 x 8).  Row
//   maxima and sums run over the 16 lanes of a row with shuffles.
// - Masks.  Both use the reference's NEG_INF = -1e30, a finite value, and
//   K12 starts m at -inf, as the TPU kernel does: a row whose keys in a
//   chunk are all masked gets m = -1e30 and p = 1 there, and the next
//   chunk with a key it sees wipes that with corr = exp(-1e30 - m) = 0.
//   Keys past S (a ragged last tile) do not exist and score -inf.  Tiles
//   that no row of the q tile sees (past the last row's diagonal, or before
//   the first row's window) are skipped: they add exactly nothing in K11,
//   and in K12 their only effect is that wiped garbage, so the result is
//   the same function (the diagonal key of every row is always seen).
// - Sum order.  K12's kv tile is the largest divisor of S up to
//   min(kv_block, 64), the reference's kvb rule under a cap of 64, so its
//   rescaling points are the TPU kernel's only where kv_block <= 64; the
//   model path's kv_block 1024 runs tiles of 64 where the TPU kernel's are
//   1024.  K11's q and kv tiles do not change its function.
//
// What bounds it (starcoder2-7b's heads: dh 128, rep 9, causal, bf16), the
// function's own work, not this design's:
// - K11 at B 4 x S 2048 (BG 144): q, k, v read and o written once, 167.8 MB,
//   0.050 ms at 3.35 TB/s.  A causal pair costs 2 dh for QK^T, whose bf16
//   products are exact in fp32 and so may run on the tensor cores (77.3 G,
//   0.078 ms at 989 TFLOP/s), and 2 dh for p v with fp32 p plus one exp on
//   the CUDA cores (77.6 G, 1.16 ms at 67 TFLOP/s).
// - K12 at B 1 x S 8192 (BG 36): 167.8 MB; 309.3 G and 310.5 G, 4.63 ms.
// So both are bound by p v on the CUDA cores.  This simple design runs QK^T
// there too, K11 twice (its exact-max sweep); tensor cores (mma.sync or
// wgmma on bf16 tiles), TMA copies and whether K11 keeps two sweeps are
// later work (ROADMAP).

#include <cuda_bf16.h>
#include <math.h>

#include "common.cuh"

#define RT_FA_BQ 64          // q rows a block
#define RT_FA_BK 64          // K11's kv tile, and the largest K12 takes
#define RT_FA_THREADS 256    // a 16 x 16 grid of threads
#define RT_FA_SIDE 16
#define RT_FA_MAX_DH 128
#define RT_FA_LDP 80         // row length of P (rows 16 banks apart)
#define RT_FA_NEG_INF (-1e30f)

struct RtFaArgs {
  int H, rep, S, dh, ld, causal, window, kvb;
  long long sqb, sqh, sqs, skb, skh, sks, svb, svh, svs, sob, soh, sos;
  float scale;
};

__device__ __forceinline__ float rt_fa_f32(float x) { return x; }
__device__ __forceinline__ float rt_fa_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void rt_fa_put(float* p, float x) { *p = x; }
__device__ __forceinline__ void rt_fa_put(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float rt_fa_comp(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// Fold over the 16 lanes that hold one row's scores (a half warp).
__device__ __forceinline__ float rt_fa_row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float rt_fa_row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Rows r0 .. r0 + n - 1 of a (S, dh) matrix with row stride srow into a
// (64, ld) fp32 tile; rows past n or S and columns past dh are zero.  A
// warp a row, its lanes along the row.
template <typename T>
__device__ __forceinline__ void rt_fa_load(float* dst, const T* __restrict__ src, long long srow,
                                           int r0, int n, int S, int dh, int ld) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < RT_FA_BQ; r += RT_FA_THREADS / 32) {
    const bool ok = r < n && r0 + r < S;
    const T* row = src + (long long)(r0 + r) * srow;
    for (int d = lane; d < ld; d += 32) dst[r * ld + d] = (ok && d < dh) ? rt_fa_f32(row[d]) : 0.0f;
  }
}

// x[i][j] = scale * q_(q0 + ty + 16 i) . k_(k0 + tx + 16 j), masked: -1e30
// where the row does not see the key, -inf where the key does not exist
// (j >= n or past S).
__device__ __forceinline__ void rt_fa_scores(float (&x)[4][4], const float* Qs, const float* Ks,
                                             const RtFaArgs& a, int q0, int k0, int n, int ty,
                                             int tx) {
  const int ld = a.ld, dh4 = (a.dh + 3) & ~3;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) x[i][j] = 0.0f;
  for (int d = 0; d < dh4; d += 4) {
    float4 qa[4], kb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      qa[i] = *reinterpret_cast<const float4*>(Qs + (ty + RT_FA_SIDE * i) * ld + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      kb[j] = *reinterpret_cast<const float4*>(Ks + (tx + RT_FA_SIDE * j) * ld + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float s = x[i][j];
        s = fmaf(qa[i].x, kb[j].x, s);
        s = fmaf(qa[i].y, kb[j].y, s);
        s = fmaf(qa[i].z, kb[j].z, s);
        s = fmaf(qa[i].w, kb[j].w, s);
        x[i][j] = s;
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + RT_FA_SIDE * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + RT_FA_SIDE * j, kj = k0 + c;
      const bool seen = (!a.causal || kj <= qi) && (a.window <= 0 || qi - kj < a.window);
      x[i][j] = (c >= n || kj >= a.S) ? -INFINITY : seen ? x[i][j] * a.scale : RT_FA_NEG_INF;
    }
  }
}

// acc[i][c] += sum_j P[ty + 16 i][j] V[j][col c] over the tile's rows,
// col c = 4 tx + c for c < 4 and 64 + 4 tx + c - 4 after.
__device__ __forceinline__ void rt_fa_pv(float (&acc)[4][8], const float* Ps, const float* Vs,
                                         int ld, int dh, int n, int ty, int tx) {
  const int dh4 = (dh + 3) & ~3, c0 = 4 * tx, c1 = 64 + 4 * tx;
  const bool h0 = c0 < dh4, h1 = c1 < dh4;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const int n4 = (n + 3) & ~3;  // P and V are zero past the tile's keys
  for (int j = 0; j < n4; j += 4) {
    float4 pa[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      pa[i] = *reinterpret_cast<const float4*>(Ps + (ty + RT_FA_SIDE * i) * RT_FA_LDP + j);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float4 v0 = h0 ? *reinterpret_cast<const float4*>(Vs + (j + e) * ld + c0) : zero;
      const float4 v1 = h1 ? *reinterpret_cast<const float4*>(Vs + (j + e) * ld + c1) : zero;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = rt_fa_comp(pa[i], e);
        acc[i][0] = fmaf(p, v0.x, acc[i][0]);
        acc[i][1] = fmaf(p, v0.y, acc[i][1]);
        acc[i][2] = fmaf(p, v0.z, acc[i][2]);
        acc[i][3] = fmaf(p, v0.w, acc[i][3]);
        acc[i][4] = fmaf(p, v1.x, acc[i][4]);
        acc[i][5] = fmaf(p, v1.y, acc[i][5]);
        acc[i][6] = fmaf(p, v1.z, acc[i][6]);
        acc[i][7] = fmaf(p, v1.w, acc[i][7]);
      }
    }
  }
}

// ONLINE false: K11 (exact max, two sweeps, kv tiles of 64).
// ONLINE true: K12 (online softmax, one sweep, kv tiles of a.kvb).
template <typename T, bool ONLINE>
__global__ void __launch_bounds__(RT_FA_THREADS, 2)
    rt_flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    T* __restrict__ o, RtFaArgs a) {
  extern __shared__ __align__(16) float rt_fa_smem[];
  const int ld = a.ld;
  float* Qs = rt_fa_smem;                                // (64, ld)
  float* Ks = Qs + RT_FA_BQ * ld;                        // (64, ld), then P (64, LDP)
  float* Vs = Ks + RT_FA_BQ * max(ld, RT_FA_LDP);        // (64, ld)
  float* Ps = Ks;
  const int tid = threadIdx.x, tx = tid % RT_FA_SIDE, ty = tid / RT_FA_SIDE;
  const int nq = (a.S + RT_FA_BQ - 1) / RT_FA_BQ;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * RT_FA_BQ;  // longest rows first
  const int bh = blockIdx.y, b = bh / a.H, h = bh - b * a.H, g = h / a.rep;
  const T* qp = q + b * a.sqb + h * a.sqh;
  const T* kp = k + b * a.skb + g * a.skh;
  const T* vp = v + b * a.svb + g * a.svh;
  T* op = o + b * a.sob + h * a.soh;
  const int kvb = ONLINE ? a.kvb : RT_FA_BK;
  // the kv tiles holding a key that some row of this q tile sees
  const int q_last = min(q0 + RT_FA_BQ - 1, a.S - 1);
  const int k_end = a.causal ? q_last + 1 : a.S;
  const int k_begin = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  const int t_begin = k_begin / kvb, t_end = (k_end + kvb - 1) / kvb;

  rt_fa_load(Qs, qp, a.sqs, q0, RT_FA_BQ, a.S, a.dh, ld);

  float m[4], l[4], acc[4][8], x[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.0f;
  }

  if (!ONLINE) {  // sweep 1: each row's exact max over the keys it sees
    for (int t = t_begin; t < t_end; ++t) {
      const int k0 = t * kvb;
      __syncthreads();
      rt_fa_load(Ks, kp, a.sks, k0, kvb, a.S, a.dh, ld);
      __syncthreads();
      rt_fa_scores(x, Qs, Ks, a, q0, k0, kvb, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) m[i] = fmaxf(m[i], x[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) m[i] = rt_fa_row_max(m[i]);
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kvb, n = min(kvb, a.S - k0);
    __syncthreads();  // the previous tile's P and V are consumed
    rt_fa_load(Ks, kp, a.sks, k0, n, a.S, a.dh, ld);
    rt_fa_load(Vs, vp, a.svs, k0, n, a.S, a.dh, ld);
    __syncthreads();
    rt_fa_scores(x, Qs, Ks, a, q0, k0, n, ty, tx);
    __syncthreads();  // every read of the k tile is done before P overwrites it
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (ONLINE) {
        const float m_new = fmaxf(m[i], rt_fa_row_max(fmaxf(fmaxf(x[i][0], x[i][1]),
                                                            fmaxf(x[i][2], x[i][3]))));
        const float corr = expf(m[i] - m_new);
        float ps = 0.0f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          x[i][j] = expf(x[i][j] - m_new);
          ps += x[i][j];
        }
        l[i] = l[i] * corr + rt_fa_row_sum(ps);
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[i][c] *= corr;
        m[i] = m_new;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          x[i][j] = expf(x[i][j] - m[i]);
          l[i] += x[i][j];
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) Ps[(ty + RT_FA_SIDE * i) * RT_FA_LDP + tx + RT_FA_SIDE * j] = x[i][j];
    }
    __syncthreads();
    rt_fa_pv(acc, Ps, Vs, ld, a.dh, n, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float li = ONLINE ? l[i] : rt_fa_row_sum(l[i]);
    const int r = q0 + ty + RT_FA_SIDE * i;
    if (r >= a.S) continue;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = (c < 4 ? 0 : 64 - 4) + 4 * tx + c;
      if (col < a.dh) rt_fa_put(op + r * a.sos + col, acc[i][c] / li);
    }
  }
}

static int rt_fa_ld(int dh) { return 4 * (((dh + 3) / 4) | 1); }

static int rt_fa_smem_bytes(int ld) {
  return static_cast<int>(sizeof(float)) * RT_FA_BQ * (2 * ld + (ld > RT_FA_LDP ? ld : RT_FA_LDP));
}

template <typename T, bool ONLINE>
static int rt_fa_launch(const void* q, const void* k, const void* v, void* o, int B,
                        const RtFaArgs& a, cudaStream_t stream) {
  const int smem = rt_fa_smem_bytes(a.ld);
  // the opt-in only grows, so it is set once for the largest head size seen
  // (one device a process)
  static int smem_set = 0;
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        rt_flash_kernel<T, ONLINE>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = smem;
  }
  const dim3 grid((a.S + RT_FA_BQ - 1) / RT_FA_BQ, B * a.H);
  rt_flash_kernel<T, ONLINE><<<grid, RT_FA_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), a);
  RT_LAUNCH_RESULT();
}

template <bool ONLINE>
static int rt_fa_entry(const void* q, const void* k, const void* v, void* o, int dtype, int B,
                       int H, int KV, int S, int dh, long long sqb, long long sqh, long long sqs,
                       long long skb, long long skh, long long sks, long long svb, long long svh,
                       long long svs, long long sob, long long soh, long long sos, int causal,
                       int window, float scale, int kvb, cudaStream_t stream) {
  if (B < 1 || H < 1 || KV < 1 || H % KV || S < 1 || dh < 1 || dh > RT_FA_MAX_DH ||
      static_cast<long long>(B) * H > 65535 || kvb < 1 || kvb > RT_FA_BK)
    return static_cast<int>(cudaErrorInvalidValue);
  RtFaArgs a;
  a.H = H;
  a.rep = H / KV;
  a.S = S;
  a.dh = dh;
  a.ld = rt_fa_ld(dh);
  a.causal = causal;
  a.window = window;
  a.kvb = kvb;
  a.sqb = sqb; a.sqh = sqh; a.sqs = sqs;
  a.skb = skb; a.skh = skh; a.sks = sks;
  a.svb = svb; a.svh = svh; a.svs = svs;
  a.sob = sob; a.soh = soh; a.sos = sos;
  a.scale = scale;
  switch (dtype) {
    case 0: return rt_fa_launch<float, ONLINE>(q, k, v, o, B, a, stream);
    case 1: return rt_fa_launch<__nv_bfloat16, ONLINE>(q, k, v, o, B, a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" {

// q: (B, H, S, dh) with strides (sqb, sqh, sqs, 1); k, v: (B, KV, S, dh)
// with theirs; o: (B, H, S, dh) with (sob, soh, sos, 1).  All of one dtype,
// 0 fp32 or 1 bf16; o in it.  Query head h reads kv head h / (H / KV).
// causal != 0 masks keys after the query; window > 0 masks keys window or
// more before it.  scale multiplies the fp32 dot products.  Returns
// cudaErrorInvalidValue unless 1 <= dh <= 128, KV divides H and B H <= 65535
// (and, for K12, 1 <= kvb <= 64), and the launch's error otherwise.
int rt_flash(const void* q, const void* k, const void* v, void* o, int dtype, int B, int H,
             int KV, int S, int dh, long long sqb, long long sqh, long long sqs, long long skb,
             long long skh, long long sks, long long svb, long long svh, long long svs,
             long long sob, long long soh, long long sos, int causal, int window, float scale,
             cudaStream_t stream) {
  return rt_fa_entry<false>(q, k, v, o, dtype, B, H, KV, S, dh, sqb, sqh, sqs, skb, skh, sks,
                            svb, svh, svs, sob, soh, sos, causal, window, scale, RT_FA_BK,
                            stream);
}

int rt_flash_kvchunk(const void* q, const void* k, const void* v, void* o, int dtype, int B,
                     int H, int KV, int S, int dh, long long sqb, long long sqh, long long sqs,
                     long long skb, long long skh, long long sks, long long svb, long long svh,
                     long long svs, long long sob, long long soh, long long sos, int causal,
                     int window, float scale, int kvb, cudaStream_t stream) {
  return rt_fa_entry<true>(q, k, v, o, dtype, B, H, KV, S, dh, sqb, sqh, sqs, skb, skh, sks,
                           svb, svh, svs, sob, soh, sos, causal, window, scale, kvb, stream);
}

}  // extern "C"
