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
// Common to both instances (bf16 and fp32):
// - Blocks.  One block owns one (batch, q head) and one q tile of 64 rows;
//   the kv loop runs inside the block (the TPU's sequential kv axis).  Query
//   head h reads kv head h / rep, so GQA never materialises the repeat.
// - Sweeps.  K11's whole k and v rows (1 MiB in bf16 at S 2048, dh 128)
//   do not fit the 227 KiB a block may have, so K11 keeps the TPU kernel's
//   arithmetic and streams the keys in tiles of 64: sweep 1 over the k tiles
//   finds each row's exact max, sweep 2 over the k and v tiles forms p, l
//   and p v, so p <= 1 and nothing is rescaled.  QK^T is computed twice.
//   K12 streams tiles of kvb keys (1 to 64) once.
// - Order.  The grid is (B H, q tiles), launched q tile by q tile, longest
//   causal rows first over every head, so the short tiles fill the tail.
// - Masks.  Both use the reference's NEG_INF = -1e30, a finite value, and
//   K12 starts m at -inf, as the TPU kernel does: a row whose keys in a
//   chunk are all masked gets m = -1e30 and p = 1 there, and the next
//   chunk with a key it sees wipes that with corr = exp(-1e30 - m) = 0.
//   Keys past S or past the tile's kvb keys do not exist and score -inf.
//   Tiles that no row of the q tile sees (past the last row's diagonal, or
//   before the first row's window) are skipped: they add exactly nothing in
//   K11, and in K12 their only effect is that wiped garbage, so the result
//   is the same function (the diagonal key of every row is always seen).
// - Sum order.  K12's kv tile is the largest divisor of S up to
//   min(kv_block, 64), the reference's kvb rule under a cap of 64, so its
//   rescaling points are the TPU kernel's only where kv_block <= 64; the
//   model path's kv_block 1024 runs tiles of 64 where the TPU kernel's are
//   1024.  K11's q and kv tiles do not change its function.
//
// The bf16 instance (rt_flash_mma_kernel), on the tensor cores:
// - Warps.  128 threads; warp w owns q rows 16 w .. 16 w + 15 of the tile.
//   The q tile's bf16 A fragments are loaded once with ldmatrix and stay in
//   registers (8 k steps x 4 registers at dh 128).  Every loop is unrolled
//   at compile time: the head size is padded to the instance's 32, 64 or
//   128, and every kv tile is held as 64 keys (K12's kvb keys, the rest
//   scoring -inf), so no mma waits on a runtime bound.
// - QK^T is mma.sync m16n8k16 (bf16 in, fp32 accumulate) over dh in steps
//   of 16, B the k tile read by ldmatrix (no .trans).  bf16 products are
//   exact in fp32, so the scores are fp32 dot products in the tensor
//   cores' sum order.  Scale (__fmul_rn, never contracted) and masks are
//   applied to the accumulators in registers.  Sweep 1 and sweep 2 run the
//   same fragments through the same mma order, so K11's scores are bitwise
//   the same in both and its max is exact.
// - Softmax in registers.  A quad of lanes holds a row pair (lane / 4 and
//   lane / 4 + 8); its max runs over the thread's columns, then over the
//   quad (shfl_xor 1, 2).  p = exp(s - m) and corr are 2^(x log2 e) on the
//   SFU (ex2.approx, relative error ~2^-22, against the one-ulp limit's
//   2^-8); s - m <= 0 keeps p <= 1.  l is a per-thread fp32 sum of p
//   (rescaled by K12's corr), folded over the quad at the end.
// - P.V.  The score accumulators of two n-tiles have the layout of the next
//   mma's A operand, so P never touches shared memory.  A bf16 p would miss
//   the card tests' limit (one bf16 ulp of o), so p = hi + lo with hi =
//   bf16(p), lo = bf16(p - hi) (p - hi is exact), and each 16-key step runs
//   acc += hi v, then acc += lo v, into the same fp32 accumulator; v is
//   exact in bf16 and read with ldmatrix.trans.
// - Copies.  k and v tiles are double-buffered with 16-byte cp.async.cg
//   (commit / wait_group 1): tile t + 1 is in flight while tile t computes;
//   K11's sweep 1 streams k alone and its last tile prefetches sweep 2's
//   first.  Shared-memory rows are 256 B with the 16-byte chunk index XORed
//   with row % 8, so ldmatrix's eight rows hit eight bank groups.  Tiles
//   are bf16: q, 2 k and 2 v tiles of 64 x 128, 81,920 B, two blocks an SM.
// - Ragged edges.  Head sizes are padded with zeros in shared memory
//   (cp.async's source size zero-fills past dh; the zeros add exact 0 to
//   QK^T and give output columns that are not stored), rows past S or past
//   the tile are zero, keys past them score -inf, so p = 0 there.  Rows of
//   q, k and v must start on 16 bytes: bases 16-byte aligned, batch, head
//   and row strides multiples of 8 elements (the wrapper raises otherwise).
//
// The fp32 instance (rt_flash_f32_kernel) runs on the CUDA cores: fp32 q.k
// products are not exact in bf16.  256 threads as a 16 x 16 grid; a thread
// owns the scores of rows ty + 16 i and keys tx + 16 j (4 x 4), read as
// float4 runs of fp32 q and k tiles (row lengths padded to 4 x an odd
// number of floats), and o at rows ty + 16 i, columns 4 tx + e and
// 64 + 4 tx + e; P is written over the k tile (101,376 B at dh 128).
//
// What bounds the bf16 instance (starcoder2-7b's heads: dh 128, rep 9,
// causal), the function's own work at the tests' limits, not this design's:
// - K11 at B 4 x S 2048 (BG 144, 302,137,344 seen pairs): q, k, v read and o
//   written once, 167.8 MB, 0.050 ms at 3.35 TB/s.  QK^T once (2 dh a pair)
//   and P.V as two bf16 passes (split p), 3 x 77.35 G = 232.0 G tensor-core
//   operations, 0.2346 ms at 989 TFLOP/s; the 302 M exps on the CUDA cores
//   do not bind.  So it is bound by the tensor cores.
// - K12 at B 1 x S 8192 (BG 36, 1,208,107,008 pairs): 167.8 MB; 927.8 G,
//   0.9381 ms.
// This design does 4/3 of that count in K11 (its exact-max sweep computes
// QK^T again) and issues mma.sync, a quarter of a warpgroup's tile at a
// time.  Left for later (ROADMAP): wgmma with TMA copies and a producer
// warp, 128-row q tiles, and skipping a warp's masked n-tiles on the
// diagonal.

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

#define RT_FA_BQ 64          // q rows a block
#define RT_FA_BK 64          // K11's kv tile, and the largest K12 takes
#define RT_FA_MAX_DH 128
#define RT_FA_NEG_INF (-1e30f)

struct RtFaArgs {
  int H, rep, S, dh, ld, causal, window, kvb;
  long long sqb, sqh, sqs, skb, skh, sks, svb, svh, svs, sob, soh, sos;
  float scale;
};

// The kv tiles holding a key that some row of the q tile at q0 sees.
__device__ __forceinline__ void rt_fa_tiles(const RtFaArgs& a, int q0, int kvb, int& t_begin,
                                            int& t_end) {
  const int q_last = min(q0 + RT_FA_BQ - 1, a.S - 1);
  const int k_end = a.causal ? q_last + 1 : a.S;
  const int k_begin = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  t_begin = k_begin / kvb;
  t_end = (k_end + kvb - 1) / kvb;
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core instance
// ---------------------------------------------------------------------------

#define RT_FM_THREADS 128          // 4 warps of 16 q rows
#define RT_FM_ROW 128              // bf16 a shared-memory row: 256 B, 16 chunks
#define RT_FM_TILE_BYTES (RT_FA_BK * RT_FM_ROW * 2)
#define RT_FM_SMEM (5 * RT_FM_TILE_BYTES)   // q, k x 2, v x 2: 81,920 B

// Byte offset of 16-byte chunk c of row r in a tile (swizzled).
__device__ __forceinline__ uint32_t rt_fm_off(int r, int c) {
  return static_cast<uint32_t>(r * (RT_FM_ROW * 2) + ((c ^ (r & 7)) << 4));
}

__device__ __forceinline__ void rt_cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void rt_cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void rt_cp_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void rt_ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void rt_ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// d += a b: one m16n8k16 product, bf16 in, fp32 accumulate.
__device__ __forceinline__ void rt_mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// p = hi + lo for a pair of p values (x the lower column, in the low
// half): hi = bf16(p), lo = bf16(p - hi), both rounded to nearest.
__device__ __forceinline__ void rt_split(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 r = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&r);
}

// e^x as 2^(x log2 e) on the SFU (ex2.approx, relative error ~2^-22;
// -inf and values below -126 / log2 e give 0).  x <= 0 gives at most 1.
__device__ __forceinline__ float rt_exp(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

__device__ __forceinline__ float rt_quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float rt_quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Rows r0 .. r0 + n - 1 (and < S) of a (S, dh) bf16 matrix with row
// stride srow into the tile at dst, chunks 0 .. 2 DK - 1; every byte past
// n, S or dh is zero.  Asynchronous: the caller commits the group.
template <int DK>
__device__ __forceinline__ void rt_fm_load(uint32_t dst, const __nv_bfloat16* __restrict__ src,
                                           long long srow, int r0, int n, int S, int dh) {
  // thread t copies chunk t % 16 of rows t / 16 + 8 i: a warp two whole rows
  const int c = threadIdx.x & 15;
  if (c >= 2 * DK) return;
  const int cbytes = min(16, max(0, 2 * (dh - 8 * c)));
#pragma unroll
  for (int i = 0; i < RT_FA_BK / 8; ++i) {
    const int r = (threadIdx.x >> 4) + 8 * i;
    const int bytes = r < n && r0 + r < S ? cbytes : 0;
    const __nv_bfloat16* g = bytes ? src + (long long)(r0 + r) * srow + 8 * c : src;
    rt_cp_async16(dst + rt_fm_off(r, c), g, bytes);
  }
}

// The warp's scores against the 64 keys of the k tile at ks: s[j][e] for
// keys 8 j + 2 (lane % 4) + e % 2 and rows lane / 4 + 8 (e / 2), scaled and,
// unless the tile is full, masked.  The mma order (k step outer, n-tile
// pair inner) is fixed.
template <int DK>
__device__ __forceinline__ void rt_fm_scores(float (&s)[8][4], const uint32_t (&qf)[DK][4],
                                             uint32_t ks, const RtFaArgs& a, int row0, int k0,
                                             int n, bool full) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < DK; ++kk) {
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      uint32_t b[4];
      rt_ldsm_x4(b, ks + rt_fm_off(16 * jp + (lane & 7) + ((lane >> 4) << 3),
                                   2 * kk + ((lane >> 3) & 1)));
      rt_mma(s[2 * jp], qf[kk], b[0], b[1]);
      rt_mma(s[2 * jp + 1], qf[kk], b[2], b[3]);
    }
  }
  if (full) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = __fmul_rn(s[j][e], a.scale);
    return;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qi = row0 + (lane >> 2) + 8 * (e >> 1);
      const int c = 8 * j + 2 * (lane & 3) + (e & 1), kj = k0 + c;
      const bool seen = (!a.causal || kj <= qi) && (a.window <= 0 || qi - kj < a.window);
      s[j][e] = (c >= n || kj >= a.S) ? -INFINITY
                : seen                ? __fmul_rn(s[j][e], a.scale)
                                      : RT_FA_NEG_INF;
    }
}

// ONLINE false: K11 (exact max, two sweeps, kv tiles of 64).
// ONLINE true: K12 (online softmax, one sweep, kv tiles of a.kvb keys held
// in tiles of 64, the keys past kvb scoring -inf).
// DK: head steps of 16 (the head size padded with zeros to 16 DK).
template <bool ONLINE, int DK>
__global__ void __launch_bounds__(RT_FM_THREADS, 2)
    rt_flash_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                        RtFaArgs a) {
  extern __shared__ __align__(128) unsigned char rt_fm_smem[];
  const uint32_t sQ = static_cast<uint32_t>(__cvta_generic_to_shared(rt_fm_smem));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nq = (a.S + RT_FA_BQ - 1) / RT_FA_BQ;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.y)) * RT_FA_BQ;  // longest rows first
  const int bh = blockIdx.x, b = bh / a.H, h = bh - b * a.H, g = h / a.rep;
  const __nv_bfloat16* qp = q + b * a.sqb + h * a.sqh;
  const __nv_bfloat16* kp = k + b * a.skb + g * a.skh;
  const __nv_bfloat16* vp = v + b * a.svb + g * a.svh;
  __nv_bfloat16* op = o + b * a.sob + h * a.soh;
  const int kvb = ONLINE ? a.kvb : RT_FA_BK;
  int t_begin, t_end;
  rt_fa_tiles(a, q0, kvb, t_begin, t_end);
  const int nt = t_end - t_begin, niter = ONLINE ? nt : 2 * nt;
  const int row0 = q0 + 16 * warp;
  const int q_last = min(q0 + RT_FA_BQ - 1, a.S - 1);

  // iteration it: K11's sweep 1 for it < nt (k alone), sweep 2 after
  // tile it's k and v in stage it % 2
  const auto k_tile = [&](int it) { return sQ + (1 + (it & 1)) * RT_FM_TILE_BYTES; };
  const auto v_tile = [&](int it) { return sQ + (3 + (it & 1)) * RT_FM_TILE_BYTES; };
  const auto load = [&](int it) {
    const int k0 = (t_begin + (ONLINE ? it : it % nt)) * kvb, n = min(kvb, a.S - k0);
    rt_fm_load<DK>(k_tile(it), kp, a.sks, k0, n, a.S, a.dh);
    if (ONLINE || it >= nt) rt_fm_load<DK>(v_tile(it), vp, a.svs, k0, n, a.S, a.dh);
  };
  rt_fm_load<DK>(sQ, qp, a.sqs, q0, RT_FA_BQ, a.S, a.dh);
  load(0);
  rt_cp_commit();

  uint32_t qf[DK][4];
  float acc[2 * DK][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
#pragma unroll
  for (int c = 0; c < 2 * DK; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.0f;

  for (int it = 0; it < niter; ++it) {
    if (it + 1 < niter) load(it + 1);
    rt_cp_commit();   // possibly empty: the group count stays uniform
    rt_cp_wait1();    // everything but the newest group: tile it is in
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < DK; ++kk)
        rt_ldsm_x4(qf[kk], sQ + rt_fm_off(16 * warp + (lane & 7) + (((lane >> 3) & 1) << 3),
                                          2 * kk + (lane >> 4)));
    }
    const int k0 = (t_begin + (ONLINE ? it : it % nt)) * kvb, n = min(kvb, a.S - k0);
    // no mask to apply: all 64 keys exist and every real row sees them
    const bool full = n == RT_FA_BK && (!a.causal || k0 + n - 1 <= q0) &&
                      (a.window <= 0 || q_last - k0 < a.window);
    float s[8][4];
    rt_fm_scores<DK>(s, qf, k_tile(it), a, row0, k0, n, full);

    if (!ONLINE && it < nt) {   // sweep 1: the thread's share of each row's max
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        m[0] = fmaxf(m[0], fmaxf(s[j][0], s[j][1]));
        m[1] = fmaxf(m[1], fmaxf(s[j][2], s[j][3]));
      }
    } else {
      if (ONLINE) {
        float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          mt[0] = fmaxf(mt[0], fmaxf(s[j][0], s[j][1]));
          mt[1] = fmaxf(mt[1], fmaxf(s[j][2], s[j][3]));
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float m_new = fmaxf(m[i], rt_quad_max(mt[i]));
          const float corr = rt_exp(m[i] - m_new);
          l[i] *= corr;
#pragma unroll
          for (int c = 0; c < 2 * DK; ++c) {
            acc[c][2 * i] *= corr;
            acc[c][2 * i + 1] *= corr;
          }
          m[i] = m_new;
        }
      } else if (it == nt) {   // sweep 1 is done: each row's exact max
        m[0] = rt_quad_max(m[0]);
        m[1] = rt_quad_max(m[1]);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = rt_exp(s[j][e] - m[e >> 1]);
          l[e >> 1] += s[j][e];
        }
      // acc += p v over the tile's 16-key steps: for each step and pair of
      // 8-column n-tiles, hi then lo into each accumulator
      const uint32_t vs = v_tile(it);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t hi[4], lo[4];
        rt_split(s[2 * kk][0], s[2 * kk][1], hi[0], lo[0]);
        rt_split(s[2 * kk][2], s[2 * kk][3], hi[1], lo[1]);
        rt_split(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[2], lo[2]);
        rt_split(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
        for (int cp = 0; cp < DK; ++cp) {
          uint32_t bv[4];
          rt_ldsm_x4_t(bv, vs + rt_fm_off(16 * kk + (lane & 7) + (((lane >> 3) & 1) << 3),
                                          2 * cp + (lane >> 4)));
          rt_mma(acc[2 * cp], hi, bv[0], bv[1]);
          rt_mma(acc[2 * cp + 1], hi, bv[2], bv[3]);
          rt_mma(acc[2 * cp], lo, bv[0], bv[1]);
          rt_mma(acc[2 * cp + 1], lo, bv[2], bv[3]);
        }
      }
    }
    __syncthreads();  // stage it % 2 is consumed before load(it + 2) refills it
  }

  const float li[2] = {rt_quad_sum(l[0]), rt_quad_sum(l[1])};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + (lane >> 2) + 8 * i;
    if (r >= a.S) continue;
    __nv_bfloat16* orow = op + r * a.sos;
#pragma unroll
    for (int c = 0; c < 2 * DK; ++c) {
      const int col = 8 * c + 2 * (lane & 3);
      if (col < a.dh) orow[col] = __float2bfloat16_rn(acc[c][2 * i] / li[i]);
      if (col + 1 < a.dh) orow[col + 1] = __float2bfloat16_rn(acc[c][2 * i + 1] / li[i]);
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: the CUDA-core instance
// ---------------------------------------------------------------------------

#define RT_FA_THREADS 256    // a 16 x 16 grid of threads
#define RT_FA_SIDE 16
#define RT_FA_LDP 80         // row length of P (rows 16 banks apart)

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
__device__ __forceinline__ void rt_fa_load(float* dst, const float* __restrict__ src,
                                           long long srow, int r0, int n, int S, int dh, int ld) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < RT_FA_BQ; r += RT_FA_THREADS / 32) {
    const bool ok = r < n && r0 + r < S;
    const float* row = src + (long long)(r0 + r) * srow;
    for (int d = lane; d < ld; d += 32) dst[r * ld + d] = (ok && d < dh) ? row[d] : 0.0f;
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

template <bool ONLINE>
__global__ void __launch_bounds__(RT_FA_THREADS, 2)
    rt_flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ o, RtFaArgs a) {
  extern __shared__ __align__(16) float rt_fa_smem[];
  const int ld = a.ld;
  float* Qs = rt_fa_smem;                                // (64, ld)
  float* Ks = Qs + RT_FA_BQ * ld;                        // (64, ld), then P (64, LDP)
  float* Vs = Ks + RT_FA_BQ * max(ld, RT_FA_LDP);        // (64, ld)
  float* Ps = Ks;
  const int tid = threadIdx.x, tx = tid % RT_FA_SIDE, ty = tid / RT_FA_SIDE;
  const int nq = (a.S + RT_FA_BQ - 1) / RT_FA_BQ;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.y)) * RT_FA_BQ;  // longest rows first
  const int bh = blockIdx.x, b = bh / a.H, h = bh - b * a.H, g = h / a.rep;
  const float* qp = q + b * a.sqb + h * a.sqh;
  const float* kp = k + b * a.skb + g * a.skh;
  const float* vp = v + b * a.svb + g * a.svh;
  float* op = o + b * a.sob + h * a.soh;
  const int kvb = ONLINE ? a.kvb : RT_FA_BK;
  int t_begin, t_end;
  rt_fa_tiles(a, q0, kvb, t_begin, t_end);

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
      if (col < a.dh) op[r * a.sos + col] = acc[i][c] / li;
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

static int rt_fa_ld(int dh) { return 4 * (((dh + 3) / 4) | 1); }

static int rt_fa_smem_bytes(int ld) {
  return static_cast<int>(sizeof(float)) * RT_FA_BQ * (2 * ld + (ld > RT_FA_LDP ? ld : RT_FA_LDP));
}

template <bool ONLINE>
static int rt_fa_launch_f32(const void* q, const void* k, const void* v, void* o, int B,
                            const RtFaArgs& a, cudaStream_t stream) {
  const int smem = rt_fa_smem_bytes(a.ld);
  static int smem_set = 0;
  if (const int e = rt_smem_optin(rt_flash_f32_kernel<ONLINE>, smem, smem_set)) return e;
  const dim3 grid(B * a.H, (a.S + RT_FA_BQ - 1) / RT_FA_BQ);
  rt_flash_f32_kernel<ONLINE><<<grid, RT_FA_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), a);
  RT_LAUNCH_RESULT();
}

template <bool ONLINE, int DK>
static int rt_fa_launch_mma(const void* q, const void* k, const void* v, void* o, int B,
                            const RtFaArgs& a, cudaStream_t stream) {
  static int smem_set = 0;
  if (const int e = rt_smem_optin(rt_flash_mma_kernel<ONLINE, DK>, RT_FM_SMEM, smem_set))
    return e;
  const dim3 grid(B * a.H, (a.S + RT_FA_BQ - 1) / RT_FA_BQ);
  rt_flash_mma_kernel<ONLINE, DK><<<grid, RT_FM_THREADS, RT_FM_SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), a);
  RT_LAUNCH_RESULT();
}

// Head sizes to 32, 64 and 128 (padded with zeros to the instance's).
template <bool ONLINE>
static int rt_fa_launch_bf16(const void* q, const void* k, const void* v, void* o, int B,
                             const RtFaArgs& a, cudaStream_t stream) {
  if (a.dh <= 32) return rt_fa_launch_mma<ONLINE, 2>(q, k, v, o, B, a, stream);
  if (a.dh <= 64) return rt_fa_launch_mma<ONLINE, 4>(q, k, v, o, B, a, stream);
  return rt_fa_launch_mma<ONLINE, 8>(q, k, v, o, B, a, stream);
}

// Whether a bf16 operand's rows start on 16 bytes (strides of extents 1
// are never used).
static bool rt_fa_rows16(const void* p, int nb, long long sb, int nh, long long sh,
                         long long ss) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && (nb < 2 || sb % 8 == 0) &&
         (nh < 2 || sh % 8 == 0) && ss % 8 == 0;
}

template <bool ONLINE>
static int rt_fa_entry(const void* q, const void* k, const void* v, void* o, int dtype, int B,
                       int H, int KV, int S, int dh, long long sqb, long long sqh, long long sqs,
                       long long skb, long long skh, long long sks, long long svb, long long svh,
                       long long svs, long long sob, long long soh, long long sos, int causal,
                       int window, float scale, int kvb, cudaStream_t stream) {
  if (B < 1 || H < 1 || KV < 1 || H % KV || S < 1 || dh < 1 || dh > RT_FA_MAX_DH ||
      (S + RT_FA_BQ - 1) / RT_FA_BQ > 65535 || kvb < 1 || kvb > RT_FA_BK)
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
    case 0: return rt_fa_launch_f32<ONLINE>(q, k, v, o, B, a, stream);
    case 1:
      if (!rt_fa_rows16(q, B, sqb, H, sqh, sqs) || !rt_fa_rows16(k, B, skb, KV, skh, sks) ||
          !rt_fa_rows16(v, B, svb, KV, svh, svs))
        return static_cast<int>(cudaErrorInvalidValue);
      return rt_fa_launch_bf16<ONLINE>(q, k, v, o, B, a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" {

// q: (B, H, S, dh) with strides (sqb, sqh, sqs, 1); k, v: (B, KV, S, dh)
// with theirs; o: (B, H, S, dh) with (sob, soh, sos, 1).  All of one dtype,
// 0 fp32 or 1 bf16; o in it.  Query head h reads kv head h / (H / KV).
// causal != 0 masks keys after the query; window > 0 masks keys window or
// more before it.  scale multiplies the fp32 dot products.  Returns
// cudaErrorInvalidValue unless 1 <= dh <= 128, KV divides H and S <= 64 x
// 65535 (and, for K12, 1 <= kvb <= 64), and, for bf16, q's, k's and v's rows
// start on 16 bytes (bases aligned, strides of extents above 1 multiples of
// 8); the launch's error otherwise.
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
