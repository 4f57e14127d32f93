// K10 rt_rwkv6_wkv: the RWKV6 chunked WKV recurrence.
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
// Design for Hopper:
// - Blocks.  Hopper's blocks run at once and in no order, so the chunk axis
//   is a loop inside the block: one block owns one (b, h) and keeps S in
//   shared memory for the whole sequence.
// - Shared memory.  Each chunk's r, k, v and log w tiles are loaded into
//   shared memory, where L and Lprev are formed (a thread a column d adds
//   down the chunk).  q = r exp(Lprev) then takes r's place and
//   kd = k exp(L_C - L) takes k's.  The (C, C, dk) pairwise tensor of the
//   reference never exists: each A[t, s] is summed over d in registers and
//   only the (C, C) matrix A is kept.  116,736 B at C = dk = dv = 64, over
//   the 48 KiB default, so the entry point opts in; one block an SM.
// - Threads.  256 threads as a 16 x 16 grid; each owns a 4 x 4 register
//   tile of A, of o and of the state update, at rows ty + 16 i and columns
//   tx + 16 j, and reads 8 shared values for 16 products.  Rows of the
//   (C, dk) tiles and of A are padded to an odd length, so the two rows a
//   warp reads fall in different banks.  Out-of-range rows and columns
//   (C, dk or dv under 64) read a clamped index and write nothing.
// - Causality.  Pairs s >= t are masked in the reference after they are
//   computed; the clamp keeps them finite, so skipping them gives the same
//   function.  A warp's tile block (i, j) with j > i holds only such pairs
//   and is skipped; the rest write A = 0 for s >= t.
// - Limits.  C, dk and dv are runtime values from 1 to 64; T a multiple of C.
//
// What bounds it (B 4, H 64, T 2048, C = dk = dv = 64: BH 256, 8,192 chunks):
// - bytes: r, k, v, w read and o written once (134.2 MB each), u, s0, sT:
//   679.5 MB, 0.203 ms at 3.35 TB/s;
// - fp32 operations a chunk, each exp and log counted as one: q S and kd^T v
//   2 C dk dv each, A 6 dk a causal pair (C (C-1) / 2 pairs: a difference, a
//   min, an exp, two products, a sum), A v 2 dv a pair, 11 C dk elementwise:
//   2.15 M, 17.6 G in all, 0.262 ms at 67 TFLOP/s;
// - of them exponentials and logarithms, dk a causal pair plus 3 C dk: 141 k
//   a chunk, 1.16 G in all, ~0.28 ms at 16 a clock an SM (1.98 GHz).
// So it is bound by arithmetic, not bytes, and by the exponentials as much as
// the products.  This simple design uses no tensor cores, keeps one block an
// SM (two waves of blocks at BH 256), does not overlap the chunk's loads with
// its arithmetic, and runs the cumulative sum on dk threads; ROADMAP lists
// the next steps (bf16 reads, a dv split across blocks, tensor cores).

#include "common.cuh"

#define RT_K10_MAX 64       // C, dk and dv may each be 1 .. RT_K10_MAX
#define RT_K10_THREADS 256  // a 16 x 16 grid of threads
#define RT_K10_SIDE 16
#define RT_K10_TILE 4       // RT_K10_SIDE * RT_K10_TILE == RT_K10_MAX

// Floats of dynamic shared memory a block needs.
static long long rt_k10_smem_floats(int C, int dk, int dv) {
  const int P = dk | 1, PA = C | 1;
  return (long long)dk * dv + 4LL * C * P + (long long)C * dv + (long long)C * PA + C + dk + dk;
}

__global__ void __launch_bounds__(RT_K10_THREADS)
    rwkv6_wkv_kernel(const float* __restrict__ r, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ w,
                     const float* __restrict__ u, const float* __restrict__ s0,
                     float* __restrict__ o, float* __restrict__ sT, int T, int C, int dk,
                     int dv) {
  extern __shared__ float rt_k10_smem[];
  const int P = dk | 1;   // row length of the (C, dk) tiles
  const int PA = C | 1;   // row length of A
  float* S = rt_k10_smem;       // (dk, dv), row length dv
  float* rq = S + dk * dv;      // r, then q = r exp(Lprev)
  float* kk = rq + C * P;       // k, then kd = k exp(L_C - L)
  float* Lc = kk + C * P;       // L
  float* Lp = Lc + C * P;       // log w, then Lprev
  float* vv = Lp + C * P;       // (C, dv), row length dv
  float* A = vv + C * dv;       // (C, C), row length PA
  float* rku = A + C * PA;      // sum_d r u k, a row
  float* Llast = rku + C;       // L_C
  float* us = Llast + dk;       // u

  const long long bh = blockIdx.x;
  const int tid = threadIdx.x;
  const int tx = tid % RT_K10_SIDE;
  const int ty = tid / RT_K10_SIDE;

  for (int i = tid; i < dk * dv; i += RT_K10_THREADS) S[i] = s0[bh * dk * dv + i];
  for (int i = tid; i < dk; i += RT_K10_THREADS) us[i] = u[bh * dk + i];

  for (int c0 = 0; c0 < T; c0 += C) {
    const long long offk = (bh * T + c0) * dk;
    const long long offv = (bh * T + c0) * dv;
    __syncthreads();  // the previous chunk is done with rq, kk, vv and S
    for (int i = tid; i < C * dk; i += RT_K10_THREADS) {
      const int t = i / dk, d = i - t * dk;
      rq[t * P + d] = r[offk + i];
      kk[t * P + d] = k[offk + i];
      Lp[t * P + d] = logf(fmaxf(w[offk + i], 1e-26f));
    }
    for (int i = tid; i < C * dv; i += RT_K10_THREADS) vv[i] = v[offv + i];
    __syncthreads();

    // L = cumsum(log w) down each column, Lprev = L - log w
    if (tid < dk) {
      float acc = 0.0f;
      for (int t = 0; t < C; ++t) {
        const float lw = Lp[t * P + tid];
        acc += lw;
        Lc[t * P + tid] = acc;
        Lp[t * P + tid] = acc - lw;
      }
      Llast[tid] = acc;
    }
    __syncthreads();

    // A[t, s] for the causal pairs (0 elsewhere), and the bonus row sums
    {
      float acc[RT_K10_TILE][RT_K10_TILE];
#pragma unroll
      for (int i = 0; i < RT_K10_TILE; ++i)
#pragma unroll
        for (int j = 0; j < RT_K10_TILE; ++j) acc[i][j] = 0.0f;
      for (int d = 0; d < dk; ++d) {
        float rt[RT_K10_TILE], lpt[RT_K10_TILE], ks[RT_K10_TILE], lcs[RT_K10_TILE];
#pragma unroll
        for (int i = 0; i < RT_K10_TILE; ++i) {
          const int t = min(ty + RT_K10_SIDE * i, C - 1);
          rt[i] = rq[t * P + d];
          lpt[i] = Lp[t * P + d];
        }
#pragma unroll
        for (int j = 0; j < RT_K10_TILE; ++j) {
          const int s = min(tx + RT_K10_SIDE * j, C - 1);
          ks[j] = kk[s * P + d];
          lcs[j] = Lc[s * P + d];
        }
#pragma unroll
        for (int i = 0; i < RT_K10_TILE; ++i)
#pragma unroll
          for (int j = 0; j <= i; ++j)  // j > i: s > t for every pair of the block
            acc[i][j] += rt[i] * expf(fminf(lpt[i] - lcs[j], 0.0f)) * ks[j];
      }
#pragma unroll
      for (int i = 0; i < RT_K10_TILE; ++i) {
        const int t = ty + RT_K10_SIDE * i;
#pragma unroll
        for (int j = 0; j < RT_K10_TILE; ++j) {
          const int s = tx + RT_K10_SIDE * j;
          if (t < C && s < C) A[t * PA + s] = (j <= i && s < t) ? acc[i][j] : 0.0f;
        }
      }
      if (tid < C) {
        float b = 0.0f;
        for (int d = 0; d < dk; ++d) b += rq[tid * P + d] * us[d] * kk[tid * P + d];
        rku[tid] = b;
      }
    }
    __syncthreads();

    // q = r exp(Lprev) in r's place, kd = k exp(L_C - L) in k's
    for (int i = tid; i < C * dk; i += RT_K10_THREADS) {
      const int t = i / dk, d = i - t * dk;
      rq[t * P + d] *= expf(Lp[t * P + d]);
      kk[t * P + d] *= expf(Llast[d] - Lc[t * P + d]);
    }
    __syncthreads();

    // o = q S + A v + rku v
    {
      float inter[RT_K10_TILE][RT_K10_TILE], intra[RT_K10_TILE][RT_K10_TILE];
#pragma unroll
      for (int i = 0; i < RT_K10_TILE; ++i)
#pragma unroll
        for (int j = 0; j < RT_K10_TILE; ++j) inter[i][j] = intra[i][j] = 0.0f;
      for (int d = 0; d < dk; ++d) {
        float qt[RT_K10_TILE], sj[RT_K10_TILE];
#pragma unroll
        for (int i = 0; i < RT_K10_TILE; ++i)
          qt[i] = rq[min(ty + RT_K10_SIDE * i, C - 1) * P + d];
#pragma unroll
        for (int j = 0; j < RT_K10_TILE; ++j)
          sj[j] = S[d * dv + min(tx + RT_K10_SIDE * j, dv - 1)];
#pragma unroll
        for (int i = 0; i < RT_K10_TILE; ++i)
#pragma unroll
          for (int j = 0; j < RT_K10_TILE; ++j) inter[i][j] += qt[i] * sj[j];
      }
      // A[t, s] = 0 for s >= t, so s stops at this thread's last row
      const int s_end = min(ty + RT_K10_SIDE * (RT_K10_TILE - 1), C - 1);
      for (int s = 0; s < s_end; ++s) {
        float at[RT_K10_TILE], vs[RT_K10_TILE];
#pragma unroll
        for (int i = 0; i < RT_K10_TILE; ++i)
          at[i] = A[min(ty + RT_K10_SIDE * i, C - 1) * PA + s];
#pragma unroll
        for (int j = 0; j < RT_K10_TILE; ++j)
          vs[j] = vv[s * dv + min(tx + RT_K10_SIDE * j, dv - 1)];
#pragma unroll
        for (int i = 0; i < RT_K10_TILE; ++i)
#pragma unroll
          for (int j = 0; j < RT_K10_TILE; ++j) intra[i][j] += at[i] * vs[j];
      }
#pragma unroll
      for (int i = 0; i < RT_K10_TILE; ++i) {
        const int t = ty + RT_K10_SIDE * i;
#pragma unroll
        for (int j = 0; j < RT_K10_TILE; ++j) {
          const int jj = tx + RT_K10_SIDE * j;
          if (t < C && jj < dv)
            o[offv + (long long)t * dv + jj] =
                (inter[i][j] + intra[i][j]) + rku[t] * vv[t * dv + jj];
        }
      }
    }
    __syncthreads();  // every reader of S is done

    // S <- exp(L_C) S + kd^T v; each thread updates its own entries
    {
      float acc[RT_K10_TILE][RT_K10_TILE];
#pragma unroll
      for (int i = 0; i < RT_K10_TILE; ++i)
#pragma unroll
        for (int j = 0; j < RT_K10_TILE; ++j) acc[i][j] = 0.0f;
      for (int s = 0; s < C; ++s) {
        float kd[RT_K10_TILE], vs[RT_K10_TILE];
#pragma unroll
        for (int i = 0; i < RT_K10_TILE; ++i)
          kd[i] = kk[s * P + min(ty + RT_K10_SIDE * i, dk - 1)];
#pragma unroll
        for (int j = 0; j < RT_K10_TILE; ++j)
          vs[j] = vv[s * dv + min(tx + RT_K10_SIDE * j, dv - 1)];
#pragma unroll
        for (int i = 0; i < RT_K10_TILE; ++i)
#pragma unroll
          for (int j = 0; j < RT_K10_TILE; ++j) acc[i][j] += kd[i] * vs[j];
      }
#pragma unroll
      for (int i = 0; i < RT_K10_TILE; ++i) {
        const int d = ty + RT_K10_SIDE * i;
        if (d >= dk) continue;
        const float decay = expf(Llast[d]);
#pragma unroll
        for (int j = 0; j < RT_K10_TILE; ++j) {
          const int jj = tx + RT_K10_SIDE * j;
          if (jj < dv) S[d * dv + jj] = decay * S[d * dv + jj] + acc[i][j];
        }
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < dk * dv; i += RT_K10_THREADS) sT[bh * dk * dv + i] = S[i];
}

extern "C" {

// r, k, w: (BH, T, dk); v: (BH, T, dv); u: (BH, dk); s0: (BH, dk, dv); all
// fp32, contiguous.  Writes o (BH, T, dv) and sT (BH, dk, dv).  Returns
// cudaErrorInvalidValue unless 1 <= C, dk, dv <= 64 and C divides T, and the
// error of the shared-memory opt-in or of the launch otherwise.
int rt_rwkv6_wkv(const float* r, const float* k, const float* v, const float* w,
                 const float* u, const float* s0, float* o, float* sT, int BH, int T, int C,
                 int dk, int dv, cudaStream_t stream) {
  if (BH < 1 || T < 1 || C < 1 || dk < 1 || dv < 1 || C > RT_K10_MAX || dk > RT_K10_MAX ||
      dv > RT_K10_MAX || T % C)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(rt_k10_smem_floats(C, dk, dv) * sizeof(float));
  // the opt-in only grows, so it is set once for the largest tile seen
  // (one device a process)
  static int smem_set = 0;
  if (smem > smem_set) {
    const cudaError_t e =
        cudaFuncSetAttribute(rwkv6_wkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = smem;
  }
  rwkv6_wkv_kernel<<<BH, RT_K10_THREADS, smem, stream>>>(r, k, v, w, u, s0, o, sT, T, C, dk, dv);
  RT_LAUNCH_RESULT();
}

}  // extern "C"
