// K2: per-component sum / max over all sites of a field, in two passes.
//
// Replaces the TPU kernel core/reduce.py::_reduce (inner kern :106,
// pallas_call :128).  That kernel initialises a (ncomp, vvl) accumulator at
// program 0 and read-modify-writes it from every later program, which is
// well defined only because a Pallas grid runs in order on one core.  Here:
//
//   pass 1  rt_reduce_partials: block (b, c) folds sites [b*block, (b+1)*block)
//           of component c, read at INDEX(c, s) in the field's layout
//           (SoA, AoS or AoSoA; common.cuh), and writes partials[b * ncomp + c];
//   pass 2  rt_reduce_fold: one block per component folds the partial rows
//           in a fixed order (strided per thread, then a fixed tree).
//
// No atomics: a fixed plan gives the same bits on every run, and max is
// exact whatever the order.  The fold does not depend on the layout: a
// block folds the same sites in the same order in every layout, so the
// sums are bitwise the SoA launch's.  Outside SoA (and AoSoA with SAL >= 32)
// a warp's loads are strided: ncomp floats apart under AoS.  The fused kernels (fused_flat.cu,
// wilson_normal.cu) write partial rows of the same shape and reuse pass 2.
//
// Bound on the H100: bytes.  Pass 1 reads each input element once (96 B a
// site for a 24-component field) and does one add per element; pass 2 reads
// nblocks * ncomp partials, under 1% of pass 1 at block 128.
//
// K2B, the batch instance (the reduction of a BatchedField, _reduce's batch
// grid axis :92-98): the same two kernels with the slot as one more grid
// axis (blockIdx.z in pass 1, blockIdx.y in pass 2).  Slot b's field and
// partial rows are offset by whole fields and whole partial tables, and
// nothing else in a block depends on the slot, so row b folds the same site
// blocks in the same order as the single launch on slot b: bitwise its
// sums.  The single entry points are the batch instance with one slot.
//
// K2's compensated instance (_reduce's accumulate branch, acc_dt / comp,
// :86-91, :140: a sum under a DtypePolicy whose accumulate slot resolves to
// compensated fp32), batched like K2B:
//
//   pass 1  rt_reduce_partials_comp: as rt_reduce_partials, but block (b, c)
//           folds its sites into a (hi, lo) pair (comp.cuh) and writes
//           partials[(b * ncomp + c) * 2 + {0, 1}];
//   pass 2  rt_reduce_fold_comp: one block per component and slot folds the
//           pairs, thread k those of blocks k, k + 256, ... in block order,
//           then the threads' pairs in a fixed tree; out[c] = hi.  The
//           wilson_normal kernel's policy instance (wilson_normal_mixed.cu)
//           writes pairs of the same shape and reuses it.
//
// The result is held to the fp64 sum of the same values (within a few fp32
// ulps of the sum), not bitwise to the reference's Kahan scan; it is the
// same bits on every run.  Bound: bytes, as the plain instance (pass 2 reads
// twice its bytes).

#include "comp.cuh"

#define RT_FOLD_THREADS 256

// Fold one value per thread over the block; the result is valid in thread 0.
__device__ __forceinline__ float rt_block_fold(float x, int op) {
  __shared__ float smem[RT_MAX_WARPS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  x = rt_warp_fold(x, op);
  if (lane == 0) smem[warp] = x;
  __syncthreads();
  float acc = smem[0];
  if (threadIdx.x == 0)
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w) acc = rt_combine(acc, smem[w], op);
  return acc;
}

template <int K>
__global__ void reduce_partials_kernel(const float* __restrict__ x, float* __restrict__ partials,
                                       int ncomp, long long nsites, int op, rt_layout lx) {
  const int c = blockIdx.y;
  x += blockIdx.z * (long long)ncomp * nsites;
  partials += blockIdx.z * (long long)gridDim.x * ncomp;
  const long long s = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const float v = s < nsites ? x[rt_at<K>(lx, c, s, ncomp, nsites)] : rt_identity(op);
  const float acc = rt_block_fold(v, op);
  if (threadIdx.x == 0) partials[(long long)blockIdx.x * ncomp + c] = acc;
}

__global__ void reduce_fold_kernel(const float* __restrict__ partials, float* __restrict__ out,
                                   long long nblocks, int ncomp, int op) {
  const int c = blockIdx.x;
  partials += blockIdx.y * nblocks * ncomp;
  out += blockIdx.y * (long long)ncomp;
  float acc = rt_identity(op);
  for (long long k = threadIdx.x; k < nblocks; k += blockDim.x)
    acc = rt_combine(acc, partials[k * ncomp + c], op);
  acc = rt_block_fold(acc, op);
  if (threadIdx.x == 0) out[c] = acc;
}

template <int K>
__global__ void reduce_partials_comp_kernel(const float* __restrict__ x,
                                            float* __restrict__ partials, int ncomp,
                                            long long nsites, rt_layout lx) {
  const int c = blockIdx.y;
  x += blockIdx.z * (long long)ncomp * nsites;
  partials += blockIdx.z * (long long)gridDim.x * ncomp * 2;
  const long long s = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const float v = s < nsites ? x[rt_at<K>(lx, c, s, ncomp, nsites)] : 0.0f;
  const rt_pair acc = rt_block_fold_pair(rt_pair{v, 0.0f});
  if (threadIdx.x == 0) {
    partials[((long long)blockIdx.x * ncomp + c) * 2] = acc.hi;
    partials[((long long)blockIdx.x * ncomp + c) * 2 + 1] = acc.lo;
  }
}

__global__ void reduce_fold_comp_kernel(const float* __restrict__ partials,
                                        float* __restrict__ out, long long nblocks, int ncomp) {
  const int c = blockIdx.x;
  partials += blockIdx.y * nblocks * ncomp * 2;
  out += blockIdx.y * (long long)ncomp;
  rt_pair acc{0.0f, 0.0f};
  for (long long k = threadIdx.x; k < nblocks; k += blockDim.x)
    acc = rt_pair_add(acc, rt_pair{partials[(k * ncomp + c) * 2],
                                   partials[(k * ncomp + c) * 2 + 1]});
  acc = rt_block_fold_pair(acc);
  if (threadIdx.x == 0) out[c] = acc.hi;
}

extern "C" {

// The compensated pass 1: x as rt_reduce_partials_batched; partials:
// (batch, ceil(nsites / block), ncomp, 2).
int rt_reduce_partials_comp(const float* x, float* partials, int ncomp, long long nsites,
                            int batch, int lx, int block, cudaStream_t stream) {
  const rt_layout L = rt_make_layout(lx);
  const int k = rt_launch_class(&L, 1);
  if (k < 0) return RT_BAD_LAYOUT;
  if (nsites == 0 || ncomp == 0 || batch == 0) return 0;
  const dim3 grid(rt_grid(nsites, block), ncomp, batch);
  RT_WITH_CLASS(k, reduce_partials_comp_kernel<RT_K><<<grid, block, 0, stream>>>(
                       x, partials, ncomp, nsites, L));
  RT_LAUNCH_RESULT();
}

// The compensated pass 2: partials (batch, nblocks, ncomp, 2) -> out (batch,
// ncomp).
int rt_reduce_fold_comp(const float* partials, float* out, long long nblocks, int ncomp,
                        int batch, cudaStream_t stream) {
  if (ncomp == 0 || batch == 0) return 0;
  reduce_fold_comp_kernel<<<dim3(ncomp, batch), RT_FOLD_THREADS, 0, stream>>>(partials, out,
                                                                            nblocks, ncomp);
  RT_LAUNCH_RESULT();
}

// x: batch fields of ncomp x nsites, one after another, each in layout lx
// (descriptor); partials: (batch, ceil(nsites / block), ncomp).
int rt_reduce_partials_batched(const float* x, float* partials, int ncomp, long long nsites,
                               int batch, int op, int lx, int block, cudaStream_t stream) {
  const rt_layout L = rt_make_layout(lx);
  const int k = rt_launch_class(&L, 1);
  if (k < 0) return RT_BAD_LAYOUT;
  if (nsites == 0 || ncomp == 0 || batch == 0) return 0;
  const dim3 grid(rt_grid(nsites, block), ncomp, batch);
  RT_WITH_CLASS(k, reduce_partials_kernel<RT_K><<<grid, block, 0, stream>>>(x, partials, ncomp,
                                                                          nsites, op, L));
  RT_LAUNCH_RESULT();
}

// partials: (batch, nblocks, ncomp) -> out: (batch, ncomp).
int rt_reduce_fold_batched(const float* partials, float* out, long long nblocks, int ncomp,
                           int batch, int op, cudaStream_t stream) {
  if (ncomp == 0 || batch == 0) return 0;
  reduce_fold_kernel<<<dim3(ncomp, batch), RT_FOLD_THREADS, 0, stream>>>(partials, out, nblocks,
                                                                         ncomp, op);
  RT_LAUNCH_RESULT();
}

// x: ncomp x nsites field in layout lx (descriptor); partials:
// (ceil(nsites / block), ncomp).
int rt_reduce_partials(const float* x, float* partials, int ncomp, long long nsites, int op,
                       int lx, int block, cudaStream_t stream) {
  return rt_reduce_partials_batched(x, partials, ncomp, nsites, 1, op, lx, block, stream);
}

// partials: (nblocks, ncomp) -> out: (ncomp,).
int rt_reduce_fold(const float* partials, float* out, long long nblocks, int ncomp, int op,
                   cudaStream_t stream) {
  return rt_reduce_fold_batched(partials, out, nblocks, ncomp, 1, op, stream);
}

}  // extern "C"
