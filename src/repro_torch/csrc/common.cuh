// Shared helpers of the hand-written kernels: reduction monoids, the
// deterministic per-block fold that replaces the TPU's grid-sequential
// accumulator, and the layout addressing (INDEX) every lattice kernel
// loads and stores through.
//
// On the TPU a Pallas grid runs in order on one core, so the JAX package
// initialises an accumulator at program 0 and read-modify-writes it from
// every later program (core/reduce.py:106, core/fuse.py:2032).  CUDA blocks
// run concurrently in no order, so that idiom is a race here.  Every
// reduction in this library is instead two passes with no atomics: each
// block writes its own partial row, and a second kernel folds the rows in a
// fixed order (reduce.cu).  A fixed plan therefore gives the same bits on
// every run.
#pragma once

#include <cuda_runtime.h>

#define RT_OP_SUM 0
#define RT_OP_MAX 1
#define RT_MAX_WARPS 32  // 1024 threads per block at most

// max must propagate NaN, as jnp.max and torch.amax do: fmaxf (IEEE maxNum)
// returns the other operand when one is NaN, so a NaN site would vanish from
// its component's max (and an all-NaN component would give -inf).  PTX's
// max.NaN.f32 (sm_80+) returns the canonical NaN when either operand is
// NaN; the sum is a + b as before.
__device__ __forceinline__ float rt_max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float rt_combine(float a, float b, int op) {
  return op == RT_OP_MAX ? rt_max_nan(a, b) : a + b;
}

__device__ __forceinline__ float rt_identity(int op) {
  return op == RT_OP_MAX ? __int_as_float(0xff800000) : 0.0f;  // -inf or 0
}

// Fold a value across the 32 lanes of a warp (result in lane 0), always in
// the same tree order.  Every lane of the warp must take part.
__device__ __forceinline__ float rt_warp_fold(float x, int op) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = rt_combine(x, __shfl_down_sync(0xffffffffu, x, off), op);
  return x;
}

// Fold NCOMP per-thread values over the whole block and write the block's
// partial row, row[c] (the caller places the row: a table's row blockIdx.x,
// or the row of the sites the block computes).  blockDim.x must be a whole
// number of warps; threads without a site pass the identity.  Must be
// reached by every thread of the block.
template <int NCOMP>
__device__ __forceinline__ void rt_block_partials(const float (&v)[NCOMP], int op,
                                                  float* __restrict__ row) {
  __shared__ float smem[NCOMP * RT_MAX_WARPS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int c = 0; c < NCOMP; ++c) {
    const float x = rt_warp_fold(v[c], op);
    if (lane == 0) smem[c * RT_MAX_WARPS + warp] = x;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < NCOMP; c += blockDim.x) {
    float acc = smem[c * RT_MAX_WARPS];
    for (int w = 1; w < nwarps; ++w) acc = rt_combine(acc, smem[c * RT_MAX_WARPS + w], op);
    row[c] = acc;
  }
}

// -- layouts: targetDP's INDEX() macro ---------------------------------------
//
// A field of ncomp components over nsites sites is one contiguous fp32
// array; the layout says where component c of site s lies:
//
//   SoA    c * nsites + s
//   AoS    s * ncomp + c
//   AoSoA  (s / SAL) * ncomp * SAL + c * SAL + s % SAL
//
// The host passes each tensor's layout as one int (Layout.descriptor() in
// core/layout.py): kind | SAL << 2.  A kernel keeps one thread on one site
// (or one element) in every layout; only the address changes, so a block
// folds the same sites in the same order whatever the layout (K2 keeps one
// canonical fold order with two block shapes, reduce.cu).
//
// Every lattice kernel is a template on the launch's layout class K
// (rt_launch_class): RT_K_SOA, RT_K_AOS and RT_K_AOSOA when every tensor of
// the launch shares that layout (AoSoA with one power-of-two SAL, every SAL
// of the paper's sweeps, addressed by shifts), RT_K_ANY otherwise (mixed
// layouts, or a SAL that is not a power of two), where each tensor's
// rt_layout is read at run time.  The RT_K_SOA instantiation is the SoA
// address c * nsites + s alone.

#define RT_SOA 0
#define RT_AOS 1
#define RT_AOSOA 2

#define RT_K_SOA 0
#define RT_K_AOS 1
#define RT_K_AOSOA 2
#define RT_K_ANY 3

struct rt_layout {
  int kind;   // RT_SOA, RT_AOS or RT_AOSOA
  int sal;    // AoSoA's short-array length (1 otherwise)
  int shift;  // log2(sal) when sal is a power of two, else -1
};

// Decode a descriptor; kind 3 or an AoSoA SAL < 1 gives kind -1, which
// rt_launch_class refuses.
static inline rt_layout rt_make_layout(int desc) {
  rt_layout L;
  L.kind = desc & 3;
  L.sal = L.kind == RT_AOSOA ? (desc >> 2) : 1;
  L.shift = -1;
  if (L.kind == 3 || L.sal < 1) L.kind = -1;
  for (int k = 0; k < 31 && L.kind == RT_AOSOA; ++k)
    if ((1 << k) == L.sal) L.shift = k;
  return L;
}

static inline bool rt_same_layout(const rt_layout& a, const rt_layout& b) {
  return a.kind == b.kind && a.sal == b.sal;
}

// The layout class of a launch whose n tensors have layouts ls, or -1 when
// a descriptor names no layout.
static inline int rt_launch_class(const rt_layout* ls, int n) {
  for (int k = 0; k < n; ++k)
    if (ls[k].kind < 0) return -1;
  for (int k = 1; k < n; ++k)
    if (!rt_same_layout(ls[k], ls[0])) return RT_K_ANY;
  if (ls[0].kind == RT_SOA) return RT_K_SOA;
  if (ls[0].kind == RT_AOS) return RT_K_AOS;
  return ls[0].shift >= 0 ? RT_K_AOSOA : RT_K_ANY;
}

// Run the statement(s) with the compile-time constant RT_K set to the
// launch class k (an entry point's dispatch to its kernel's instantiation).
#define RT_WITH_CLASS(k, ...)                   \
  switch (k) {                                  \
    case RT_K_SOA: {                            \
      constexpr int RT_K = RT_K_SOA;            \
      __VA_ARGS__;                              \
    } break;                                    \
    case RT_K_AOS: {                            \
      constexpr int RT_K = RT_K_AOS;            \
      __VA_ARGS__;                              \
    } break;                                    \
    case RT_K_AOSOA: {                          \
      constexpr int RT_K = RT_K_AOSOA;          \
      __VA_ARGS__;                              \
    } break;                                    \
    default: {                                  \
      constexpr int RT_K = RT_K_ANY;            \
      __VA_ARGS__;                              \
    } break;                                    \
  }

// INDEX(comp, site) for any layout, read at run time.
__device__ __forceinline__ long long rt_index(const rt_layout& L, int c, long long s, int ncomp,
                                              long long nsites) {
  if (L.kind == RT_AOS) return s * ncomp + c;
  if (L.kind == RT_AOSOA) {
    if (L.shift >= 0) {
      const long long blk = s >> L.shift;
      return ((blk * ncomp + c) << L.shift) + (s & (L.sal - 1));
    }
    const long long blk = s / L.sal;
    return (blk * ncomp + c) * L.sal + (s - blk * L.sal);
  }
  return (long long)c * nsites + s;
}

template <typename T>
struct rt_same {
  typedef T type;
};

// INDEX(comp, site) in a launch of class K: the class's address with only
// the SAL's shift read at run time, or rt_index under RT_K_ANY.  Offsets
// are of type I: long long, or int in a kernel whose every offset fits one
// (I is named, never deduced).
template <int K, typename I = long long>
__device__ __forceinline__ I rt_at(const rt_layout& L, int c, typename rt_same<I>::type s,
                                   int ncomp, typename rt_same<I>::type nsites) {
  if (K == RT_K_SOA) return (I)c * nsites + s;
  if (K == RT_K_AOS) return s * ncomp + c;
  if (K == RT_K_AOSOA)
    return (((s >> L.shift) * ncomp + c) << L.shift) + (s & (((I)1 << L.shift) - 1));
  return (I)rt_index(L, c, s, ncomp, nsites);
}

// The inverse of INDEX: the (component, site) stored at flat offset i.
__device__ __forceinline__ void rt_coords(const rt_layout& L, long long i, int ncomp,
                                          long long nsites, int& c, long long& s) {
  if (L.kind == RT_AOS) {
    s = i / ncomp;
    c = (int)(i - s * ncomp);
  } else if (L.kind == RT_AOSOA) {
    long long t, lane;
    if (L.shift >= 0) {
      t = i >> L.shift;
      lane = i & (L.sal - 1);
    } else {
      t = i / L.sal;
      lane = i - t * L.sal;
    }
    const long long blk = t / ncomp;
    c = (int)(t - blk * ncomp);
    s = blk * L.sal + lane;
  } else {
    c = (int)(i / nsites);
    s = i - (long long)c * nsites;
  }
}

// Whether a pointer is 16-byte aligned (a float4's address).
static inline bool rt_aligned(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15ull) == 0;
}

// Opt a kernel in to smem bytes of dynamic shared memory (above 48 KB it
// must).  The opt-in only grows, so it is set once for the largest size
// seen (one device a process), smem_set the caller's record of it.
template <typename K>
static int rt_smem_optin(K kernel, int smem, int& smem_set) {
  if (smem <= smem_set) return 0;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  smem_set = smem;
  return 0;
}

// Blocks needed to give each of n items one thread.
static inline unsigned int rt_grid(long long n, int block) {
  return static_cast<unsigned int>((n + block - 1) / block);
}

// Returned by every C entry point: the launch's cudaGetLastError().
#define RT_LAUNCH_RESULT() return static_cast<int>(cudaGetLastError())

// Returned by an entry point for a descriptor that names no layout.
#define RT_BAD_LAYOUT static_cast<int>(cudaErrorInvalidValue)

// The coordinates, in the box grown by 1, of position r (< the ring's
// sites) of the ring of width 1 around an X Y Z box: the lo x face, then
// the hi one, each over the grown y and z; the y faces over the box's x
// range and the grown z; the z faces over the box's x and y ranges; in a
// face the later axes fastest (core/stencil.py::shell_order mirrors it).
template <typename I>
__device__ __forceinline__ int3 rt_shell3_site(int X, int Y, int Z, I r) {
  const int GY = Y + 2, GZ = Z + 2;
  const I fx = (I)GY * GZ, fy = (I)X * GZ, fz = (I)X * Y;
  if (r < 2 * fx) {
    const int gx = r < fx ? 0 : X + 1;
    const I q = r < fx ? r : r - fx;
    return make_int3(gx, (int)(q / GZ), (int)(q % GZ));
  }
  r -= 2 * fx;
  if (r < 2 * fy) {
    const int gy = r < fy ? 0 : Y + 1;
    const I q = r < fy ? r : r - fy;
    return make_int3(1 + (int)(q / GZ), gy, (int)(q % GZ));
  }
  r -= 2 * fy;
  const int gz = r < fz ? 0 : Z + 1;
  const I q = r < fz ? r : r - fz;
  return make_int3(1 + (int)(q / Y), 1 + (int)(q % Y), gz);
}
