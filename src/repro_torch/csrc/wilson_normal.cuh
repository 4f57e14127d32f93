// The two kernels of K5, the fused normal operator of the CG solve,
//
//   wilson_normal_t_kernel   t  = g5(p - kappa D p)       (scratch, SoA, fp32)
//   wilson_normal_ap_kernel  ap = g5(t - kappa D t)       (= M^dag M p)
//                            and the per-block partials of pap[c] = p[c] . ap[c]
//
// shared by the policy-free instance (wilson_normal.cu) and the DtypePolicy
// instance (wilson_normal_mixed.cu), each of which instantiates its own
// flags.  Template flags, all off in the policy-free instance:
//
//   SB     the slots a thread computes, one link load for all of them
//          (K5B: a group of RT_NORMAL_SLOTS; 1 for K5, and for K5B's policy
//          instance; rt_order); p, t, ap and the partials offset to each
//          slot.
//   I      the type of sites and offsets inside a slot's fields: int where
//          every one fits (72 V < 2^31 values of u), else long long.
//   RB     round every load of p to bf16 and widen it back in registers
//          (the stage-in of a bf16-storage policy; bf16.cuh), and of u
//          where u is fp32.  t is never rounded: the reference keeps it in
//          VMEM in fp32.
//   TU     u's storage type: float, or __nv_bfloat16 under a bf16-storage
//          policy, whose operator rounds u once (apps/milc/cg.py::
//          make_fused_normal) to the values the rounding at every load
//          gave: the same bits, and 144 fewer bytes a site a launch.
//   TAP    ap's storage type (float, or __nv_bfloat16 under a bf16
//          storage policy).  pap takes ap in fp32, before the write's
//          rounding, as the reference refolds its reduction's fp32 source.
//   COMP   write pap's partials as compensated (hi, lo) pairs (comp.cuh)
//          for reduce.cu's compensated pass 2; the product that feeds a
//          pair is __fmul_rn, so nvcc cannot contract it into the pair's
//          adds.
//
// With every flag off the kernels compile to the policy-free code: RB's
// rounding and COMP's branch are compile-time, and rt_st to a float is a
// plain store.  K5T, the tiled plan's instance, is the same kernels with
// a walk in their block order (rt_walk, set at run time: no instantiation
// of its own).  Both kernels run their blocks in the order of rt_order
// (below) and address a slot's fields with 32-bit offsets where they fit.
#pragma once

#include "comp.cuh"
#include "wilson.cuh"

#define RT_BRICK_X 16   // x-planes of a brick of the block order
#define RT_NORMAL_SLOTS 2   // K5B: the slots a thread computes, one link load for all
#define RT_NORMAL_SLOTS_POLICY 1   // K5B's policy instance: one slot a thread
#define RT_NORMAL_MAX_BLOCK 1024

__device__ __forceinline__ float rt_g5_sign(int c) { return c >= 12 ? -1.0f : 1.0f; }

// t's layout: SoA, in every instantiation.
__device__ __forceinline__ rt_layout rt_soa() { return rt_layout{RT_SOA, 1, -1}; }

// The block order of both kernels.  A block computes one chunk of vvl
// (blockDim.x) consecutive sites and writes its partial row at the chunk's
// index, so the sites it folds, their order and the partial table do not
// depend on the order (they are the linear order's); only which chunk a
// linear block index takes does.  With nq chunks in an x-plane
// (nq = Y Z T / vvl where vvl divides Y Z T; else 0 and the chunks run in
// linear order, as they do under AoS, where the brick order measured 8%
// slower than the linear one at (64, 64, 64, 32)), linear block i takes
//
//   group = i % groups                         (K5B's slot groups of a chunk
//   j     = i / groups                          together; 1 group for K5)
//   brick = j / (RT_BRICK_X nq)                (RT_BRICK_X x-planes a brick;
//   w     = min(RT_BRICK_X, X - RT_BRICK_X brick)   the last one may be thinner)
//   r     = j - RT_BRICK_X nq brick
//   chunk = (RT_BRICK_X brick + r % w) nq + r / w
//
// x runs fastest inside a brick, then the chunks of an x-plane (z and t
// within a y-row, then y), then the next brick.  A site is read again as an
// x-neighbour one block later, as a z-neighbour about RT_BRICK_X blocks
// later, as a y-neighbour RT_BRICK_X Z T / vvl blocks later (256 at
// (64, 64, 64, 32), vvl 128: ~16 MB of traffic, inside the 50 MB L2),
// where the linear order re-reads an x-neighbour Y Z T sites later (~63
// MB there).  Only the x-faces of a brick are re-read from device memory.
// kernels/wilson_dslash/kernel.py::block_chunks mirrors this map.
//
// K5B: a thread computes its site for a group of SB slots (RT_NORMAL_SLOTS;
// the last group may hold fewer), loading each link once for all of them
// (rt_wilson_hop, wilson.cuh).  One slot a block read u once a slot,
// and at 4 slots took 3.9x K5's time on an H100 even with the slots of a
// chunk next to each other in the order, the links then coming from L2.
// At 4 slots of (64, 64, 64, 32) (tools/k5_slots.py, H100 80GB HBM3,
// 700 W) one slot a thread took 18.0 ms, two 14.35 ms (168 registers), four
// 35.5 ms (242 registers: too few warps a multiprocessor), hence 2.  The
// policy instance (RB, COMP, a bf16 u) took 24.35 ms at two slots a thread
// against 17.54 at one (chip_smoke.py Q3, two runs on H100 80GB HBM3,
// 700 W), hence RT_NORMAL_SLOTS_POLICY.  Each slot's adds are K5's, in its
// order, so each slot is bitwise the one-slot launch (SB = 1).  A lattice
// with 72 V >= 2^31 takes the 64-bit instantiation, one slot a thread.
// K5T: the tiled plan's walk (rt_order.w, bx 0 for the untiled order).
// As a template flag it doubled the kernels' instances in both translation
// units and took the library's build past 200 s on the H100's machine; set
// at run time it costs one uniform branch a thread.  Under a plan with tiles (bx, by, bz)
// (T whole) the sites are walked in the reference's grid order, tile
// t = (i nty + j) ntz + k (x-slab outermost, z-tile fastest), and in a
// tile x, y, z, then t fastest; block q of a slot group takes the `block`
// consecutive walk positions [q block, (q + 1) block), one a thread, and
// writes its partial row at q, so K2's fold adds the rows in walk order.
// Each site's hop is K5's (the same adds whatever the order), so t and ap
// are bitwise K5's; pap's fold follows the walk, and equals K5's bitwise
// where the walk is the linear order (bx = 1 with z whole, or by = bz = 1:
// the budget's finest tile at (64, 64, 64, 32)).  Threads past V take no
// site.  kernels/wilson_dslash/kernel.py::normal_walk mirrors the walk.
struct rt_walk {
  int bx, by, bz;   // the tile (each divides its dim)
  int Y, Z, T;
  int nty, ntz;     // tiles along y and along z
  int tsites;       // bx by bz T
};

struct rt_order {
  int nq;       // chunks an x-plane, 0: linear order (and under a walk)
  int X;
  int groups;   // slot groups (1 for the single instance)
  int slots;    // slots of the launch
  rt_walk w;    // K5T's walk; w.bx 0: none
};

// The site at walk position g (< V).
template <typename I>
__device__ __forceinline__ I rt_walk_site(const rt_walk& w, I g) {
  const I t = g / w.tsites;
  I l = g - t * w.tsites;
  const I lt = l % w.T;
  l /= w.T;
  const I lz = l % w.bz;
  l /= w.bz;
  const I ly = l % w.by;
  const I lx = l / w.by;
  const I tz = t % w.ntz;
  const I r = t / w.ntz;
  const I ty = r % w.nty;
  const I tx = r / w.nty;
  return (((tx * w.bx + lx) * w.Y + ty * w.by + ly) * w.Z + tz * w.bz + lz) * w.T + lt;
}

__device__ __forceinline__ int rt_order_chunk(const rt_order& o, int i, int& group) {
  group = i % o.groups;
  const int j = i / o.groups;
  if (o.nq == 0) return j;
  const int per = RT_BRICK_X * o.nq;
  const int brick = j / per;
  const int x0 = RT_BRICK_X * brick;
  const int w = min(RT_BRICK_X, o.X - x0);
  const int r = j - per * brick;
  return (x0 + r % w) * o.nq + r / w;
}

// The slots of a block's group of SB: b0 = SB group, and nb <= SB of them;
// off[b] the offset of slot b0 + b's field of n values (the last valid one
// repeated past nb).  The kernels address every field from their own
// __restrict__ base pointers plus these offsets, so nvcc may move a field's
// loads past another's stores.
template <int SB>
__device__ __forceinline__ int rt_slot_offsets(long long n, const rt_order& o, int group,
                                               long long (&off)[SB]) {
  const int b0 = group * SB;
  const int nb = SB == 1 ? 1 : min(SB, o.slots - b0);
#pragma unroll
  for (int b = 0; b < SB; ++b) off[b] = (b0 + min(b, nb - 1)) * n;
  return nb;
}

// This thread's site, and its block's chunk and slot group (rt_order).
template <typename I>
__device__ __forceinline__ I rt_normal_site(const rt_order& o, int& chunk, int& group) {
  chunk = rt_order_chunk(o, blockIdx.x, group);
  return (I)chunk * blockDim.x + threadIdx.x;
}

// K5's and K5T's site (K5T: chunk is the walk unit, a site >= V where the
// thread has none).
template <typename I>
__device__ __forceinline__ I rt_normal_walk_site(const rt_order& o, I V, int& chunk,
                                                 int& group) {
  const I g = rt_normal_site<I>(o, chunk, group);
  return o.w.bx && g < V ? rt_walk_site<I>(o.w, g) : g;
}

// Fields stored as TU: u's storage (float, or __nv_bfloat16: the policy
// instance's copy of u made once per operator).  A slot's base is offset in
// 64 bits, sites and offsets inside it are of type I.
template <int K, typename I, int SB, bool RB = false, typename TU = float>
__global__ void wilson_normal_t_kernel(const float* __restrict__ p, const TU* __restrict__ u,
                                       float* __restrict__ t, float kappa, rt_lattice L,
                                       rt_layout lp, rt_layout lu, rt_order o) {
  constexpr bool RBU = RB && !rt_is_bf16<TU>::value;
  const I V = (I)L.X * L.Y * L.Z * L.T;
  int chunk, group;
  const I s = rt_normal_walk_site<I>(o, V, chunk, group);
  if (s >= V) return;
  long long off[SB];
  const int nb = rt_slot_offsets<SB>(24LL * V, o, group, off);
  const float* ps[SB];
#pragma unroll
  for (int b = 0; b < SB; ++b) ps[b] = p + off[b];
  float d[SB][24];
  rt_wilson_hop<K, K, RB, RBU, SB>(ps, lp, rt_wf<TU>{u, lu}, nb, L, s, d);
#pragma unroll
  for (int b = 0; b < SB; ++b) {
    if (b >= nb) break;
#pragma unroll
    for (int c = 0; c < 24; ++c) {
      const float pv = rt_bf16_if<RB>(p[off[b] + rt_at<K, I>(lp, c, s, 24, V)]);
      t[off[b] + c * V + s] = rt_g5_sign(c) * (pv - kappa * d[b][c]);
    }
  }
}

// ap and pap's products at site s of one slot: ap[c] = g5 (t[c] - kappa
// d[c]) written at INDEX, prod[c] = p[c] ap[c] (before ap's rounding).
template <int K, bool RB, bool COMP, typename TAP, typename I>
__device__ __forceinline__ void rt_normal_ap_site(const float* __restrict__ p,
                                                  const float* __restrict__ t,
                                                  TAP* __restrict__ ap, const float (&d)[24],
                                                  float kappa, I s, I V, const rt_layout& lp,
                                                  const rt_layout& lap, float (&prod)[24]) {
#pragma unroll
  for (int c = 0; c < 24; ++c) {
    const float a = rt_g5_sign(c) * (t[c * V + s] - kappa * d[c]);
    rt_st(ap, rt_at<K, I>(lap, c, s, 24, V), a);
    const float pv = rt_bf16_if<RB>(p[rt_at<K, I>(lp, c, s, 24, V)]);
    if constexpr (COMP)
      prod[c] = __fmul_rn(pv, a);
    else
      prod[c] = pv * a;
  }
}

template <int K, typename I, int SB, bool RB = false, typename TAP = float, bool COMP = false,
          typename TU = float>
__global__ void wilson_normal_ap_kernel(const float* __restrict__ p, const float* __restrict__ t,
                                        const TU* __restrict__ u, TAP* __restrict__ ap,
                                        float* __restrict__ partials, float kappa,
                                        rt_lattice L, rt_layout lp, rt_layout lu,
                                        rt_layout lap, rt_order o) {
  constexpr bool RBU = RB && !rt_is_bf16<TU>::value;
  constexpr int W = COMP ? 2 : 1;   // words a partial value
  const I V = (I)L.X * L.Y * L.Z * L.T;
  const long long nchunks = gridDim.x / o.groups;
  int chunk, group;
  const I s = rt_normal_walk_site<I>(o, V, chunk, group);
  long long off[SB];
  const int nb = rt_slot_offsets<SB>(24LL * V, o, group, off);
  const float* ts[SB];
#pragma unroll
  for (int b = 0; b < SB; ++b) ts[b] = t + off[b];
  float prod[SB][24];
#pragma unroll
  for (int b = 0; b < SB; ++b)
#pragma unroll
    for (int c = 0; c < 24; ++c) prod[b][c] = 0.0f;
  if (s < V) {
    float d[SB][24];
    rt_wilson_hop<RT_K_SOA, K, false, RBU, SB>(ts, rt_soa(), rt_wf<TU>{u, lu}, nb, L, s, d);
#pragma unroll
    for (int b = 0; b < SB; ++b) {
      if (b >= nb) break;
      rt_normal_ap_site<K, RB, COMP>(p + off[b], t + off[b], ap + off[b], d[b], kappa, s, V,
                                     lp, lap, prod[b]);
    }
  }
  const int b0 = group * SB;
#pragma unroll
  for (int b = 0; b < SB; ++b) {
    if (b >= nb) break;
    if (b) __syncthreads();   // the last fold's shared rows are read before they are reused
    const float (&pb)[24] = prod[b];
    float* row = partials + ((b0 + b) * nchunks + chunk) * 24 * W;
    if constexpr (COMP)
      rt_block_partials_comp<24>(pb, row);
    else
      rt_block_partials<24>(pb, RT_OP_SUM, row);
  }
}

// -- host side ------------------------------------------------------------------------

// The block order of a launch of `block` threads over `batch` slots, sb a
// thread, in layout class k (see rt_order): one group for a single slot.
// A tile (bx, by, bz) with bx > 0 sets K5T's walk (the chunks then in
// linear order); bx 0 is the untiled launch.
static constexpr int RT_NO_TILE[3] = {0, 0, 0};
static inline rt_order rt_make_order(const rt_lattice& L, int block, int batch, int k, int sb,
                                     const int (&tile)[3] = RT_NO_TILE) {
  const long long plane = (long long)L.Y * L.Z * L.T;
  const int groups = batch > 1 ? (batch + sb - 1) / sb : 1;
  const int bx = tile[0], by = tile[1], bz = tile[2];
  const rt_walk w{bx, by, bz, L.Y, L.Z, L.T, bx ? L.Y / by : 0, bx ? L.Z / bz : 0,
                  bx * by * bz * L.T};
  const bool brick = !bx && k != RT_K_AOS && plane % block == 0;
  return rt_order{brick ? (int)(plane / block) : 0, L.X, groups, batch, w};
}

// Whether (bx, by, bz) tiles the lattice for K5T: each >= 1 and dividing
// its dim.
static inline bool rt_normal_tile_ok(const rt_lattice& L, const int (&tile)[3]) {
  return tile[0] >= 1 && tile[1] >= 1 && tile[2] >= 1 && L.X % tile[0] == 0 &&
         L.Y % tile[1] == 0 && L.Z % tile[2] == 0;
}

// Whether K5 takes the block: whole warps within the bound.
static inline bool rt_normal_block_ok(int block) {
  return block > 0 && block % 32 == 0 && block <= RT_NORMAL_MAX_BLOCK;
}

// Whether every offset inside a slot's fields (72 V of u) fits an int: the
// kernels' 32-bit instantiation.
static inline bool rt_normal_narrow(const rt_lattice& L) {
  return 72LL * L.X * L.Y * L.Z * L.T < (1LL << 31);
}

// Blocks of a launch: every chunk of every slot group.
static inline unsigned rt_normal_grid(const rt_lattice& L, int block, const rt_order& o) {
  const long long V = (long long)L.X * L.Y * L.Z * L.T;
  return (unsigned)(rt_grid(V, block) * (long long)o.groups);
}

// The t launch of `batch` slots in layout class K with sites of type I, SB
// slots a thread, walking `tile` where its bx is set.
template <int K, typename I, int SB, bool RB, typename TU>
static void rt_launch_normal_t(const float* p, const TU* u, float* t, float kappa,
                               const rt_lattice& lat, const rt_layout (&L)[2], int batch,
                               int block, const int (&tile)[3], cudaStream_t stream) {
  const rt_order o = rt_make_order(lat, block, batch, K, SB, tile);
  wilson_normal_t_kernel<K, I, SB, RB, TU>
      <<<rt_normal_grid(lat, block, o), block, 0, stream>>>(p, u, t, kappa, lat, L[0], L[1], o);
}

// The ap launch, likewise.
template <int K, typename I, int SB, bool RB, typename TAP, bool COMP, typename TU>
static void rt_launch_normal_ap(const float* p, const float* t, const TU* u, TAP* ap,
                                float* partials, float kappa, const rt_lattice& lat,
                                const rt_layout (&L)[3], int batch, int block,
                                const int (&tile)[3], cudaStream_t stream) {
  const rt_order o = rt_make_order(lat, block, batch, K, SB, tile);
  wilson_normal_ap_kernel<K, I, SB, RB, TAP, COMP, TU>
      <<<rt_normal_grid(lat, block, o), block, 0, stream>>>(p, t, u, ap, partials, kappa, lat,
                                                            L[0], L[1], L[2], o);
}


// Run the launch statement(s) with RT_K the layout class k, and the site
// type RT_IDX and slots a thread RT_SB of the instantiation it takes: 32-bit
// sites with SB slots a thread (one for a single slot) on a narrow lattice,
// else 64-bit sites one slot a thread.
#define RT_NORMAL_DISPATCH(k, lat, batch, SB, ...) \
  if (!rt_normal_narrow(lat)) {                   \
    typedef long long RT_IDX;                     \
    constexpr int RT_SB = 1;                      \
    RT_WITH_CLASS(k, __VA_ARGS__)                 \
  } else if ((batch) > 1) {                       \
    typedef int RT_IDX;                           \
    constexpr int RT_SB = SB;                     \
    RT_WITH_CLASS(k, __VA_ARGS__)                 \
  } else {                                        \
    typedef int RT_IDX;                           \
    constexpr int RT_SB = 1;                      \
    RT_WITH_CLASS(k, __VA_ARGS__)                 \
  }
