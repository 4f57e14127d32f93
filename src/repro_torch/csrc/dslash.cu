// K4: the Wilson hopping term D psi on a periodic lattice.
//
// Replaces the TPU kernel kernels/wilson_dslash/kernel.py::dslash_site_pallas
// (pallas_call :53) together with its gather prologue (ops.py:53-54): the
// TPU path first materialises the 192-component neighbour pack and the
// backward links (6.4 GB and 2.4 GB at (64,64,64,32)), then runs the site
// math over (ncomp, vvl) blocks in the field's layout.  Here one thread per
// site gathers its neighbours by periodic index arithmetic inside the
// kernel, through the hop K5 shares (wilson.cuh::rt_hop_mu).
//
// Bound on the H100: bytes.  Compulsory traffic is psi + u in, D psi out:
// (24 + 72 + 24) * 4 = 480 B a site for about 1320 flops, 2.75 flop/byte,
// under the ~20 flop/byte fp32 ridge.  A site reads 8 neighbour spinors
// (768 B) and 8 links (576 B) from L2: 1,344 B into the SM for 480
// compulsory ones.  The design keeps the device-memory side near the 480
// and, at T = 32 (milc_small's), reads whole 32-byte sectors in every
// layout:
//
//   - the blocks, each a chunk of vvl consecutive sites, run in K5's brick
//     order (wilson_normal.cuh::rt_order) in every layout, so a site is
//     read again as a neighbour within reach of the 50 MB L2, where the
//     linear order re-read every x-neighbour from device memory (Y Z T
//     sites later, ~63 MB at (64, 64, 64, 32)); offsets are 32-bit where
//     72 V < 2^31, 64-bit above;
//   - AoS and AoSoA with SAL 2 to 16, where T is 32: the warp-staged loads
//     below, each sector read whole by one 16-byte copy into shared
//     memory; a thread's own loads would read half a sector an instruction
//     (a 96-byte AoS record's 16-byte pieces, a short array's 4 values of
//     one component) and the next instruction the other half, or touch a
//     line a short array;
//   - every other launch (SoA, AoSoA with SAL >= 32, where a warp's load of
//     one component reads one 128-byte line; mixed layouts, other T, vvl
//     or a misaligned field): one thread a site, each value through INDEX
//     (in AoS a load of one component then touches 32 sectors).
//
// A tiled design that staged psi on a block's tile of t-rows and its faces
// in shared memory (cp.async) was measured against this one and deleted
// (PERF.md): it was slower in every layout.
//
// Layouts: psi, u and out each come with a layout descriptor (SoA, AoS or
// AoSoA); both paths feed rt_hop_mu the same values in the same order in
// every layout, so out is bitwise the SoA launch's, repacked.  The kernel
// is instantiated for each layout class (common.cuh); the all-SoA one is
// SoA's addresses alone.

#include "wilson_normal.cuh"

// One thread a site, the blocks in rt_order, every value through INDEX.
template <int K, typename I>
__global__ void dslash_kernel(const float* __restrict__ psi, const float* __restrict__ u,
                              float* __restrict__ out, rt_lattice L, rt_layout lpsi,
                              rt_layout lu, rt_layout lout, rt_order o) {
  const I V = (I)L.X * L.Y * L.Z * L.T;
  int chunk, group;
  const I s = rt_normal_site<I>(o, chunk, group);
  if (s >= V) return;
  const float* const ps[1] = {psi};
  float d[1][24];
  rt_wilson_hop<K, K, false, false, 1>(ps, lpsi, rt_wf<float>{u, lu}, 1, L, s, d);
#pragma unroll
  for (int c = 0; c < 24; ++c) out[rt_at<K, I>(lout, c, s, 24, V)] = d[0][c];
}

// -- the warp-staged loads of AoS and AoSoA -------------------------------------------
//
// Where T is 32 (a warp's 32 consecutive sites are one t-row), every field
// is AoS or AoSoA with a SAL of 2 to 16, and the block is whole warps of at
// most RT_DSLASH_WS_MAX_BLOCK sites: a warp's x-, y- and z-neighbours (one
// direction and sign) are again 32 consecutive sites, whose 24 x 32 values
// lie in one run of 768 floats in either layout; the t-neighbours are the
// warp's own row, rotated.  The warp copies such a run as 16-byte loads
// (each 32-byte sector read whole by one instruction, where per-thread
// loads of a 96-byte AoS record, or of a component of an AoSoA short array
// of 4, read half a sector an instruction) into buffers of its own, each
// short array of SAL sites padded by SAL floats so that a lane's read of
// one component is free of bank conflicts, and each lane reads its
// neighbours' spinors there.  Links likewise: link mu of the run's sites is
// one run of 18 SAL floats a short array, copied as 8-byte pieces.  D psi
// goes out the same way, a run of 768 floats stored as 16-byte pieces.
// With SAL 8 and 16 a thread's loads read whole sectors too, but each
// instruction touches 4 and 2 short arrays' lines; staged, K4 took 1.69 and
// 1.61 ms against 2.29 and 1.92 at (64, 64, 64, 32) (tools/
// k4_k5l_variants.py, H100 80GB HBM3, 700 W).  With SAL 32 or more a warp's
// load of one component is one 128-byte line, and threads load their own.

#define RT_DSLASH_WS_MAX_BLOCK 128
// blocks an SM the registers must allow: 3 (168 registers) took 1.71 ms in
// aosoa4 and 2.26 in AoS at (64, 64, 64, 32), 4 (128, spilling) 2.05 and
// 2.31 (tools/k4_k5l_variants.py, H100 80GB HBM3, 700 W)
#define RT_DSLASH_WS_MIN_BLOCKS 3
#define RT_DSLASH_WS_PSI (32 * 25)    // floats of a staged spinor run
#define RT_DSLASH_WS_LINK (32 * 19)   // floats of a staged link run
// a warp's buffers: the forward and backward spinor runs, then their links
#define RT_DSLASH_WS_WARP (2 * RT_DSLASH_WS_PSI + 2 * RT_DSLASH_WS_LINK)

// Stage the spinor run of sites [n0, n0 + 32) (n0 a multiple of 32): 192
// 16-byte pieces, 6 a lane; short array b of SAL sites at 25 SAL b.
template <int SAL>
__device__ __forceinline__ void rt_ws_psi(float* buf, const float* __restrict__ psi, int n0,
                                          int lane) {
  const float4* run = reinterpret_cast<const float4*>(psi + 24 * n0);
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const int e = lane + 32 * k;
    const float4 v = __ldg(run + e);
    const int b = 4 * e / (24 * SAL), w = 4 * e - 24 * SAL * b;
    float* d = buf + 25 * SAL * b + w;
    d[0] = v.x;
    d[1] = v.y;
    d[2] = v.z;
    d[3] = v.w;
  }
}

// Stage link MU of the sites [n0, n0 + 32): a run of 18 SAL floats a short
// array (72 SAL apart), 288 8-byte pieces, 9 a lane; short array b at 19
// SAL b.
template <int MU, int SAL>
__device__ __forceinline__ void rt_ws_link(float* buf, const float* __restrict__ u, int n0,
                                           int lane) {
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const int e = lane + 32 * k;
    const int b = e / (9 * SAL), w = 2 * (e - 9 * SAL * b);
    const float2 v = __ldg(reinterpret_cast<const float2*>(u + 72 * (n0 + SAL * b) +
                                                           18 * MU * SAL + w));
    float* d = buf + 19 * SAL * b + w;
    d[0] = v.x;
    d[1] = v.y;
  }
}

// Lane l's spinor in a staged run (rt_project's ld).
template <int SAL>
struct rt_ws_spinor {
  const float* q;

  __device__ __forceinline__ rt_ws_spinor(const float* buf, int l)
      : q(buf + 25 * SAL * (l / SAL) + (l % SAL)) {}
  __device__ __forceinline__ rt_cplx operator()(int comp) const {
    return {q[(2 * comp) * SAL], q[(2 * comp + 1) * SAL]};
  }
};

// Lane l's link in a staged link run.
template <int SAL>
__device__ __forceinline__ void rt_ws_link_of(const float* buf, int l, rt_cplx (&m)[3][3]) {
  const float* q = buf + 19 * SAL * (l / SAL) + (l % SAL);
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b)
      m[a][b] = {q[(2 * (a * 3 + b)) * SAL], q[(2 * (a * 3 + b) + 1) * SAL]};
}

// Direction MU (x, y or z) of the hop for the warp's sites [s0, s0 + 32),
// whose forward and backward runs start at nf0 and nb0.
template <int MU, int SAL>
__device__ __forceinline__ void rt_ws_dir(float* buf, const float* __restrict__ psi,
                                          const float* __restrict__ u, int s0, int nf0, int nb0,
                                          int lane, rt_cplx (&acc)[4][3]) {
  float* pf = buf;
  float* pb = buf + RT_DSLASH_WS_PSI;
  float* lf = buf + 2 * RT_DSLASH_WS_PSI;
  float* lb = lf + RT_DSLASH_WS_LINK;
  rt_ws_psi<SAL>(pf, psi, nf0, lane);
  rt_ws_psi<SAL>(pb, psi, nb0, lane);
  rt_ws_link<MU, SAL>(lf, u, s0, lane);
  rt_ws_link<MU, SAL>(lb, u, nb0, lane);
  __syncwarp();
  rt_cplx mf[3][3], mb[3][3];
  rt_ws_link_of<SAL>(lf, lane, mf);
  rt_ws_link_of<SAL>(lb, lane, mb);
  rt_hop_mu<MU>(mf, mb, rt_ws_spinor<SAL>(pf, lane), rt_ws_spinor<SAL>(pb, lane), acc);
  __syncwarp();
}

// Every field in layout class K (RT_K_AOS with SAL 1, or RT_K_AOSOA), T =
// 32, blocks of whole warps in rt_order, 32-bit offsets; dynamic shared
// memory: RT_DSLASH_WS_WARP floats a warp.
template <int K, int SAL>
__global__ void __launch_bounds__(RT_DSLASH_WS_MAX_BLOCK, RT_DSLASH_WS_MIN_BLOCKS)
    dslash_kernel_warp(const float* __restrict__ psi, const float* __restrict__ u,
                       float* __restrict__ out, rt_lattice L, rt_order o) {
  extern __shared__ float rt_ws_buf[];
  const int V = L.X * L.Y * L.Z * L.T;
  const int lane = threadIdx.x & 31;
  float* buf = rt_ws_buf + RT_DSLASH_WS_WARP * (threadIdx.x >> 5);
  int chunk, group;
  const int s = rt_normal_site<int>(o, chunk, group);
  if (s - lane >= V) return;   // the whole warp (V is a multiple of 32)
  const int s0 = s - lane;
  int fwd[4], bwd[4];
  rt_neighbours(L, s0, fwd, bwd);   // the runs' first sites
  rt_cplx acc[4][3];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 3; ++c) acc[a][c] = {0.0f, 0.0f};
  rt_ws_dir<0, SAL>(buf, psi, u, s0, fwd[0], bwd[0], lane, acc);
  rt_ws_dir<1, SAL>(buf, psi, u, s0, fwd[1], bwd[1], lane, acc);
  rt_ws_dir<2, SAL>(buf, psi, u, s0, fwd[2], bwd[2], lane, acc);
  {   // t: the warp's own row, rotated; the link run of its own sites
    float* lf = buf + 2 * RT_DSLASH_WS_PSI;
    rt_ws_psi<SAL>(buf, psi, s0, lane);
    rt_ws_link<3, SAL>(lf, u, s0, lane);
    __syncwarp();
    rt_cplx mf[3][3], mb[3][3];
    rt_ws_link_of<SAL>(lf, lane, mf);
    rt_ws_link_of<SAL>(lf, (lane + 31) & 31, mb);
    rt_hop_mu<3>(mf, mb, rt_ws_spinor<SAL>(buf, (lane + 1) & 31),
                 rt_ws_spinor<SAL>(buf, (lane + 31) & 31), acc);
    __syncwarp();
  }
  // D psi through the buffer, then out as one run of 16-byte pieces
  float* q = buf + 25 * SAL * (lane / SAL) + (lane % SAL);
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      q[(2 * (a * 3 + c)) * SAL] = acc[a][c].re;
      q[(2 * (a * 3 + c) + 1) * SAL] = acc[a][c].im;
    }
  __syncwarp();
  float4* run = reinterpret_cast<float4*>(out + 24 * s0);
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const int e = lane + 32 * k;
    const int b = 4 * e / (24 * SAL), w = 4 * e - 24 * SAL * b;
    const float* d = buf + 25 * SAL * b + w;
    run[e] = make_float4(d[0], d[1], d[2], d[3]);
  }
}

// -- host side ------------------------------------------------------------------------

// The SAL of the warp-staged kernel that takes a launch of class k (every
// field in layout l) on lat in blocks of `block` (see above), or 0.
static int rt_dslash_warp_sal(const rt_lattice& lat, int k, const rt_layout& l, int block,
                              const float* psi, const float* u, const float* out) {
  const int sal = k == RT_K_AOS ? 1 : (k == RT_K_AOSOA && l.sal <= 16 ? l.sal : 0);
  if (sal == 0) return 0;
  if (lat.T != 32 || block % 32 || block > RT_DSLASH_WS_MAX_BLOCK) return 0;
  const bool ok = rt_normal_narrow(lat) && rt_aligned(psi) && rt_aligned(out) &&
                  (reinterpret_cast<unsigned long long>(u) & 7ull) == 0;
  return ok ? sal : 0;
}

template <int K, typename I>
static void rt_dslash_launch(const float* psi, const float* u, float* out, const rt_lattice& lat,
                             const rt_layout (&L)[3], int block, cudaStream_t stream) {
  // the brick order in every layout (rt_make_order's AoS rule is K5's)
  const rt_order o = rt_make_order(lat, block, 1, RT_K_SOA, 1);
  dslash_kernel<K, I><<<rt_normal_grid(lat, block, o), block, 0, stream>>>(
      psi, u, out, lat, L[0], L[1], L[2], o);
}

extern "C" {

// psi, out: 24 x V, u: 72 x V, in the layouts of descriptors lpsi, lu, lout;
// V = X*Y*Z*T; blocks of `block` sites.
int rt_dslash(const float* psi, const float* u, float* out, int X, int Y, int Z, int T,
              int lpsi, int lu, int lout, int block, cudaStream_t stream) {
  const rt_lattice lat{X, Y, Z, T};
  const rt_layout L[3] = {rt_make_layout(lpsi), rt_make_layout(lu), rt_make_layout(lout)};
  int k = rt_launch_class(L, 3);
  if (k < 0 || block < 1 || block > 1024) return RT_BAD_LAYOUT;
  if ((long long)X * Y * Z * T == 0) return 0;
  if (const int sal = rt_dslash_warp_sal(lat, k, L[0], block, psi, u, out)) {
    const rt_order o = rt_make_order(lat, block, 1, RT_K_SOA, 1);
    const unsigned grid = rt_normal_grid(lat, block, o);
    const int smem = (block / 32) * RT_DSLASH_WS_WARP * (int)sizeof(float);
    if (sal == 1)
      dslash_kernel_warp<RT_K_AOS, 1><<<grid, block, smem, stream>>>(psi, u, out, lat, o);
    else if (sal == 2)
      dslash_kernel_warp<RT_K_AOSOA, 2><<<grid, block, smem, stream>>>(psi, u, out, lat, o);
    else if (sal == 4)
      dslash_kernel_warp<RT_K_AOSOA, 4><<<grid, block, smem, stream>>>(psi, u, out, lat, o);
    else if (sal == 8)
      dslash_kernel_warp<RT_K_AOSOA, 8><<<grid, block, smem, stream>>>(psi, u, out, lat, o);
    else
      dslash_kernel_warp<RT_K_AOSOA, 16><<<grid, block, smem, stream>>>(psi, u, out, lat, o);
    RT_LAUNCH_RESULT();
  }
  if (rt_normal_narrow(lat)) {
    RT_WITH_CLASS(k, (rt_dslash_launch<RT_K, int>(psi, u, out, lat, L, block, stream)));
  } else {
    RT_WITH_CLASS(k, (rt_dslash_launch<RT_K, long long>(psi, u, out, lat, L, block, stream)));
  }
  RT_LAUNCH_RESULT();
}

}  // extern "C"
