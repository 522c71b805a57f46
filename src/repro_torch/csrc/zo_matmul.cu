// zo_matmul: Y = X @ (W + coeff * z(seed)) for row-major X (M, K) and
// W (K, N), f32 accumulation, Y in X's dtype (float32 or bfloat16).
//
// Replaces the Pallas kernel _zo_matmul_kernel (src/repro/kernels/
// zo_perturb.py:214, launched by zo_matmul at :292): every dense
// projection of the fused MeZO perturbed forward (Q/K/V/O, the MLP, the
// LM head), so the perturbation never exists in device memory.
// zo_matmul_q (_zo_matmul_q_kernel, :234, launched at :310): the same
// over an int8 W (K, N) with per-column f32 scales s (N,), Y = X @ (q * s
// + coeff * z), so neither the dequantized base nor the perturbation
// exists in device memory. zo_matmul_users / zo_matmul_users_q
// (_zo_matmul_users_kernel :332 and _zo_matmul_users_q_kernel :352,
// launched at :409 and :428): Y[i] = X[i] @ (W[i % P] + coeff[i] *
// z(seed[i])) for X (U, M, K) and a W that is shared (P = 1, the one
// resident base; or one int8 base) or stacked per lane (P lanes at any
// lane stride: a layer slice of the multi-tenant state) -- every
// projection of the multi-tenant step's user-axis forward in one launch.
//
// Two bodies, chosen by the launcher from X's dtype and z's dist
// (repro_zo_matmul_body), for all four entry points alike; the tensor-core
// one has two routes, chosen from W's dtype, K, N, W's lane stride and the
// bases' alignment -- never from M, a value or a setting:
//
// 1. bf16 X with Rademacher z: bf16 tensor cores. The decomposition
//    X (W + c z) = X W + c (X z) is exact term by term on these inputs:
//    a bf16 x bf16 product is exact in an f32 accumulator, z = +-1 is
//    exact in bf16, an int8 q is exact in bf16, and the power-of-two
//    column scales are exact, so s (X q) = X (q s). Two bf16 products
//    with f32 accumulation therefore give the reference's true-f32 dot
//    (f32 X against the f32 W') up to summation order and the one f32
//    rounding of W' that they skip -- the class of difference that the
//    2e-5 / 1e-2 of max|Y| limits already admit. The f32 W' is never
//    formed. Bound on this card: max(bytes / 3.35 TB/s, 2 M K N / 989
//    TFLOP/s) -- 0.0695 ms for OPT-1.3B's q/k/v/o at M = 8192 (B 16 x S
//    512), 0.278 ms for its w_in and w_out -- where the SIMT body's f32
//    bound would be ~15x that.
//    a. The Hopper body (namespace tma), where TMA can load X and W: a
//    bf16 W (not an int8 q), K, N and W's lane stride multiples of 8
//    bf16 (16-byte rows) and 16-byte bases (use_tma) -- every bf16
//    projection of the training paths. What bounds it is the SM's
//    shared memory and the hash, not the tensor cores: a CTA's output
//    tile is 128 x 128, and for every k16 step each of two consumer
//    warpgroups issues one wgmma.m64n256k16 over its 64 rows of X and the
//    joint 64 x 256 B tile [W | z] of the stage (W's 128 columns beside
//    z's, four MN-major 128-byte-swizzled [64][64] chunks, LBO the chunk
//    stride), so the first 128 accumulator columns are X W and the last
//    128 X z, still two accumulators, 128 registers a thread. That is 80
//    KB of shared-memory reads a 64-k stage for 2.1 M MACs (the 256 x 64
//    body below read 128 KB for the same), beside the stage's 48 KB of
//    writes; X is read once per 128 columns (not 64). The ring has 4
//    stages of 48 KB with a full and an empty mbarrier each (transaction
//    bytes on the full one); X and W arrive by TMA (cp.async.bulk.tensor,
//    each issued by lane 0 of its own producer warp), and the producer
//    warpgroup otherwise only hashes; setmaxnreg gives the consumers 216
//    registers and the producers 72. The two CTAs of a 2-CTA cluster
//    take the two 128-row halves of a 256-row block of one column strip:
//    each loads half of every stage's W rows by TMA multicast into both,
//    and hashes half of its z rows (zo_hash.cuh's folds at the ABSOLUTE
//    (k, n) coordinates, the plain version's bits) and writes them as
//    bf16 +-1 into both rings by st.async, whose bytes complete on the
//    full barriers like TMA's -- so each weight is hashed once per 256
//    rows of X, as in the 256 x 64 body. A CTA whose rows lie past M
//    still loads and hashes its half for its peer. The grid is
//    persistent: as many clusters as the card holds at once walk the
//    tiles, lanes outermost, then groups of 8 row blocks, row blocks
//    fastest, so the clusters that run together share W strips and a
//    group's rows of X stay in L2. Measured (scripts/zo_matmul_ablation.py,
//    H100): 1.40-1.60x the 256 x 64 body at the OPT cells' shapes,
//    2.7-3.1x bf16 cuBLAS; without the hash it would run 1.34-1.7x
//    faster, without the X z half another 1.00-1.09x, so the producers'
//    hash and z writes, contending with the consumers' products for the
//    shared-memory pipe, are the largest remaining part; 4-CTA clusters
//    (kCluster 4: z hashed once per 512 rows) ran 4-10 % faster.
//    b. The 256 x 64 body (namespace tc) for the rest: an int8 q, whose
//    tile is widened in the producers, and ragged or unaligned rows.
//    wgmma (sm_90a; m64n64k16, bf16 in, f32 accumulators)
//    on a 4-stage ring in shared memory (192 KB, tiles in wgmma's
//    128-byte-swizzled layouts); 384 threads, warp specialised. Two
//    consumer warpgroups own a 256 x 64 output block, 128 rows (two
//    64-row tiles) each, with two accumulators, X W (or X q) and X z,
//    both read by wgmma straight from the ring. One producer warpgroup
//    fills it, tile by tile (BK = 64): with an int8 q, X by 16-byte
//    cp.async (zero-filled at the edges) and the q tile loaded 16 bytes a
//    thread and widened to bf16 on the way into shared memory; the z tile
//    hashed with zo_hash.cuh's folds at the ABSOLUTE (k, n) coordinates
//    -- the same bits as the SIMT body and the plain version -- written
//    as bf16 +-1. Named barriers (full / empty per stage) hand stages
//    between the roles, so the producers' integer work (the hash: ~7
//    integer operations a weight, the last xorshift dropped since it
//    leaves the sign bit alone) runs beside the consumers' tensor-core
//    work; the consumers keep one tile's products in flight. The hash is
//    the limit this shape answers: each weight is hashed once per 256-row
//    block of X (4 times at M = 1024, 412 M folds for the LM head). The two
//    f32 accumulators of a 256-row block fit in the register file beside
//    the producers only at 64 columns (128 registers a consumer thread),
//    so X is read once per 64 columns and W once per 256 rows. Measured
//    (scripts/zo_matmul_ablation.py): the hash and the second product
//    each still cost a fraction of the time, and a single product
//    through this ring is well behind cuBLAS's bf16 GEMM, whose larger
//    tiles read X and W fewer times. A bf16 W comes here only with rows
//    or bases that are not a multiple of 16 bytes (K = 33), and it, X and
//    an unaligned int8 q take element loads into the same ring: a load
//    route does not change a value. Blocks walk M
//    fastest, so the blocks that share a W column strip run together
//    and W is read from device memory about once.
//    Y = acc_W (* s_n) + c * acc_z.
//
// 2. f32 X, or Gaussian z: the SIMT body, in true f32 FFMA. The reference
//    dots true f32 (preferred_element_type f32 on an f32 perturbed tile),
//    and neither f32 X nor Gaussian z is exact in bf16, so tensor cores
//    are out; the bound is operations at the f32 SIMT rate (67 TFLOP/s:
//    0.128 ms for RoBERTa-large's (1024, 1024) @ (1024, 4096) w_in).
//    The card's FMA pipes take one warp instruction a clock on each of
//    an SM's four schedulers, so every other instruction a thread issues
//    -- fragment loads, staging, the hash -- is an FMA not issued. The
//    design keeps them few: 256 threads a block, each a (BM / 16) x
//    (BN / 16) register tile whose A and B fragments are 16-byte shared
//    loads, conflict-free (one LDS.128 feeds 16 or 32 FMAs); stages of 16
//    k, one barrier each, through a double buffer, the next stage's X and W loaded into registers at the
//    top of a stage and stored -- X transposed, conflict-free, W
//    perturbed -- half way through its FMAs, so the loads' latency and
//    the hash hide behind FMAs; the W tile hashed and perturbed once per
//    BM rows (256 where the shape fills the card), w' = __fadd_rn(w,
//    __fmul_rn(c, z)) (int8: w = __fmul_rn(q, s); Rademacher c * z as c
//    with z's sign, the same bits), the plain version's f32 value bit for
//    bit with Rademacher z, column folds and scales read once a block.
//    The launcher picks the tile (256 x 128, 128 x 128, 128 x 64 or
//    64 x 64) from M, N, the lane count and the card's SMs (pick_tile:
//    RoBERTa's square projections take 128 x 64, 128 blocks on 132 SMs;
//    its w_in 256 x 128). No split-K: each output is one fmaf chain over
//    k = 0 .. K - 1 in order, so its bits depend on neither the tile, M,
//    N, the lane count nor (row0, col0). Edges are masked in M, K and N;
//    X, W and Y take element loads and stores where K or N is not a
//    multiple of 4 or a base is not aligned.
//
// Lanes: the lane is blockIdx.z (the Hopper body: the tile walk's
// outermost index) and the per-lane scalars travel in the Lanes struct;
// the k order and the per-element arithmetic depend neither on the number
// of lanes, M, nor on the entry point (a lone launch is the one-lane case
// of the same kernel), so every lane's bits are those of a lone
// zo_matmul (or zo_matmul_q) launch with that lane's seed and
// coefficient. Both tensor-core routes take the same k16 steps in the
// same order, and on an H100 their outputs were equal bit for bit.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <type_traits>

#include "zo_hash.cuh"

namespace repro_torch {
namespace {

// bit 31 = the sign of z at column coordinate n of a row whose fold is
// h_row: fold(h_row, n, d) without avalanche's last xorshift, which
// leaves bit 31 as it is (z_from_bits(.., 0) reads only bit 31)
__device__ __forceinline__ uint32_t z_sign(uint32_t h_row, uint32_t n_prime) {
  uint32_t x = h_row ^ n_prime;
  x ^= x >> 15;
  x *= 0x2C1B3C6Du;
  x ^= x >> 12;
  x *= 0x297A2D39u;
  return x;
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// ---------------------------------------------------------------------------
// the SIMT body (f32 X, or Gaussian z)

namespace simt {

using bf16 = __nv_bfloat16;

constexpr int BK = 16;          // k a stage

// The tiles the launcher picks from: a BM x BN output block a block, each
// thread a TM x TN register tile (4 x 4 sub-tiles), BM / TM x BN / TN
// threads. kEff: each tile's outputs an SM a second, in %
// of the 256 x 128 tile's, measured on an H100 at RoBERTa-large's w_in
// shape (1024, 1024, 4096), where every tile gives an SM the same
// outputs (scripts/simt_tiles.py: 100, 84.3, 82.1, 60.5).
constexpr int kTiles = 4;
constexpr int kTileBM[kTiles] = {256, 128, 128, 64};
constexpr int kTileBN[kTiles] = {128, 128, 64, 64};
constexpr int kTileTM[kTiles] = {16, 8, 8, 4};
constexpr int kTileTN[kTiles] = {8, 8, 4, 4};
constexpr int kEff[kTiles] = {100, 84, 82, 60};

// The tile of a launch of m x n outputs a lane over `sms` SMs: the least
// modelled time -- the blocks an SM runs, ceil(blocks / sms), times a
// block's outputs, over the tile's kEff -- ties to the larger tile.
// Integers throughout; tests/test_torch_zo_matmul_tile.py repeats it.
int pick_tile(int64_t m, int64_t n, int64_t lanes, int64_t sms) {
  int best = 0;
  int64_t best_work = 0;
  for (int i = 0; i < kTiles; ++i) {
    const int64_t blocks = (m + kTileBM[i] - 1) / kTileBM[i] *
                           ((n + kTileBN[i] - 1) / kTileBN[i]) * lanes;
    const int64_t work =
        (blocks + sms - 1) / sms * kTileBM[i] * kTileBN[i];
    if (i == 0 || work * kEff[best] < best_work * kEff[i]) {
      best = i;
      best_work = work;
    }
  }
  return best;
}

// four consecutive elements of a row of X or W as stored: a float4, four
// bf16 in a uint2, four int8 in a word
template <typename T>
struct QuadOf { using type = float4; };
template <>
struct QuadOf<bf16> { using type = uint2; };
template <>
struct QuadOf<int8_t> { using type = uint32_t; };
template <typename T>
using Quad = typename QuadOf<T>::type;

// p[0 .. 3] in one load (p aligned to 4 elements)
template <typename T>
__device__ __forceinline__ Quad<T> load_quad(const T* p) {
  return __ldg(reinterpret_cast<const Quad<T>*>(p));
}
// p[0 .. valid - 1] by element, -0.0 after: an X element past K times
// the 0.0 of W' past K adds -0.0 to a sum, which leaves every sum (a
// -0.0 one too) as it is, so the padded k are no part of the chain
__device__ __forceinline__ float4 load_quad_elems(const float* p, int valid) {
  float e[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) e[i] = i < valid ? p[i] : -0.0f;
  return make_float4(e[0], e[1], e[2], e[3]);
}
__device__ __forceinline__ uint2 load_quad_elems(const bf16* p, int valid) {
  const uint16_t* b = reinterpret_cast<const uint16_t*>(p);
  uint32_t e[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) e[i] = i < valid ? b[i] : 0x8000u;
  return make_uint2(e[0] | e[1] << 16, e[2] | e[3] << 16);
}
__device__ __forceinline__ uint32_t load_quad_elems(const int8_t* p,
                                                    int valid) {
  uint32_t r = 0u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (i < valid) r |= static_cast<uint32_t>(static_cast<uint8_t>(p[i]))
                        << (8 * i);
  return r;
}
// element i as f32 (exact; an int8 one as its integer value)
__device__ __forceinline__ float quad_at(const float4& q, int i) {
  return i == 0 ? q.x : i == 1 ? q.y : i == 2 ? q.z : q.w;
}
__device__ __forceinline__ float quad_at(const uint2& q, int i) {
  const uint32_t w = i < 2 ? q.x : q.y;
  return __uint_as_float(i % 2 ? (w & 0xFFFF0000u) : (w << 16));
}
__device__ __forceinline__ float quad_at(uint32_t q, int i) {
  return static_cast<float>(static_cast<int8_t>((q >> (8 * i)) & 0xFFu));
}
// four outputs to p[0 .. 3] (full: in one store, p aligned), else to
// p[0 .. valid - 1]
__device__ __forceinline__ void store_quad(float* p, const float (&v)[4],
                                           bool full, int valid) {
  if (full) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (i < valid) p[i] = v[i];
}
__device__ __forceinline__ void store_quad(bf16* p, const float (&v)[4],
                                           bool full, int valid) {
  if (full) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    *reinterpret_cast<uint2*>(p) =
        make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                   *reinterpret_cast<const uint32_t*>(&hi));
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (i < valid) p[i] = __float2bfloat16_rn(v[i]);
}

// One BM x BN output block (blockIdx.x, blockIdx.y) of lane blockIdx.z:
// X and Y lane z, W lane z % w_lanes at stride w_stride. T: X's and Y's
// type; TW: W's (T, or int8_t with column scales); DIST: z's (0
// Rademacher, 1 Gaussian). vec: X, W and Y take 4-element loads and
// stores (K and N multiples of 4, bases aligned).
//
// Thread (tx, ty) of the TXN x TYN grid owns rows 4 (TYN i + ty) + 0..3
// and columns 4 (TXN j + tx) + 0..3 of the block: its fragments of a k
// are 16-byte shared loads that a quarter warp (8 tx, one ty) takes
// broadcast (A) or from 8 distinct 16-byte slots (B), so they are
// conflict-free. One block an SM at most for the two larger tiles: at
// two, 128 x 128 spills (128 registers a thread) and ran slower on an
// H100, and 256 x 128 holds 128 accumulators a thread; the smaller tiles
// fit two an SM (under 128 registers). Stages of BK k go through a double buffer: stage t + 1's
// X and W are loaded into registers at the top of stage t, stored (X
// transposed: a warp's 32 threads hold 32 consecutive rows, so the
// stores are conflict-free) and perturbed into the other buffer half way
// through stage t's FMAs, and one barrier a stage hands them over. Each
// output is one fmaf chain over k = 0 .. K - 1 in order, whatever the
// tile, so its bits depend on neither the tile, M, N, the lane count nor
// (row0, col0).
template <typename T, typename TW, int DIST, int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__(BM / TM * (BN / TN), 1)
zo_matmul_simt_kernel(const T* __restrict__ x, const TW* __restrict__ w,
                      const float* __restrict__ scale, T* __restrict__ y,
                      int m, int k, int n, int64_t w_stride, int w_lanes,
                      Lanes lanes, int prime_offset, int vec) {
  constexpr bool kInt8 = std::is_same_v<TW, int8_t>;
  constexpr int TXN = BN / TN, TYN = BM / TM;   // the thread grid
  constexpr int kThreads = TXN * TYN;
  constexpr int XC = BM * BK / 4 / kThreads;    // X quads a thread a stage
  constexpr int WQ = BN / 4;                    // W quads a stage row
  constexpr int WC = BK * WQ / kThreads;        // W quads a thread a stage
  constexpr int WK = kThreads / WQ;             // stage rows between them
  static_assert(TM % 4 == 0 && TN % 4 == 0 && TXN % 8 == 0 &&
                kThreads % 32 == 0 && BM % 32 == 0 && XC >= 1 &&
                WC >= 1 && XC * kThreads == BM * BK / 4 &&
                WC * WK == BK, "tile split");
  __shared__ __align__(16) float xs[2][BK][BM];  // X stages, transposed
  __shared__ __align__(16) float ws[2][BK][BN];  // W' stages
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int tx = lane % 8 + 8 * (warp % (TXN / 8));
  const int ty = lane / 8 + 4 * (warp / (TXN / 8));
  const int u = blockIdx.z;
  x += static_cast<int64_t>(u) * m * k;
  y += static_cast<int64_t>(u) * m * n;
  w += (u % w_lanes) * w_stride;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const uint32_t base = lanes.base[u];
  const float coeff = lanes.coeff[u];
  const int n_tiles = (k + BK - 1) / BK;

  // this thread's W quads: stage rows wk + WK i, columns gn .. gn + 3 in
  // every stage, so their column folds and scales are read once
  const int wq = tid % WQ, wk = tid / WQ, gn = n0 + 4 * wq;
  const uint32_t p1 = dim_prime(prime_offset + 1);
  uint32_t n_prime[4];
  float col_scale[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    n_prime[e] = (static_cast<uint32_t>(gn + e) + lanes.col0) * p1;
    col_scale[e] = kInt8 && gn + e < n ? scale[gn + e] : 1.0f;
  }

  Quad<T> xq[XC];
  Quad<TW> wv[WC];
  // stage k0's X and W into registers (-0.0 / 0 past M, K and N)
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < XC; ++i) {
      const int c = tid + kThreads * i, gk = k0 + 4 * (c / BM);
      const int64_t gm = m0 + c % BM;
      const T* p = x + gm * k + gk;
      const int valid = gm < m ? min(4, k - gk) : 0;
      xq[i] = vec && valid == 4 ? load_quad(p) : load_quad_elems(p, valid);
    }
#pragma unroll
    for (int i = 0; i < WC; ++i) {
      const int gk = k0 + wk + WK * i;
      const TW* p = w + static_cast<int64_t>(gk) * n + gn;
      const int valid = gk < k ? min(4, n - gn) : 0;
      wv[i] = vec && valid == 4 ? load_quad(p) : load_quad_elems(p, valid);
    }
  };
  // the registers into stage buffer buf: X transposed, W perturbed,
  // w' = __fadd_rn(w, __fmul_rn(c, z)) (int8: w = __fmul_rn(q, s)), the
  // plain version's f32 value (bit for bit with Rademacher z)
  auto store = [&](int buf, int k0) {
#pragma unroll
    for (int i = 0; i < XC; ++i) {
      const int c = tid + kThreads * i, r = c % BM, kq = c / BM;
#pragma unroll
      for (int e = 0; e < 4; ++e) xs[buf][4 * kq + e][r] = quad_at(xq[i], e);
    }
#pragma unroll
    for (int i = 0; i < WC; ++i) {
      const int kr = wk + WK * i, gk = k0 + kr;
      const uint32_t h_row =
          fold(base, static_cast<uint32_t>(gk) + lanes.row0, prime_offset);
      float o[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float wf = quad_at(wv[i], e);
        if constexpr (kInt8) wf = __fmul_rn(wf, col_scale[e]);
        float cz;
        if constexpr (DIST == 0) {
          // c * (+-1): c with z's sign, the bits of __fmul_rn(c, z)
          cz = __uint_as_float(__float_as_uint(coeff) ^
                               (z_sign(h_row, n_prime[e]) & 0x80000000u));
        } else {
          cz = __fmul_rn(coeff,
                         z_from_bits(avalanche(h_row ^ n_prime[e]), 1));
        }
        o[e] = gk < k && gn + e < n ? __fadd_rn(wf, cz) : 0.0f;
      }
      *reinterpret_cast<float4*>(&ws[buf][kr][4 * wq]) =
          make_float4(o[0], o[1], o[2], o[3]);
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  fetch(0);
  store(0, 0);
  __syncthreads();
  for (int t = 0; t < n_tiles; ++t) {
    const int cur = t & 1;
    const bool more = t + 1 < n_tiles;
    if (more) fetch((t + 1) * BK);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      // the buffer cur ^ 1 was last read before the previous barrier
      if (kk == BK / 2 && more) store(cur ^ 1, (t + 1) * BK);
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM / 4; ++i) {
        const float4 v =
            *reinterpret_cast<const float4*>(&xs[cur][kk][4 * (TYN * i + ty)]);
        a[4 * i] = v.x;
        a[4 * i + 1] = v.y;
        a[4 * i + 2] = v.z;
        a[4 * i + 3] = v.w;
      }
#pragma unroll
      for (int j = 0; j < TN / 4; ++j) {
        const float4 v =
            *reinterpret_cast<const float4*>(&ws[cur][kk][4 * (TXN * j + tx)]);
        b[4 * j] = v.x;
        b[4 * j + 1] = v.y;
        b[4 * j + 2] = v.z;
        b[4 * j + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t gm = m0 + 4 * (TYN * (i / 4) + ty) + i % 4;
    if (gm >= m) continue;
#pragma unroll
    for (int j = 0; j < TN / 4; ++j) {
      const int gc = n0 + 4 * (TXN * j + tx);
      const float v[4] = {acc[i][4 * j], acc[i][4 * j + 1],
                          acc[i][4 * j + 2], acc[i][4 * j + 3]};
      store_quad(y + gm * n + gc, v, vec && gc + 3 < n, n - gc);
    }
  }
}

template <typename T, typename TW, int DIST, int BM, int BN, int TM, int TN>
int launch_tile(const void* x, const void* w, const float* scale, void* y,
                int m, int k, int n, int64_t w_stride, int w_lanes,
                const Lanes& lanes, int n_lanes, int prime_offset, int vec,
                cudaStream_t st) {
  const dim3 grid((m + BM - 1) / BM, (n + BN - 1) / BN, n_lanes);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  zo_matmul_simt_kernel<T, TW, DIST, BM, BN, TM, TN>
      <<<grid, BM / TM * (BN / TN), 0, st>>>(
      static_cast<const T*>(x), static_cast<const TW*>(w), scale,
      static_cast<T*>(y), m, k, n, w_stride, w_lanes, lanes, prime_offset,
      vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename TW, int DIST>
int launch_dist(const void* x, const void* w, const float* scale, void* y,
                int m, int k, int n, int64_t w_stride, int w_lanes,
                const Lanes& lanes, int n_lanes, int prime_offset,
                cudaStream_t st) {
  const int sms = sm_count();
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  constexpr int xb = 4 * sizeof(T), wb = 4 * sizeof(TW);
  const int vec = k % 4 == 0 && n % 4 == 0 && w_stride % 4 == 0 &&
                  aligned(x, xb) && aligned(w, wb) && aligned(y, xb);
#define REPRO_SIMT_TILE(I)                                                  \
  case I:                                                                   \
    return launch_tile<T, TW, DIST, kTileBM[I], kTileBN[I], kTileTM[I],     \
                       kTileTN[I]>(                                         \
        x, w, scale, y, m, k, n, w_stride, w_lanes, lanes, n_lanes,         \
        prime_offset, vec, st);
  switch (pick_tile(m, n, n_lanes, sms)) {
    REPRO_SIMT_TILE(0)
    REPRO_SIMT_TILE(1)
    REPRO_SIMT_TILE(2)
    REPRO_SIMT_TILE(3)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_SIMT_TILE
}

// T: X's and Y's type; TW: W's. bf16 X with Rademacher z runs on the
// tensor cores (use_tc), so it has no SIMT instantiation.
template <typename T, typename TW>
int launch(const void* x, const void* w, const float* scale, void* y, int m,
           int k, int n, int64_t w_stride, int w_lanes, const Lanes& lanes,
           int n_lanes, int prime_offset, int dist, cudaStream_t st) {
  if (dist == 1)
    return launch_dist<T, TW, 1>(x, w, scale, y, m, k, n, w_stride, w_lanes,
                                 lanes, n_lanes, prime_offset, st);
  if constexpr (std::is_same_v<T, float>)
    return launch_dist<T, TW, 0>(x, w, scale, y, m, k, n, w_stride, w_lanes,
                                 lanes, n_lanes, prime_offset, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace simt

// ---------------------------------------------------------------------------
// the tensor-core body (bf16 X, Rademacher z)

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int BM = 256, BN = 64, BK = 64, STAGES = 4;
constexpr int kConsumerWarps = 8, kProducerWarps = 4;
constexpr int kConsumers = kConsumerWarps * 32;                  // 256
constexpr int kProducers = kProducerWarps * 32;                  // 128
constexpr int kThreads = kConsumers + kProducers;                // 384
// 16-byte chunks a producer thread moves a tile: X, a bf16 W, an int8 q
constexpr int X_PER = BM * BK / 8 / kProducers;
constexpr int W_PER = BK * BN / 8 / kProducers;
constexpr int Q_PER = BK * BN / 16 / kProducers;
// Shared-memory tiles in wgmma's 128-byte-swizzled layouts (16-byte
// chunk c of a 128-byte row r sits at chunk c ^ (r % 8); the pattern
// repeats every 1024 bytes, so every tile starts 1024-byte aligned):
// X [BM][BK] K-major, one 128-byte row a row of X (BK = 64), 8-row groups
// 1024 bytes apart; W and z [BK][BN] MN-major, one 128-byte row a k (BN =
// 64), the next 8 k 1024 bytes on (SBO).
constexpr int X_TILE = BM * BK, W_TILE = BK * BN;                 // bf16s
constexpr int STAGE = X_TILE + 2 * W_TILE;
constexpr int SMEM_BYTES = STAGES * STAGE * 2 + 1024;   // + alignment slack
static_assert(BK == 64 && BN == 64 && BM == 256, "the swizzled layouts");
static_assert(BK % 32 == 0 && BN % 32 == 0 && X_PER * kProducers * 8 ==
              BM * BK && W_PER * kProducers * 8 == BK * BN &&
              Q_PER * kProducers * 16 == BK * BN, "tile split");
static_assert(SMEM_BYTES <= 232448, "shared memory a block can use");
constexpr int BAR_FULL = 1, BAR_EMPTY = 1 + STAGES;  // named barrier ids

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(kThreads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(kThreads) : "memory");
}
// 16 bytes global -> shared; src_bytes 0 writes 16 zero bytes
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// element offset of 16-byte chunk c (< 8) of row r in a swizzled tile
// (a row of X, or a k of W / z)
__device__ __forceinline__ int sw_off(int r, int c) {
  return r * 64 + ((c ^ (r & 7)) << 3);
}
// wgmma shared-memory matrix descriptor, 128-byte swizzle, of the tile at
// shared address a
__device__ __forceinline__ uint64_t gmma_desc_at(uint32_t a, uint32_t lbo,
                                                 uint32_t sbo) {
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | 1ull << 62;
}
__device__ __forceinline__ uint64_t gmma_desc(const bf16* p, uint32_t lbo,
                                              uint32_t sbo) {
  return gmma_desc_at(smem_u32(p), lbo, sbo);
}
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// d (64 x 64 f32, a warpgroup's fragment) += A (64 x 16, K-major) *
// B (16 x 64, MN-major), both from shared memory
__device__ __forceinline__ void wgmma_64(float (&d)[32], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// two z as bf16 +-1 (0x3F80 | sign << 15): a in the low half, b in the high
__device__ __forceinline__ uint32_t z_pair(uint32_t sa, uint32_t sb) {
  return 0x3F803F80u | ((sa >> 16) & 0x8000u) | (sb & 0x80000000u);
}
// four int8 (one 32-bit word) -> two bf16x2 words, exactly: each byte b
// becomes the f32 2^23 + (b + 128), minus 2^23 + 128; the f32 of an
// 8-bit integer is exact in bf16, so its top half is the bf16
__device__ __forceinline__ void i8x4_to_bf16(uint32_t v, uint32_t& lo,
                                             uint32_t& hi) {
  const uint32_t u = v ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + i)) -
           8388736.0f;
  lo = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
  hi = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632);
}

__device__ __forceinline__ uint16_t bf16_bits(const bf16* p) {
  return *reinterpret_cast<const uint16_t*>(p);
}

// eight bf16 of row `row` starting at column `col` (of `cols`) of a
// row-major (rows, cols) matrix, masked to zero outside it, by element
__device__ __forceinline__ uint4 load8_elems(const bf16* p, int64_t row,
                                             int64_t rows, int64_t col,
                                             int64_t cols) {
  uint32_t h[8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    h[i] = (row < rows && col + i < cols) ? bf16_bits(p + row * cols + col + i)
                                          : 0u;
  return make_uint4(h[0] | h[1] << 16, h[2] | h[3] << 16, h[4] | h[5] << 16,
                    h[6] | h[7] << 16);
}

// the block's X rows [m0, m0 + BM) and W columns [n0, n0 + BN) of lane
// blockIdx.z; VEC (int8 q only): 16-byte loads of X and q (K, N, bases and
// lane strides allow them)
template <typename TW, bool VEC>
__global__ void __launch_bounds__(kThreads, 1)
zo_matmul_tc_kernel(const bf16* __restrict__ x, const TW* __restrict__ w,
                    const float* __restrict__ scale, bf16* __restrict__ y,
                    int m, int k, int n, int64_t w_stride, int w_lanes,
                    Lanes lanes, int prime_offset) {
  constexpr bool kInt8 = std::is_same_v<TW, int8_t>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  const int u = blockIdx.z;
  x += static_cast<int64_t>(u) * m * k;
  y += static_cast<int64_t>(u) * m * n;
  w += (u % w_lanes) * w_stride;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int n_tiles = (k + BK - 1) / BK;
  const int tid = threadIdx.x;

  if (tid >= kConsumers) {
    // ------------------------------------------------------------ producers
    const int pt = tid - kConsumers;                  // 0..kProducers - 1
    const uint32_t base = lanes.base[u];
    // z: rows pt / 4 + 32 r of the tile, 8-column chunks (pt % 4) + 4 j
    const int zr = pt / 4, zq = pt % 4;
    uint4 held[Q_PER];                                // int8 chunks in flight

    auto load_x_w = [&](int t) {
      bf16* st = smem + (t % STAGES) * STAGE;
      const int k0 = t * BK;
      // X tile: BM rows x BK / 8 chunks of 8
#pragma unroll
      for (int i = 0; i < X_PER; ++i) {
        const int c = pt + kProducers * i, r = c / (BK / 8);
        const int col = (c % (BK / 8)) * 8;
        bf16* dst = st + sw_off(r, col / 8);
        const int gm = m0 + r, gk = k0 + col;
        if constexpr (VEC) {
          const bool ok = gm < m && gk < k;
          cp_async16(dst, ok ? x + static_cast<int64_t>(gm) * k + gk : x,
                     ok ? 16 : 0);
        } else {
          *reinterpret_cast<uint4*>(dst) = load8_elems(x, gm, m, gk, k);
        }
      }
      if constexpr (!kInt8) {
        // W tile: BK rows x BN / 8 chunks of 8
        bf16* ws = st + X_TILE;
#pragma unroll
        for (int i = 0; i < W_PER; ++i) {
          const int c = pt + kProducers * i, r = c / (BN / 8);
          const int col = (c % (BN / 8)) * 8;
          bf16* dst = ws + sw_off(r, col / 8);
          const int gk = k0 + r, gn = n0 + col;
          *reinterpret_cast<uint4*>(dst) = load8_elems(w, gk, k, gn, n);
        }
      }
    };
    // int8 q tile: BK rows x BN / 16 chunks of 16, read into registers
    // first and widened into the ring later
    auto fetch_q = [&](int t) {
      if constexpr (kInt8) {
        const int k0 = t * BK;
#pragma unroll
        for (int i = 0; i < Q_PER; ++i) {
          const int c = pt + kProducers * i, r = c / (BN / 16);
          const int gk = k0 + r, gn = n0 + (c % (BN / 16)) * 16;
          const int8_t* src = w + static_cast<int64_t>(gk) * n + gn;
          if constexpr (VEC) {
            held[i] = (gk < k && gn < n)
                          ? __ldg(reinterpret_cast<const uint4*>(src))
                          : make_uint4(0u, 0u, 0u, 0u);
          } else {
            uint32_t b[4] = {0u, 0u, 0u, 0u};
#pragma unroll
            for (int e = 0; e < 16; ++e)
              if (gk < k && gn + e < n)
                b[e / 4] |= static_cast<uint32_t>(
                                static_cast<uint8_t>(src[e])) << (8 * (e % 4));
            held[i] = make_uint4(b[0], b[1], b[2], b[3]);
          }
        }
      }
    };
    auto store_q = [&](int t) {
      if constexpr (kInt8) {
        bf16* ws = smem + (t % STAGES) * STAGE + X_TILE;
#pragma unroll
        for (int i = 0; i < Q_PER; ++i) {
          const int c = pt + kProducers * i, r = c / (BN / 16);
          const int col = (c % (BN / 16)) * 16;
          const uint32_t v[4] = {held[i].x, held[i].y, held[i].z, held[i].w};
          uint32_t o[8];
#pragma unroll
          for (int e = 0; e < 4; ++e) i8x4_to_bf16(v[e], o[2 * e], o[2 * e + 1]);
          *reinterpret_cast<uint4*>(ws + sw_off(r, col / 8)) =
              make_uint4(o[0], o[1], o[2], o[3]);
          *reinterpret_cast<uint4*>(ws + sw_off(r, col / 8 + 1)) =
              make_uint4(o[4], o[5], o[6], o[7]);
        }
      }
    };
    auto make_z = [&](int t) {
      bf16* zs = smem + (t % STAGES) * STAGE + X_TILE + W_TILE;
      const uint32_t p1 = dim_prime(prime_offset + 1);
#pragma unroll
      for (int rr = 0; rr < BK / 32; ++rr) {
        const int row = zr + 32 * rr;
        const uint32_t h_row =
            fold(base, static_cast<uint32_t>(t * BK + row) + lanes.row0,
                 prime_offset);
#pragma unroll
        for (int j = 0; j < BN / 32; ++j) {
          const int col = (zq + 4 * j) * 8;
          uint32_t np = (static_cast<uint32_t>(n0 + col) + lanes.col0) * p1;
          uint32_t o[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const uint32_t sa = z_sign(h_row, np);
            const uint32_t sb = z_sign(h_row, np + p1);
            np += 2u * p1;
            o[e] = z_pair(sa, sb);
          }
          *reinterpret_cast<uint4*>(zs + sw_off(row, col / 8)) =
              make_uint4(o[0], o[1], o[2], o[3]);
        }
      }
    };

    // The copies run STAGES - 1 tiles ahead (one commit group a tile,
    // empty past the end); the hash of tile t runs first in its turn,
    // into a stage freed before tile t's copies were issued, so it
    // overlaps the consumers' work on tile t - 1. Generic-proxy writes
    // (cp.async, st.shared) are fenced for wgmma's async proxy before
    // tile t is handed over.
    for (int t = 0; t < STAGES - 1; ++t) {
      if (t < n_tiles) {
        load_x_w(t);
        fetch_q(t);
        store_q(t);
      }
      cp_async_commit();
    }
    for (int t = 0; t < n_tiles; ++t) {
      const int ahead = t + STAGES - 1;
      const bool issue = ahead < n_tiles;
      if (issue) fetch_q(ahead);
      make_z(t);
      cp_async_wait<STAGES - 2>();     // tile t's copies have landed
      fence_async_smem();              // visible to wgmma's async proxy
      bar_arrive(BAR_FULL + t % STAGES);
      // the consumers free tile t - 1's stage once tile t's products are
      // issued, so this wait comes after tile t is handed over
      if (issue) {
        if (ahead >= STAGES) bar_sync(BAR_EMPTY + ahead % STAGES);
        load_x_w(ahead);
        store_q(ahead);
      }
      cp_async_commit();
    }
    return;
  }

  // -------------------------------------------------------------- consumers
  // warpgroup wg owns rows wg * 128 .. + 127 of the block, all 64
  // columns, as MT row tiles of 64
  constexpr int MT = BM / 2 / 64;
  const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  float acc_w[MT][32], acc_z[MT][32];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc_w[i][e] = acc_z[i][e] = 0.0f;

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % STAGES;
    bar_sync(BAR_FULL + s);
    const bf16* xs = smem + s * STAGE + wg * MT * 64 * BK;
    const bf16* ws = smem + s * STAGE + X_TILE;
    const bf16* zs = ws + W_TILE;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      // A: k16 steps are 32 bytes along the swizzled row, row tiles 64
      // rows apart; B: two 8-k groups (2 x SBO) a step (one 64-n pattern,
      // so LBO is not read)
      const uint64_t dw = gmma_desc(ws + kk * 64, 1024, 1024);
      const uint64_t dz = gmma_desc(zs + kk * 64, 1024, 1024);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const uint64_t da = gmma_desc(xs + i * 64 * BK + kk, 16, 1024);
        wgmma_64(acc_w[i], da, dw);
        wgmma_64(acc_z[i], da, dz);
      }
    }
    wgmma_commit();
    wgmma_wait<1>();                   // tile t - 1's products are done
    if (t >= 1 && t - 1 + STAGES < n_tiles)
      bar_arrive(BAR_EMPTY + (t - 1) % STAGES);
  }
  wgmma_wait<0>();

  // epilogue: Y = acc_W (* s_n) + c * acc_z; row tile i's fragment holds
  // rows warp * 16 + lane / 4 (+ 8) and columns 8 j + 2 (lane % 4) (+ 1)
  const float coeff = lanes.coeff[u];
  const int g = lane / 4, q2 = (lane % 4) * 2;
  const bool pairs = (n % 2) == 0;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + j * 8 + q2;
    if (col >= n) continue;
    float s0 = 1.0f, s1 = 1.0f;
    if constexpr (kInt8) {
      s0 = scale[col];
      s1 = col + 1 < n ? scale[col + 1] : 0.0f;
    }
#pragma unroll
    for (int r = 0; r < 2 * MT; ++r) {
      const int i = r / 2, h = r % 2;
      const int row = m0 + (wg * MT + i) * 64 + warp * 16 + g + 8 * h;
      if (row >= m) continue;
      float v0 = acc_w[i][4 * j + 2 * h], v1 = acc_w[i][4 * j + 2 * h + 1];
      if constexpr (kInt8) {
        v0 = __fmul_rn(v0, s0);
        v1 = __fmul_rn(v1, s1);
      }
      v0 = __fmaf_rn(coeff, acc_z[i][4 * j + 2 * h], v0);
      v1 = __fmaf_rn(coeff, acc_z[i][4 * j + 2 * h + 1], v1);
      bf16* dst = y + static_cast<int64_t>(row) * n + col;
      if (pairs) {
        *reinterpret_cast<__nv_bfloat162*>(dst) =
            __floats2bfloat162_rn(v0, v1);
      } else {
        dst[0] = __float2bfloat16_rn(v0);
        if (col + 1 < n) dst[1] = __float2bfloat16_rn(v1);
      }
    }
  }
}

template <typename TW, bool VEC>
int launch_vec(const void* x, const void* w, const float* scale, void* y,
               int m, int k, int n, int64_t w_stride, int w_lanes,
               const Lanes& lanes, int n_lanes, int prime_offset,
               cudaStream_t st) {
  auto kern = zo_matmul_tc_kernel<TW, VEC>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  dim3 grid((m + BM - 1) / BM, (n + BN - 1) / BN, n_lanes);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  kern<<<grid, kThreads, SMEM_BYTES, st>>>(
      static_cast<const bf16*>(x), static_cast<const TW*>(w), scale,
      static_cast<bf16*>(y), m, k, n, w_stride, w_lanes, lanes,
      prime_offset);
  return static_cast<int>(cudaGetLastError());
}

// TW: bf16 (W of X's dtype) or int8_t (with column scales). A bf16 W
// reaches this body only where the Hopper body cannot load it (use_tma),
// so it always takes element loads; an int8 q takes 16-byte loads where
// K, N, the bases and the lane stride allow them.
template <typename TW>
int launch(const void* x, const void* w, const float* scale, void* y, int m,
           int k, int n, int64_t w_stride, int w_lanes, const Lanes& lanes,
           int n_lanes, int prime_offset, cudaStream_t st) {
  if constexpr (std::is_same_v<TW, int8_t>) {
    if (k % 8 == 0 && n % 16 == 0 && w_stride % 16 == 0 && aligned(x, 16) &&
        aligned(w, 16))
      return launch_vec<TW, true>(x, w, scale, y, m, k, n, w_stride, w_lanes,
                                  lanes, n_lanes, prime_offset, st);
  }
  return launch_vec<TW, false>(x, w, scale, y, m, k, n, w_stride, w_lanes,
                               lanes, n_lanes, prime_offset, st);
}

}  // namespace tc

// ---------------------------------------------------------------------------
// the Hopper tensor-core body (bf16 X and W, Rademacher z, 16-byte rows)

namespace tma {

using bf16 = __nv_bfloat16;
using tc::gmma_desc_at;
using tc::smem_u32;
using tc::sw_off;
using tc::wgmma_commit;
using tc::wgmma_fence;
using tc::wgmma_wait;

constexpr int BM = 128, BN = 128, BK = 64, STAGES = 4;
constexpr int kConsumerGroups = 2, kProducerWarps = 4;
constexpr int kConsumers = kConsumerGroups * 128;                 // 256
constexpr int kThreads = kConsumers + kProducerWarps * 32;        // 384
constexpr int kProducers = kThreads - kConsumers;                 // 128
// CTAs a cluster: they take consecutive 128-row tiles of one column
// strip, so each loads and hashes 1 / kCluster of every stage's W and z
// rows and z is hashed once per kCluster * BM rows of X
constexpr int kCluster = 2;
constexpr int kGroup = 8;      // clusters' row blocks a raster group (place)
// registers a thread after setmaxnreg: the producers give up what the
// consumers take (168 a thread at launch, 384 threads an SM); more would
// leave the consumers' setmaxnreg.inc waiting for ever
constexpr int kProducerRegs = 72, kConsumerRegs = 216;
static_assert(kProducerRegs + kConsumerGroups * kConsumerRegs ==
                  (kConsumerGroups + 1) * (65536 / kThreads / 8 * 8),
              "setmaxnreg moves registers, it does not add them");
// A stage: X [BM][BK] K-major (one 128-byte swizzled row a row of X), then
// the joint B tile as four [BK][64] MN-major chunks (one 128-byte swizzled
// row a k): W columns n0 .. n0 + 63, W n0 + 64 .. n0 + 127, then z's two.
// Every chunk starts 1024-byte aligned, the swizzle's period.
constexpr int X_TILE = BM * BK, CHUNK = BK * 64;                  // bf16s
constexpr int STAGE = X_TILE + 4 * CHUNK;
constexpr int SMEM_BYTES = STAGES * STAGE * 2 + 1024;   // + alignment slack
static_assert(BK == 64 && BN == 2 * 64 && BM == kConsumerGroups * 64,
              "one n256 product a consumer warpgroup and k16 step");
static_assert(SMEM_BYTES <= 232448, "shared memory a block can use");
// each CTA's share of a stage's k rows of W and z: ROWS rows of each
// 64-column chunk, 128 bytes a row, rows ROWS * rank .. + ROWS - 1
constexpr int ROWS = BK / kCluster;
static_assert(ROWS % 8 == 0, "whole 8-row swizzle periods a share");
// a stage's bytes, every one of which completes on its full barrier: X by
// TMA (a live CTA), W by TMA multicast, z by st.async
constexpr uint32_t X_BYTES = X_TILE * 2, W_BYTES = 2 * CHUNK * 2;
constexpr uint32_t Z_BYTES = 2 * CHUNK * 2;
// z: each producer thread hashes Z_CHUNKS 8-column chunks of one row
constexpr int Z_CHUNKS = 16 * ROWS / kProducers, Z_ROW_THREADS = 16 / Z_CHUNKS;
static_assert(Z_ROW_THREADS == 4 || Z_ROW_THREADS == 8, "a quarter warp's rows");
// full: the local expect_tx arrival alone (the rest is bytes); empty:
// each consumer warpgroup of every CTA of the cluster
constexpr uint32_t FULL_ARRIVALS = 1;
constexpr uint32_t EMPTY_ARRIVALS = kCluster * kConsumerGroups;

// two z as bf16 +-1, tc::z_pair's bits in two instructions: the permute
// copies bit 31 of sa into bits 8-15 and of sb into bits 24-31
__device__ __forceinline__ uint32_t z_pair(uint32_t sa, uint32_t sb) {
  return (__byte_perm(sa, sb, 0xF0B0) & 0x80008000u) | 0x3F803F80u;
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// every thread of every CTA of the cluster
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n"
               "barrier.cluster.wait.acquire;\n" ::: "memory");
}
// the address of local shared address `a` in CTA `rank` of the cluster
__device__ __forceinline__ uint32_t map_rank(uint32_t a, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r) : "r"(a), "r"(rank));
  return r;
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}
// The consumers' wait on a full stage acquires at cluster scope: its z
// rows arrive by st.async from every CTA of the cluster (then fenced for
// wgmma's async proxy), its X and W by TMA. The producers' wait on an
// empty stage, and the consumers' arrivals that free it, order reads
// before writes and stay at CTA scope.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar), "r"(parity) : "memory");
}
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar,
                                                  uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%0], "
      "%1;\n@!p bra WAIT;\n}\n" ::"r"(bar), "r"(parity) : "memory");
}
// an arrival on a barrier of either CTA (a shared::cluster address)
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}
// box (c0, c1, c2) of a 3-D tensor map into this CTA's shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}
// the same into every CTA of the cluster, at the same offsets, each on
// its own barrier
__device__ __forceinline__ void tma_load_all(uint32_t dst,
                                             const CUtensorMap* map,
                                             uint32_t bar, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%3, %4, %5}], [%2], %6;\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
      "r"(c1), "r"(c2), "h"(static_cast<uint16_t>((1 << kCluster) - 1))
      : "memory");
}
// four words into shared::cluster address a (this CTA's or another's),
// completing 16 bytes on that CTA's barrier bar (a shared::cluster
// address too)
__device__ __forceinline__ void st_async(uint32_t a, const uint32_t (&v)[4],
                                         uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(a), "r"(v[0]), "r"(v[1]), "r"(v[2]),
      "r"(v[3]), "r"(bar)
      : "memory");
}

#define REPRO_F8(i)                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),              \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
// d (64 x 256 f32, a warpgroup's fragment) = A (64 x 16, K-major) *
// B (16 x 256, MN-major) (+ d if accumulate), both from shared memory:
// the joint product. Only wgmma defines d (no zeroing), so ptxas keeps
// the products in flight.
__device__ __forceinline__ void wgmma_256(float (&d)[128], uint64_t da,
                                          uint64_t db, bool accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : REPRO_F8(0), REPRO_F8(8), REPRO_F8(16), REPRO_F8(24), REPRO_F8(32),
        REPRO_F8(40), REPRO_F8(48), REPRO_F8(56), REPRO_F8(64),
        REPRO_F8(72), REPRO_F8(80), REPRO_F8(88), REPRO_F8(96),
        REPRO_F8(104), REPRO_F8(112), REPRO_F8(120)
      : "l"(da), "l"(db), "r"(static_cast<int>(accumulate)));
}
#undef REPRO_F8

// Output tile `tile` of a launch: lane u, X rows [m0, m0 + BM) of this
// CTA (the cluster's row block is kCluster tiles of BM rows, one a CTA),
// W columns [n0, n0 + BN). Lanes outermost; inside a lane, groups of
// kGroup row blocks, and inside a group row blocks fastest, then column
// strips: the clusters that run together share W strips, and a group's
// X rows stay in L2 while its strips go by.
struct Place {
  int u, m0, n0;
};
__device__ __forceinline__ Place place(int tile, int m_blocks, int n_strips,
                                       uint32_t rank) {
  const int per_lane = m_blocks * n_strips;
  const int u = tile / per_lane, r = tile % per_lane;
  const int first = r / (kGroup * n_strips) * kGroup;
  const int blocks = min(kGroup, m_blocks - first);
  const int local = r - first * n_strips;
  return {u, ((first + local % blocks) * kCluster + static_cast<int>(rank)) *
                 BM,
          local / blocks * BN};
}

// Persistent: each cluster walks the tiles cluster, cluster + clusters,
// ...; its CTAs take the row block's kCluster tiles of one column strip.
// Each CTA loads its X rows by TMA, ROWS k rows of the stage's W (both
// chunks, multicast into every CTA) and hashes ROWS k rows of z, which
// it writes into every CTA's ring: z is hashed once per kCluster * BM
// rows of X. A CTA whose rows lie past M still loads and hashes its share
// for the others.
__global__ void __launch_bounds__(kThreads, 1)
zo_matmul_tc_kernel(const __grid_constant__ CUtensorMap tx,
                    const __grid_constant__ CUtensorMap tw,
                    bf16* __restrict__ y, int m, int k, int n, int w_lanes,
                    int n_lanes, Lanes lanes, int prime_offset) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  // the same offsets in every CTA: multicast and copies rely on it
  unsigned char* const ring_p =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t ring = smem_u32(ring_p);
  const int tid = threadIdx.x;
  const uint32_t rank = cluster_rank();
  const int m_blocks = (m + kCluster * BM - 1) / (kCluster * BM);
  const int n_strips = (n + BN - 1) / BN;
  const int tiles = m_blocks * n_strips * n_lanes;
  const int k_tiles = (k + BK - 1) / BK;
  const int cluster = blockIdx.x / kCluster;
  const int clusters = gridDim.x / kCluster;
  const uint32_t full0 = smem_u32(&full[0]), empty0 = smem_u32(&empty[0]);
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, FULL_ARRIVALS);
      mbar_init(empty0 + 8 * s, EMPTY_ARRIVALS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();     // every CTA's barriers exist before any arrival

  if (tid >= kConsumers) {
    // ------------------------------------------------------------ producers
    // Every stage: thread pt hashes Z_CHUNKS 8-column chunks c = q +
    // Z_ROW_THREADS j (q = pt % Z_ROW_THREADS; z's chunk c / 8, column
    // group c % 8) of one of this CTA's ROWS z rows, and writes each into
    // every CTA's ring by st.async, whose bytes complete on that CTA's
    // full barrier as TMA bytes do: no local store to wait for, no fence,
    // no hand-over. A quarter warp's rows differ in bit 2, so its 16-byte
    // writes land on eight distinct swizzled bank groups.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs)
                 : "memory");
    const int pt = tid - kConsumers;
    const uint32_t p1 = dim_prime(prime_offset + 1);
    const int row0 = ROWS * static_cast<int>(rank);   // this CTA's k rows
    const int lane = pt % 32, q = pt % Z_ROW_THREADS;
    const int zrow = row0 + pt / 32 * (32 / Z_ROW_THREADS) + lane / 8 +
                     4 * (lane % 8 / Z_ROW_THREADS);
    uint32_t zoff[Z_CHUNKS];
#pragma unroll
    for (int j = 0; j < Z_CHUNKS; ++j) {
      const int c = q + Z_ROW_THREADS * j;
      zoff[j] = 2 * (X_TILE + (2 + c / 8) * CHUNK + sw_off(zrow, c % 8));
    }
    uint32_t rings[kCluster], fulls[kCluster];        // every CTA's
#pragma unroll
    for (int r = 0; r < kCluster; ++r) {
      rings[r] = map_rank(ring, r);
      fulls[r] = map_rank(full0, r);
    }
    uint32_t it = 0;                  // stages used so far, over all tiles
    for (int tile = cluster; tile < tiles; tile += clusters) {
      const Place at = place(tile, m_blocks, n_strips, rank);
      const uint32_t base = lanes.base[at.u];
      const bool live = at.m0 < m;
      uint32_t np0[Z_CHUNKS];
#pragma unroll
      for (int j = 0; j < Z_CHUNKS; ++j)
        np0[j] = (static_cast<uint32_t>(at.n0 + 8 * (q + Z_ROW_THREADS * j)) +
                  lanes.col0) * p1;
      for (int kt = 0; kt < k_tiles; ++kt, ++it) {
        const uint32_t s = it % STAGES;
        const uint32_t full = full0 + 8 * s;
        const uint32_t st = ring + 2 * s * STAGE;
        // every CTA's consumers are done with stage s (first pass: free)
        mbar_wait(empty0 + 8 * s, ((it / STAGES) & 1u) ^ 1u);
        // a TMA issue holds its warp up to hundreds of cycles, so the
        // three go to three warps' lane 0 and each warp's hash starts late
        // by one issue alone
        if (pt == 0) {
          mbar_expect_tx(full, (live ? X_BYTES : 0u) + W_BYTES + Z_BYTES);
          if (live) tma_load(st, &tx, full, kt * BK, at.m0, at.u);
        } else if (pt == 32 || pt == 64) {
          // W rows row0 .. + ROWS - 1 of chunk h, into every CTA
          const int h = pt / 32 - 1;
          tma_load_all(st + 2 * (X_TILE + h * CHUNK + row0 * 64), &tw, full,
                       at.n0 + 64 * h, kt * BK + row0, at.u % w_lanes);
        }
        // the stage's z rows at the ABSOLUTE (k, n) coordinates, as bf16
        // +-1
        const uint32_t h_row =
            fold(base, static_cast<uint32_t>(kt * BK + zrow) + lanes.row0,
                 prime_offset);
#pragma unroll
        for (int j = 0; j < Z_CHUNKS; ++j) {
          uint32_t np = np0[j];
          uint32_t o[4];
#pragma unroll
          for (int e = 0; e < 4; ++e, np += 2u * p1)
            o[e] = z_pair(z_sign(h_row, np), z_sign(h_row, np + p1));
#pragma unroll
          for (int r = 0; r < kCluster; ++r)
            st_async(rings[r] + 2 * s * STAGE + zoff[j], o, fulls[r] + 8 * s);
        }
      }
    }
    cluster_sync();   // no CTA leaves while another may write into it
    return;
  }

  // -------------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs)
               : "memory");
  // warpgroup wg owns rows wg * 64 .. + 63 of the CTA's tile; its
  // fragment's first 128 columns are X W, the last 128 X z
  const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  // thread r < kCluster of a warpgroup frees stage s in CTA r
  const uint32_t empty_r = map_rank(empty0, tid % 128 % kCluster);
  auto release = [&](uint32_t s) {
    if (tid % 128 < kCluster) mbar_arrive(empty_r + 8 * s);
  };
  float acc[128];
  uint32_t it = 0;
  for (int tile = cluster; tile < tiles; tile += clusters) {
    const Place at = place(tile, m_blocks, n_strips, rank);
    const bool live = at.m0 < m;
    for (int kt = 0; kt < k_tiles; ++kt, ++it) {
      const uint32_t s = it % STAGES;
      mbar_wait_cluster(full0 + 8 * s, (it / STAGES) & 1u);
      tc::fence_async_smem();         // the st.async z rows, for wgmma
      if (live) {
        const uint32_t xs = ring + 2 * (s * STAGE + wg * 64 * BK);
        const uint32_t bs = ring + 2 * (s * STAGE + X_TILE);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK; kk += 16) {
          // A: k16 steps 32 bytes along the swizzled row (SBO: 8 rows);
          // B: 16 k rows (2 x SBO) a step, LBO the 64-column chunks
          wgmma_256(acc, gmma_desc_at(xs + 2 * kk, 16, 1024),
                    gmma_desc_at(bs + 2 * kk * 64, 2 * CHUNK, 1024),
                    kt > 0 || kk > 0);
        }
        wgmma_commit();
        wgmma_wait<1>();              // the previous stage's products done
      }
      if (kt >= 1) release((it - 1) % STAGES);
    }
    wgmma_wait<0>();
    release((it - 1) % STAGES);
    if (!live) continue;

    // Y = acc_W + c * acc_z; the fragment holds rows warp * 16 + lane / 4
    // (+ 8) and columns 8 j + 2 (lane % 4) (+ 1); N % 8 == 0, so a pair
    // is whole
    const float coeff = lanes.coeff[at.u];
    bf16* yl = y + static_cast<int64_t>(at.u) * m * n;
    const int col0 = at.n0 + 2 * (lane % 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = at.m0 + wg * 64 + warp * 16 + lane / 4 + 8 * h;
      if (row >= m) continue;
      bf16* yr = yl + static_cast<int64_t>(row) * n;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = col0 + 8 * j;
        if (col >= n) continue;
        const float v0 = __fmaf_rn(coeff, acc[4 * (j + 16) + 2 * h],
                                   acc[4 * j + 2 * h]);
        const float v1 = __fmaf_rn(coeff, acc[4 * (j + 16) + 2 * h + 1],
                                   acc[4 * j + 2 * h + 1]);
        *reinterpret_cast<__nv_bfloat162*>(yr + col) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
  cluster_sync();
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no -lcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q{};
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// a bf16 (d2, d1, d0) tensor, rows of d0 at s1 bytes, planes at s2 bytes,
// boxes of (1, b1, b0) in the 128-byte swizzle; zeros past every edge
bool encode(CUtensorMap* map, const void* p, uint64_t d0, uint64_t d1,
            uint64_t d2, uint64_t s1, uint64_t s2, uint32_t b0, uint32_t b1) {
  const EncodeTiled fn = encode_tiled();
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {s1, s2};
  const cuuint32_t box[3] = {b0, b1, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn != nullptr &&
         fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(p),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

cudaLaunchConfig_t config(unsigned clusters, cudaStream_t st,
                          cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kCluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(kCluster * clusters, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = SMEM_BYTES;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// the clusters the card holds at once (queried once a device)
int max_clusters() {
  static std::atomic<int> cached[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  int c = cached[dev].load(std::memory_order_relaxed);
  if (c == 0) {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg =
        config(sm_count() / kCluster, nullptr, &attr);
    if (cudaOccupancyMaxActiveClusters(&c, zo_matmul_tc_kernel, &cfg) !=
        cudaSuccess)
      return 0;
    cached[dev].store(c, std::memory_order_relaxed);
  }
  return c;
}

int launch(const void* x, const void* w, void* y, int m, int k, int n,
           int64_t w_stride, int w_lanes, const Lanes& lanes, int n_lanes,
           int prime_offset, cudaStream_t st) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      zo_matmul_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  CUtensorMap tx, tw;
  const uint64_t plane = w_lanes > 1 ? w_stride : static_cast<int64_t>(k) * n;
  if (!encode(&tx, x, k, m, n_lanes, 2ull * k, 2ull * m * k, BK, BM) ||
      !encode(&tw, w, n, k, w_lanes, 2ull * n, 2 * plane, 64, ROWS))
    return static_cast<int>(cudaErrorInvalidValue);
  const int cap = max_clusters();
  if (cap <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  const int64_t tiles =
      static_cast<int64_t>((m + kCluster * BM - 1) / (kCluster * BM)) *
      ((n + BN - 1) / BN) * n_lanes;
  if (tiles > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute cluster;
  const cudaLaunchConfig_t cfg =
      config(static_cast<unsigned>(std::min<int64_t>(tiles, cap)), st,
             &cluster);
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, zo_matmul_tc_kernel, tx, tw, static_cast<bf16*>(y), m, k, n,
      w_lanes, n_lanes, lanes, prime_offset);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace tma

// the body rule: bf16 X (dtype 1) with Rademacher z (dist 0) runs on the
// tensor cores, everything else on the SIMT body
bool use_tc(int dtype, int dist) { return dtype == 1 && dist == 0; }

// The tensor-core route: the Hopper body (tma::) where TMA can load X and
// W -- a bf16 W, 16-byte rows (K, N and W's lane stride multiples of 8)
// and 16-byte bases -- else the 256 x 64 body (tc::): int8 q, ragged or
// unaligned rows. Values do not decide it, nor M.
bool use_tma(bool int8, int k, int n, int64_t w_stride, const void* x,
             const void* w) {
  return !int8 && k % 8 == 0 && n % 8 == 0 && w_stride % 8 == 0 &&
         aligned(x, 16) && aligned(w, 16);
}

Lanes one_lane(uint32_t base, float coeff, uint32_t row0, uint32_t col0) {
  Lanes lanes{};
  lanes.base[0] = base;
  lanes.coeff[0] = coeff;
  lanes.row0 = row0;
  lanes.col0 = col0;
  return lanes;
}

bool bad_args(int m, int k, int n, int prime_offset, int dist) {
  return m <= 0 || k <= 0 || n <= 0 || prime_offset < 0 ||
         prime_offset + 2 > kMaxRank || (dist != 0 && dist != 1);
}

// every entry point: the body by (dtype, dist), W of X's dtype (scale
// null) or int8 with column scales
int run(const void* x, const void* w, const float* scale, void* y,
        int dtype, int m, int k, int n, int64_t w_stride, int w_lanes,
        const Lanes& lanes, int n_lanes, int prime_offset, int dist,
        cudaStream_t st) {
  using bf16 = __nv_bfloat16;
  if (use_tc(dtype, dist)) {
    if (use_tma(scale != nullptr, k, n, w_stride, x, w))
      return tma::launch(x, w, y, m, k, n, w_stride, w_lanes, lanes, n_lanes,
                         prime_offset, st);
    return scale == nullptr
               ? tc::launch<bf16>(x, w, nullptr, y, m, k, n, w_stride,
                                  w_lanes, lanes, n_lanes, prime_offset, st)
               : tc::launch<int8_t>(x, w, scale, y, m, k, n, w_stride,
                                    w_lanes, lanes, n_lanes, prime_offset,
                                    st);
  }
  if (dtype == 0)
    return scale == nullptr
               ? simt::launch<float, float>(x, w, nullptr, y, m, k, n,
                                            w_stride, w_lanes, lanes,
                                            n_lanes, prime_offset, dist, st)
               : simt::launch<float, int8_t>(x, w, scale, y, m, k, n,
                                             w_stride, w_lanes, lanes,
                                             n_lanes, prime_offset, dist, st);
  if (dtype == 1)
    return scale == nullptr
               ? simt::launch<bf16, bf16>(x, w, nullptr, y, m, k, n,
                                          w_stride, w_lanes, lanes, n_lanes,
                                          prime_offset, dist, st)
               : simt::launch<bf16, int8_t>(x, w, scale, y, m, k, n,
                                            w_stride, w_lanes, lanes,
                                            n_lanes, prime_offset, dist, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

int users(const void* x, const void* w, const float* scale, void* y,
          int dtype, int m, int k, int n, int64_t w_stride, int w_lanes,
          const uint32_t* bases, const float* coeffs, int n_lanes,
          int prime_offset, int dist, void* stream) {
  if (bad_args(m, k, n, prime_offset, dist) || n_lanes <= 0 ||
      n_lanes > kMaxLanes || w_lanes <= 0 || n_lanes % w_lanes != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Lanes lanes{};
  for (int i = 0; i < n_lanes; ++i) {
    lanes.base[i] = bases[i];
    lanes.coeff[i] = coeffs[i];
    lanes.idx[i] = i;
  }
  return run(x, w, scale, y, dtype, m, k, n, w_stride, w_lanes, lanes,
             n_lanes, prime_offset, dist, static_cast<cudaStream_t>(stream));
}

}  // namespace
}  // namespace repro_torch

// The body a launch with this X dtype (0 float32, 1 bfloat16), z dist (0
// Rademacher, 1 Gaussian), W (int8: 1 for an int8 q), K, N, W lane stride
// (elements; 0 for one W) and X / W bases (lane 0's) runs: 0 the SIMT
// body, 1 the 256 x 64 tensor-core body, 2 the Hopper tensor-core body --
// the rule every zo_matmul entry point below follows.
extern "C" int repro_zo_matmul_body(int dtype, int dist, int int8, int k,
                                    int n, int64_t w_stride, const void* x,
                                    const void* w) {
  using namespace repro_torch;
  if (!use_tc(dtype, dist)) return 0;
  return use_tma(int8 != 0, k, n, w_stride, x, w) ? 2 : 1;
}

// The SIMT body's tile for a launch of m x n outputs a lane on `lanes`
// lanes over `sms` SMs (sms <= 0: the current device's): its index in
// (256 x 128, 128 x 128, 128 x 64, 64 x 64); -1 for bad arguments.
extern "C" int repro_zo_matmul_simt_tile(int m, int n, int lanes, int sms) {
  using namespace repro_torch;
  if (sms <= 0) sms = sm_count();
  if (m <= 0 || n <= 0 || lanes <= 0 || sms <= 0) return -1;
  return simt::pick_tile(m, n, lanes, sms);
}

// x (M, K), w (K, N), y (M, N): contiguous, one dtype (0 float32,
// 1 bfloat16). base: the pre-hashed z base (leaf_base, plus any layer
// fold); prime_offset: primes of (k, n) are P[po], P[po + 1]. dist 0
// Rademacher, 1 Gaussian. (row0, col0): W's global origin within a larger
// leaf (a shard of it: z is that leaf's slice), zeros for a whole W.
// Returns cudaGetLastError() after the launch.
extern "C" int repro_zo_matmul(const void* x, const void* w, void* y,
                               int dtype, int m, int k, int n, uint32_t base,
                               int prime_offset, float coeff, int dist,
                               int64_t row0, int64_t col0, void* stream) {
  using namespace repro_torch;
  if (bad_args(m, k, n, prime_offset, dist) || row0 < 0 || col0 < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return run(x, w, nullptr, y, dtype, m, k, n, 0, 1,
             one_lane(base, coeff, static_cast<uint32_t>(row0),
                      static_cast<uint32_t>(col0)),
             1, prime_offset, dist, static_cast<cudaStream_t>(stream));
}

// x (M, K) of dtype 0 float32 / 1 bfloat16, q (K, N) int8, scale (N,)
// float32, y (M, N) of x's dtype; the other arguments as for
// repro_zo_matmul. Returns cudaGetLastError() after the launch.
extern "C" int repro_zo_matmul_q(const void* x, const void* q,
                                 const void* scale, void* y, int dtype, int m,
                                 int k, int n, uint32_t base,
                                 int prime_offset, float coeff, int dist,
                                 void* stream) {
  using namespace repro_torch;
  if (bad_args(m, k, n, prime_offset, dist) || scale == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return run(x, q, static_cast<const float*>(scale), y, dtype, m, k, n, 0, 1,
             one_lane(base, coeff, 0, 0), 1, prime_offset, dist,
             static_cast<cudaStream_t>(stream));
}

// x (n_lanes, M, K) and y (n_lanes, M, N) contiguous, of dtype 0 float32
// / 1 bfloat16; w: w_lanes row-major (K, N) weights of x's dtype, lane j
// at w + j * w_stride (elements; 0 for one shared W); lane i multiplies
// by W lane i % w_lanes with bases[i] and coeffs[i]. prime_offset and
// dist as for repro_zo_matmul. Returns cudaGetLastError() after the
// launch.
extern "C" int repro_zo_matmul_users(const void* x, const void* w, void* y,
                                     int dtype, int m, int k, int n,
                                     int64_t w_stride, int w_lanes,
                                     const uint32_t* bases,
                                     const float* coeffs, int n_lanes,
                                     int prime_offset, int dist,
                                     void* stream) {
  return repro_torch::users(x, w, nullptr, y, dtype, m, k, n, w_stride,
                            w_lanes, bases, coeffs, n_lanes, prime_offset,
                            dist, stream);
}

// x, y, bases, coeffs as for repro_zo_matmul_users; q (K, N) int8 and
// scale (N,) float32: one shared int8 base. Returns cudaGetLastError()
// after the launch.
extern "C" int repro_zo_matmul_users_q(const void* x, const void* q,
                                       const void* scale, void* y, int dtype,
                                       int m, int k, int n,
                                       const uint32_t* bases,
                                       const float* coeffs, int n_lanes,
                                       int prime_offset, int dist,
                                       void* stream) {
  if (scale == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return repro_torch::users(x, q, static_cast<const float*>(scale), y, dtype,
                            m, k, n, 0, 1, bases, coeffs, n_lanes,
                            prime_offset, dist, stream);
}
