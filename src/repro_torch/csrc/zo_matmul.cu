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
// Two bodies, chosen by the launcher from X's dtype and z's dist alone
// (repro_zo_matmul_body), for all four entry points alike:
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
//    TFLOP/s) -- 0.213 ms for OPT-1.3B's LM head at M = 1024, 0.035 ms
//    for a w_in slice -- where the SIMT body's f32 bound was 3.147 and
//    0.513 ms.
//    The design: wgmma (sm_90a; m64n64k16, bf16 in, f32 accumulators)
//    on a 4-stage ring in shared memory (192 KB, tiles in wgmma's
//    128-byte-swizzled layouts); 384 threads, warp specialised. Two
//    consumer warpgroups own a 256 x 64 output block, 128 rows (two
//    64-row tiles) each, with two accumulators, X W (or X q) and X z,
//    both read by wgmma straight from the ring. One producer warpgroup
//    fills it, tile by tile (BK = 64): X and a bf16 W by 16-byte cp.async
//    (zero-filled at the edges), an int8 q tile loaded 16 bytes a thread
//    and widened to bf16 on the way into shared memory, and the z tile
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
//    tiles read X and W fewer times. Rows of X whose length or base is
//    not a multiple of 16 bytes (K = 33) take element loads into the
//    same ring: a load route does not change a value. Blocks walk M
//    fastest, so the blocks that share a W column strip run together
//    and W is read from device memory about once.
//    Y = acc_W (* s_n) + c * acc_z.
//
// 2. f32 X, or Gaussian z: the SIMT body, unchanged from the first port.
//    The reference dots true f32 (preferred_element_type f32 on an f32
//    perturbed tile), and neither f32 X nor Gaussian z is exact in bf16,
//    so tensor cores are out; the bound is operations at the f32 SIMT
//    rate. A 128 x 128 output block per 256-thread block, each thread an
//    8 x 8 register tile, the K loop in steps of 8 through shared memory.
//    While the W tile is staged it is perturbed: w' = __fadd_rn(w,
//    __fmul_rn(c, z)) (an int8 tile: w' = __fadd_rn(__fmul_rn(q, s),
//    __fmul_rn(c, z))), the plain version's f32 value bit for bit with
//    Rademacher z. Edges are masked in M, K and N.
//
// Lanes: in both bodies the lane is blockIdx.z and the per-lane scalars
// travel in the Lanes struct; the tile shape, the k order and the
// per-element arithmetic depend neither on the number of lanes nor on
// the entry point (a lone launch is the one-lane case of the same
// kernel in the tensor-core body), so every lane's bits are those of a
// lone zo_matmul (or zo_matmul_q) launch with that lane's seed and
// coefficient.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "zo_hash.cuh"

namespace repro_torch {
namespace {

// ---------------------------------------------------------------------------
// the SIMT body (f32 X, or Gaussian z)

constexpr int kBM = 128, kBN = 128, kBK = 8, kTM = 8, kTN = 8;
constexpr int kThreads = (kBM / kTM) * (kBN / kTN);  // 256

__device__ __forceinline__ float mm_f32(float x) { return x; }
__device__ __forceinline__ float mm_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
// W element (gk, gn) as f32: a float/bf16 weight as it is, an int8 one
// times its column's scale (exact with power-of-two scales)
template <typename TW>
__device__ __forceinline__ float w_f32(const TW* w, const float*,
                                       int64_t idx, int64_t) {
  return mm_f32(w[idx]);
}
__device__ __forceinline__ float w_f32(const int8_t* w, const float* scale,
                                       int64_t idx, int64_t col) {
  return __fmul_rn(static_cast<float>(w[idx]), scale[col]);
}
template <typename T>
__device__ __forceinline__ T mm_out(float x);
template <>
__device__ __forceinline__ float mm_out<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 mm_out<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// one 128 x 128 output block (blockIdx.x, blockIdx.y) of X @ W'
template <typename T, typename TW>
__device__ __forceinline__ void zo_matmul_block(
    float (&xs)[kBK][kBM], float (&ws)[kBK][kBN], const T* __restrict__ x,
    const TW* __restrict__ w, const float* __restrict__ scale,
    T* __restrict__ y, int m, int k, int n, uint32_t base, int prime_offset,
    float coeff, int dist) {
  const int tid = threadIdx.x;
  const int tx = tid % (kBN / kTN), ty = tid / (kBN / kTN);
  const int64_t m0 = static_cast<int64_t>(blockIdx.y) * kBM;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * kBN;
  // X loads: row m0 + tid / 2, columns (tid % 2) * 4 .. + 3 of the tile
  const int xr = tid / 2, xc = (tid % 2) * 4;
  // W loads: row tid / 32 of the tile, columns tid % 32 + 32 * i
  const int wr = tid / 32, wc = tid % 32;
  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < k; k0 += kBK) {
    const int64_t gm = m0 + xr;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gk = k0 + xc + i;
      xs[xc + i][xr] = (gm < m && gk < k)
                           ? mm_f32(x[gm * k + gk]) : 0.0f;
    }
    const int gk = k0 + wr;
    const uint32_t h_row =
        fold(base, static_cast<uint32_t>(gk), prime_offset);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = wc + 32 * i;
      const int64_t gn = n0 + c;
      float v = 0.0f;
      if (gk < k && gn < n) {
        const float z = z_from_bits(
            fold(h_row, static_cast<uint32_t>(gn), prime_offset + 1), dist);
        v = __fadd_rn(w_f32(w, scale, static_cast<int64_t>(gk) * n + gn, gn),
                      __fmul_rn(coeff, z));
      }
      ws[wr][c] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[kTM], b[kTN];
      const float4* ap = reinterpret_cast<const float4*>(&xs[kk][ty * kTM]);
      const float4* bp = reinterpret_cast<const float4*>(&ws[kk][tx * kTN]);
      float4 a0 = ap[0], a1 = ap[1], b0 = bp[0], b1 = bp[1];
      a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
      a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
      b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
      b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int64_t gm = m0 + ty * kTM + i;
    if (gm >= m) break;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int64_t gn = n0 + tx * kTN + j;
      if (gn < n) y[gm * n + gn] = mm_out<T>(acc[i][j]);
    }
  }
}

template <typename T, typename TW>
__global__ void __launch_bounds__(kThreads)
zo_matmul_kernel(const T* __restrict__ x, const TW* __restrict__ w,
                 const float* __restrict__ scale, T* __restrict__ y, int m,
                 int k, int n, uint32_t base, int prime_offset, float coeff,
                 int dist) {
  __shared__ __align__(16) float xs[kBK][kBM];  // X tile, transposed
  __shared__ __align__(16) float ws[kBK][kBN];  // perturbed W tile
  zo_matmul_block<T, TW>(xs, ws, x, w, scale, y, m, k, n, base,
                         prime_offset, coeff, dist);
}

// lane blockIdx.z: X and Y lane z, W lane z % w_lanes at stride w_stride.
// Two blocks an SM: left to itself the int8 instantiation takes 130
// registers a thread, so only one 256-thread block fits on an SM.
template <typename T, typename TW>
__global__ void __launch_bounds__(kThreads, 2)
zo_matmul_users_kernel(const T* __restrict__ x, const TW* __restrict__ w,
                       const float* __restrict__ scale, T* __restrict__ y,
                       int m, int k, int n, int64_t w_stride, int w_lanes,
                       Lanes lanes, int prime_offset, int dist) {
  __shared__ __align__(16) float xs[kBK][kBM];
  __shared__ __align__(16) float ws[kBK][kBN];
  const int u = blockIdx.z;
  const int64_t mk = static_cast<int64_t>(m) * k;
  const int64_t mn = static_cast<int64_t>(m) * n;
  zo_matmul_block<T, TW>(xs, ws, x + u * mk, w + (u % w_lanes) * w_stride,
                         scale, y + u * mn, m, k, n, lanes.base[u],
                         prime_offset, lanes.coeff[u], dist);
}

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
// wgmma shared-memory matrix descriptor, 128-byte swizzle
__device__ __forceinline__ uint64_t gmma_desc(const bf16* p, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | 1ull << 62;
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
// blockIdx.z; VEC: 16-byte loads (K, N, bases and lane strides allow them)
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
          if constexpr (VEC) {
            const bool ok = gk < k && gn < n;
            cp_async16(dst, ok ? w + static_cast<int64_t>(gk) * n + gn : w,
                       ok ? 16 : 0);
          } else {
            *reinterpret_cast<uint4*>(dst) = load8_elems(w, gk, k, gn, n);
          }
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
            fold(base, static_cast<uint32_t>(t * BK + row), prime_offset);
#pragma unroll
        for (int j = 0; j < BN / 32; ++j) {
          const int col = (zq + 4 * j) * 8;
          uint32_t np = static_cast<uint32_t>(n0 + col) * p1;
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

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// TW: bf16 (W of X's dtype) or int8_t (with column scales)
template <typename TW>
int launch(const void* x, const void* w, const float* scale, void* y, int m,
           int k, int n, int64_t w_stride, int w_lanes, const Lanes& lanes,
           int n_lanes, int prime_offset, cudaStream_t st) {
  constexpr int w_vec = std::is_same_v<TW, int8_t> ? 16 : 8;
  const bool vec = k % 8 == 0 && n % w_vec == 0 && w_stride % w_vec == 0 &&
                   aligned16(x) && aligned16(w);
  return vec ? launch_vec<TW, true>(x, w, scale, y, m, k, n, w_stride,
                                    w_lanes, lanes, n_lanes, prime_offset,
                                    st)
             : launch_vec<TW, false>(x, w, scale, y, m, k, n, w_stride,
                                     w_lanes, lanes, n_lanes, prime_offset,
                                     st);
}

}  // namespace tc

// the body rule: bf16 X (dtype 1) with Rademacher z (dist 0) runs on the
// tensor cores, everything else on the SIMT body
bool use_tc(int dtype, int dist) { return dtype == 1 && dist == 0; }

Lanes one_lane(uint32_t base, float coeff) {
  Lanes lanes{};
  lanes.base[0] = base;
  lanes.coeff[0] = coeff;
  return lanes;
}

// TW void: W has X's dtype T; TW int8_t: an int8 W with f32 scales
template <typename T, typename TW>
void launch(const void* x, const void* w, const float* scale, void* y, int m,
            int k, int n, uint32_t base, int prime_offset, float coeff,
            int dist, cudaStream_t st) {
  using W = std::conditional_t<std::is_void_v<TW>, T, TW>;
  dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  zo_matmul_kernel<T, W><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const W*>(w), scale,
      static_cast<T*>(y), m, k, n, base, prime_offset, coeff, dist);
}

template <typename T, typename TW>
void launch_users(const void* x, const void* w, const float* scale, void* y,
                  int m, int k, int n, int64_t w_stride, int w_lanes,
                  const Lanes& lanes, int n_lanes, int prime_offset,
                  int dist, cudaStream_t st) {
  using W = std::conditional_t<std::is_void_v<TW>, T, TW>;
  dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM, n_lanes);
  zo_matmul_users_kernel<T, W><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const W*>(w), scale,
      static_cast<T*>(y), m, k, n, w_stride, w_lanes, lanes, prime_offset,
      dist);
}

bool bad_args(int m, int k, int n, int prime_offset, int dist) {
  return m <= 0 || k <= 0 || n <= 0 || prime_offset < 0 ||
         prime_offset + 2 > kMaxRank || (dist != 0 && dist != 1);
}

}  // namespace
}  // namespace repro_torch

// 1 when a launch with this X dtype (0 float32, 1 bfloat16) and z dist
// (0 Rademacher, 1 Gaussian) runs the tensor-core body, 0 for the SIMT
// body: the rule every zo_matmul entry point below follows.
extern "C" int repro_zo_matmul_body(int dtype, int dist) {
  return repro_torch::use_tc(dtype, dist) ? 1 : 0;
}

// x (M, K), w (K, N), y (M, N): contiguous, one dtype (0 float32,
// 1 bfloat16). base: the pre-hashed z base (leaf_base, plus any layer
// fold); prime_offset: primes of (k, n) are P[po], P[po + 1]. dist 0
// Rademacher, 1 Gaussian. Returns cudaGetLastError() after the launch.
extern "C" int repro_zo_matmul(const void* x, const void* w, void* y,
                               int dtype, int m, int k, int n, uint32_t base,
                               int prime_offset, float coeff, int dist,
                               void* stream) {
  using namespace repro_torch;
  if (bad_args(m, k, n, prime_offset, dist))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (use_tc(dtype, dist))
    return tc::launch<__nv_bfloat16>(x, w, nullptr, y, m, k, n, 0, 1,
                                     one_lane(base, coeff), 1, prime_offset,
                                     st);
  if (dtype == 0)
    launch<float, void>(x, w, nullptr, y, m, k, n, base, prime_offset, coeff,
                        dist, st);
  else if (dtype == 1)
    launch<__nv_bfloat16, void>(x, w, nullptr, y, m, k, n, base,
                                prime_offset, coeff, dist, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
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
  if (bad_args(m, k, n, prime_offset, dist))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sp = static_cast<const float*>(scale);
  if (use_tc(dtype, dist))
    return tc::launch<int8_t>(x, q, sp, y, m, k, n, 0, 1,
                              one_lane(base, coeff), 1, prime_offset, st);
  if (dtype == 0)
    launch<float, int8_t>(x, q, sp, y, m, k, n, base, prime_offset, coeff,
                          dist, st);
  else if (dtype == 1)
    launch<__nv_bfloat16, int8_t>(x, q, sp, y, m, k, n, base, prime_offset,
                                  coeff, dist, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

namespace {

int users(const void* x, const void* w, const float* scale, void* y,
          int dtype, int m, int k, int n, int64_t w_stride, int w_lanes,
          const uint32_t* bases, const float* coeffs, int n_lanes,
          int prime_offset, int dist, void* stream) {
  using namespace repro_torch;
  if (bad_args(m, k, n, prime_offset, dist) || n_lanes <= 0 ||
      n_lanes > kMaxLanes || w_lanes <= 0 || n_lanes % w_lanes != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Lanes lanes{};
  for (int i = 0; i < n_lanes; ++i) {
    lanes.base[i] = bases[i];
    lanes.coeff[i] = coeffs[i];
    lanes.idx[i] = i;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (use_tc(dtype, dist))
    return scale == nullptr
               ? tc::launch<__nv_bfloat16>(x, w, nullptr, y, m, k, n,
                                           w_stride, w_lanes, lanes, n_lanes,
                                           prime_offset, st)
               : tc::launch<int8_t>(x, w, scale, y, m, k, n, w_stride,
                                    w_lanes, lanes, n_lanes, prime_offset,
                                    st);
  if (scale == nullptr && dtype == 0)
    launch_users<float, void>(x, w, nullptr, y, m, k, n, w_stride, w_lanes,
                              lanes, n_lanes, prime_offset, dist, st);
  else if (scale == nullptr && dtype == 1)
    launch_users<__nv_bfloat16, void>(x, w, nullptr, y, m, k, n, w_stride,
                                      w_lanes, lanes, n_lanes, prime_offset,
                                      dist, st);
  else if (dtype == 0)
    launch_users<float, int8_t>(x, w, scale, y, m, k, n, w_stride, w_lanes,
                                lanes, n_lanes, prime_offset, dist, st);
  else if (dtype == 1)
    launch_users<__nv_bfloat16, int8_t>(x, w, scale, y, m, k, n, w_stride,
                                        w_lanes, lanes, n_lanes,
                                        prime_offset, dist, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

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
  return users(x, w, nullptr, y, dtype, m, k, n, w_stride, w_lanes, bases,
               coeffs, n_lanes, prime_offset, dist, stream);
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
  return users(x, q, static_cast<const float*>(scale), y, dtype, m, k, n, 0,
               1, bases, coeffs, n_lanes, prime_offset, dist, stream);
}
