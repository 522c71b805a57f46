// zo_matmul: Y = X @ (W + coeff * z(seed)) for row-major X (M, K) and
// W (K, N), f32 accumulation, Y in X's dtype (float32 or bfloat16).
//
// Replaces the Pallas kernel _zo_matmul_kernel (src/repro/kernels/
// zo_perturb.py:214, launched by zo_matmul at :292): every dense
// projection of the fused MeZO perturbed forward (Q/K/V/O, the MLP, the
// LM head), so the perturbation never exists in device memory.
//
// Bound: operations. The reference dots true f32 (preferred_element_type
// f32 on an f32 perturbed tile), so tensor cores (TF32 or bf16 inputs)
// are out and the peak is the f32 SIMT rate; at the training shapes
// (M = B * S = 1024, K >= 1024) the product is far above the bytes line.
// The design: a classic SIMT tiling, a 128 x 128 output block per
// 256-thread block, each thread an 8 x 8 register tile, the K loop in
// steps of 8 through shared memory. While the W tile is staged it is
// perturbed: w' = __fadd_rn(w, __fmul_rn(c, z)) with z hashed at the
// ABSOLUTE (k, n) coordinates (zo_hash.cuh), so w' is the plain
// version's f32 value bit for bit with Rademacher z. Each thread hashes
// one row of the tile once and folds four columns. The hash of a weight
// is repeated once per 128-row block of X (8 times at M = 1024). Edges
// are masked in M, K and N: OPT's LM head has N = 50272 and M is any
// batch * sequence.
//
// zo_matmul_q: Y = X @ (q * s + coeff * z(seed)) for an int8 W (K, N)
// with per-column f32 scales s (N,) -- the same kernel, instantiated
// with an int8 W tile that is dequantized with its column's scale on the
// way into shared memory: w' = __fadd_rn(__fmul_rn(q, s), __fmul_rn(c,
// z)), the plain version's f32 value bit for bit with Rademacher z
// (power-of-two scales make q * s exact).
//
// Replaces the Pallas kernel _zo_matmul_q_kernel (src/repro/kernels/
// zo_perturb.py:234, launched by zo_matmul(scale=) at :310): every
// projection of the fused perturbed forward over a frozen int8 base, so
// neither the dequantized base nor the perturbation exists in device
// memory. Bound: operations, as for zo_matmul (true f32 dot, SIMT f32
// peak); the weight bytes are a quarter of the f32 kernel's.
//
// zo_matmul_users: Y[i] = X[i] @ (W[i % P] + coeff[i] * z(seed[i])) for
// X (U, M, K) and a W that is shared (P = 1, lane stride 0: the one
// resident base) or stacked per lane (P lanes, any lane stride: a layer
// slice of the multi-tenant state's (P, L, K, N) leaf);
// zo_matmul_users_q: the same over a shared int8 W (K, N) with f32
// column scales, Y[i] = X[i] @ (q * s + coeff[i] * z(seed[i])).
//
// Replace the Pallas kernels _zo_matmul_users_kernel and
// _zo_matmul_users_q_kernel (src/repro/kernels/zo_perturb.py:332 and
// :352, launched by zo_matmul_users at :409 and :428): every projection
// of the multi-tenant step's user-axis forward, one launch for all lanes.
// Bound: operations, as zo_matmul. The design is zo_matmul's kernel
// with the lane as blockIdx.z: the same 128 x 128 x 8 tiles, the same k
// order and the same per-element arithmetic, with the lane's base and
// coefficient, so every lane's bits are those of a lone zo_matmul (or
// zo_matmul_q) launch with that lane's seed and coefficient. A simple
// first version: no wgmma, no TMA, a shared W tile is staged once per
// lane and output block.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "zo_hash.cuh"

namespace repro_torch {
namespace {

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
