// flash_attention: forward-only GQA attention, causal or bidirectional,
// q (B, S, H, hd), k/v (B, T, KV, hd) -> out (B, S, H, hd) in q's dtype.
//
// Replaces the Pallas kernel _flash_kernel (src/repro/kernels/
// flash_attention.py:32, launched by flash_attention at :100): the
// attention of the training forward when attn_impl == "flash". ZO
// training has no backward pass, so no softmax statistics are kept.
//
// Bound: at the training shapes (S = T = 128..512, hd 64) the score work
// (4 * S * T * hd flops a head, all in f32 outside the tensor cores, as
// the reference computes it) is above the bytes line. The design: one
// block per (batch, head, 32 query rows), 4 warps of 8 rows each. Keys
// go 32 at a time through shared memory as f32 (K padded one float a row
// so that lane j reading key j hits its own bank); lane j scores key j
// for all 8 rows of its warp at once, the warp takes the tile's max and
// sum with one butterfly each, and for P @ V each lane owns hd / 32
// output columns and takes the probabilities by shuffle. The online
// softmax is the reference's: f32, the running max starts at -1e30,
// q is scaled in f32 before the dot, the denominator is max(l, 1e-30).
// Masked keys (causal, or past T) get probability 0; causal key tiles
// wholly above the block's last row are never loaded. Query head h reads
// KV head h / (H / KV). S and T are arbitrary: tails are masked.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace repro_torch {
namespace {

constexpr int kWarps = 4, kRows = 8, kBQ = kWarps * kRows, kBK = 32;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float fa_f32(float x) { return x; }
__device__ __forceinline__ float fa_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T fa_out(float x);
template <>
__device__ __forceinline__ float fa_out<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 fa_out<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <int HD>
constexpr int smem_floats() {
  return kBQ * HD + kBK * (HD + 1) + kBK * HD;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kWarps * 32)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int s,
                       int t, int h, int kvh, int causal, float scale) {
  constexpr int E = HD >= 32 ? HD / 32 : 1;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                       // [kBQ][HD], scaled
  float* ks = qs + kBQ * HD;              // [kBK][HD + 1]
  float* vs = ks + kBK * (HD + 1);        // [kBK][HD]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.z, head = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int kv = head / (h / kvh);
  const int64_t q_stride = static_cast<int64_t>(h) * HD;     // per position
  const int64_t kv_stride = static_cast<int64_t>(kvh) * HD;
  const T* qb = q + (static_cast<int64_t>(b) * s) * q_stride + head * HD;
  const T* kb = k + (static_cast<int64_t>(b) * t) * kv_stride + kv * HD;
  const T* vb = v + (static_cast<int64_t>(b) * t) * kv_stride + kv * HD;

  for (int i = tid; i < kBQ * HD; i += kWarps * 32) {
    const int r = i / HD, d = i - r * HD;
    const int qi = q0 + r;
    qs[i] = qi < s ? __fmul_rn(fa_f32(qb[qi * q_stride + d]), scale) : 0.0f;
  }
  float m[kRows], l[kRows], acc[kRows][E];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.0f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[r][e] = 0.0f;
  }
  const int row0 = q0 + warp * kRows;     // this warp's first query row
  const int last_q = min(q0 + kBQ, s) - 1;
  const int t_end = causal ? min(t, last_q + 1) : t;

  for (int k0 = 0; k0 < t_end; k0 += kBK) {
    __syncthreads();                      // previous tile fully read
    for (int i = tid; i < kBK * HD; i += kWarps * 32) {
      const int j = i / HD, d = i - j * HD;
      const int kt = k0 + j;
      float kx = 0.0f, vx = 0.0f;
      if (kt < t) {
        kx = fa_f32(kb[kt * kv_stride + d]);
        vx = fa_f32(vb[kt * kv_stride + d]);
      }
      ks[j * (HD + 1) + d] = kx;
      vs[j * HD + d] = vx;
    }
    __syncthreads();
    // lane j scores key k0 + j for the warp's 8 rows
    float sc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) sc[r] = 0.0f;
    const float* kr = ks + lane * (HD + 1);
    const float* qw = qs + warp * kRows * HD;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      const float kd = kr[d];
#pragma unroll
      for (int r = 0; r < kRows; ++r) sc[r] = fmaf(qw[r * HD + d], kd, sc[r]);
    }
    const int kt = k0 + lane;
    float p[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const bool live = kt < t && (!causal || kt <= row0 + r);
      float mx = live ? sc[r] : kNegInf;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      p[r] = live ? expf(sc[r] - m_new) : 0.0f;
      float ps = p[r];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[r] = l[r] * alpha + ps;
      m[r] = m_new;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[r][e] *= alpha;
    }
    // P @ V: lane owns columns lane + 32 * e
    const int jn = min(kBK, t_end - k0);
    for (int j = 0; j < jn; ++j) {
      float vj[E];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int d = lane + 32 * e;
        vj[e] = d < HD ? vs[j * HD + d] : 0.0f;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float pj = __shfl_sync(0xffffffffu, p[r], j);
#pragma unroll
        for (int e = 0; e < E; ++e) acc[r][e] = fmaf(pj, vj[e], acc[r][e]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qi = row0 + r;
    if (qi >= s) break;
    const float denom = fmaxf(l[r], 1e-30f);
    T* orow = out + (static_cast<int64_t>(b) * s + qi) * q_stride +
              head * HD;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int d = lane + 32 * e;
      if (d < HD) orow[d] = fa_out<T>(acc[r][e] / denom);
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int s, int t, int h, int kvh, int causal, float scale,
           cudaStream_t st) {
  constexpr int bytes = smem_floats<HD>() * static_cast<int>(sizeof(float));
  auto kern = flash_attention_kernel<T, HD>;
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid((s + kBQ - 1) / kBQ, h, b);
  kern<<<grid, kWarps * 32, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), s, t, h, kvh, causal,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v,
                void* out, int b, int s, int t, int h, int kvh, int causal,
                float scale, cudaStream_t st) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, out, b, s, t, h, kvh, causal,
                                  scale, st);
    case 32: return launch<T, 32>(q, k, v, out, b, s, t, h, kvh, causal,
                                  scale, st);
    case 64: return launch<T, 64>(q, k, v, out, b, s, t, h, kvh, causal,
                                  scale, st);
    case 128: return launch<T, 128>(q, k, v, out, b, s, t, h, kvh, causal,
                                    scale, st);
    case 256: return launch<T, 256>(q, k, v, out, b, s, t, h, kvh, causal,
                                    scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace repro_torch

// q, out: (B, S, H, hd); k, v: (B, T, KV, hd); contiguous, one dtype
// (0 float32, 1 bfloat16); H % KV == 0; hd in {16, 32, 64, 128, 256};
// scale: the f32 1 / sqrt(hd). Returns cudaGetLastError() after the
// launch.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int dtype,
                                     int b, int s, int t, int h, int kvh,
                                     int hd, int causal, float scale,
                                     void* stream) {
  using namespace repro_torch;
  if (b <= 0 || s <= 0 || t <= 0 || kvh <= 0 || h % kvh != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<float>(hd, q, k, v, out, b, s, t, h, kvh, causal,
                              scale, st);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, out, b, s, t, h, kvh,
                                      causal, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
