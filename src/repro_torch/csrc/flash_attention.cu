// flash_attention: forward-only GQA attention, causal or bidirectional,
// q (B, S, H, hd), k/v (B, T, KV, hd) -> out (B, S, H, hd) in q's dtype.
//
// Replaces the Pallas kernel _flash_kernel (src/repro/kernels/
// flash_attention.py:32, launched by flash_attention at :100): the
// attention of the training forward when attn_impl == "flash". ZO
// training has no backward pass, so no softmax statistics are kept.
//
// Two bodies, chosen by the launcher from the dtype alone
// (repro_flash_attention_body):
//
// 1. bf16: tensor cores, FA2-style. q . k of bf16 inputs is exact in an
//    f32 accumulator, so S = Q K^T on mma.sync.m16n8k16 is the
//    reference's f32 score up to summation order; the f32 scale
//    multiplies the f32 scores, inside exp2's argument as scale * log2 e
//    (the reference scales q first: for hd 64 the same, 1/8 being exact;
//    for another hd a rounding apart). P is rounded to bf16 for P V, as the plain
//    attention itself does, inside the 2e-2 limit. Bound on this card,
//    bf16 at OPT-1.3B's training shape (B 8, S 128, 32 heads of 64,
//    causal): bytes, 16.8 MB / 3.35 TB/s = 5.0 us (the f32 SIMT body's
//    operations bound was 8.1 us). The design: one block per (batch,
//    head, 16 query rows a warp), 8 warps up to hd 64 (128 rows, two
//    blocks an SM at <= 128 registers a thread, so K and V are read
//    once for 128 rows), 4 above; Q staged once, K and V tiles of 64
//    keys staged in bf16 (rows padded 16 bytes, so ldmatrix reads
//    conflict-free) and double-buffered with cp.async; each warp keeps
//    its 16 x 64 scores and the online softmax in registers (f32, the
//    running max from -1e30, the denominator max(l, 1e-30)), masks only
//    the tiles that reach past T or its diagonal, takes maxima and sums
//    as trees, folds the scale into exp2's argument (one FMA a score,
//    ex2.approx), turns the score accumulators into the bf16 A fragments
//    of P V in place, and reads V with ldmatrix.trans. Causal key tiles
//    wholly above a warp's rows are skipped; the diagonal tile is
//    masked. The output goes through shared memory and out 16 bytes a
//    thread.
//
// 2. f32: the SIMT body of the first port (the reference's true-f32
//    arithmetic; f32 is not exact in bf16). Bound: operations at the f32
//    SIMT rate. One block per (batch, head, 32 query rows), 4 warps of 8
//    rows each. Keys go 32 at a time through shared memory as f32 (K
//    padded one float a row so that lane j reading key j hits its own
//    bank); lane j scores key j for all 8 rows of its warp at once, the
//    warp takes the tile's max and sum with one butterfly each, and for
//    P @ V each lane owns hd / 32 output columns and takes the
//    probabilities by shuffle. q is scaled in f32 before the dot.
//
// Both: masked keys (causal, or past T) get probability 0; query head h
// reads KV head h / (H / KV); S and T are arbitrary (tails masked).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mma_sm80.cuh"

namespace repro_torch {
namespace {

constexpr int kWarps = 4, kRows = 8, kBQ = kWarps * kRows, kBK = 32;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float fa_f32(float x) { return x; }
template <typename T>
__device__ __forceinline__ T fa_out(float x);
template <>
__device__ __forceinline__ float fa_out<float>(float x) { return x; }

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


// ---------------------------------------------------------------------------
// the tensor-core body (bf16)

namespace tc {

using namespace sm80;

constexpr int BKV = 64;

// warps a block, 16 query rows each: 8 up to hd 64 (two blocks an SM at
// <= 128 registers a thread), 4 above (more registers a thread)
template <int HD>
__host__ __device__ constexpr int warps() { return HD <= 64 ? 8 : 4; }
template <int HD>
__host__ __device__ constexpr int block_rows() { return 16 * warps<HD>(); }
template <int HD>
__host__ __device__ constexpr int row_stride() { return HD + 8; }  // 16 B pad
template <int HD>
__host__ __device__ constexpr int smem_bytes() {
  return (block_rows<HD>() + 4 * BKV) * row_stride<HD>() * 2;
}

// rows [r0, r0 + n_rows) of a (rows, HD) slab whose rows lie `stride`
// elements apart, into shared rows of row_stride<HD>(); rows past `rows`
// are zero. VEC: 16-byte cp.async (bases 16-byte aligned), else by element.
template <int HD, bool VEC>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src,
                                           int r0, int n_rows, int rows,
                                           int64_t stride) {
  constexpr int CH = HD / 8;                     // 16-byte chunks a row
  for (int c = threadIdx.x; c < n_rows * CH; c += warps<HD>() * 32) {
    const int r = c / CH, col = (c % CH) * 8;
    const int gr = r0 + r;
    bf16* d = dst + r * row_stride<HD>() + col;
    const bf16* s = src + static_cast<int64_t>(gr) * stride + col;
    if constexpr (VEC) {
      cp_async16(d, gr < rows ? s : src, gr < rows ? 16 : 0);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        d[i] = gr < rows ? s[i] : __float2bfloat16_rn(0.0f);
    }
  }
}

template <int HD, bool VEC>
__global__ void __launch_bounds__(warps<HD>() * 32, HD <= 64 ? 2 : 1)
flash_attention_tc_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v, bf16* __restrict__ out,
                          int s, int t, int h, int kvh, int causal,
                          float scale) {
  constexpr int RS = row_stride<HD>(), BQ = block_rows<HD>();
  constexpr int NT = BKV / 8;            // score n-tiles (keys) a warp row
  constexpr int DT = HD / 8;             // output n-tiles (hd)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);          // [BQ][RS]
  bf16* ks = qs + BQ * RS;                               // [2][BKV][RS]
  bf16* vs = ks + 2 * BKV * RS;                          // [2][BKV][RS]
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int b = blockIdx.z, head = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int kv = head / (h / kvh);
  const int64_t q_stride = static_cast<int64_t>(h) * HD;     // per position
  const int64_t kv_stride = static_cast<int64_t>(kvh) * HD;
  const bf16* qb = q + static_cast<int64_t>(b) * s * q_stride + head * HD;
  const bf16* kb = k + static_cast<int64_t>(b) * t * kv_stride + kv * HD;
  const bf16* vb = v + static_cast<int64_t>(b) * t * kv_stride + kv * HD;
  const int last_q = min(q0 + BQ, s) - 1;
  const int t_end = causal ? min(t, last_q + 1) : t;
  const int n_kt = (t_end + BKV - 1) / BKV;

  stage_rows<HD, VEC>(qs, qb, q0, BQ, s, q_stride);
  stage_rows<HD, VEC>(ks, kb, 0, BKV, t, kv_stride);
  stage_rows<HD, VEC>(vs, vb, 0, BKV, t, kv_stride);
  cp_async_commit();

  const float sl2 = scale * kLog2e;      // scores in the exp2 domain
  const float neg = -1e30f;
  const int g = lane / 4, q2 = (lane % 4) * 2;
  const int row_a = q0 + warp * 16 + g, row_b = row_a + 8;
  float m_a = neg, m_b = neg, l_a = 0.0f, l_b = 0.0f;
  float o[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.0f;

  for (int kt = 0; kt < n_kt; ++kt) {
    if (kt + 1 < n_kt) {
      const int nb = (kt + 1) % 2;
      stage_rows<HD, VEC>(ks + nb * BKV * RS, kb, (kt + 1) * BKV, BKV, t,
                          kv_stride);
      stage_rows<HD, VEC>(vs + nb * BKV * RS, vb, (kt + 1) * BKV, BKV, t,
                          kv_stride);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* kt_s = ks + (kt % 2) * BKV * RS;
    const bf16* vt_s = vs + (kt % 2) * BKV * RS;
    const int k0 = kt * BKV;

    // a causal key tile wholly above this warp's rows is skipped (the
    // block's loads and barriers still run)
    if (!causal || k0 <= q0 + warp * 16 + 15) {
      // S = Q K^T: 16 rows x 64 keys a warp
      float sc[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < HD; kk += 16) {
        uint32_t a[4];
        ldsm_x4(a, qs + (warp * 16 + lane % 16) * RS + kk + (lane / 16) * 8);
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          uint32_t r[4];
          ldsm_x4(r, kt_s + (j * 8 + lane % 8 + (lane / 16) * 8) * RS + kk +
                         ((lane / 8) % 2) * 8);
          mma_bf16(sc[j], a, r[0], r[1]);
          mma_bf16(sc[j + 1], a, r[2], r[3]);
        }
      }
      // mask only a tile that reaches past t or this warp's diagonal; the
      // online softmax runs on the raw scores with the scale folded into
      // exp2's argument (scale > 0 keeps the maxima); rows row_a: e 0-1,
      // row_b: e 2-3; maxima and sums as trees
      if (k0 + BKV > t || (causal && k0 + BKV - 1 > q0 + warp * 16)) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + j * 8 + q2 + (e & 1);
            const int row = e < 2 ? row_a : row_b;
            if (!(key < t && (!causal || key <= row))) sc[j][e] = neg;
          }
      }
      float ta[NT], tb[NT];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        ta[j] = fmaxf(sc[j][0], sc[j][1]);
        tb[j] = fmaxf(sc[j][2], sc[j][3]);
      }
#pragma unroll
      for (int st = 1; st < NT; st *= 2)
#pragma unroll
        for (int j = 0; j < NT; j += 2 * st) {
          ta[j] = fmaxf(ta[j], ta[j + st]);
          tb[j] = fmaxf(tb[j], tb[j + st]);
        }
      float mx_a = ta[0], mx_b = tb[0];
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
      }
      // a masked key's argument is ~ -1e30 * sl2: exp2 gives exactly 0
      const float mn_a = fmaxf(m_a, mx_a * sl2), mn_b = fmaxf(m_b, mx_b * sl2);
      const float al_a = exp2_approx(m_a - mn_a);
      const float al_b = exp2_approx(m_b - mn_b);
      m_a = mn_a;
      m_b = mn_b;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        sc[j][0] = exp2_approx(fmaf(sc[j][0], sl2, -mn_a));
        sc[j][1] = exp2_approx(fmaf(sc[j][1], sl2, -mn_a));
        sc[j][2] = exp2_approx(fmaf(sc[j][2], sl2, -mn_b));
        sc[j][3] = exp2_approx(fmaf(sc[j][3], sl2, -mn_b));
        ta[j] = sc[j][0] + sc[j][1];
        tb[j] = sc[j][2] + sc[j][3];
      }
#pragma unroll
      for (int st = 1; st < NT; st *= 2)
#pragma unroll
        for (int j = 0; j < NT; j += 2 * st) {
          ta[j] += ta[j + st];
          tb[j] += tb[j + st];
        }
      const float ps_a = ta[0], ps_b = tb[0];
      l_a = l_a * al_a + ps_a;
      l_b = l_b * al_b + ps_b;
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        o[d][0] *= al_a;
        o[d][1] *= al_a;
        o[d][2] *= al_b;
        o[d][3] *= al_b;
      }
      // O += P V: the score accumulators of key tiles 2c, 2c + 1 are the
      // A fragment of keys 16c .. 16c + 15
#pragma unroll
      for (int c = 0; c < BKV / 16; ++c) {
        uint32_t a[4];
        a[0] = pack_bf16(sc[2 * c][0], sc[2 * c][1]);
        a[1] = pack_bf16(sc[2 * c][2], sc[2 * c][3]);
        a[2] = pack_bf16(sc[2 * c + 1][0], sc[2 * c + 1][1]);
        a[3] = pack_bf16(sc[2 * c + 1][2], sc[2 * c + 1][3]);
#pragma unroll
        for (int d = 0; d < DT; d += 2) {
          uint32_t r[4];
          ldsm_x4_t(r, vt_s + (c * 16 + lane % 16) * RS + d * 8 +
                           (lane / 16) * 8);
          mma_bf16(o[d], a, r[0], r[1]);
          mma_bf16(o[d + 1], a, r[2], r[3]);
        }
      }
    }
    __syncthreads();                     // this buffer is free to refill
  }
  cp_async_wait<0>();

  // the row sums live spread over the quad: reduce, then divide
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float inv_a = 1.0f / fmaxf(l_a, 1e-30f);
  const float inv_b = 1.0f / fmaxf(l_b, 1e-30f);
  // the block's output rows go through shared memory (Q's rows, free
  // since the last barrier of the loop) and out 16 bytes a thread
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    const int col = d * 8 + q2;
    *reinterpret_cast<__nv_bfloat162*>(qs + (warp * 16 + g) * RS + col) =
        __floats2bfloat162_rn(o[d][0] * inv_a, o[d][1] * inv_a);
    *reinterpret_cast<__nv_bfloat162*>(qs + (warp * 16 + g + 8) * RS + col) =
        __floats2bfloat162_rn(o[d][2] * inv_b, o[d][3] * inv_b);
  }
  __syncthreads();
  constexpr int CH = HD / 8;
  for (int c = threadIdx.x; c < BQ * CH; c += warps<HD>() * 32) {
    const int r = c / CH, col = (c % CH) * 8;
    if (q0 + r >= s) continue;
    bf16* dst = out + (static_cast<int64_t>(b) * s + q0 + r) * q_stride +
                head * HD + col;
    const bf16* src = qs + r * RS + col;
    if constexpr (VEC) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) dst[i] = src[i];
    }
  }
}

template <int HD, bool VEC>
int launch_vec(const void* q, const void* k, const void* v, void* out, int b,
               int s, int t, int h, int kvh, int causal, float scale,
               cudaStream_t st) {
  constexpr int bytes = smem_bytes<HD>();
  auto kern = flash_attention_tc_kernel<HD, VEC>;
  if (bytes > 48 * 1024) {
    static const cudaError_t attr = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (attr != cudaSuccess) return static_cast<int>(attr);
  }
  dim3 grid((s + block_rows<HD>() - 1) / block_rows<HD>(), h, b);
  kern<<<grid, warps<HD>() * 32, bytes, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), s, t, h, kvh,
      causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int s, int t, int h, int kvh, int causal, float scale,
           cudaStream_t st) {
  const bool vec = (reinterpret_cast<uintptr_t>(q) |
                    reinterpret_cast<uintptr_t>(k) |
                    reinterpret_cast<uintptr_t>(v)) % 16 == 0;
  return vec ? launch_vec<HD, true>(q, k, v, out, b, s, t, h, kvh, causal,
                                    scale, st)
             : launch_vec<HD, false>(q, k, v, out, b, s, t, h, kvh, causal,
                                     scale, st);
}

int dispatch_hd(int hd, const void* q, const void* k, const void* v,
                void* out, int b, int s, int t, int h, int kvh, int causal,
                float scale, cudaStream_t st) {
  switch (hd) {
    case 16: return launch<16>(q, k, v, out, b, s, t, h, kvh, causal,
                               scale, st);
    case 32: return launch<32>(q, k, v, out, b, s, t, h, kvh, causal,
                               scale, st);
    case 64: return launch<64>(q, k, v, out, b, s, t, h, kvh, causal,
                               scale, st);
    case 128: return launch<128>(q, k, v, out, b, s, t, h, kvh, causal,
                                 scale, st);
    case 256: return launch<256>(q, k, v, out, b, s, t, h, kvh, causal,
                                 scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace tc

}  // namespace
}  // namespace repro_torch

// 1 when a launch of this dtype (0 float32, 1 bfloat16) runs the
// tensor-core body, 0 for the SIMT body.
extern "C" int repro_flash_attention_body(int dtype) {
  return dtype == 1 ? 1 : 0;
}

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
    return tc::dispatch_hd(hd, q, k, v, out, b, s, t, h, kvh, causal, scale,
                           st);
  return static_cast<int>(cudaErrorInvalidValue);
}
