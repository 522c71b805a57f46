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
// 2. f32: the SIMT body, in true f32 FFMA (f32 is not exact in bf16, so
//    tensor cores are out). Bound at RoBERTa-large's shape (B 8, S 128,
//    16 heads of 64, bidirectional): operations, 0.54 GFLOP / 67 TFLOP/s
//    = 8.0 us (bytes 5.0 us). Each FMA the SMs' schedulers issue competes
//    with every shared load, shuffle and exp for the same issue slots, so
//    both products are register-tiled outer products: one block a
//    (64 query rows, head, batch) -- RoBERTa's 8 x 16 heads x 128 rows
//    are 256 blocks, two an SM -- 4 warps of 16 rows, each thread 4 rows.
//    Q K^T: the thread scores its 4 rows against BKV / 8 keys (BKV = 64 up
//    to hd 64, 32 above), from 16-byte loads of Q (broadcast in a quarter
//    warp) and K (rows padded to an odd count of 16-byte chunks, so 8
//    keys' loads are conflict-free), 16 FMAs a K load. The online softmax
//    runs over the quarter warp that shares the rows (3 shuffles a max or
//    sum); P is stored transposed to shared memory by the warp that owns
//    its rows (a __syncwarp, no block barrier), and P V is again a 4-row
//    outer product, 16 FMAs a V load. K and V tiles are staged by
//    16-byte cp.async, double-buffered (hd 64: 2 x 34 KB, 104 KB a
//    block); edge tiles (past T) and causal diagonal tiles alone are
//    masked, and causal tiles wholly above a warp's rows are skipped. The
//    reference's arithmetic: q scaled in f32 before the dot, the running
//    max from -1e30, a masked key's probability 0 (never exp(-1e30 - m)),
//    expf, the denominator max(l, 1e-30).
//
// Both: masked keys (causal, or past T) get probability 0; query head h
// reads KV head h / (H / KV); S and T are arbitrary (tails masked).
//
// Head dim 112 (kimi-k2-1t-a32b), not a power of two: the bf16 body takes
// it as it is -- 7 k-steps of 16 for Q K^T, each one ldmatrix.x4 of Q and
// of K (no step is paired with another), and 14 output n-tiles of 8 for
// P V, taken in pairs, 14 being even; rows of 120 elements (240 bytes)
// keep ldmatrix 16-byte aligned and its 8 rows on distinct banks; 56 f32
// accumulators a thread, fewer than hd 128's 64, in the 4-warp block.
// The SIMT body gives each thread 16-byte output chunks tx + 8 e of 28,
// the fourth idle for tx >= 4.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mma_sm80.cuh"

namespace repro_torch {
namespace {

// ---------------------------------------------------------------------------
// the SIMT body (f32)

namespace simt {

using namespace sm80;

// query rows a thread, warps a block, query rows a block (each warp's 4
// groups of 8 lanes take RT rows each)
constexpr int RT = 4, kWarps = 4, kThreads = 32 * kWarps, BQ = 4 * RT * kWarps;
static_assert(RT == 4, "P^T moves one 16-byte row quad a key");
constexpr int PLD = BQ + 4;             // a row of P^T (floats)
constexpr float kNegInf = -1e30f;

// keys a K / V tile
template <int HD>
__host__ __device__ constexpr int bkv() { return HD <= 64 ? 64 : 32; }
// a staged row of Q, K or V (floats): HD + 4, an odd number of 16-byte
// chunks, so 8 rows read at one column fall on 8 distinct bank quads
template <int HD>
__host__ __device__ constexpr int ld() { return HD + 4; }
template <int HD>
__host__ __device__ constexpr int smem_bytes() {
  return (BQ * ld<HD>() + 4 * bkv<HD>() * ld<HD>() + bkv<HD>() * PLD) * 4;
}

// One block a (64 query rows, head, batch); warp w owns rows 16 w .. +15,
// lane (tx = lane % 8, ty = lane / 8) rows 16 w + 4 ty .. + 3. For a K / V
// tile of BKV keys the thread scores its 4 rows against keys tx + 8 e (a
// 4 x BKV / 8 register tile: each 16-byte Q load, broadcast to the quarter
// warp, and K load, 8 distinct rows, feeds 16 FMAs), takes the online
// softmax with its quarter warp (3 shuffles a max or sum), writes P
// transposed to shared memory (its warp's rows only, so a __syncwarp
// hands it over), and adds P V to its 4 rows x output chunks tx + 8 e (a
// 16-byte P^T load broadcast, one V load of 8 distinct chunks, 16 FMAs).
// K and V are staged by 16-byte cp.async, double-buffered; vec: every
// base 16-byte aligned, else element loads.
template <int HD>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_simt_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            float* __restrict__ out, int s, int t, int h,
                            int kvh, int causal, float scale, int vec) {
  constexpr int BKV = bkv<HD>(), LD = ld<HD>();
  constexpr int DQ = HD / 4;            // 16-byte chunks a row
  constexpr int NK = BKV / 8;           // keys a thread scores
  constexpr int NC = (DQ + 7) / 8;      // output chunks a thread (past DQ idle)
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                     // [BQ][LD], scaled
  float* ks = qs + BQ * LD;             // [2][BKV][LD]
  float* vs = ks + 2 * BKV * LD;        // [2][BKV][LD]
  float* pt = vs + 2 * BKV * LD;        // [BKV][PLD]
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int tx = lane % 8, ty = lane / 8;
  const int b = blockIdx.z, head = blockIdx.y, q0 = blockIdx.x * BQ;
  const int kv = head / (h / kvh);
  const int64_t q_stride = static_cast<int64_t>(h) * HD;     // per position
  const int64_t kv_stride = static_cast<int64_t>(kvh) * HD;
  const float* qb = q + static_cast<int64_t>(b) * s * q_stride + head * HD;
  const float* kb = k + static_cast<int64_t>(b) * t * kv_stride + kv * HD;
  const float* vb = v + static_cast<int64_t>(b) * t * kv_stride + kv * HD;
  const int last_q = min(q0 + BQ, s) - 1;
  const int t_end = causal ? min(t, last_q + 1) : t;
  const int n_kt = (t_end + BKV - 1) / BKV;
  const int wrow = q0 + 4 * RT * warp;  // this warp's first query row
  const int r0 = 4 * RT * warp + RT * ty;  // this thread's first row, in block

  // keys [k0, k0 + BKV) of K and V into stage buf (rows past t zero)
  auto stage_kv = [&](int buf, int k0) {
    float* kd = ks + buf * BKV * LD;
    float* vd = vs + buf * BKV * LD;
    for (int c = tid; c < BKV * DQ; c += kThreads) {
      const int j = c / DQ, col = (c % DQ) * 4, key = k0 + j;
      const int64_t off = static_cast<int64_t>(key) * kv_stride + col;
      if (vec) {
        cp_async16(kd + j * LD + col, key < t ? kb + off : kb,
                   key < t ? 16 : 0);
        cp_async16(vd + j * LD + col, key < t ? vb + off : vb,
                   key < t ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          kd[j * LD + col + e] = key < t ? kb[off + e] : 0.0f;
          vd[j * LD + col + e] = key < t ? vb[off + e] : 0.0f;
        }
      }
    }
  };

  // Q, scaled in f32 as the reference does before the dot
  for (int c = tid; c < BQ * DQ; c += kThreads) {
    const int r = c / DQ, col = (c % DQ) * 4, qi = q0 + r;
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (qi < s) {
      const float* p = qb + qi * q_stride + col;
      x = vec ? __ldg(reinterpret_cast<const float4*>(p))
              : make_float4(p[0], p[1], p[2], p[3]);
    }
    *reinterpret_cast<float4*>(qs + r * LD + col) =
        make_float4(__fmul_rn(x.x, scale), __fmul_rn(x.y, scale),
                    __fmul_rn(x.z, scale), __fmul_rn(x.w, scale));
  }
  stage_kv(0, 0);
  cp_async_commit();

  float m_r[RT], l_r[RT], o[RT][4 * NC];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    m_r[i] = kNegInf;
    l_r[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) o[i][c] = 0.0f;
  }

  for (int it = 0; it < n_kt; ++it) {
    const int buf = it % 2, k0 = it * BKV;
    cp_async_wait<0>();                 // tile it has landed
    // tile it (and Q) visible to all, and every warp is done with tile
    // it - 1, whose buffer the next copies refill
    __syncthreads();
    if (it + 1 < n_kt) stage_kv(buf ^ 1, k0 + BKV);
    cp_async_commit();
    // a causal tile wholly above this warp's rows adds nothing: skipped
    if (!causal || k0 <= wrow + 4 * RT - 1) {
      const float* kt_s = ks + buf * BKV * LD;
      const float* vt_s = vs + buf * BKV * LD;
      // S = Q K^T for rows r0 .. r0 + RT - 1, keys k0 + tx + 8 e
      float sc[RT][NK];
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int e = 0; e < NK; ++e) sc[i][e] = 0.0f;
#pragma unroll 4
      for (int dc = 0; dc < DQ; ++dc) {
        float4 qv[RT];
#pragma unroll
        for (int i = 0; i < RT; ++i)
          qv[i] = *reinterpret_cast<const float4*>(qs + (r0 + i) * LD +
                                                   4 * dc);
#pragma unroll
        for (int e = 0; e < NK; ++e) {
          const float4 kk = *reinterpret_cast<const float4*>(
              kt_s + (tx + 8 * e) * LD + 4 * dc);
#pragma unroll
          for (int i = 0; i < RT; ++i) {
            sc[i][e] = fmaf(qv[i].x, kk.x, sc[i][e]);
            sc[i][e] = fmaf(qv[i].y, kk.y, sc[i][e]);
            sc[i][e] = fmaf(qv[i].z, kk.z, sc[i][e]);
            sc[i][e] = fmaf(qv[i].w, kk.w, sc[i][e]);
          }
        }
      }
      // masks only on a tile that reaches past t or this warp's
      // diagonal: a masked key's score is -1e30 for the max, its
      // probability 0
      const bool edge = k0 + BKV > t || (causal && k0 + BKV - 1 > wrow);
      auto live = [&](int i, int e) {
        const int key = k0 + tx + 8 * e;
        return !edge || (key < t && (!causal || key <= q0 + r0 + i));
      };
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        float mx = kNegInf;
#pragma unroll
        for (int e = 0; e < NK; ++e) {
          if (!live(i, e)) sc[i][e] = kNegInf;
          mx = fmaxf(mx, sc[i][e]);
        }
#pragma unroll
        for (int off = 1; off < 8; off <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m_r[i], mx);
        const float alpha = expf(m_r[i] - m_new);
        float ps = 0.0f;
#pragma unroll
        for (int e = 0; e < NK; ++e) {
          sc[i][e] = live(i, e) ? expf(sc[i][e] - m_new) : 0.0f;
          ps += sc[i][e];
        }
#pragma unroll
        for (int off = 1; off < 8; off <<= 1)
          ps += __shfl_xor_sync(0xffffffffu, ps, off);
        l_r[i] = l_r[i] * alpha + ps;
        m_r[i] = m_new;
#pragma unroll
        for (int c = 0; c < 4 * NC; ++c) o[i][c] *= alpha;
      }
      // P^T: key tx + 8 e's probabilities of rows r0 .. r0 + 3
#pragma unroll
      for (int e = 0; e < NK; ++e)
        *reinterpret_cast<float4*>(pt + (tx + 8 * e) * PLD + r0) =
            make_float4(sc[0][e], sc[1][e], sc[2][e], sc[3][e]);
      __syncwarp();
      // O += P V over the tile's keys below t_end
      const int jn = min(BKV, t_end - k0);
#pragma unroll 4
      for (int j = 0; j < jn; ++j) {
        const float4 p4 = *reinterpret_cast<const float4*>(pt + j * PLD + r0);
        const float p[RT] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
        for (int e = 0; e < NC; ++e) {
          const int c = tx + 8 * e;
          if (DQ % 8 == 0 || c < DQ) {
            const float4 vv =
                *reinterpret_cast<const float4*>(vt_s + j * LD + 4 * c);
#pragma unroll
            for (int i = 0; i < RT; ++i) {
              o[i][4 * e] = fmaf(p[i], vv.x, o[i][4 * e]);
              o[i][4 * e + 1] = fmaf(p[i], vv.y, o[i][4 * e + 1]);
              o[i][4 * e + 2] = fmaf(p[i], vv.z, o[i][4 * e + 2]);
              o[i][4 * e + 3] = fmaf(p[i], vv.w, o[i][4 * e + 3]);
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int qi = q0 + r0 + i;
    if (qi >= s) continue;
    const float denom = fmaxf(l_r[i], 1e-30f);
    float* orow = out + (static_cast<int64_t>(b) * s + qi) * q_stride +
                  head * HD;
#pragma unroll
    for (int e = 0; e < NC; ++e) {
      const int c = tx + 8 * e;
      if (DQ % 8 != 0 && c >= DQ) continue;
      const float4 r = make_float4(o[i][4 * e] / denom, o[i][4 * e + 1] / denom,
                                   o[i][4 * e + 2] / denom,
                                   o[i][4 * e + 3] / denom);
      if (vec) {
        *reinterpret_cast<float4*>(orow + 4 * c) = r;
      } else {
        orow[4 * c] = r.x;
        orow[4 * c + 1] = r.y;
        orow[4 * c + 2] = r.z;
        orow[4 * c + 3] = r.w;
      }
    }
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int s, int t, int h, int kvh, int causal, float scale,
           cudaStream_t st) {
  constexpr int bytes = smem_bytes<HD>();
  static_assert(bytes <= 232448, "shared memory a block can use");
  auto kern = flash_attention_simt_kernel<HD>;
  if (bytes > 48 * 1024) {
    static const cudaError_t attr = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (attr != cudaSuccess) return static_cast<int>(attr);
  }
  const int vec = (reinterpret_cast<uintptr_t>(q) |
                   reinterpret_cast<uintptr_t>(k) |
                   reinterpret_cast<uintptr_t>(v) |
                   reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  dim3 grid((s + BQ - 1) / BQ, h, b);
  kern<<<grid, kThreads, bytes, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), s, t, h, kvh,
      causal, scale, vec);
  return static_cast<int>(cudaGetLastError());
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
    case 112: return launch<112>(q, k, v, out, b, s, t, h, kvh, causal,
                                 scale, st);
    case 128: return launch<128>(q, k, v, out, b, s, t, h, kvh, causal,
                                 scale, st);
    case 256: return launch<256>(q, k, v, out, b, s, t, h, kvh, causal,
                                 scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace simt

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
    case 112: return launch<112>(q, k, v, out, b, s, t, h, kvh, causal,
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
// (0 float32, 1 bfloat16); H % KV == 0; hd in {16, 32, 64, 112, 128, 256};
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
    return simt::dispatch_hd(hd, q, k, v, out, b, s, t, h, kvh, causal,
                             scale, st);
  if (dtype == 1)
    return tc::dispatch_hd(hd, q, k, v, out, b, s, t, h, kvh, causal, scale,
                           st);
  return static_cast<int>(cudaErrorInvalidValue);
}
