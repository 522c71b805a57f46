// The paged tensor-core attention body (bf16): the rows of a (slot, KV
// head) over a paged KV pool, each row with its own causal limit.
//
// flash_prefill.cu (a C-token prompt chunk) and flash_verify.cu (a W-token
// speculative verify window) run it: the two read the pool alike;
// flash_decode.cu's split route runs its chunked mode (attend_block's
// kChunks) for bf16 decode at G 8-16. q/out are
// (B, C, H, hd); row r of the C * G rows of a (slot b, KV head kv) is offset
// r / G at position pos[b] + r / G, head kv * G + r % G, and reads positions
// 0 .. min(pos[b] + r / G, n_live * ps - 1) (earlier positions plus causal
// inside the chunk or window; the cap keeps a stale slot's rows inside its
// table). Each .cu wraps attend_block in a kernel of its own name, so a
// profile tells the two apart.
//
// One block per (slot, KV head, 16 of the C * G rows), 4 warps, grid
// (B, KV, ceil(C * G / 16)), so any C or W is taken. The block reads pos
// and its slot's page-table row together (the row into shared memory),
// stages its 16 Q rows once and gathers K/V tiles of 64 positions through
// the table (position t: page table[t / ps], offset t % ps; any page size,
// a tile may cross pages) into padded shared rows with 16-byte cp.async,
// double-buffered. Each warp takes 16 keys of every tile: S = Q K^T and
// P V on mma.sync.m16n8k16 with f32 accumulators (q . k of bf16 inputs is
// exact in f32), V read with ldmatrix.trans, P rounded to bf16 for P V as
// the plain attention rounds it, the online softmax in registers with the
// scale folded into exp2's argument. Tiles past the block's last row are
// never loaded, slices past it skipped, and only slices that reach past
// the block's first row's limit are masked; padding rows (past C * G) read
// nothing. Positions past the last row's (the unused tail of the last
// live page, pages past it, the trash page) are zero-filled by cp.async
// (source size 0), never read, so NaN there cannot reach the output. The
// four warps' partials (m, l, O) merge through shared memory in a fixed
// order: no atomics, two calls give the same bits.
//
// Head dim 112 (kimi-k2-1t-a32b) runs this body as it stands: Q K^T is 7
// k-steps of 16, each its own ldmatrix.x4 of Q and of K, none paired; P V
// is 14 n-tiles of 8 taken two at a time, 14 being even; rows of 120
// elements (240 bytes) keep every ldmatrix 16-byte aligned and its 8 rows
// on distinct banks; O is 56 f32 registers a thread (hd 128: 64).
#pragma once

#include "paged_attn.cuh"

namespace repro_torch {
namespace {
namespace tc {

using namespace sm80;

constexpr int kRows = 16;                // query rows a block (one m16 tile)
constexpr int kSplit = 4;                // warps a block, one key slice each
constexpr int kThreads = kSplit * 32;
constexpr int kBKV = 64;                 // positions a tile
constexpr int kSlice = kBKV / kSplit;    // keys a warp a tile (k16 of P V)
constexpr float kLn2 = 0.6931471805599453f;

template <int HD>
__host__ __device__ constexpr int row_stride() { return HD + 8; }  // 16 B pad
template <int HD>
__host__ __device__ constexpr int smem_bytes() {   // + the page table
  return (kRows + 2 * 2 * kBKV) * row_stride<HD>() * 2;
}

// the body of a block: rows blockIdx.z * 16 .. + 15 of the C * G rows of
// (slot blockIdx.x, KV head blockIdx.y); each .cu wraps it in a kernel of
// its own name (flash_prefill_tc_kernel, flash_verify_tc_kernel).
//
// kChunks (flash_decode's split route, C = 1, G <= 16): the block is
// chunk blockIdx.z of the slot's positions instead, t0 = blockIdx.z *
// chunk .. min(pos, t0 + chunk - 1), every row reading exactly those
// keys; it stages only the chunk's slice of the table row (read beside
// pos) and writes the G rows' unnormalized partials to ws (B, KV,
// n_chunks, G, HD + 2): O, then m (natural-log units), then l; a chunk
// past pos writes the empty partial (O 0, m -1e30, l 0).
template <int HD, bool kChunks = false>
__device__ __forceinline__ void attend_block(const bf16* __restrict__ q,
                                             const bf16* __restrict__ k_pool,
                                             const bf16* __restrict__ v_pool,
                                             const int32_t* __restrict__ pages,
                                             const int32_t* __restrict__ pos,
                                             bf16* __restrict__ out, int c,
                                             int n_heads, int kvh, int ps,
                                             int n_live, float scale,
                                             float* __restrict__ ws = nullptr,
                                             int chunk = 0,
                                             int n_chunks = 0) {
  constexpr int RS = row_stride<HD>();
  constexpr int CH = HD / 8;             // 16-byte chunks a row
  constexpr int DT = HD / 8;             // output n-tiles (hd)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);          // [kRows][RS]
  bf16* ring = qs + kRows * RS;          // [2][K, V][kBKV][RS]
  int* tbl = reinterpret_cast<int*>(smem_raw + smem_bytes<HD>());
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int b = blockIdx.x, kv = blockIdx.y;
  const int r0 = kChunks ? 0 : blockIdx.z * kRows;
  const int g_per = n_heads / kvh, rows = c * g_per;
  const int t0 = kChunks ? blockIdx.z * chunk : 0;  // the block's first key
  const int pg0 = t0 / ps;                          // its first page
  const int n_tbl =
      kChunks ? min(n_live - 1, (t0 + chunk - 1) / ps) - pg0 + 1 : n_live;
  const int32_t* table = pages + static_cast<int64_t>(b) * n_live + pg0;
  // the slot's page table (kChunks: the chunk's slice), read once beside
  // pos (entries past the live pages are read but never used)
  for (int i = threadIdx.x; i < n_tbl; i += kThreads) tbl[i] = table[i];
  const int p0 = pos[b], cap = n_live * ps - 1;
  int t_end = 0;                                    // kChunks: last key
  if constexpr (kChunks) {
    if (t0 > min(p0, cap)) {    // past the slot's position: empty partial
      constexpr int kPart = HD + 2;
      float* dst = ws + ((static_cast<int64_t>(b) * kvh + kv) * n_chunks +
                         blockIdx.z) * g_per * kPart;
      for (int i = threadIdx.x; i < g_per * kPart; i += kThreads)
        dst[i] = i % kPart == HD ? -1e30f : 0.0f;
      return;
    }
    t_end = min(min(p0, cap), t0 + chunk - 1);
  }
  // row r (of the C * G) reads positions <= lim(r); padding rows none
  auto lim = [&](int r) {
    if constexpr (kChunks) return r < rows ? t_end : -1;
    return r < rows ? min(p0 + r / g_per, cap) : -1;
  };
  const int first_lim = lim(r0);
  const int last = lim(min(r0 + kRows, rows) - 1);   // the block's furthest
  const int n_kt = (last - t0) / kBKV + 1;
  const int64_t tok = static_cast<int64_t>(kvh) * HD;  // position stride
  const bf16* kb = k_pool + kv * HD;
  const bf16* vb = v_pool + kv * HD;

  // the block's 16 query rows: row r is (offset r / G, head kv * G + r % G)
  for (int i = threadIdx.x; i < kRows * CH; i += kThreads) {
    const int r = i / CH, col = (i % CH) * 8, gr = r0 + r;
    const bool live = gr < rows;
    const int64_t src =
        live ? ((static_cast<int64_t>(b) * c + gr / g_per) * n_heads +
                kv * g_per + gr % g_per) * HD + col
             : 0;
    cp_async16(qs + r * RS + col, q + src, live ? 16 : 0);
  }
  __syncthreads();
  auto stage = [&](int kt) {
    bf16* kd = ring + (kt % 2) * 2 * kBKV * RS;
    gather_kv_tile<bf16, HD, kBKV, RS, kThreads>(
        kd, kd + kBKV * RS, kb, vb, tbl, t0 + kt * kBKV, last, ps, tok,
        pg0);
  };
  stage(0);
  cp_async_commit();

  const float sl2 = scale * kLog2e;      // scores in the exp2 domain
  const float neg = -1e30f;
  const int g = lane / 4, q2 = (lane % 4) * 2;
  const int lim_a = lim(r0 + g), lim_b = lim(r0 + g + 8);
  float m_a = neg, m_b = neg, l_a = 0.0f, l_b = 0.0f;
  float o[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.0f;

  for (int kt = 0; kt < n_kt; ++kt) {
    if (kt + 1 < n_kt) stage(kt + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* kt_s = ring + (kt % 2) * 2 * kBKV * RS + warp * kSlice * RS;
    const bf16* vt_s = kt_s + kBKV * RS;
    const int s0 = t0 + kt * kBKV + warp * kSlice;  // this warp's first key

    if (s0 <= last) {
      // S = Q K^T: 16 rows x 16 keys
      float sc[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < HD; kk += 16) {
        uint32_t a[4], r[4];
        ldsm_x4(a, qs + (lane % 16) * RS + kk + (lane / 16) * 8);
        ldsm_x4(r, kt_s + (lane % 8 + (lane / 16) * 8) * RS + kk +
                       ((lane / 8) % 2) * 8);
        mma_bf16(sc[0], a, r[0], r[1]);
        mma_bf16(sc[1], a, r[2], r[3]);
      }
      // scaled scores; a key past its row's limit is out (only a slice
      // that reaches past the block's first limit needs the test)
      float x[2][4];
      bool in[2][4];
      const bool edge = s0 + kSlice - 1 > first_lim;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = s0 + j * 8 + q2 + (e & 1);
          in[j][e] = !edge || key <= (e < 2 ? lim_a : lim_b);
          x[j][e] = in[j][e] ? sc[j][e] * sl2 : neg;
        }
      float mx_a = fmaxf(fmaxf(x[0][0], x[0][1]), fmaxf(x[1][0], x[1][1]));
      float mx_b = fmaxf(fmaxf(x[0][2], x[0][3]), fmaxf(x[1][2], x[1][3]));
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
      }
      const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
      const float al_a = exp2_approx(m_a - mn_a);
      const float al_b = exp2_approx(m_b - mn_b);
      m_a = mn_a;
      m_b = mn_b;
      // an out key's probability is 0 even while the row's max is still
      // the -1e30 start (a row with no key yet in this warp's slices)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          x[j][e] = in[j][e] ? exp2_approx(x[j][e] - (e < 2 ? mn_a : mn_b))
                             : 0.0f;
      l_a = l_a * al_a + ((x[0][0] + x[0][1]) + (x[1][0] + x[1][1]));
      l_b = l_b * al_b + ((x[0][2] + x[0][3]) + (x[1][2] + x[1][3]));
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        o[d][0] *= al_a;
        o[d][1] *= al_a;
        o[d][2] *= al_b;
        o[d][3] *= al_b;
      }
      // O += P V: the two score tiles are the A fragment of 16 keys
      uint32_t a[4];
      a[0] = pack_bf16(x[0][0], x[0][1]);
      a[1] = pack_bf16(x[0][2], x[0][3]);
      a[2] = pack_bf16(x[1][0], x[1][1]);
      a[3] = pack_bf16(x[1][2], x[1][3]);
#pragma unroll
      for (int d = 0; d < DT; d += 2) {
        uint32_t r[4];
        ldsm_x4_t(r, vt_s + (lane % 16) * RS + d * 8 + (lane / 16) * 8);
        mma_bf16(o[d], a, r[0], r[1]);
        mma_bf16(o[d + 1], a, r[2], r[3]);
      }
    }
    __syncthreads();                     // this buffer is free to refill
  }
  cp_async_wait<0>();

  // merge the four key slices through shared memory (the ring is free):
  // O [kSplit][kRows][HD] f32, then m and l [kSplit][kRows]
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  float* os = reinterpret_cast<float*>(ring);
  float* ms = os + kSplit * kRows * HD;
  float* ls = ms + kSplit * kRows;
  float* ow = os + warp * kRows * HD;
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    const int col = d * 8 + q2;
    *reinterpret_cast<float2*>(ow + g * HD + col) =
        make_float2(o[d][0], o[d][1]);
    *reinterpret_cast<float2*>(ow + (g + 8) * HD + col) =
        make_float2(o[d][2], o[d][3]);
  }
  if (lane % 4 == 0) {
    ms[warp * kRows + g] = m_a;
    ms[warp * kRows + g + 8] = m_b;
    ls[warp * kRows + g] = l_a;
    ls[warp * kRows + g + 8] = l_b;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kRows * CH; i += kThreads) {
    const int r = i / CH, col = (i % CH) * 8, gr = r0 + r;
    if (gr >= rows) continue;
    float mm = neg;
#pragma unroll
    for (int w = 0; w < kSplit; ++w) mm = fmaxf(mm, ms[w * kRows + r]);
    float den = 0.0f, y[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) y[e] = 0.0f;
#pragma unroll
    for (int w = 0; w < kSplit; ++w) {
      const float wt = exp2_approx(ms[w * kRows + r] - mm);
      den = fmaf(wt, ls[w * kRows + r], den);
      const float* src = os + (w * kRows + r) * HD + col;
#pragma unroll
      for (int e = 0; e < 8; ++e) y[e] = fmaf(wt, src[e], y[e]);
    }
    if constexpr (kChunks) {            // the row's partial, unnormalized
      float* dst = ws + (((static_cast<int64_t>(b) * kvh + kv) * n_chunks +
                          blockIdx.z) * g_per + gr) * (HD + 2);
#pragma unroll
      for (int e = 0; e < 8; ++e) dst[col + e] = y[e];
      if (col == 0) {
        dst[HD] = mm * kLn2;              // the exp2 domain's max, in nats
        dst[HD + 1] = den;
      }
      continue;
    }
    const float inv = 1.0f / fmaxf(den, 1e-30f);
    uint4 packed;
    packed.x = pack_bf16(y[0] * inv, y[1] * inv);
    packed.y = pack_bf16(y[2] * inv, y[3] * inv);
    packed.z = pack_bf16(y[4] * inv, y[5] * inv);
    packed.w = pack_bf16(y[6] * inv, y[7] * inv);
    *reinterpret_cast<uint4*>(
        out + ((static_cast<int64_t>(b) * c + gr / g_per) * n_heads +
               kv * g_per + gr % g_per) * HD + col) = packed;
  }
}

using Kernel = void (*)(const bf16*, const bf16*, const bf16*,
                        const int32_t*, const int32_t*, bf16*, int, int, int,
                        int, int, float);

// launch `kern` (an attend_block<HD> kernel) over q (B, C, H, hd)
template <int HD>
int launch(Kernel kern, const void* q, const void* k, const void* v,
           const int32_t* pg, const int32_t* pos, void* out, int b, int c,
           int h, int kvh, int ps, int n_live, float scale,
           cudaStream_t st) {
  const size_t bytes = smem_bytes<HD>() + sizeof(int) * n_live;
  static_assert(kSplit * kRows * (HD + 2) * 4 <= 2 * 2 * kBKV * (HD + 8) * 2,
                "the merge scratch fits in the ring");
  // one kernel per HD in a translation unit: set its limit once
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_optin());
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int rows = c * (h / kvh);
  dim3 grid(b, kvh, (rows + kRows - 1) / kRows);
  kern<<<grid, kThreads, bytes, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), pg, pos, static_cast<bf16*>(out), c, h,
      kvh, ps, n_live, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc
}  // namespace
}  // namespace repro_torch
