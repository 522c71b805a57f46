// flash_prefill: C-token chunk attention over a paged KV pool.
//
// Replaces the Pallas kernel _prefill_kernel (src/repro/kernels/
// flash_prefill.py:45, launched by flash_prefill at :131), which runs in
// every layer on every prompt chunk of chunked paged prefill. The
// chunk's own K/V is already scattered into the slot's pages by the
// caller.
//
// Row r of the chunk's C * G rows of a (slot, KV head) is chunk offset
// r / G at position pos + r / G, and reads positions 0 .. pos + r / G
// (earlier chunks plus causal inside this one).
//
// Bound on this card: bytes. Each slot's live K/V is needed once, q read
// and out written once: at the serving admission's shape (B 1, C 32, 32
// heads of 64 on 32 KV heads, bf16, pos 64) ~1.0 MB, ~0.31 us at 3.35
// TB/s, against ~21 MFLOP (~0.02 us on bf16 tensor cores). Like decode,
// a chunk this small is latency-bound (pos and the page table, then K/V,
// then the products).
//
// Two bodies, chosen by dtype alone (repro_flash_prefill_body):
//
// 1. bf16: tensor cores, after flash_attention.cu's bf16 body. One block
//    per (slot, KV head, 16 of the C * G rows), 4 warps, so a B 1 chunk of
//    32 rows on 32 KV heads is 64 blocks. The block reads pos and its
//    slot's page-table row together (the row into shared memory), stages
//    its 16 Q rows once and gathers K/V tiles of 64 positions through the
//    table (position t: page table[t / ps], offset t % ps; any page size,
//    a tile may cross pages) into padded shared rows with 16-byte
//    cp.async, double-buffered. Each warp takes 16 keys of every tile:
//    S = Q K^T and P V on mma.sync.m16n8k16 with f32 accumulators (q . k
//    of bf16 inputs is exact in f32), V read with ldmatrix.trans, P
//    rounded to bf16 for P V as the plain attention rounds it, the online
//    softmax in registers with the scale folded into exp2's argument. Row r
//    reads positions <= pos + r / G: tiles past the block's last row are never
//    loaded, slices past it skipped, and only slices that reach past the
//    block's first row's limit are masked. Positions past the last row's (the
//    unused tail of the last live page, pages past it, the trash page) are
//    zero-filled by cp.async (source size 0), never read, so NaN there cannot
//    reach the output. The four warps' partials (m, l, O) merge through shared
//    memory in a fixed order: no atomics, two calls give the same bits.
//
// 2. f32: the SIMT body of the first port (f32 is not exact on bf16
//    tensor cores at 2e-5): grid (slot, KV head, row group), one warp per
//    row through paged_attn.cuh's attend_row, which reads only the pages
//    its own row can see.
#include "paged_attn.cuh"

namespace repro_torch {
namespace {

constexpr int kWarps = 8;

template <typename T, int HD>
__global__ void flash_prefill_kernel(const T* __restrict__ q,
                                     const T* __restrict__ k_pool,
                                     const T* __restrict__ v_pool,
                                     const int32_t* __restrict__ pages,
                                     const int32_t* __restrict__ pos,
                                     T* __restrict__ out, int c, int n_heads,
                                     int kvh, int ps, int n_live,
                                     float scale) {
  const int b = blockIdx.x, kv = blockIdx.y;
  const int g_per = n_heads / kvh;
  const int r = blockIdx.z * kWarps + (threadIdx.x >> 5);
  if (r >= c * g_per) return;
  const int off = r / g_per, g = r - off * g_per;
  const int qpos = pos[b] + off;
  const int32_t* table = pages + static_cast<int64_t>(b) * n_live;
  // q/out (B, C, H, hd): row (b, off, kv * G + g)
  const int64_t row =
      ((static_cast<int64_t>(b) * c + off) * n_heads + kv * g_per + g) * HD;
  attend_row<T, HD>(q + row, k_pool, v_pool, table, n_live, ps, kvh, kv,
                    qpos, scale, out + row);
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const int32_t* pg,
           const int32_t* pos, void* out, int b, int c, int h, int kvh,
           int ps, int n_live, float scale, cudaStream_t st) {
  int rows = c * (h / kvh);
  dim3 grid(b, kvh, (rows + kWarps - 1) / kWarps);
  flash_prefill_kernel<T, HD><<<grid, 32 * kWarps, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), pg, pos, static_cast<T*>(out), c, h, kvh,
      ps, n_live, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v,
                const int32_t* pg, const int32_t* pos, void* out, int b,
                int c, int h, int kvh, int ps, int n_live, float scale,
                cudaStream_t st) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, pg, pos, out, b, c, h, kvh, ps,
                                  n_live, scale, st);
    case 32: return launch<T, 32>(q, k, v, pg, pos, out, b, c, h, kvh, ps,
                                  n_live, scale, st);
    case 64: return launch<T, 64>(q, k, v, pg, pos, out, b, c, h, kvh, ps,
                                  n_live, scale, st);
    case 128: return launch<T, 128>(q, k, v, pg, pos, out, b, c, h, kvh, ps,
                                    n_live, scale, st);
    case 256: return launch<T, 256>(q, k, v, pg, pos, out, b, c, h, kvh, ps,
                                    n_live, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}


// ---------------------------------------------------------------------------
// the tensor-core body (bf16)

namespace tc {

using namespace sm80;

constexpr int kRows = 16;                // query rows a block (one m16 tile)
constexpr int kSplit = 4;                // warps a block, one key slice each
constexpr int kBKV = 64;                 // positions a tile
constexpr int kSlice = kBKV / kSplit;    // keys a warp a tile (k16 of P V)

template <int HD>
__host__ __device__ constexpr int row_stride() { return HD + 8; }  // 16 B pad
template <int HD>
__host__ __device__ constexpr int smem_bytes() {   // + the page table
  return (kRows + 2 * 2 * kBKV) * row_stride<HD>() * 2;
}

template <int HD>
__global__ void __launch_bounds__(kSplit * 32)
flash_prefill_tc_kernel(const bf16* __restrict__ q,
                        const bf16* __restrict__ k_pool,
                        const bf16* __restrict__ v_pool,
                        const int32_t* __restrict__ pages,
                        const int32_t* __restrict__ pos,
                        bf16* __restrict__ out, int c, int n_heads, int kvh,
                        int ps, int n_live, float scale) {
  constexpr int RS = row_stride<HD>();
  constexpr int CH = HD / 8;             // 16-byte chunks a row
  constexpr int DT = HD / 8;             // output n-tiles (hd)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);          // [kRows][RS]
  bf16* ring = qs + kRows * RS;          // [2][K, V][kBKV][RS]
  int* tbl = reinterpret_cast<int*>(smem_raw + smem_bytes<HD>());
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int b = blockIdx.x, kv = blockIdx.y, r0 = blockIdx.z * kRows;
  const int g_per = n_heads / kvh, rows = c * g_per;
  const int p0 = pos[b], cap = n_live * ps - 1;
  // row r (of the C * G) reads positions <= lim(r); padding rows none
  auto lim = [&](int r) {
    return r < rows ? min(p0 + r / g_per, cap) : -1;
  };
  const int first_lim = lim(r0);
  const int last = lim(min(r0 + kRows, rows) - 1);   // the block's furthest
  const int n_kt = last / kBKV + 1;
  const int32_t* table = pages + static_cast<int64_t>(b) * n_live;
  const int64_t tok = static_cast<int64_t>(kvh) * HD;  // position stride
  const bf16* kb = k_pool + kv * HD;
  const bf16* vb = v_pool + kv * HD;
  // the slot's page table, read once beside pos (entries past the live
  // pages are read but never used)
  for (int i = threadIdx.x; i < n_live; i += kSplit * 32) tbl[i] = table[i];

  // the block's 16 query rows: row r is (offset r / G, head kv * G + r % G)
  for (int i = threadIdx.x; i < kRows * CH; i += kSplit * 32) {
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
    gather_kv_tile<bf16, HD, kBKV, RS, kSplit * 32>(
        kd, kd + kBKV * RS, kb, vb, tbl, kt * kBKV, last, ps, tok);
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
    const int s0 = kt * kBKV + warp * kSlice;      // this warp's first key

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
  for (int i = threadIdx.x; i < kRows * CH; i += kSplit * 32) {
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

template <int HD>
int launch(const void* q, const void* k, const void* v, const int32_t* pg,
           const int32_t* pos, void* out, int b, int c, int h, int kvh,
           int ps, int n_live, float scale, cudaStream_t st) {
  const size_t bytes = smem_bytes<HD>() + sizeof(int) * n_live;
  static_assert(kSplit * kRows * (HD + 2) * 4 <= 2 * 2 * kBKV * (HD + 8) * 2,
                "the merge scratch fits in the ring");
  auto kern = flash_prefill_tc_kernel<HD>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_optin());
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int rows = c * (h / kvh);
  dim3 grid(b, kvh, (rows + kRows - 1) / kRows);
  kern<<<grid, kSplit * 32, bytes, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), pg, pos, static_cast<bf16*>(out), c, h,
      kvh, ps, n_live, scale);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_hd(int hd, const void* q, const void* k, const void* v,
                const int32_t* pg, const int32_t* pos, void* out, int b,
                int c, int h, int kvh, int ps, int n_live, float scale,
                cudaStream_t st) {
  switch (hd) {
    case 16: return launch<16>(q, k, v, pg, pos, out, b, c, h, kvh, ps,
                               n_live, scale, st);
    case 32: return launch<32>(q, k, v, pg, pos, out, b, c, h, kvh, ps,
                               n_live, scale, st);
    case 64: return launch<64>(q, k, v, pg, pos, out, b, c, h, kvh, ps,
                               n_live, scale, st);
    case 128: return launch<128>(q, k, v, pg, pos, out, b, c, h, kvh, ps,
                                 n_live, scale, st);
    case 256: return launch<256>(q, k, v, pg, pos, out, b, c, h, kvh, ps,
                                 n_live, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace tc

}  // namespace
}  // namespace repro_torch

// 1 when a launch of this dtype (0 float32, 1 bfloat16) runs the
// tensor-core body, 0 for the SIMT body.
extern "C" int repro_flash_prefill_body(int dtype) {
  return dtype == 1 ? 1 : 0;
}

// q, out: (B, C, H, hd); k/v pools: (NP, ps, KV, hd); pages: (B, n_live)
// int32; pos: (B,) int32 chunk-start positions. dtype: 0 float32,
// 1 bfloat16. Returns cudaGetLastError() after the launch (or the error
// of a refused shared-memory size).
extern "C" int repro_flash_prefill(const void* q, const void* k_pool,
                                   const void* v_pool, const void* pages,
                                   const void* pos, void* out, int dtype,
                                   int b, int c, int h, int kvh, int hd,
                                   int ps, int n_live, float scale,
                                   void* stream) {
  using namespace repro_torch;
  if (b <= 0 || c <= 0 || kvh <= 0 || h % kvh != 0 || n_live <= 0 ||
      ps <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto pg = static_cast<const int32_t*>(pages);
  auto ps_ = static_cast<const int32_t*>(pos);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<float>(hd, q, k_pool, v_pool, pg, ps_, out, b, c, h,
                              kvh, ps, n_live, scale, st);
  if (dtype == 1)
    return tc::dispatch_hd(hd, q, k_pool, v_pool, pg, ps_, out, b, c, h, kvh,
                           ps, n_live, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
