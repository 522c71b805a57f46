// flash_decode: one-token attention over a paged KV pool.
//
// Replaces the Pallas kernel _decode_kernel (src/repro/kernels/
// flash_decode.py:57, launched by flash_decode at :136), which runs in
// every layer of every decode step of paged serving.
//
// Bound on this card: bytes. A step reads each slot's live K/V once
// (pos + 1 keys of KV * hd values, twice) plus q, and writes one row per
// head: at OPT-1.3B's serving shape (B 4, 32 KV heads of 64, bf16,
// positions 40-127) ~3 MB, ~0.9 us at 3.35 TB/s; at positions up to 2047
// ~51 MB, ~15 us. The arithmetic is 4 * hd operations a key and query
// row, so at G = H / KV = 1 (OPT) a KV head is a GEMV: one operation a
// byte, far below the ~295 operations a byte at which bf16 tensor cores
// rather than memory would be the limit, so this body uses no tensor
// cores (a G >= 8 mma.sync body is not written).
//
// At short contexts the bound is not reachable: the time is the chain of
// dependent memory round trips (pos and the page table, then K/V) and
// the launch. The design keeps that chain at two round trips and, at
// long contexts, keeps enough bytes in flight for the bandwidth:
//
// - one block per (slot, KV head), 8 warps; the block reads pos and its
//   slot's page-table row together, the row into shared memory, and
//   gathers K/V itself through it;
// - tiles follow positions, not pages: position t is page table[t / ps],
//   offset t % ps, so any page size works and a tile may cross pages. A
//   tile is sized in bytes (8 KB of K and 8 KB of V, at most 64 keys), so
//   f32 at hd 256 fits;
// - every K and V chunk of a tile is one 16-byte cp.async into shared
//   memory, all issued at once; a ring of 4 tiles keeps 3 in flight
//   while one is computed (a context of <= 128 bf16 keys at hd 64 is
//   issued whole before the first wait). Positions past the row's own
//   (the unused tail of the last live page, pages past it, the trash
//   page) are never read: cp.async writes zeros there (source size 0),
//   and their probabilities are 0, so NaN garbage cannot reach the
//   output;
// - warps split the tile's keys (G = 1: 8 ways, G = 2: 4, G 3-4: 2) and
//   the G query rows (G >= 5: rows only); lanes split keys too,
//   hd * sizeof(T) / 16 lanes a key (8 at bf16 hd 64), one 16-byte read
//   each, a dot of the lane's elements and log2 of that many butterfly
//   shuffles. All G rows of the KV head share each staged tile;
// - head dim 112 (kimi-k2-1t-a32b) is 14 chunks a row in bf16 and 28 in
//   f32, not a power of two: the lane group a key is padded to the next
//   one (16 lanes in bf16, 2 keys a warp pass; 32 in f32, 1 key), the
//   idle lanes hold zeros, which leave the butterflies' dot and the key
//   groups' merge exact, and read, write and merge nothing; the tile
//   rounds down to a power of two of keys (8 KB / 224 B = 36 -> 32 in
//   bf16, 18 -> 16 in f32) so the key slices still divide it. At 16,
//   32, 64, 128 and 256 nothing of this changes;
// - online softmax in f32 (expf, the -1e30 start, max(l, 1e-30)) over
//   groups of keys; partials (m, l, acc) of the key-splitting warps merge
//   through shared memory in a fixed order. No atomics: two calls give
//   the same bits.
//
// f32 and bf16 take this one body; the dots are true f32 FMAs in both,
// so f32 holds the 2e-5 limit.
#include "paged_attn.cuh"

namespace repro_torch {
namespace {

using sm80::cp_async_commit;
using sm80::cp_async_wait;

constexpr int kStages = 4;     // tiles in the shared-memory ring
constexpr int kWarps = 8;      // warps a block
constexpr int kMaxRows = 4;    // query rows a warp holds

constexpr int pow2_ceil(int n) {
  return n <= 1 ? 1 : 2 * pow2_ceil((n + 1) / 2);
}
constexpr int pow2_floor(int n) { return n < 2 ? 1 : 2 * pow2_floor(n / 2); }

template <typename T, int HD>
struct Geo {
  static constexpr int kRow = HD * static_cast<int>(sizeof(T));  // bytes
  static constexpr int kChunks = kRow / 16;          // 16-byte chunks a row
  static constexpr int kPer = 16 / static_cast<int>(sizeof(T));  // a chunk
  static constexpr int kLanes =                      // lanes a key: 2^n
      pow2_ceil(kChunks) < 32 ? pow2_ceil(kChunks) : 32;
  static constexpr int kCh = (kChunks + kLanes - 1) / kLanes;  // a lane
  // every lane's every chunk lies in the row (all but hd 112)
  static constexpr bool kExact = kChunks % kLanes == 0;
  static constexpr int kE = kCh * kPer;              // elements a lane
  static constexpr int kKeys = 32 / kLanes;          // keys a warp pass
  static constexpr int kTile = pow2_floor(           // keys a tile: 8 KB
      8192 / kRow > 64 ? 64 : (8192 / kRow < 8 ? 8 : 8192 / kRow));
  static constexpr int kRingBytes = kStages * 2 * kTile * kRow;
  static constexpr int kSmemBytes =                  // + merge scratch
      kRingBytes + kWarps * (HD + 2) * static_cast<int>(sizeof(float));
  static_assert(kRow % 16 == 0, "a row is whole 16-byte chunks");
};

// chunk c of the lane's kCh: (lane % kLanes) + kLanes * c, inside the row
// unless the lane is one of hd 112's idle ones
template <typename T, int HD>
__device__ __forceinline__ bool own_chunk(int lane, int c) {
  using G = Geo<T, HD>;
  return G::kExact || (lane % G::kLanes) + G::kLanes * c < G::kChunks;
}

// the lane's kCh chunks of a row (zeros for an idle lane's)
template <typename T, int HD>
__device__ __forceinline__ void row_to_f32(const T* row, int lane,
                                           float* out) {
  using G = Geo<T, HD>;
#pragma unroll
  for (int c = 0; c < G::kCh; ++c) {
    if (own_chunk<T, HD>(lane, c)) {
      load_f32<T, G::kPer>(
          row + ((lane % G::kLanes) + G::kLanes * c) * G::kPer,
          out + c * G::kPer);
    } else {
#pragma unroll
      for (int e = 0; e < G::kPer; ++e) out[c * G::kPer + e] = 0.0f;
    }
  }
}

// KS: warps sharing a query row, each taking 1 / KS of every tile's keys;
// RPW: query rows a warp holds (rows g = warp % NR + i * NR)
template <typename T, int HD, int RPW, int KS>
__global__ void __launch_bounds__(32 * kWarps)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                    const T* __restrict__ v_pool,
                    const int32_t* __restrict__ pages,
                    const int32_t* __restrict__ pos, T* __restrict__ out,
                    int n_heads, int kvh, int ps, int n_live, float scale) {
  using G = Geo<T, HD>;
  constexpr int kSlice = G::kTile / KS;                // keys a warp a tile
  constexpr int kPasses = kSlice / G::kKeys;
  // passes whose scores are held together (one max, one rescale)
  constexpr int kGroup = kPasses < 4 / RPW ? kPasses : 4 / RPW;
  static_assert(kSlice % G::kKeys == 0 && kPasses % kGroup == 0, "tile");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);  // [kStages][K, V][kTile][HD]
  float* part = reinterpret_cast<float*>(smem_raw + G::kRingBytes);
  int* tbl = reinterpret_cast<int*>(smem_raw + G::kSmemBytes);  // [n_live]

  const int b = blockIdx.x, kv = blockIdx.y;
  const int g_per = n_heads / kvh;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int nr = kWarps / KS;              // warps of one key slice
  const int ks = warp / nr, rr = warp % nr;
  const int last = min(pos[b], n_live * ps - 1);    // last position read
  const int n_tiles = last / G::kTile + 1;
  const int32_t* table = pages + static_cast<int64_t>(b) * n_live;
  const int64_t tok = static_cast<int64_t>(kvh) * HD;  // position stride
  const T* kb = k_pool + kv * HD;
  const T* vb = v_pool + kv * HD;
  // the slot's page table, read once beside pos (entries past the live
  // pages are read but never used)
  for (int i = threadIdx.x; i < n_live; i += 32 * kWarps) tbl[i] = table[i];
  __syncthreads();

  auto issue = [&](int tile) {
    T* kd = ring + (tile % kStages) * 2 * G::kTile * HD;
    gather_kv_tile<T, HD, G::kTile, HD, 32 * kWarps>(
        kd, kd + G::kTile * HD, kb, vb, tbl, tile * G::kTile, last, ps, tok);
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) issue(s);
    cp_async_commit();
  }

  // this warp's query rows, scaled as attend_row scales them
  int n_rows = 0;
  float qf[RPW][G::kE], acc[RPW][G::kE], m[RPW], l[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int g = rr + i * nr;
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int e = 0; e < G::kE; ++e) qf[i][e] = acc[i][e] = 0.0f;
    if (g < g_per) {
      n_rows = i + 1;
      row_to_f32<T, HD>(q + (static_cast<int64_t>(b) * n_heads + kv * g_per +
                             g) * HD, lane, qf[i]);
#pragma unroll
      for (int e = 0; e < G::kE; ++e) qf[i][e] = __fmul_rn(qf[i][e], scale);
    }
  }

  for (int tile = 0; tile < n_tiles; ++tile) {
    cp_async_wait<kStages - 2>();
    __syncthreads();              // tile ready; tile - 1's buffer free
    if (tile + kStages - 1 < n_tiles) issue(tile + kStages - 1);
    cp_async_commit();
    if (n_rows == 0) continue;
    const T* kd = ring + (tile % kStages) * 2 * G::kTile * HD;
    const T* vd = kd + G::kTile * HD;
#pragma unroll
    for (int p0 = 0; p0 < kPasses; p0 += kGroup) {
      float s[kGroup][RPW];
      bool valid[kGroup];
#pragma unroll
      for (int p = 0; p < kGroup; ++p) {
        const int j = ks * kSlice + (p0 + p) * G::kKeys + lane / G::kLanes;
        valid[p] = tile * G::kTile + j <= last;
        float kf[G::kE];
        row_to_f32<T, HD>(kd + j * HD, lane, kf);
#pragma unroll
        for (int i = 0; i < RPW; ++i) {
          float d = 0.0f;
#pragma unroll
          for (int e = 0; e < G::kE; ++e) d = fmaf(qf[i][e], kf[e], d);
          s[p][i] = d;
        }
      }
#pragma unroll
      for (int off = 1; off < G::kLanes; off <<= 1)
#pragma unroll
        for (int p = 0; p < kGroup; ++p)
#pragma unroll
          for (int i = 0; i < RPW; ++i)
            s[p][i] += __shfl_xor_sync(0xffffffffu, s[p][i], off);
      float vf[kGroup][G::kE];
#pragma unroll
      for (int p = 0; p < kGroup; ++p) {
        const int j = ks * kSlice + (p0 + p) * G::kKeys + lane / G::kLanes;
        row_to_f32<T, HD>(vd + j * HD, lane, vf[p]);
      }
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        if (i >= n_rows) break;
        float mx = kNegInf;
#pragma unroll
        for (int p = 0; p < kGroup; ++p)
          if (valid[p]) mx = fmaxf(mx, s[p][i]);
#pragma unroll
        for (int off = G::kLanes; off < 32; off <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m[i], mx);
        const float alpha = expf(m[i] - m_new);
        l[i] *= alpha;
#pragma unroll
        for (int e = 0; e < G::kE; ++e) acc[i][e] *= alpha;
#pragma unroll
        for (int p = 0; p < kGroup; ++p) {
          const float pr = valid[p] ? expf(s[p][i] - m_new) : 0.0f;
          l[i] += pr;
#pragma unroll
          for (int e = 0; e < G::kE; ++e)
            acc[i][e] = fmaf(pr, vf[p][e], acc[i][e]);
        }
        m[i] = m_new;
      }
    }
  }
  cp_async_wait<0>();

  // sum the key groups of the warp (lanes kLanes apart)
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    if (i >= n_rows) break;
#pragma unroll
    for (int off = G::kLanes; off < 32; off <<= 1) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
#pragma unroll
      for (int e = 0; e < G::kE; ++e)
        acc[i][e] += __shfl_xor_sync(0xffffffffu, acc[i][e], off);
    }
  }
  const bool writer = lane < G::kLanes;
  auto store = [&](int g, const float* o, float denom) {
    float y[G::kE];
#pragma unroll
    for (int e = 0; e < G::kE; ++e) y[e] = o[e] / denom;
    T* row = out + (static_cast<int64_t>(b) * n_heads + kv * g_per + g) * HD;
#pragma unroll
    for (int c = 0; c < G::kCh; ++c)
      if (own_chunk<T, HD>(lane, c))
        store_from_f32<T, G::kPer>(row + (lane + G::kLanes * c) * G::kPer,
                                   y + c * G::kPer);
  };
  if constexpr (KS == 1) {
#pragma unroll
    for (int i = 0; i < RPW; ++i)
      if (i < n_rows && writer) store(rr + i * nr, acc[i], fmaxf(l[i], 1e-30f));
  } else {
    // KS warps hold partials of one row (RPW = 1, G <= nr): merge them
    // through shared memory, slice 0 first
    if (writer && n_rows > 0) {
      float* pr = part + (ks * nr + rr) * (HD + 2);
#pragma unroll
      for (int c = 0; c < G::kCh; ++c)
        if (own_chunk<T, HD>(lane, c))
#pragma unroll
          for (int e = 0; e < G::kPer; ++e)
            pr[(lane + G::kLanes * c) * G::kPer + e] =
                acc[0][c * G::kPer + e];
      if (lane == 0) {
        pr[HD] = m[0];
        pr[HD + 1] = l[0];
      }
    }
    __syncthreads();
    if (ks == 0 && writer && n_rows > 0) {
      float mm = kNegInf;
#pragma unroll
      for (int k = 0; k < KS; ++k)
        mm = fmaxf(mm, part[(k * nr + rr) * (HD + 2) + HD]);
      float o[G::kE], den = 0.0f;
#pragma unroll
      for (int e = 0; e < G::kE; ++e) o[e] = 0.0f;
#pragma unroll
      for (int k = 0; k < KS; ++k) {
        const float* pr = part + (k * nr + rr) * (HD + 2);
        const float w = expf(pr[HD] - mm);
        den = fmaf(w, pr[HD + 1], den);
#pragma unroll
        for (int c = 0; c < G::kCh; ++c)
          if (own_chunk<T, HD>(lane, c))
#pragma unroll
            for (int e = 0; e < G::kPer; ++e)
              o[c * G::kPer + e] =
                  fmaf(w, pr[(lane + G::kLanes * c) * G::kPer + e],
                       o[c * G::kPer + e]);
      }
      store(rr, o, fmaxf(den, 1e-30f));
    }
  }
}

template <typename T, int HD, int RPW, int KS>
int launch_geo(const void* q, const void* k, const void* v,
               const int32_t* pg, const int32_t* pos, void* out, int b,
               int h, int kvh, int ps, int n_live, float scale,
               cudaStream_t st) {
  const size_t bytes = Geo<T, HD>::kSmemBytes + sizeof(int) * n_live;
  auto kern = flash_decode_kernel<T, HD, RPW, KS>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_optin());
  if (attr != cudaSuccess) return static_cast<int>(attr);
  dim3 grid(b, kvh);
  kern<<<grid, 32 * kWarps, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), pg, pos, static_cast<T*>(out), h, kvh, ps,
      n_live, scale);
  return static_cast<int>(cudaGetLastError());
}

// the 8 warps split each tile's keys KS ways (G = 1: 8, G = 2: 4, G 3-4:
// 2; at most as many slices as a tile has warp passes) and the G rows
// over the 8 / KS warps of a slice, at most 4 rows a warp
template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const int32_t* pg,
           const int32_t* pos, void* out, int b, int h, int kvh, int ps,
           int n_live, float scale, cudaStream_t st) {
  using G = Geo<T, HD>;
  constexpr int kMaxSplit = G::kTile / G::kKeys;
  const int g = h / kvh;
  if (g > kWarps * kMaxRows) return static_cast<int>(cudaErrorInvalidValue);
  int split = 1;
  while (2 * split * g <= kWarps && 2 * split <= kMaxSplit) split *= 2;
  const int nr = kWarps / split, rpw = (g + nr - 1) / nr;
#define REPRO_DECODE(RPW, KS)                                              \
  return launch_geo<T, HD, RPW, KS>(q, k, v, pg, pos, out, b, h, kvh, ps, \
                                    n_live, scale, st)
  if constexpr (kMaxSplit >= 8) {
    if (split == 8) REPRO_DECODE(1, 8);
  }
  if constexpr (kMaxSplit >= 4) {
    if (split == 4) REPRO_DECODE(1, 4);
  }
  if constexpr (kMaxSplit >= 2) {
    if (split == 2) REPRO_DECODE(1, 2);
  }
  if (rpw == 1) REPRO_DECODE(1, 1);
  if (rpw == 2) REPRO_DECODE(2, 1);
  REPRO_DECODE(4, 1);
#undef REPRO_DECODE
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v,
                const int32_t* pg, const int32_t* pos, void* out, int b,
                int h, int kvh, int ps, int n_live, float scale,
                cudaStream_t st) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, pg, pos, out, b, h, kvh, ps,
                                  n_live, scale, st);
    case 32: return launch<T, 32>(q, k, v, pg, pos, out, b, h, kvh, ps,
                                  n_live, scale, st);
    case 64: return launch<T, 64>(q, k, v, pg, pos, out, b, h, kvh, ps,
                                  n_live, scale, st);
    case 112: return launch<T, 112>(q, k, v, pg, pos, out, b, h, kvh, ps,
                                    n_live, scale, st);
    case 128: return launch<T, 128>(q, k, v, pg, pos, out, b, h, kvh, ps,
                                    n_live, scale, st);
    case 256: return launch<T, 256>(q, k, v, pg, pos, out, b, h, kvh, ps,
                                    n_live, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace repro_torch

// q, out: (B, H, hd); k/v pools: (NP, ps, KV, hd); pages: (B, n_live)
// int32; pos: (B,) int32. dtype: 0 float32, 1 bfloat16. Returns
// cudaGetLastError() after the launch (or the error of a refused
// shared-memory size).
extern "C" int repro_flash_decode(const void* q, const void* k_pool,
                                  const void* v_pool, const void* pages,
                                  const void* pos, void* out, int dtype,
                                  int b, int h, int kvh, int hd, int ps,
                                  int n_live, float scale, void* stream) {
  using namespace repro_torch;
  if (b <= 0 || kvh <= 0 || h % kvh != 0 || n_live <= 0 || ps <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto pg = static_cast<const int32_t*>(pages);
  auto ps_ = static_cast<const int32_t*>(pos);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<float>(hd, q, k_pool, v_pool, pg, ps_, out, b, h,
                              kvh, ps, n_live, scale, st);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(hd, q, k_pool, v_pool, pg, ps_, out,
                                      b, h, kvh, ps, n_live, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
