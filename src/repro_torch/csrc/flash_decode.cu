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
// row, G = H / KV rows sharing each key: G operations a byte in bf16 (1
// at OPT's MHA, 8 at gemma-2b and kimi-k2, 16 at chatglm3), under the
// ~20 at which the f32 FMA rate rather than memory would be the limit.
// But a SIMT warp spends ~20 instructions a key and row (loads, a dot,
// its butterfly, the softmax), so at G >= 8 the instructions, not the
// bytes, bound a SIMT body; bf16 at G 8-16 runs the dots on tensor
// cores instead (below). f32 stays true-f32 FMAs (its 2e-5 limit).
//
// Two routes, picked by G alone (the launcher in kernels/flash_decode.py
// calls repro_flash_decode for G = 1, repro_flash_decode_split for
// G >= 2):
//
// The slot route (G = 1: OPT-1.3B, RoBERTa, whisper-base's self
// attention; B x KV blocks fill the card there). At short contexts the
// bound is not reachable: the time is the chain of dependent memory
// round trips (pos and the page table, then K/V) and the launch. The
// design keeps that chain at two round trips and, at long contexts,
// keeps enough bytes in flight for the bandwidth:
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
// - warps split the tile's keys 8 ways (4 in bf16 at hd 16, whose tile
//   has 4 warp passes); lanes split keys too, hd * sizeof(T) / 16 lanes
//   a key (8 at bf16 hd 64), one 16-byte read each, a dot of the lane's
//   elements and log2 of that many butterfly shuffles;
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
// The split route (G >= 2: every GQA / MQA layout, flash-decoding). With
// one block per (slot, KV head), gemma-2b (8 heads over 1 KV of 256) at
// B 4 ran 4 blocks on 132 SMs, each streaming a whole slot alone, and a
// warp took every key of its row. Here a third grid dimension splits each
// slot's positions into chunks:
//
// - block (slot, KV head, chunk) stages its chunk's K/V through the page
//   table with the slot route's cp.async ring, lane groups and tiles
//   (its slice of the table row only, read beside pos: it depends on the
//   chunk alone), computes the G rows' partial
//   (m, l, acc) in f32 and writes it unnormalized to a f32 workspace
//   (B, KV, chunks, G, hd + 2): acc, then m, then l;
// - in the block, warps split the chunk's keys KS ways and hold RPW rows
//   each (G 2: 2 rows, 8 key slices; G 3-4: 4, 8; G 5-8: 4, 4; G 9-16:
//   4, 2; G 17-32: 4, 1), so every staged key feeds up to 4 rows from
//   registers; the key slices' partials go through shared memory (the
//   drained ring) and the whole block merges them, a thread an element,
//   in slice order;
// - the chunk length is the launcher's (kernels/flash_decode.py,
//   split_plan): 64 * max(ceil(S / 2048), min(256 / hd, ceil(S / 128)))
//   positions for a table of S = n_live * ps, a multiple of every tile,
//   about 64 KB of bf16 K/V, at most 32 chunks. It depends on hd and the
//   table's width only, never on B, the other slots, pos or the SM
//   count, so a slot decodes to the same bits at any batch;
// - pos is read on the card only: a chunk past the slot's position
//   issues no copy and writes the empty partial (m -1e30, l 0, acc 0),
//   so the route needs no host sync and can be captured in a graph;
// - bf16 at 8 <= G <= 16 (gemma-2b, kimi-k2, chatglm3 / glm4) runs the
//   chunk on paged_tc.cuh's mma.sync body in its chunked mode (the G
//   rows one m16 tile, 4 warps of 16 keys a 64-key tile, f32
//   accumulators, exp2 on the SFU), as flash_prefill's and
//   flash_verify's bf16 do: it rounds P to bf16 for P V, as the plain
//   attention does, where the SIMT body keeps f32 P; its partial's m is
//   written in nats, so the merge takes either body's. Every other
//   layout and all f32 run the SIMT body;
// - a second kernel merges a row's chunks in chunk order (one block a
//   row, one thread an element, every chunk's element loaded at once):
//   m the max, each chunk's weight expf(m_c - m), 0 for an empty chunk
//   (never exp(-1e30 - m)), l and acc summed by fmaf in chunk order,
//   out = acc / max(l, 1e-30). No atomics: two calls give the same bits.
//
// f32 takes only the SIMT bodies, whose dots are true f32 FMAs, so it
// holds the 2e-5 limit; bf16 holds 2e-2 on either body.
#include "paged_attn.cuh"
#include "paged_tc.cuh"

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

// KS: warps sharing the query row (G = 1), each taking 1 / KS of every
// tile's keys
template <typename T, int HD, int KS>
__global__ void __launch_bounds__(32 * kWarps)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                    const T* __restrict__ v_pool,
                    const int32_t* __restrict__ pages,
                    const int32_t* __restrict__ pos, T* __restrict__ out,
                    int n_heads, int kvh, int ps, int n_live, float scale) {
  using G = Geo<T, HD>;
  constexpr int RPW = 1;                               // rows a warp
  constexpr int kSlice = G::kTile / KS;                // keys a warp a tile
  constexpr int kPasses = kSlice / G::kKeys;
  // passes whose scores are held together (one max, one rescale)
  constexpr int kGroup = kPasses < 4 / RPW ? kPasses : 4 / RPW;
  static_assert(KS >= 2, "the key slices' merge below");
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
  // the KS warps of a row group hold partials of the row: merge them
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

template <typename T, int HD, int KS>
int launch_geo(const void* q, const void* k, const void* v,
               const int32_t* pg, const int32_t* pos, void* out, int b,
               int h, int kvh, int ps, int n_live, float scale,
               cudaStream_t st) {
  const size_t bytes = Geo<T, HD>::kSmemBytes + sizeof(int) * n_live;
  auto kern = flash_decode_kernel<T, HD, KS>;
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

// G = 1 only: the 8 warps split each tile's keys KS ways, 8 or as many
// as a tile has warp passes (4 in bf16 at hd 16)
template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const int32_t* pg,
           const int32_t* pos, void* out, int b, int h, int kvh, int ps,
           int n_live, float scale, cudaStream_t st) {
  using G = Geo<T, HD>;
  constexpr int kMaxSplit = G::kTile / G::kKeys;
  constexpr int KS = kMaxSplit < kWarps ? kMaxSplit : kWarps;
  if (h != kvh) return static_cast<int>(cudaErrorInvalidValue);
  return launch_geo<T, HD, KS>(q, k, v, pg, pos, out, b, h, kvh, ps, n_live,
                               scale, st);
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

// ---------------------------------------------------------------------------
// The split route (G >= 2)

constexpr int kMaxChunks = 32;  // chunks a slot: the merge's registers

// Block (slot b, KV head kv, chunk c): positions c * chunk .. (c + 1) *
// chunk - 1 of the slot, RPW rows a warp (rows g = rr + i * NR), KS key
// slices; writes the G rows' partials to ws[b, kv, c].
template <typename T, int HD, int RPW, int KS>
__global__ void __launch_bounds__(32 * kWarps)
flash_decode_split_kernel(const T* __restrict__ q,
                          const T* __restrict__ k_pool,
                          const T* __restrict__ v_pool,
                          const int32_t* __restrict__ pages,
                          const int32_t* __restrict__ pos,
                          float* __restrict__ ws, int n_heads, int kvh,
                          int ps, int n_live, int chunk, int n_chunks,
                          float scale) {
  using G = Geo<T, HD>;
  constexpr int kSlice = G::kTile / KS;                // keys a warp a tile
  constexpr int kPasses = kSlice / G::kKeys;
  // passes whose scores are held together (one max, one rescale): the
  // warp's whole slice of a tile, up to 16 scores a lane
  constexpr int kGroup = kPasses < 16 / RPW ? kPasses : 16 / RPW;
  constexpr int NR = kWarps / KS;                      // row groups
  constexpr int kPart = HD + 2;                        // acc, m, l
  static_assert(kSlice % G::kKeys == 0 && kPasses % kGroup == 0, "tile");
  static_assert(kWarps * RPW * kPart * 4 <= G::kRingBytes,
                "the key slices' partials fit the drained ring");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);  // [kStages][K, V][kTile][HD]
  int* tbl = reinterpret_cast<int*>(smem_raw + G::kRingBytes);

  const int b = blockIdx.x, kv = blockIdx.y, c = blockIdx.z;
  const int g_per = n_heads / kvh;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ks = warp / NR, rr = warp % NR;
  const int t0 = c * chunk;
  // the chunk's slice of the table row depends on c alone: read beside
  // pos, not after it
  const int p0 = t0 / ps;                           // first logical page
  const int p_end = min(n_live - 1, (t0 + chunk - 1) / ps);
  const int32_t* table = pages + static_cast<int64_t>(b) * n_live + p0;
  for (int i = threadIdx.x; p0 + i <= p_end; i += 32 * kWarps)
    tbl[i] = table[i];
  const int last = min(pos[b], n_live * ps - 1);    // last position read
  float* part_out =
      ws + ((static_cast<int64_t>(b) * kvh + kv) * n_chunks + c) * g_per *
               kPart;
  if (t0 > last) {              // past the slot's position: empty partial
    for (int i = threadIdx.x; i < g_per * kPart; i += 32 * kWarps)
      part_out[i] = i % kPart == HD ? kNegInf : 0.0f;
    return;
  }
  const int t_last = min(last, t0 + chunk - 1);     // the chunk's last key
  const int n_tiles = (t_last - t0) / G::kTile + 1;
  __syncthreads();

  const int64_t tok = static_cast<int64_t>(kvh) * HD;  // position stride
  const T* kb = k_pool + kv * HD;
  const T* vb = v_pool + kv * HD;
  auto issue = [&](int tile) {
    T* kd = ring + (tile % kStages) * 2 * G::kTile * HD;
    gather_kv_tile<T, HD, G::kTile, HD, 32 * kWarps>(
        kd, kd + G::kTile * HD, kb, vb, tbl, t0 + tile * G::kTile, t_last,
        ps, tok, p0);
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) issue(s);
    cp_async_commit();
  }

  // this warp's query rows, scaled as the slot route scales them
  int n_rows = 0;
  float qf[RPW][G::kE], acc[RPW][G::kE], m[RPW], l[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int g = rr + i * NR;
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
    for (int p0k = 0; p0k < kPasses; p0k += kGroup) {
      float s[kGroup][RPW];
      bool valid[kGroup];
#pragma unroll
      for (int p = 0; p < kGroup; ++p) {
        const int j = ks * kSlice + (p0k + p) * G::kKeys + lane / G::kLanes;
        valid[p] = t0 + tile * G::kTile + j <= t_last;
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
      // one max and one rescale a row for the group
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
        m[i] = m_new;
      }
#pragma unroll
      for (int p = 0; p < kGroup; ++p) {
        const int j = ks * kSlice + (p0k + p) * G::kKeys + lane / G::kLanes;
        float vf[G::kE];
        row_to_f32<T, HD>(vd + j * HD, lane, vf);
#pragma unroll
        for (int i = 0; i < RPW; ++i) {
          if (i >= n_rows) break;
          const float pr = valid[p] ? expf(s[p][i] - m[i]) : 0.0f;
          l[i] += pr;
#pragma unroll
          for (int e = 0; e < G::kE; ++e)
            acc[i][e] = fmaf(pr, vf[e], acc[i][e]);
        }
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
  // the lane's elements of a row's partial (o: kE floats) at dst
  auto put = [&](float* dst, const float* o, float mm, float ll) {
#pragma unroll
    for (int cc = 0; cc < G::kCh; ++cc)
      if (own_chunk<T, HD>(lane, cc))
#pragma unroll
        for (int e = 0; e < G::kPer; ++e)
          dst[(lane + G::kLanes * cc) * G::kPer + e] = o[cc * G::kPer + e];
    if (lane == 0) {
      dst[HD] = mm;
      dst[HD + 1] = ll;
    }
  };
  if constexpr (KS == 1) {
#pragma unroll
    for (int i = 0; i < RPW; ++i)
      if (i < n_rows && writer)
        put(part_out + (rr + i * NR) * kPart, acc[i], m[i], l[i]);
  } else {
    // the KS slices' partials of a row through the drained ring, then the
    // whole block merges them, a thread an element, in slice order
    float* part = reinterpret_cast<float*>(smem_raw);
    __syncthreads();              // every warp is done with the ring
    if (writer) {
#pragma unroll
      for (int i = 0; i < RPW; ++i)
        if (i < n_rows)
          put(part + ((ks * NR + rr) * RPW + i) * kPart, acc[i], m[i], l[i]);
    }
    __syncthreads();
    for (int t = threadIdx.x; t < g_per * HD; t += 32 * kWarps) {
      const int g = t / HD, e = t % HD;
      // row g is row g / NR of row group g % NR
      const float* pr = part + ((g % NR) * RPW + g / NR) * kPart;
      constexpr int kSliceStride = NR * RPW * kPart;
      float mm = kNegInf;
#pragma unroll
      for (int k = 0; k < KS; ++k) mm = fmaxf(mm, pr[k * kSliceStride + HD]);
      float o = 0.0f, den = 0.0f;
#pragma unroll
      for (int k = 0; k < KS; ++k) {
        const float* pk = pr + k * kSliceStride;
        // a slice that saw no key of the chunk weighs 0
        const float w = pk[HD] == kNegInf ? 0.0f : expf(pk[HD] - mm);
        den = fmaf(w, pk[HD + 1], den);
        o = fmaf(w, pk[e], o);
      }
      float* dst = part_out + g * kPart;
      dst[e] = o;
      if (e == 0) {
        dst[HD] = mm;
        dst[HD + 1] = den;
      }
    }
  }
}

// One block a row (b, h), one thread an element: every chunk's partial
// element is loaded at once (n_chunks <= 32 registers a thread), the
// first warp takes the chunks' (m, l) (lane c: chunk c) and their weights,
// then each thread sums its element in chunk order.
template <int HD>
constexpr int merge_threads() { return (HD + 31) / 32 * 32; }

template <typename T, int HD>
__global__ void __launch_bounds__(merge_threads<HD>())
flash_decode_merge_kernel(const float* __restrict__ ws, T* __restrict__ out,
                          int n_heads, int kvh, int n_chunks) {
  constexpr int kPart = HD + 2;
  __shared__ float w_s[kMaxChunks], l_s[kMaxChunks];
  const int row = blockIdx.x, d = threadIdx.x;      // row = b * H + h
  const int b = row / n_heads, h = row % n_heads;
  const int g_per = n_heads / kvh, kv = h / g_per, g = h % g_per;
  const int64_t stride = static_cast<int64_t>(g_per) * kPart;  // a chunk
  const float* src =
      ws + (static_cast<int64_t>(b) * kvh + kv) * n_chunks * stride +
      static_cast<int64_t>(g) * kPart;
  float a[kMaxChunks];
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c)
    a[c] = c < n_chunks && d < HD ? src[c * stride + d] : 0.0f;
  if (threadIdx.x < 32) {
    const int c = threadIdx.x;
    const float mc = c < n_chunks ? src[c * stride + HD] : kNegInf;
    float mm = mc;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mm = fmaxf(mm, __shfl_xor_sync(0xffffffffu, mm, off));
    // an empty chunk weighs 0 (never exp(-1e30 - m), which is 1 while
    // every chunk is empty)
    w_s[c] = mc == kNegInf ? 0.0f : expf(mc - mm);
    l_s[c] = c < n_chunks ? src[c * stride + HD + 1] : 0.0f;
  }
  __syncthreads();
  float den = 0.0f, acc = 0.0f;
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) {
    if (c < n_chunks) {
      den = fmaf(w_s[c], l_s[c], den);
      acc = fmaf(w_s[c], a[c], acc);
    }
  }
  if (d < HD)
    out[static_cast<int64_t>(row) * HD + d] =
        f32_as<T>(acc / fmaxf(den, 1e-30f));
}

// the merge kernel on `st`, behind the chunk kernel launched there
template <typename T, int HD>
int launch_merge(const float* ws, void* out, int b, int h, int kvh,
                 int n_chunks, cudaStream_t st) {
  flash_decode_merge_kernel<T, HD><<<b * h, merge_threads<HD>(), 0, st>>>(
      ws, static_cast<T*>(out), h, kvh, n_chunks);
  return static_cast<int>(cudaGetLastError());
}

// The split route's tensor-core body (bf16, 8 <= G <= 16): paged_tc.cuh's
// attend_block in its chunked mode, one m16 tile of the G rows.
template <int HD>
__global__ void __launch_bounds__(tc::kThreads)
flash_decode_split_tc_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k_pool,
                             const __nv_bfloat16* __restrict__ v_pool,
                             const int32_t* __restrict__ pages,
                             const int32_t* __restrict__ pos,
                             float* __restrict__ ws, int n_heads, int kvh,
                             int ps, int n_live, int chunk, int n_chunks,
                             float scale) {
  tc::attend_block<HD, true>(q, k_pool, v_pool, pages, pos, nullptr, 1,
                             n_heads, kvh, ps, n_live, scale, ws, chunk,
                             n_chunks);
}

// the split route's body: 1 (tensor cores) for bf16 at 8 <= G <= 16,
// 0 (SIMT) otherwise
inline bool split_tc(int dtype, int g) {
  return dtype == 1 && g >= 8 && g <= tc::kRows;
}

template <int HD>
int launch_split_tc(const void* q, const void* k, const void* v,
                    const int32_t* pg, const int32_t* pos, float* ws,
                    void* out, int b, int h, int kvh, int ps, int n_live,
                    int chunk, int n_chunks, float scale, cudaStream_t st) {
  const size_t bytes = tc::smem_bytes<HD>() + sizeof(int) * (chunk / ps + 2);
  auto kern = flash_decode_split_tc_kernel<HD>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_optin());
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kern<<<dim3(b, kvh, n_chunks), tc::kThreads, bytes, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), pg, pos, ws, h, kvh, ps, n_live, chunk,
      n_chunks, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_merge<__nv_bfloat16, HD>(ws, out, b, h, kvh, n_chunks, st);
}

template <typename T, int HD, int RPW, int KS>
int launch_split_geo(const void* q, const void* k, const void* v,
                     const int32_t* pg, const int32_t* pos, float* ws,
                     void* out, int b, int h, int kvh, int ps, int n_live,
                     int chunk, int n_chunks, float scale, cudaStream_t st) {
  // the chunk's slice of the table row: at most chunk / ps + 2 pages
  const size_t bytes =
      Geo<T, HD>::kRingBytes + sizeof(int) * (chunk / ps + 2);
  auto kern = flash_decode_split_kernel<T, HD, RPW, KS>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_optin());
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kern<<<dim3(b, kvh, n_chunks), 32 * kWarps, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), pg, pos, ws, h, kvh, ps, n_live, chunk,
      n_chunks, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_merge<T, HD>(ws, out, b, h, kvh, n_chunks, st);
}

// RPW rows a warp (2 at G = 2, else 4), the 8 warps' remaining factor as
// key slices (at most as many as a tile has warp passes; fewer slices,
// then, and fewer rows a warp)
template <typename T, int HD>
int launch_split(const void* q, const void* k, const void* v,
                 const int32_t* pg, const int32_t* pos, float* ws, void* out,
                 int b, int h, int kvh, int ps, int n_live, int chunk,
                 int n_chunks, float scale, cudaStream_t st) {
  using G = Geo<T, HD>;
  constexpr int kMaxSplit = G::kTile / G::kKeys;
  const int g = h / kvh;
  if (g < 2 || g > kWarps * kMaxRows)
    return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (sizeof(T) == 2) {
    if (split_tc(1, g))
      return launch_split_tc<HD>(q, k, v, pg, pos, ws, out, b, h, kvh, ps,
                                 n_live, chunk, n_chunks, scale, st);
  }
  int rpw = g == 2 ? 2 : 4;
  int nr = pow2_ceil((g + rpw - 1) / rpw);
  int ks = kWarps / nr;
  if (ks > kMaxSplit) {
    ks = kMaxSplit;
    nr = kWarps / ks;
    rpw = pow2_ceil((g + nr - 1) / nr);
  }
#define REPRO_SPLIT(RPW, KS)                                                \
  if (rpw == RPW && ks == KS)                                               \
    return launch_split_geo<T, HD, RPW, KS>(q, k, v, pg, pos, ws, out, b, h, \
                                            kvh, ps, n_live, chunk,         \
                                            n_chunks, scale, st)
  if constexpr (kMaxSplit >= 8) {
    REPRO_SPLIT(2, 8);
    REPRO_SPLIT(4, 8);
  }
  if constexpr (kMaxSplit >= 4) REPRO_SPLIT(4, 4);
  REPRO_SPLIT(4, 2);
  REPRO_SPLIT(4, 1);
  if constexpr (kMaxSplit == 4) {
    REPRO_SPLIT(1, 4);
    REPRO_SPLIT(2, 4);
  }
#undef REPRO_SPLIT
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int dispatch_split_hd(int hd, const void* q, const void* k, const void* v,
                      const int32_t* pg, const int32_t* pos, float* ws,
                      void* out, int b, int h, int kvh, int ps, int n_live,
                      int chunk, int n_chunks, float scale,
                      cudaStream_t st) {
#define REPRO_SPLIT_HD(HD)                                                 \
  case HD:                                                                 \
    return launch_split<T, HD>(q, k, v, pg, pos, ws, out, b, h, kvh, ps,  \
                               n_live, chunk, n_chunks, scale, st)
  switch (hd) {
    REPRO_SPLIT_HD(16);
    REPRO_SPLIT_HD(32);
    REPRO_SPLIT_HD(64);
    REPRO_SPLIT_HD(112);
    REPRO_SPLIT_HD(128);
    REPRO_SPLIT_HD(256);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_SPLIT_HD
}

}  // namespace
}  // namespace repro_torch

// The slot route (G = 1: h == kvh). q, out: (B, H, hd); k/v pools:
// (NP, ps, KV, hd); pages: (B, n_live) int32; pos: (B,) int32. dtype: 0
// float32, 1 bfloat16. Returns cudaGetLastError() after the launch (or
// the error of a refused shared-memory size, or cudaErrorInvalidValue
// for G >= 2, which is the split route's).
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


// The split route: q, out, pools, pages, pos as repro_flash_decode; ws a
// f32 workspace of (B, KV, n_chunks, H / KV, hd + 2); chunk the positions
// a chunk (a multiple of 64), n_chunks = ceil(n_live * ps / chunk) <= 32.
// Launches the chunk kernel, then the merge kernel, on the stream.
// Returns cudaGetLastError() after the launches (or the error of a
// refused shared-memory size, or cudaErrorInvalidValue for arguments the
// route does not take: G < 2 or > 32, a chunk plan other than this).
extern "C" int repro_flash_decode_split(const void* q, const void* k_pool,
                                        const void* v_pool,
                                        const void* pages, const void* pos,
                                        void* ws, void* out, int dtype,
                                        int b, int h, int kvh, int hd,
                                        int ps, int n_live, int chunk,
                                        int n_chunks, float scale,
                                        void* stream) {
  using namespace repro_torch;
  if (b <= 0 || kvh <= 0 || h % kvh != 0 || n_live <= 0 || ps <= 0 ||
      chunk <= 0 || chunk % 64 != 0 || n_chunks > kMaxChunks ||
      n_chunks != (n_live * ps + chunk - 1) / chunk)
    return static_cast<int>(cudaErrorInvalidValue);
  auto pg = static_cast<const int32_t*>(pages);
  auto ps_ = static_cast<const int32_t*>(pos);
  auto w = static_cast<float*>(ws);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_split_hd<float>(hd, q, k_pool, v_pool, pg, ps_, w, out,
                                    b, h, kvh, ps, n_live, chunk, n_chunks,
                                    scale, st);
  if (dtype == 1)
    return dispatch_split_hd<__nv_bfloat16>(hd, q, k_pool, v_pool, pg, ps_,
                                            w, out, b, h, kvh, ps, n_live,
                                            chunk, n_chunks, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The split route's body for dtype (0 float32, 1 bfloat16) and G: 1 for
// the tensor-core body, 0 for the SIMT one.
extern "C" int repro_flash_decode_split_body(int dtype, int g) {
  return repro_torch::split_tc(dtype, g) ? 1 : 0;
}
