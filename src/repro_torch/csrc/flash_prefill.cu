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
// 1. bf16: tensor cores, paged_tc.cuh's attend_block (shared with
//    flash_verify.cu), after flash_attention.cu's bf16 body. One block per
//    (slot, KV head, 16 of the C * G rows), 4 warps, so a B 1 chunk of 32
//    rows on 32 KV heads is 64 blocks; K/V tiles of 64 positions gathered
//    through the page table with cp.async, double-buffered, each warp 16
//    keys of a tile on mma.sync, the four partials merged in a fixed
//    order (two calls give the same bits); positions past the last row's
//    are zero-filled, never read, so NaN there cannot reach the output.
//
// 2. f32: the SIMT body of the first port (f32 is not exact on bf16
//    tensor cores at 2e-5): grid (slot, KV head, row group), one warp per
//    row through paged_attn.cuh's attend_row, which reads only the pages
//    its own row can see.
#include "paged_tc.cuh"

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
    case 112: return launch<T, 112>(q, k, v, pg, pos, out, b, c, h, kvh, ps,
                                    n_live, scale, st);
    case 128: return launch<T, 128>(q, k, v, pg, pos, out, b, c, h, kvh, ps,
                                    n_live, scale, st);
    case 256: return launch<T, 256>(q, k, v, pg, pos, out, b, c, h, kvh, ps,
                                    n_live, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// the tensor-core body under this kernel's own name
template <int HD>
__global__ void __launch_bounds__(tc::kThreads)
    flash_prefill_tc_kernel(const sm80::bf16* __restrict__ q,
                            const sm80::bf16* __restrict__ k_pool,
                            const sm80::bf16* __restrict__ v_pool,
                            const int32_t* __restrict__ pages,
                            const int32_t* __restrict__ pos,
                            sm80::bf16* __restrict__ out, int c, int n_heads,
                            int kvh, int ps, int n_live, float scale) {
  tc::attend_block<HD>(q, k_pool, v_pool, pages, pos, out, c, n_heads, kvh,
                       ps, n_live, scale);
}

int tc_dispatch(int hd, const void* q, const void* k, const void* v,
                const int32_t* pg, const int32_t* pos, void* out, int b,
                int c, int h, int kvh, int ps, int n_live, float scale,
                cudaStream_t st) {
  switch (hd) {
    case 16: return tc::launch<16>(flash_prefill_tc_kernel<16>, q, k, v, pg,
                                   pos, out, b, c, h, kvh, ps, n_live, scale,
                                   st);
    case 32: return tc::launch<32>(flash_prefill_tc_kernel<32>, q, k, v, pg,
                                   pos, out, b, c, h, kvh, ps, n_live, scale,
                                   st);
    case 64: return tc::launch<64>(flash_prefill_tc_kernel<64>, q, k, v, pg,
                                   pos, out, b, c, h, kvh, ps, n_live, scale,
                                   st);
    case 112: return tc::launch<112>(flash_prefill_tc_kernel<112>, q, k, v,
                                     pg, pos, out, b, c, h, kvh, ps, n_live,
                                     scale, st);
    case 128: return tc::launch<128>(flash_prefill_tc_kernel<128>, q, k, v,
                                     pg, pos, out, b, c, h, kvh, ps, n_live,
                                     scale, st);
    case 256: return tc::launch<256>(flash_prefill_tc_kernel<256>, q, k, v,
                                     pg, pos, out, b, c, h, kvh, ps, n_live,
                                     scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

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
    return tc_dispatch(hd, q, k_pool, v_pool, pg, ps_, out, b, c, h, kvh, ps,
                       n_live, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
