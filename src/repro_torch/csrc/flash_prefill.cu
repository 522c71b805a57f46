// flash_prefill: C-token chunk attention over a paged KV pool.
//
// Replaces the Pallas kernel _prefill_kernel (src/repro/kernels/
// flash_prefill.py:45, launched by flash_prefill at :131), which runs on
// every prompt chunk of chunked paged prefill. The chunk's own K/V is
// already scattered into the slot's pages by the caller.
//
// Bound: memory at serving shapes. Row r of the chunk's C * G rows of a
// (slot, KV head) is chunk offset r // G at position pos + r // G, and
// reads positions 0 .. pos + r // G (earlier chunks plus causal inside
// this one). The design: grid (slot, KV head, row group), one warp per
// row, so a B = 1 chunk of C = 32 rows on 32 KV heads still fills 128
// blocks; each warp reads only the pages its own row can see (see
// paged_attn.cuh). Rows of one block re-read the same pages from L1/L2;
// a later version can stage each page once in shared memory.
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
void launch(const void* q, const void* k, const void* v, const int32_t* pg,
            const int32_t* pos, void* out, int b, int c, int h, int kvh,
            int ps, int n_live, float scale, cudaStream_t st) {
  int rows = c * (h / kvh);
  dim3 grid(b, kvh, (rows + kWarps - 1) / kWarps);
  flash_prefill_kernel<T, HD><<<grid, 32 * kWarps, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), pg, pos, static_cast<T*>(out), c, h, kvh,
      ps, n_live, scale);
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v,
                const int32_t* pg, const int32_t* pos, void* out, int b,
                int c, int h, int kvh, int ps, int n_live, float scale,
                cudaStream_t st) {
  switch (hd) {
    case 16: launch<T, 16>(q, k, v, pg, pos, out, b, c, h, kvh, ps,
                           n_live, scale, st); break;
    case 32: launch<T, 32>(q, k, v, pg, pos, out, b, c, h, kvh, ps, n_live,
                           scale, st); break;
    case 64: launch<T, 64>(q, k, v, pg, pos, out, b, c, h, kvh, ps, n_live,
                           scale, st); break;
    case 128: launch<T, 128>(q, k, v, pg, pos, out, b, c, h, kvh, ps,
                             n_live, scale, st); break;
    case 256: launch<T, 256>(q, k, v, pg, pos, out, b, c, h, kvh, ps,
                             n_live, scale, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro_torch

// q, out: (B, C, H, hd); k/v pools: (NP, ps, KV, hd); pages: (B, n_live)
// int32; pos: (B,) int32 chunk-start positions. dtype: 0 float32,
// 1 bfloat16. Returns cudaGetLastError() after the launch.
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
    return dispatch_hd<__nv_bfloat16>(hd, q, k_pool, v_pool, pg, ps_, out,
                                      b, c, h, kvh, ps, n_live, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
