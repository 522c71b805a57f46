// flash_decode: one-token attention over a paged KV pool.
//
// Replaces the Pallas kernel _decode_kernel (src/repro/kernels/
// flash_decode.py:57, launched by flash_decode at :136), which runs on
// every decode step of paged serving.
//
// Bound: memory. A step reads each slot's live K/V once (pos + 1 keys of
// KV * hd values, twice) plus q, and writes one row per head; the
// arithmetic is 4 * hd operations a key and head. The design: one block
// per (slot, KV head) holds that head's G query heads, one warp per
// query head (warps loop when G > 8); each warp reads only pages
// 0 .. pos // ps of its slot's table (see paged_attn.cuh), so a slot's
// dead tail and the trash page are never read. The TPU's sequential page
// grid axis becomes the loop inside the warp.
#include <algorithm>

#include "paged_attn.cuh"

namespace repro_torch {
namespace {

constexpr int kMaxWarps = 8;

template <typename T, int HD>
__global__ void flash_decode_kernel(const T* __restrict__ q,
                                    const T* __restrict__ k_pool,
                                    const T* __restrict__ v_pool,
                                    const int32_t* __restrict__ pages,
                                    const int32_t* __restrict__ pos,
                                    T* __restrict__ out, int n_heads,
                                    int kvh, int ps, int n_live,
                                    float scale) {
  const int b = blockIdx.x, kv = blockIdx.y;
  const int g_per = n_heads / kvh;
  const int warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  const int qpos = pos[b];
  const int32_t* table = pages + static_cast<int64_t>(b) * n_live;
  for (int g = warp; g < g_per; g += n_warps) {
    const int64_t row = (static_cast<int64_t>(b) * n_heads + kv * g_per + g)
                        * HD;
    attend_row<T, HD>(q + row, k_pool, v_pool, table, n_live, ps, kvh, kv,
                      qpos, scale, out + row);
  }
}

template <typename T, int HD>
void launch(const void* q, const void* k, const void* v, const int32_t* pg,
            const int32_t* pos, void* out, int b, int h, int kvh, int ps,
            int n_live, float scale, cudaStream_t st) {
  int warps = std::min(h / kvh, kMaxWarps);
  dim3 grid(b, kvh);
  flash_decode_kernel<T, HD><<<grid, 32 * warps, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), pg, pos, static_cast<T*>(out), h, kvh, ps,
      n_live, scale);
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v,
                const int32_t* pg, const int32_t* pos, void* out, int b,
                int h, int kvh, int ps, int n_live, float scale,
                cudaStream_t st) {
  switch (hd) {
    case 16: launch<T, 16>(q, k, v, pg, pos, out, b, h, kvh, ps, n_live,
                           scale, st); break;
    case 32: launch<T, 32>(q, k, v, pg, pos, out, b, h, kvh, ps, n_live,
                           scale, st); break;
    case 64: launch<T, 64>(q, k, v, pg, pos, out, b, h, kvh, ps, n_live,
                           scale, st); break;
    case 128: launch<T, 128>(q, k, v, pg, pos, out, b, h, kvh, ps, n_live,
                             scale, st); break;
    case 256: launch<T, 256>(q, k, v, pg, pos, out, b, h, kvh, ps, n_live,
                             scale, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro_torch

// q, out: (B, H, hd); k/v pools: (NP, ps, KV, hd); pages: (B, n_live)
// int32; pos: (B,) int32. dtype: 0 float32, 1 bfloat16. Returns
// cudaGetLastError() after the launch.
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
