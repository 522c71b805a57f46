// flash_verify: short-window attention over a paged KV pool, the
// speculative verifier's read.
//
// Replaces the Pallas kernel _verify_kernel (src/repro/kernels/
// flash_verify.py:38, launched by flash_verify at :119), which runs in
// every layer of every verify call of self-speculative serving. The
// window's own K/V is already scattered into the slot's pages by the
// caller, so the kernel only reads pages.
//
// Bound: memory at serving shapes. Window offset w of slot b sits at
// position pos[b] + w and reads positions 0 .. pos[b] + w (the page
// gather plus causal masking inside the window): each slot's live K/V is
// needed once, q read once, one row per (offset, head) written. The TPU
// grid (B, KV, W, n_live) keeps one VMEM scratch per window offset and
// walks pages in order; here one block per (slot, KV head) holds all W*G
// rows of that window, one warp per row, so at W = 4, G = 1 a block is 4
// warps and 4 slots x 32 KV heads give 128 blocks on the 132 SMs. Rows
// past 32 split over blockIdx.z. Each warp runs attend_row
// (paged_attn.cuh) and reads only the pages its own row can see, so NaN
// in the trash page or past the row's position never reaches the output.
// The warps of a block re-read the same pages from L1/L2; staging each
// page once in shared memory for every row is the next design.
#include <algorithm>

#include "paged_attn.cuh"

namespace repro_torch {
namespace {

constexpr int kMaxWarps = 32;

template <typename T, int HD>
__global__ void __launch_bounds__(32 * kMaxWarps)
    flash_verify_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                        const T* __restrict__ v_pool,
                        const int32_t* __restrict__ pages,
                        const int32_t* __restrict__ pos, T* __restrict__ out,
                        int w, int n_heads, int kvh, int ps, int n_live,
                        float scale) {
  const int b = blockIdx.x, kv = blockIdx.y;
  const int g_per = n_heads / kvh;
  const int warps = blockDim.x >> 5;
  const int r = blockIdx.z * warps + (threadIdx.x >> 5);
  if (r >= w * g_per) return;
  const int off = r / g_per, g = r - off * g_per;
  const int qpos = pos[b] + off;
  const int32_t* table = pages + static_cast<int64_t>(b) * n_live;
  // q/out (B, W, H, hd): row (b, off, kv * G + g)
  const int64_t row =
      ((static_cast<int64_t>(b) * w + off) * n_heads + kv * g_per + g) * HD;
  attend_row<T, HD>(q + row, k_pool, v_pool, table, n_live, ps, kvh, kv,
                    qpos, scale, out + row);
}

template <typename T, int HD>
void launch(const void* q, const void* k, const void* v, const int32_t* pg,
            const int32_t* pos, void* out, int b, int w, int h, int kvh,
            int ps, int n_live, float scale, cudaStream_t st) {
  const int rows = w * (h / kvh);
  const int warps = std::min(rows, kMaxWarps);
  dim3 grid(b, kvh, (rows + warps - 1) / warps);
  flash_verify_kernel<T, HD><<<grid, 32 * warps, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), pg, pos, static_cast<T*>(out), w, h, kvh,
      ps, n_live, scale);
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v,
                const int32_t* pg, const int32_t* pos, void* out, int b,
                int w, int h, int kvh, int ps, int n_live, float scale,
                cudaStream_t st) {
  switch (hd) {
    case 16: launch<T, 16>(q, k, v, pg, pos, out, b, w, h, kvh, ps, n_live,
                           scale, st); break;
    case 32: launch<T, 32>(q, k, v, pg, pos, out, b, w, h, kvh, ps, n_live,
                           scale, st); break;
    case 64: launch<T, 64>(q, k, v, pg, pos, out, b, w, h, kvh, ps, n_live,
                           scale, st); break;
    case 128: launch<T, 128>(q, k, v, pg, pos, out, b, w, h, kvh, ps,
                             n_live, scale, st); break;
    case 256: launch<T, 256>(q, k, v, pg, pos, out, b, w, h, kvh, ps,
                             n_live, scale, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro_torch

// q, out: (B, W, H, hd); k/v pools: (NP, ps, KV, hd); pages: (B, n_live)
// int32; pos: (B,) int32 window-start positions. dtype: 0 float32,
// 1 bfloat16. Returns cudaGetLastError() after the launch.
extern "C" int repro_flash_verify(const void* q, const void* k_pool,
                                  const void* v_pool, const void* pages,
                                  const void* pos, void* out, int dtype,
                                  int b, int w, int h, int kvh, int hd,
                                  int ps, int n_live, float scale,
                                  void* stream) {
  using namespace repro_torch;
  if (b <= 0 || w <= 0 || kvh <= 0 || h % kvh != 0 || n_live <= 0 ||
      ps <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto pg = static_cast<const int32_t*>(pages);
  auto ps_ = static_cast<const int32_t*>(pos);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<float>(hd, q, k_pool, v_pool, pg, ps_, out, b, w, h,
                              kvh, ps, n_live, scale, st);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(hd, q, k_pool, v_pool, pg, ps_, out,
                                      b, w, h, kvh, ps, n_live, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
