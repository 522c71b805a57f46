// flash_verify: short-window attention over a paged KV pool, the
// speculative verifier's read.
//
// Replaces the Pallas kernel _verify_kernel (src/repro/kernels/
// flash_verify.py:38, launched by flash_verify at :119), which runs in
// every layer of every verify call of self-speculative serving. The
// window's own K/V is already scattered into the slot's pages by the
// caller, so the kernel only reads pages.
//
// Row r of the window's W * G rows of a (slot, KV head) is window offset
// r / G at position pos[b] + r / G and reads positions 0 .. pos[b] + r / G
// (the page gather plus causal masking inside the window), capped at the
// slot's last table position n_live * ps - 1: flash_prefill's read with
// C = W (the plain versions are one function).
//
// Bound on this card: bytes at serving shapes (B 4, W 4, 32 heads of 64 on
// 32 KV heads, page 16, positions 96-127: ~3.8 MB of K/V, ~1.1 us at 3.35
// TB/s), but a call this small is latency-bound: pos and the page table,
// then K/V, then the products.
//
// Two bodies, chosen by dtype alone (repro_flash_verify_body), as
// flash_prefill chooses:
//
// 1. bf16: paged_tc.cuh's tensor-core attend_block, the body
//    flash_prefill's bf16 chunks run, with C = W. One block per (slot, KV
//    head, 16 of the W * G rows), 4 warps, each warp 16 keys of every
//    64-position tile, the tile staged once in shared memory for all the
//    block's rows. At the serving shape W * G = 4 rows fill 4 of the
//    block's 16 MMA rows; the idle rows cost only their share of the
//    products, which are not what bounds the call. Any W: rows past 16 go
//    over blockIdx.z.
//
// 2. f32: the SIMT body of the first port (f32 is not exact on bf16
//    tensor cores at 2e-5; no serving path verifies in f32): one block per
//    (slot, KV head) holding all W * G rows, one warp per row (rows past
//    32 over blockIdx.z) through attend_row (paged_attn.cuh), which reads
//    only the pages its own row can see.
//
// Either way NaN in the trash page or past a row's position never reaches
// the output.
#include <algorithm>

#include "paged_tc.cuh"

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
    case 112: launch<T, 112>(q, k, v, pg, pos, out, b, w, h, kvh, ps,
                             n_live, scale, st); break;
    case 128: launch<T, 128>(q, k, v, pg, pos, out, b, w, h, kvh, ps,
                             n_live, scale, st); break;
    case 256: launch<T, 256>(q, k, v, pg, pos, out, b, w, h, kvh, ps,
                             n_live, scale, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// the tensor-core body under this kernel's own name
template <int HD>
__global__ void __launch_bounds__(tc::kThreads)
    flash_verify_tc_kernel(const sm80::bf16* __restrict__ q,
                           const sm80::bf16* __restrict__ k_pool,
                           const sm80::bf16* __restrict__ v_pool,
                           const int32_t* __restrict__ pages,
                           const int32_t* __restrict__ pos,
                           sm80::bf16* __restrict__ out, int w, int n_heads,
                           int kvh, int ps, int n_live, float scale) {
  tc::attend_block<HD>(q, k_pool, v_pool, pages, pos, out, w, n_heads, kvh,
                       ps, n_live, scale);
}

int tc_dispatch(int hd, const void* q, const void* k, const void* v,
                const int32_t* pg, const int32_t* pos, void* out, int b,
                int w, int h, int kvh, int ps, int n_live, float scale,
                cudaStream_t st) {
  switch (hd) {
    case 16: return tc::launch<16>(flash_verify_tc_kernel<16>, q, k, v, pg,
                                   pos, out, b, w, h, kvh, ps, n_live, scale,
                                   st);
    case 32: return tc::launch<32>(flash_verify_tc_kernel<32>, q, k, v, pg,
                                   pos, out, b, w, h, kvh, ps, n_live, scale,
                                   st);
    case 64: return tc::launch<64>(flash_verify_tc_kernel<64>, q, k, v, pg,
                                   pos, out, b, w, h, kvh, ps, n_live, scale,
                                   st);
    case 112: return tc::launch<112>(flash_verify_tc_kernel<112>, q, k, v,
                                     pg, pos, out, b, w, h, kvh, ps, n_live,
                                     scale, st);
    case 128: return tc::launch<128>(flash_verify_tc_kernel<128>, q, k, v,
                                     pg, pos, out, b, w, h, kvh, ps, n_live,
                                     scale, st);
    case 256: return tc::launch<256>(flash_verify_tc_kernel<256>, q, k, v,
                                     pg, pos, out, b, w, h, kvh, ps, n_live,
                                     scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace repro_torch

// 1 when a launch of this dtype (0 float32, 1 bfloat16) runs the
// tensor-core body, 0 for the SIMT body.
extern "C" int repro_flash_verify_body(int dtype) {
  return dtype == 1 ? 1 : 0;
}

// q, out: (B, W, H, hd); k/v pools: (NP, ps, KV, hd); pages: (B, n_live)
// int32; pos: (B,) int32 window-start positions. dtype: 0 float32,
// 1 bfloat16. Returns cudaGetLastError() after the launch (or the error
// of a refused shared-memory size).
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
    return tc_dispatch(hd, q, k_pool, v_pool, pg, ps_, out, b, w, h, kvh, ps,
                       n_live, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
