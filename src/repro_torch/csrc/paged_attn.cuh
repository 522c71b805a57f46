// Paged attention building blocks.
//
// attend_row: one query row of attention over a paged KV pool, for one
// warp; the f32 bodies of flash_prefill.cu (C * G rows: chunk offset x
// query head) and flash_verify.cu (W * G rows: window offset x query head)
// run it. gather_kv_tile: a tile of a slot's K/V gathered by position into
// shared memory with cp.async; flash_decode.cu and paged_tc.cuh's
// tensor-core body (flash_prefill.cu's and flash_verify.cu's bf16) stage
// their tiles with it.
//
// Layout (the JAX package's): k/v pools (NP, ps, KV, hd); a slot's page
// table row maps logical page p to physical page table[p]; physical page
// 0 is the trash page. A row at logical position qpos reads positions
// 0 .. min(qpos, n_live * ps - 1) and nothing else: pages past
// qpos // ps are never touched, and neither are the masked tail
// positions of the last live page, so garbage (even NaN) in the trash
// page or beyond qpos cannot reach the output. (The TPU kernel masks
// scores to -1e30 and multiplies by the zero probabilities, which would
// let a NaN through.)
//
// Each lane holds E = ceil(HD / 32) contiguous elements of q and of the
// f32 accumulator, the lanes past HD idle: HD / 32 at 64, 128 and 256
// (every lane busy), one element for HD < 32, and 4 at HD 112 (lanes
// 0-27 hold the row, 28-31 hold zeros, which add nothing to a dot and
// are never stored). Keys go
// KT at a time: KT independent dot products are loaded and reduced
// together (butterfly shuffles), then the online softmax (m, l, acc)
// takes the tile -- the TPU kernel's per-page update, at tile
// granularity. Softmax in f32 with expf, the -1e30 initial max
// and the max(l, 1e-30) denominator of the TPU kernel.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mma_sm80.cuh"

namespace repro_torch {

constexpr float kNegInf = -1e30f;

template <typename T, int N>
struct alignas(sizeof(T) * N) AVec {
  T v[N];
};

__device__ __forceinline__ float as_f32(float x) { return x; }
__device__ __forceinline__ float as_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T f32_as(float x);
template <>
__device__ __forceinline__ float f32_as<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 f32_as<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// E contiguous elements at p (aligned to min(E * sizeof(T), 16) bytes)
template <typename T, int E>
__device__ __forceinline__ void load_f32(const T* p, float* out) {
  constexpr int kBytes = E * static_cast<int>(sizeof(T));
  constexpr int kChunk = kBytes >= 16 ? 16 : kBytes;
  constexpr int kPer = kChunk / static_cast<int>(sizeof(T));
#pragma unroll
  for (int c = 0; c < E / kPer; ++c) {
    AVec<T, kPer> x = *reinterpret_cast<const AVec<T, kPer>*>(p + c * kPer);
#pragma unroll
    for (int i = 0; i < kPer; ++i) out[c * kPer + i] = as_f32(x.v[i]);
  }
}

template <typename T, int E>
__device__ __forceinline__ void store_from_f32(T* p, const float* in) {
  constexpr int kBytes = E * static_cast<int>(sizeof(T));
  constexpr int kChunk = kBytes >= 16 ? 16 : kBytes;
  constexpr int kPer = kChunk / static_cast<int>(sizeof(T));
#pragma unroll
  for (int c = 0; c < E / kPer; ++c) {
    AVec<T, kPer> x;
#pragma unroll
    for (int i = 0; i < kPer; ++i) x.v[i] = f32_as<T>(in[c * kPer + i]);
    *reinterpret_cast<AVec<T, kPer>*>(p + c * kPer) = x;
  }
}

// q_row / out_row: HD elements; table: the slot's n_live physical ids.
template <typename T, int HD>
__device__ void attend_row(const T* __restrict__ q_row,
                           const T* __restrict__ k_pool,
                           const T* __restrict__ v_pool,
                           const int32_t* __restrict__ table, int n_live,
                           int ps, int kvh, int kv, int qpos, float scale,
                           T* __restrict__ out_row) {
  constexpr int E = (HD + 31) / 32;
  static_assert(HD % E == 0, "a lane's elements end at the row's end");
  constexpr int KT = 8;
  const int lane = threadIdx.x & 31;
  const bool active = lane * E < HD;   // uniform at HD 32, 64, 128, 256
  float q[E], acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) q[e] = acc[e] = 0.0f;
  if (active) load_f32<T, E>(q_row + lane * E, q);
#pragma unroll
  for (int e = 0; e < E; ++e) q[e] = __fmul_rn(q[e], scale);
  float m = kNegInf, l = 0.0f;
  const int64_t page_stride = static_cast<int64_t>(ps) * kvh * HD;
  const int last = min(qpos, n_live * ps - 1);  // last position read
  for (int page = 0; page * ps <= last; ++page) {
    const int64_t pbase =
        static_cast<int64_t>(table[page]) * page_stride + kv * HD + lane * E;
    const int t_end = min(ps, last - page * ps + 1);  // live keys here
    for (int t0 = 0; t0 < t_end; t0 += KT) {
      float s[KT];
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        s[j] = 0.0f;
        if (active && t0 + j < t_end) {
          float k[E];
          load_f32<T, E>(k_pool + pbase +
                             static_cast<int64_t>(t0 + j) * kvh * HD, k);
#pragma unroll
          for (int e = 0; e < E; ++e) s[j] = fmaf(q[e], k[e], s[j]);
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
        for (int j = 0; j < KT; ++j)
          s[j] += __shfl_xor_sync(0xffffffffu, s[j], off);
      }
      float m_new = m;
#pragma unroll
      for (int j = 0; j < KT; ++j)
        if (t0 + j < t_end) m_new = fmaxf(m_new, s[j]);
      const float alpha = expf(m - m_new);
      l *= alpha;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] *= alpha;
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        if (t0 + j < t_end) {
          const float p = expf(s[j] - m_new);
          l += p;
          if (active) {
            float v[E];
            load_f32<T, E>(v_pool + pbase +
                               static_cast<int64_t>(t0 + j) * kvh * HD, v);
#pragma unroll
            for (int e = 0; e < E; ++e) acc[e] = fmaf(p, v[e], acc[e]);
          }
        }
      }
      m = m_new;
    }
  }
  const float denom = fmaxf(l, 1e-30f);
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = acc[e] / denom;
  if (active) store_from_f32<T, E>(out_row + lane * E, acc);
}

// Positions t0 .. t0 + TILE - 1 of one (slot, KV head)'s K and V into
// shared rows ROW elements apart (kd, vd), by THREADS threads: position t
// is row t % ps of physical page tbl[t / ps] (the slot's page-table row,
// staged in shared memory from entry pg0 on: tbl[i] is logical page
// pg0 + i), kb / vb point at the KV head's first element of physical
// page 0, tok is the pool's position stride. Positions past `last` are
// zero-filled and never read. The offsets come first, then the copies:
// a cp.async is a barrier to the compiler, so a table read between two
// copies would wait for each.
template <typename T, int HD, int TILE, int ROW, int THREADS>
__device__ __forceinline__ void gather_kv_tile(T* kd, T* vd, const T* kb,
                                               const T* vb, const int* tbl,
                                               int t0, int last, int ps,
                                               int64_t tok, int pg0 = 0) {
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));   // a chunk
  constexpr int kChunks = HD / kPer;                       // a row
  constexpr int kN = (TILE * kChunks + THREADS - 1) / THREADS;
  int64_t off[kN];
  int bytes[kN];
#pragma unroll
  for (int n = 0; n < kN; ++n) {
    const int i = threadIdx.x + n * THREADS;
    const int t = t0 + i / kChunks;
    off[n] = 0;
    bytes[n] = i < TILE * kChunks && t <= last ? 16 : 0;
    if (bytes[n]) {
      const int pg = t / ps;
      off[n] = (static_cast<int64_t>(tbl[pg - pg0]) * ps + (t - pg * ps)) *
                   tok +
               (i % kChunks) * kPer;
    }
  }
#pragma unroll
  for (int n = 0; n < kN; ++n) {
    const int i = threadIdx.x + n * THREADS;
    if (i < TILE * kChunks) {
      const int at = (i / kChunks) * ROW + (i % kChunks) * kPer;
      sm80::cp_async16(kd + at, kb + off[n], bytes[n]);
      sm80::cp_async16(vd + at, vb + off[n], bytes[n]);
    }
  }
}

// the largest dynamic shared memory a block may opt in to on this device
// (a paged kernel's shared memory grows with its page-table row)
inline int smem_optin() {
  int dev = 0, bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  return bytes;
}

}  // namespace repro_torch
