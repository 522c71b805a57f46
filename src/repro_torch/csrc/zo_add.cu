// zo_add: out = W + coeff * z(seed, salt) over a leaf of rank 0..8.
//
// Replaces the Pallas kernel _zo_add_kernel (src/repro/kernels/
// zo_perturb.py:90, launched by zo_add at :129): the seed-replay sweep
// that materializes a user's adapter (base + every logged update).
//
// Bound: memory. Each element is read once and written once (4 bytes an
// element in bf16), about 12 integer operations an element hash it. The
// design: one thread takes VEC contiguous elements with one 16-byte load
// and one 16-byte store; the hash of the outer coordinates (all but the
// last) is folded once per thread and only the last coordinate is folded
// per element. z never touches device memory. The TPU's (256, 256) tiles
// and the N % 128 alignment gate do not carry over: the kernel takes any
// shape and masks its own ragged tail.
//
// W + c*z is computed in f32 with explicit round-to-nearest intrinsics
// (no FMA contraction), then rounded to the leaf's dtype with
// __float2bfloat16_rn -- the plain version's arithmetic exactly.
//
// zo_add_q: out = q * s + coeff * z(seed, salt) in f32 for an int8 leaf
// of rank 2..8 with per-column scales s of shape shape[:-2] + (N,).
//
// Replaces the Pallas kernel _zo_add_q_kernel (src/repro/kernels/
// zo_perturb.py:99, launched by zo_add(scale=) at :144): the perturbed
// (or, at c = 0, dequantized) effective weight of a frozen int8 leaf.
//
// Bound: memory, 5 bytes an element (1 int8 read, 4 f32 written; the
// scales are N * 4 bytes a layer, read through L1). The design is
// zo_add's: VEC = 16 contiguous elements a thread, one 16-byte load of
// q and four 16-byte stores, the outer coordinates (64-bit divisions)
// hashed once a thread.
// The value is __fadd_rn(__fmul_rn(float(q), s), __fmul_rn(c, z)): with
// power-of-two scales q * s is exact, so the bits are the plain
// version's.
//
// zo_add_users: out[l] = W[l] + coeff[i] * z(seed[i]) for the lanes
// l = idx[i] of a user-stacked leaf W (U, *leaf_shape), one launch for
// every lane (the multi-tenant step's updates, and the per-lane W' of
// an int8 leaf with stacked deltas).
//
// Replaces the Pallas kernel _zo_add_users_kernel (src/repro/kernels/
// zo_perturb.py:165, launched by zo_add_users at :194). Bound: memory,
// as zo_add. The lane is the grid's outermost dimension (blockIdx.y) and
// each lane runs zo_add's body unchanged on its own leaf with its own
// (base, coeff), so every lane's bits are a lone zo_add launch's. A lane
// may start anywhere (a layer slice of a stacked leaf has a lane stride
// of L * leaf size): the 16-byte path is taken only when every lane's
// start is aligned.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "zo_hash.cuh"

namespace repro_torch {
namespace {

struct Shape {
  int64_t dim[kMaxRank];
  int nd;
};

template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// hash of the outer coordinates of row `row` (all dims but the last)
__device__ __forceinline__ uint32_t row_hash(uint32_t base, int64_t row,
                                             const Shape& s,
                                             int prime_offset) {
  uint32_t coord[kMaxRank];
  for (int d = s.nd - 2; d >= 0; --d) {
    int64_t n = s.dim[d];
    coord[d] = static_cast<uint32_t>(row % n);
    row /= n;
  }
  uint32_t h = base;
  for (int d = 0; d < s.nd - 1; ++d) h = fold(h, coord[d], prime_offset + d);
  return h;
}

// VEC contiguous elements of one leaf from element `start` on
template <typename T, int VEC>
__device__ __forceinline__ void zo_add_body(const T* __restrict__ w,
                                            T* __restrict__ out, int64_t n,
                                            const Shape& s, uint32_t base,
                                            int prime_offset, float coeff,
                                            int dist, int64_t start) {
  if (start >= n) return;
  if (s.nd == 0) {  // a scalar leaf: one extra avalanche unless a slice
    uint32_t h = prime_offset == 0 ? avalanche(base) : base;
    float z = z_from_bits(h, dist);
    out[0] = from_f32<T>(__fadd_rn(to_f32(w[0]), __fmul_rn(coeff, z)));
    return;
  }
  const int64_t last = s.dim[s.nd - 1];
  const int last_d = prime_offset + s.nd - 1;
  int64_t row = start / last;
  int64_t col = start - row * last;
  uint32_t h_row = row_hash(base, row, s, prime_offset);
  if (VEC > 1 && start + VEC <= n) {
    Vec<T, VEC> x = *reinterpret_cast<const Vec<T, VEC>*>(w + start);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      if (col == last) {  // the vector crosses into the next row
        ++row;
        col = 0;
        h_row = row_hash(base, row, s, prime_offset);
      }
      float z = z_from_bits(fold(h_row, static_cast<uint32_t>(col), last_d),
                            dist);
      x.v[i] = from_f32<T>(__fadd_rn(to_f32(x.v[i]), __fmul_rn(coeff, z)));
      ++col;
    }
    *reinterpret_cast<Vec<T, VEC>*>(out + start) = x;
    return;
  }
  for (int64_t i = start; i < n && i < start + VEC; ++i) {  // ragged tail
    if (col == last) {
      ++row;
      col = 0;
      h_row = row_hash(base, row, s, prime_offset);
    }
    float z = z_from_bits(fold(h_row, static_cast<uint32_t>(col), last_d),
                          dist);
    out[i] = from_f32<T>(__fadd_rn(to_f32(w[i]), __fmul_rn(coeff, z)));
    ++col;
  }
}

template <typename T, int VEC>
__global__ void zo_add_kernel(const T* __restrict__ w, T* __restrict__ out,
                              int64_t n, Shape s, uint32_t base,
                              int prime_offset, float coeff, int dist) {
  const int64_t start = (static_cast<int64_t>(blockIdx.x) * blockDim.x +
                         threadIdx.x) * VEC;
  zo_add_body<T, VEC>(w, out, n, s, base, prime_offset, coeff, dist, start);
}

// grid lane blockIdx.y: lane idx[y] of w and out, with lane y's scalars
template <typename T, int VEC>
__global__ void zo_add_users_kernel(const T* __restrict__ w,
                                    T* __restrict__ out, int64_t n,
                                    int64_t w_stride, int64_t out_stride,
                                    Shape s, Lanes lanes, int prime_offset,
                                    int dist) {
  const int y = blockIdx.y;
  const int64_t lane = lanes.idx[y];
  const int64_t start = (static_cast<int64_t>(blockIdx.x) * blockDim.x +
                         threadIdx.x) * VEC;
  zo_add_body<T, VEC>(w + lane * w_stride, out + lane * out_stride, n, s,
                      lanes.base[y], prime_offset, lanes.coeff[y], dist,
                      start);
}

// q * s + c * z for VEC contiguous int8 elements starting at `start`
template <int VEC>
__global__ void zo_add_q_kernel(const int8_t* __restrict__ q,
                                const float* __restrict__ scale,
                                float* __restrict__ out, int64_t n, Shape s,
                                uint32_t base, int prime_offset, float coeff,
                                int dist) {
  int64_t start = (static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x) * VEC;
  if (start >= n) return;
  const int64_t last = s.dim[s.nd - 1];      // N
  const int64_t rows_per_lead = s.dim[s.nd - 2];  // K
  const int last_d = prime_offset + s.nd - 1;
  int64_t row = start / last;
  int64_t col = start - row * last;
  uint32_t h_row = row_hash(base, row, s, prime_offset);
  const float* srow = scale + (row / rows_per_lead) * last;
  alignas(16) int8_t v[VEC];
  const bool full = start + VEC <= n;
  if constexpr (VEC == 16) {
    if (full) {
      *reinterpret_cast<int4*>(v) = *reinterpret_cast<const int4*>(q + start);
    }
  }
  if (VEC == 1 || !full) {
    for (int i = 0; i < VEC; ++i) v[i] = start + i < n ? q[start + i] : 0;
  }
  float r[VEC] = {};
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    if (start + i >= n) break;  // ragged tail: no read past the scales
    if (col == last) {  // the vector crosses into the next row
      ++row;
      col = 0;
      h_row = row_hash(base, row, s, prime_offset);
      srow = scale + (row / rows_per_lead) * last;
    }
    float z = z_from_bits(fold(h_row, static_cast<uint32_t>(col), last_d),
                          dist);
    r[i] = __fadd_rn(__fmul_rn(static_cast<float>(v[i]), srow[col]),
                     __fmul_rn(coeff, z));
    ++col;
  }
  if constexpr (VEC == 16) {
    if (full) {
#pragma unroll
      for (int i = 0; i < VEC; i += 4)
        *reinterpret_cast<float4*>(out + start + i) =
            make_float4(r[i], r[i + 1], r[i + 2], r[i + 3]);
      return;
    }
  }
  for (int i = 0; i < VEC; ++i)
    if (start + i < n) out[start + i] = r[i];
}

template <typename T, int VEC>
void launch(const void* w, void* out, int64_t n, const Shape& s,
            uint32_t base, int prime_offset, float coeff, int dist,
            cudaStream_t stream) {
  constexpr int kThreads = 256;
  int64_t threads_needed = (n + VEC - 1) / VEC;
  unsigned blocks =
      static_cast<unsigned>((threads_needed + kThreads - 1) / kThreads);
  zo_add_kernel<T, VEC><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(w), static_cast<T*>(out), n, s, base,
      prime_offset, coeff, dist);
}

template <typename T, int VEC>
void launch_users(const void* w, void* out, int64_t n, int64_t w_stride,
                  int64_t out_stride, const Shape& s, const Lanes& lanes,
                  int n_lanes, int prime_offset, int dist,
                  cudaStream_t stream) {
  constexpr int kThreads = 256;
  int64_t threads_needed = (n + VEC - 1) / VEC;
  dim3 grid(static_cast<unsigned>((threads_needed + kThreads - 1) /
                                  kThreads),
            static_cast<unsigned>(n_lanes));
  zo_add_users_kernel<T, VEC><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(w), static_cast<T*>(out), n, w_stride,
      out_stride, s, lanes, prime_offset, dist);
}

}  // namespace
}  // namespace repro_torch

// dtype: 0 float32, 1 bfloat16. vectorized: both pointers are 16-byte
// aligned. Returns cudaGetLastError() after the launch.
extern "C" int repro_zo_add(const void* w, void* out, int64_t n, int dtype,
                            const int64_t* shape, int nd, uint32_t base,
                            int prime_offset, float coeff, int dist,
                            int vectorized, void* stream) {
  using namespace repro_torch;
  if (nd < 0 || nd > kMaxRank || n <= 0 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Shape s{};
  s.nd = nd;
  for (int d = 0; d < nd; ++d) s.dim[d] = shape[d];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (vectorized)
      launch<float, 4>(w, out, n, s, base, prime_offset, coeff, dist, st);
    else
      launch<float, 1>(w, out, n, s, base, prime_offset, coeff, dist, st);
  } else {
    if (vectorized)
      launch<__nv_bfloat16, 8>(w, out, n, s, base, prime_offset, coeff,
                               dist, st);
    else
      launch<__nv_bfloat16, 1>(w, out, n, s, base, prime_offset, coeff,
                               dist, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// q (int8, rank 2..8), scale (f32, shape[:-2] + (N,)), out (f32, q's
// shape). vectorized: q and out are 16-byte aligned. Returns
// cudaGetLastError() after the launch.
extern "C" int repro_zo_add_q(const void* q, const void* scale, void* out,
                              int64_t n, const int64_t* shape, int nd,
                              uint32_t base, int prime_offset, float coeff,
                              int dist, int vectorized, void* stream) {
  using namespace repro_torch;
  if (nd < 2 || nd > kMaxRank || n <= 0 || (dist != 0 && dist != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Shape s{};
  s.nd = nd;
  for (int d = 0; d < nd; ++d) s.dim[d] = shape[d];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  constexpr int kThreads = 256;
  const int vec = vectorized ? 16 : 1;
  const int64_t threads_needed = (n + vec - 1) / vec;
  const unsigned blocks =
      static_cast<unsigned>((threads_needed + kThreads - 1) / kThreads);
  const int8_t* qp = static_cast<const int8_t*>(q);
  const float* sp = static_cast<const float*>(scale);
  float* op = static_cast<float*>(out);
  if (vectorized)
    zo_add_q_kernel<16><<<blocks, kThreads, 0, st>>>(
        qp, sp, op, n, s, base, prime_offset, coeff, dist);
  else
    zo_add_q_kernel<1><<<blocks, kThreads, 0, st>>>(
        qp, sp, op, n, s, base, prime_offset, coeff, dist);
  return static_cast<int>(cudaGetLastError());
}

// w, out: n_lanes' leaves of n elements each (dtype 0 float32,
// 1 bfloat16), lane l of w at w + l * w_stride and of out at
// out + l * out_stride (elements); grid lane i updates lane idx[i] with
// base[i] and coeff[i]. shape: one leaf's shape (rank 0..8).
// vectorized: every lane's start is 16-byte aligned. Returns
// cudaGetLastError() after the launch.
extern "C" int repro_zo_add_users(const void* w, void* out, int64_t n,
                                  int64_t w_stride, int64_t out_stride,
                                  int dtype, const int64_t* shape, int nd,
                                  const uint32_t* bases, const float* coeffs,
                                  const int* idx, int n_lanes,
                                  int prime_offset, int dist, int vectorized,
                                  void* stream) {
  using namespace repro_torch;
  if (nd < 0 || nd > kMaxRank || n <= 0 || (dtype != 0 && dtype != 1) ||
      n_lanes <= 0 || n_lanes > kMaxLanes || (dist != 0 && dist != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Shape s{};
  s.nd = nd;
  for (int d = 0; d < nd; ++d) s.dim[d] = shape[d];
  Lanes lanes{};
  for (int i = 0; i < n_lanes; ++i) {
    lanes.base[i] = bases[i];
    lanes.coeff[i] = coeffs[i];
    lanes.idx[i] = idx[i];
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (vectorized)
      launch_users<float, 4>(w, out, n, w_stride, out_stride, s, lanes,
                             n_lanes, prime_offset, dist, st);
    else
      launch_users<float, 1>(w, out, n, w_stride, out_stride, s, lanes,
                             n_lanes, prime_offset, dist, st);
  } else {
    if (vectorized)
      launch_users<__nv_bfloat16, 8>(w, out, n, w_stride, out_stride, s,
                                     lanes, n_lanes, prime_offset, dist, st);
    else
      launch_users<__nv_bfloat16, 1>(w, out, n, w_stride, out_stride, s,
                                     lanes, n_lanes, prime_offset, dist, st);
  }
  return static_cast<int>(cudaGetLastError());
}
