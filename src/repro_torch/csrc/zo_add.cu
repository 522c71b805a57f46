// zo_add: out = W + coeff * z(seed, salt) over a leaf of rank 0..8.
//
// Replaces the Pallas kernel _zo_add_kernel (src/repro/kernels/
// zo_perturb.py:90, launched by zo_add at :129): the seed-replay sweep
// that materializes a user's adapter (base + every logged update), and
// the update sweep of every training step.
//
// zo_add_q: out = q * s + coeff * z(seed, salt) in f32 for an int8 leaf
// of rank 2..8 with per-column scales s of shape shape[:-2] + (N,).
// Replaces _zo_add_q_kernel (zo_perturb.py:99, launched by zo_add(scale=)
// at :144): the perturbed (or, at c = 0, dequantized) effective weight of
// a frozen int8 leaf. The value is __fadd_rn(__fmul_rn(float(q), s),
// __fmul_rn(c, z)): with power-of-two scales q * s is exact, so the bits
// are the plain version's.
//
// zo_add_users: out[l] = W[l] + coeff[i] * z(seed[i]) for the lanes
// l = idx[i] of a user-stacked leaf W (U, *leaf_shape), one launch for
// every lane (the multi-tenant step's updates, and the per-lane W' of an
// int8 leaf with stacked deltas). Replaces _zo_add_users_kernel
// (zo_perturb.py:165, launched by zo_add_users at :194). The lane is
// blockIdx.y and each lane runs zo_add's stream on its own leaf with its
// own (base, coeff), so every lane's bits are a lone zo_add launch's. A
// lane may start anywhere (a layer slice of a stacked leaf has a lane
// stride of L * leaf size; offsets are int64): the 16-byte path is taken
// only when every lane's start is aligned.
//
// Bound on this card: bytes. Each element is read once and written once:
// 4 bytes an element for bf16 zo_add, 8 for f32, 5 for zo_add_q. Hashing
// an element is one fold (~10 integer instructions, zo_hash.cuh), under
// the bytes at the integer pipe's rate only if little else is paid an
// element or a vector: an int64 division is a software routine of dozens
// of instructions. The design:
//
// * A persistent grid-stride stream: kBlocksPerSm blocks of kThreads an
//   SM (the launcher sizes the grid to the card), each thread taking
//   16-byte vectors gridDim.x * kThreads apart, loaded with ld.global.cs
//   and stored with st.global.cs (every byte is touched once). zo_add_q
//   keeps kQUnroll vectors in flight a thread before it hashes any: its
//   4-byte loads feed 16-byte stores.
// * No division on the per-vector path. A thread's position is an
//   odometer over the leaf's coordinates, set once from its first element
//   (int64 division, once a thread) and advanced by the grid stride,
//   whose digits in the leaf's mixed radix the launcher computes
//   (plan): one add and one conditional subtract a coordinate. The
//   row's hash folds the outer coordinates (one avalanche each); the
//   last coordinate is folded per element.
// * zo_add_q takes 4 int8 elements a vector, so that its 16-byte f32
//   stores are contiguous across a warp (16 elements a thread would put
//   a warp's stores 64 bytes apart from lane to lane).
// * Rademacher z applies as the sign of c: c with its sign bit XORed by the
//   hash's top bit, bit-identical to __fmul_rn(c, +-1). Gaussian z keeps
//   z_from_bits.
// * A vector never crosses a row: the 16-byte path runs only when the
//   vector divides the last dimension (and the start is aligned); any
//   other leaf takes the one-element instantiation of the same stream.
//
// W + c*z is computed in f32 with explicit round-to-nearest intrinsics (no
// FMA contraction), then rounded to the leaf's dtype with
// __float2bfloat16_rn -- the plain version's arithmetic exactly.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <type_traits>

#include "zo_hash.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 256;     // a block
constexpr int kBlocksPerSm = 4;   // resident blocks an SM (the grid's cap)
constexpr int kQUnroll = 4;       // zo_add_q's vectors in flight (Rademacher)
constexpr int kOuter = kMaxRank - 1;  // outer coordinates (all but the last)

struct Shape {
  int64_t dim[kMaxRank];
  int nd;
  // the grid stride (gridDim.x * kThreads * VEC elements) as digits of
  // the leaf's mixed radix: step[nd - 1] the last coordinate's (reduced),
  // step[0] the outermost (not reduced)
  uint32_t step[kMaxRank];
  uint32_t prime[kMaxRank];       // dim_prime(prime_offset + d)
  // the leaf's global offset in each dimension: a shard of a larger leaf
  // hashes the coordinates it has there (zero for a whole leaf)
  uint32_t off[kMaxRank];
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

// vectors stream through the cache (each byte is touched once)
template <typename V>
__device__ __forceinline__ V load_stream(const V* p) {
  if constexpr (sizeof(V) == 16) {
    union { uint4 u; V v; } r;
    r.u = __ldcs(reinterpret_cast<const uint4*>(p));
    return r.v;
  } else if constexpr (sizeof(V) == 4) {
    union { unsigned u; V v; } r;
    r.u = __ldcs(reinterpret_cast<const unsigned*>(p));
    return r.v;
  } else {
    return *p;
  }
}
template <typename V>
__device__ __forceinline__ void store_stream(V* p, const V& x) {
  if constexpr (sizeof(V) == 16) {
    union { uint4 u; V v; } r;
    r.v = x;
    __stcs(reinterpret_cast<uint4*>(p), r.u);
  } else {
    *p = x;
  }
}

// c * z for the hash h of an element: Rademacher z as c's sign
template <int DIST>
__device__ __forceinline__ float c_times_z(uint32_t h, float coeff) {
  if constexpr (DIST == 0) {
    return __uint_as_float(__float_as_uint(coeff) ^ (h & 0x80000000u));
  } else {
    return __fmul_rn(coeff, z_from_bits(h, 1));
  }
}

// A thread's position: the last coordinate and the outer ones (c[d] for
// d <= nd - 2). Fixed indices only (loops unrolled, runtime guards), so
// it lives in registers.
struct Odometer {
  uint32_t col;
  uint32_t c[kOuter];
};

// the odometer at element e (int64 division: once a thread)
__device__ __forceinline__ Odometer odometer_at(int64_t e, const Shape& s) {
  Odometer o;
  const int64_t last = s.dim[s.nd - 1];
  int64_t row = e / last;
  o.col = static_cast<uint32_t>(e - row * last);
#pragma unroll
  for (int d = kOuter - 1; d >= 1; --d) {
    o.c[d] = 0;
    if (d <= s.nd - 2) {
      const int64_t up = row / s.dim[d];
      o.c[d] = static_cast<uint32_t>(row - up * s.dim[d]);
      row = up;
    }
  }
  o.c[0] = static_cast<uint32_t>(row);
  return o;
}

// advance by the grid stride: each digit adds with the carry and wraps
// at most once (every digit but the outermost is below its dimension)
__device__ __forceinline__ void odometer_step(Odometer& o, const Shape& s,
                                              uint32_t last,
                                              uint32_t step_col) {
  const uint32_t col = o.col + step_col;
  uint32_t carry = col >= last;
  o.col = carry ? col - last : col;
#pragma unroll
  for (int d = kOuter - 1; d >= 1; --d) {
    if (d <= s.nd - 2) {
      const uint32_t x = o.c[d] + s.step[d] + carry;
      const uint32_t n = static_cast<uint32_t>(s.dim[d]);
      carry = x >= n;
      o.c[d] = carry ? x - n : x;
    }
  }
  if (s.nd >= 2) o.c[0] += s.step[0] + carry;
}

// the hash of the odometer's row: its outer coordinates (global: plus
// the shard's offsets) folded in order
__device__ __forceinline__ uint32_t odometer_hash(const Odometer& o,
                                                  const Shape& s,
                                                  uint32_t base) {
  uint32_t h = base;
#pragma unroll
  for (int d = 0; d < kOuter; ++d)
    if (d <= s.nd - 2) h = avalanche(h ^ ((o.c[d] + s.off[d]) * s.prime[d]));
  return h;
}

// the flat index of the odometer's (K, N) matrix: its coordinates but the
// last two (zo_add_q's scale row)
__device__ __forceinline__ int64_t odometer_lead(const Odometer& o,
                                                 const Shape& s) {
  int64_t lead = 0;
#pragma unroll
  for (int d = 0; d < kOuter - 1; ++d)
    if (d <= s.nd - 3) lead = lead * s.dim[d] + o.c[d];
  return lead;
}

// VEC elements inside one row, from (global) column col of the row
// hashed h_row
template <typename T, int VEC, int DIST>
__device__ __forceinline__ void perturb_in_row(Vec<T, VEC>& x, uint32_t h_row,
                                               uint32_t col, uint32_t p_last,
                                               float coeff) {
  uint32_t cp = col * p_last;
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const float cz = c_times_z<DIST>(avalanche(h_row ^ cp), coeff);
    x.v[i] = from_f32<T>(__fadd_rn(to_f32(x.v[i]), cz));
    cp += p_last;
  }
}

// the whole leaf of n elements, by the grid's blockIdx.x / gridDim.x
template <typename T, int VEC, int DIST>
__device__ __forceinline__ void zo_add_stream(const T* __restrict__ w,
                                              T* __restrict__ out, int64_t n,
                                              const Shape& s, uint32_t base,
                                              int prime_offset, float coeff) {
  using V = Vec<T, VEC>;
  if (s.nd == 0) {  // a scalar leaf: one extra avalanche unless a slice
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      const uint32_t h = prime_offset == 0 ? avalanche(base) : base;
      out[0] =
          from_f32<T>(__fadd_rn(to_f32(w[0]), c_times_z<DIST>(h, coeff)));
    }
    return;
  }
  const int64_t nv = n / VEC;   // VEC divides the last dimension
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const uint32_t last = static_cast<uint32_t>(s.dim[s.nd - 1]);
  const uint32_t p_last = s.prime[s.nd - 1];
  const uint32_t step_col = s.step[s.nd - 1];
  const uint32_t off_col = s.off[s.nd - 1];
  int64_t v = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  Odometer o = odometer_at(v * VEC, s);
  const V* wv = reinterpret_cast<const V*>(w);
  V* ov = reinterpret_cast<V*>(out);
  for (; v < nv; v += stride) {
    V x = load_stream(wv + v);
    perturb_in_row<T, VEC, DIST>(x, odometer_hash(o, s, base),
                                 o.col + off_col, p_last, coeff);
    store_stream(ov + v, x);
    odometer_step(o, s, last, step_col);
  }
}

template <typename T, int VEC, int DIST>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    zo_add_kernel(const T* __restrict__ w, T* __restrict__ out, int64_t n,
                  Shape s, uint32_t base, int prime_offset, float coeff) {
  zo_add_stream<T, VEC, DIST>(w, out, n, s, base, prime_offset, coeff);
}

// grid lane blockIdx.y: lane idx[y] of w and out, with lane y's scalars
template <typename T, int VEC, int DIST>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    zo_add_users_kernel(const T* __restrict__ w, T* __restrict__ out,
                        int64_t n, int64_t w_stride, int64_t out_stride,
                        Shape s, Lanes lanes, int prime_offset) {
  const int y = blockIdx.y;
  const int64_t lane = lanes.idx[y];
  zo_add_stream<T, VEC, DIST>(w + lane * w_stride, out + lane * out_stride,
                              n, s, lanes.base[y], prime_offset,
                              lanes.coeff[y]);
}

// q * s + c * z, VEC int8 elements a vector (4: one 4-byte load, their
// four scales as one 16-byte load, one 16-byte store, so that a warp's
// every store is one contiguous 512 bytes; scale_vec: the scale pointer
// is 16-byte aligned)
template <int VEC, int DIST>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    zo_add_q_kernel(const int8_t* __restrict__ q,
                    const float* __restrict__ scale, float* __restrict__ out,
                    int64_t n, Shape s, uint32_t base, float coeff,
                    int scale_vec) {
  using V = Vec<int8_t, VEC>;
  const int64_t nv = n / VEC;   // VEC divides the last dimension
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const uint32_t last = static_cast<uint32_t>(s.dim[s.nd - 1]);
  const uint32_t p_last = s.prime[s.nd - 1];
  const uint32_t step_col = s.step[s.nd - 1];
  int64_t v = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  Odometer o = odometer_at(v * VEC, s);
  const V* qv = reinterpret_cast<const V*>(q);
  // Gaussian z is bound by its instructions: one vector, fewer registers
  constexpr int kUnroll = DIST == 0 ? kQUnroll : 1;
  for (; v < nv; v += kUnroll * stride) {
    V x[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j)
      if (v + j * stride < nv) x[j] = load_stream(qv + v + j * stride);
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int64_t vj = v + j * stride;
      if (vj < nv) {
        const float* sp = scale + odometer_lead(o, s) * last + o.col;
        float sc[VEC], r[VEC];
        if constexpr (VEC == 4) {
          if (scale_vec) {
            const float4 f = __ldg(reinterpret_cast<const float4*>(sp));
            sc[0] = f.x;
            sc[1] = f.y;
            sc[2] = f.z;
            sc[3] = f.w;
          } else {
#pragma unroll
            for (int i = 0; i < VEC; ++i) sc[i] = __ldg(sp + i);
          }
        } else {
          sc[0] = __ldg(sp);
        }
        const uint32_t h_row = odometer_hash(o, s, base);
        uint32_t cp = o.col * p_last;
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          r[i] = __fadd_rn(__fmul_rn(static_cast<float>(x[j].v[i]), sc[i]),
                           c_times_z<DIST>(avalanche(h_row ^ cp), coeff));
          cp += p_last;
        }
        float* op = out + vj * VEC;
        if constexpr (VEC == 4)
          __stcs(reinterpret_cast<float4*>(op),
                 make_float4(r[0], r[1], r[2], r[3]));
        else
          op[0] = r[0];
      }
      odometer_step(o, s, last, step_col);
    }
  }
}

// A launch's plan over a leaf of n elements, vec a vector, on `lanes`
// lanes: the grid (one thread a vector, capped at the blocks the card
// keeps resident, shared by the lanes) and the Shape: dims, primes and
// the grid stride's digits (step[nd - 1] = stride % last, step[nd - 2..1]
// reduced by their dimension, step[0] not). False for a leaf the kernels
// do not take: a dimension past 2^31 - 1, a rank past kMaxRank.
bool plan(Shape& s, int& blocks, const int64_t* shape, int nd,
          int prime_offset, int64_t n, int vec, int lanes) {
  if (nd < 0 || nd > kMaxRank || prime_offset < 0 ||
      nd + prime_offset > kMaxRank || lanes <= 0)
    return false;
  const int sms = sm_count();
  if (sms <= 0) return false;
  const int64_t want = (std::max<int64_t>(n / vec, 1) + kThreads - 1) /
                       kThreads;
  blocks = static_cast<int>(std::min<int64_t>(
      want, std::max(1, sms * kBlocksPerSm / lanes)));
  s = Shape{};
  s.nd = nd;
  for (int d = 0; d < nd; ++d) {
    if (shape[d] <= 0 || shape[d] >= (int64_t{1} << 31)) return false;
    s.dim[d] = shape[d];
    s.prime[d] = dim_prime(prime_offset + d);
  }
  if (nd == 0) return true;
  int64_t row = static_cast<int64_t>(blocks) * kThreads * vec;
  for (int d = nd - 1; d >= 1; --d) {
    s.step[d] = static_cast<uint32_t>(row % shape[d]);
    row /= shape[d];
  }
  s.step[0] = static_cast<uint32_t>(nd == 1 ? row % shape[0] : row);
  return nd == 1 || row < (int64_t{1} << 31);
}

// elements a vector: `full` (16 bytes of them) when the tensors are
// 16-byte aligned and `full` divides the last dimension (so no vector
// crosses a row), else one
int vector_of(int full, int aligned, const int64_t* shape, int nd) {
  return aligned && nd >= 1 && shape[nd - 1] % full == 0 ? full : 1;
}

// the (dtype, vectorized, dist) instantiation of a launch: `go(T, VEC,
// DIST)` with T a value of the element type
template <typename F>
void by_type(int dtype, int vectorized, int dist, F&& go) {
  using I0 = std::integral_constant<int, 0>;
  using I1 = std::integral_constant<int, 1>;
  auto with_dist = [&](auto t, auto vec) {
    if (dist == 0) go(t, vec, I0{});
    else go(t, vec, I1{});
  };
  if (dtype == 0) {
    if (vectorized) with_dist(float{}, std::integral_constant<int, 4>{});
    else with_dist(float{}, I1{});
  } else {
    const __nv_bfloat16 t{};
    if (vectorized) with_dist(t, std::integral_constant<int, 8>{});
    else with_dist(t, I1{});
  }
}

}  // namespace
}  // namespace repro_torch

// dtype: 0 float32, 1 bfloat16. aligned: both pointers are 16-byte
// aligned (then a vector is 16 bytes of elements where that divides the
// last dimension, else one element). offsets: nd global offsets of this
// leaf within a larger one (a shard: its z is that leaf's slice), or
// null for zeros. Returns cudaGetLastError() after the launch.
extern "C" int repro_zo_add(const void* w, void* out, int64_t n, int dtype,
                            const int64_t* shape, int nd,
                            const int64_t* offsets, uint32_t base,
                            int prime_offset, float coeff, int dist,
                            int aligned, void* stream) {
  using namespace repro_torch;
  const int vec = vector_of(dtype == 0 ? 4 : 8, aligned, shape, nd);
  Shape s;
  int blocks = 0;
  if (n <= 0 || (dtype != 0 && dtype != 1) || (dist != 0 && dist != 1) ||
      !plan(s, blocks, shape, nd, prime_offset, n, vec, 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (offsets != nullptr)
    for (int d = 0; d < nd; ++d) {
      if (offsets[d] < 0) return static_cast<int>(cudaErrorInvalidValue);
      s.off[d] = static_cast<uint32_t>(offsets[d]);
    }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  by_type(dtype, vec > 1, dist, [&](auto t, auto v, auto d) {
    using T = decltype(t);
    zo_add_kernel<T, decltype(v)::value, decltype(d)::value>
        <<<blocks, kThreads, 0, st>>>(static_cast<const T*>(w),
                                      static_cast<T*>(out), n, s, base,
                                      prime_offset, coeff);
  });
  return static_cast<int>(cudaGetLastError());
}

// q (int8, rank 2..8), scale (f32, shape[:-2] + (N,)), out (f32, q's
// shape). aligned: q and out are 16-byte aligned (then 4 elements a
// vector where 4 divides N). Returns cudaGetLastError() after the
// launch.
extern "C" int repro_zo_add_q(const void* q, const void* scale, void* out,
                              int64_t n, const int64_t* shape, int nd,
                              uint32_t base, int prime_offset, float coeff,
                              int dist, int aligned, void* stream) {
  using namespace repro_torch;
  const int vec = vector_of(4, aligned, shape, nd);
  Shape s;
  int blocks = 0;
  if (nd < 2 || n <= 0 || (dist != 0 && dist != 1) ||
      !plan(s, blocks, shape, nd, prime_offset, n, vec, 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int scale_vec = reinterpret_cast<uintptr_t>(scale) % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto go = [&](auto v, auto d) {
    zo_add_q_kernel<decltype(v)::value, decltype(d)::value>
        <<<blocks, kThreads, 0, st>>>(
            static_cast<const int8_t*>(q), static_cast<const float*>(scale),
            static_cast<float*>(out), n, s, base, coeff, scale_vec);
  };
  using I0 = std::integral_constant<int, 0>;
  using I1 = std::integral_constant<int, 1>;
  using I4 = std::integral_constant<int, 4>;
  if (vec > 1) {
    if (dist == 0) go(I4{}, I0{});
    else go(I4{}, I1{});
  } else {
    if (dist == 0) go(I1{}, I0{});
    else go(I1{}, I1{});
  }
  return static_cast<int>(cudaGetLastError());
}

// w, out: n_lanes' leaves of n elements each (dtype 0 float32,
// 1 bfloat16), lane l of w at w + l * w_stride and of out at
// out + l * out_stride (elements); grid lane i updates lane idx[i] with
// base[i] and coeff[i]. shape: one leaf's shape (rank 0..8).
// aligned: every lane's start is 16-byte aligned (vectors as in
// repro_zo_add). Returns cudaGetLastError() after the launch.
extern "C" int repro_zo_add_users(const void* w, void* out, int64_t n,
                                  int64_t w_stride, int64_t out_stride,
                                  int dtype, const int64_t* shape, int nd,
                                  const uint32_t* bases, const float* coeffs,
                                  const int* idx, int n_lanes,
                                  int prime_offset, int dist, int aligned,
                                  void* stream) {
  using namespace repro_torch;
  const int vec = vector_of(dtype == 0 ? 4 : 8, aligned, shape, nd);
  Shape s;
  int blocks = 0;
  if (n <= 0 || (dtype != 0 && dtype != 1) || n_lanes <= 0 ||
      n_lanes > kMaxLanes || (dist != 0 && dist != 1) ||
      !plan(s, blocks, shape, nd, prime_offset, n, vec, n_lanes)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Lanes lanes{};
  for (int i = 0; i < n_lanes; ++i) {
    lanes.base[i] = bases[i];
    lanes.coeff[i] = coeffs[i];
    lanes.idx[i] = idx[i];
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  by_type(dtype, vec > 1, dist, [&](auto t, auto v, auto d) {
    using T = decltype(t);
    zo_add_users_kernel<T, decltype(v)::value, decltype(d)::value>
        <<<dim3(blocks, n_lanes), kThreads, 0, st>>>(
            static_cast<const T*>(w), static_cast<T*>(out), n, w_stride,
            out_stride, s, lanes, prime_offset);
  });
  return static_cast<int>(cudaGetLastError());
}
