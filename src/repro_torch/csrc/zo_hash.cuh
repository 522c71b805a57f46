// Counter-based hash RNG on the device: the CUDA twin of
// repro_torch/core/rng.py (and of the JAX package's core/rng.py and the
// Pallas helper _tile_z in kernels/zo_perturb.py).
//
// z for element (i0, i1, ...) of a leaf is a pure function of the leaf's
// pre-hashed base avalanche(seed ^ salt) and its coordinates, folded
// outermost-first: h = avalanche(h ^ i_d * P[prime_offset + d]).
// Native uint32 arithmetic wraps exactly as the reference's does.
//
// Every float step of the Gaussian form is an explicit round-to-nearest
// intrinsic, so nvcc cannot contract it into an FMA; logf/cosf/sqrtf are
// the precise library functions (no --use_fast_math), which still differ
// from XLA's and torch's in the last ulps -- hence a tolerance for
// Gaussian z, and bit-exactness for Rademacher z.
#pragma once

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace repro_torch {

constexpr int kMaxRank = 8;
constexpr uint32_t kGaussSalt = 0x68E31DA4u;

// The user-batched kernels' per-lane scalars: lane i of the grid uses the
// pre-hashed base base[i] and the coefficient coeff[i]; zo_add_users
// reads and writes lane idx[i] of its stacked leaf; zo_matmul's (row0,
// col0) is the W tile's global origin (a shard of a larger W hashes its
// coordinates there; zero in a user launch). The TPU kernels keep
// their (U,) seed and coefficient vectors in SMEM; here they travel by
// value in the kernel's parameter space (a constant bank every thread
// reads), so a launch needs no host-to-device copy and no sync.
constexpr int kMaxLanes = 64;
struct Lanes {
  uint32_t base[kMaxLanes];
  float coeff[kMaxLanes];
  int idx[kMaxLanes];
  uint32_t row0, col0;
};

__host__ __device__ __forceinline__ uint32_t dim_prime(int d) {
  switch (d) {
    case 0: return 0x9E3779B1u;
    case 1: return 0x85EBCA77u;
    case 2: return 0xC2B2AE3Du;
    case 3: return 0x27D4EB2Fu;
    case 4: return 0x165667B1u;
    case 5: return 0xD3A2646Du;
    case 6: return 0xFD7046C5u;
    default: return 0xB55A4F09u;
  }
}

__host__ __device__ __forceinline__ uint32_t avalanche(uint32_t x) {
  x ^= x >> 15;
  x *= 0x2C1B3C6Du;
  x ^= x >> 12;
  x *= 0x297A2D39u;
  x ^= x >> 15;
  return x;
}

// one fold of coordinate `idx` along the dimension whose prime is P[d]
__host__ __device__ __forceinline__ uint32_t fold(uint32_t h, uint32_t idx,
                                                  int d) {
  return avalanche(h ^ (idx * dim_prime(d)));
}

// SMs of the current device (queried once a device): the launchers of
// zo_add.cu and zo_matmul.cu size their grids or tiles by it
inline int sm_count() {
  static std::atomic<int> cached[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  int n = cached[dev].load(std::memory_order_relaxed);
  if (n == 0) {
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
        cudaSuccess)
      return 0;
    cached[dev].store(n, std::memory_order_relaxed);
  }
  return n;
}

// dist 0: Rademacher (+-1 from the top bit); dist 1: Box-Muller Gaussian
__device__ __forceinline__ float z_from_bits(uint32_t h, int dist) {
  if (dist == 0) return (h >> 31) ? -1.0f : 1.0f;
  uint32_t h2 = avalanche(h ^ kGaussSalt);
  // uniforms in (0, 1]: top 24 bits, plus 1 ulp to avoid log(0)
  float u1 = __fmul_rn(__fadd_rn(static_cast<float>(h >> 8), 1.0f),
                       1.0f / 16777216.0f);
  float u2 = __fmul_rn(static_cast<float>(h2 >> 8), 1.0f / 16777216.0f);
  float r = sqrtf(__fmul_rn(-2.0f, logf(u1)));
  float theta = __fmul_rn(6.283185307179586f, u2);
  return __fmul_rn(r, cosf(theta));
}

}  // namespace repro_torch
