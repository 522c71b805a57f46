// selective_scan: the forward of Mamba-1's selective scan, fused.
//
// Replaces no Pallas kernel: the JAX package runs the scan as a
// lax.scan over time (src/repro/models/mamba.py:71, _scan_ssm), which
// XLA compiles into one loop on the TPU; its plain form in the port
// (kernels/selective_scan.py, selective_scan_ref) is a Python loop over
// time with two (B, S, d_inner, d_state) f32 tensors, 4.3 GB each at
// B 2 x S 4096 x d_inner 8192, and two launches a step. This kernel is
// the forward only: MeZO never backpropagates through the scan.
//
// For each batch row b, channel d and time t, with N = d_state:
//
//   delta = softplus(dt[b, t, d] + dt_bias[d])
//   h[n]  = exp(delta * A[d, n]) * h[n] + (delta * x[b, t, d]) * B[b, t, n]
//   y     = (sum_n C[b, t, n] * h[n] + D[d] * x[b, t, d]) * silu(z[b, t, d])
//
// with A = -exp(A_log), h in f32 from h0 (or zeros), y written in x's
// dtype and the last h written to h_last. Nothing of the size
// (B, S, d_inner, d_state) exists: the decay and the input of a step
// are formed in registers and used at once.
//
// Bound on this card: B * S * d_inner * d_state exponentials (1.07e9 a
// Jamba layer at B 2 x S 4096), each with two FMAs beside it, take
// ~0.26 ms on the SFU alone (16 a clock an SM) and ~0.12 ms split with
// the FP32 pipe, as long as the 2-byte x, z and y take over HBM.
// The design:
//
// * One thread a (b, d) channel, its N states and N decay rates
//   (A * log2 e) in registers, one block of kThreads channels of one
//   batch row; grid (ceil(d_inner / kThreads), B). The time loop is
//   sequential in a thread; the channels fill the card (16384 threads
//   at Jamba's widths: one warp on each SM sub-partition).
// * exp is ex2.approx of a pre-scaled argument (one SFU op a state and
//   step); softplus keeps log1pf, once a step. A chunk forms every
//   step's delta and gate first (independent chains the compiler
//   overlaps), then runs the recurrence, whose only carried value is h,
//   in one branch-free block; the sum over the states runs in four
//   chains.
// * Time runs in chunks of kSteps. A thread's dt, x and z of the next
//   chunk are loaded into registers before the current chunk is
//   computed (coalesced across the block's channels), and the block
//   stages the next chunk's B and C rows (shared by every channel) into
//   the other half of a double-buffered shared array: one
//   __syncthreads a chunk. A chunk's compute (~8 x 160 cycles) covers
//   the loads' latency.
// * The ragged channel edge is masked (a thread past d_inner still
//   stages B and C); the ragged time edge is a uniform branch.
//
// At the Jamba cell's shape this takes ~1.56 ms, ~8 % of that bound
// (PERF.md section 6): 2 threads a channel (the states split, the sum
// by one shuffle) took as long, 4 twice as long.
//
// dt, dt_bias, A_log, B, C, D, h0 and h_last are f32; x, z and y share
// one dtype, f32 or bf16. x and z may have a row stride (z is a view of
// in_proj's output); every other tensor is contiguous. The leaves
// dt_bias, A_log and D are per lane: batch row b reads lane
// b / lane_rows's (lane_rows = batch: one set shared by every row; the
// user-axis forward's lanes each hold lane_rows rows).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {
namespace scan {

constexpr int kThreads = 128;
constexpr int kSteps = 8;
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  const void* x;
  const float* dt;
  const float* dt_bias;
  const float* a_log;
  const float* bmat;
  const float* cmat;
  const float* dvec;
  const void* z;
  const float* h0;
  void* y;
  float* h_last;
  int seq;
  int dim;
  int lane_rows;
  int64_t x_stride;
  int64_t z_stride;
};

__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T, int N>
struct Chunk {
  static constexpr int kShare = (kSteps * 2 * N + kThreads - 1) / kThreads;
  float x[kSteps], z[kSteps], dt[kSteps];
  float bc[kShare];        // this thread's share of the chunk's B, C rows
};

template <typename T, int N>
__device__ __forceinline__ void load_chunk(Chunk<T, N>& c, const Args& a,
                                           const T* xr, const T* zr,
                                           const float* dtr,
                                           const float* br, const float* cr,
                                           int t0, bool live) {
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const int t = t0 + s;
    const bool ok = live && t < a.seq;
    c.x[s] = ok ? load_f32(xr + t * a.x_stride) : 0.f;
    c.z[s] = ok ? load_f32(zr + t * a.z_stride) : 0.f;
    c.dt[s] = ok ? dtr[static_cast<int64_t>(t) * a.dim] : 0.f;
  }
#pragma unroll
  for (int j = 0; j < Chunk<T, N>::kShare; ++j) {
    const int i = threadIdx.x + j * kThreads;     // (step, B or C, n)
    const int s = i / (2 * N), k = i % (2 * N);
    const int t = t0 + s;
    float v = 0.f;
    if (s < kSteps && t < a.seq) {
      v = k < N ? br[t * N + k] : cr[t * N + k - N];
    }
    c.bc[j] = v;
  }
}

template <typename T, int N>
__device__ __forceinline__ void stage(float (*bc)[2 * N],
                                      const Chunk<T, N>& c) {
#pragma unroll
  for (int j = 0; j < Chunk<T, N>::kShare; ++j) {
    const int i = threadIdx.x + j * kThreads;
    if (i < kSteps * 2 * N) bc[i / (2 * N)][i % (2 * N)] = c.bc[j];
  }
}

__device__ __forceinline__ float softplus(float v) {
  return fmaxf(v, 0.f) + log1pf(__expf(-fabsf(v)));
}

__device__ __forceinline__ float silu(float z) {
  return __fdividef(z, 1.f + __expf(-z));
}

// kLen steps of one channel (kLen < kSteps only at the ragged end):
// every step's delta and gate first (independent chains), then the
// recurrence; the state advances in place, y[s] is written.
template <int N, int kLen>
__device__ __forceinline__ void chunk_steps(float (&h)[N],
                                            const float (&ak)[N],
                                            const float (*bc)[2 * N],
                                            const float (&x)[kSteps],
                                            const float (&z)[kSteps],
                                            const float (&dt)[kSteps],
                                            float bias, float dd,
                                            float (&y)[kSteps]) {
  float delta[kLen], gate[kLen];
#pragma unroll
  for (int s = 0; s < kLen; ++s) {
    delta[s] = softplus(dt[s] + bias);
    gate[s] = silu(z[s]);
  }
#pragma unroll
  for (int s = 0; s < kLen; ++s) {
    const float dx = delta[s] * x[s];
    const float* bt = bc[s];
    float acc[4] = {0.f, 0.f, 0.f, 0.f};    // four short chains, not one
#pragma unroll
    for (int n = 0; n < N; ++n) {
      h[n] = fmaf(ex2(delta[s] * ak[n]), h[n], dx * bt[n]);
      acc[n % 4] = fmaf(bt[N + n], h[n], acc[n % 4]);
    }
    y[s] = fmaf(x[s], dd, (acc[0] + acc[1]) + (acc[2] + acc[3])) * gate[s];
  }
}

template <int N, int kLen = kSteps>
__device__ __forceinline__ void ragged_steps(int len, float (&h)[N],
                                             const float (&ak)[N],
                                             const float (*bc)[2 * N],
                                             const float (&x)[kSteps],
                                             const float (&z)[kSteps],
                                             const float (&dt)[kSteps],
                                             float bias, float dd,
                                             float (&y)[kSteps]) {
  if constexpr (kLen > 1) {
    if (len < kLen) {
      ragged_steps<N, kLen - 1>(len, h, ak, bc, x, z, dt, bias, dd, y);
      return;
    }
  }
  chunk_steps<N, kLen>(h, ak, bc, x, z, dt, bias, dd, y);
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
    selective_scan_kernel(const Args a) {
  __shared__ float bc[2][kSteps][2 * N];
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  const bool live = d < a.dim;
  const int dc = live ? d : 0;
  const int64_t row0 = static_cast<int64_t>(b) * a.seq;
  const int64_t hrow = (static_cast<int64_t>(b) * a.dim + dc) * N;
  const int64_t leaf = static_cast<int64_t>(b / a.lane_rows) * a.dim + dc;

  float ak[N], h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    ak[n] = -expf(a.a_log[leaf * N + n]) * kLog2e;
    h[n] = a.h0 ? a.h0[hrow + n] : 0.f;
  }
  const float bias = a.dt_bias[leaf];
  const float dd = a.dvec[leaf];
  const T* xr = static_cast<const T*>(a.x) + row0 * a.x_stride + dc;
  const T* zr = static_cast<const T*>(a.z) + row0 * a.z_stride + dc;
  const float* dtr = a.dt + row0 * a.dim + dc;
  const float* br = a.bmat + row0 * N;
  const float* cr = a.cmat + row0 * N;
  T* yr = static_cast<T*>(a.y) + row0 * a.dim + dc;

  Chunk<T, N> cur, nxt;
  load_chunk(cur, a, xr, zr, dtr, br, cr, 0, live);
  stage<T, N>(bc[0], cur);
  __syncthreads();
  int buf = 0;
  for (int t0 = 0; t0 < a.seq; t0 += kSteps) {
    const bool more = t0 + kSteps < a.seq;       // uniform in the block
    if (more) load_chunk(nxt, a, xr, zr, dtr, br, cr, t0 + kSteps, live);
    float y[kSteps];
    if (t0 + kSteps <= a.seq) {                  // a whole chunk
      chunk_steps<N, kSteps>(h, ak, bc[buf], cur.x, cur.z, cur.dt, bias, dd,
                             y);
    } else {
      ragged_steps<N>(a.seq - t0, h, ak, bc[buf], cur.x, cur.z, cur.dt,
                      bias, dd, y);
    }
    if (live) {
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
        if (t0 + s < a.seq) store(yr + static_cast<int64_t>(t0 + s) * a.dim,
                                  y[s]);
      }
    }
    if (more) {
      stage<T, N>(bc[buf ^ 1], nxt);
      cur = nxt;
    }
    __syncthreads();
    buf ^= 1;
  }
  if (a.h_last && live) {
#pragma unroll
    for (int n = 0; n < N; ++n) a.h_last[hrow + n] = h[n];
  }
}

template <typename T>
cudaError_t dispatch(const Args& a, int batch, int n_state,
                     cudaStream_t stream) {
  const dim3 grid((a.dim + kThreads - 1) / kThreads, batch);
  switch (n_state) {
    case 4:
      selective_scan_kernel<T, 4><<<grid, kThreads, 0, stream>>>(a);
      break;
    case 8:
      selective_scan_kernel<T, 8><<<grid, kThreads, 0, stream>>>(a);
      break;
    case 16:
      selective_scan_kernel<T, 16><<<grid, kThreads, 0, stream>>>(a);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace scan
}  // namespace repro_torch

// dtype 0: f32 x, z, y; 1: bf16. h0 and h_last may be null. lane_rows
// divides batch (Args).
extern "C" int repro_selective_scan(const void* x, const float* dt,
                                    const float* dt_bias, const float* a_log,
                                    const float* bmat, const float* cmat,
                                    const float* dvec, const void* z,
                                    const float* h0, void* y, float* h_last,
                                    int dtype, int batch, int seq, int dim,
                                    int n_state, int lane_rows,
                                    int64_t x_stride,
                                    int64_t z_stride, void* stream) {
  using namespace repro_torch::scan;
  if (batch <= 0 || batch > 65535 || seq <= 0 || dim <= 0 ||
      lane_rows <= 0 || batch % lane_rows != 0 ||
      (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{x,  dt,     dt_bias, a_log, bmat,      cmat,     dvec,
               z,  h0,     y,       h_last, seq,       dim,      lane_rows,
               x_stride,   z_stride};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      dtype == 0 ? dispatch<float>(a, batch, n_state, s)
                 : dispatch<__nv_bfloat16>(a, batch, n_state, s));
}
