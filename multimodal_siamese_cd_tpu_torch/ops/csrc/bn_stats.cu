// Per-channel BatchNorm statistics, for Hopper (sm_90a).
//
// Replaces the TPU kernel tools/bench_bn_reduce.py `_kernel` (launched by
// `pallas_reduce`), which walks an NHWC activation row block by row block in
// a sequential grid and carries two (1, C) f32 sums in VMEM from one grid
// step to the next. Here the port's layout is NCHW and the blocks run in
// no order, so the reduction is split in two passes.
//
// Function: for a, b of shape (B, C, H, W), contiguous NCHW, both bf16 or
// both f32, and every channel c,
//   s1[c] = sum_{b,h,w} a[b,c,h,w]
//   s2[c] = sum_{b,h,w} a[b,c,h,w] * b[b,c,h,w]        (f32 accumulation)
// A training-mode BatchNorm calls it twice: forward with a = b = x (sum x,
// sum x^2), backward with (dy, x) (sum dy, sum dy*x).
//
// Bound: bytes. Each element is read once (once in all when a and b are the
// same tensor) for three floating-point operations, so the card's memory
// rate bounds it by more than an order of magnitude.
//
// Design:
//   * Grid (chunks, C). Block (k, c) reduces elements [k*chunk, (k+1)*chunk)
//     of channel c's B*H*W index space. Each (b, c) plane is a contiguous
//     run of H*W elements; an index j maps to plane j / (H*W). At the
//     deepest level of a full-width step a channel has only 2,048 elements,
//     at the stem 524,288: the chunking keeps every SM busy at both ends.
//   * 16-byte loads (8 bf16 or 4 f32 per thread and step) when H*W is a
//     multiple of the vector width and both pointers are 16-byte aligned;
//     a scalar path otherwise (odd H*W, ragged tails).
//   * a == b (the forward call) is detected on the host and each vector is
//     loaded once.
//   * Deterministic: no float atomics. Each thread sums its elements in a
//     fixed order, the block reduces with warp shuffles and shared memory in
//     a fixed order and writes its two partial sums to a workspace; a second
//     kernel (one warp per channel) sums the partials in a fixed order. Two
//     launches on the same inputs give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int kN = 4;
  using Raw = float4;
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  using Raw = uint4;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void unpack(const float4& r, float (&v)[4]) {
  v[0] = r.x;
  v[1] = r.y;
  v[2] = r.z;
  v[3] = r.w;
}

__device__ __forceinline__ void unpack(const uint4& r, float (&v)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
  return x;
}

// Partial sums of one (chunk, channel) tile into partial[(c * chunks + k) * 2 + {0, 1}].
template <typename T, bool kVector, bool kSame>
__global__ void __launch_bounds__(kThreads)
bn_stats_partial(const T* __restrict__ a, const T* __restrict__ b, int channels,
                 long long plane, long long per_channel, long long chunk,
                 float* __restrict__ partial) {
  __shared__ float s_part[2][kWarps];
  const int c = blockIdx.y;
  const long long lo = (long long)blockIdx.x * chunk;
  const long long hi = min(lo + chunk, per_channel);
  float s1 = 0.0f, s2 = 0.0f;

  if constexpr (kVector) {
    // plane % kN == 0, chunk % kN == 0, 16-byte aligned pointers
    constexpr int kN = Vec<T>::kN;
    using Raw = typename Vec<T>::Raw;
    const Raw* av = reinterpret_cast<const Raw*>(a);
    const Raw* bv = reinterpret_cast<const Raw*>(b);
    const long long plane_v = plane / kN;
#pragma unroll 4
    for (long long j = lo / kN + threadIdx.x; j < hi / kN; j += kThreads) {
      const long long bi = j / plane_v;
      const long long off = (bi * channels + c) * plane_v + (j - bi * plane_v);
      float x[kN];
      unpack(av[off], x);
      if constexpr (kSame) {
#pragma unroll
        for (int i = 0; i < kN; ++i) {
          s1 += x[i];
          s2 = fmaf(x[i], x[i], s2);
        }
      } else {
        float y[kN];
        unpack(bv[off], y);
#pragma unroll
        for (int i = 0; i < kN; ++i) {
          s1 += x[i];
          s2 = fmaf(x[i], y[i], s2);
        }
      }
    }
  } else {
    for (long long i = lo + threadIdx.x; i < hi; i += kThreads) {
      const long long bi = i / plane;
      const long long off = (bi * channels + c) * plane + (i - bi * plane);
      const float x = to_f32(a[off]);
      const float y = kSame ? x : to_f32(b[off]);
      s1 += x;
      s2 = fmaf(x, y, s2);
    }
  }

  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    s_part[0][warp] = s1;
    s_part[1][warp] = s2;
  }
  __syncthreads();
  if (threadIdx.x < 2) {
    float tot = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) tot += s_part[threadIdx.x][w];
    partial[((long long)c * gridDim.x + blockIdx.x) * 2 + threadIdx.x] = tot;
  }
}

// One warp per channel sums that channel's `chunks` partial pairs.
__global__ void __launch_bounds__(kThreads)
bn_stats_finalize(const float* __restrict__ partial, int chunks, int channels,
                  float* __restrict__ s1, float* __restrict__ s2) {
  const int c = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (c >= channels) return;  // uniform per warp
  const float* p = partial + (long long)c * chunks * 2;
  float t1 = 0.0f, t2 = 0.0f;
  for (int k = lane; k < chunks; k += 32) {
    t1 += p[2 * k];
    t2 += p[2 * k + 1];
  }
  t1 = warp_sum(t1);
  t2 = warp_sum(t2);
  if (lane == 0) {
    s1[c] = t1;
    s2[c] = t2;
  }
}

template <typename T>
int launch(const T* a, const T* b, long long batch, int channels, long long plane,
           long long chunk, int chunks, float* partial, float* s1, float* s2,
           cudaStream_t stream) {
  const long long per_channel = batch * plane;
  const dim3 grid(chunks, channels);
  const bool same = a == b;
  const bool vector = plane % Vec<T>::kN == 0 && chunk % Vec<T>::kN == 0 &&
                      reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(b) % 16 == 0;
  if (vector && same)
    bn_stats_partial<T, true, true><<<grid, kThreads, 0, stream>>>(
        a, b, channels, plane, per_channel, chunk, partial);
  else if (vector)
    bn_stats_partial<T, true, false><<<grid, kThreads, 0, stream>>>(
        a, b, channels, plane, per_channel, chunk, partial);
  else if (same)
    bn_stats_partial<T, false, true><<<grid, kThreads, 0, stream>>>(
        a, b, channels, plane, per_channel, chunk, partial);
  else
    bn_stats_partial<T, false, false><<<grid, kThreads, 0, stream>>>(
        a, b, channels, plane, per_channel, chunk, partial);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int warps_per_block = kThreads / 32;
  const int blocks = (channels + warps_per_block - 1) / warps_per_block;
  bn_stats_finalize<<<blocks, kThreads, 0, stream>>>(partial, chunks, channels, s1, s2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, loaded with ctypes. `a`, `b`: (batch, channels, plane)
// contiguous, dtype 0 = f32, 1 = bf16; `partial`: channels * chunks * 2 f32
// scratch; `s1`, `s2`: (channels,) f32 outputs (fully written). `chunk` is
// the number of elements of one channel a block reduces, a multiple of 8.
// Returns the cudaError_t of the launches (0 on success).
extern "C" int mscd_bn_stats(const void* a, const void* b, int dtype, long long batch,
                             int channels, long long plane, long long chunk, int chunks,
                             float* partial, float* s1, float* s2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch(static_cast<const float*>(a), static_cast<const float*>(b), batch,
                  channels, plane, chunk, chunks, partial, s1, s2, s);
  if (dtype == 1)
    return launch(static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b),
                  batch, channels, plane, chunk, chunks, partial, s1, s2, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
