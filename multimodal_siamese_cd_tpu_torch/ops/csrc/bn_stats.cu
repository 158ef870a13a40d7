// Per-channel BatchNorm statistics, for Hopper (sm_90a).
//
// Replaces the TPU kernel tools/bench_bn_reduce.py `_kernel` (launched by
// `pallas_reduce`), which walks an NHWC activation row block by row block in
// a sequential grid and carries two (1, C) f32 sums in VMEM from one grid
// step to the next. Here the blocks run in no order, so the reduction is
// split in two passes, and there are two designs, one per layout: the
// NCHW kernels below (`bn_stats_partial`, `bn_stats_finalize`) and the
// channels-last ones further down (`bn_stats_partial_nhwc`,
// `bn_stats_finalize_nhwc`), which the training step runs on the card.
//
// Function: for a, b of shape (B, C, H, W), both contiguous NCHW or both
// contiguous channels-last, both bf16 or both f32, and every channel c,
//   s1[c] = sum_{b,h,w} a[b,c,h,w]
//   s2[c] = sum_{b,h,w} a[b,c,h,w] * b[b,c,h,w]        (f32 accumulation)
// A training-mode BatchNorm calls it twice: forward with a = b = x (sum x,
// sum x^2), backward with (dy, x) (sum dy, sum dy*x).
//
// Bound: bytes. Each element is read once (once in all when a and b are the
// same tensor) for three floating-point operations, so the card's memory
// rate bounds it by more than an order of magnitude.
//
// Design of the NCHW kernels:
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

#include <algorithm>

#include "nhwc.cuh"

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

// ---- channels-last -----------------------------------------------------------
//
// Design (nhwc.cuh for the tiling): a and b are (M = B*H*W) x C row-major
// matrices. Block (k, g) reduces rows [k*chunk, (k+1)*chunk) of the
// channel octets of group g: each thread walks its rows kRows at a time
// (a == b: each octet loaded once) and keeps 8 s1 and 8 s2 float32 sums in
// registers; the block then adds its stack of row-threads, by shuffles
// within a warp and through shared memory across warps, each (octet, sum,
// channel) slot in a fixed order, and writes the (chunk, 2, C) partial
// sums. `bn_stats_finalize_nhwc` adds a channel's partials over the chunks
// in a fixed order. No float atomics: two launches on the same inputs give
// the same bits. The C entry plans the chunks (`plan_nhwc`): about
// kBlocksPerSm blocks an SM of the device in all (the stem's million rows
// at batch 16 in 528 chunks on 132 SMs), and at most one chunk for each
// kMinRows rows (the deepest level's 2,048-4,096 rows in 16-32 chunks of
// each of its 8 channel groups), so every SM has work at both ends and the
// partials stay a few percent of the bytes read. Bound: bytes, as the NCHW
// kernel.

constexpr int kRows = 4;   // rows a thread has in flight
constexpr int kBlocksPerSm = 4;
constexpr long long kMinRows = 128;
constexpr int kFinalThreads = 1024;
constexpr int kFinalWarps = kFinalThreads / 32;

template <typename T, bool kVector, bool kSame>
__global__ void __launch_bounds__(nhwc::kThreads)
bn_stats_partial_nhwc(const T* __restrict__ a, const T* __restrict__ b, long long rows,
                      int channels, long long chunk, float* __restrict__ partial) {
  using nhwc::kOct;
  __shared__ float s_red[2 * kOct][nhwc::kThreads];
  const int octets = blockDim.x, stack = blockDim.y;
  int t = threadIdx.y * octets + threadIdx.x;
  const int c0 = (blockIdx.y * octets + threadIdx.x) * kOct;
  const long long lo = (long long)blockIdx.x * chunk;
  const long long hi = min(lo + chunk, rows);
  float s1[kOct] = {}, s2[kOct] = {};
  if (c0 < channels) {
    for (long long r = lo + threadIdx.y; r < hi; r += (long long)kRows * stack) {
      nhwc::Loaded<T, kVector> la[kRows], lb[kSame ? 1 : kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const long long ri = r + (long long)i * stack;
        if (ri < hi) {
          nhwc::fetch(a + ri * channels, c0, channels, la[i]);
          if constexpr (!kSame) nhwc::fetch(b + ri * channels, c0, channels, lb[i]);
        } else {
          nhwc::zero(la[i]);
          if constexpr (!kSame) nhwc::zero(lb[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        float x[kOct];
        nhwc::widen(la[i], x);
        if constexpr (kSame) {
#pragma unroll
          for (int k = 0; k < kOct; ++k) {
            s1[k] += x[k];
            s2[k] = fmaf(x[k], x[k], s2[k]);
          }
        } else {
          float y[kOct];
          nhwc::widen(lb[i], y);
#pragma unroll
          for (int k = 0; k < kOct; ++k) {
            s1[k] += x[k];
            s2[k] = fmaf(x[k], y[k], s2[k]);
          }
        }
      }
    }
  }
  // The stack's sums per (sum, channel j, octet o) slot, in a fixed order.
  // Where octets divides the warp (C = 8, 16, 32 or >= 64), the lanes of a
  // warp that share an octet add by xor-shuffles and the warps' totals meet
  // in shared memory; else every row-thread's sums do.
  int parts = stack;
  if (32 % octets == 0) {
    for (int off = 16; off >= octets; off >>= 1) {
#pragma unroll
      for (int k = 0; k < kOct; ++k) {
        s1[k] += __shfl_xor_sync(0xffffffffu, s1[k], off);
        s2[k] += __shfl_xor_sync(0xffffffffu, s2[k], off);
      }
    }
    parts = nhwc::kThreads / 32;
    if ((t & 31) >= octets) t = -1;              // lane o holds octet o's sums
    else t = (t >> 5) * octets + (t & 31);
  }
  if (t >= 0) {
#pragma unroll
    for (int k = 0; k < kOct; ++k) {
      s_red[k][t] = s1[k];
      s_red[kOct + k][t] = s2[k];
    }
  }
  __syncthreads();
  // slot q: sum j (s1 channel j, s2 channel j - 8) of octet o, its parts
  // added in order; consecutive threads read consecutive words
  const int q = threadIdx.y * octets + threadIdx.x;
  if (q < 2 * kOct * octets) {
    const int j = q / octets, o = q % octets;
    float tot = 0.0f;
    for (int r = 0; r < parts; ++r) tot += s_red[j][r * octets + o];
    const int c = (blockIdx.y * octets + o) * kOct + j % kOct;
    if (c < channels)
      partial[((long long)blockIdx.x * 2 + j / kOct) * channels + c] = tot;
  }
}

// Block (g, s): channels [32 g, 32 g + 32) of sum s (0: s1, 1: s2). Warp w
// adds chunks w, w + kFinalWarps, ... in order, lane l channel 32 g + l
// (coalesced), then warp 0 adds the warps' totals in order.
__global__ void __launch_bounds__(kFinalThreads)
bn_stats_finalize_nhwc(const float* __restrict__ partial, int chunks, int channels,
                       float* __restrict__ s1, float* __restrict__ s2) {
  __shared__ float s_warp[kFinalWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  const int s = blockIdx.y;
  float tot = 0.0f;
  if (c < channels) {
#pragma unroll 4
    for (int k = warp; k < chunks; k += kFinalWarps)
      tot += partial[((long long)k * 2 + s) * channels + c];
  }
  s_warp[warp][lane] = tot;
  __syncthreads();
  if (warp == 0 && c < channels) {
    float sum = 0.0f;
#pragma unroll
    for (int w = 0; w < kFinalWarps; ++w) sum += s_warp[w][lane];
    (s == 0 ? s1 : s2)[c] = sum;
  }
}

template <typename T, bool kVector>
void launch_nhwc_partial(const T* a, const T* b, long long rows, int channels,
                         long long chunk, dim3 grid, dim3 block, float* partial,
                         cudaStream_t stream) {
  if (a == b)
    bn_stats_partial_nhwc<T, kVector, true><<<grid, block, 0, stream>>>(
        a, b, rows, channels, chunk, partial);
  else
    bn_stats_partial_nhwc<T, kVector, false><<<grid, block, 0, stream>>>(
        a, b, rows, channels, chunk, partial);
}

// The chunks of the channels-last launch over `rows` rows of `channels` on
// the current device (header note): `chunks` chunks of `chunk` rows cover
// them, the last one short.
cudaError_t plan_nhwc(long long rows, int channels, long long& chunk, int& chunks) {
  if (rows < 1 || channels < 1) return cudaErrorInvalidValue;
  const nhwc::Tile tile = nhwc::tile(channels);
  if (tile.groups > 65535) return cudaErrorInvalidValue;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long blocks = static_cast<long long>(sms) * kBlocksPerSm;
  long long n = (blocks + tile.groups - 1) / tile.groups;
  n = std::max(1LL, std::min(n, (rows + kMinRows - 1) / kMinRows));
  chunk = (rows + n - 1) / n;
  chunks = static_cast<int>((rows + chunk - 1) / chunk);
  return cudaSuccess;
}

template <typename T>
int launch_nhwc(const T* a, const T* b, long long rows, int channels, int chunks,
                float* partial, float* s1, float* s2, cudaStream_t stream) {
  long long chunk = 0;
  int planned = 0;
  const cudaError_t planning = plan_nhwc(rows, channels, chunk, planned);
  if (planning != cudaSuccess) return static_cast<int>(planning);
  if (planned != chunks) return static_cast<int>(cudaErrorInvalidValue);
  const nhwc::Tile tile = nhwc::tile(channels);
  const dim3 grid(chunks, tile.groups), block(tile.octets, tile.stack);
  const void* pointers[] = {a, b};
  if (nhwc::vector_path(channels, pointers, 2))
    launch_nhwc_partial<T, true>(a, b, rows, channels, chunk, grid, block, partial, stream);
  else
    launch_nhwc_partial<T, false>(a, b, rows, channels, chunk, grid, block, partial,
                                  stream);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bn_stats_finalize_nhwc<<<dim3((channels + 31) / 32, 2), kFinalThreads, 0, stream>>>(
      partial, chunks, channels, s1, s2);
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

// C interface of the channels-last kernels. `a`, `b`: (rows, channels)
// row-major (a dense channels-last (B, C, H, W) tensor, rows = B * H * W),
// dtype 0 = f32, 1 = bf16. `mscd_bn_stats_nhwc_chunks` writes to `chunks`
// the chunks a launch over `rows` rows of `channels` takes on the current
// device (the grid is planned here; `stream` is the one the launch will run
// on, and the plan does not depend on it). `mscd_bn_stats_nhwc` takes them
// back with `partial`, chunks * 2 * channels f32 of scratch; `s1`, `s2`:
// (channels,) f32 outputs (fully written). Both return the cudaError_t of
// the call, cudaErrorInvalidValue for chunks that are not the plan's or a
// dtype or shape the kernels do not take.
extern "C" int mscd_bn_stats_nhwc_chunks(long long rows, int channels, int* chunks,
                                         void* stream) {
  (void)stream;
  long long chunk = 0;
  return static_cast<int>(plan_nhwc(rows, channels, chunk, *chunks));
}

extern "C" int mscd_bn_stats_nhwc(const void* a, const void* b, int dtype, long long rows,
                                  int channels, int chunks, float* partial, float* s1,
                                  float* s2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_nhwc(static_cast<const float*>(a), static_cast<const float*>(b), rows,
                       channels, chunks, partial, s1, s2, s);
  if (dtype == 1)
    return launch_nhwc(static_cast<const __nv_bfloat16*>(a),
                       static_cast<const __nv_bfloat16*>(b), rows, channels, chunks,
                       partial, s1, s2, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
