// Per-scene confusion counts at T thresholds, for Hopper (sm_90a).
//
// Replaces the TPU kernel multimodal_siamese_cd_tpu/ops/confusion.py
// `_kernel` (launched by `_confusion_pallas` / `confusion_counts_pallas`),
// which streams one flat probability map through VMEM and keeps f32 counts
// in SMEM. This kernel takes B scenes at once and returns exact integer
// counts.
//
// Function: for scene b and threshold k, over pixels i with valid[b,i] != 0,
//   pred = rint((p - thr_k) + 0.5) >= 1    (f32, round half to even; the
//                                           training metric's rule)
//   or, in the strict variant,
//   pred = p > thr_k                        (the offline assessment's rule,
//                                           metrics.py strict_confusion_counts)
//   truth = y[b,i] != 0                     (== y > 0.5 on a uint8 label)
//   out[b, 0..3, k] = (tp, tn, fp, fn)      int64
// Neither rule predicts at p == thr_k (round(0.5) == 0). They differ just
// above a threshold below 0.5, where p - thr_k is under half an ulp of 0.5
// and the first rule's `+ 0.5` absorbs it (thr 0.3, p = 0.3 + 1 ulp: only
// the strict rule predicts).
//
// Bound: bytes. Each pixel is read once, 6 bytes (f32 prob, u8 label, u8
// mask), for a handful of integer and float operations, so the card's
// memory rate bounds it by two orders of magnitude. The design streams
// every byte exactly once for T <= kChunk: vector loads (16 B of probs and
// 4 B each of label and mask per thread and step) in a grid-stride loop,
// counters in registers, a warp-shuffle and shared-memory reduction, then
// ONE 64-bit atomicAdd per block per output count. Per threshold the
// kernel counts only predicted-positives and true positives; the other
// three counts follow from the valid and positive totals:
//   fp = pred - tp,  fn = pos - tp,  tn = (valid - pos) - fp.
// Thresholds sit in shared memory; T is a runtime argument, counted kChunk
// at a time (one pass over the data per chunk).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 2048 / kThreads;   // resident threads an SM holds
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 8;                   // thresholds counted per pass
constexpr int kSlots = 2 + 2 * kChunk;      // valid, pos, pred[k], tp[k]

struct Counters {
  unsigned int valid;
  unsigned int pos;
  unsigned int pred[kChunk];
  unsigned int tp[kChunk];
};

template <bool kStrict>
__device__ __forceinline__ void count_pixel(float p, unsigned char y,
                                            unsigned char v,
                                            const float (&thr)[kChunk],
                                            int n_thr, Counters& c) {
  const unsigned int valid = v != 0;
  const unsigned int truth = valid & (y != 0);
  c.valid += valid;
  c.pos += truth;
#pragma unroll
  for (int k = 0; k < kChunk; ++k) {
    if (k < n_thr) {
      bool above;
      if constexpr (kStrict) {
        above = p > thr[k];
      } else {
        // explicit round-to-nearest adds: no contraction or reordering
        above = rintf(__fadd_rn(__fsub_rn(p, thr[k]), 0.5f)) >= 1.0f;
      }
      const unsigned int pred = valid & above;
      c.pred[k] += pred;
      c.tp[k] += pred & truth;
    }
  }
}

__device__ __forceinline__ unsigned long long warp_sum(unsigned long long x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
  return x;
}

template <bool kVec, bool kStrict>
__global__ void __launch_bounds__(kThreads)
confusion_kernel(const float* __restrict__ probs,
                 const unsigned char* __restrict__ labels,
                 const unsigned char* __restrict__ valid,
                 const float* __restrict__ thresholds, int n_thresholds,
                 long long n_pixels, unsigned long long* __restrict__ out) {
  extern __shared__ float s_thr[];
  __shared__ unsigned long long s_part[kWarps][kSlots];
  __shared__ unsigned long long s_tot[kSlots];

  for (int i = threadIdx.x; i < n_thresholds; i += kThreads) s_thr[i] = thresholds[i];
  __syncthreads();

  const long long b = blockIdx.y;
  const float* p_row = probs + b * n_pixels;
  const unsigned char* y_row = labels + b * n_pixels;
  const unsigned char* v_row = valid + b * n_pixels;
  unsigned long long* o_row = out + b * 4LL * n_thresholds;
  const long long start = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kThreads;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  for (int t0 = 0; t0 < n_thresholds; t0 += kChunk) {
    const int n_thr = min(kChunk, n_thresholds - t0);
    float thr[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) thr[k] = k < n_thr ? s_thr[t0 + k] : 0.0f;

    Counters c = {};
    if constexpr (kVec) {
      // n_pixels % 4 == 0 and the rows are 16 B (probs) / 4 B aligned
      const float4* p4 = reinterpret_cast<const float4*>(p_row);
      const uchar4* y4 = reinterpret_cast<const uchar4*>(y_row);
      const uchar4* v4 = reinterpret_cast<const uchar4*>(v_row);
      const long long n4 = n_pixels >> 2;
      for (long long i = start; i < n4; i += stride) {
        const float4 p = p4[i];
        const uchar4 y = y4[i];
        const uchar4 v = v4[i];
        count_pixel<kStrict>(p.x, y.x, v.x, thr, n_thr, c);
        count_pixel<kStrict>(p.y, y.y, v.y, thr, n_thr, c);
        count_pixel<kStrict>(p.z, y.z, v.z, thr, n_thr, c);
        count_pixel<kStrict>(p.w, y.w, v.w, thr, n_thr, c);
      }
    } else {
      for (long long i = start; i < n_pixels; i += stride)
        count_pixel<kStrict>(p_row[i], y_row[i], v_row[i], thr, n_thr, c);
    }

    // block reduction: warp shuffles, then across warps in shared memory
    unsigned long long part[kSlots];
    part[0] = c.valid;
    part[1] = c.pos;
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      part[2 + k] = c.pred[k];
      part[2 + kChunk + k] = c.tp[k];
    }
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const unsigned long long w = warp_sum(part[s]);
      if (lane == 0) s_part[warp][s] = w;
    }
    __syncthreads();
    if (threadIdx.x < kSlots) {
      unsigned long long tot = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) tot += s_part[w][threadIdx.x];
      s_tot[threadIdx.x] = tot;
    }
    __syncthreads();
    if (threadIdx.x < n_thr) {
      const int k = threadIdx.x;
      const unsigned long long n_valid = s_tot[0], n_pos = s_tot[1];
      const unsigned long long pred = s_tot[2 + k], tp = s_tot[2 + kChunk + k];
      const unsigned long long fp = pred - tp;
      const long long col = t0 + k;
      atomicAdd(o_row + 0LL * n_thresholds + col, tp);
      atomicAdd(o_row + 1LL * n_thresholds + col, (n_valid - n_pos) - fp);
      atomicAdd(o_row + 2LL * n_thresholds + col, fp);
      atomicAdd(o_row + 3LL * n_thresholds + col, n_pos - tp);
    }
    __syncthreads();  // s_part / s_tot are reused by the next chunk
  }
}

}  // namespace

// The vectorized path needs whole 4-pixel groups and aligned rows.
static bool vectorizable(const float* probs, const unsigned char* labels,
                         const unsigned char* valid, long long n_pixels) {
  return (n_pixels % 4 == 0) && (reinterpret_cast<uintptr_t>(probs) % 16 == 0) &&
         (reinterpret_cast<uintptr_t>(labels) % 4 == 0) &&
         (reinterpret_cast<uintptr_t>(valid) % 4 == 0);
}

// Grid: enough blocks to fill every SM of the current device, never more
// than one per kThreads pixels of a scene.
template <bool kStrict>
static int launch(const float* probs, const unsigned char* labels, const unsigned char* valid,
                  const float* thresholds, int n_thresholds, long long n_scenes,
                  long long n_pixels, long long* out, void* stream) {
  if (n_scenes < 1) return static_cast<int>(cudaErrorInvalidValue);
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long by_pixels = (n_pixels + kThreads - 1) / kThreads;
  const long long by_sms = (static_cast<long long>(sms) * kBlocksPerSm + n_scenes - 1) / n_scenes;
  const long long per_scene = by_pixels < by_sms ? by_pixels : by_sms;
  const dim3 grid(static_cast<unsigned int>(per_scene > 1 ? per_scene : 1),
                  static_cast<unsigned int>(n_scenes));
  const size_t smem = sizeof(float) * static_cast<size_t>(n_thresholds);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned long long* o = reinterpret_cast<unsigned long long*>(out);
  if (vectorizable(probs, labels, valid, n_pixels))
    confusion_kernel<true, kStrict><<<grid, kThreads, smem, s>>>(
        probs, labels, valid, thresholds, n_thresholds, n_pixels, o);
  else
    confusion_kernel<false, kStrict><<<grid, kThreads, smem, s>>>(
        probs, labels, valid, thresholds, n_thresholds, n_pixels, o);
  return static_cast<int>(cudaGetLastError());
}

// C interface, loaded with ctypes. `out` is a zeroed (B, 4, T) int64 tensor.
// Returns the cudaError_t of the launch (0 on success). The first entry
// point counts with the rounding rule, the second with the strict rule.
extern "C" int mscd_confusion_counts(const float* probs, const unsigned char* labels,
                                     const unsigned char* valid, const float* thresholds,
                                     int n_thresholds, long long n_scenes,
                                     long long n_pixels, long long* out, void* stream) {
  return launch<false>(probs, labels, valid, thresholds, n_thresholds, n_scenes, n_pixels,
                       out, stream);
}

extern "C" int mscd_strict_confusion_counts(const float* probs, const unsigned char* labels,
                                            const unsigned char* valid,
                                            const float* thresholds, int n_thresholds,
                                            long long n_scenes, long long n_pixels,
                                            long long* out, void* stream) {
  return launch<true>(probs, labels, valid, thresholds, n_thresholds, n_scenes, n_pixels,
                      out, stream);
}
