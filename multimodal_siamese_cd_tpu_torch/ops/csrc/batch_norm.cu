// Train-mode BatchNorm's two elementwise halves, for Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX package leaves the normalisation and its
// input gradient to XLA, which fuses each into one pass over the
// activation. The port's train-mode BatchNorm (models/batchnorm.py) built
// them from float32 PyTorch passes: the forward from five (a float32 copy,
// sub, mul, add, the cast back), the input gradient from eight (two float32
// copies, four in-place passes, the cast). Each kernel here is one pass.
//
// Functions: for x, dy of shape (B, C, H, W), both contiguous NCHW or both
// contiguous channels-last, both bf16 or both f32, and (C,) float32
// per-channel vectors,
//   batch_norm_apply:  y[b,c,h,w] = cast(((float)x - mean[c]) * scale[c] + bias[c])
//   batch_norm_dx:    dx[b,c,h,w] = cast((((float)dy - b[c]) - ((float)x - mean[c]) * a[c]) * g[c])
// Each operation is rounded to float32 on its own (__fsub_rn, __fmul_rn,
// __fadd_rn: nothing contracts into an FMA) and the cast rounds to nearest
// even, in the order of the PyTorch composition (ops/batch_norm.py's
// reference functions), so the result is bit-equal to it.
//
// Bound: bytes. apply reads x and writes y (4 bytes an element in bf16,
// 8 in f32) for 3 floating-point operations; dx reads dy and x and writes dx
// (6 bytes, 12 in f32) for 5. Both sit far below the card's ridge point, so
// the design is about moving each byte once, in wide accesses:
//   * Grid (rows, chunks). Row r = b * C + c is one contiguous (b, c) plane
//     of H*W elements; block (r, k) covers chunk k of it, so a block loads
//     its channel's coefficients once and computes no index division per
//     element.
//   * 16-byte accesses (8 bf16 or 4 f32) when H*W is a multiple of the
//     vector width and every tensor pointer is 16-byte aligned; one element
//     at a time otherwise (odd planes, views at odd offsets). The host
//     (ops/batch_norm.py `vector_width`) picks the width; `launch_grid`
//     here shapes the launch from it.
//   * A block has the plane's vectors rounded up to a warp, at most
//     kThreads; a thread loads all its kItems vectors of the chunk before
//     it computes and stores, so several 16-byte loads are in flight a
//     thread.
//     At the U-Net's top level (64 x 256^2) a step's launches are thousands
//     of blocks, many waves over 132 SMs. No shared memory.
// Channels-last (`batch_norm_apply_nhwc`, `batch_norm_dx_nhwc`, the layout
// the training step runs in on the card) is another design, not the plane
// kernels re-indexed: x is an (M = B*H*W) x C row-major matrix and a
// thread owns an octet of 8 channels (nhwc.cuh). It issues the 16-byte
// loads of its kRows rows of the block's chunk, then loads its octet's
// coefficients once, and computes and stores. A block is a
// chunk of stack * kRows rows of up to 64 channels, the same 8,192
// elements a block as the plane kernels at 64 channels or more; grid
// (chunks, channel groups). The C entry picks the path (nhwc.cuh): an
// octet in 16-byte accesses when C is a multiple of 8 and every tensor
// pointer is 16-byte aligned, else element by element. The same rounded
// operations in the same order give the same bits as the plane kernels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "nhwc.cuh"

namespace {

constexpr int kItems = 4;      // vectors a thread moves per chunk
constexpr int kThreads = 256;  // the most threads a block has

// The launch over `rows` planes of `plane` elements in vectors of `width`
// elements: a block of the plane's vectors rounded up to a warp, at most
// kThreads, and enough chunks of kItems vectors a thread to cover the
// plane. False when the width does not divide the plane or the grid would
// pass its limits (2^31 - 1 rows, 65535 chunks).
bool launch_grid(long long rows, long long plane, int width, dim3& grid, int& threads) {
  if (rows < 1 || rows > 0x7fffffffLL || plane < 1 || width < 1 || plane % width != 0)
    return false;
  const long long packs = plane / width;
  const long long warps = (packs + 31) / 32 * 32;
  threads = static_cast<int>(warps < kThreads ? warps : kThreads);
  const long long per_chunk = static_cast<long long>(threads) * kItems;
  const long long chunks = (packs + per_chunk - 1) / per_chunk;
  if (chunks > 65535) return false;
  grid = dim3(static_cast<unsigned>(rows), static_cast<unsigned>(chunks));
  return true;
}

template <typename T, int kN>
struct alignas(sizeof(T) * kN) Pack {
  T v[kN];
};

template <typename T, int kN>
__global__ void __launch_bounds__(kThreads)
batch_norm_apply(const T* __restrict__ x, const float* __restrict__ mean,
                 const float* __restrict__ scale, const float* __restrict__ bias,
                 T* __restrict__ y, int channels, long long plane) {
  using P = Pack<T, kN>;
  const long long row = blockIdx.x;
  const int c = static_cast<int>(row % channels);
  const float m = mean[c], s = scale[c], o = bias[c];
  const long long packs = plane / kN;
  const P* xp = reinterpret_cast<const P*>(x) + row * packs;
  P* yp = reinterpret_cast<P*>(y) + row * packs;
  const long long first = (long long)blockIdx.y * blockDim.x * kItems + threadIdx.x;
  P in[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const long long j = first + (long long)i * blockDim.x;
    if (j < packs) in[i] = xp[j];
  }
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const long long j = first + (long long)i * blockDim.x;
    if (j < packs) {
      P out;
#pragma unroll
      for (int k = 0; k < kN; ++k)
        from_f32(__fadd_rn(__fmul_rn(__fsub_rn(to_f32(in[i].v[k]), m), s), o), out.v[k]);
      yp[j] = out;
    }
  }
}

template <typename T, int kN>
__global__ void __launch_bounds__(kThreads)
batch_norm_dx(const T* __restrict__ dy, const T* __restrict__ x,
              const float* __restrict__ mean, const float* __restrict__ a,
              const float* __restrict__ b, const float* __restrict__ g,
              T* __restrict__ dx, int channels, long long plane) {
  using P = Pack<T, kN>;
  const long long row = blockIdx.x;
  const int c = static_cast<int>(row % channels);
  const float m = mean[c], ac = a[c], bc = b[c], gc = g[c];
  const long long packs = plane / kN;
  const P* dyp = reinterpret_cast<const P*>(dy) + row * packs;
  const P* xp = reinterpret_cast<const P*>(x) + row * packs;
  P* dxp = reinterpret_cast<P*>(dx) + row * packs;
  const long long first = (long long)blockIdx.y * blockDim.x * kItems + threadIdx.x;
  P din[kItems], xin[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const long long j = first + (long long)i * blockDim.x;
    if (j < packs) {
      din[i] = dyp[j];
      xin[i] = xp[j];
    }
  }
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const long long j = first + (long long)i * blockDim.x;
    if (j < packs) {
      P out;
#pragma unroll
      for (int k = 0; k < kN; ++k) {
        const float t = __fmul_rn(__fsub_rn(to_f32(xin[i].v[k]), m), ac);
        const float d = __fsub_rn(__fsub_rn(to_f32(din[i].v[k]), bc), t);
        from_f32(__fmul_rn(d, gc), out.v[k]);
      }
      dxp[j] = out;
    }
  }
}

template <typename T>
int launch_apply(const void* x, const float* mean, const float* scale, const float* bias,
                 void* y, long long rows, int channels, long long plane, int width,
                 cudaStream_t stream) {
  dim3 grid;
  int threads;
  if (!launch_grid(rows, plane, width, grid, threads))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kVec = 16 / sizeof(T);
  if (width == kVec)
    batch_norm_apply<T, kVec><<<grid, threads, 0, stream>>>(
        static_cast<const T*>(x), mean, scale, bias, static_cast<T*>(y), channels, plane);
  else if (width == 1)
    batch_norm_apply<T, 1><<<grid, threads, 0, stream>>>(
        static_cast<const T*>(x), mean, scale, bias, static_cast<T*>(y), channels, plane);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dx(const void* dy, const void* x, const float* mean, const float* a,
              const float* b, const float* g, void* dx, long long rows, int channels,
              long long plane, int width, cudaStream_t stream) {
  dim3 grid;
  int threads;
  if (!launch_grid(rows, plane, width, grid, threads))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kVec = 16 / sizeof(T);
  if (width == kVec)
    batch_norm_dx<T, kVec><<<grid, threads, 0, stream>>>(
        static_cast<const T*>(dy), static_cast<const T*>(x), mean, a, b, g,
        static_cast<T*>(dx), channels, plane);
  else if (width == 1)
    batch_norm_dx<T, 1><<<grid, threads, 0, stream>>>(
        static_cast<const T*>(dy), static_cast<const T*>(x), mean, a, b, g,
        static_cast<T*>(dx), channels, plane);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// ---- channels-last -----------------------------------------------------------

constexpr int kRows = 4;   // rows a channels-last thread moves

// The channels-last launch over `rows` rows of `channels`: false when the
// grid would pass its limits.
bool launch_grid_nhwc(long long rows, int channels, dim3& grid, dim3& block) {
  if (rows < 1 || channels < 1) return false;
  const nhwc::Tile tile = nhwc::tile(channels);
  const long long chunk = static_cast<long long>(tile.stack) * kRows;
  const long long chunks = (rows + chunk - 1) / chunk;
  if (chunks > 0x7fffffffLL || tile.groups > 65535) return false;
  grid = dim3(static_cast<unsigned>(chunks), static_cast<unsigned>(tile.groups));
  block = dim3(tile.octets, tile.stack);
  return true;
}

template <typename T, bool kVector>
__global__ void __launch_bounds__(nhwc::kThreads)
batch_norm_apply_nhwc(const T* __restrict__ x, const float* __restrict__ mean,
                      const float* __restrict__ scale, const float* __restrict__ bias,
                      T* __restrict__ y, long long rows, int channels) {
  using nhwc::kOct;
  const int c0 = (blockIdx.y * blockDim.x + threadIdx.x) * kOct;
  if (c0 >= channels) return;
  const long long first = (long long)blockIdx.x * blockDim.y * kRows + threadIdx.y;
  nhwc::Loaded<T, kVector> in[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const long long r = first + (long long)i * blockDim.y;
    if (r < rows) nhwc::fetch(x + r * channels, c0, channels, in[i]);
  }
  float m[kOct], s[kOct], o[kOct];
  nhwc::coefficients(mean, c0, channels, m);
  nhwc::coefficients(scale, c0, channels, s);
  nhwc::coefficients(bias, c0, channels, o);
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const long long r = first + (long long)i * blockDim.y;
    if (r < rows) {
      float v[kOct], out[kOct];
      nhwc::widen(in[i], v);
#pragma unroll
      for (int k = 0; k < kOct; ++k)
        out[k] = __fadd_rn(__fmul_rn(__fsub_rn(v[k], m[k]), s[k]), o[k]);
      nhwc::store<T, kVector>(y + r * channels, c0, channels, out);
    }
  }
}

template <typename T, bool kVector>
__global__ void __launch_bounds__(nhwc::kThreads)
batch_norm_dx_nhwc(const T* __restrict__ dy, const T* __restrict__ x,
                   const float* __restrict__ mean, const float* __restrict__ a,
                   const float* __restrict__ b, const float* __restrict__ g,
                   T* __restrict__ dx, long long rows, int channels) {
  using nhwc::kOct;
  const int c0 = (blockIdx.y * blockDim.x + threadIdx.x) * kOct;
  if (c0 >= channels) return;
  const long long first = (long long)blockIdx.x * blockDim.y * kRows + threadIdx.y;
  nhwc::Loaded<T, kVector> din[kRows], xin[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const long long r = first + (long long)i * blockDim.y;
    if (r < rows) {
      nhwc::fetch(dy + r * channels, c0, channels, din[i]);
      nhwc::fetch(x + r * channels, c0, channels, xin[i]);
    }
  }
  float m[kOct], ac[kOct], bc[kOct], gc[kOct];
  nhwc::coefficients(mean, c0, channels, m);
  nhwc::coefficients(a, c0, channels, ac);
  nhwc::coefficients(b, c0, channels, bc);
  nhwc::coefficients(g, c0, channels, gc);
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const long long r = first + (long long)i * blockDim.y;
    if (r < rows) {
      float dv[kOct], xv[kOct], out[kOct];
      nhwc::widen(din[i], dv);
      nhwc::widen(xin[i], xv);
#pragma unroll
      for (int k = 0; k < kOct; ++k) {
        const float t = __fmul_rn(__fsub_rn(xv[k], m[k]), ac[k]);
        const float d = __fsub_rn(__fsub_rn(dv[k], bc[k]), t);
        out[k] = __fmul_rn(d, gc[k]);
      }
      nhwc::store<T, kVector>(dx + r * channels, c0, channels, out);
    }
  }
}

template <typename T>
int launch_apply_nhwc(const void* x, const float* mean, const float* scale,
                      const float* bias, void* y, long long rows, int channels,
                      cudaStream_t stream) {
  dim3 grid, block;
  if (!launch_grid_nhwc(rows, channels, grid, block))
    return static_cast<int>(cudaErrorInvalidValue);
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  const void* pointers[] = {x, y};
  if (nhwc::vector_path(channels, pointers, 2))
    batch_norm_apply_nhwc<T, true><<<grid, block, 0, stream>>>(xt, mean, scale, bias, yt,
                                                                rows, channels);
  else
    batch_norm_apply_nhwc<T, false><<<grid, block, 0, stream>>>(xt, mean, scale, bias, yt,
                                                                 rows, channels);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dx_nhwc(const void* dy, const void* x, const float* mean, const float* a,
                   const float* b, const float* g, void* dx, long long rows, int channels,
                   cudaStream_t stream) {
  dim3 grid, block;
  if (!launch_grid_nhwc(rows, channels, grid, block))
    return static_cast<int>(cudaErrorInvalidValue);
  const T* dyt = static_cast<const T*>(dy);
  const T* xt = static_cast<const T*>(x);
  T* dxt = static_cast<T*>(dx);
  const void* pointers[] = {dy, x, dx};
  if (nhwc::vector_path(channels, pointers, 3))
    batch_norm_dx_nhwc<T, true><<<grid, block, 0, stream>>>(dyt, xt, mean, a, b, g, dxt,
                                                             rows, channels);
  else
    batch_norm_dx_nhwc<T, false><<<grid, block, 0, stream>>>(dyt, xt, mean, a, b, g, dxt,
                                                              rows, channels);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, loaded with ctypes. Tensors: (rows = B * C, plane = H * W)
// contiguous, dtype 0 = f32, 1 = bf16; per-channel vectors: (channels,) f32.
// `width`: 1, or 16 bytes' worth of elements where it divides the plane and
// every tensor pointer is 16-byte aligned (the host's choice). Returns the
// cudaError_t of the launch (0 on success), cudaErrorInvalidValue for a
// width, dtype or shape the kernels do not take.
extern "C" int mscd_batch_norm_apply(const void* x, const float* mean, const float* scale,
                                     const float* bias, void* y, int dtype, long long rows,
                                     int channels, long long plane, int width,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_apply<float>(x, mean, scale, bias, y, rows, channels, plane, width, s);
  if (dtype == 1)
    return launch_apply<__nv_bfloat16>(x, mean, scale, bias, y, rows, channels, plane,
                                       width, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int mscd_batch_norm_dx(const void* dy, const void* x, const float* mean,
                                  const float* a, const float* b, const float* g, void* dx,
                                  int dtype, long long rows, int channels, long long plane,
                                  int width, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dx<float>(dy, x, mean, a, b, g, dx, rows, channels, plane, width, s);
  if (dtype == 1)
    return launch_dx<__nv_bfloat16>(dy, x, mean, a, b, g, dx, rows, channels, plane,
                                    width, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// C interface of the channels-last kernels. Tensors: (rows = B * H * W,
// channels) row-major (dense channels-last), dtype 0 = f32, 1 = bf16;
// per-channel vectors: (channels,) f32. The entry takes the vector path
// where C is a multiple of 8 and every tensor pointer is 16-byte aligned.
// Returns the cudaError_t of the launch (0 on success),
// cudaErrorInvalidValue for a dtype or shape the kernels do not take.
extern "C" int mscd_batch_norm_apply_nhwc(const void* x, const float* mean,
                                          const float* scale, const float* bias, void* y,
                                          int dtype, long long rows, int channels,
                                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_apply_nhwc<float>(x, mean, scale, bias, y, rows, channels, s);
  if (dtype == 1)
    return launch_apply_nhwc<__nv_bfloat16>(x, mean, scale, bias, y, rows, channels, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int mscd_batch_norm_dx_nhwc(const void* dy, const void* x, const float* mean,
                                       const float* a, const float* b, const float* g,
                                       void* dx, int dtype, long long rows, int channels,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dx_nhwc<float>(dy, x, mean, a, b, g, dx, rows, channels, s);
  if (dtype == 1)
    return launch_dx_nhwc<__nv_bfloat16>(dy, x, mean, a, b, g, dx, rows, channels, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
