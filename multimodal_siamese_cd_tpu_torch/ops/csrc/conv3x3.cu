// 3x3 stride-1 SAME convolution, NHWC input and HWIO weights, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel tools/pallas_conv3x3_experiment.py `_kernel`
// (launched by `conv3x3_pallas`): an implicit GEMM in which each output row
// tile contracts K = 3·Cin per vertical tap, the three horizontal taps packed
// side by side in fast memory.
//
// Function, for image b, output pixel (h, w) and output channel o:
//   y[b,h,w,o] = Σ_{dy,dx,c} bf16(x[b,h+dy-1,w+dx-1,c]) · bf16(w[dy,dx,c,o])
// with x zero outside the image, bf16 rounding to nearest even, products
// accumulated in f32, and y in x's dtype (f32, or bf16 rounded to nearest
// even).
//
// Bound: operations at the U-Net's deeper levels (2·9·Cin·Cout flops per
// output pixel on the bf16 tensor cores, against a few bytes per pixel),
// bytes at the 64-channel full-resolution level, where the two are about
// equal (8 × 256² × 64 → 64 in bf16: 38.7 GFLOP, 134 MB).
//
// Design, a first kernel that is right and simple: a block computes a
// 16 x 16 pixel tile for 64 output channels with 8 warps, two output rows
// per warp. It walks Cin in chunks of 32 channels. For each chunk the input
// tile with its one-pixel halo (18 x 18 x 32, rounded to bf16 as it is
// stored) and the chunk's 9 x 32 x 64 weights are loaded into shared memory
// once. The nine taps then read the same shared tile at shifted addresses:
// a tap's 16 x 16 A operand is 16 neighbouring pixels of one row, 96 bytes
// apart, so no packed copy is made (the TPU kernel's tap packing, which
// needed one). Each warp multiplies with bf16 WMMA fragments (16 x 16 x 16,
// mma.sync on the tensor cores) into f32 accumulators, which finally pass
// through shared memory to coalesced, masked stores. There is no TMA, no
// wgmma and no overlap of one chunk's loads with the previous chunk's
// products: that is work for a later kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int kTileH = 16;                    // output rows per block
constexpr int kTileW = 16;                    // output columns per block (one fragment's M)
constexpr int kTileN = 64;                    // output channels per block
constexpr int kChunk = 32;                    // input channels per shared-memory stage
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerWarp = kTileH / kWarps;
constexpr int kFragsN = kTileN / 16;
constexpr int kHaloH = kTileH + 2;
constexpr int kHaloW = kTileW + 2;
// Leading dimensions, in elements. A pixel of the input tile takes 48 bf16
// (96 B): every tap shift then keeps the 32-byte alignment WMMA loads need.
constexpr int kLdA = kChunk + 16;
constexpr int kLdB = kTileN + 8;              // 144 B per weight row
constexpr int kLdC = kTileN + 4;              // f32 accumulators per output pixel
constexpr int kBytesA = kHaloH * kHaloW * kLdA * 2;
constexpr int kBytesB = 9 * kChunk * kLdB * 2;
constexpr int kBytesC = kTileH * kTileW * kLdC * 4;
constexpr int kSmemBytes = (kBytesA + kBytesB) > kBytesC ? (kBytesA + kBytesB) : kBytesC;

static_assert(kBytesA % 128 == 0, "the weight tile must start 128-byte aligned");
// WMMA pointers must be 32-byte aligned: A moves by one pixel per tap, B and
// C by 16 rows per fragment
static_assert((kLdA * 2) % 32 == 0 && (16 * kLdB * 2) % 32 == 0 &&
              (16 * kLdC * 4) % 32 == 0, "WMMA pointers must stay 32-byte aligned");
static_assert(kLdA % 8 == 0 && kLdB % 8 == 0 && kLdC % 4 == 0,
              "WMMA leading dimensions: multiples of 16 bytes");

__device__ __forceinline__ unsigned int pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<unsigned int*>(&v);
}

// 8 consecutive channels as bf16 (16 bytes).
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ uint4 load8(const float* p) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  return make_uint4(pack2(a.x, a.y), pack2(a.z, a.w), pack2(b.x, b.y), pack2(b.z, b.w));
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack2(v.x, v.y), pack2(v.z, v.w));
}

// two blocks per SM (at most 128 registers a thread): one block's loads
// overlap the other's products
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
conv3x3_kernel(const T* __restrict__ x, const __nv_bfloat16* __restrict__ w,
               T* __restrict__ y, int height, int width, int cin, int cout,
               int tiles_w) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* s_a = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* s_b = reinterpret_cast<__nv_bfloat16*>(smem + kBytesA);
  float* s_c = reinterpret_cast<float*>(smem);  // reused once the products are done

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int y0 = (blockIdx.x / tiles_w) * kTileH;
  const int x0 = (blockIdx.x % tiles_w) * kTileW;
  const int n0 = blockIdx.y * kTileN;
  const long long plane = static_cast<long long>(height) * width;
  const T* x_img = x + blockIdx.z * plane * cin;
  T* y_img = y + blockIdx.z * plane * cout;
  // output-channel fragments that hold any channel < cout (warp-uniform)
  const int n_frags = min(kFragsN, (cout - n0 + 15) / 16);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kRowsPerWarp][kFragsN];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
    for (int j = 0; j < kFragsN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int c0 = 0; c0 < cin; c0 += kChunk) {
    // the chunk's input tile with its halo; zeros outside the image and
    // past cin
    for (int i = tid; i < kHaloH * kHaloW * (kChunk / 8); i += kThreads) {
      const int v = i % (kChunk / 8);
      const int p = i / (kChunk / 8);
      const int gy = y0 - 1 + p / kHaloW;
      const int gx = x0 - 1 + p % kHaloW;
      const int c = c0 + 8 * v;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (gy >= 0 && gy < height && gx >= 0 && gx < width && c < cin)
        val = load8(x_img + (static_cast<long long>(gy) * width + gx) * cin + c);
      *reinterpret_cast<uint4*>(s_a + p * kLdA + 8 * v) = val;
    }
    // the chunk's weights of all nine taps; zeros past cin and cout
    for (int i = tid; i < 9 * kChunk * (kTileN / 8); i += kThreads) {
      const int v = i % (kTileN / 8);
      const int r = i / (kTileN / 8);        // tap * kChunk + channel in chunk
      const int c = c0 + r % kChunk;
      const int n = n0 + 8 * v;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (c < cin && n < cout)
        val = __ldg(reinterpret_cast<const uint4*>(
            w + (static_cast<long long>(r / kChunk) * cin + c) * cout + n));
      *reinterpret_cast<uint4*>(s_b + r * kLdB + 8 * v) = val;
    }
    __syncthreads();

#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3;
      const int dx = tap % 3;
#pragma unroll
      for (int k = 0; k < kChunk; k += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[kRowsPerWarp];
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) {
          // rows of A: the 16 pixels of output row r shifted by the tap
          const int r = warp * kRowsPerWarp + i;
          wmma::load_matrix_sync(a[i], s_a + ((r + dy) * kHaloW + dx) * kLdA + k, kLdA);
        }
#pragma unroll
        for (int j = 0; j < kFragsN; ++j) {
          if (j < n_frags) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
            wmma::load_matrix_sync(b, s_b + (tap * kChunk + k) * kLdB + 16 * j, kLdB);
#pragma unroll
            for (int i = 0; i < kRowsPerWarp; ++i)
              wmma::mma_sync(acc[i][j], a[i], b, acc[i][j]);
          }
        }
      }
    }
    __syncthreads();  // the next chunk (or the epilogue) overwrites the tiles
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
    for (int j = 0; j < kFragsN; ++j)
      if (j < n_frags)
        wmma::store_matrix_sync(s_c + (warp * kRowsPerWarp + i) * kTileW * kLdC + 16 * j,
                                acc[i][j], kLdC, wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < kTileH * kTileW * (kTileN / 4); i += kThreads) {
    const int v = i % (kTileN / 4);
    const int p = i / (kTileN / 4);
    const int gy = y0 + p / kTileW;
    const int gx = x0 + p % kTileW;
    const int n = n0 + 4 * v;
    if (gy < height && gx < width && n < cout)
      store4(y_img + (static_cast<long long>(gy) * width + gx) * cout + n,
             *reinterpret_cast<const float4*>(s_c + p * kLdC + 4 * v));
  }
}

template <typename T>
int launch(const void* x, const void* w, void* y, int batch, int height, int width,
           int cin, int cout, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_w = (width + kTileW - 1) / kTileW;
  const int tiles_h = (height + kTileH - 1) / kTileH;
  const dim3 grid(tiles_w * tiles_h, (cout + kTileN - 1) / kTileN, batch);
  conv3x3_kernel<T><<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(x), static_cast<const __nv_bfloat16*>(w), static_cast<T*>(y),
      height, width, cin, cout, tiles_w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, loaded with ctypes. x (B, H, W, Cin) and y (B, H, W, Cout)
// contiguous, both float32 (dtype 0) or both bfloat16 (dtype 1); w (3, 3,
// Cin, Cout) contiguous bfloat16; Cin and Cout multiples of 8; every pointer
// 16-byte aligned. Returns the cudaError_t of the launch (0 on success).
extern "C" int mscd_conv3x3(const void* x, const void* w, void* y, int dtype, int batch,
                            int height, int width, int cin, int cout, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w, y, batch, height, width, cin, cout, s);
  return launch<float>(x, w, y, batch, height, width, cin, cout, s);
}
