// 3x3 stride-1 SAME convolution, NHWC input and HWIO weights, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel tools/pallas_conv3x3_experiment.py:51 `_kernel`
// (launched by `conv3x3_pallas`): an implicit GEMM in which each output row
// tile contracts K = 3·Cin per vertical tap, the three horizontal taps packed
// side by side in fast memory.
//
// Function, for image b, output pixel (h, w) and output channel o:
//   y[b,h,w,o] = Σ_{dy,dx,c} x[b,h+dy-1,w+dx-1,c] · w[dy,dx,c,o]
// over bf16 x and w (the wrapper rounds both to bf16, to nearest even), with
// x zero outside the image, products accumulated in f32, and y in x's dtype
// (f32, or bf16 rounded to nearest even).
//
// Bound: operations at the U-Net's deeper levels (2·9·Cin·Cout flops per
// output pixel on the bf16 tensor cores, against a few bytes per pixel),
// bytes at the 64-channel full-resolution level, where the two are about
// equal (8 × 256² × 64 → 64 in bf16: 38.7 GFLOP, 134 MB).
//
// Design: an implicit GEMM with M = output pixels, N = Cout, K = 9 taps ×
// Cin, on wgmma fed by TMA.
// - A tile is 128·MB output pixels (a TW x TH rectangle of one image, TW in
//   8..64, MB = 1 or 2) by BN output channels (8..256, dividing Cout). Its
//   K loop walks the horizontal taps dx, inside each Cin in chunks of 64
//   channels (128 bytes), inside each the vertical taps dy.
// - Input ring: for each (dx, chunk) one TMA box of the tile's TH rows and
//   the halo rows above and below, (TH + 2) x TW pixels of 64 channels,
//   starting at (x0 + dx - 1, y0 - 1). The hardware fills what lies outside
//   the image or past Cin with zeros, so the SAME padding costs no masks and
//   no padded copy. The box is stored as 128-byte pixel rows with the
//   128-byte swizzle, and the three vertical taps read it at offsets of dy
//   whole tile rows (dy·TW·128 bytes, a multiple of 1024): the standard
//   swizzled wgmma operand, with no copy per tap.
// - Weight ring: for each (tap, chunk) one TMA box of the K-major weights
//   (3, 3, Cout, Cin), BN rows of 64 channels, with the same swizzle.
// - One producer thread keeps both rings in flight, paced by full / empty
//   mbarriers with a phase bit each. Two consumer warpgroups each multiply
//   MB blocks of 64 pixels: 4·MB wgmma m64nBNk16 per (tap, chunk), f32
//   accumulators in registers. setmaxnreg moves registers from the producer
//   warpgroup to the consumers. At BN = 64 a second block per warpgroup
//   (MB = 2) halves the weight reads and the epilogues per pixel.
// - The grid is persistent: one block per SM walks the (pixel tile, channel
//   tile) list. The epilogue writes each warpgroup's 64·MB x BN sums, converted
//   to y's dtype, into swizzled shared memory and a TMA store writes them
//   out, clipped at H, W and Cout. The producer meanwhile fills the rings for
//   the next tile.
// Layout choice (PERF.md): a first build loaded one input box per tap at
// the tap's offset, nine per chunk; on an H100 it matched this design at the
// deep levels and lost to it at 64 -> 64 channels, where the nine reads from
// L2 bound it. This design reads the input three times per chunk; at 64
// channels the weights (9·Cin·BN·2 bytes per tile) are then most of what a
// tile reads from L2. A single halo box read at shifted starts would need
// descriptors that start inside a swizzle pattern (dx) and rows of one tile
// row only (TW = 64), or an unswizzled layout of 16-byte pieces loaded one
// 8-channel plane at a time; neither was built.
// No split-K and no atomics: two launches give the same bits.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kChunk = 64;                        // input channels per stage (128 B)
constexpr int kConsumers = 2;                     // wgmma warpgroups, MB x 64 pixels each
constexpr int kThreads = 128 * (kConsumers + 1);  // + the producer warpgroup
constexpr int kSmemLimit = 232448;                // a block's shared memory on Hopper

struct Params {
  int tile_w, tile_h;            // pixel tile TW x TH, TW·TH = 128·MB
  int tiles_w, tiles_h, tiles_n, tiles;
  int chunks;                    // ceil(cin / kChunk)
  int cout;
  int a_stages, b_stages;        // ring slots for input boxes and weight tiles
  int a_bytes;                   // one input box: (TH + 2) rows of TW pixels
};

// an input box holds the tile's TH rows and the halo rows above and below:
// (TH + 2)·TW pixels of 128 bytes, a multiple of 1024 bytes for TW in 8..64
__host__ __device__ constexpr int input_box_bytes(int tile_w, int mb) {
  return (128 * mb + 2 * tile_w) * kChunk * 2;
}

// BN output channels per tile; MB blocks of 64 pixels per consumer warpgroup
template <int BN, int MB, typename OutT>
struct Layout {
  static constexpr int kBytesB = BN * kChunk * 2;   // one tap's weights for a chunk
  // a store box holds 64 pixels x kBoxC channels, rows of at most 128 bytes
  static constexpr int kBoxC = BN * (int)sizeof(OutT) <= 128 ? BN : 128 / (int)sizeof(OutT);
  static constexpr int kRowBytes = kBoxC * (int)sizeof(OutT);
  static constexpr int kBoxBytes = 64 * kRowBytes;
  static constexpr int kBoxes = BN / kBoxC;
  static constexpr int kStaging = MB * kBoxes * kBoxBytes;   // per consumer warpgroup
  // the TMA swizzle that matches rows of kRowBytes: log2(kRowBytes / 16) bits
  static constexpr int kSwizzleBits = kRowBytes == 128 ? 3 : kRowBytes == 64 ? 2
                                    : kRowBytes == 32 ? 1 : 0;
};

template <int BN, int MB, typename OutT>
constexpr int smem_bytes(int tile_w, int a_stages, int b_stages) {
  using L = Layout<BN, MB, OutT>;
  // 1024 bytes of slack to align the base for the 128-byte swizzle, and a
  // full and an empty barrier per slot
  return 1024 + a_stages * input_box_bytes(tile_w, MB) + b_stages * L::kBytesB
       + kConsumers * L::kStaging + 16 * (a_stages + b_stages);
}

struct Tile {
  int img, y0, x0, n0;
};

template <int BN>
__device__ __forceinline__ Tile tile_at(int t, const Params& p) {
  const int n = t % p.tiles_n;
  int m = t / p.tiles_n;
  const int tx = m % p.tiles_w;
  m /= p.tiles_w;
  const int ty = m % p.tiles_h;
  return {m / p.tiles_h, ty * p.tile_h, tx * p.tile_w, n * BN};
}

// a position in a ring of slots, with the phase parity of its barriers
struct Ring {
  int slot = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void next(int slots) {
    if (++slot == slots) {
      slot = 0;
      phase ^= 1;
    }
  }
};

// byte offset within a staging box after the TMA swizzle of its rows
template <int Bits>
__device__ __forceinline__ uint32_t swizzle(uint32_t off) {
  return off ^ (((off >> 7) & ((1u << Bits) - 1)) << 4);
}

template <typename OutT>
__device__ __forceinline__ void store_pair(unsigned char* p, float a, float b) {
  if constexpr (sizeof(OutT) == 4) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);  // nearest even
  }
}

template <int BN, int MB, typename OutT>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_kernel(const __grid_constant__ CUtensorMap x_map,
               const __grid_constant__ CUtensorMap w_map,
               const __grid_constant__ CUtensorMap y_map, const Params p) {
  using L = Layout<BN, MB, OutT>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = hopper::smem_addr(smem_raw);
  const uint32_t ring_a = (raw + 1023) & ~1023u;
  const uint32_t ring_b = ring_a + p.a_stages * p.a_bytes;
  const uint32_t staging = ring_b + p.b_stages * L::kBytesB;
  // barriers, 8 bytes each: full and empty per input slot, then per weight slot
  const uint32_t full_a = staging + kConsumers * L::kStaging;
  const uint32_t empty_a = full_a + 8 * p.a_stages;
  const uint32_t full_b = empty_a + 8 * p.a_stages;
  const uint32_t empty_b = full_b + 8 * p.b_stages;
  const int wg = threadIdx.x / 128;
  const int row_bytes = p.tile_w * 128;   // one tile row of input pixels

  if (threadIdx.x == 0) {
    // full: the producer's arrival and the bytes; empty: one arrival per consumer
    for (int s = 0; s < p.a_stages; ++s) {
      hopper::mbar_init(full_a + 8 * s, 1);
      hopper::mbar_init(empty_a + 8 * s, kConsumers);
    }
    for (int s = 0; s < p.b_stages; ++s) {
      hopper::mbar_init(full_b + 8 * s, 1);
      hopper::mbar_init(empty_b + 8 * s, kConsumers);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---- producer: one thread issues every TMA load ----
    hopper::setmaxnreg_dec<40>();
    if (threadIdx.x == kConsumers * 128) {
      hopper::prefetch_tensormap(&x_map);
      hopper::prefetch_tensormap(&w_map);
      Ring a, b;
      for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
        const Tile tile = tile_at<BN>(t, p);
        for (int dx = 0; dx < 3; ++dx) {
          for (int c = 0; c < p.chunks; ++c) {
            // the tile's rows and their halo, shifted by the horizontal tap
            hopper::mbar_wait(empty_a + 8 * a.slot, a.phase ^ 1);   // the slot is free
            hopper::mbar_arrive_expect_tx(full_a + 8 * a.slot, p.a_bytes);
            hopper::tma_load_4d(ring_a + a.slot * p.a_bytes, &x_map, full_a + 8 * a.slot,
                                c * kChunk, tile.x0 + dx - 1, tile.y0 - 1, tile.img);
            a.next(p.a_stages);
            for (int dy = 0; dy < 3; ++dy) {
              hopper::mbar_wait(empty_b + 8 * b.slot, b.phase ^ 1);
              hopper::mbar_arrive_expect_tx(full_b + 8 * b.slot, L::kBytesB);
              hopper::tma_load_2d(ring_b + b.slot * L::kBytesB, &w_map, full_b + 8 * b.slot,
                                  c * kChunk, (3 * dy + dx) * p.cout + tile.n0);
              b.next(p.b_stages);
            }
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg multiplies pixel blocks MB wg .. MB wg +
    // MB - 1 of 64 pixels each (64·MB/TW tile rows) ----
    hopper::setmaxnreg_inc<232>();
    const int tid = threadIdx.x % 128;
    const int row0 = 16 * (tid / 32) + (tid % 32) / 4;   // and row0 + 8
    const int col0 = 2 * (tid % 4);
    constexpr uint32_t kBlockBytes = 64 * 128;           // 64 pixel rows of A
    const uint32_t my_rows = wg * MB * kBlockBytes;
    const uint32_t my_staging = staging + wg * L::kStaging;
    unsigned char* my_staging_ptr = smem_raw + (my_staging - raw);
    float acc[MB][BN / 2];
    Ring a, b;
    for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
      const Tile tile = tile_at<BN>(t, p);
#pragma unroll
      for (int m = 0; m < MB; ++m)
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[m][i] = 0.0f;
      // slots the previous group of products read, handed back once it is done
      int prev_b = -1, prev_a = -1;
      for (int dx = 0; dx < 3; ++dx) {
        for (int c = 0; c < p.chunks; ++c) {
          hopper::mbar_wait(full_a + 8 * a.slot, a.phase);
          const uint32_t rows = ring_a + a.slot * p.a_bytes + my_rows;
          for (int dy = 0; dy < 3; ++dy) {
            hopper::mbar_wait(full_b + 8 * b.slot, b.phase);
            // the vertical tap moves A by whole tile rows: 1024-byte aligned
            const uint64_t desc_a = hopper::desc_sw128(rows + dy * row_bytes);
            const uint64_t desc_b = hopper::desc_sw128(ring_b + b.slot * L::kBytesB);
            hopper::wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < kChunk / 16; ++kk)     // +32 bytes = 16 channels
#pragma unroll
              for (int m = 0; m < MB; ++m)
                hopper::wgmma_bf16<BN>(acc[m], desc_a + m * (kBlockBytes >> 4) + 2 * kk,
                                       desc_b + 2 * kk, 1);
            hopper::wgmma_commit();
            hopper::wgmma_wait<1>();   // the previous group is done
            if (tid == 0) {
              if (prev_b >= 0) hopper::mbar_arrive(empty_b + 8 * prev_b);
              if (prev_a >= 0) hopper::mbar_arrive(empty_a + 8 * prev_a);
            }
            prev_b = b.slot;
            prev_a = dy == 2 ? a.slot : -1;   // the input box's last reader
            b.next(p.b_stages);
          }
          a.next(p.a_stages);
        }
      }
      hopper::wgmma_wait<0>();
      if (tid == 0) {
        hopper::mbar_arrive(empty_b + 8 * prev_b);
        hopper::mbar_arrive(empty_a + 8 * prev_a);
      }
#pragma unroll
      for (int m = 0; m < MB; ++m) hopper::fence_registers(acc[m]);

      // epilogue: registers -> swizzled staging -> TMA store
      if (tid == 0) hopper::bulk_wait_read();   // the last tile's store has read it
      hopper::named_barrier_sync(1 + wg, 128);
#pragma unroll
      for (int m = 0; m < MB; ++m)
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int col = 8 * j + col0;
            const uint32_t off = (m * L::kBoxes + col / L::kBoxC) * L::kBoxBytes
                + swizzle<L::kSwizzleBits>((row0 + 8 * h) * L::kRowBytes
                                           + (col % L::kBoxC) * (int)sizeof(OutT));
            store_pair<OutT>(my_staging_ptr + off, acc[m][4 * j + 2 * h],
                             acc[m][4 * j + 2 * h + 1]);
          }
      hopper::fence_proxy_async();
      hopper::named_barrier_sync(1 + wg, 128);
      if (tid == 0) {
        const int block_rows = 64 / p.tile_w;   // tile rows of one 64-pixel block
        for (int m = 0; m < MB; ++m)
          for (int box = 0; box < L::kBoxes; ++box)
            hopper::tma_store_4d(&y_map, my_staging + (m * L::kBoxes + box) * L::kBoxBytes,
                                 tile.n0 + box * L::kBoxC, tile.x0,
                                 tile.y0 + (wg * MB + m) * block_rows, tile.img);
        hopper::bulk_commit();
      }
    }
    if (tid == 0) hopper::bulk_wait();
  }
}

// ---- host side --------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library needs no -lcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                                    cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

CUtensorMapSwizzle swizzle_mode(int row_bytes) {
  switch (row_bytes) {
    case 128: return CU_TENSOR_MAP_SWIZZLE_128B;
    case 64: return CU_TENSOR_MAP_SWIZZLE_64B;
    case 32: return CU_TENSOR_MAP_SWIZZLE_32B;
    default: return CU_TENSOR_MAP_SWIZZLE_NONE;
  }
}

// a 4-D NHWC map (C, W, H, B), innermost first
bool encode_nhwc(EncodeTiled fn, CUtensorMap* map, CUtensorMapDataType type, int elem,
                 const void* ptr, int batch, int height, int width, int channels,
                 int box_c, int box_w, int box_h, int row_bytes) {
  const cuuint64_t dims[4] = {(cuuint64_t)channels, (cuuint64_t)width, (cuuint64_t)height,
                              (cuuint64_t)batch};
  const cuuint64_t px = (cuuint64_t)channels * elem;
  const cuuint64_t strides[3] = {px, px * width, px * width * height};
  const cuuint32_t box[4] = {(cuuint32_t)box_c, (cuuint32_t)box_w, (cuuint32_t)box_h, 1};
  const cuuint32_t steps[4] = {1, 1, 1, 1};
  return fn(map, type, 4, const_cast<void*>(ptr), dims, strides, box, steps,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle_mode(row_bytes),
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE)
         == CUDA_SUCCESS;
}

// return codes besides cudaError_t: the driver has no tensor-map encoder,
// a tensor map was refused, the plan is not one the kernel takes
constexpr int kNoEncoder = -1;
constexpr int kBadTensorMap = -2;
constexpr int kBadPlan = -3;

// one call: the operands' sizes and the plan
struct Call {
  int batch, height, width, cin, cout;
  int tile_w, a_stages, b_stages, grid;
};

template <int BN, int MB, typename OutT>
int launch(const void* x, const void* wk, void* y, const Call& call, cudaStream_t stream) {
  using L = Layout<BN, MB, OutT>;
  const int tw = call.tile_w;
  if (tw != 8 && tw != 16 && tw != 32 && tw != 64) return kBadPlan;
  const int smem = smem_bytes<BN, MB, OutT>(tw, call.a_stages, call.b_stages);
  // two slots at least in each ring: a slot is handed back only once the
  // products after its last reader have been issued
  if (call.cout % BN || call.a_stages < 2 || call.b_stages < 2 || smem > kSmemLimit
      || call.grid < 1)
    return kBadPlan;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kNoEncoder;

  Params p;
  p.tile_w = tw;
  p.tile_h = 128 * MB / tw;
  p.tiles_w = (call.width + tw - 1) / tw;
  p.tiles_h = (call.height + p.tile_h - 1) / p.tile_h;
  p.tiles_n = call.cout / BN;
  const long long tiles = (long long)call.batch * p.tiles_h * p.tiles_w * p.tiles_n;
  if (tiles > 0x7fffffffLL) return kBadPlan;
  p.tiles = (int)tiles;
  p.chunks = (call.cin + kChunk - 1) / kChunk;
  p.cout = call.cout;
  p.a_stages = call.a_stages;
  p.b_stages = call.b_stages;
  p.a_bytes = input_box_bytes(tw, MB);

  CUtensorMap x_map, w_map, y_map;
  const CUtensorMapDataType out_type = sizeof(OutT) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                                         : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  // input boxes: 64 channels x TW pixels x (TH + 2) rows
  bool ok = encode_nhwc(fn, &x_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, call.batch,
                        call.height, call.width, call.cin, kChunk, tw, p.tile_h + 2, 128);
  // the weights as a (9·Cout) x Cin matrix, K-major
  const cuuint64_t w_dims[2] = {(cuuint64_t)call.cin, (cuuint64_t)9 * call.cout};
  const cuuint64_t w_strides[1] = {(cuuint64_t)call.cin * 2};
  const cuuint32_t w_box[2] = {kChunk, BN};
  const cuuint32_t w_steps[2] = {1, 1};
  ok = ok && fn(&w_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(wk), w_dims,
                w_strides, w_box, w_steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
  // output boxes: one block of 64 pixels, kBoxC channels
  ok = ok && encode_nhwc(fn, &y_map, out_type, (int)sizeof(OutT), y, call.batch, call.height,
                         call.width, call.cout, L::kBoxC, tw, 64 / tw, L::kRowBytes);
  if (!ok) return kBadTensorMap;

  cudaError_t err = cudaFuncSetAttribute(conv3x3_kernel<BN, MB, OutT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  conv3x3_kernel<BN, MB, OutT><<<call.grid, kThreads, smem, stream>>>(x_map, w_map, y_map, p);
  return static_cast<int>(cudaGetLastError());
}

// the instantiations: one 64-pixel block per warpgroup at every channel
// tile; two at a channel tile of 64, where they halve the weight reads per
// pixel and the epilogues per product (at 128 and more the ring loses
// slots to the larger tile and gains nothing)
template <typename OutT>
int launch_n(int block_n, int m_blocks, const void* x, const void* wk, void* y,
             const Call& call, cudaStream_t s) {
  if (m_blocks == 2) return block_n == 64 ? launch<64, 2, OutT>(x, wk, y, call, s) : kBadPlan;
  if (m_blocks != 1) return kBadPlan;
  switch (block_n) {
    case 8: return launch<8, 1, OutT>(x, wk, y, call, s);
    case 16: return launch<16, 1, OutT>(x, wk, y, call, s);
    case 32: return launch<32, 1, OutT>(x, wk, y, call, s);
    case 64: return launch<64, 1, OutT>(x, wk, y, call, s);
    case 128: return launch<128, 1, OutT>(x, wk, y, call, s);
    case 256: return launch<256, 1, OutT>(x, wk, y, call, s);
    default: return kBadPlan;
  }
}

}  // namespace

// C interface, loaded with ctypes. x (B, H, W, Cin) contiguous bfloat16; wk
// (3, 3, Cout, Cin) contiguous bfloat16 (the HWIO weights with the last two
// axes swapped); y (B, H, W, Cout) contiguous, float32 (out_dtype 0) or
// bfloat16 (1); Cin and Cout multiples of 8; every pointer 16-byte aligned.
// The plan (ops/conv3x3.py `plan`): the pixel tile's width (8, 16, 32 or 64;
// its height is 128·m_blocks / width), the output-channel tile (8, 16, 32,
// 64, 128 or 256, dividing Cout), the 64-pixel blocks per consumer
// warpgroup (1, or 2 with a channel tile of 64), the slots of the
// input and weight rings, and the number of blocks. Returns the cudaError_t of the launch (0 on success), or
// -1 (no tensor-map encoder in the driver), -2 (a tensor map was refused),
// -3 (a plan the kernel does not take).
extern "C" int mscd_conv3x3(const void* x, const void* wk, void* y, int out_dtype, int batch,
                            int height, int width, int cin, int cout, int tile_w,
                            int block_n, int m_blocks, int a_stages, int b_stages,
                            int grid, void* stream) {
  const Call call = {batch, height, width, cin, cout, tile_w, a_stages, b_stages, grid};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_dtype == 1) return launch_n<__nv_bfloat16>(block_n, m_blocks, x, wk, y, call, s);
  return launch_n<float>(block_n, m_blocks, x, wk, y, call, s);
}
