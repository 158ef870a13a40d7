// Channels-last (NHWC) tiling and loads, shared by the NHWC kernels of
// bn_stats.cu and batch_norm.cu, and the element conversions of both
// layouts' kernels there; the build hashes every csrc/*.cuh with each
// kernel's source, so an edit here rebuilds them.
//
// A dense channels-last activation of shape (B, C, H, W) is a row-major
// (M = B*H*W) x C matrix: row m holds the C channels of one pixel, and
// consecutive rows are consecutive in memory. A thread owns an "octet", 8
// consecutive channels of a row: one 16-byte load in bf16, two in float32.
// A block of kThreads threads is (octets x stack): `octets` octets of a row
// side by side (at most kMaxOctets: 64 channels, so a warp reads whole
// 128-byte lines of 4 rows in bf16, 256 bytes of each in float32) and the
// rest of its threads stacked over rows; grid.y walks the groups of
// `octets` octets that cover C. A thread loads its octet's per-channel
// values once and then walks rows, several at a time, all their loads
// issued (as raw words) before any is used. No index division per element.
//
// The vector path needs C a multiple of 8 and every tensor 16-byte aligned
// (then every octet is); the scalar path reads and writes an octet element
// by element and leaves the channels past C alone.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Element conversions of both layouts' kernels: bf16 widens exactly; a
// float32 narrows to bf16 by round-to-nearest-even.
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void from_f32(float v, float& out) { out = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16& out) {
  out = __float2bfloat16_rn(v);
}

namespace nhwc {

constexpr int kThreads = 256;
constexpr int kOct = 8;         // channels a thread owns
constexpr int kMaxOctets = 8;   // octets a block spans along a row

// A block's shape for `channels`: octets x stack threads, `groups` blocks
// along the channels.
struct Tile {
  int octets, stack, groups;
};

inline Tile tile(int channels) {
  const int octs = (channels + kOct - 1) / kOct;
  Tile t;
  t.octets = octs < kMaxOctets ? octs : kMaxOctets;
  t.stack = kThreads / t.octets;
  t.groups = (octs + t.octets - 1) / t.octets;
  return t;
}

// The vector path's condition (header note).
inline bool vector_path(int channels, const void* const* pointers, int count) {
  if (channels % kOct != 0) return false;
  for (int i = 0; i < count; ++i)
    if (reinterpret_cast<uintptr_t>(pointers[i]) % 16 != 0) return false;
  return true;
}

// One octet as raw 16-byte words.
template <typename T>
struct Octet {
  static constexpr int kWords = kOct * static_cast<int>(sizeof(T)) / 16;
  uint4 w[kWords];
};

__device__ __forceinline__ void widen(const Octet<float>& o, float (&v)[kOct]) {
  const float* f = reinterpret_cast<const float*>(o.w);
#pragma unroll
  for (int i = 0; i < kOct; ++i) v[i] = f[i];
}

__device__ __forceinline__ void widen(const Octet<__nv_bfloat16>& o, float (&v)[kOct]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(o.w);
#pragma unroll
  for (int i = 0; i < kOct / 2; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// An octet as loaded: raw 16-byte words on the vector path (4 registers in
// bf16, so a thread can hold many in flight), float32 on the scalar path.
template <typename T, bool kVector>
struct Loaded;
template <typename T>
struct Loaded<T, true> {
  Octet<T> o;
};
template <typename T>
struct Loaded<T, false> {
  float v[kOct];
};

// Load channels [c0, c0 + 8) of `row`; on the scalar path those at or past
// `channels` read as 0.
template <typename T, bool kVector>
__device__ __forceinline__ void fetch(const T* __restrict__ row, int c0, int channels,
                                      Loaded<T, kVector>& l) {
  if constexpr (kVector) {
    const uint4* q = reinterpret_cast<const uint4*>(row + c0);
#pragma unroll
    for (int i = 0; i < Octet<T>::kWords; ++i) l.o.w[i] = q[i];
  } else {
#pragma unroll
    for (int i = 0; i < kOct; ++i)
      l.v[i] = c0 + i < channels ? ::to_f32(row[c0 + i]) : 0.0f;
  }
}

// An octet of zeros (a row past the end: adds nothing to a sum).
template <typename T, bool kVector>
__device__ __forceinline__ void zero(Loaded<T, kVector>& l) {
  if constexpr (kVector) {
#pragma unroll
    for (int i = 0; i < Octet<T>::kWords; ++i) l.o.w[i] = make_uint4(0, 0, 0, 0);
  } else {
#pragma unroll
    for (int i = 0; i < kOct; ++i) l.v[i] = 0.0f;
  }
}

// A loaded octet as float32 (exact).
template <typename T, bool kVector>
__device__ __forceinline__ void widen(const Loaded<T, kVector>& l, float (&v)[kOct]) {
  if constexpr (kVector) {
    widen(l.o, v);
  } else {
#pragma unroll
    for (int i = 0; i < kOct; ++i) v[i] = l.v[i];
  }
}

// `v` rounded to T (nearest even) into channels [c0, c0 + 8) of `row`, those
// below `channels` on the scalar path.
template <typename T, bool kVector>
__device__ __forceinline__ void store(T* __restrict__ row, int c0, int channels,
                                      const float (&v)[kOct]) {
  if constexpr (kVector) {
    Octet<T> o;
    T* e = reinterpret_cast<T*>(o.w);
#pragma unroll
    for (int i = 0; i < kOct; ++i) ::from_f32(v[i], e[i]);
    uint4* q = reinterpret_cast<uint4*>(row + c0);
#pragma unroll
    for (int i = 0; i < Octet<T>::kWords; ++i) q[i] = o.w[i];
  } else {
#pragma unroll
    for (int i = 0; i < kOct; ++i)
      if (c0 + i < channels) ::from_f32(v[i], row[c0 + i]);
  }
}

// A per-channel float32 vector's values at channels [c0, c0 + 8), 0 past C.
__device__ __forceinline__ void coefficients(const float* __restrict__ p, int c0,
                                             int channels, float (&v)[kOct]) {
#pragma unroll
  for (int i = 0; i < kOct; ++i) v[i] = c0 + i < channels ? p[c0 + i] : 0.0f;
}

}  // namespace nhwc
