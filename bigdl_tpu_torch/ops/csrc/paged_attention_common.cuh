// Shared pieces of the paged attention kernels (decode and verify):
// loading one K or V row of head_dim values, a lane's share at a time, from
// a float32 page pool or from an int8 one with its page's scale (load_row,
// the verify kernel's), or 16 values of a row in 16-byte loads, unscaled
// (Row16, the decode kernel's).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace paged {

// Lane's E neighbouring floats of a float32 row.  The scale is 1 for
// float32 pools and is ignored.
template <int E>
__device__ __forceinline__ void load_row(const float* __restrict__ p, float,
                                         float (&r)[E]) {
  if constexpr (E % 4 == 0) {
#pragma unroll
    for (int i = 0; i < E / 4; ++i) {
      const float4 v = reinterpret_cast<const float4*>(p)[i];
      r[4 * i] = v.x;
      r[4 * i + 1] = v.y;
      r[4 * i + 2] = v.z;
      r[4 * i + 3] = v.w;
    }
  } else if constexpr (E % 2 == 0) {
#pragma unroll
    for (int i = 0; i < E / 2; ++i) {
      const float2 v = reinterpret_cast<const float2*>(p)[i];
      r[2 * i] = v.x;
      r[2 * i + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < E; ++i) r[i] = p[i];
  }
}

// Lane's E neighbouring values of an int8 row (1 byte each), multiplied by
// the page's scale right after the load: the float32 image of the page is
// never written to memory.
template <int E>
__device__ __forceinline__ void load_row(const int8_t* __restrict__ p,
                                         float scale, float (&r)[E]) {
  if constexpr (E % 4 == 0) {
#pragma unroll
    for (int i = 0; i < E / 4; ++i) {
      const char4 v = reinterpret_cast<const char4*>(p)[i];
      r[4 * i] = static_cast<float>(v.x) * scale;
      r[4 * i + 1] = static_cast<float>(v.y) * scale;
      r[4 * i + 2] = static_cast<float>(v.z) * scale;
      r[4 * i + 3] = static_cast<float>(v.w) * scale;
    }
  } else if constexpr (E % 2 == 0) {
#pragma unroll
    for (int i = 0; i < E / 2; ++i) {
      const char2 v = reinterpret_cast<const char2*>(p)[i];
      r[2 * i] = static_cast<float>(v.x) * scale;
      r[2 * i + 1] = static_cast<float>(v.y) * scale;
    }
  } else {
#pragma unroll
    for (int i = 0; i < E; ++i) r[i] = static_cast<float>(p[i]) * scale;
  }
}

// 16 neighbouring values of a pool row, held as loaded (four float4, or
// one int4 of 16 int8 values) and read as float32 by index: the loads of
// several rows can be issued before the first is used.  p must be 16-byte
// aligned.
template <typename T>
struct Row16;

template <>
struct Row16<float> {
  float4 v[4];
  __device__ __forceinline__ void load(const float* __restrict__ p) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      v[i] = __ldg(reinterpret_cast<const float4*>(p) + i);
  }
  __device__ __forceinline__ float operator[](int i) const {
    const float4& x = v[i >> 2];
    switch (i & 3) {
      case 0: return x.x;
      case 1: return x.y;
      case 2: return x.z;
      default: return x.w;
    }
  }
};

template <>
struct Row16<int8_t> {
  int4 v;
  __device__ __forceinline__ void load(const int8_t* __restrict__ p) {
    v = __ldg(reinterpret_cast<const int4*>(p));
  }
  __device__ __forceinline__ float operator[](int i) const {
    const int w = (i >> 2) == 0 ? v.x : (i >> 2) == 1 ? v.y
                : (i >> 2) == 2 ? v.z : v.w;
    return static_cast<float>(static_cast<int8_t>(w >> (8 * (i & 3))));
  }
};

// The scale of pool page `pid`: 1 for float32 pools (no scale table).
__device__ __forceinline__ float page_scale(const float* __restrict__ scales,
                                            int pid) {
  return scales == nullptr ? 1.f : scales[pid];
}

}  // namespace paged
