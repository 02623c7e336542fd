// Shared pieces of the paged attention kernels (decode and verify): 16
// values of a K or V row in 16-byte loads, unscaled, from a float32 or an
// int8 page pool (Row16), and the merge of a split walk's per-chunk
// partials in chunk order (merge_kernel).
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace paged {

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

// out row r from the n_chunks partials (m, l, acc[D]) of row r, merged in
// chunk order; one thread a column, block r = blockIdx.y * gridDim.x +
// blockIdx.x (a (slot, head) of the decode kernel, a (slot, head, query)
// of the verify kernel).  The non-empty partials are chunks 0 .. n_used -
// 1 (a chunk has keys for the row when it starts at or below the row's
// last visible key).  Their weights are computed a tile of D chunks at a
// time, one thread a chunk, so every load of a pass is independent of
// the others.  No atomics: the same bits every launch.
template <int D>
__global__ void __launch_bounds__(D)
merge_kernel(const float* __restrict__ ws, float* __restrict__ out,
             int n_chunks) {
  __shared__ float s_w[D], s_lw[D];
  __shared__ float s_mx[D / 32];
  __shared__ int s_n[D / 32];
  const size_t row = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
  const int t = threadIdx.x;
  const float* parts = ws + row * n_chunks * (D + 2);
  float mx = -INFINITY;
  int n_used = 0;
  for (int c = t; c < n_chunks; c += D) {
    const float* pc = parts + (size_t)c * (D + 2);
    if (pc[D + 1] > 0.f) {
      mx = fmaxf(mx, pc[D]);
      n_used = c + 1;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    n_used = max(n_used, __shfl_xor_sync(0xffffffffu, n_used, o));
  }
  if ((t & 31) == 0) {
    s_mx[t >> 5] = mx;
    s_n[t >> 5] = n_used;
  }
  __syncthreads();
#pragma unroll
  for (int w = 0; w < D / 32; ++w) {
    mx = fmaxf(mx, s_mx[w]);
    n_used = max(n_used, s_n[w]);
  }
  float den = 0.f, num = 0.f;
  for (int c0 = 0; c0 < n_used; c0 += D) {
    const int n = min(D, n_used - c0);
    if (t < n) {
      const float* pc = parts + (size_t)(c0 + t) * (D + 2);
      const float e = expf(pc[D] - mx);
      s_w[t] = e;
      s_lw[t] = pc[D + 1] * e;
    }
    __syncthreads();
#pragma unroll 8
    for (int i = 0; i < n; ++i) {
      num = fmaf(parts[(size_t)(c0 + i) * (D + 2) + t], s_w[i], num);
      den += s_lw[i];
    }
    __syncthreads();   // the tile's weights are read before the next
  }
  out[row * D + t] = num / (den == 0.f ? 1.f : den);
}

}  // namespace paged
