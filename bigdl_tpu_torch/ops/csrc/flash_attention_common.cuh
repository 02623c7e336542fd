// Shared pieces of the blockwise (flash) attention kernels, forward
// (flash_attention_fwd.cu) and backward (flash_attention_bwd.cu), float32,
// for Hopper (sm_90a).  Both take their operands as strided Views, mask
// with `visible` and launch through the FLASH_VIEW macros; the tile layout
// and helpers below are the forward's (the backward runs on the tensor
// cores, tf32x3.cuh).
//
// The forward works on 64-row tiles of one (batch, head) slice.  A block has
// 256 threads seen as a 16 x 16 grid: thread (ty, tx) = (tid / 16, tid % 16)
// owns rows ty*4 .. ty*4+3 of a 64 x 64 score tile and its columns
// tx, tx+16, tx+32, tx+48.  The 16 threads that share a row sit in one half
// of a warp, so a row's max and sum are four xor-shuffles.
//
// Tiles live in shared memory with rows padded to head_dim + 1 floats: a
// column walk (16 threads reading 16 rows at the same offset) then hits 16
// different banks, and a row walk stays contiguous.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace flash {

constexpr int kTile = 64;      // rows of a q tile and of a k tile
constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kPPitch = kTile + 1;  // padded row of a 64 x 64 score tile
// the TPU kernel's _NEG_INF: a finite start for the running max, so that
// exp(m_old - m_new) is 0 or 1 and never NaN
constexpr float kNegInf = -1e30f;

// One (batch, heads, seq, head_dim) float32 operand whose head_dim is
// contiguous; the other three strides are in elements.
struct View {
  const float* p;
  long long sb, sh, ss;
  __device__ __forceinline__ const float* row(int b, int h, int s) const {
    return p + b * sb + h * sh + s * ss;
  }
};

template <int D>
__host__ __device__ constexpr int pitch() {
  return D + 1;
}

template <int D>
__host__ __device__ constexpr size_t tile_floats() {
  return (size_t)kTile * pitch<D>();
}

__host__ __device__ constexpr size_t score_floats() {
  return (size_t)kTile * kPPitch;
}

// Rows [row0, row0 + 64) of slice (b, h) of `v` into the padded tile `t`,
// times `scale`; rows at or past `n` are zero.  Global reads are float4 and
// coalesced along head_dim (the wrapper guarantees 16-byte aligned rows).
template <int D>
__device__ __forceinline__ void load_tile(float* t, const View& v, int b,
                                          int h, int row0, int n,
                                          float scale) {
  constexpr int P = pitch<D>();
  constexpr int V4 = D / 4;
  for (int i = threadIdx.x; i < kTile * V4; i += kThreads) {
    const int r = i / V4;
    const int c = (i - r * V4) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n) {
      x = *reinterpret_cast<const float4*>(v.row(b, h, row0 + r) + c);
    }
    float* d = t + r * P + c;
    d[0] = x.x * scale;
    d[1] = x.y * scale;
    d[2] = x.z * scale;
    d[3] = x.w * scale;
  }
}

// acc[i][j] = sum_d A[ty*4+i][d] * B[tx+16j][d]: a 64 x 64 tile of A B^T,
// A and B padded 64 x D tiles.
template <int D>
__device__ __forceinline__ void tile_abt(const float* A, const float* B,
                                         float (&acc)[4][4]) {
  constexpr int P = pitch<D>();
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
  const float* a0 = A + (ty * 4) * P;
  const float* b0 = B + tx * P;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float a[4], bb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = a0[i * P + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bb[j] = b0[j * 16 * P + d];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
    }
  }
}

// acc[i][jj] += sum_k S[ty*4+i][k] * B[k][tx+16jj]: rows of a 64 x 64 score
// tile S (pitch kPPitch) times a padded 64 x D tile B.
template <int D>
__device__ __forceinline__ void tile_sb(const float* S, const float* B,
                                        float (&acc)[4][D / 16]) {
  constexpr int P = pitch<D>();
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
  const float* s0 = S + (ty * 4) * kPPitch;
#pragma unroll 4
  for (int k = 0; k < kTile; ++k) {
    float s[4], bb[D / 16];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i] = s0[i * kPPitch + k];
#pragma unroll
    for (int jj = 0; jj < D / 16; ++jj) bb[jj] = B[k * P + tx + 16 * jj];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int jj = 0; jj < D / 16; ++jj)
        acc[i][jj] = fmaf(s[i], bb[jj], acc[i][jj]);
    }
  }
}

// Max and sum over the 16 threads that share a row (one half-warp).
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Whether key `kp` is visible to query `qp`: inside the key length and, when
// causal, not after the query (top-left aligned, as the TPU kernel masks).
template <bool CAUSAL>
__device__ __forceinline__ bool visible(int qp, int kp, int skv) {
  return kp < skv && (!CAUSAL || kp <= qp);
}

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

}  // namespace flash

// The C entry points take each strided operand as (pointer, batch stride,
// head stride, seq stride); these spell that out once.
#define FLASH_VIEW_ARGS(name) \
  const float *name, long long name##_sb, long long name##_sh, \
      long long name##_ss
#define FLASH_VIEW(name) (flash::View{name, name##_sb, name##_sh, name##_ss})
