// Shared pieces of the blockwise (flash) attention kernels, forward
// (flash_attention_fwd.cu) and backward (flash_attention_bwd.cu), float32,
// for Hopper (sm_90a).  Both take their operands as strided Views, mask
// with `visible`, launch through the FLASH_VIEW macros, and run every
// product on the tensor cores in 3xTF32 (tf32x3.cuh) with the tile layout
// below.
//
// A block has 4 warps and owns a 64-row tile of one (batch, head) slice:
// each warp owns 16 of its rows.  The other side is walked 32 rows at a
// time through a ring of two shared-memory slots filled by cp.async.
// Tiles are padded to head_dim + 4 floats a row, which keeps every
// mma.sync fragment read, direct or in the permuted order below, free of
// bank conflicts; rows past the sequence are zero-filled by cp.async
// without a read.
//
// A product's scores come out of mma.sync in the accumulator layout (row
// g or g + 8, columns 2t and 2t + 1, with g = lane / 4, t = lane % 4) and
// go into the next product as its A operand with the k index permuted to
// match (virtual k t is column 2t, t + 4 is 2t + 1); the B operand is then
// read from shared memory at the same permuted rows (tile_b_perm), so
// scores never leave registers and a transposed operand is only a choice
// of addresses.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace flash {

constexpr int kRows = 64;      // the block's own tile: 16 rows a warp
constexpr int kThreads = 128;  // 4 warps
constexpr int kHalf = 32;      // the other side, walked 32 rows at a time
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

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

template <int D>
__host__ __device__ constexpr int pitch() {
  return D + 4;
}

// Whether key `kp` is visible to query `qp`: inside the key length and, when
// causal, not after the query (top-left aligned, as the TPU kernel masks).
template <bool CAUSAL>
__device__ __forceinline__ bool visible(int qp, int kp, int skv) {
  return kp < skv && (!CAUSAL || kp <= qp);
}

// Rows [row0, row0 + ROWS) of slice (b, h) of `v` into the padded tile `t`
// by cp.async, 16 bytes a copy; rows at or past `n` are zero-filled.
template <int D, int ROWS>
__device__ __forceinline__ void stage_tile(float* t, const View& v, int b,
                                           int h, int row0, int n) {
  constexpr int P = pitch<D>(), V4 = D / 4;
  for (int i = threadIdx.x; i < ROWS * V4; i += kThreads) {
    const int r = i / V4;
    const int c = (i - r * V4) * 4;
    const bool ok = row0 + r < n;
    tf32x3::cp_async16(t + r * P + c, ok ? v.row(b, h, row0 + r) + c : v.p,
                       ok);
  }
}

// ROWS per-row floats src[row0 ..) into s by cp.async; rows at or past n
// are 0
template <int ROWS>
__device__ __forceinline__ void stage_vec(float* s, const float* src,
                                          int row0, int n) {
  for (int r = threadIdx.x; r < ROWS; r += kThreads) {
    const bool ok = row0 + r < n;
    tf32x3::cp_async4(s + r, ok ? src + row0 + r : src, ok);
  }
}

// A 16 x 8 A fragment of the padded tile t at rows r0.., columns c0..
template <int D>
__device__ __forceinline__ tf32x3::FragA tile_a(const float* t, int r0,
                                                int c0) {
  constexpr int P = pitch<D>();
  const int g = (threadIdx.x & 31) >> 2, tt = threadIdx.x & 3;
  const float* p = t + (r0 + g) * P + c0 + tt;
  return tf32x3::frag_a(p[0], p[8 * P], p[4], p[8 * P + 4]);
}

// The B fragment of (tile rows n0.. as columns)^T: element (k, n) =
// t[n0 + n][c0 + k], for products against a tile's transpose (q k^T)
template <int D>
__device__ __forceinline__ tf32x3::FragB tile_bt(const float* t, int n0,
                                                 int c0) {
  constexpr int P = pitch<D>();
  const int g = (threadIdx.x & 31) >> 2, tt = threadIdx.x & 3;
  const float* p = t + (n0 + g) * P + c0 + tt;
  return tf32x3::frag_b(p[0], p[4]);
}

// The B fragment of tile rows r0.. (8 of them, in the permuted k order of
// acc_a) and columns c0..: element (k, n) = t[r0 + perm(k)][c0 + n]
template <int D>
__device__ __forceinline__ tf32x3::FragB tile_b_perm(const float* t, int r0,
                                                     int c0) {
  constexpr int P = pitch<D>();
  const int g = (threadIdx.x & 31) >> 2, tt = threadIdx.x & 3;
  const float* p = t + (r0 + 2 * tt) * P + c0 + g;
  return tf32x3::frag_b(p[0], p[P]);
}

// An accumulator tile (16 x 8, rows g / g + 8, columns 2t / 2t + 1) as the
// A fragment of the next product, its 8 columns in the permuted k order:
// virtual k t is column 2t, t + 4 is column 2t + 1.
__device__ __forceinline__ tf32x3::FragA acc_a(const float (&c)[4]) {
  return tf32x3::frag_a(c[0], c[2], c[1], c[3]);
}

// Accumulators e0 .. e0 + 3 of an (E, 4) array, as one (4, 4) array.
template <int E>
__device__ __forceinline__ float (&four(float (&acc)[E][4], int e0))[4][4] {
  return *reinterpret_cast<float(*)[4][4]>(&acc[e0]);
}

template <int E>
__device__ __forceinline__ void zero(float (&a)[E][4]) {
#pragma unroll
  for (int e = 0; e < E; ++e) {
#pragma unroll
    for (int i = 0; i < 4; ++i) a[e][i] = 0.f;
  }
}

// Row g (r = 0) or g + 8 (r = 1) of a warp's 16 x 8E accumulators to a
// contiguous output row, each times `scale`: columns 8e + 2t, 8e + 2t + 1
template <int E>
__device__ __forceinline__ void store_row(float* out, const float (&acc)[E][4],
                                          int r, float scale = 1.f) {
  const int tq = threadIdx.x & 3;
#pragma unroll
  for (int e = 0; e < E; ++e)
    *reinterpret_cast<float2*>(out + 8 * e + 2 * tq) =
        make_float2(acc[e][2 * r] * scale, acc[e][2 * r + 1] * scale);
}

}  // namespace flash

// The C entry points take each strided operand as (pointer, batch stride,
// head stride, seq stride); these spell that out once.
#define FLASH_VIEW_ARGS(name) \
  const float *name, long long name##_sb, long long name##_sh, \
      long long name##_ss
#define FLASH_VIEW(name) (flash::View{name, name##_sb, name##_sh, name##_ss})
