// Blockwise (flash) attention backward, float32, for Hopper (sm_90a).
//
// Replaces bigdl_tpu/ops/flash_attention.py: _blockwise_bwd, the custom VJP
// of _flash (a lax.scan over k/v blocks on the TPU).  From the forward's
// residuals q, k, v, out and the per-row logsumexp lse, and the output
// gradient g, it computes the recurrence
//
//   p  = exp(q . k^T * sm_scale - lse)      (0 where the key is masked)
//   D  = rowsum(g * out)
//   dv = p^T g,   dp = g v^T,   ds = p * (dp - D) * sm_scale
//   dq = ds k,    dk = ds^T q
//
// with the causal (top-left) and key-length masks of the forward.  As on the
// TPU, p is rebuilt tile by tile from lse, so the S x S score matrix never
// reaches device memory.
//
// Two entry points, launched in this order on one stream:
//   flash_attention_bwd_dq_f32    one block per (b*h, q tile): D for its rows
//                                 (written out for the second kernel), then dq
//                                 over the k tiles its rows can see;
//   flash_attention_bwd_dkdv_f32  one block per (b*h, k tile): dk and dv over
//                                 the q tiles that can see it (from the
//                                 diagonal down when causal).
// Each output element is summed by exactly one thread, in a fixed order: no
// atomics, and the result is the same from run to run.
//
// What bounds it: operations.  The least work is 2.5 times the forward's
// (five 64 x 64 x D products per visible tile pair against two): 3.2e10 flops
// at the training shape (B 8, H 12, S 1024, D 64, causal), against about
// 200 MB of q, k, v, out, g, lse, dq, dk, dv; far past the float32 ridge
// point, so the floor is the flops over 67 TFLOP/s.
//
// What the design does about it: the tiles of both kernels are staged in
// shared memory and every product is a 4 x 4 (or 4 x D/16) register block
// per thread fed from it, as in the forward.  Splitting the work into a
// q-side and a k-side kernel recomputes p and dp once more (seven products
// per tile pair instead of five) in exchange for no atomics and no
// cross-block reduction; one fused kernel with a dq reduction is a later
// change, as are tensor cores and TMA.

#include "flash_attention_common.cuh"

namespace {

using flash::kPPitch;
using flash::kThreads;
using flash::kTile;
using flash::View;

template <int D>
constexpr size_t dq_smem_bytes() {
  return (4 * flash::tile_floats<D>() + flash::score_floats() + 2 * kTile) *
         sizeof(float);
}

template <int D>
constexpr size_t dkdv_smem_bytes() {
  return (4 * flash::tile_floats<D>() + 2 * flash::score_floats() +
          2 * kTile) *
         sizeof(float);
}

// Row statistics of q rows [q0, q0 + 64) into shared memory: lse as given,
// and D = rowsum(g * out) from the staged g tile, one warp per row; D is also
// written to `delta` for the dk/dv kernel.
template <int D>
__device__ __forceinline__ void delta_rows(float* lse_s, float* delta_s,
                                           const float* gs, const View& o,
                                           const float* __restrict__ lse,
                                           float* __restrict__ delta, int b,
                                           int h, int bh, int q0, int sq) {
  constexpr int P = flash::pitch<D>();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int r = warp; r < kTile; r += kThreads / 32) {
    const bool ok = q0 + r < sq;
    float acc = 0.f;
    if (ok) {
      const float* orow = o.row(b, h, q0 + r);
      for (int d = lane; d < D; d += 32) acc = fmaf(gs[r * P + d], orow[d], acc);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      delta_s[r] = acc;
      lse_s[r] = ok ? lse[(size_t)bh * sq + q0 + r] : 0.f;
      if (ok) delta[(size_t)bh * sq + q0 + r] = acc;
    }
  }
}

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(View q, View k, View v, View o, View g,
                    const float* __restrict__ lse, float* __restrict__ delta,
                    float* __restrict__ dq, int heads, int sq, int skv,
                    float sm_scale) {
  constexpr int E = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Gs = Qs + flash::tile_floats<D>();
  float* Ks = Gs + flash::tile_floats<D>();
  float* Vs = Ks + flash::tile_floats<D>();
  float* dSs = Vs + flash::tile_floats<D>();
  float* lse_s = dSs + flash::score_floats();
  float* delta_s = lse_s + kTile;

  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int qt = gridDim.y - 1 - blockIdx.y;  // heaviest causal tiles first
  const int q0 = qt * kTile;
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;

  flash::load_tile<D>(Qs, q, b, h, q0, sq, 1.f);
  flash::load_tile<D>(Gs, g, b, h, q0, sq, 1.f);
  __syncthreads();
  delta_rows<D>(lse_s, delta_s, Gs, o, lse, delta, b, h, bh, q0, sq);

  float acc[4][E];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int e = 0; e < E; ++e) acc[i][e] = 0.f;
  }

  const int n_kt_all = flash::cdiv(skv, kTile);
  const int n_kt = CAUSAL ? min(qt + 1, n_kt_all) : n_kt_all;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the last tile's readers are done (row stats are in)
    flash::load_tile<D>(Ks, k, b, h, k0, skv, 1.f);
    flash::load_tile<D>(Vs, v, b, h, k0, skv, 1.f);
    __syncthreads();

    float s[4][4], dp[4][4];
    flash::tile_abt<D>(Qs, Ks, s);
    flash::tile_abt<D>(Gs, Vs, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float p = flash::visible<CAUSAL>(q0 + r, k0 + c, skv)
                            ? expf(s[i][j] * sm_scale - lse_s[r])
                            : 0.f;
        dSs[r * kPPitch + c] = p * (dp[i][j] - delta_s[r]) * sm_scale;
      }
    }
    __syncthreads();
    flash::tile_sb<D>(dSs, Ks, acc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= sq) continue;
    float* out = dq + ((size_t)bh * sq + r) * D;
#pragma unroll
    for (int e = 0; e < E; ++e) out[tx + 16 * e] = acc[i][e];
  }
}

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(View q, View k, View v, View g,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      float* __restrict__ dk, float* __restrict__ dv,
                      int heads, int sq, int skv, float sm_scale) {
  constexpr int E = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + flash::tile_floats<D>();
  float* Qs = Vs + flash::tile_floats<D>();
  float* Gs = Qs + flash::tile_floats<D>();
  float* Pt = Gs + flash::tile_floats<D>();
  float* dSt = Pt + flash::score_floats();
  float* lse_s = dSt + flash::score_floats();
  float* delta_s = lse_s + kTile;

  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int kt = blockIdx.y;  // causal: low k tiles see the most q tiles
  const int k0 = kt * kTile;
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;

  flash::load_tile<D>(Ks, k, b, h, k0, skv, 1.f);
  flash::load_tile<D>(Vs, v, b, h, k0, skv, 1.f);

  float dk_acc[4][E], dv_acc[4][E];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int e = 0; e < E; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.f;
  }

  const int n_qt = flash::cdiv(sq, kTile);
  // causal: q tile qt holds queries up to qt*64 + 63, so it sees this k
  // tile only from qt = kt on
  for (int qt = CAUSAL ? kt : 0; qt < n_qt; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();  // the last tile's readers are done (and Ks, Vs are in)
    flash::load_tile<D>(Qs, q, b, h, q0, sq, 1.f);
    flash::load_tile<D>(Gs, g, b, h, q0, sq, 1.f);
    for (int r = threadIdx.x; r < kTile; r += kThreads) {
      const bool ok = q0 + r < sq;
      lse_s[r] = ok ? lse[(size_t)bh * sq + q0 + r] : 0.f;
      delta_s[r] = ok ? delta[(size_t)bh * sq + q0 + r] : 0.f;
    }
    __syncthreads();

    // transposed tiles: row = key (ty*4+i), column = query (tx+16j)
    float st[4][4], dpt[4][4];
    flash::tile_abt<D>(Ks, Qs, st);
    flash::tile_abt<D>(Vs, Gs, dpt);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const bool ok =
            q0 + c < sq && flash::visible<CAUSAL>(q0 + c, k0 + r, skv);
        const float p = ok ? expf(st[i][j] * sm_scale - lse_s[c]) : 0.f;
        Pt[r * kPPitch + c] = p;
        dSt[r * kPPitch + c] = p * (dpt[i][j] - delta_s[c]) * sm_scale;
      }
    }
    __syncthreads();
    flash::tile_sb<D>(Pt, Gs, dv_acc);
    flash::tile_sb<D>(dSt, Qs, dk_acc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = k0 + ty * 4 + i;
    if (r >= skv) continue;
    const size_t off = ((size_t)bh * skv + r) * D;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      dk[off + tx + 16 * e] = dk_acc[i][e];
      dv[off + tx + 16 * e] = dv_acc[i][e];
    }
  }
}

template <int D, bool CAUSAL>
cudaError_t launch_dq(View q, View k, View v, View o, View g,
                      const float* lse, float* delta, float* dq, int batch,
                      int heads, int sq, int skv, float sm_scale,
                      cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<D>();
  const cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D, CAUSAL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(batch * heads, flash::cdiv(sq, kTile));
  flash_bwd_dq_kernel<D, CAUSAL><<<grid, kThreads, smem, stream>>>(
      q, k, v, o, g, lse, delta, dq, heads, sq, skv, sm_scale);
  return cudaGetLastError();
}

template <int D, bool CAUSAL>
cudaError_t launch_dkdv(View q, View k, View v, View g, const float* lse,
                        const float* delta, float* dk, float* dv, int batch,
                        int heads, int sq, int skv, float sm_scale,
                        cudaStream_t stream) {
  constexpr size_t smem = dkdv_smem_bytes<D>();
  const cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<D, CAUSAL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(batch * heads, flash::cdiv(skv, kTile));
  flash_bwd_dkdv_kernel<D, CAUSAL><<<grid, kThreads, smem, stream>>>(
      q, k, v, g, lse, delta, dk, dv, heads, sq, skv, sm_scale);
  return cudaGetLastError();
}

}  // namespace

// Operands as in flash_attention_fwd_f32: q, k, v, out and g are float32
// with contiguous, 16-byte aligned head_dim rows and the given element
// strides; lse (B, H, Sq) is the forward's.  delta (B, H, Sq) and dq
// (B, H, Sq, D) are contiguous outputs.  Launches on `stream`, does not
// synchronise, allocates nothing, and returns cudaGetLastError().
extern "C" int flash_attention_bwd_dq_f32(
    FLASH_VIEW_ARGS(q), FLASH_VIEW_ARGS(k), FLASH_VIEW_ARGS(v),
    FLASH_VIEW_ARGS(o), FLASH_VIEW_ARGS(g), const float* lse, float* delta,
    float* dq, int batch, int heads, int sq, int skv, int head_dim,
    float sm_scale, int causal, void* stream) {
  if (batch <= 0 || heads <= 0 || sq <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const View qv = FLASH_VIEW(q), kv = FLASH_VIEW(k), vv = FLASH_VIEW(v),
             ov = FLASH_VIEW(o), gv = FLASH_VIEW(g);
#define FLASH_DQ(D_)                                                        \
  return (int)(causal ? launch_dq<D_, true>(qv, kv, vv, ov, gv, lse, delta, \
                                            dq, batch, heads, sq, skv,      \
                                            sm_scale, st)                   \
                      : launch_dq<D_, false>(qv, kv, vv, ov, gv, lse,       \
                                             delta, dq, batch, heads, sq,   \
                                             skv, sm_scale, st))
  switch (head_dim) {
    case 32: FLASH_DQ(32);
    case 64: FLASH_DQ(64);
    case 128: FLASH_DQ(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef FLASH_DQ
}

// dk and dv (B, H, Skv, D) are contiguous outputs; delta is what
// flash_attention_bwd_dq_f32 wrote, so this runs after it on the same
// stream.  Launches on `stream`, does not synchronise, allocates nothing,
// and returns cudaGetLastError().
extern "C" int flash_attention_bwd_dkdv_f32(
    FLASH_VIEW_ARGS(q), FLASH_VIEW_ARGS(k), FLASH_VIEW_ARGS(v),
    FLASH_VIEW_ARGS(g), const float* lse, const float* delta, float* dk,
    float* dv, int batch, int heads, int sq, int skv, int head_dim,
    float sm_scale, int causal, void* stream) {
  if (batch <= 0 || heads <= 0 || skv <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const View qv = FLASH_VIEW(q), kv = FLASH_VIEW(k), vv = FLASH_VIEW(v),
             gv = FLASH_VIEW(g);
#define FLASH_DKDV(D_)                                                       \
  return (int)(causal ? launch_dkdv<D_, true>(qv, kv, vv, gv, lse, delta, dk, \
                                              dv, batch, heads, sq, skv,     \
                                              sm_scale, st)                  \
                      : launch_dkdv<D_, false>(qv, kv, vv, gv, lse, delta,   \
                                               dk, dv, batch, heads, sq,     \
                                               skv, sm_scale, st))
  switch (head_dim) {
    case 32: FLASH_DKDV(32);
    case 64: FLASH_DKDV(64);
    case 128: FLASH_DKDV(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef FLASH_DKDV
}

extern "C" const char* flash_attention_bwd_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
