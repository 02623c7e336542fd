// Blockwise (flash) attention forward, float32, for Hopper (sm_90a).
//
// Replaces bigdl_tpu/ops/flash_attention.py: _flash_fwd, whose Pallas kernel
// is _fwd_kernel.  For q (B, H, Sq, D) and k, v (B, H, Skv, D) it computes
//
//   out[b, h, i] = sum_j softmax_j(q_i . k_j * sm_scale) v_j
//   lse[b, h, i] = log sum_j exp(q_i . k_j * sm_scale)
//
// over the keys j < Skv and, when causal, j <= i (top-left aligned).  The
// S x S score matrix never reaches device memory: each q tile keeps a running
// (max, denominator, accumulator) while it walks the k tiles.  A row with no
// visible key (Skv == 0) divides by 1, as the TPU kernel does.
//
// What bounds it: operations.  A call does 4 * B * H * D flops per visible
// (query, key) pair and reads each of q, k, v once at the least: at the
// training shape (B 8, H 12, S 1024, D 64, causal) that is 1.3e10 flops
// against 100 MB, far past the H100's float32 ridge point (67 TFLOP/s over
// 3.35 TB/s is 20 flops a byte), so its floor is the flops over 67 TFLOP/s.
//
// What the design does about it:
//   - one block per (b*h, q tile of 64 rows) loops over the k tiles of 64: the
//     TPU kernel's sequential k grid axis, whose scratch carried the softmax
//     state, becomes a loop inside the block with the state in registers;
//   - the q tile (pre-scaled by sm_scale, as the TPU kernel scales q) and each
//     k and v tile are staged in shared memory, so every key is read from
//     device memory once per q tile, not once per query;
//   - each thread computes a 4 x 4 block of the 64 x 64 score tile and a 4 x
//     D/16 block of the output from shared memory (two loads feed 16 FMAs);
//   - causal: k tiles wholly above the diagonal are never visited, and the
//     q tiles with the most k tiles are launched first;
//   - float32 CUDA cores throughout: tensor cores (TF32/bf16 wgmma), TMA and
//     double-buffered tiles are left for a later change.

#include "flash_attention_common.cuh"

namespace {

using flash::kNegInf;
using flash::kPPitch;
using flash::kThreads;
using flash::kTile;
using flash::View;

template <int D>
constexpr size_t fwd_smem_bytes() {
  return (3 * flash::tile_floats<D>() + flash::score_floats()) * sizeof(float);
}

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(View q, View k, View v, float* __restrict__ out,
                 float* __restrict__ lse, int heads, int sq, int skv,
                 float sm_scale) {
  constexpr int E = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + flash::tile_floats<D>();
  float* Vs = Ks + flash::tile_floats<D>();
  float* Ps = Vs + flash::tile_floats<D>();

  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int qt = gridDim.y - 1 - blockIdx.y;  // heaviest causal tiles first
  const int q0 = qt * kTile;
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;

  flash::load_tile<D>(Qs, q, b, h, q0, sq, sm_scale);

  float m[4], l[4], acc[4][E];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[i][e] = 0.f;
  }

  const int n_kt_all = flash::cdiv(skv, kTile);
  const int n_kt = CAUSAL ? min(qt + 1, n_kt_all) : n_kt_all;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the last tile's readers are done (and Qs is in)
    flash::load_tile<D>(Ks, k, b, h, k0, skv, 1.f);
    flash::load_tile<D>(Vs, v, b, h, k0, skv, 1.f);
    __syncthreads();

    float s[4][4];
    flash::tile_abt<D>(Qs, Ks, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (!flash::visible<CAUSAL>(qp, k0 + tx + 16 * j, skv))
          s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], flash::row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p =
            flash::visible<CAUSAL>(qp, k0 + tx + 16 * j, skv)
                ? expf(s[i][j] - m_new)
                : 0.f;
        sum += p;
        Ps[(ty * 4 + i) * kPPitch + tx + 16 * j] = p;
      }
      l[i] = l[i] * alpha + flash::row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[i][e] *= alpha;
    }
    __syncthreads();
    flash::tile_sb<D>(Ps, Vs, acc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= sq) continue;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
    const float inv = 1.f / l_safe;
    float* o = out + ((size_t)bh * sq + r) * D;
#pragma unroll
    for (int e = 0; e < E; ++e) o[tx + 16 * e] = acc[i][e] * inv;
    if (tx == 0) lse[(size_t)bh * sq + r] = m[i] + logf(l_safe);
  }
}

template <int D, bool CAUSAL>
cudaError_t launch(View q, View k, View v, float* out, float* lse, int batch,
                   int heads, int sq, int skv, float sm_scale,
                   cudaStream_t stream) {
  constexpr size_t smem = fwd_smem_bytes<D>();
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<D, CAUSAL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(batch * heads, flash::cdiv(sq, kTile));
  flash_fwd_kernel<D, CAUSAL><<<grid, kThreads, smem, stream>>>(
      q, k, v, out, lse, heads, sq, skv, sm_scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_d(View q, View k, View v, float* out, float* lse,
                     int batch, int heads, int sq, int skv, float sm_scale,
                     int causal, cudaStream_t stream) {
  return causal ? launch<D, true>(q, k, v, out, lse, batch, heads, sq, skv,
                                  sm_scale, stream)
                : launch<D, false>(q, k, v, out, lse, batch, heads, sq, skv,
                                   sm_scale, stream);
}

}  // namespace

// q (B, H, Sq, D), k and v (B, H, Skv, D): float32 with a contiguous,
// 16-byte aligned head_dim row and the given element strides.  out
// (B, H, Sq, D) and lse (B, H, Sq) are contiguous float32.  Launches on
// `stream`, does not synchronise, allocates nothing, and returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a head_dim
// other than 32, 64 or 128).
extern "C" int flash_attention_fwd_f32(FLASH_VIEW_ARGS(q), FLASH_VIEW_ARGS(k),
                                       FLASH_VIEW_ARGS(v), float* out,
                                       float* lse, int batch, int heads,
                                       int sq, int skv, int head_dim,
                                       float sm_scale, int causal,
                                       void* stream) {
  if (batch <= 0 || heads <= 0 || sq <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const View qv = FLASH_VIEW(q), kv = FLASH_VIEW(k), vv = FLASH_VIEW(v);
  switch (head_dim) {
    case 32:
      return (int)launch_d<32>(qv, kv, vv, out, lse, batch, heads, sq, skv,
                               sm_scale, causal, st);
    case 64:
      return (int)launch_d<64>(qv, kv, vv, out, lse, batch, heads, sq, skv,
                               sm_scale, causal, st);
    case 128:
      return (int)launch_d<128>(qv, kv, vv, out, lse, batch, heads, sq, skv,
                                sm_scale, causal, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_attention_fwd_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
