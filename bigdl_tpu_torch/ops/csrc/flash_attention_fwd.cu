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
// What bounds it: operations.  A call does 4 * D flops per visible (query,
// key) pair and reads each of q, k, v once at the least: at the training
// shape (B 8, H 12, S 1024, D 64, causal) that is 1.3e10 flops against 100
// MB.  On the tensor cores in 3xTF32 (three TF32 products for each float32
// one) that is 0.078 ms at 495 TFLOP/s, still past the bytes' 0.03 ms; on
// CUDA cores it would be 0.19 ms at 67 TFLOP/s.
//
// What the design does about it (the backward's tiles, flash_attention_bwd.cu
// and flash_attention_common.cuh):
// - Tensor cores.  Both products, q k^T and p v, are mma.sync.m16n8k8 in
//   TF32 with the 3xTF32 split (tf32x3.cuh): float32 accuracy, float32
//   accumulators.  One block per (b*h, 64-query tile), the tiles with the
//   most keys launched first; each of 4 warps owns 16 query rows.
// - q is staged once, scaled by sm_scale (as the TPU kernel scales q) times
//   log2(e), and split once in shared memory into its hi and lo TF32 parts;
//   a warp reads its A fragments from there for every key half (two shared
//   loads a value, no arithmetic), which leaves its registers to the output
//   sums.  The scores are then in base 2: the softmax takes exp2f (measured
//   faster than expf on the card), and lse is converted back to base e once
//   a row.  q's fragments kept in registers instead measured slower (they
//   cost the third block an SM), and so did separate sums for the small
//   and the large products of the split (more independent mma chains, but
//   the registers again); for q k^T alone they were no faster.
// - Online softmax in the accumulator layout.  A thread holds rows g and
//   g + 8 of its warp's 16 and columns 2t, 2t + 1 of each 8-key step; a
//   row's max takes two quad shuffles, its denominator is summed per thread
//   and across the quad once at the end.  The running max starts at the TPU
//   kernel's -1e30.  32-key halves measured faster than 64-key ones (more
//   registers for the sums, two blocks an SM instead of three).
// - p stays in registers: it feeds p v as the A operand with the k index
//   permuted to the accumulator layout, and V's rows are read from shared
//   memory at the permuted rows.  Each key half's p v goes into its own
//   tensor-core sums, which are added into float32 totals (times the
//   rescale), so the tensor core's truncating adds never see a long sum.
// - K and V come in 32-row halves through a two-slot cp.async ring, the
//   next half loading while this one multiplies; rows past Skv are
//   zero-filled without a read.  70 KB of shared memory at head_dim 64:
//   three blocks (12 warps) an SM; one at head_dim 128.
// - Causal: key halves wholly after a warp's last query are skipped, and
//   only the halves on the diagonal (and a ragged last half) are masked.
// - No atomics: every output element is summed by one thread in a fixed
//   order, and two launches give the same bits.
// - Not used: wgmma.  Its tf32 operands must be K-major in shared memory,
//   so p v would need a transposed copy of every V half (there is no
//   transpose for 32-bit types), and p would leave registers; that is left
//   to a later change.

#include "flash_attention_common.cuh"

namespace {

using namespace flash;
using namespace tf32x3;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// q's hi and lo tiles, and a ring of two slots of (k, v) halves
template <int D>
constexpr size_t fwd_smem_bytes() {
  return (2 * (size_t)kRows + 4 * (size_t)kHalf) * pitch<D>() *
         sizeof(float);
}

// blocks an SM should hold: three at head_dim <= 64 (at most 168 registers
// a thread), one at 128 (135 KB of shared memory)
template <int D>
__host__ __device__ constexpr int fwd_min_blocks() {
  return D <= 64 ? 3 : 1;
}

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads, fwd_min_blocks<D>())
flash_fwd_kernel(View q, View k, View v, float* __restrict__ out,
                 float* __restrict__ lse, int heads, int sq, int skv,
                 float sm_scale) {
  constexpr int E = D / 8;  // 8-wide column tiles of a head
  constexpr int P = pitch<D>();
  extern __shared__ __align__(16) float smem[];
  float* Qh = smem;             // q * sm_scale rounded to TF32
  float* Ql = Qh + kRows * P;   // q * sm_scale - Qh
  float* ring = Ql + kRows * P;

  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int qt = gridDim.y - 1 - blockIdx.y;  // heaviest causal tiles first
  const int q0 = qt * kRows;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int wrow = 16 * warp;                 // the warp's rows in the tile
  const int qrow[2] = {q0 + wrow + gq, q0 + wrow + gq + 8};

  constexpr int NS = kHalf / 8;   // 8-key steps of a half
  // key halves 0 .. n_hk: causal, the tile's last query q0 + 63 sees up to
  // half (q0 + 63) / 32
  const int n_hk = CAUSAL ? min(cdiv(skv, kHalf), (q0 + kRows) / kHalf)
                          : cdiv(skv, kHalf);
  auto stage_half = [&](int hk, int slot) {
    float* kd = ring + slot * 2 * kHalf * P;
    stage_tile<D, kHalf>(kd, k, b, h, hk * kHalf, skv);
    stage_tile<D, kHalf>(kd + kHalf * P, v, b, h, hk * kHalf, skv);
  };

  stage_tile<D, kRows>(Qh, q, b, h, q0, sq);
  if (n_hk > 0) stage_half(0, 0);
  cp_commit();
  cp_wait<0>();
  __syncthreads();
  // q * sm_scale split once; the loop's first barrier orders these writes
  // before any fragment read
  for (int i = threadIdx.x; i < kRows * D; i += kThreads) {
    const int r = i / D;
    const int o = r * P + (i - r * D);
    const Split s = split(Qh[o] * (sm_scale * kLog2e));
    Qh[o] = __uint_as_float(s.hi);
    Ql[o] = __uint_as_float(s.lo);
  }

  // running max and this thread's share of the denominator, rows g, g + 8
  float m_r[2] = {kNegInf, kNegInf};
  float l_r[2] = {0.f, 0.f};
  float o_tot[E][4];   // float32 totals of p v
  zero(o_tot);

  for (int hk = 0; hk < n_hk; ++hk) {
    const int slot = hk & 1;
    if (hk + 1 < n_hk) stage_half(hk + 1, slot ^ 1);   // its readers passed
    cp_commit();                                       // the last barrier
    cp_wait<1>();
    __syncthreads();
    const float* Kt = ring + slot * 2 * kHalf * P;
    const float* Vt = Kt + kHalf * P;
    const int kb = hk * kHalf;                // keys kb .. kb + 31

    // causal: skip a half wholly after the warp's last query
    if (!CAUSAL || kb <= q0 + wrow + 15) {
      float s[NS][4];
      zero(s);
#pragma unroll
      for (int ks = 0; ks < D / 8; ++ks) {
        FragA aq;
        const int o0 = (wrow + gq) * P + 8 * ks + tq;
        const int offs[4] = {o0, o0 + 8 * P, o0 + 4, o0 + 8 * P + 4};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          aq.hi[i] = __float_as_uint(Qh[offs[i]]);
          aq.lo[i] = __float_as_uint(Ql[offs[i]]);
        }
        FragB bk[NS];
#pragma unroll
        for (int n = 0; n < NS; ++n) bk[n] = tile_bt<D>(Kt, 8 * n, 8 * ks);
        mma3(s, aq, bk);
      }

      // only a half on the diagonal or past skv has invisible keys
      const bool edge =
          kb + kHalf > skv || (CAUSAL && kb + kHalf - 1 > q0 + wrow);
      float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (edge && !visible<CAUSAL>(qrow[i >> 1],
                                       kb + 8 * n + 2 * tq + (i & 1), skv))
            s[n][i] = kNegInf;
          mx[i >> 1] = fmaxf(mx[i >> 1], s[n][i]);
        }
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = exp2f(m_r[r] - mx[r]);
        m_r[r] = mx[r];
        l_r[r] *= alpha[r];
      }
      // p in place of s
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = s[n][i] == kNegInf ? 0.f
                                             : exp2f(s[n][i] - mx[i >> 1]);
          s[n][i] = p;
          l_r[i >> 1] += p;
        }
      }

      // this half's p v: the 32 keys are the k index, in four permuted steps
      float o_half[E][4];
      zero(o_half);
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const FragA a = acc_a(s[n]);
#pragma unroll
        for (int e0 = 0; e0 < E; e0 += 4) {
          FragB bv[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            bv[e] = tile_b_perm<D>(Vt, 8 * n, 8 * (e0 + e));
          mma3(four(o_half, e0), a, bv);
        }
      }
#pragma unroll
      for (int e = 0; e < E; ++e) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          o_tot[e][i] = fmaf(o_tot[e][i], alpha[i >> 1], o_half[e][i]);
      }
    }
    __syncthreads();   // slot `slot` is free for half hk + 2
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r] + __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    if (qrow[r] >= sq) continue;
    const float l_safe = l == 0.f ? 1.f : l;
    store_row<E>(out + ((size_t)bh * sq + qrow[r]) * D, o_tot, r,
                 1.f / l_safe);
    if (tq == 0)
      lse[(size_t)bh * sq + qrow[r]] = m_r[r] * kLn2 + logf(l_safe);
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
  const dim3 grid(batch * heads, cdiv(sq, kRows));
  flash_fwd_kernel<D, CAUSAL><<<grid, kThreads, smem, stream>>>(
      q, k, v, out, lse, heads, sq, skv, sm_scale);
  return cudaGetLastError();
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
#define FLASH_FWD(D_)                                                       \
  return (int)(causal ? launch<D_, true>(qv, kv, vv, out, lse, batch, heads, \
                                         sq, skv, sm_scale, st)             \
                      : launch<D_, false>(qv, kv, vv, out, lse, batch,      \
                                          heads, sq, skv, sm_scale, st))
  switch (head_dim) {
    case 32: FLASH_FWD(32);
    case 64: FLASH_FWD(64);
    case 128: FLASH_FWD(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef FLASH_FWD
}

extern "C" const char* flash_attention_fwd_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
