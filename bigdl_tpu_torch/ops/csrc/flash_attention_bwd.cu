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
//   flash_attention_bwd_dq_f32    one block per (b*h, 64-query tile): D for
//                                 its rows (written out for the second
//                                 kernel), then dq over the key tiles its
//                                 rows can see;
//   flash_attention_bwd_dkdv_f32  one block per (b*h, 64-key tile): dk and dv
//                                 over the query tiles that can see it (from
//                                 the diagonal down when causal).
// Each output element is summed by one thread in a fixed order: no float
// atomics, and two launches on the same inputs give the same bits.
//
// What bounds it: operations.  The least work is five 64 x 64 x D products
// per visible tile pair (2.5 times the forward's): 3.2e10 flops at the
// training shape (B 8, H 12, S 1024, D 64, causal) against about 200 MB of
// q, k, v, out, g, lse, dq, dk, dv.  On CUDA cores that is 0.48 ms at 67
// TFLOP/s; on the tensor cores in 3xTF32 (three TF32 products each) 0.195
// ms at 495 TFLOP/s, still far past the bytes' 0.06 ms.
//
// What the design does about it:
// - Tensor cores.  Every product (q k^T, g v^T, p^T g, ds^T q, ds k) is
//   mma.sync.m16n8k8 in TF32 with the 3xTF32 split (tf32x3.cuh): float32
//   accuracy, float32 accumulators.  A warp owns 16 rows of the block's
//   64-row tile and walks the other side 32 rows at a time.  The scores
//   come out of one product in the accumulator layout (row g, columns 2t,
//   2t + 1) and go into the next as its A operand; the next product's k
//   index is permuted to match (virtual k t is column 2t, t + 4 is 2t + 1)
//   and its B operand read from shared memory at the same permuted rows, so
//   p, ds and their transposes never leave registers: a transposed operand
//   is only a choice of addresses.  wgmma would need K-major copies of p^T
//   and ds^T (no transpose for 32-bit types) and is not used.  Each 32-row
//   half's tensor-core sums are added into float32 totals (head_dim <= 64;
//   at 128 the registers do not fit), so the tensor core's truncating adds
//   never see a long sum.
// - Shared memory, copied asynchronously.  The block's own tiles (q and g
//   for dq; k and v for dk/dv) are staged once; the other side comes in
//   32-row halves through a ring of two slots filled by cp.async, so the
//   next half loads while this one multiplies.  That is 70 KB at head_dim
//   64: three blocks (12 warps) an SM.  Rows are padded by 4 floats (pitch
//   D + 4), which keeps every fragment read, direct or permuted, free of
//   bank conflicts; rows past the sequence are zero-filled by cp.async
//   without a read.
// - The split into a q-side and a k-side kernel recomputes p and dp once
//   more (seven products per tile pair instead of five) in exchange for no
//   atomics and no cross-block reduction; on the tensor cores the extra two
//   products are cheap.  Causal halves wholly masked for a warp are
//   skipped.

#include "flash_attention_common.cuh"

namespace {

using namespace flash;
using namespace tf32x3;

template <int D>
__host__ __device__ constexpr int tile_floats() {
  return kRows * pitch<D>();
}

// one ring slot: a 32-row half of each of the other side's two operands
template <int D>
__host__ __device__ constexpr int slot_floats() {
  return 2 * kHalf * pitch<D>();
}

// Both kernels: the block's two own tiles, a ring of two slots, and two
// slots of two per-row vectors (dk/dv: lse and D of the query half; dq:
// lse and D of its own 64 rows use the first 128 floats)
template <int D>
constexpr size_t smem_bytes() {
  return (2 * (size_t)tile_floats<D>() + 2 * (size_t)slot_floats<D>() +
          2 * kRows) * sizeof(float);
}

// blocks an SM should hold: three at head_dim <= 64 (70 KB of shared
// memory, at most 168 registers a thread), one at 128
template <int D>
__host__ __device__ constexpr int min_blocks() {
  return D <= 64 ? 3 : 1;
}

// Whether a kernel keeps its tensor-core sums per 32-row half and adds
// each half into a float32 total (the tensor core's truncating adds then
// never see a long sum); at head_dim 128 the second set of registers does
// not fit.
template <int D>
__host__ __device__ constexpr bool split_sums() {
  return D <= 64;
}

template <int E, bool SPLIT>
__device__ __forceinline__ void fold(float (&sums)[E][4],
                                     float (&total)[SPLIT ? E : 1][4]) {
  if constexpr (SPLIT) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        total[e][i] += sums[e][i];
        sums[e][i] = 0.f;
      }
    }
  }
}

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads, min_blocks<D>())
flash_bwd_dq_kernel(View q, View k, View v, View o, View g,
                    const float* __restrict__ lse, float* __restrict__ delta,
                    float* __restrict__ dq, int heads, int sq, int skv,
                    float sm_scale) {
  constexpr int E = D / 8;   // 8-wide column tiles of a head
  constexpr int P = pitch<D>();
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Gs = Qs + tile_floats<D>();
  float* ring = Gs + tile_floats<D>();   // two slots of (k, v) halves
  float* lse_s = ring + 2 * slot_floats<D>();
  float* dl_s = lse_s + kRows;

  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int qt = gridDim.y - 1 - blockIdx.y;  // heaviest causal tiles first
  const int q0 = qt * kRows;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int wrow = 16 * warp;                 // the warp's rows in the tile

  // key halves 0 .. n_hk: causal, the tile's last query q0 + 63 sees up to
  // half (q0 + 63) / 32
  const int n_hk = CAUSAL ? min(flash::cdiv(skv, kHalf), (q0 + kRows) / kHalf)
                          : flash::cdiv(skv, kHalf);
  auto stage_half = [&](int hk, int slot) {
    float* kd = ring + slot * slot_floats<D>();
    stage_tile<D, kHalf>(kd, k, b, h, hk * kHalf, skv);
    stage_tile<D, kHalf>(kd + kHalf * P, v, b, h, hk * kHalf, skv);
  };

  stage_tile<D, kRows>(Qs, q, b, h, q0, sq);
  stage_tile<D, kRows>(Gs, g, b, h, q0, sq);
  stage_vec<kRows>(lse_s, lse + (size_t)bh * sq, q0, sq);
  if (n_hk > 0) stage_half(0, 0);
  cp_commit();
  cp_wait<0>();
  __syncthreads();

  // D = rowsum(g * out) of the warp's 16 rows, lanes over the head dim;
  // written out for the dk/dv kernel
  for (int i = 0; i < 16; ++i) {
    const int r = wrow + i;
    const bool ok = q0 + r < sq;
    float acc = 0.f;
    if (ok) {
      const float* orow = o.row(b, h, q0 + r);
      for (int d = lane; d < D; d += 32)
        acc = fmaf(Gs[r * P + d], orow[d], acc);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      dl_s[r] = acc;
      if (ok) delta[(size_t)bh * sq + q0 + r] = acc;
    }
  }
  __syncwarp();
  // this thread's two rows (g and g + 8 of the warp's 16)
  const float lse_r[2] = {lse_s[wrow + gq], lse_s[wrow + gq + 8]};
  const float dl_r[2] = {dl_s[wrow + gq], dl_s[wrow + gq + 8]};
  const int qrow[2] = {q0 + wrow + gq, q0 + wrow + gq + 8};

  constexpr bool SPLIT = split_sums<D>();
  // sums: this key half's tensor-core sums (all of them without SPLIT)
  float sums[E][4], total[SPLIT ? E : 1][4];
  zero(sums);
  zero(total);

  for (int hk = 0; hk < n_hk; ++hk) {
    const int slot = hk & 1;
    if (hk + 1 < n_hk) stage_half(hk + 1, slot ^ 1);   // its readers passed
    cp_commit();                                       // the last barrier
    cp_wait<1>();
    __syncthreads();
    const float* Kt = ring + slot * slot_floats<D>();
    const float* Vt = Kt + kHalf * P;
    const int kb = hk * kHalf;                // keys kb .. kb + 31

    // causal: skip a half wholly after the warp's last query
    if (!CAUSAL || kb <= q0 + wrow + 15) {
      float s[4][4], dp[4][4];
      zero(s);
      zero(dp);
#pragma unroll
      for (int ks = 0; ks < D / 8; ++ks) {
        const FragA aq = tile_a<D>(Qs, wrow, 8 * ks);
        const FragA ag = tile_a<D>(Gs, wrow, 8 * ks);
        FragB bk[4], bv[4];
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          bk[n] = tile_bt<D>(Kt, 8 * n, 8 * ks);
          bv[n] = tile_bt<D>(Vt, 8 * n, 8 * ks);
        }
        mma3(s, aq, bk);
        mma3(dp, ag, bv);
      }
      // ds = p (dp - D) sm_scale, in place of s
#pragma unroll
      for (int n = 0; n < 4; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = kb + 8 * n + 2 * tq + (i & 1);
          const int r = i >> 1;
          const float p = flash::visible<CAUSAL>(qrow[r], key, skv)
                              ? expf(s[n][i] * sm_scale - lse_r[r])
                              : 0.f;
          s[n][i] = p * (dp[n][i] - dl_r[r]) * sm_scale;
        }
      }
      // dq += ds k: the 32 keys are the k index, in four permuted steps
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const FragA a = acc_a(s[n]);
#pragma unroll
        for (int e0 = 0; e0 < E; e0 += 4) {
          FragB bk[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            bk[e] = tile_b_perm<D>(Kt, 8 * n, 8 * (e0 + e));
          mma3(four(sums, e0), a, bk);
        }
      }
      fold<E, SPLIT>(sums, total);
    }
    __syncthreads();   // slot `slot` is free for half hk + 2
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qrow[r] >= sq) continue;
    float* out = dq + ((size_t)bh * sq + qrow[r]) * D;
    if constexpr (SPLIT)
      store_row<E>(out, total, r);
    else
      store_row<E>(out, sums, r);
  }
}

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads, min_blocks<D>())
flash_bwd_dkdv_kernel(View q, View k, View v, View g,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      float* __restrict__ dk, float* __restrict__ dv,
                      int heads, int sq, int skv, float sm_scale) {
  constexpr int E = D / 8;
  constexpr int P = pitch<D>();
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + tile_floats<D>();
  float* ring = Vs + tile_floats<D>();      // two slots of (q, g) halves
  float* lse_s = ring + 2 * slot_floats<D>();  // two slots of 32
  float* dl_s = lse_s + 2 * kHalf;             // two slots of 32

  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int kt = blockIdx.y;  // causal: low key tiles see the most queries
  const int k0 = kt * kRows;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int wrow = 16 * warp;
  const int key[2] = {k0 + wrow + gq, k0 + wrow + gq + 8};

  // query halves hq0 .. n_hq: causal, queries before k0 see no key here
  const int n_hq = flash::cdiv(sq, kHalf);
  const int hq0 = CAUSAL ? min(k0 / kHalf, n_hq) : 0;
  auto stage_half = [&](int hq, int slot) {
    const int q0 = hq * kHalf;
    float* qd = ring + slot * slot_floats<D>();
    stage_tile<D, kHalf>(qd, q, b, h, q0, sq);
    stage_tile<D, kHalf>(qd + kHalf * P, g, b, h, q0, sq);
    stage_vec<kHalf>(lse_s + slot * kHalf, lse + (size_t)bh * sq, q0, sq);
    stage_vec<kHalf>(dl_s + slot * kHalf, delta + (size_t)bh * sq, q0, sq);
  };

  stage_tile<D, kRows>(Ks, k, b, h, k0, skv);
  stage_tile<D, kRows>(Vs, v, b, h, k0, skv);
  if (hq0 < n_hq) stage_half(hq0, 0);
  cp_commit();

  constexpr bool SPLIT = split_sums<D>();
  // this half's tensor-core sums (all of them without SPLIT), and the
  // float32 totals
  float dk_acc[E][4], dv_acc[E][4];
  float dk_tot[SPLIT ? E : 1][4], dv_tot[SPLIT ? E : 1][4];
  zero(dk_acc);
  zero(dv_acc);
  zero(dk_tot);
  zero(dv_tot);

  for (int hq = hq0; hq < n_hq; ++hq) {
    const int slot = (hq - hq0) & 1;
    if (hq + 1 < n_hq) stage_half(hq + 1, slot ^ 1);   // its readers passed
    cp_commit();                                       // the last barrier
    cp_wait<1>();
    __syncthreads();
    const float* Qt = ring + slot * slot_floats<D>();
    const float* Gt = Qt + kHalf * P;
    const float* lse_t = lse_s + slot * kHalf;
    const float* dl_t = dl_s + slot * kHalf;
    const int qb = hq * kHalf;                // queries qb .. qb + 31

    // causal: skip a half wholly before the warp's first key
    if (!CAUSAL || qb + kHalf - 1 >= k0 + wrow) {
      // transposed scores: row = key (the warp's 16), column = query
      float st[4][4], dpt[4][4];
      zero(st);
      zero(dpt);
#pragma unroll
      for (int ks = 0; ks < D / 8; ++ks) {
        const FragA ak = tile_a<D>(Ks, wrow, 8 * ks);
        const FragA av = tile_a<D>(Vs, wrow, 8 * ks);
        FragB bq[4], bg[4];
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          bq[n] = tile_bt<D>(Qt, 8 * n, 8 * ks);
          bg[n] = tile_bt<D>(Gt, 8 * n, 8 * ks);
        }
        mma3(st, ak, bq);
        mma3(dpt, av, bg);
      }
      // p^T in st, ds^T in dpt
#pragma unroll
      for (int n = 0; n < 4; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int ql = 8 * n + 2 * tq + (i & 1);   // row in the half
          const int qp = qb + ql;
          const bool ok = qp < sq && flash::visible<CAUSAL>(qp, key[i >> 1],
                                                            skv);
          const float p = ok ? expf(st[n][i] * sm_scale - lse_t[ql]) : 0.f;
          st[n][i] = p;
          dpt[n][i] = p * (dpt[n][i] - dl_t[ql]) * sm_scale;
        }
      }
      // dv += p^T g and dk += ds^T q: the 32 queries are the k index
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const FragA ap = acc_a(st[n]);
        const FragA ads = acc_a(dpt[n]);
#pragma unroll
        for (int e0 = 0; e0 < E; e0 += 4) {
          FragB bg[4], bq[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            bg[e] = tile_b_perm<D>(Gt, 8 * n, 8 * (e0 + e));
            bq[e] = tile_b_perm<D>(Qt, 8 * n, 8 * (e0 + e));
          }
          mma3(four(dv_acc, e0), ap, bg);
          mma3(four(dk_acc, e0), ads, bq);
        }
      }
      fold<E, SPLIT>(dk_acc, dk_tot);
      fold<E, SPLIT>(dv_acc, dv_tot);
    }
    __syncthreads();   // slot `slot` is free for half hq + 2
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (key[r] >= skv) continue;
    const size_t off = ((size_t)bh * skv + key[r]) * D;
    if constexpr (SPLIT) {
      store_row<E>(dk + off, dk_tot, r);
      store_row<E>(dv + off, dv_tot, r);
    } else {
      store_row<E>(dk + off, dk_acc, r);
      store_row<E>(dv + off, dv_acc, r);
    }
  }
}

template <int D, bool CAUSAL>
cudaError_t launch_dq(View q, View k, View v, View o, View g,
                      const float* lse, float* delta, float* dq, int batch,
                      int heads, int sq, int skv, float sm_scale,
                      cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  const cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D, CAUSAL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(batch * heads, flash::cdiv(sq, kRows));
  flash_bwd_dq_kernel<D, CAUSAL><<<grid, kThreads, smem, stream>>>(
      q, k, v, o, g, lse, delta, dq, heads, sq, skv, sm_scale);
  return cudaGetLastError();
}

template <int D, bool CAUSAL>
cudaError_t launch_dkdv(View q, View k, View v, View g, const float* lse,
                        const float* delta, float* dk, float* dv, int batch,
                        int heads, int sq, int skv, float sm_scale,
                        cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  const cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<D, CAUSAL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(batch * heads, flash::cdiv(skv, kRows));
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
