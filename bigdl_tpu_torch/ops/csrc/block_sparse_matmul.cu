// Block-sparse matrix product, float32 and bfloat16, for Hopper (sm_90a).
//
// Replaces bigdl_tpu/ops/block_sparse.py: _bs_matmul_raw, whose Pallas
// kernel (_bs_kernel) walks only the nonzero k-blocks of each output column
// block through a scalar-prefetched per-column index list.  It computes
//
//   out (M, N) = x (M, K) @ (w (K, N) masked to the kept (block_k, block_n)
//                blocks)
//
// from the column plan of the block mask: counts[j], the number of kept
// k-blocks of column block j, and idx[j, 0 .. counts[j]), their indices in
// increasing order.  Pruned blocks are never read and never multiplied.
// The backward's dx is this kernel on the transposed problem (the caller
// passes w^T and the plan of the transposed mask).
//
// The bfloat16 instance (block_sparse_matmul_bf16; namespace wg, after the
// float32 kernel) is the Pallas kernel on the bfloat16 operands that
// BlockSparseLinear casts under the JAX package's compute dtype
// (bigdl_tpu/ops/block_sparse.py:314-318): float32 sums, each output
// rounded once to bfloat16 (_bsmm's astype(x.dtype), :157-158).  It is
// bound by the bytes of the kept blocks, 2 (M K + K N density + M N) over
// HBM's 3.35 TB/s, at the draft's shapes both ways: the dense product of
// the zero-filled tiles that it computes, 2 M K N flops over 989 TFLOP/s,
// takes 1.2 us at M = 256, under the 1.29 us of the bytes.  What its
// design does about that:
// - wgmma with the output columns as the 64-row side: out^T = (w masked)^T
//   x^T, so a decode step (M <= 16) is wgmma n = 16, not a 64-row tile
//   three quarters empty.  w's chunk is the MN-major A operand (the
//   transpose bit), x's the K-major B; both in the 128-byte swizzle.
// - Only the kept bytes of w are read: a producer warpgroup copies w 16
//   bytes at a time with cp.async straight into the swizzled layout,
//   source size 0 (zeros, no read) where the row mask drops the row.  The
//   row masks, one 64-bit word per (64-row chunk, column block), are built
//   once on the host with the column plan (ColumnPlan.on), not by every
//   block at every launch; a block loads its words together, once, while
//   its first chunks of x are already in flight.
// - Few serial steps: a split's chunks each get a stage of their own where
//   they fit (up to 12 for a decode step's 16-row tile), so every copy goes
//   out at once and the wgmmas follow the chunks as they land, summing in
//   the wgmma accumulator (at most 768 terms); longer walks run a ring,
//   each chunk's tensor-core sum added into a float32 total.  The wgmmas
//   sit in a warp-uniform branch with the barrier waits' loops in the PTX,
//   and nothing touches the accumulator while they run: otherwise ptxas
//   serialises them (C7518, C7514).
// - Split K to fill the card: a product of fewer tiles than SMs (the
//   draft's l2 at M = 16 has 12) splits K into runs of whole chunks
//   (ops.block_sparse.bf16_plan).  Each split writes float32 partials to a
//   workspace; the tile's last split to arrive (a counter per tile, set
//   back to 0 by that split) adds them in split order and rounds once:
//   one launch, no float atomics, the same bits every launch and replay.
// - 16-byte stores from a staged tile.
// Shapes whose rows wgmma's copies cannot take whole (K, N or block_n not
// a multiple of 8, x or w not 16-byte aligned) run the mma.sync kernel
// below the float32 one: m16n8k16 bf16 mma.sync on the float32 kernel's
// walk, row masks built in the block from the kept lists.
//
// The float32 kernel.  What bounds it, by both peaks (2 M K N density
// flops, 4 (M K + K N density + M N) bytes): at the draft's decode shapes
// (M = 16) the bytes of the kept weight blocks over HBM's 3.35 TB/s; at
// M = 256 the operations, which on the tensor cores in 3xTF32 cost three
// TF32 products each, 3 x flops over 495 TFLOP/s (against flops over 67
// TFLOP/s on CUDA cores).
//
// What the design does about it:
// - Tensor cores.  Every product is mma.sync.m16n8k8 in TF32 with the
//   3xTF32 split (tf32x3.cuh): float32 accuracy, float32 accumulators.  A
//   warp owns a tile of rows x 8-column n-tiles; an (8, 8) block is one
//   8-deep k-step of one n-tile, larger blocks are walked as 8-deep steps,
//   and a k-step no column of an n-tile keeps is skipped.  Each 64-row
//   chunk's tensor-core sums are added into a float32 total, so the
//   tensor core's truncating adds never see a long sum.
// - Shared memory, copied asynchronously.  A block owns BM rows x GW
//   columns and walks K in chunks of 64 rows through a ring of STAGES
//   buffers filled by cp.async: the x chunk (rows that some column block of
//   the tile keeps) and the w chunk, whose pruned blocks are zero-filled by
//   cp.async without a read.  Which rows a column block keeps in each chunk
//   is a 64-bit mask, built once per block from the kept lists by all its
//   threads (integer ORs in shared memory), so any block shape works: block
//   rows past a block's end, the ragged last k-block and column block,
//   rows past M and columns past N are zeros in shared memory, never read
//   out of bounds.  Rows are padded by 4 (x) and 8 (w) floats, which keeps
//   the fragment reads free of bank conflicts.  Rows and columns are copied
//   16 bytes at a time from fixed per-thread offsets where K, N and block_n
//   are multiples of 4 and x and w are 16-byte aligned, 4 bytes otherwise.
// - M <= 16 (bytes): tiles of 16 rows x 8 columns, so a 3072-column
//   product has 384 blocks and a 768-column one 96; the 4 warps split each
//   chunk's eight k-steps, and eight stages keep seven chunks in flight a
//   block.  M > 16 (operations): tiles of 32 x 16, warps 2 over rows x 2
//   over k-steps, three stages.  Narrow tiles beat wide ones on the card:
//   more blocks in flight outweigh x re-read from L2 by each column tile.
// - Determinism.  The warps' partial sums over k-steps are added in shared
//   memory in a fixed order; no float atomics, so two launches give the
//   same bits.

#include <cuda_bf16.h>

#include "tf32x3.cuh"

namespace {

using namespace tf32x3;

constexpr int kThreads = 128;  // 4 warps
constexpr int kKC = 64;        // K rows a chunk: 8 k-steps of 8
constexpr int kXP = kKC + 4;   // x tile row pitch (floats)
constexpr int kPer = 8;        // list entries a thread loads at once

// BM x GW tile; warps WR (rows) x WC (columns) x WK (k-steps of a chunk)
template <int BM, int GW, int WR, int WC, int WK, int STAGES>
struct Cfg {
  static_assert(WR * WC * WK == kThreads / 32, "4 warps");
  static constexpr int kMT = BM / WR / 16;   // m-tiles a warp
  static constexpr int kNT = GW / WC / 8;    // n-tiles a warp
  static constexpr int kWP = GW + 8;         // w tile row pitch (floats)
  static constexpr int kXF = BM * kXP;       // floats of an x stage
  static constexpr int kWF = kKC * kWP;      // floats of a w stage
  // the stages, then per chunk a 64-bit row mask per column block and
  // their union; a tile of GW columns touches at most (GW - 1) / bn + 2
  // column blocks
  static size_t smem_bytes(int nchunks, int bn) {
    const int max_g = (GW - 1) / bn + 2;
    return (size_t)STAGES * (kXF + kWF) * sizeof(float) +
           (size_t)nchunks * (max_g + 1) * sizeof(unsigned long long);
  }
  static_assert(kMT >= 1 && kNT >= 1, "warp tile");
  static_assert((WK - 1) * WR * WC * kMT * kNT * 4 * 32 <=
                    STAGES * (kXF + kWF),
                "the k-step reduction reuses the stage buffers");
};

// bits [a, b) of a 64-bit mask, 0 <= a < b <= 64
__device__ __forceinline__ unsigned long long bit_range(int a, int b) {
  const unsigned long long m = b - a == 64 ? ~0ull : (1ull << (b - a)) - 1;
  return m << a;
}

// bit i set where byte i of m is nonzero: the 8-row k-steps a chunk's
// 64-bit row mask touches
__device__ __forceinline__ unsigned step_bits(unsigned long long m) {
  const unsigned a = __vcmpne4((unsigned)m, 0u) & 0x01010101u;
  const unsigned b = __vcmpne4((unsigned)(m >> 32), 0u) & 0x01010101u;
  return ((a * 0x01020408u) >> 24) | (((b * 0x01020408u) >> 24) << 4);
}

// Which rows of each 64-row chunk each column block j0 .. j0 + G - 1 of a
// tile keeps: masks[c * (G + 1) + j] for chunk c, and their union at
// masks[c * (G + 1) + G].  One 64-bit mask per (chunk, column block), built
// once from the kept lists (idx rows j0 .. j0 + G are contiguous), kPer
// entries a thread loaded at once; integer ORs in shared memory, so the
// order does not matter.  All kThreads threads of the block call it.
__device__ __forceinline__ void build_row_masks(
    unsigned long long* masks, const int* __restrict__ counts,
    const int* __restrict__ idx, int max_count, int j0, int G, int nchunks,
    int K, int bk) {
  const int tid = threadIdx.x, GS = G + 1;
  for (int i = tid; i < nchunks * GS; i += kThreads) masks[i] = 0;
  __syncthreads();
  const int n_entries = G * max_count;
  const int* lists = idx + (size_t)j0 * max_count;
  for (int base = 0; base < n_entries; base += kThreads * kPer) {
    int kb[kPer], cnt[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int e = base + u * kThreads + tid;
      const bool in = e < n_entries;
      kb[u] = in ? __ldg(lists + e) : 0;
      cnt[u] = in ? __ldg(counts + j0 + e / max_count) : 0;
    }
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int e = base + u * kThreads + tid;
      const int j = e / max_count;
      if (e >= n_entries || e - j * max_count >= cnt[u]) continue;
      const int hi = min(kb[u] * bk + bk, K);
      for (int r = kb[u] * bk; r < hi;) {   // the block, chunk by chunk
        const int c = r / kKC;
        const int e_row = min(hi, (c + 1) * kKC);
        atomicOr(masks + c * GS + j, bit_range(r - c * kKC, e_row - c * kKC));
        r = e_row;
      }
    }
  }
  __syncthreads();

  for (int c = tid; c < nchunks; c += kThreads) {
    unsigned long long u = 0;
    for (int j = 0; j < G; ++j) u |= masks[c * GS + j];
    masks[c * GS + G] = u;
  }
  __syncthreads();
}

template <int BM, int GW, int WR, int WC, int WK, int STAGES, bool VEC>
__global__ void __launch_bounds__(kThreads)
block_sparse_matmul_kernel(const float* __restrict__ x,
                           const float* __restrict__ w,
                           const int* __restrict__ counts,
                           const int* __restrict__ idx, int max_count,
                           float* __restrict__ out, int M, int K, int N,
                           int bk, int bn, int row_tiles) {
  using C = Cfg<BM, GW, WR, WC, WK, STAGES>;
  constexpr int MT = C::kMT, NT = C::kNT, WP = C::kWP;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                        // STAGES x BM x kXP
  float* ws = xs + STAGES * C::kXF;        // STAGES x kKC x WP
  unsigned long long* masks =              // nchunks x (G + 1) row masks
      reinterpret_cast<unsigned long long*>(ws + STAGES * C::kWF);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp % WR, wc = (warp / WR) % WC, wk = warp / (WR * WC);
  const int rt = blockIdx.x % row_tiles;   // neighbours share a w tile
  const int m0 = rt * BM, n0 = (blockIdx.x / row_tiles) * GW;
  const int j0 = n0 / bn;
  const int G = (min(n0 + GW, N) - 1) / bn + 1 - j0;   // column blocks
  const int rbase = wr * (BM / WR), cbase = wc * (GW / WC);
  const int nchunks = (K + kKC - 1) / kKC;
  const int GS = G + 1;   // masks of a chunk: G column blocks, their union

  // Which rows of each chunk each column block of the tile keeps
  build_row_masks(masks, counts, idx, max_count, j0, G, nchunks, K, bk);

  // This thread's copies, fixed for every chunk (16-byte path): x rows
  // xr0 + 8 i at chunk column xk; w chunk rows wr0 + kWRows i at tile
  // column wcol, in relative column block wj.
  constexpr int kXI = BM / 8, kWQ = GW / 4, kWRows = kThreads / kWQ;
  constexpr int kWI = kKC / kWRows;
  const int xk = (tid & 15) * 4, xr0 = tid >> 4;
  const float* xsrc = x + (size_t)(m0 + xr0) * K + xk;
  unsigned xrows_ok = 0;
#pragma unroll
  for (int i = 0; i < kXI; ++i)
    xrows_ok |= (m0 + xr0 + 8 * i < M ? 1u : 0u) << i;
  const int wcol = (tid % kWQ) * 4, wr0 = tid / kWQ;
  const bool wcol_ok = n0 + wcol < N;
  const int wj = wcol_ok ? (n0 + wcol) / bn - j0 : 0;
  const float* wsrc = w + n0 + wcol;

  // Issue chunk c into stage c % STAGES and commit one cp.async group
  // (an empty one past the last chunk).  The stage's last readers finished
  // before the barrier that ended the previous iteration.
  auto issue = [&](int c) {
    if (c < nchunks) {
      const int s = c % STAGES, c0 = c * kKC;
      const unsigned long long* ms = masks + c * GS;
      const unsigned long long any = ms[G];   // rows some block keeps
      float* xd = xs + s * C::kXF;
      float* wd = ws + s * C::kWF;
      if (VEC) {
        const bool kok = c0 + xk < K && ((any >> xk) & 0xF);
#pragma unroll
        for (int i = 0; i < kXI; ++i) {
          const bool ok = kok && ((xrows_ok >> i) & 1u);
          cp_async16(xd + (xr0 + 8 * i) * kXP + xk,
                     ok ? xsrc + (size_t)8 * i * K + c0 : x, ok);
        }
        const unsigned long long mj = wcol_ok ? ms[wj] : 0ull;
#pragma unroll
        for (int i = 0; i < kWI; ++i) {
          const int k = wr0 + kWRows * i;
          const bool ok = c0 + k < K && ((mj >> k) & 1ull);
          cp_async16(wd + k * WP + wcol,
                     ok ? wsrc + (size_t)(c0 + k) * N : w, ok);
        }
      } else {
        for (int e = tid; e < BM * kKC; e += kThreads) {
          const int r = e / kKC, k = e % kKC;
          const bool ok = m0 + r < M && c0 + k < K && ((any >> k) & 1);
          cp_async4(xd + r * kXP + k,
                    ok ? x + (size_t)(m0 + r) * K + c0 + k : x, ok);
        }
        for (int e = tid; e < kKC * GW; e += kThreads) {
          const int k = e / GW, c = e % GW;
          const int n = n0 + c;
          const bool ok = c0 + k < K && n < N &&
                          ((ms[n / bn - j0] >> k) & 1);
          cp_async4(wd + k * WP + c, ok ? w + (size_t)(c0 + k) * N + n : w,
                    ok);
        }
      }
    }
    cp_commit();
  };

  // the relative column blocks [jlo, jhi] each of the warp's n-tiles
  // touches (none past N)
  int jlo[NT], jhi[NT];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int nlo = n0 + cbase + 8 * nt;
    jlo[nt] = nlo / bn - j0;
    jhi[nt] = nlo < N ? min(nlo + 7, N - 1) / bn - j0 : jlo[nt] - 1;
  }

  // acc: the float32 total; part: one chunk's tensor-core sums
  float acc[MT][NT][4], part[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
    }
  }

  for (int c = 0; c < STAGES - 1; ++c) issue(c);
  for (int c = 0; c < nchunks; ++c) {
    issue(c + STAGES - 1);
    cp_wait<STAGES - 1>();   // chunk c has landed (this thread's copies)
    __syncthreads();         // ... and every thread's
    const int s = c % STAGES;
    const unsigned long long* ms = masks + c * GS;
    const float* xd = xs + s * C::kXF;
    const float* wd = ws + s * C::kWF;
    // the k-steps each n-tile needs: 8 bits, one per 8 rows of the chunk
    unsigned ntm[NT];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      unsigned long long m = 0;
      for (int j = jlo[nt]; j <= jhi[nt]; ++j) m |= ms[j];
      ntm[nt] = step_bits(m);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) part[mt][nt][i] = 0.f;
      }
    }
    for (int st = wk; st < 8; st += WK) {
      unsigned need = 0;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) need |= ((ntm[nt] >> st) & 1u) << nt;
      if (!need) continue;
      FragA a[MT];
      FragB b[NT];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const float* xr = xd + (rbase + 16 * mt + g) * kXP + 8 * st + t;
        a[mt] = frag_a(xr[0], xr[8 * kXP], xr[4], xr[8 * kXP + 4]);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if (!((need >> nt) & 1u)) continue;
        const float* wc = wd + (8 * st + t) * WP + cbase + 8 * nt + g;
        b[nt] = frag_b(wc[0], wc[4 * WP]);
      }
      // three passes over the independent (m-tile, n-tile) sums
#pragma unroll
      for (int pass = 0; pass < 3; ++pass) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if (m0 + rbase + 16 * mt >= M) continue;   // rows past M
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            if (!((need >> nt) & 1u)) continue;
            if (pass == 0) mma(part[mt][nt], a[mt].lo, b[nt].hi);
            if (pass == 1) mma(part[mt][nt], a[mt].hi, b[nt].lo);
            if (pass == 2) mma(part[mt][nt], a[mt].hi, b[nt].hi);
          }
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] += part[mt][nt][i];
      }
    }
    __syncthreads();   // stage s is free for chunk c + STAGES
  }

  // Warps that took other k-steps of the same output tile add their sums
  // to warp wk = 0's in a fixed order, through the (now idle) stage buffers.
  if (WK > 1) {
    cp_wait<0>();
    __syncthreads();
    constexpr int kTile = MT * NT * 4 * 32;
    const int wrc = warp % (WR * WC);
    if (wk > 0) {
      float* red = smem + ((wk - 1) * WR * WC + wrc) * kTile;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            red[((mt * NT + nt) * 4 + i) * 32 + lane] = acc[mt][nt][i];
        }
      }
    }
    __syncthreads();
    if (wk > 0) return;
    for (int q = 1; q < WK; ++q) {
      const float* red = smem + ((q - 1) * WR * WC + wrc) * kTile;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            acc[mt][nt][i] += red[((mt * NT + nt) * 4 + i) * 32 + lane];
        }
      }
    }
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = m0 + rbase + 16 * mt + g + (i >> 1) * 8;
        const int col = n0 + cbase + 8 * nt + 2 * t + (i & 1);
        if (row < M && col < N) out[(size_t)row * N + col] = acc[mt][nt][i];
      }
    }
  }
}

template <int BM, int GW, int WR, int WC, int WK, int STAGES, bool VEC>
int launch(const float* x, const float* w, const int* counts, const int* idx,
           int max_count, float* out, int M, int K, int N, int bk, int bn,
           cudaStream_t stream) {
  using C = Cfg<BM, GW, WR, WC, WK, STAGES>;
  auto* kernel = block_sparse_matmul_kernel<BM, GW, WR, WC, WK, STAGES, VEC>;
  const size_t smem = C::smem_bytes((K + kKC - 1) / kKC, bn);
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long row_tiles = (M + BM - 1) / BM;
  const long long blocks = row_tiles * ((N + GW - 1) / GW);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      x, w, counts, idx, max_count, out, M, K, N, bk, bn, (int)row_tiles);
  return (int)cudaGetLastError();
}

template <bool VEC>
int dispatch(const float* x, const float* w, const int* counts,
             const int* idx, int max_count, float* out, int M, int K, int N,
             int bk, int bn, cudaStream_t s) {
  if (M <= 16)   // decode: bytes-bound, many small tiles, k-steps split
    return launch<16, 8, 1, 1, 4, 8, VEC>(x, w, counts, idx, max_count, out,
                                           M, K, N, bk, bn, s);
  return launch<32, 16, 2, 1, 2, 3, VEC>(x, w, counts, idx, max_count, out,
                                          M, K, N, bk, bn, s);
}

// ---------------------------------------------------------------------------
// The bfloat16 instance: x and w bfloat16, float32 sums, out bfloat16.
// One mma.sync.m16n8k16 a k-step of 16 rows (no split: the operands are
// already what the tensor core reads), so a 64-row chunk is four k-steps.
// The walk, the row masks and the cp.async ring are the float32 kernel's
// at half the bytes a tile: 16-byte copies carry 8 values where K, N and
// block_n are multiples of 8 and x and w are 16-byte aligned, else each
// value is loaded and stored by a thread.  m16n8k16 fragments (bf16 pairs
// in 32-bit registers, the lower index in the low half), g = lane / 4,
// t = lane % 4:
//   A (16 x 16): a0 (g, 2t..2t+1), a1 (g + 8, 2t..), a2 (g, 2t+8..),
//                a3 (g + 8, 2t+8..)
//   B (16 x 8):  b0 (2t..2t+1, g), b1 (2t+8..2t+9, g)
//   C (16 x 8):  as the float32 kernel's
// ---------------------------------------------------------------------------

constexpr int kXPH = kKC + 8;   // x tile row pitch (bf16): 144-byte rows

template <int BM, int GW, int WR, int WC, int WK, int STAGES>
struct CfgH {
  static_assert(WR * WC * WK == kThreads / 32, "4 warps");
  static constexpr int kMT = BM / WR / 16;   // m-tiles a warp
  static constexpr int kNT = GW / WC / 8;    // n-tiles a warp
  static constexpr int kWP = GW + 8;         // w tile row pitch (bf16)
  static constexpr int kXF = BM * kXPH;      // values of an x stage
  static constexpr int kWF = kKC * kWP;      // values of a w stage
  static size_t smem_bytes(int nchunks, int bn) {
    const int max_g = (GW - 1) / bn + 2;
    return (size_t)STAGES * (kXF + kWF) * sizeof(__nv_bfloat16) +
           (size_t)nchunks * (max_g + 1) * sizeof(unsigned long long);
  }
  static_assert(kMT >= 1 && kNT >= 1, "warp tile");
  static_assert((WK - 1) * WR * WC * kMT * kNT * 4 * 32 * sizeof(float) <=
                    STAGES * (kXF + kWF) * sizeof(__nv_bfloat16),
                "the k-step reduction reuses the stage buffers");
  static_assert((STAGES * (kXF + kWF) * sizeof(__nv_bfloat16)) % 16 == 0,
                "the row masks start 16-byte aligned");
};

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_pair(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// bit i set where rows [16 i, 16 i + 16) of a chunk's row mask m meet
__device__ __forceinline__ unsigned step_bits16(unsigned long long m) {
  unsigned out = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) out |= ((m >> (16 * i)) & 0xFFFFull ? 1u : 0u) << i;
  return out;
}

template <int BM, int GW, int WR, int WC, int WK, int STAGES, bool VEC>
__global__ void __launch_bounds__(kThreads)
block_sparse_matmul_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                                const __nv_bfloat16* __restrict__ w,
                                const int* __restrict__ counts,
                                const int* __restrict__ idx, int max_count,
                                __nv_bfloat16* __restrict__ out, int M, int K,
                                int N, int bk, int bn, int row_tiles) {
  using C = CfgH<BM, GW, WR, WC, WK, STAGES>;
  constexpr int MT = C::kMT, NT = C::kNT, WP = C::kWP;
  extern __shared__ __align__(16) unsigned char smem_h[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_h);
  __nv_bfloat16* ws = xs + STAGES * C::kXF;
  unsigned long long* masks =
      reinterpret_cast<unsigned long long*>(ws + STAGES * C::kWF);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp % WR, wc = (warp / WR) % WC, wk = warp / (WR * WC);
  const int rt = blockIdx.x % row_tiles;
  const int m0 = rt * BM, n0 = (blockIdx.x / row_tiles) * GW;
  const int j0 = n0 / bn;
  const int G = (min(n0 + GW, N) - 1) / bn + 1 - j0;
  const int rbase = wr * (BM / WR), cbase = wc * (GW / WC);
  const int nchunks = (K + kKC - 1) / kKC;
  const int GS = G + 1;
  const __nv_bfloat16 zero = __ushort_as_bfloat16((unsigned short)0);

  build_row_masks(masks, counts, idx, max_count, j0, G, nchunks, K, bk);

  // Chunk c into stage c % STAGES, one cp.async group (empty past the
  // last chunk; the scalar path's stores are complete at the barrier that
  // follows).  Rows no column block keeps, and rows and columns out of
  // range, are zeros.
  auto issue = [&](int c) {
    if (c < nchunks) {
      const int s = c % STAGES, c0 = c * kKC;
      const unsigned long long* ms = masks + c * GS;
      const unsigned long long any = ms[G];
      __nv_bfloat16* xd = xs + s * C::kXF;
      __nv_bfloat16* wd = ws + s * C::kWF;
      if (VEC) {
        for (int e = tid; e < BM * 8; e += kThreads) {
          const int r = e >> 3, k = (e & 7) * 8;
          const bool ok = m0 + r < M && c0 + k < K && ((any >> k) & 0xFFull);
          cp_async16(xd + r * kXPH + k,
                     ok ? x + (size_t)(m0 + r) * K + c0 + k : x, ok);
        }
        for (int e = tid; e < kKC * (GW / 8); e += kThreads) {
          const int k = e / (GW / 8), n = n0 + (e % (GW / 8)) * 8;
          const bool ok = c0 + k < K && n < N &&
                          ((ms[n / bn - j0] >> k) & 1ull);
          cp_async16(wd + k * WP + (n - n0),
                     ok ? w + (size_t)(c0 + k) * N + n : w, ok);
        }
      } else {
        for (int e = tid; e < BM * kKC; e += kThreads) {
          const int r = e / kKC, k = e % kKC;
          const bool ok = m0 + r < M && c0 + k < K && ((any >> k) & 1ull);
          xd[r * kXPH + k] = ok ? x[(size_t)(m0 + r) * K + c0 + k] : zero;
        }
        for (int e = tid; e < kKC * GW; e += kThreads) {
          const int k = e / GW, n = n0 + e % GW;
          const bool ok = c0 + k < K && n < N &&
                          ((ms[n / bn - j0] >> k) & 1ull);
          wd[k * WP + (n - n0)] = ok ? w[(size_t)(c0 + k) * N + n] : zero;
        }
      }
    }
    cp_commit();
  };

  int jlo[NT], jhi[NT];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int nlo = n0 + cbase + 8 * nt;
    jlo[nt] = nlo / bn - j0;
    jhi[nt] = nlo < N ? min(nlo + 7, N - 1) / bn - j0 : jlo[nt] - 1;
  }

  // acc: the float32 total; part: one chunk's tensor-core sums
  float acc[MT][NT][4], part[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
    }
  }

  for (int c = 0; c < STAGES - 1; ++c) issue(c);
  for (int c = 0; c < nchunks; ++c) {
    issue(c + STAGES - 1);
    cp_wait<STAGES - 1>();
    __syncthreads();
    const int s = c % STAGES;
    const unsigned long long* ms = masks + c * GS;
    const __nv_bfloat16* xd = xs + s * C::kXF;
    const __nv_bfloat16* wd = ws + s * C::kWF;
    unsigned ntm[NT];   // the 16-row k-steps each n-tile needs
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      unsigned long long m = 0;
      for (int j = jlo[nt]; j <= jhi[nt]; ++j) m |= ms[j];
      ntm[nt] = step_bits16(m);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) part[mt][nt][i] = 0.f;
      }
    }
    for (int st = wk; st < kKC / 16; st += WK) {
      unsigned need = 0;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) need |= ((ntm[nt] >> st) & 1u) << nt;
      if (!need) continue;
      uint32_t a[MT][4], b[NT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const __nv_bfloat16* xr =
            xd + (rbase + 16 * mt + g) * kXPH + 16 * st + 2 * t;
        a[mt][0] = ld_pair(xr);
        a[mt][1] = ld_pair(xr + 8 * kXPH);
        a[mt][2] = ld_pair(xr + 8);
        a[mt][3] = ld_pair(xr + 8 * kXPH + 8);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const __nv_bfloat16* wcp =
            wd + (16 * st + 2 * t) * WP + cbase + 8 * nt + g;
        b[nt][0] = pack_pair(wcp[0], wcp[WP]);
        b[nt][1] = pack_pair(wcp[8 * WP], wcp[9 * WP]);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (m0 + rbase + 16 * mt >= M) continue;   // rows past M
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          if ((need >> nt) & 1u) mma_bf16(part[mt][nt], a[mt], b[nt]);
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] += part[mt][nt][i];
      }
    }
    __syncthreads();   // stage s is free for chunk c + STAGES
  }

  // the k-step warps' sums into warp wk = 0's, in a fixed order
  if (WK > 1) {
    cp_wait<0>();
    __syncthreads();
    float* red_base = reinterpret_cast<float*>(smem_h);
    constexpr int kTile = MT * NT * 4 * 32;
    const int wrc = warp % (WR * WC);
    if (wk > 0) {
      float* red = red_base + ((wk - 1) * WR * WC + wrc) * kTile;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            red[((mt * NT + nt) * 4 + i) * 32 + lane] = acc[mt][nt][i];
        }
      }
    }
    __syncthreads();
    if (wk > 0) return;
    for (int q = 1; q < WK; ++q) {
      const float* red = red_base + ((q - 1) * WR * WC + wrc) * kTile;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            acc[mt][nt][i] += red[((mt * NT + nt) * 4 + i) * 32 + lane];
        }
      }
    }
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = m0 + rbase + 16 * mt + g + (i >> 1) * 8;
        const int col = n0 + cbase + 8 * nt + 2 * t + (i & 1);
        if (row < M && col < N)
          out[(size_t)row * N + col] = __float2bfloat16_rn(acc[mt][nt][i]);
      }
    }
  }
}

template <int BM, int GW, int WR, int WC, int WK, int STAGES, bool VEC>
int launch_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w,
                const int* counts, const int* idx, int max_count,
                __nv_bfloat16* out, int M, int K, int N, int bk, int bn,
                cudaStream_t stream) {
  using C = CfgH<BM, GW, WR, WC, WK, STAGES>;
  auto* kernel =
      block_sparse_matmul_bf16_kernel<BM, GW, WR, WC, WK, STAGES, VEC>;
  const size_t smem = C::smem_bytes((K + kKC - 1) / kKC, bn);
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long row_tiles = (M + BM - 1) / BM;
  const long long blocks = row_tiles * ((N + GW - 1) / GW);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      x, w, counts, idx, max_count, out, M, K, N, bk, bn, (int)row_tiles);
  return (int)cudaGetLastError();
}

template <bool VEC>
int dispatch_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w,
                  const int* counts, const int* idx, int max_count,
                  __nv_bfloat16* out, int M, int K, int N, int bk, int bn,
                  cudaStream_t s) {
  if (M <= 16)   // the float32 kernel's tiles: 16 x 8, k-steps split
    return launch_bf16<16, 8, 1, 1, 4, 8, VEC>(x, w, counts, idx, max_count,
                                                out, M, K, N, bk, bn, s);
  return launch_bf16<32, 16, 2, 1, 2, 3, VEC>(x, w, counts, idx, max_count,
                                               out, M, K, N, bk, bn, s);
}


// ---------------------------------------------------------------------------
// The bfloat16 instance on Hopper's warpgroup MMA (block_sparse_matmul_bf16
// where K, N and block_n are multiples of 8 and x and w are 16-byte
// aligned).  Block (split, row tile, column tile) computes
//
//   out^T (64 columns x MT rows) = (w tile masked)^T (64 x K) . x^T (K x MT)
//
// over its split's chunks [split cps, (split + 1) cps) with
// wgmma.m64nMTk16.  A is the w chunk (64 k-rows of 128 bytes, 64 columns:
// MN-major), B the x chunk (MT rows of 64 k: K-major); 16-byte piece p of
// 128-byte row r sits at p ^ (r % 8) (the 128-byte swizzle), in a stage
// aligned to 1024 bytes.  Warp roles: a producer warpgroup (threads 128 ..
// 255) copies x and w with cp.async, each thread's arrival on a chunk's
// full barrier firing when its copies land; the consumer warpgroup
// (threads 0 .. 127) waits on it, runs the chunk's four wgmma k-steps, and
// frees the stage on its empty barrier (one lane a warp).
// ---------------------------------------------------------------------------

namespace wg {

constexpr int kKC = 64;            // K rows a chunk: one 128-byte x row
constexpr int kNT = 64;            // output columns a tile
constexpr int kConsumers = 128;    // one warpgroup
constexpr int kProducers = 128;    // one warpgroup of copies
constexpr int kThreads = kConsumers + kProducers;
constexpr int kRowStep = kProducers / 8;   // k-rows apart, a producer's copies
constexpr int kWBytes = kKC * kNT * 2;     // a w chunk: 8 KB
constexpr int kPitch = kNT + 4;            // staging row pitch (floats)
constexpr int kMaskBatch = 32;             // chunks of mask words loaded at once
constexpr int kCounters = 1024;            // tiles a split product may have
constexpr int kMaxSplits = 16;

template <int MT>
struct Smem {
  static_assert(MT % 16 == 0 && MT <= 64, "wgmma n");
  static constexpr int kXBytes = MT * kKC * 2;
  static constexpr int kStage = kWBytes + kXBytes;   // a multiple of 1024
  static constexpr int kStaging = MT * kPitch * 4;
  // the ring's chunks: up to 12 for a 16-row tile, 4 for 64 rows, where two
  // blocks must fit an SM
  static constexpr int kMaxStages = MT <= 16 ? 12 : MT <= 32 ? 8 : 4;
  // 1024 bytes of slack align the ring to the swizzle's 1024-byte period;
  // then the staging tile, the mask words, the full and empty barriers
  static size_t bytes(int stages) {
    return 1024 + (size_t)stages * kStage + kStaging + kMaskBatch * 8 * 8 +
           2 * stages * 8;
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// 16 bytes global -> shared, zeros where !ok (source size 0: no read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// one arrival on `bar` once this thread's earlier cp.async copies landed
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

// until the phase of parity `parity` has completed.  The loop is in the
// PTX, so the compiler sees no divergence around the wgmmas that follow.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// mbar_arrive where `pred` holds, the predicate in the PTX
__device__ __forceinline__ void mbar_arrive_if(uint32_t bar, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(bar),
      "r"((int)pred)
      : "memory");
}

// generic-proxy writes (cp.async) before async-proxy reads (wgmma)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A shared-memory matrix descriptor in the 128-byte swizzle: start
// address, leading and stride byte offsets, all in 16-byte units
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

// two floats rounded to bfloat16, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x MT, f32) = scale_d ? D : 0, + A (64 x 16, bf16, MN-major) .
// B (16 x MT, bf16, K-major)
template <int MT>
__device__ __forceinline__ void wgmma_tile(float (&d)[MT / 2], uint64_t a,
                                           uint64_t b, int scale_d);

template <>
__device__ __forceinline__ void wgmma_tile<16>(float (&d)[8], uint64_t a,
                                                  uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tile<32>(float (&d)[16], uint64_t a,
                                                  uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tile<64>(float (&d)[32], uint64_t a,
                                                  uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

__device__ __forceinline__ uint4 pack8(const float4& lo, const float4& hi) {
  uint4 v;
  v.x = pack_bf16(lo.x, lo.y);
  v.y = pack_bf16(lo.z, lo.w);
  v.z = pack_bf16(hi.x, hi.y);
  v.w = pack_bf16(hi.z, hi.w);
  return v;
}

template <int MT>
__global__ void __launch_bounds__(kThreads)
bs_bf16_wgmma_kernel(const __nv_bfloat16* __restrict__ x,
                     const __nv_bfloat16* __restrict__ w,
                     const unsigned long long* __restrict__ masks,
                     __nv_bfloat16* __restrict__ out, float* __restrict__ ws,
                     int* __restrict__ counters, int M, int K, int N, int bn,
                     int row_tiles, int splits, int cps, int stages) {
  using S = Smem<MT>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* ring = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  float* staging = reinterpret_cast<float*>(ring + stages * S::kStage);
  unsigned long long* mw =
      reinterpret_cast<unsigned long long*>(staging + MT * kPitch);
  const uint32_t full0 = smem_u32(mw + kMaskBatch * 8);
  const uint32_t empty0 = full0 + stages * 8;
  const uint32_t ring0 = smem_u32(ring);

  // block = split + splits (row tile + row_tiles column tile)
  const int tid = threadIdx.x;
  int b = blockIdx.x;
  const int sp = b % splits;
  b /= splits;
  const int rt = b % row_tiles, ct = b / row_tiles;
  const int m0 = rt * MT, n0 = ct * kNT;
  const int nchunks = (K + kKC - 1) / kKC;
  const int c_begin = sp * cps, nck = min(nchunks, c_begin + cps) - c_begin;
  const int nnb = (N + bn - 1) / bn;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full0 + 8 * s, kProducers);
      mbar_init(empty0 + 8 * s, kConsumers / 32);     // a lane a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warpgroup's role, warp-uniform for the compiler (a shuffle)
  if (__shfl_sync(0xffffffffu, tid / kConsumers, 0) == 1) {
    // The producer warpgroup.  Thread p copies the 16-byte piece jn = p % 8
    // of k-rows p / 8 + kRowStep q; its 8 columns lie in one column block,
    // whose mask words come kMaskBatch chunks at a time into mw, loaded
    // together ahead of the copies that read them.  Each thread's arrival
    // on a chunk's full barrier fires when its copies have landed.
    const int p = tid - kConsumers, jn = p & 7, kr0 = p >> 3;
    const int n = n0 + 8 * jn;
    const bool n_ok = n < N;
    const unsigned long long* mrow =
        masks + (size_t)c_begin * nnb + (n_ok ? n / bn : 0);
    const __nv_bfloat16* wsrc = w + (n_ok ? n : 0);
    // x needs no mask: the ring's first chunks of it go out at once, ahead
    // of the mask words that the w copies wait for.  Piece e of a chunk is
    // 16 bytes (8 k) of x row e / 8; rows past M and k past K are zeros.
    auto load_x = [&](int i) {
      const uint32_t st = ring0 + (i % stages) * S::kStage + kWBytes;
      const int k0 = (c_begin + i) * kKC;
#pragma unroll
      for (int u = 0; u < MT * 8 / kProducers; ++u) {
        const int e = p + kProducers * u, r = e >> 3, j = e & 7;
        const bool ok = m0 + r < M && k0 + 8 * j < K;
        const void* src = ok ? x + (size_t)(m0 + r) * K + k0 + 8 * j : x;
        cp_async16(st + r * 128 + ((j ^ (r & 7)) << 4), src, ok);
      }
    };
    for (int i = 0; i < min(nck, stages); ++i) load_x(i);
    for (int i = 0; i < nck; ++i) {
      const int s = i % stages, c = c_begin + i;
      if (i % kMaskBatch == 0) {
        asm volatile("bar.sync 2, %0;\n" ::"n"(kProducers) : "memory");
#pragma unroll
        for (int u = 0; u < kMaskBatch / kRowStep; ++u) {
          const int bi = kr0 + kRowStep * u;
          mw[bi * 8 + jn] =
              n_ok && i + bi < nck ? mrow[(size_t)(i + bi) * nnb] : 0ull;
        }
        asm volatile("bar.sync 2, %0;\n" ::"n"(kProducers) : "memory");
      }
      if (i >= stages) {
        mbar_wait(empty0 + 8 * s, ((i / stages) - 1) & 1);
        load_x(i);
      }
      const uint32_t st = ring0 + s * S::kStage;
      const unsigned long long mk = mw[(i % kMaskBatch) * 8 + jn];
#pragma unroll
      for (int q = 0; q < kKC / kRowStep; ++q) {
        const int kr = kr0 + kRowStep * q;
        const uint32_t dst = st + kr * 128 + ((jn ^ (kr & 7)) << 4);
        const bool ok = (mk >> kr) & 1ull;
        const void* src = ok ? wsrc + (size_t)(c * kKC + kr) * N : w;
        cp_async16(dst, src, ok);
      }
      cp_async_arrive(full0 + 8 * s);
    }
  } else {
    const int lane = tid & 31;
    float acc[MT / 2], total[MT / 2];
#pragma unroll
    for (int r = 0; r < MT / 2; ++r) acc[r] = total[r] = 0.f;
    // chunk i's four wgmma k-steps into acc, from zero (fresh) or onto it
    auto issue = [&](int i, bool fresh) {
      const int s = i % stages;
      mbar_wait(full0 + 8 * s, (i / stages) & 1);
      fence_proxy_async();   // the cp.async bytes, for wgmma's reads
      const uint32_t wa = ring0 + s * S::kStage, xa = wa + kWBytes;
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int ks = 0; ks < kKC / 16; ++ks) {
        // A: 16 k-rows of 128 bytes a k-step, 8-row groups 1024 bytes
        // apart (the one 64-column swizzle atom makes the leading offset
        // unused: it is given the same 1024); B: 32 bytes along each
        // 128-byte x row, 8-row groups 1024 bytes apart
        wgmma_tile<MT>(acc, desc_sw128(wa + ks * 2048, 1024, 1024),
                       desc_sw128(xa + ks * 32, 16, 1024), !fresh || ks > 0);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    };
    if (nck <= stages) {
      // Every chunk has a stage of its own: each chunk's wgmmas go out as
      // it lands, onto one accumulator, and the warpgroup waits once
      for (int i = 0; i < nck; ++i) issue(i, i == 0);
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_operands(acc);
#pragma unroll
      for (int r = 0; r < MT / 2; ++r) total[r] = acc[r];
    } else {
      // A ring: each chunk's wgmmas from zero, then the sum added into the
      // float32 total and the stage freed
      for (int i = 0; i < nck; ++i) {
        issue(i, true);
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        fence_operands(acc);
        __syncwarp();
        mbar_arrive_if(empty0 + 8 * (i % stages), lane == 0);
#pragma unroll
        for (int r = 0; r < MT / 2; ++r) total[r] += acc[r];
      }
    }
    // Stage the tile as [MT rows][64 columns]: element (row g, col c) of
    // the wgmma accumulator is output (m0 + c, n0 + row)
    const int warp = tid >> 5, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int j = 0; j < MT / 8; ++j) {
      const int row = 16 * warp + g, col = 8 * j + 2 * t;
      staging[col * kPitch + row] = total[4 * j];
      staging[(col + 1) * kPitch + row] = total[4 * j + 1];
      staging[col * kPitch + row + 8] = total[4 * j + 2];
      staging[(col + 1) * kPitch + row + 8] = total[4 * j + 3];
    }
  }
  __syncthreads();

  if (splits == 1) {
    // 8 outputs (16 bytes) a thread
    for (int e = tid; e < MT * (kNT / 8); e += kThreads) {
      const int r = e / (kNT / 8), c8 = (e % (kNT / 8)) * 8;
      const int m = m0 + r, n = n0 + c8;
      if (m >= M || n >= N) continue;
      const float* st = staging + r * kPitch + c8;
      *reinterpret_cast<uint4*>(out + (size_t)m * N + n) =
          pack8(*reinterpret_cast<const float4*>(st),
                *reinterpret_cast<const float4*>(st + 4));
    }
    return;
  }
  // Each split's tile of float32 sums into the workspace (splits, M, N)
  float* part = ws + (size_t)sp * M * N;
  for (int e = tid; e < MT * (kNT / 4); e += kThreads) {
    const int r = e / (kNT / 4), c4 = (e % (kNT / 4)) * 4;
    const int m = m0 + r, n = n0 + c4;
    if (m >= M || n >= N) continue;
    *reinterpret_cast<float4*>(part + (size_t)m * N + n) =
        *reinterpret_cast<const float4*>(staging + r * kPitch + c4);
  }
  // The last of the tile's splits to arrive adds the splits' sums in split
  // order (its own read back like the others), rounds once, and sets the
  // tile's counter back to 0 for the next launch
  __syncthreads();
  int* last = reinterpret_cast<int*>(mw);
  const int tile = ct * row_tiles + rt;
  if (tid == 0) {
    __threadfence();   // the block's partial sums, before its arrival
    *last = atomicAdd(counters + tile, 1) == splits - 1;
    __threadfence();
  }
  __syncthreads();
  if (!*last) return;
  // 4 outputs a thread, the splits' values loaded kBatch at a time
  constexpr int kBatch = 8;
  for (int e = tid; e < MT * (kNT / 4); e += kThreads) {
    const int r = e / (kNT / 4), c4 = (e % (kNT / 4)) * 4;
    const int m = m0 + r, n = n0 + c4;
    if (m >= M || n >= N) continue;
    const float* src = ws + (size_t)m * N + n;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int q0 = 0; q0 < splits; q0 += kBatch) {
      float4 v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (q0 + u < splits)
          v[u] = __ldcg(reinterpret_cast<const float4*>(
              src + (size_t)(q0 + u) * M * N));
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (q0 + u >= splits) break;
        if (q0 + u == 0)
          sum = v[0];
        else
          add4(sum, v[u]);
      }
    }
    uint2 o;
    o.x = pack_bf16(sum.x, sum.y);
    o.y = pack_bf16(sum.z, sum.w);
    *reinterpret_cast<uint2*>(out + (size_t)m * N + n) = o;
  }
  if (tid == 0) counters[tile] = 0;
}

template <int MT>
int launch(const __nv_bfloat16* x, const __nv_bfloat16* w,
           const unsigned long long* masks, __nv_bfloat16* out, float* ws,
           int* counters, int M, int K, int N, int bn, int cps,
           cudaStream_t stream) {
  using S = Smem<MT>;
  auto* kernel = bs_bf16_wgmma_kernel<MT>;
  const int nchunks = (K + kKC - 1) / kKC;
  const int splits = (nchunks + cps - 1) / cps;
  // a stage for each chunk of a split where they fit, else the ring
  const int stages = max(2, min(cps, S::kMaxStages));
  const size_t smem = S::bytes(stages);
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long row_tiles = (M + MT - 1) / MT;
  const long long tiles = row_tiles * ((N + kNT - 1) / kNT);
  if (splits > kMaxSplits ||
      (splits > 1 && (ws == nullptr || counters == nullptr ||
                      tiles > kCounters)))
    return (int)cudaErrorInvalidValue;
  const long long blocks = row_tiles * splits * ((N + kNT - 1) / kNT);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      x, w, masks, out, ws, counters, M, K, N, bn, (int)row_tiles, splits,
      cps, stages);
  return (int)cudaGetLastError();
}

}  // namespace wg

}  // namespace

// x (M, K), w (K, N) and out (M, N) are contiguous float32; counts (ceil(N /
// block_n),) and idx (ceil(N / block_n), max_count) int32 are the column
// plan of the block mask.  Launches on `stream`, does not synchronise,
// allocates nothing, and returns cudaGetLastError() after the launch.
extern "C" int block_sparse_matmul_f32(const float* x, const float* w,
                                       const int* counts, const int* idx,
                                       int max_count, float* out, int M,
                                       int K, int N, int block_k, int block_n,
                                       void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (K < 0 || block_k <= 0 || block_n <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = K % 4 == 0 && N % 4 == 0 && block_n % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
  return vec ? dispatch<true>(x, w, counts, idx, max_count, out, M, K, N,
                              block_k, block_n, s)
             : dispatch<false>(x, w, counts, idx, max_count, out, M, K, N,
                               block_k, block_n, s);
}

// As block_sparse_matmul_f32, with x, w and out bfloat16 (float32 sums,
// one rounding of each output).  Where K, N and block_n are multiples of 8
// and x and w are 16-byte aligned it runs on wgmma (namespace wg): masks
// (ceil(K / 64), ceil(N / block_n)) are the column plan's 64-bit row masks
// of each (64-row chunk, column block), tile_m (16, 32 or 64) the x rows a
// tile, chunks_per_split the 64-row chunks a split walks; where there is
// more than one split (ceil(ceil(K / 64) / chunks_per_split)), ws is a
// float32 (splits, M, N) workspace and counters the tiles' zeroed arrival
// counters (ops.block_sparse.bf16_plan makes the same choice of path, and
// the wrapper allocates both).  Other shapes, and tile_m 0, run the
// mma.sync kernel above from counts and idx.
extern "C" int block_sparse_matmul_bf16(const void* x, const void* w,
                                        const int* counts, const int* idx,
                                        int max_count, const void* masks,
                                        void* out, void* ws, int* counters,
                                        int M, int K, int N, int block_k,
                                        int block_n, int tile_m,
                                        int chunks_per_split, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (K < 0 || block_k <= 0 || block_n <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xh = static_cast<const __nv_bfloat16*>(x);
  const auto* wh = static_cast<const __nv_bfloat16*>(w);
  auto* oh = static_cast<__nv_bfloat16*>(out);
  const bool vec = K % 8 == 0 && N % 8 == 0 && block_n % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
  if (vec && K > 0 && tile_m > 0) {
    if (chunks_per_split <= 0) return (int)cudaErrorInvalidValue;
    const auto* mk = static_cast<const unsigned long long*>(masks);
    float* wsf = static_cast<float*>(ws);
    switch (tile_m) {
      case 16:
        return wg::launch<16>(xh, wh, mk, oh, wsf, counters, M, K, N, block_n,
                              chunks_per_split, s);
      case 32:
        return wg::launch<32>(xh, wh, mk, oh, wsf, counters, M, K, N, block_n,
                              chunks_per_split, s);
      case 64:
        return wg::launch<64>(xh, wh, mk, oh, wsf, counters, M, K, N, block_n,
                              chunks_per_split, s);
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  return vec ? dispatch_bf16<true>(xh, wh, counts, idx, max_count, oh, M, K,
                                   N, block_k, block_n, s)
             : dispatch_bf16<false>(xh, wh, counts, idx, max_count, oh, M, K,
                                    N, block_k, block_n, s);
}

extern "C" const char* block_sparse_matmul_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
