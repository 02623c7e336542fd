// Block-sparse matrix product, float32, for Hopper (sm_90a).
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
// What bounds it, by both peaks (2 M K N density flops, 4 (M K + K N
// density + M N) bytes): at the draft's decode shapes (M = 16) the bytes of
// the kept weight blocks over HBM's 3.35 TB/s; at M = 256 the operations,
// which on the tensor cores in 3xTF32 cost three TF32 products each, 3 x
// flops over 495 TFLOP/s (against flops over 67 TFLOP/s on CUDA cores).
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

  // Which rows of each chunk each column block of the tile keeps: one
  // 64-bit mask per (chunk, column block), built once from the kept lists
  // (idx rows j0 .. j0 + G are contiguous), kPer entries a thread loaded
  // at once; integer ORs in shared memory, so the order does not matter.
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

extern "C" const char* block_sparse_matmul_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
