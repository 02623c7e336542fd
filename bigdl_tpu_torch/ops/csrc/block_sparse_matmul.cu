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
// What bounds it: at the draft's decode shapes (M = 16 rows) the bytes of the
// kept weight blocks, read once (4 bytes x K x N x density); at M = 256 the
// float32 operations (2 M K N density) over the CUDA cores' 67 TFLOP/s.
//
// What the design does about it: the product is a stream over the kept
// weight rows, so the work is spread along K.  One warp owns a slice of 8
// output columns inside one column block and a tile of kRows = 4 rows; its
// 32 lanes split that column block's kept k-rows (lane l takes kept rows l,
// l + 32, ...), each lane summing 4 x 8 partial products in float32
// registers, and the warp adds the lanes' sums with a fixed butterfly of
// shuffles (no atomics: the same bits run to run).  Neighbouring lanes read
// neighbouring k, so the x reads of a warp are coalesced, and each lane's
// 8 weights are one 32-byte sector.  The warps of a block share one weight
// slice (different row tiles), so a slice is read from memory once per
// block.  Pruned blocks are never read.  Tensor cores and shared-memory
// staging are left for a later change.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;   // per block
constexpr int kCols = 8;    // output columns per warp (one slice)
constexpr int kRows = 4;    // rows per warp

__global__ void __launch_bounds__(kWarps * 32)
block_sparse_matmul_kernel(const float* __restrict__ x,
                           const float* __restrict__ w,
                           const int* __restrict__ counts,
                           const int* __restrict__ idx, int max_count,
                           float* __restrict__ out, int M, int K, int N,
                           int block_k, int block_n, int slices,
                           int row_tiles) {
  const int lane = threadIdx.x & 31;
  const int gw = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int slice = gw / row_tiles;            // warps of a block share it
  const int rt = gw - slice * row_tiles;
  const int nnb = (N + block_n - 1) / block_n;
  const int j = slice / slices;                 // column block
  if (j >= nnb) return;                         // no barrier below
  const int c0 = j * block_n + (slice - j * slices) * kCols;
  const int c_end = min(min(c0 + kCols, (j + 1) * block_n), N);
  if (c0 >= c_end) return;
  const int row0 = rt * kRows;
  const int* lst = idx + (size_t)j * max_count;
  const int n_rows = counts[j] * block_k;       // kept k-rows of block j

  const float* xr[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r)  // rows past M read row M - 1, never stored
    xr[r] = x + (size_t)min(row0 + r, M - 1) * K;
  float acc[kRows][kCols];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
  }
  for (int i = lane; i < n_rows; i += 32) {
    const int t = i / block_k;
    const int k = lst[t] * block_k + (i - t * block_k);
    if (k >= K) continue;                        // the ragged last k-block
    const float* wr = w + (size_t)k * N + c0;
    float wv[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) wv[c] = c0 + c < c_end ? wr[c] : 0.f;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float xv = xr[r][k];
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] = fmaf(xv, wv[c], acc[r][c]);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        acc[r][c] += __shfl_xor_sync(0xffffffffu, acc[r][c], o);
    }
  }
  // every lane holds every sum; lane r * 8 + c stores (row r, column c)
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      if (lane == r * kCols + c && row0 + r < M && c0 + c < c_end)
        out[(size_t)(row0 + r) * N + c0 + c] = acc[r][c];
    }
  }
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
  const int nnb = (N + block_n - 1) / block_n;
  const int slices = (block_n + kCols - 1) / kCols;   // per column block
  const int row_tiles = (M + kRows - 1) / kRows;
  const long long warps = (long long)nnb * slices * row_tiles;
  const long long blocks = (warps + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  block_sparse_matmul_kernel<<<(unsigned)blocks, kWarps * 32, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      x, w, counts, idx, max_count, out, M, K, N, block_k, block_n, slices,
      row_tiles);
  return (int)cudaGetLastError();
}

extern "C" const char* block_sparse_matmul_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
