// Int8 matrix product for Hopper (sm_90a): int8 x (M, K) times int8 w (K, N)
// into int32 out (M, N), exact.
//
// Replaces bigdl_tpu/ops/quantized.py: int8_matmul, whose Pallas kernel
// (_int8_mm_kernel) pads the operands to tiles of 256/256/512 and keeps an
// int32 output block resident in VMEM while a sequential K grid axis
// accumulates into it on the MXU.  Here a block owns a 64 x 64 output tile and
// loops over K itself (blocks run in no order, so nothing carries over from
// one block to the next), and nothing is padded in memory: the ragged edges
// of M, N and K are masked while the tiles are staged.
//
// What bounds it: at ResNet-50's shapes the int8 tensor-core operations
// (2 M K N over 1,979 TOP/s) for the big convs, the bytes of the operands
// (M K + K N + 4 M N over 3.35 TB/s) for the 1x1 convs of narrow K and for
// the head's M = batch rows.
//
// What the design does about it: the products run on the tensor cores, one
// mma.sync.m16n8k32 s8 x s8 -> s32 per 16 x 8 x 32 piece, four warps of a
// block each computing a 32 x 32 quarter of the tile from int8 tiles of x and
// w staged in shared memory.  The mma's B operand wants 4 consecutive k of one
// column in a register, so w's (k, n) tile is stored transposed, [n][k], as it
// is staged.  Rows of both tiles are 64 + 16 bytes apart, which keeps the
// fragment reads free of bank conflicts.  Loads are 16 bytes a thread where
// the row length is a multiple of 16 (every ResNet-50 conv but the stem's
// K = 147, every N but the head's 1000) and byte loads otherwise; K tails,
// rows past M and columns past N are staged as zeros and never read from
// memory.  No cp.async or TMA pipeline, no wgmma: the staging and the
// products of one k-tile do not overlap.  That is a later change's work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64, kBN = 64, kBK = 64;
constexpr int kThreads = 128;        // 4 warps in 2 x 2, each 32 x 32
constexpr int kStride = kBK + 16;    // bytes from one smem row to the next

__device__ __forceinline__ void mma_s8(int (&c)[4], const int (&a)[4],
                                       const int (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <bool kVecA, bool kVecB>
__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                   int32_t* __restrict__ out, int M, int K, int N) {
  __shared__ __align__(16) int8_t As[kBM * kStride];   // x tile, [m][k]
  __shared__ __align__(16) int8_t Bs[kBN * kStride];   // w tile, [n][k]
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;      // mma fragment coordinates
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const long long m0 = (long long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;

  int acc[2][4][4] = {};

  for (int k0 = 0; k0 < K; k0 += kBK) {
    if (kVecA) {   // K % 16 == 0: a 16-byte chunk lies in or past a row
      for (int c = tid; c < kBM * kBK / 16; c += kThreads) {
        const int r = c / (kBK / 16), col = (c % (kBK / 16)) * 16;
        const long long gm = m0 + r;
        const int gk = k0 + col;
        int4 v = make_int4(0, 0, 0, 0);
        if (gm < M && gk < K)
          v = *reinterpret_cast<const int4*>(x + gm * K + gk);
        *reinterpret_cast<int4*>(As + r * kStride + col) = v;
      }
    } else {
      for (int e = tid; e < kBM * kBK; e += kThreads) {
        const int r = e / kBK, col = e % kBK;
        const long long gm = m0 + r;
        const int gk = k0 + col;
        As[r * kStride + col] = (gm < M && gk < K) ? x[gm * K + gk]
                                                   : (int8_t)0;
      }
    }
    if (kVecB) {   // N % 16 == 0
      for (int c = tid; c < kBK * kBN / 16; c += kThreads) {
        const int kr = c / (kBN / 16), col = (c % (kBN / 16)) * 16;
        const int gk = k0 + kr, gn = n0 + col;
        int4 v = make_int4(0, 0, 0, 0);
        if (gk < K && gn < N)
          v = *reinterpret_cast<const int4*>(w + (size_t)gk * N + gn);
        const int8_t* b = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
        for (int j = 0; j < 16; ++j) Bs[(col + j) * kStride + kr] = b[j];
      }
    } else {
      for (int e = tid; e < kBK * kBN; e += kThreads) {
        const int kr = e / kBN, col = e % kBN;
        const int gk = k0 + kr, gn = n0 + col;
        Bs[col * kStride + kr] = (gk < K && gn < N) ? w[(size_t)gk * N + gn]
                                                    : (int8_t)0;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      // A fragment (16 x 32, row): rows g and g + 8, k = t*4.. and 16 + t*4..
      // B fragment (32 x 8, col): column g, k = t*4.. and 16 + t*4..
      int a[2][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int8_t* p = As + (wm + mi * 16 + g) * kStride + kk + t * 4;
        a[mi][0] = *reinterpret_cast<const int*>(p);
        a[mi][1] = *reinterpret_cast<const int*>(p + 8 * kStride);
        a[mi][2] = *reinterpret_cast<const int*>(p + 16);
        a[mi][3] = *reinterpret_cast<const int*>(p + 8 * kStride + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int8_t* p = Bs + (wn + ni * 8 + g) * kStride + kk + t * 4;
        b[ni][0] = *reinterpret_cast<const int*>(p);
        b[ni][1] = *reinterpret_cast<const int*>(p + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni]);
      }
    }
    __syncthreads();
  }

  // C fragment (16 x 8): (row g, columns t*2, t*2 + 1), then row g + 8
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int c = n0 + wn + ni * 8 + t * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long r = m0 + wm + mi * 16 + g + h * 8;
        if (r >= M) continue;
        if (c < N) out[r * N + c] = acc[mi][ni][2 * h];
        if (c + 1 < N) out[r * N + c + 1] = acc[mi][ni][2 * h + 1];
      }
    }
  }
}

}  // namespace

// x (M, K) and w (K, N) int8 and out (M, N) int32, all contiguous.
// Launches on `stream`, does not synchronise, allocates nothing, and returns
// cudaGetLastError() after the launch.
extern "C" int int8_matmul_s8(const int8_t* x, const int8_t* w, int32_t* out,
                              int M, int K, int N, void* stream) {
  if (M < 0 || K < 0 || N < 0) return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return 0;
  const bool va = K % 16 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const bool vb = N % 16 == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0;
  const dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (va && vb)
    int8_matmul_kernel<true, true><<<grid, kThreads, 0, s>>>(x, w, out, M, K, N);
  else if (va)
    int8_matmul_kernel<true, false><<<grid, kThreads, 0, s>>>(x, w, out, M, K, N);
  else if (vb)
    int8_matmul_kernel<false, true><<<grid, kThreads, 0, s>>>(x, w, out, M, K, N);
  else
    int8_matmul_kernel<false, false><<<grid, kThreads, 0, s>>>(x, w, out, M, K, N);
  return (int)cudaGetLastError();
}

extern "C" const char* int8_matmul_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
