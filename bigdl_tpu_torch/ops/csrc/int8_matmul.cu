// Int8 matrix product for Hopper (sm_90a): int8 x (M, K) times int8 w, held
// K-major as (N, K), into int32 (M, N), exact; or, with the rescale fused
// into the epilogue, float32 y = acc * sx[m] * sw[n] (+ bias[n]).
//
// Replaces bigdl_tpu/ops/quantized.py: int8_matmul, whose Pallas kernel
// (_int8_mm_kernel) pads the operands to tiles of 256/256/512 and keeps an
// int32 output block resident in VMEM while a sequential K grid axis
// accumulates into it on the MXU; the JAX quantized_linear then rescales
// in one fused XLA pass.  Here a block owns a 128 x 128 (or 128 x 64) output
// tile and loops over its share of K itself (blocks run in no order, so
// nothing carries over from one block to the next), and nothing is padded
// in memory: the ragged edges of M, N and K are zero-filled as the tiles are
// staged, never read.
//
// What bounds it: device-memory bytes.  At ResNet-50's shapes the operands
// and the 4-byte output (M K + K N + 4 M N over 3.35 TB/s: 0.32 ms for the
// 54 products of a bucket-16 forward) take five times the int8 tensor-core
// operations (2 M K N over 1,979 TOP/s: 0.066 ms).  The output is the
// largest term: 4 M N bytes against M K of x wherever K < 4 N, which is
// every 1x1 conv that widens and the stem.
//
// What the design does about it:
// - The output is written once.  The fused epilogue turns each int32 sum
//   into y = ((float)acc * sx) * sw (+ bias) in registers, with
//   __fmul_rn / __fadd_rn in the order of the plain tail (no FMA is
//   contracted), so y is bit-equal to the plain rescale of the same
//   payloads and the four eager passes over M N int32 / float32 values
//   that followed the kernel are gone.  sx is per row (dynamic), one
//   scalar (calibrated), or absent (per-channel scales folded into w).
// - Both operands are K-major, so the mma's A and B fragments (4
//   consecutive k of one row or column a register) come straight from
//   16-byte rows by ldmatrix, with no transpose on the way.  Tiles of
//   64 k-bytes are staged with 16-byte cp.async into a 4-stage ring
//   (cp.async.wait_group between stages), so the next tiles' loads
//   overlap this tile's mma.sync.  Shared rows are 80 bytes apart: the 8
//   rows an ldmatrix phase reads land in 8 distinct 16-byte bank groups.
//   A ragged K tail is zero-filled through cp.async's source-size operand.
// - 128-row tiles with 8 warps (128 x 128, or 128 x 64 where N <= 64) read
//   x once per 128 output columns and w once per 128 rows.  The output
//   tile leaves through the drained ring in 16-byte stores of whole rows;
//   the epilogue's factors of the tile are read into shared memory at the
//   block's start, so their loads overlap the main loop.
// - Split-K where the output tiles cannot fill the card (the head at
//   every bucket, the late stages at buckets 1 and 4): the caller's plan
//   (ops/quantized.py: int8_plan, a function of M, K, N alone) gives each
//   of `splits` blocks of a tile a run of k-tiles; they write int32
//   partials to a workspace the caller allocates, and a second kernel of
//   the same entry sums them in split order (exact) and applies the
//   epilogue.  The same bits come out of every launch.
// - Rows that do not start 16-byte aligned (the stem's weight, K = 147,
//   LeNet's K) are staged through registers: whole aligned 16-byte
//   loads around the row, shifted into place with funnel shifts, stored
//   16 bytes at a time.  The stem's activations come with rows padded to
//   16 bytes (ops/quantized.py: quantize_activations), so they take
//   cp.async.  No single-byte load or shared store remains.
// Not here: s8 wgmma fed by TMA (the operations bound is a fifth of the
// bytes bound at these shapes); the activation quantization and im2col
// passes before the kernel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBK = 64;             // k bytes of a stage
constexpr int kPitch = kBK + 16;    // bytes from one shared row to the next
constexpr int kStages = 4;
constexpr int kThreads = 256;       // 8 warps

// The epilogue: int32 out (f32 == 0), or float32 y with sx_mode 0 (no
// activation scale), 1 (sx[0] for every row) or 2 (sx[m] per row).
struct Epilogue {
  void* out;
  int f32;
  const float* sx;
  int sx_mode;
  const float* sw;
  const float* bias;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(int (&r)[4], const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const int (&a)[4],
                                       const int (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Bytes p[0 .. 15] of a row that need not be 16-byte aligned, zero from
// byte `valid` (1 .. 16) on.  Reads only the aligned 16-byte pieces that
// hold one of bytes p[0 .. valid - 1] (allocations on the card start and
// end on 16-byte boundaries, so these lie inside the operand's), and
// shifts them into place.
__device__ __forceinline__ int4 load16_shifted(const int8_t* p, int valid) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const int off = (int)(a & 15);
  const int4* base = reinterpret_cast<const int4*>(a - off);
  const int4 lo = __ldg(base);
  const int4 hi = off + valid > 16 ? __ldg(base + 1) : make_int4(0, 0, 0, 0);
  const unsigned w[8] = {(unsigned)lo.x, (unsigned)lo.y, (unsigned)lo.z,
                         (unsigned)lo.w, (unsigned)hi.x, (unsigned)hi.y,
                         (unsigned)hi.z, (unsigned)hi.w};
  const int q = off >> 2, sh = 8 * (off & 3);
  unsigned v[5];
#pragma unroll
  for (int i = 0; i < 5; ++i)   // words q .. q + 4, without local memory
    v[i] = q == 0 ? w[i] : q == 1 ? w[i + 1] : q == 2 ? w[i + 2] : w[i + 3];
  unsigned r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    r[i] = __funnelshift_r(v[i], v[i + 1], sh);
    const int nb = valid - 4 * i;   // bytes of word i that are valid
    if (nb <= 0) r[i] = 0u;
    else if (nb < 4) r[i] &= (1u << (8 * nb)) - 1u;
  }
  return make_int4((int)r[0], (int)r[1], (int)r[2], (int)r[3]);
}

// Stage rows row0 .. row0 + ROWS - 1 (those below n_rows), k-bytes k0 ..
// k0 + 63 (those below K) of a K-major operand with rows `ld` bytes apart
// into a shared tile of ROWS rows kPitch bytes apart; the rest is zero.
// kAligned: rows and base 16-byte aligned, staged by cp.async; else through
// registers.
template <int ROWS, bool kAligned>
__device__ __forceinline__ void stage(int8_t* s, const int8_t* __restrict__ g,
                                      long long ld, int n_rows, int k0,
                                      int K, int tid) {
  static_assert(ROWS * (kBK / 16) % kThreads == 0, "whole rounds");
#pragma unroll
  for (int it = 0; it < ROWS * (kBK / 16) / kThreads; ++it) {
    const int c = tid + it * kThreads;
    const int r = c / (kBK / 16), col = (c % (kBK / 16)) * 16;
    const int k = k0 + col;
    const int valid = (r < n_rows && k < K) ? min(16, K - k) : 0;
    int8_t* dst = s + r * kPitch + col;
    const int8_t* src = valid ? g + r * ld + k : g;
    if constexpr (kAligned) {
      cp_async16(dst, src, valid);
    } else {
      *reinterpret_cast<int4*>(dst) =
          valid ? load16_shifted(src, valid) : make_int4(0, 0, 0, 0);
    }
  }
}

__device__ __forceinline__ float rescale(int acc, float sxr, float sw,
                                         float bias, const Epilogue& e) {
  float y = __int2float_rn(acc);
  if (e.sx_mode != 0) y = __fmul_rn(y, sxr);
  y = __fmul_rn(y, sw);
  if (e.bias != nullptr) y = __fadd_rn(y, bias);
  return y;
}

// The epilogue's factors of outputs (r, c .. c + 3) (those below N), read
// from global memory: float4s of sw and bias where N % 4 == 0.
__device__ __forceinline__ void load_scales(long long r, int c, int N,
                                            const Epilogue& e, float& sxr,
                                            float (&sw)[4], float (&b)[4]) {
  sxr = e.sx_mode == 2 ? __ldg(e.sx + r) : e.sx_mode == 1 ? __ldg(e.sx) : 1.f;
#pragma unroll
  for (int u = 0; u < 4; ++u) sw[u] = b[u] = 0.f;
  if ((N & 3) == 0) {
    const float4 w4 = __ldg(reinterpret_cast<const float4*>(e.sw + c));
    sw[0] = w4.x, sw[1] = w4.y, sw[2] = w4.z, sw[3] = w4.w;
    if (e.bias != nullptr) {
      const float4 b4 = __ldg(reinterpret_cast<const float4*>(e.bias + c));
      b[0] = b4.x, b[1] = b4.y, b[2] = b4.z, b[3] = b4.w;
    }
  } else {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (c + u >= N) break;
      sw[u] = __ldg(e.sw + c + u);
      if (e.bias != nullptr) b[u] = __ldg(e.bias + c + u);
    }
  }
}

// Outputs (r, c .. c + 3) of the product (those below N): raw int32
// partials into the workspace slice `part` when K is split, else the
// int32 sums, or their rescale by (sxr, sw, b) into e.out.  16-byte
// stores where N % 4 == 0.
__device__ __forceinline__ void store4(int4 v, long long r, int c, int N,
                                       int32_t* part, const Epilogue& e,
                                       float sxr, const float (&sw)[4],
                                       const float (&b)[4]) {
  const long long i = r * N + c;
  const int n = min(4, N - c);
  const bool vec = (N & 3) == 0;   // then n == 4 and i % 4 == 0
  const int a[4] = {v.x, v.y, v.z, v.w};
  if (part != nullptr || !e.f32) {
    int32_t* o = (part != nullptr ? part : static_cast<int32_t*>(e.out)) + i;
    if (vec) {
      *reinterpret_cast<int4*>(o) = v;
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (u < n) o[u] = a[u];
    }
    return;
  }
  float y[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) y[u] = rescale(a[u], sxr, sw[u], b[u], e);
  float* o = static_cast<float*>(e.out) + i;
  if (vec) {
    *reinterpret_cast<float4*>(o) = make_float4(y[0], y[1], y[2], y[3]);
  } else {
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (u < n) o[u] = y[u];
  }
}

// One (BM x BN output tile, K split) a block; WM x WN warps, each a
// (BM / WM) x (BN / WN) piece of the tile in m16n8k32 mma.sync steps.
template <int BM, int BN, int WM, int WN, bool kAlA, bool kAlB>
__global__ void __launch_bounds__(kThreads, 2)
int8_matmul_kernel(const int8_t* __restrict__ x, long long ldx,
                   const int8_t* __restrict__ w, long long ldw, int M, int K,
                   int N, int kt_per, int32_t* __restrict__ ws, Epilogue e) {
  static_assert(WM * WN * 32 == kThreads, "8 warps");
  constexpr int TM = BM / WM, TN = BN / WN;       // a warp's piece
  constexpr int MI = TM / 16, NI = TN / 8;
  static_assert(MI >= 1 && NI % 2 == 0, "warp piece");
  extern __shared__ __align__(16) int8_t smem[];
  int8_t* As = smem;                              // [stage][BM][kPitch]
  int8_t* Bs = smem + kStages * BM * kPitch;      // [stage][BN][kPitch]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp / WN) * TM, wn = (warp % WN) * TN;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int k_tiles = (K + kBK - 1) / kBK;
  const int kt0 = blockIdx.z * kt_per;
  const int n_kt = max(0, min(kt_per, k_tiles - kt0));
  const int8_t* xa = x + m0 * ldx;
  const int8_t* wb = w + (long long)n0 * ldw;
  const int m_rows = (int)min((long long)BM, M - m0);
  const int n_rows = min(BN, N - n0);
  // a warp whose rows or columns all lie past the edge skips its mma
  const bool live = wm < m_rows && wn < n_rows;
  // the epilogue's factors of the tile's rows and columns, read now so
  // that their loads overlap the main loop (zero past the edges)
  const bool rescaled = e.f32 && gridDim.z == 1;
  __shared__ float s_sx[BM], s_sw[BN], s_b[BN];
  if (rescaled) {
    for (int i = tid; i < BM; i += kThreads)
      s_sx[i] = e.sx_mode == 2 ? (i < m_rows ? e.sx[m0 + i] : 0.f)
              : e.sx_mode == 1 ? e.sx[0] : 1.f;
    for (int i = tid; i < BN; i += kThreads) {
      s_sw[i] = i < n_rows ? e.sw[n0 + i] : 0.f;
      s_b[i] = e.bias != nullptr && i < n_rows ? e.bias[n0 + i] : 0.f;
    }
  }

  int acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0;

  auto load = [&](int t, int slot) {
    const int k0 = (kt0 + t) * kBK;
    stage<BM, kAlA>(As + slot * BM * kPitch, xa, ldx, m_rows, k0, K, tid);
    stage<BN, kAlB>(Bs + slot * BN * kPitch, wb, ldw, n_rows, k0, K, tid);
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_kt) load(s, s);
    cp_commit();
  }
  for (int t = 0; t < n_kt; ++t) {
    cp_wait<kStages - 2>();
    __syncthreads();   // tile t landed; every warp is done with tile t - 1
    const int next = t + kStages - 1;
    if (next < n_kt) load(next, next % kStages);
    cp_commit();
    if (!live) continue;
    const int8_t* a_s = As + (t % kStages) * BM * kPitch;
    const int8_t* b_s = Bs + (t % kStages) * BN * kPitch;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      // A (16 x 32, row-major): matrices rows 0-7 / 8-15 x k 0-15 / 16-31;
      // B (32 x 8, K-major rows): two n8 pieces x k 0-15 / 16-31
      int a[MI][4], b[NI][2];
#pragma unroll
      for (int i = 0; i < MI; ++i)
        ldmatrix_x4(a[i], a_s + (wm + i * 16 + (lane & 15)) * kPitch + kk +
                              (lane >> 4) * 16);
#pragma unroll
      for (int j = 0; j < NI; j += 2) {
        int r[4];
        ldmatrix_x4(r, b_s + (wn + j * 8 + (lane & 7) + ((lane >> 4) << 3)) *
                                 kPitch +
                             kk + ((lane >> 3) & 1) * 16);
        b[j][0] = r[0];
        b[j][1] = r[1];
        b[j + 1][0] = r[2];
        b[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j) mma_s8(acc[i][j], a[i], b[j]);
    }
  }
  cp_wait<0>();
  __syncthreads();   // every warp is done with the ring

  // The ring becomes the output tile, [BM][BN + 8] int32: the C
  // fragments (16 x 8: row g, columns 2t and 2t + 1, then row g + 8) land
  // there without bank conflicts (a half warp's 4 rows are 8 banks
  // apart), and leave in 16-byte stores of whole rows.
  constexpr int CP = BN + 8;
  static_assert(BM * CP * 4 <= kStages * (BM + BN) * kPitch, "tile fits");
  int32_t* Cs = reinterpret_cast<int32_t*>(smem);
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<int2*>(Cs + (wm + i * 16 + g + h * 8) * CP + wn +
                                 j * 8 + tq * 2) =
            make_int2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
  __syncthreads();
  int32_t* part =
      gridDim.z > 1 ? ws + (long long)blockIdx.z * M * N : nullptr;
  constexpr int Q = BN / 4;   // 16-byte pieces a tile row
  for (int p = tid; p < BM * Q; p += kThreads) {
    const int rr = p / Q, cc = (p % Q) * 4;
    if (rr >= m_rows || cc >= n_rows) continue;
    float sw[4] = {0.f, 0.f, 0.f, 0.f}, b[4] = {0.f, 0.f, 0.f, 0.f};
    float sxr = 1.f;
    if (rescaled) {
      sxr = s_sx[rr];
#pragma unroll
      for (int u = 0; u < 4; ++u) sw[u] = s_sw[cc + u], b[u] = s_b[cc + u];
    }
    store4(*reinterpret_cast<const int4*>(Cs + rr * CP + cc), m0 + rr,
           n0 + cc, N, part, e, sxr, sw, b);
  }
}

// out (or y) from the `splits` int32 partials of the workspace, summed in
// split order; four neighbouring outputs of one row a thread.
__global__ void __launch_bounds__(256)
int8_splitk_reduce_kernel(const int32_t* __restrict__ ws, int splits, int M,
                          int N, Epilogue e) {
  const int q4 = (N + 3) / 4;   // pieces of 4 a row
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= (long long)M * q4) return;
  const long long r = p / q4;
  const int c = (int)(p - r * q4) * 4;
  const int n = min(4, N - c);
  const long long mn = (long long)M * N, i = r * N + c;
  int s[4] = {0, 0, 0, 0};
  for (int z = 0; z < splits; ++z) {
    const int32_t* src = ws + z * mn + i;
    if ((N & 3) == 0) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(src));
      s[0] += v.x, s[1] += v.y, s[2] += v.z, s[3] += v.w;
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (u < n) s[u] += src[u];
    }
  }
  float sxr = 1.f, sw[4] = {}, b[4] = {};
  if (e.f32) load_scales(r, c, N, e, sxr, sw, b);
  store4(make_int4(s[0], s[1], s[2], s[3]), r, c, N, nullptr, e, sxr, sw, b);
}

template <int BM, int BN, int WM, int WN, bool kAlA, bool kAlB>
cudaError_t launch_tiles(const int8_t* x, long long ldx, const int8_t* w,
                         long long ldw, int M, int K, int N, int splits,
                         int kt_per, int32_t* ws, const Epilogue& e,
                         cudaStream_t st) {
  auto kernel = int8_matmul_kernel<BM, BN, WM, WN, kAlA, kAlB>;
  const int smem = kStages * (BM + BN) * kPitch;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((M + BM - 1) / BM), (N + BN - 1) / BN, splits);
  kernel<<<grid, kThreads, smem, st>>>(x, ldx, w, ldw, M, K, N, kt_per, ws, e);
  return cudaGetLastError();
}

template <int BM, int BN, int WM, int WN>
cudaError_t launch_aligned(bool al_a, bool al_b, const int8_t* x,
                           long long ldx, const int8_t* w, long long ldw,
                           int M, int K, int N, int splits, int kt_per,
                           int32_t* ws, const Epilogue& e, cudaStream_t st) {
#define INT8_TILES(A_, B_)                                                   \
  return launch_tiles<BM, BN, WM, WN, A_, B_>(x, ldx, w, ldw, M, K, N,       \
                                              splits, kt_per, ws, e, st)
  if (al_a && al_b) INT8_TILES(true, true);
  if (al_a) INT8_TILES(true, false);
  if (al_b) INT8_TILES(false, true);
  INT8_TILES(false, false);
#undef INT8_TILES
}

}  // namespace

// x: M rows of K int8, `ldx` bytes apart; w: the K-major weight, N rows of
// K int8, `ldw` bytes apart.  The caller's plan: tiles of bm x bn (128 x
// 128 or 128 x 64), K cut into `splits` runs of kt_per 64-byte k-tiles
// that cover K, each run non-empty; with splits > 1, ws is int32 scratch
// of ws_ints >= splits * M * N.  out_f32 == 0: out is int32 (M, N); else
// out is float32 (M, N), y = acc * sx * sw (+ bias), sx_mode 0 (no sx), 1
// (the scalar sx[0]) or 2 (sx[m] per row), sw (N,) and bias (N,) or null,
// both 16-byte aligned where N % 4 == 0.
// A plan, a workspace or an argument that falls short returns
// cudaErrorInvalidValue before any launch.  Launches on `stream` (the
// tiles, then with splits > 1 the sum of the partials), does not
// synchronise, allocates nothing, and returns cudaGetLastError() after the
// launches.
extern "C" int int8_matmul_s8(const int8_t* x, long long ldx,
                              const int8_t* w, long long ldw, int M, int K,
                              int N, int bm, int bn, int splits, int kt_per,
                              int32_t* ws, long long ws_ints, void* out,
                              int out_f32, const float* sx, int sx_mode,
                              const float* sw, const float* bias,
                              void* stream) {
  if (M < 0 || K < 0 || N < 0 || ldx < K || ldw < K || out == nullptr)
    return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return 0;
  const int k_tiles = (K + kBK - 1) / kBK;
  const bool plan_ok =
      splits >= 1 && splits <= 65535 && kt_per >= 1 &&
      (long long)splits * kt_per >= k_tiles &&
      (long long)(splits - 1) * kt_per < (k_tiles > 0 ? k_tiles : 1) &&
      (splits == 1 || (ws != nullptr && ws_ints >= (long long)splits * M * N));
  // where N % 4 == 0 the epilogue reads sw and bias as float4
  const bool vec_ok =
      N % 4 != 0 || ((reinterpret_cast<uintptr_t>(sw) & 15) == 0 &&
                     (reinterpret_cast<uintptr_t>(bias) & 15) == 0);
  const bool epi_ok =
      !out_f32 || (sw != nullptr && sx_mode >= 0 && sx_mode <= 2 &&
                   (sx_mode == 0 || sx != nullptr) && vec_ok);
  if (!plan_ok || !epi_ok || (N + bn - 1) / bn > 65535)
    return (int)cudaErrorInvalidValue;
  const Epilogue e{out, out_f32, sx, sx_mode, sw, bias};
  const bool al_a =
      ldx % 16 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const bool al_b =
      ldw % 16 == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the tiles write int32 partials to ws when K is split
  cudaError_t err;
  if (bm == 128 && bn == 128)
    err = launch_aligned<128, 128, 2, 4>(al_a, al_b, x, ldx, w, ldw, M, K, N,
                                         splits, kt_per, ws, e, st);
  else if (bm == 128 && bn == 64)
    err = launch_aligned<128, 64, 4, 2>(al_a, al_b, x, ldx, w, ldw, M, K, N,
                                        splits, kt_per, ws, e, st);
  else
    return (int)cudaErrorInvalidValue;
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long pieces = (long long)M * ((N + 3) / 4);
  int8_splitk_reduce_kernel<<<(unsigned)((pieces + 255) / 256), 256, 0, st>>>(
      ws, splits, M, N, e);
  return (int)cudaGetLastError();
}

extern "C" const char* int8_matmul_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
