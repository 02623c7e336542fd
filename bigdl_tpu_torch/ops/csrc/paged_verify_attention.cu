// Paged speculative-verify attention, float32 or int8 pages, for Hopper
// (sm_90a).
//
// Replaces bigdl_tpu/ops/flash_attention.py: paged_verify_attention, whose
// Pallas kernel is _verify_kernel.  One call scores a whole drafted chunk of
// C = k + 1 queries per slot against the slot's paged KV cache.  Query c of
// slot s sits at cache position positions[s] + c and attends the keys at
// positions <= positions[s] + c (a per-query causal staircase), so its output
// equals the one of a single-query decode step at that position:
//
//   out[s, h, c] = softmax(q[s, h, c] . K[s, h, :p+c]^T * sm_scale)
//                  . V[s, h, :p+c],   p = positions[s]
//
// Key position j * page + t of slot s is read from
// pages[page_table[s, j], h, t, :] (times k_scales / v_scales[page] for int8
// pages).  Online softmax in float32; a row with denominator 0 divides by 1.
//
// What bounds it: device-memory bytes.  The walk of a slot reads its K and V
// up to position p + C - 1 once for all C queries: about 4 C flops per 8
// bytes (2 for int8), still below the ridge point for any C the engine uses,
// so the floor is those bytes over 3.35 TB/s.  At the serving shape (16
// slots, 12 heads, head_dim 64, C = 5) that is 46 MB of float32 pages, 14
// microseconds; what a call costs is how many SMs its walk keeps busy.
//
// What the design does about it (the decode kernel's split walk, with the C
// queries of a slot sharing every loaded row):
// - A split walk.  Each slot's keys are cut into chunks of `chunk_pages`
//   whole pages, and one block of 4 warps takes one (chunk, head, slot).
//   The wrapper chooses the split from the page size and the table's width
//   alone (ops/flash_attention.py: decode_chunks, 128 keys a chunk) and the
//   entry checks it against the table and the workspace.  A block whose
//   chunk starts past its slot's last visible key, positions[s] + C - 1,
//   writes empty partials (l = 0) and exits.  No host read of `positions`,
//   no synchronise, a launch shape fixed by the table: a CUDA graph can
//   capture the call.
// - Whole rows in 16-byte loads, as the decode kernel reads them: a lane
//   holds 16 neighbouring values of a row (one int4 of int8 values, or
//   four float4), head_dim / 16 lanes a row, two rows in flight.  Each
//   loaded K row is scored against every query of the slot (q sits in
//   shared memory), under the staircase; an int8 page's scale multiplies
//   the score and p once per key.
// - Per-query state off the registers.  A warp's round of rows parks its
//   V rows and its p values in shared memory, and each lane then owns
//   head_dim / 32 columns of every query's accumulator, also in shared
//   memory; (max, denominator) per query sit beside them.  No register
//   grows with C, so any C runs in one pass over the rows (C bounded only
//   by shared memory: the entry refuses what does not fit).
// - A merge in fixed order.  Each block merges its warps per query and
//   writes one partial (m, l, acc[head_dim]) per (slot, head, query,
//   chunk) to a float32 workspace the wrapper allocates; the decode
//   kernel's merge (paged_attention_common.cuh), launched by the same
//   entry, merges each query's partials in chunk order.  No atomics: two
//   launches give the same bits.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "paged_attention_common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kVals = 16;          // values of a row held by a lane
constexpr int kJ = 2;              // rows a lane loads in a round
constexpr int kMaxChunkPages = kWarps * 32;   // one table entry a thread
constexpr int kMaxSmem = 232448;              // a block's shared memory

// Floats of a block's shared memory: V rows and p of each warp's round,
// each warp's accumulators and (m, l, alpha) per query, and q.
template <int D>
constexpr long long smem_floats(int C) {
  constexpr int R = kJ * 32 / (D / kVals);    // rows a warp's round
  return (long long)kWarps * R * D + (long long)kWarps * C * D +
         (long long)C * D + (long long)kWarps * C * R + 3LL * kWarps * C;
}

template <int D, typename T>
__global__ void __launch_bounds__(kWarps * 32)
paged_verify_split_kernel(const float* __restrict__ q,
                          const T* __restrict__ k_pages,
                          const T* __restrict__ v_pages,
                          const float* __restrict__ k_scales,
                          const float* __restrict__ v_scales,
                          const int* __restrict__ page_table, int pt_stride,
                          const int* __restrict__ positions,
                          float* __restrict__ ws, int heads, int page,
                          int n_blocks, int chunk_pages, int C,
                          float sm_scale) {
  constexpr int LPR = D / kVals;   // lanes a row
  constexpr int RPP = 32 / LPR;    // rows a warp reads at once
  constexpr int R = kJ * RPP;      // rows a warp takes in a round
  constexpr int DL = D / 32;       // accumulator columns a lane owns
  const int c = blockIdx.x, h = blockIdx.y, s = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = lane / LPR, cg = lane % LPR;
  const int ck = chunk_pages * page;   // keys a chunk
  const int c0 = c * ck;
  extern __shared__ __align__(16) float smem[];
  float* s_v = smem + warp * R * D;                       // [R][D]
  float* s_acc = smem + kWarps * R * D + warp * C * D;    // [C][D]
  float* s_q = smem + kWarps * R * D + kWarps * C * D;    // [C][D]
  float* s_p = s_q + C * D + warp * C * R;                // [C][R]
  float* s_m = s_q + C * D + kWarps * C * R + warp * 3 * C;
  float* s_l = s_m + C;
  float* s_a = s_l + C;
  __shared__ int s_pid[kMaxChunkPages];

  // the slot's position, the chunk's table entries and q are read at once:
  // none waits on another
  const int first = c * chunk_pages;
  const int* pt = page_table + (size_t)s * pt_stride + first;
  if (threadIdx.x < min(chunk_pages, n_blocks - first))
    s_pid[threadIdx.x] = pt[threadIdx.x];
  const float* qs = q + ((size_t)s * heads + h) * C * D;
  for (int i = threadIdx.x; i < C * D / 4; i += kWarps * 32)
    reinterpret_cast<float4*>(s_q)[i] = reinterpret_cast<const float4*>(qs)[i];
  for (int i = lane; i < C * D; i += 32) s_acc[i] = 0.f;
  for (int i = lane; i < C; i += 32) {
    s_m[i] = -INFINITY;
    s_l[i] = 0.f;
  }
  const int pos = positions[s];
  // the last query sees the furthest key; the table's width caps the walk
  // as the TPU grid did.  A chunk past it has no keys: its warps take no
  // round, and it writes empty partials (l = 0)
  const int n_keys = min(pos + C, n_blocks * page);
  const int n_here = max(0, min(ck, n_keys - c0));   // keys of this chunk
  __syncthreads();

  const size_t page_elems = (size_t)heads * page * D;
  const size_t head_off = (size_t)h * page * D + (size_t)cg * kVals;
  for (int u0 = warp * R; u0 < n_here; u0 += kWarps * R) {
    paged::Row16<T> kr[kJ], vr[kJ];
    bool ok[kJ];
    float ksc[kJ], vsc[kJ];   // the rows' page scales (1 for float32)
    // every row of the round is requested before any is used
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const int u = u0 + row + RPP * j;
      ok[j] = u < n_here;
      ksc[j] = vsc[j] = 1.f;
      if (ok[j]) {
        const int pi = u / page;
        const int pid = s_pid[pi];
        const size_t off = (size_t)pid * page_elems + head_off +
                           (size_t)(u - pi * page) * D;
        kr[j].load(k_pages + off);
        vr[j].load(v_pages + off);
        if constexpr (sizeof(T) == 1) {
          ksc[j] = k_scales[pid];
          vsc[j] = v_scales[pid];
        }
      }
    }
    // the round's V rows, unscaled (zeros past the chunk's keys)
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      float4* dst = reinterpret_cast<float4*>(
          s_v + (row + RPP * j) * D + cg * kVals);
#pragma unroll
      for (int i = 0; i < kVals / 4; ++i)
        dst[i] = ok[j] ? make_float4(vr[j][4 * i], vr[j][4 * i + 1],
                                     vr[j][4 * i + 2], vr[j][4 * i + 3])
                       : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    for (int cq = 0; cq < C; ++cq) {
      // key c0 + u is visible to query cq when c0 + u <= pos + cq
      const int lim = pos + cq - c0;
      const float4* qv = reinterpret_cast<const float4*>(s_q + cq * D +
                                                         cg * kVals);
      float sc[kJ];
#pragma unroll
      for (int j = 0; j < kJ; ++j) sc[j] = 0.f;
#pragma unroll
      for (int i = 0; i < kVals / 4; ++i) {
        const float4 qq = qv[i];
#pragma unroll
        for (int j = 0; j < kJ; ++j) {
          sc[j] = fmaf(qq.x, kr[j][4 * i], sc[j]);
          sc[j] = fmaf(qq.y, kr[j][4 * i + 1], sc[j]);
          sc[j] = fmaf(qq.z, kr[j][4 * i + 2], sc[j]);
          sc[j] = fmaf(qq.w, kr[j][4 * i + 3], sc[j]);
        }
      }
      // a row's LPR lanes hold its partial dots
#pragma unroll
      for (int o = 1; o < LPR; o <<= 1) {
#pragma unroll
        for (int j = 0; j < kJ; ++j)
          sc[j] += __shfl_xor_sync(0xffffffffu, sc[j], o);
      }
      bool vis[kJ];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        sc[j] *= sm_scale * ksc[j];
        vis[j] = ok[j] && u0 + row + RPP * j <= lim;
        if (vis[j]) mx = fmaxf(mx, sc[j]);
      }
#pragma unroll
      for (int o = LPR; o < 32; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = s_m[cq];
      // mx is the same in every lane: a round with no key visible to cq
      // leaves its state as it was
      const float m_new = mx == -INFINITY ? m_old : fmaxf(m_old, mx);
      const float alpha = mx == -INFINITY ? 1.f : expf(m_old - m_new);
      float p[kJ], psum = 0.f;
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        p[j] = vis[j] ? expf(sc[j] - m_new) : 0.f;
        psum += p[j];
      }
#pragma unroll
      for (int o = LPR; o < 32; o <<= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, o);
      if (cg == 0) {
#pragma unroll
        for (int j = 0; j < kJ; ++j)
          s_p[cq * R + row + RPP * j] = p[j] * vsc[j];
      }
      if (lane == 0) {
        s_m[cq] = m_new;
        s_l[cq] = s_l[cq] * alpha + psum;
        s_a[cq] = alpha;
      }
    }
    __syncwarp();
    // acc[cq] = acc[cq] * alpha + sum_u p[cq][u] v[u], a lane's DL columns
    const int nr = min(R, n_here - u0);
    for (int cq = 0; cq < C; ++cq) {
      const float alpha = s_a[cq];
      float a[DL];
#pragma unroll
      for (int e = 0; e < DL; ++e) a[e] = s_acc[cq * D + lane * DL + e] * alpha;
      for (int r0 = 0; r0 < nr; r0 += 4) {
        const float4 pp = *reinterpret_cast<const float4*>(s_p + cq * R + r0);
        const float pr[4] = {pp.x, pp.y, pp.z, pp.w};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
#pragma unroll
          for (int e = 0; e < DL; ++e)
            a[e] = fmaf(pr[r], s_v[(r0 + r) * D + lane * DL + e], a[e]);
        }
      }
#pragma unroll
      for (int e = 0; e < DL; ++e) s_acc[cq * D + lane * DL + e] = a[e];
    }
    __syncwarp();   // the round's rows and p are read before the next
  }
  __syncthreads();

  // the block's partial per query: its warps merged in order
  float* acc0 = smem + kWarps * R * D;
  float* ml0 = smem + kWarps * R * D + kWarps * C * D + C * D + kWarps * C * R;
  const int n_chunks = gridDim.x;
  for (int i = threadIdx.x; i < C * D; i += kWarps * 32) {
    const int cq = i / D, d = i - cq * D;
    float mb = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* ml = ml0 + w * 3 * C;
      if (ml[C + cq] > 0.f) mb = fmaxf(mb, ml[cq]);
    }
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* ml = ml0 + w * 3 * C;
      if (ml[C + cq] > 0.f) {   // a warp that saw no key adds nothing
        const float e = expf(ml[cq] - mb);
        den = fmaf(ml[C + cq], e, den);
        num = fmaf(acc0[(w * C + cq) * D + d], e, num);
      }
    }
    float* part =
        ws + ((((size_t)s * heads + h) * C + cq) * n_chunks + c) * (D + 2);
    part[d] = num;
    if (d == 0) {
      part[D] = mb;
      part[D + 1] = den;
    }
  }
}

template <int D, typename T>
cudaError_t launch(const float* q, const T* k_pages, const T* v_pages,
                   const float* k_scales, const float* v_scales,
                   const int* page_table, int pt_stride,
                   const int* positions, float* ws, long long ws_floats,
                   float* out, int slots, int heads, int page, int n_blocks,
                   int chunk_pages, int n_chunks, int C, float sm_scale,
                   cudaStream_t stream) {
  // the caller's split must cover the table, its workspace hold every
  // (slot, head, query, chunk) partial, and the per-query state fit in a
  // block's shared memory
  const long long smem = 4 * smem_floats<D>(C);
  if ((long long)n_chunks * chunk_pages < n_blocks ||
      ws_floats < (long long)slots * heads * C * n_chunks * (D + 2) ||
      smem + 4 * kMaxChunkPages > kMaxSmem ||
      (long long)heads * C > 65535)
    return cudaErrorInvalidValue;
  if (n_chunks > 0) {
    auto kernel = paged_verify_split_kernel<D, T>;
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    kernel<<<dim3(n_chunks, heads, slots), kWarps * 32, (size_t)smem,
             stream>>>(q, k_pages, v_pages, k_scales, v_scales, page_table,
                       pt_stride, positions, ws, heads, page, n_blocks,
                       chunk_pages, C, sm_scale);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  // one merge row a (slot, head, query)
  paged::merge_kernel<D><<<dim3(heads * C, slots), D, 0, stream>>>(ws, out,
                                                                   n_chunks);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const float* q, const T* k_pages, const T* v_pages,
             const float* k_scales, const float* v_scales,
             const int* page_table, int pt_stride, const int* positions,
             float* ws, long long ws_floats, float* out, int slots, int heads,
             int page, int n_blocks, int chunk_pages, int n_chunks, int chunk,
             int head_dim, float sm_scale, void* stream) {
  if (slots <= 0 || heads <= 0 || chunk <= 0) return 0;
  if (page <= 0 || n_blocks < 0 || chunk_pages <= 0 ||
      chunk_pages > kMaxChunkPages || n_chunks < 0 || n_chunks > 65535 ||
      slots > 65535 || heads > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PAGED_VERIFY(D_)                                                     \
  return (int)launch<D_, T>(q, k_pages, v_pages, k_scales, v_scales,         \
                            page_table, pt_stride, positions, ws, ws_floats, \
                            out, slots, heads, page, n_blocks, chunk_pages,  \
                            n_chunks, chunk, sm_scale, st)
  switch (head_dim) {
    case 32: PAGED_VERIFY(32);
    case 64: PAGED_VERIFY(64);
    case 128: PAGED_VERIFY(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef PAGED_VERIFY
}

}  // namespace

// q and out (slots, heads, chunk, head_dim) and k_pages / v_pages (pages,
// heads, page, head_dim) are contiguous float32, q and the pages 16-byte
// aligned; page_table is int32 with rows pt_stride apart; positions is
// int32 (slots,), the first query's cache position.  The caller chooses
// the split: n_chunks chunks of chunk_pages pages (1 .. 128) that cover the
// n_blocks table entries, and ws, float32 scratch of ws_floats floats, at
// least slots * heads * chunk * n_chunks * (head_dim + 2); a split or a
// workspace that falls short, or a chunk whose per-query state does not
// fit a block's shared memory, returns cudaErrorInvalidValue before any
// launch.  Launches the split walk and the merge on `stream`, does not
// synchronise, allocates nothing, reads nothing on the host, and returns
// cudaGetLastError() after the launches.
extern "C" int paged_verify_attention_f32(
    const float* q, const float* k_pages, const float* v_pages,
    const int* page_table, int pt_stride, const int* positions, float* ws,
    long long ws_floats, float* out, int slots, int heads, int page,
    int n_blocks, int chunk_pages, int n_chunks, int chunk, int head_dim,
    float sm_scale, void* stream) {
  return dispatch<float>(q, k_pages, v_pages, nullptr, nullptr, page_table,
                         pt_stride, positions, ws, ws_floats, out, slots,
                         heads, page, n_blocks, chunk_pages, n_chunks, chunk,
                         head_dim, sm_scale, stream);
}

// The same over int8 pools: k_pages / v_pages are contiguous int8 and
// k_scales / v_scales (pages,) float32, one scale per pool page.
extern "C" int paged_verify_attention_i8(
    const float* q, const int8_t* k_pages, const int8_t* v_pages,
    const float* k_scales, const float* v_scales, const int* page_table,
    int pt_stride, const int* positions, float* ws, long long ws_floats,
    float* out, int slots, int heads, int page, int n_blocks,
    int chunk_pages, int n_chunks, int chunk, int head_dim, float sm_scale,
    void* stream) {
  return dispatch<int8_t>(q, k_pages, v_pages, k_scales, v_scales,
                          page_table, pt_stride, positions, ws, ws_floats,
                          out, slots, heads, page, n_blocks, chunk_pages,
                          n_chunks, chunk, head_dim, sm_scale, stream);
}

extern "C" const char* paged_verify_attention_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
