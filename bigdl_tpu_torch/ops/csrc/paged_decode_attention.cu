// Paged decode-step attention, float32 or int8 pages, for Hopper (sm_90a).
//
// Replaces bigdl_tpu/ops/flash_attention.py: paged_decode_attention, whose
// Pallas kernel is _decode_kernel, in both its forms: float32 pages, and
// int8 pages with one float32 scale per pool page (quantized=True).  It
// computes, for every slot s and head h,
//
//   out[s, h] = softmax(q[s, h] . K[s, h, :]^T * sm_scale) . V[s, h, :]
//
// over the key positions 0 .. lengths[s] (lengths is INCLUSIVE), where key
// position j * page + t of slot s is read from pages[page_table[s, j], h, t, :]
// (times k_scales / v_scales[page_table[s, j]] for int8 pages).  The running
// (max, denominator, accumulator) of the online softmax stays in float32, and
// a row whose denominator is 0 divides by 1.
//
// What bounds it: device-memory bytes.  A call must read
// sum_s (lengths[s] + 1) * heads * head_dim bytes of K and as many of V
// (times 4 for float32 pages), plus q and out, and does about 4 flops per 8
// bytes read (per 2 bytes for int8): far below the H100's ridge point, so its
// floor is those bytes over 3.35 TB/s.  At the serving shape (16 slots, 12
// heads, head_dim 64) that is 11.5 MB of int8 pages, a few microseconds:
// what a call costs is how many SMs its walk keeps busy, and its launches.
//
// What the design does about it (flash-decoding):
// - A split walk.  Each slot's keys are cut into chunks of `chunk_pages`
//   whole pages, and one block of 4 warps takes one (chunk, head, slot).
//   The wrapper chooses and passes the split (128 keys at pages of 16:
//   faster on the card than 64 or 256 for both page types), and the entry
//   checks it against the table and the workspace.  The grid is sized
//   from the table's width (n_blocks pages), never from `lengths`: a block
//   whose chunk starts past its slot's inclusive length writes an empty
//   partial (l = 0) and exits.  No host read of `lengths`, no synchronise,
//   and a launch shape fixed by the table, so a CUDA graph can capture the
//   call.  The longest slot no longer walks alone on one SM while the
//   others idle.
// - Whole rows in 16-byte loads.  A lane holds 16 neighbouring values of a
//   row (one int4 of int8 values, or four float4), head_dim / 16 lanes a
//   row, and two rows in flight: a round of a warp reads 2 x 32 x 16 bytes
//   of K and as many of V (times 4 for float32), whole pages in contiguous
//   runs, every load issued before the first is used.  (Four int8 rows in
//   flight measured no faster.)  A chunk's page-table entries are read once, beside the
//   slot's length, into shared memory; an int8 page's scale multiplies the
//   score and p once per key, not every value.
// - A merge in fixed order.  Each block merges its warps' (max,
//   denominator, accumulator) in shared memory and writes one partial
//   (m, l, acc[head_dim]) to a float32 workspace the wrapper allocates; a
//   second kernel, launched by the same entry point, merges a (slot, head)'s
//   partials in chunk order, every partial's loads issued at once.  No
//   atomics: two launches give the same bits.
// - What is left: a block's chain of two dependent device-memory reads
//   (length and table, then K and V) times the waves of blocks, and the
//   second launch; one launch per step of a CUDA graph would hide the
//   rest.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "paged_attention_common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kVals = 16;          // values of a row held by a lane
constexpr int kJ = 2;              // rows a lane loads in a round
constexpr int kMaxChunkPages = kWarps * 32;   // one table entry a thread

template <int D, typename T>
__global__ void __launch_bounds__(kWarps * 32)
paged_decode_split_kernel(const float* __restrict__ q,
                          const T* __restrict__ k_pages,
                          const T* __restrict__ v_pages,
                          const float* __restrict__ k_scales,
                          const float* __restrict__ v_scales,
                          const int* __restrict__ page_table, int pt_stride,
                          const int* __restrict__ lengths,
                          float* __restrict__ ws, int heads, int page,
                          int n_blocks, int chunk_pages, float sm_scale) {
  constexpr int LPR = D / kVals;   // lanes a row
  constexpr int RPP = 32 / LPR;    // rows a warp reads at once
  constexpr int KR = kJ * RPP;     // keys a warp takes in a round
  const int c = blockIdx.x, h = blockIdx.y, s = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = lane / LPR, cg = lane % LPR;
  const int ck = chunk_pages * page;   // keys a chunk
  const int c0 = c * ck;
  __shared__ int s_pid[kMaxChunkPages];
  __shared__ float s_m[kWarps], s_l[kWarps];
  __shared__ float s_acc[kWarps][D];
  // the slot's length, the chunk's table entries and q are read at once:
  // none waits on another (a chunk inside the table's width is a valid
  // read whatever the length)
  const int first = c * chunk_pages;
  const int* pt = page_table + (size_t)s * pt_stride + first;
  if (threadIdx.x < min(chunk_pages, n_blocks - first))
    s_pid[threadIdx.x] = pt[threadIdx.x];
  float qv[kVals];
  const float* qs = q + ((size_t)s * heads + h) * D + cg * kVals;
#pragma unroll
  for (int i = 0; i < kVals; ++i) qv[i] = qs[i];
  // inclusive length; the table's width caps the walk as the TPU grid did.
  // A chunk past it has no keys: its warps take no round, and it writes an
  // empty partial (l = 0)
  const int n_keys = min(lengths[s] + 1, n_blocks * page);
  const int n_here = max(0, min(ck, n_keys - c0));   // keys of this chunk
  __syncthreads();

  const size_t page_elems = (size_t)heads * page * D;
  const size_t head_off = (size_t)h * page * D + (size_t)cg * kVals;
  float m = -INFINITY;   // the same in every lane of the warp
  float l = 0.f;         // this lane's rows' share of the denominator
  float acc[kVals];      // this lane's rows' share of its 16 columns
#pragma unroll
  for (int i = 0; i < kVals; ++i) acc[i] = 0.f;

  for (int u0 = warp * KR; u0 < n_here; u0 += kWarps * KR) {
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
    float sc[kJ];
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < kVals; ++i) dot = fmaf(qv[i], kr[j][i], dot);
      sc[j] = dot;
    }
    // a row's LPR lanes hold its partial dots
#pragma unroll
    for (int o = 1; o < LPR; o <<= 1) {
#pragma unroll
      for (int j = 0; j < kJ; ++j)
        sc[j] += __shfl_xor_sync(0xffffffffu, sc[j], o);
    }
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      sc[j] *= sm_scale * ksc[j];
      if (ok[j]) mx = fmaxf(mx, sc[j]);
    }
#pragma unroll
    for (int o = LPR; o < 32; o <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    // key u0 is always valid, so m_new is finite; exp(-inf) is 0
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int i = 0; i < kVals; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      if (ok[j]) {
        const float p = expf(sc[j] - m_new);
        l += p;
        const float pv = p * vsc[j];
#pragma unroll
        for (int i = 0; i < kVals; ++i) acc[i] = fmaf(pv, vr[j][i], acc[i]);
      }
    }
    m = m_new;
  }

  // the warp's sums over its row groups (the LPR lanes of a row agree)
#pragma unroll
  for (int o = LPR; o < 32; o <<= 1) {
    l += __shfl_xor_sync(0xffffffffu, l, o);
#pragma unroll
    for (int i = 0; i < kVals; ++i)
      acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], o);
  }
  if (lane == 0) {
    s_m[warp] = m;
    s_l[warp] = l;
  }
  if (lane < LPR) {
#pragma unroll
    for (int i = 0; i < kVals; ++i) s_acc[warp][lane * kVals + i] = acc[i];
  }
  __syncthreads();

  // the block's partial: its warps merged in order
  float* part = ws + (((size_t)s * heads + h) * gridDim.x + c) * (D + 2);
  float mb = -INFINITY;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (s_l[w] > 0.f) mb = fmaxf(mb, s_m[w]);
  }
  for (int d = threadIdx.x; d < D; d += kWarps * 32) {
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (s_l[w] > 0.f) {   // a warp that saw no key adds nothing
        const float e = expf(s_m[w] - mb);
        den = fmaf(s_l[w], e, den);
        num = fmaf(s_acc[w][d], e, num);
      }
    }
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
                   const int* page_table, int pt_stride, const int* lengths,
                   float* ws, long long ws_floats, float* out, int slots,
                   int heads, int page, int n_blocks, int chunk_pages,
                   int n_chunks, float sm_scale, cudaStream_t stream) {
  // the caller's split must cover the table, and its workspace hold every
  // (slot, head, chunk) partial
  if ((long long)n_chunks * chunk_pages < n_blocks ||
      ws_floats < (long long)slots * heads * n_chunks * (D + 2))
    return cudaErrorInvalidValue;
  if (n_chunks > 0) {
    paged_decode_split_kernel<D, T>
        <<<dim3(n_chunks, heads, slots), kWarps * 32, 0, stream>>>(
            q, k_pages, v_pages, k_scales, v_scales, page_table, pt_stride,
            lengths, ws, heads, page, n_blocks, chunk_pages, sm_scale);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  paged::merge_kernel<D><<<dim3(heads, slots), D, 0, stream>>>(ws, out,
                                                               n_chunks);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const float* q, const T* k_pages, const T* v_pages,
             const float* k_scales, const float* v_scales,
             const int* page_table, int pt_stride, const int* lengths,
             float* ws, long long ws_floats, float* out, int slots, int heads,
             int page, int n_blocks, int chunk_pages, int n_chunks,
             int head_dim, float sm_scale, void* stream) {
  if (slots <= 0 || heads <= 0) return 0;
  if (page <= 0 || n_blocks < 0 || chunk_pages <= 0 ||
      chunk_pages > kMaxChunkPages || n_chunks < 0 || n_chunks > 65535 ||
      slots > 65535 || heads > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PAGED_DECODE(D_)                                                     \
  return (int)launch<D_, T>(q, k_pages, v_pages, k_scales, v_scales,         \
                            page_table, pt_stride, lengths, ws, ws_floats,   \
                            out, slots, heads, page, n_blocks, chunk_pages,  \
                            n_chunks, sm_scale, st)
  switch (head_dim) {
    case 32: PAGED_DECODE(32);
    case 64: PAGED_DECODE(64);
    case 128: PAGED_DECODE(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef PAGED_DECODE
}

}  // namespace

// q (slots, heads, head_dim), k_pages / v_pages (pages, heads, page,
// head_dim) and out (slots, heads, head_dim) are contiguous float32, the
// pages 16-byte aligned; page_table is int32 with rows pt_stride apart;
// lengths is int32 (slots,).  The caller chooses the split: n_chunks
// chunks of chunk_pages pages (1 .. 128) that cover the n_blocks table
// entries, and ws, float32 scratch of ws_floats floats, at least slots *
// heads * n_chunks * (head_dim + 2); a split or a workspace that falls
// short returns cudaErrorInvalidValue before any launch.  Launches the
// split walk and the merge on `stream`, does not synchronise, allocates
// nothing, reads nothing on the host, and returns cudaGetLastError()
// after the launches.
extern "C" int paged_decode_attention_f32(
    const float* q, const float* k_pages, const float* v_pages,
    const int* page_table, int pt_stride, const int* lengths, float* ws,
    long long ws_floats, float* out, int slots, int heads, int page,
    int n_blocks, int chunk_pages, int n_chunks, int head_dim,
    float sm_scale, void* stream) {
  return dispatch<float>(q, k_pages, v_pages, nullptr, nullptr, page_table,
                         pt_stride, lengths, ws, ws_floats, out, slots,
                         heads, page, n_blocks, chunk_pages, n_chunks,
                         head_dim, sm_scale, stream);
}

// The same over int8 pools: k_pages / v_pages are contiguous int8 and
// k_scales / v_scales (pages,) float32, one scale per pool page.
extern "C" int paged_decode_attention_i8(
    const float* q, const int8_t* k_pages, const int8_t* v_pages,
    const float* k_scales, const float* v_scales, const int* page_table,
    int pt_stride, const int* lengths, float* ws, long long ws_floats,
    float* out, int slots, int heads, int page, int n_blocks,
    int chunk_pages, int n_chunks, int head_dim, float sm_scale,
    void* stream) {
  return dispatch<int8_t>(q, k_pages, v_pages, k_scales, v_scales,
                          page_table, pt_stride, lengths, ws, ws_floats, out,
                          slots, heads, page, n_blocks, chunk_pages,
                          n_chunks, head_dim, sm_scale, stream);
}

extern "C" const char* paged_decode_attention_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
