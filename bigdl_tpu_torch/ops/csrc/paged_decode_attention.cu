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
// floor is those bytes over 3.35 TB/s.
//
// What the design does about it:
//   - one thread block per (slot, head) walks only that slot's valid keys,
//     never the whole page table, so the bytes read follow the true lengths;
//   - a key's row of head_dim values is one coalesced load by one warp (each
//     lane takes head_dim / 32 neighbouring values, a float2 or a char2 at
//     head_dim 64); int8 values are scaled right after the load, so an int8
//     pool is read at 1 byte per value;
//   - each of the 4 warps takes groups of kUnroll keys in turn and issues all
//     of a group's K and V row loads before using any of them, so a group
//     costs one memory round trip and 2 * kUnroll rows are in flight per warp;
//   - each warp keeps its own online softmax in registers; the warps merge
//     their (max, denominator, accumulator) once, through shared memory.
// The TPU kernel's sequential page grid is not carried over: blocks run in
// parallel and nothing is carried from one block to the next.  Splitting one
// slot's walk across blocks (flash-decoding) and cp.async / TMA staging are
// left for a later change.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "paged_attention_common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kUnroll = 8;

template <int D, typename T>
__global__ void __launch_bounds__(kWarps * 32)
paged_decode_kernel(const float* __restrict__ q,
                    const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages,
                    const float* __restrict__ k_scales,
                    const float* __restrict__ v_scales,
                    const int* __restrict__ page_table, int pt_stride,
                    const int* __restrict__ lengths,
                    float* __restrict__ out, int heads, int page,
                    int n_blocks, float sm_scale) {
  constexpr int E = D / 32;  // head-dim values held by each lane
  const int s = blockIdx.x;
  const int h = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // inclusive length; the table's width caps the walk as the TPU grid did
  const int n_keys = min(lengths[s] + 1, n_blocks * page);
  const int* pt = page_table + (size_t)s * pt_stride;
  const size_t page_elems = (size_t)heads * page * D;
  const size_t head_off = (size_t)h * page * D + (size_t)lane * E;

  float qr[E];
  const float* qs = q + ((size_t)s * heads + h) * D + (size_t)lane * E;
#pragma unroll
  for (int e = 0; e < E; ++e) qr[e] = qs[e] * sm_scale;

  float m = -INFINITY;
  float l = 0.f;
  float acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;

  for (int t0 = warp * kUnroll; t0 < n_keys; t0 += kWarps * kUnroll) {
    float kr[kUnroll][E];
    float vr[kUnroll][E];
    bool ok[kUnroll];  // the same in every lane of the warp
    // all of the group's K and V rows are requested before any is used:
    // one memory round trip per group, not two
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u;
      ok[u] = t < n_keys;
      if (ok[u]) {
        const int blk = t / page;
        const int pid = pt[blk];
        const size_t off = (size_t)pid * page_elems + head_off +
                           (size_t)(t - blk * page) * D;
        paged::load_row<E>(k_pages + off, paged::page_scale(k_scales, pid),
                           kr[u]);
        paged::load_row<E>(v_pages + off, paged::page_scale(v_scales, pid),
                           vr[u]);
      }
    }
    float sc[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float dot = 0.f;
      if (ok[u]) {
#pragma unroll
        for (int e = 0; e < E; ++e) dot = fmaf(qr[e], kr[u][e], dot);
      }
      sc[u] = dot;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        sc[u] += __shfl_xor_sync(0xffffffffu, sc[u], o);
    }
    float m_new = m;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (ok[u]) m_new = fmaxf(m_new, sc[u]);
    }
    // key t0 is always valid, so m_new is finite; exp(-inf) is 0
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] *= alpha;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (ok[u]) {
        const float p = expf(sc[u] - m_new);
        l += p;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[e] = fmaf(p, vr[u][e], acc[e]);
      }
    }
    m = m_new;
  }

  __shared__ float s_m[kWarps];
  __shared__ float s_l[kWarps];
  __shared__ float s_acc[kWarps][D];
  if (lane == 0) {
    s_m[warp] = m;
    s_l[warp] = l;
  }
#pragma unroll
  for (int e = 0; e < E; ++e) s_acc[warp][lane * E + e] = acc[e];
  __syncthreads();

  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (s_l[w] > 0.f) mx = fmaxf(mx, s_m[w]);
    }
    float den = 0.f;
    float num = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (s_l[w] > 0.f) {  // a warp that saw no key adds nothing
        const float c = expf(s_m[w] - mx);
        den = fmaf(s_l[w], c, den);
        num = fmaf(s_acc[w][d], c, num);
      }
    }
    out[((size_t)s * heads + h) * D + d] = num / (den == 0.f ? 1.f : den);
  }
}

template <int D, typename T>
void launch(const float* q, const T* k_pages, const T* v_pages,
            const float* k_scales, const float* v_scales,
            const int* page_table, int pt_stride, const int* lengths,
            float* out, int slots, int heads, int page, int n_blocks,
            float sm_scale, cudaStream_t stream) {
  const dim3 grid(slots, heads);
  paged_decode_kernel<D, T><<<grid, kWarps * 32, 0, stream>>>(
      q, k_pages, v_pages, k_scales, v_scales, page_table, pt_stride,
      lengths, out, heads, page, n_blocks, sm_scale);
}

template <typename T>
int dispatch(const float* q, const T* k_pages, const T* v_pages,
             const float* k_scales, const float* v_scales,
             const int* page_table, int pt_stride, const int* lengths,
             float* out, int slots, int heads, int page, int n_blocks,
             int head_dim, float sm_scale, void* stream) {
  if (slots <= 0 || heads <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32:
      launch<32, T>(q, k_pages, v_pages, k_scales, v_scales, page_table,
                    pt_stride, lengths, out, slots, heads, page, n_blocks,
                    sm_scale, st);
      break;
    case 64:
      launch<64, T>(q, k_pages, v_pages, k_scales, v_scales, page_table,
                    pt_stride, lengths, out, slots, heads, page, n_blocks,
                    sm_scale, st);
      break;
    case 128:
      launch<128, T>(q, k_pages, v_pages, k_scales, v_scales, page_table,
                     pt_stride, lengths, out, slots, heads, page, n_blocks,
                     sm_scale, st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// q (slots, heads, head_dim), k_pages / v_pages (pages, heads, page,
// head_dim) and out (slots, heads, head_dim) are contiguous float32;
// page_table is int32 with rows pt_stride apart; lengths is int32 (slots,).
// Launches on `stream`, does not synchronise, allocates nothing, and returns
// cudaGetLastError() after the launch.
extern "C" int paged_decode_attention_f32(
    const float* q, const float* k_pages, const float* v_pages,
    const int* page_table, int pt_stride, const int* lengths, float* out,
    int slots, int heads, int page, int n_blocks, int head_dim,
    float sm_scale, void* stream) {
  return dispatch<float>(q, k_pages, v_pages, nullptr, nullptr, page_table,
                         pt_stride, lengths, out, slots, heads, page,
                         n_blocks, head_dim, sm_scale, stream);
}

// The same over int8 pools: k_pages / v_pages are contiguous int8 and
// k_scales / v_scales (pages,) float32, one scale per pool page.
extern "C" int paged_decode_attention_i8(
    const float* q, const int8_t* k_pages, const int8_t* v_pages,
    const float* k_scales, const float* v_scales, const int* page_table,
    int pt_stride, const int* lengths, float* out, int slots, int heads,
    int page, int n_blocks, int head_dim, float sm_scale, void* stream) {
  return dispatch<int8_t>(q, k_pages, v_pages, k_scales, v_scales,
                          page_table, pt_stride, lengths, out, slots, heads,
                          page, n_blocks, head_dim, sm_scale, stream);
}

extern "C" const char* paged_decode_attention_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
