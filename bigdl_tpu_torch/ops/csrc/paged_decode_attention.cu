// Paged decode-step attention, float32 pages, for Hopper (sm_90a).
//
// Replaces bigdl_tpu/ops/flash_attention.py: paged_decode_attention, whose
// Pallas kernel is _decode_kernel (f32 pages; the int8-page variant is not
// ported yet).  It computes, for every slot s and head h,
//
//   out[s, h] = softmax(q[s, h] . K[s, h, :]^T * sm_scale) . V[s, h, :]
//
// over the key positions 0 .. lengths[s] (lengths is INCLUSIVE), where key
// position j * page + t of slot s is read from pages[page_table[s, j], h, t, :].
// The running (max, denominator, accumulator) of the online softmax stays in
// float32, and a row whose denominator is 0 divides by 1.
//
// What bounds it: device-memory bytes.  A call must read
// sum_s (lengths[s] + 1) * heads * head_dim * 4 bytes of K and as many of V,
// plus q and out, and does about 4 flops per 8 bytes read: far below the
// H100's ridge point, so its floor is those bytes over 3.35 TB/s.
//
// What the design does about it:
//   - one thread block per (slot, head) walks only that slot's valid keys,
//     never the whole page table, so the bytes read follow the true lengths;
//   - a key's row of head_dim floats is one coalesced load by one warp (each
//     lane takes head_dim / 32 neighbouring floats, a float2 at head_dim 64);
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

namespace {

constexpr int kWarps = 4;
constexpr int kUnroll = 8;

template <int E>
__device__ __forceinline__ void load_row(const float* __restrict__ p,
                                         float (&r)[E]) {
  if constexpr (E % 4 == 0) {
#pragma unroll
    for (int i = 0; i < E / 4; ++i) {
      const float4 v = reinterpret_cast<const float4*>(p)[i];
      r[4 * i] = v.x;
      r[4 * i + 1] = v.y;
      r[4 * i + 2] = v.z;
      r[4 * i + 3] = v.w;
    }
  } else if constexpr (E % 2 == 0) {
#pragma unroll
    for (int i = 0; i < E / 2; ++i) {
      const float2 v = reinterpret_cast<const float2*>(p)[i];
      r[2 * i] = v.x;
      r[2 * i + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < E; ++i) r[i] = p[i];
  }
}

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
paged_decode_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k_pages,
                        const float* __restrict__ v_pages,
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
        const size_t off = (size_t)pt[blk] * page_elems + head_off +
                           (size_t)(t - blk * page) * D;
        load_row<E>(k_pages + off, kr[u]);
        load_row<E>(v_pages + off, vr[u]);
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

template <int D>
void launch(const float* q, const float* k_pages, const float* v_pages,
            const int* page_table, int pt_stride, const int* lengths,
            float* out, int slots, int heads, int page, int n_blocks,
            float sm_scale, cudaStream_t stream) {
  const dim3 grid(slots, heads);
  paged_decode_f32_kernel<D><<<grid, kWarps * 32, 0, stream>>>(
      q, k_pages, v_pages, page_table, pt_stride, lengths, out, heads, page,
      n_blocks, sm_scale);
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
  if (slots <= 0 || heads <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32:
      launch<32>(q, k_pages, v_pages, page_table, pt_stride, lengths, out,
                 slots, heads, page, n_blocks, sm_scale, st);
      break;
    case 64:
      launch<64>(q, k_pages, v_pages, page_table, pt_stride, lengths, out,
                 slots, heads, page, n_blocks, sm_scale, st);
      break;
    case 128:
      launch<128>(q, k_pages, v_pages, page_table, pt_stride, lengths, out,
                  slots, heads, page, n_blocks, sm_scale, st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* paged_decode_attention_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
