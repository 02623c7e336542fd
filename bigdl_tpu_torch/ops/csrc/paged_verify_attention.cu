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
// so the floor is those bytes over 3.35 TB/s.
//
// What the design does about it:
//   - one thread block per (slot, head, tile of up to kQ queries) walks only
//     the keys its last query can see; each K/V row it loads serves every
//     query of the tile.  C is any value >= 1: the queries past kQ go to
//     further tiles (grid.z), which read the same rows again from L2;
//   - the decode kernel's walk: each of 4 warps takes groups of kUnroll keys
//     in turn, every lane holds head_dim / 32 values of a row, all of a
//     group's rows are requested before any is used;
//   - per query, each lane keeps its share of the accumulator and the warp
//     its (max, denominator): kQ x head_dim / 32 accumulators a lane; the
//     warps merge once through shared memory.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "paged_attention_common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kUnroll = 4;
constexpr int kQ = 8;  // queries per block

template <int D, typename T>
__global__ void __launch_bounds__(kWarps * 32)
paged_verify_kernel(const float* __restrict__ q,
                    const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages,
                    const float* __restrict__ k_scales,
                    const float* __restrict__ v_scales,
                    const int* __restrict__ page_table, int pt_stride,
                    const int* __restrict__ positions,
                    float* __restrict__ out, int heads, int page,
                    int n_blocks, int chunk, float sm_scale) {
  constexpr int E = D / 32;  // head-dim values held by each lane
  const int s = blockIdx.x;
  const int h = blockIdx.y;
  const int c0 = blockIdx.z * kQ;
  const int nq = min(kQ, chunk - c0);  // queries of this tile
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int pos = positions[s];
  // the tile's last query sees the furthest key; the table's width caps it
  const int n_keys = min(pos + c0 + nq, n_blocks * page);
  const int* pt = page_table + (size_t)s * pt_stride;
  const size_t page_elems = (size_t)heads * page * D;
  const size_t head_off = (size_t)h * page * D + (size_t)lane * E;

  float qr[kQ][E];
  const float* qs =
      q + (((size_t)s * heads + h) * chunk + c0) * D + (size_t)lane * E;
#pragma unroll
  for (int c = 0; c < kQ; ++c) {
#pragma unroll
    for (int e = 0; e < E; ++e)
      qr[c][e] = c < nq ? qs[(size_t)c * D + e] * sm_scale : 0.f;
  }

  float m[kQ];
  float l[kQ];
  float acc[kQ][E];
#pragma unroll
  for (int c = 0; c < kQ; ++c) {
    m[c] = -INFINITY;
    l[c] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[c][e] = 0.f;
  }

  for (int t0 = warp * kUnroll; t0 < n_keys; t0 += kWarps * kUnroll) {
    float kr[kUnroll][E];
    float vr[kUnroll][E];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u;
      if (t < n_keys) {
        const int blk = t / page;
        const int pid = pt[blk];
        const size_t off = (size_t)pid * page_elems + head_off +
                           (size_t)(t - blk * page) * D;
        paged::load_row<E>(k_pages + off, paged::page_scale(k_scales, pid),
                           kr[u]);
        paged::load_row<E>(v_pages + off, paged::page_scale(v_scales, pid),
                           vr[u]);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) kr[u][e] = vr[u][e] = 0.f;
      }
    }
#pragma unroll
    for (int c = 0; c < kQ; ++c) {
      if (c >= nq) break;  // uniform across the block
      // key t is visible to query c when t <= pos + c0 + c (and t < n_keys)
      const int lim = min(pos + c0 + c, n_keys - 1);
      float sc[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) dot = fmaf(qr[c][e], kr[u][e], dot);
        sc[u] = dot;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          sc[u] += __shfl_xor_sync(0xffffffffu, sc[u], o);
      }
      float m_new = m[c];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (t0 + u <= lim) m_new = fmaxf(m_new, sc[u]);
      }
      if (m_new == -INFINITY) continue;  // no key of the group is visible
      const float alpha = expf(m[c] - m_new);
      l[c] *= alpha;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[c][e] *= alpha;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (t0 + u <= lim) {
          const float p = expf(sc[u] - m_new);
          l[c] += p;
#pragma unroll
          for (int e = 0; e < E; ++e) acc[c][e] = fmaf(p, vr[u][e], acc[c][e]);
        }
      }
      m[c] = m_new;
    }
  }

  __shared__ float s_m[kWarps][kQ];
  __shared__ float s_l[kWarps][kQ];
  __shared__ float s_acc[kWarps][kQ][D];
#pragma unroll
  for (int c = 0; c < kQ; ++c) {
    if (lane == 0) {
      s_m[warp][c] = m[c];
      s_l[warp][c] = l[c];
    }
#pragma unroll
    for (int e = 0; e < E; ++e) s_acc[warp][c][lane * E + e] = acc[c][e];
  }
  __syncthreads();

  float* os = out + (((size_t)s * heads + h) * chunk + c0) * D;
  for (int i = threadIdx.x; i < nq * D; i += blockDim.x) {
    const int c = i / D;
    const int d = i - c * D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (s_l[w][c] > 0.f) mx = fmaxf(mx, s_m[w][c]);
    }
    float den = 0.f;
    float num = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (s_l[w][c] > 0.f) {  // a warp that saw no visible key adds nothing
        const float f = expf(s_m[w][c] - mx);
        den = fmaf(s_l[w][c], f, den);
        num = fmaf(s_acc[w][c][d], f, num);
      }
    }
    os[i] = num / (den == 0.f ? 1.f : den);
  }
}

template <int D, typename T>
void launch(const float* q, const T* k_pages, const T* v_pages,
            const float* k_scales, const float* v_scales,
            const int* page_table, int pt_stride, const int* positions,
            float* out, int slots, int heads, int page, int n_blocks,
            int chunk, float sm_scale, cudaStream_t stream) {
  const dim3 grid(slots, heads, (chunk + kQ - 1) / kQ);
  paged_verify_kernel<D, T><<<grid, kWarps * 32, 0, stream>>>(
      q, k_pages, v_pages, k_scales, v_scales, page_table, pt_stride,
      positions, out, heads, page, n_blocks, chunk, sm_scale);
}

template <typename T>
int dispatch(const float* q, const T* k_pages, const T* v_pages,
             const float* k_scales, const float* v_scales,
             const int* page_table, int pt_stride, const int* positions,
             float* out, int slots, int heads, int page, int n_blocks,
             int chunk, int head_dim, float sm_scale, void* stream) {
  if (slots <= 0 || heads <= 0 || chunk <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32:
      launch<32, T>(q, k_pages, v_pages, k_scales, v_scales, page_table,
                    pt_stride, positions, out, slots, heads, page, n_blocks,
                    chunk, sm_scale, st);
      break;
    case 64:
      launch<64, T>(q, k_pages, v_pages, k_scales, v_scales, page_table,
                    pt_stride, positions, out, slots, heads, page, n_blocks,
                    chunk, sm_scale, st);
      break;
    case 128:
      launch<128, T>(q, k_pages, v_pages, k_scales, v_scales, page_table,
                     pt_stride, positions, out, slots, heads, page, n_blocks,
                     chunk, sm_scale, st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// q and out (slots, heads, chunk, head_dim) and k_pages / v_pages (pages,
// heads, page, head_dim) are contiguous float32; page_table is int32 with
// rows pt_stride apart; positions is int32 (slots,), the first query's cache
// position.  Launches on `stream`, does not synchronise, allocates nothing,
// and returns cudaGetLastError() after the launch.
extern "C" int paged_verify_attention_f32(
    const float* q, const float* k_pages, const float* v_pages,
    const int* page_table, int pt_stride, const int* positions, float* out,
    int slots, int heads, int page, int n_blocks, int chunk, int head_dim,
    float sm_scale, void* stream) {
  return dispatch<float>(q, k_pages, v_pages, nullptr, nullptr, page_table,
                         pt_stride, positions, out, slots, heads, page,
                         n_blocks, chunk, head_dim, sm_scale, stream);
}

// The same over int8 pools: k_pages / v_pages are contiguous int8 and
// k_scales / v_scales (pages,) float32, one scale per pool page.
extern "C" int paged_verify_attention_i8(
    const float* q, const int8_t* k_pages, const int8_t* v_pages,
    const float* k_scales, const float* v_scales, const int* page_table,
    int pt_stride, const int* positions, float* out, int slots, int heads,
    int page, int n_blocks, int chunk, int head_dim, float sm_scale,
    void* stream) {
  return dispatch<int8_t>(q, k_pages, v_pages, k_scales, v_scales,
                          page_table, pt_stride, positions, out, slots,
                          heads, page, n_blocks, chunk, head_dim, sm_scale,
                          stream);
}

extern "C" const char* paged_verify_attention_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
