// Row LayerNorm for Hopper (sm_90a): out = (x - mean) * rsqrt(var + eps) *
// gamma + beta over the last axis of float32 x (rows, d), mean and var taken
// in two passes (the mean, then the mean of the squared deviations).
//
// Replaces bigdl_tpu/ops/fused.py: _ln_forward, whose Pallas kernel
// (_ln_kernel) pads the rows to a block of 256 and d to a multiple of 128,
// keeps a (256, d) block resident in VMEM for both reductions and the
// scale, and masks the pad.  Here nothing is padded: one warp owns one row,
// eight warps a block, and the ragged end of a row is masked by the loop
// bounds.
//
// What bounds it: the bytes.  Every element is read once and written once
// (8 bytes), against about 8 operations, far below the card's ~20
// operations a byte; at the encoder's (8192, 768) that is 50.3 MB, 15 us at
// 3.35 TB/s.
//
// What the design does about it: a row of up to 1024 floats stays in the
// lane's registers between the two reductions and the scale, so x is read
// from device memory once.  Loads and stores are float4 where d is a
// multiple of 4 and every pointer is 16-byte aligned (decided in the C
// entry), neighbouring lanes on neighbouring 16 bytes; scalar otherwise.
// The sums are warp shuffles, no shared memory and no barrier.  gamma and
// beta go through the read-only cache.  A row longer than 1024 floats is
// walked in strides of the warp, read once for the mean, once for the
// deviations and once for the output.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                  // rows a block
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxRegCols = 1024;          // longest row held in registers

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The row in registers: lane `lane` holds float4 number lane + 32 j of the
// row (kVec) or float number lane + 32 j (scalar), j < kPer.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
fused_layernorm_kernel(const float* __restrict__ x,
                       const float* __restrict__ gamma,
                       const float* __restrict__ beta,
                       float* __restrict__ out, long long rows, int d,
                       float eps) {
  constexpr int kPer = kVec ? kMaxRegCols / 128 : kMaxRegCols / 32;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const float* xr = x + row * d;
  float* yr = out + row * d;
  const float inv_d = 1.0f / (float)d;

  if (kVec) {
    const int n4 = d >> 2;
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    float4 v[kPer];
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = lane + 32 * j;
      v[j] = i < n4 ? x4[i] : make_float4(0.f, 0.f, 0.f, 0.f);
      s += (v[j].x + v[j].y) + (v[j].z + v[j].w);
    }
    const float mean = warp_sum(s) * inv_d;
    float q = 0.f;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if (lane + 32 * j < n4) {
        const float a = v[j].x - mean, b = v[j].y - mean;
        const float c = v[j].z - mean, e = v[j].w - mean;
        q += (a * a + b * b) + (c * c + e * e);
      }
    }
    const float inv = rsqrtf(warp_sum(q) * inv_d + eps);
    const float4* g4 = reinterpret_cast<const float4*>(gamma);
    const float4* b4 = reinterpret_cast<const float4*>(beta);
    float4* y4 = reinterpret_cast<float4*>(yr);
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = lane + 32 * j;
      if (i < n4) {
        const float4 g = __ldg(g4 + i), b = __ldg(b4 + i);
        float4 y;
        y.x = (v[j].x - mean) * inv * g.x + b.x;
        y.y = (v[j].y - mean) * inv * g.y + b.y;
        y.z = (v[j].z - mean) * inv * g.z + b.z;
        y.w = (v[j].w - mean) * inv * g.w + b.w;
        y4[i] = y;
      }
    }
  } else {
    float v[kPer];
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = lane + 32 * j;
      v[j] = i < d ? xr[i] : 0.f;
      s += v[j];
    }
    const float mean = warp_sum(s) * inv_d;
    float q = 0.f;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if (lane + 32 * j < d) {
        const float a = v[j] - mean;
        q += a * a;
      }
    }
    const float inv = rsqrtf(warp_sum(q) * inv_d + eps);
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = lane + 32 * j;
      if (i < d) yr[i] = (v[j] - mean) * inv * __ldg(gamma + i) + __ldg(beta + i);
    }
  }
}

// Rows longer than kMaxRegCols: the same math, the row read from device
// memory for each pass (scalar loads, any alignment).
__global__ void __launch_bounds__(kThreads)
fused_layernorm_long_kernel(const float* __restrict__ x,
                            const float* __restrict__ gamma,
                            const float* __restrict__ beta,
                            float* __restrict__ out, long long rows, int d,
                            float eps) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const float* xr = x + row * d;
  float* yr = out + row * d;
  const float inv_d = 1.0f / (float)d;
  float s = 0.f;
  for (int i = lane; i < d; i += 32) s += xr[i];
  const float mean = warp_sum(s) * inv_d;
  float q = 0.f;
  for (int i = lane; i < d; i += 32) {
    const float a = xr[i] - mean;
    q += a * a;
  }
  const float inv = rsqrtf(warp_sum(q) * inv_d + eps);
  for (int i = lane; i < d; i += 32)
    yr[i] = (xr[i] - mean) * inv * __ldg(gamma + i) + __ldg(beta + i);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// x and out (rows, d), gamma and beta (d), all float32 and contiguous.
// Launches on `stream`, does not synchronise, allocates nothing, and returns
// cudaGetLastError() after the launch.
extern "C" int fused_layernorm_f32(const float* x, const float* gamma,
                                   const float* beta, float* out,
                                   long long rows, int d, float eps,
                                   void* stream) {
  if (rows < 0 || d <= 0) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const long long blocks = (rows + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)blocks);
  if (d > kMaxRegCols) {
    fused_layernorm_long_kernel<<<grid, kThreads, 0, s>>>(x, gamma, beta, out,
                                                          rows, d, eps);
  } else if (d % 4 == 0 && aligned16(x) && aligned16(out) &&
             aligned16(gamma) && aligned16(beta)) {
    // with d % 4 == 0 every row start is 16-byte aligned too
    fused_layernorm_kernel<true><<<grid, kThreads, 0, s>>>(x, gamma, beta, out,
                                                           rows, d, eps);
  } else {
    fused_layernorm_kernel<false><<<grid, kThreads, 0, s>>>(x, gamma, beta,
                                                            out, rows, d, eps);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* fused_layernorm_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
