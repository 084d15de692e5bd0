// layernorm_fwd: y = bf16(LN_fp32(x) * scale + bias), one warp per row.
//
// Replaces: the LayerNorm of the TPU layer kernel,
//   mudpt_tpu/ops/fused_block.py:150 (_ln_fp32) with its bf16 casts at
//   :303 (_attn_project) and :394 (_mlp_pre), inside
//   _layer_fwd_nosave_kernel (:851), _layer_fwd_kernel (:831), the
//   half-blocks' forwards (:318, :326, :403, :415) and the recompute
//   backwards (_attn_bwd_kernel :358, _mlp_bwd_kernel :444).
// Bound on the H100: device-memory bytes.  Each row is read once and
//   written once (2 * D * 2 bytes) for ~8 fp32 operations per element, far
//   below the ~295 operations per byte where the tensor cores would bind.
// Design: one warp owns one row, so the mean and variance are two warp
//   shuffle reductions with no shared memory and no block barrier.  Each lane
//   loads 16-byte vectors (8 bf16) with neighbouring lanes on neighbouring
//   addresses and keeps its slice of the row in registers between the two
//   statistics passes and the affine, so x is read from device memory once.
//   Statistics are fp32 (mean, then the mean of squared deviations, then
//   rsqrt(var + eps)) as in the TPU kernel; the output is rounded to bf16
//   once.  Supports D % 8 == 0 and D <= 1024.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kMaxVecPerLane = 4;  // 32 lanes * 4 vectors * 8 = 1024 columns
constexpr int kRowsPerBlock = 8;   // one warp per row

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kRowsPerBlock * 32)
layernorm_fwd_kernel(const __nv_bfloat16* __restrict__ x,
                     const float* __restrict__ scale,
                     const float* __restrict__ bias,
                     __nv_bfloat16* __restrict__ y, int rows, int D, float eps) {
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // warp-uniform
  const int nvec = D >> 3;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * D);

  float v[kMaxVecPerLane][8];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxVecPerLane; ++i) {
    const int c = lane + i * 32;
    if (c < nvec) {
      uint4 u = xr[c];
      const __nv_bfloat16* b = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        v[i][j] = __bfloat162float(b[j]);
        sum += v[i][j];
      }
    }
  }
  const float mean = warp_sum(sum) / (float)D;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxVecPerLane; ++i) {
    if (lane + i * 32 < nvec) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float d = v[i][j] - mean;
        sq += d * d;
      }
    }
  }
  const float inv = rsqrtf(warp_sum(sq) / (float)D + eps);

  uint4* yr = reinterpret_cast<uint4*>(y + (size_t)row * D);
  const float4* s4 = reinterpret_cast<const float4*>(scale);
  const float4* b4 = reinterpret_cast<const float4*>(bias);
#pragma unroll
  for (int i = 0; i < kMaxVecPerLane; ++i) {
    const int c = lane + i * 32;
    if (c < nvec) {
      const float4 sa = s4[2 * c], sb = s4[2 * c + 1];
      const float4 ba = b4[2 * c], bb = b4[2 * c + 1];
      const float sc[8] = {sa.x, sa.y, sa.z, sa.w, sb.x, sb.y, sb.z, sb.w};
      const float bi[8] = {ba.x, ba.y, ba.z, ba.w, bb.x, bb.y, bb.z, bb.w};
      uint4 u;
      __nv_bfloat16* o = reinterpret_cast<__nv_bfloat16*>(&u);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        o[j] = __float2bfloat16((v[i][j] - mean) * inv * sc[j] + bi[j]);
      }
      yr[c] = u;
    }
  }
}

}  // namespace

extern "C" int layernorm_fwd(const void* x, const void* scale, const void* bias,
                             void* y, int rows, int D, float eps, void* stream) {
  const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  layernorm_fwd_kernel<<<blocks, kRowsPerBlock * 32, 0, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(y), rows, D, eps);
  return (int)cudaGetLastError();
}
