// layernorm_q8: the fp32 LayerNorm of a bf16 row, quantized to int8 at once:
// symmetric per row (dynamic, with an fp32 row scale) or by one static
// multiplier.  The fp32 LayerNorm output never reaches device memory.
//
// Replaces: the LayerNorms of the TPU int8 layer kernels with the
//   quantization of their fp32 output, mudpt_tpu/ops/quant_block.py
//   _ln_fp32 + _quant_rows (:97-98, :104-105 in _layer_fwd_q8_kernel :89;
//   :188-189, :196-197 in _layer_fwd_q8_save_kernel :178) and _ln_fp32 +
//   quant_static (:401-403, :409-410 in _layer_fwd_q8_static_kernel :377;
//   :586-588, :596-597 in _layer_fwd_q8_static_save_kernel :563):
//     xn = ((x - mean) * rsqrt(var + eps)) * scale + bias       (fp32)
//     dynamic: s = max(max|xn| / 127, 1e-8), q = clip(rint(xn / s), -127, 127)
//     static:  q = clip(rint(xn * r), -127, 127)
//   Each product and sum of the affine is rounded on its own (no FMA
//   contraction), rsqrt is rounded to nearest and the division is IEEE;
//   only the order of the statistics' fp32 sums differs from the plain
//   version, which can move a code by one where xn / s lies next to a
//   rounding boundary.
// Bound on the H100: device-memory bytes (2 read and 1 written per
//   element, ~12 fp32 operations each).
// Design: layernorm_fwd's: one warp owns a row (D % 8 == 0, D <= 1024),
//   16-byte loads kept in registers through the statistics, the affine, the
//   row max (one more warp shuffle reduction) and the quantization; 8 codes
//   leave as one 8-byte store a lane.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxVecPerLane = 4;  // 32 lanes * 4 vectors * 8 = 1024 columns
constexpr int kRowsPerBlock = 8;   // one warp per row

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int8_t clip_rint(float v) {
  return static_cast<int8_t>(fminf(fmaxf(rintf(v), -127.0f), 127.0f));
}

template <bool STATIC>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
layernorm_q8_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ scale,
                    const float* __restrict__ bias, int8_t* __restrict__ q,
                    float* __restrict__ s, const float* __restrict__ r, int rows, int D,
                    float eps) {
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
  const float mean = __fdiv_rn(warp_sum(sum), (float)D);
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxVecPerLane; ++i) {
    if (lane + i * 32 < nvec) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float d = __fsub_rn(v[i][j], mean);
        sq = __fadd_rn(sq, __fmul_rn(d, d));
      }
    }
  }
  const float inv = __frsqrt_rn(__fadd_rn(__fdiv_rn(warp_sum(sq), (float)D), eps));

  const float4* s4 = reinterpret_cast<const float4*>(scale);
  const float4* b4 = reinterpret_cast<const float4*>(bias);
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxVecPerLane; ++i) {
    const int c = lane + i * 32;
    if (c < nvec) {
      const float4 sa = s4[2 * c], sb = s4[2 * c + 1];
      const float4 ba = b4[2 * c], bb = b4[2 * c + 1];
      const float sc[8] = {sa.x, sa.y, sa.z, sa.w, sb.x, sb.y, sb.z, sb.w};
      const float bi[8] = {ba.x, ba.y, ba.z, ba.w, bb.x, bb.y, bb.z, bb.w};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float xhat = __fmul_rn(__fsub_rn(v[i][j], mean), inv);
        v[i][j] = __fadd_rn(__fmul_rn(xhat, sc[j]), bi[j]);
        amax = fmaxf(amax, fabsf(v[i][j]));
      }
    }
  }
  float mult;
  if (STATIC) {
    mult = *r;
  } else {
    mult = fmaxf(__fdiv_rn(warp_max(amax), 127.0f), 1e-8f);
    if (lane == 0) s[row] = mult;
  }
  uint2* qr = reinterpret_cast<uint2*>(q + (size_t)row * D);
#pragma unroll
  for (int i = 0; i < kMaxVecPerLane; ++i) {
    const int c = lane + i * 32;
    if (c < nvec) {
      uint2 u;
      int8_t* o = reinterpret_cast<int8_t*>(&u);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        o[j] = clip_rint(STATIC ? __fmul_rn(v[i][j], mult) : __fdiv_rn(v[i][j], mult));
      qr[c] = u;
    }
  }
}

}  // namespace

// x (rows, D) bf16, scale and bias (D) fp32 -> q (rows, D) int8; dynamic
// (r null): s (rows) fp32; static: r one fp32 multiplier in device memory.
extern "C" int layernorm_q8(const void* x, const void* scale, const void* bias, void* q,
                            void* s, const void* r, int rows, int D, float eps,
                            void* stream) {
  if (rows < 1 || D % 8 || D > 1024) return (int)cudaErrorInvalidValue;
  const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  const cudaStream_t st = (cudaStream_t)stream;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* sc = static_cast<const float*>(scale);
  const auto* bi = static_cast<const float*>(bias);
  auto* qo = static_cast<int8_t*>(q);
  auto* so = static_cast<float*>(s);
  const auto* rf = static_cast<const float*>(r);
  if (rf != nullptr) {
    layernorm_q8_kernel<true><<<blocks, kRowsPerBlock * 32, 0, st>>>(xb, sc, bi, qo, so, rf,
                                                                   rows, D, eps);
  } else {
    layernorm_q8_kernel<false><<<blocks, kRowsPerBlock * 32, 0, st>>>(xb, sc, bi, qo, so, rf,
                                                                    rows, D, eps);
  }
  return (int)cudaGetLastError();
}
