// layernorm_fwd: y = T(LN_fp32(x) * scale + bias), one warp per row, for
// rows of T = bf16 or fp32 (the activation dtype).
//
// Replaces: the LayerNorm of the TPU layer kernel,
//   mudpt_tpu/ops/fused_block.py:150 (_ln_fp32) with its casts to x.dtype at
//   :303 (_attn_project) and :394 (_mlp_pre), inside
//   _layer_fwd_nosave_kernel (:851), _layer_fwd_kernel (:831), the
//   half-blocks' forwards (:318, :326, :403, :415), the recompute
//   backwards (_attn_bwd_kernel :358, _mlp_bwd_kernel :444) and the
//   chunked MLP half's (_mlp_chunk_fwd_kernel :484, _mlp_chunk_bwd_kernel
//   :509).  The Pallas kernels take x in bf16 or fp32; so does this one.
// Bound on the H100: device-memory bytes.  Each row is read once and
//   written once (2 * D * sizeof(T) bytes) for ~8 fp32 operations per
//   element, far below the ~295 operations per byte where the tensor cores
//   would bind.  So the time is what it takes to keep enough bytes in
//   flight: a row's only round trip is its load, issued whole before the
//   first reduction.
// Design: one warp owns one row, so the mean and variance are two warp
//   shuffle reductions with no shared memory and no block barrier.  Each lane
//   loads 16-byte vectors (8 bf16 or 4 fp32) with neighbouring lanes on
//   neighbouring addresses and keeps its slice of the row in registers
//   between the two statistics passes and the affine, so x is read from
//   device memory once.  Statistics are fp32 (mean, then the mean of squared
//   deviations, then rsqrt(var + eps)) as in the TPU kernel, a lane's
//   elements summed in order and the 32 lane sums by a shuffle tree, so a
//   row's arithmetic is the same whatever warp or block takes it; the output
//   is rounded to T once (a no-op for fp32).  Supports D % 8 == 0 and
//   D <= 1024 (four bf16 or eight fp32 vectors a lane), and, compiled as a
//   case of its own so that the narrower rows keep their code, D % 64 == 0
//   and D <= 2048 (eight or sixteen vectors a lane: the chunked MLP half's
//   towers wider than 1024).  Both element types are instances of one
//   template: the bf16 instances compute what they did before fp32 rows
//   were added, in the same order.
// fp32 rows keep this body: it reaches 0.89 of the bytes bound at ViT-B/16's
//   76,416 x 768 on the H100, and three redesigns timed beside it in one
//   call were no faster anywhere from 1,576 to 76,416 rows (PERF.md, the
//   fp32 LayerNorms): a persistent ring of 1-D bulk copies into shared
//   memory, the statistics read from there (1.06x its time at 76,416 x 768),
//   and registers sized to the width at one and at two rows a warp (1.00x,
//   1.01x; at two rows 1.14x at 8,288 x 1024).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerBlock = 8;  // one warp per row

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// a 16-byte vector of T: kN elements, 2^kShift of them
template <typename T> struct Vec;

template <> struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8, kShift = 3;
  __device__ __forceinline__ static float get(const uint4& u, int j) {
    return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(&u)[j]);
  }
  __device__ __forceinline__ static void put(uint4& u, int j, float v) {
    reinterpret_cast<__nv_bfloat16*>(&u)[j] = __float2bfloat16(v);
  }
};

template <> struct Vec<float> {
  static constexpr int kN = 4, kShift = 2;
  __device__ __forceinline__ static float get(const uint4& u, int j) {
    return reinterpret_cast<const float*>(&u)[j];
  }
  __device__ __forceinline__ static void put(uint4& u, int j, float v) {
    reinterpret_cast<float*>(&u)[j] = v;
  }
};

// kMaxVecPerLane: 1024 (or 2048) columns over 32 lanes of 16-byte vectors
template <typename T, int kMaxVecPerLane>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
layernorm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                     const float* __restrict__ bias, T* __restrict__ y, int rows, int D,
                     float eps) {
  constexpr int kN = Vec<T>::kN;
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // warp-uniform
  const int nvec = D >> Vec<T>::kShift;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * D);

  float v[kMaxVecPerLane][kN];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxVecPerLane; ++i) {
    const int c = lane + i * 32;
    if (c < nvec) {
      uint4 u = xr[c];
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        v[i][j] = Vec<T>::get(u, j);
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
      for (int j = 0; j < kN; ++j) {
        const float d = v[i][j] - mean;
        sq += d * d;
      }
    }
  }
  const float inv = rsqrtf(warp_sum(sq) / (float)D + eps);

  uint4* yr = reinterpret_cast<uint4*>(y + (size_t)row * D);
  const float4* s4 = reinterpret_cast<const float4*>(scale);
  const float4* b4 = reinterpret_cast<const float4*>(bias);
  constexpr int kQ = kN / 4;  // float4s of parameters a vector
#pragma unroll
  for (int i = 0; i < kMaxVecPerLane; ++i) {
    const int c = lane + i * 32;
    if (c < nvec) {
      float4 sq4[kQ], bq4[kQ];
#pragma unroll
      for (int q = 0; q < kQ; ++q) sq4[q] = s4[kQ * c + q];
#pragma unroll
      for (int q = 0; q < kQ; ++q) bq4[q] = b4[kQ * c + q];
      const float* sc = reinterpret_cast<const float*>(sq4);
      const float* bi = reinterpret_cast<const float*>(bq4);
      uint4 u;
#pragma unroll
      for (int j = 0; j < kN; ++j) Vec<T>::put(u, j, (v[i][j] - mean) * inv * sc[j] + bi[j]);
      yr[c] = u;
    }
  }
}

template <typename T>
int launch(const void* x, const void* scale, const void* bias, void* y, int rows, int D,
           float eps, cudaStream_t s) {
  // vectors a lane at D <= 1024 (4 bf16, 8 fp32), twice that up to 2048
  constexpr int kNarrow = 1024 / 32 / Vec<T>::kN;
  const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  const auto* xt = static_cast<const T*>(x);
  const auto* sc = static_cast<const float*>(scale);
  const auto* bi = static_cast<const float*>(bias);
  auto* out = static_cast<T*>(y);
  if (D <= 1024) {
    layernorm_fwd_kernel<T, kNarrow><<<blocks, kRowsPerBlock * 32, 0, s>>>(xt, sc, bi, out,
                                                                           rows, D, eps);
  } else {
    layernorm_fwd_kernel<T, 2 * kNarrow><<<blocks, kRowsPerBlock * 32, 0, s>>>(xt, sc, bi, out,
                                                                               rows, D, eps);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x, y: (rows, D), bf16, or fp32 when x_f32 != 0.  scale, bias: (D) fp32.
extern "C" int layernorm_fwd(const void* x, const void* scale, const void* bias, void* y,
                             int rows, int D, float eps, int x_f32, void* stream) {
  if (D % 8 || D > 2048 || (D > 1024 && D % 64)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return x_f32 ? launch<float>(x, scale, bias, y, rows, D, eps, s)
               : launch<__nv_bfloat16>(x, scale, bias, y, rows, D, eps, s);
}
