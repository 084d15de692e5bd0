// layernorm_bwd: dx = bf16(f32(r) + LN_dx(dxn)), one warp per row, where
// LN_dx is LayerNorm's input gradient from the gradient dxn on its
// normalized output, with the statistics recomputed from x in fp32:
//   g = dxn * scale, xhat = (x - mean) * inv, inv = rsqrt(var + eps)
//   LN_dx = (g - mean(g) - xhat * mean(g * xhat)) * inv
//
// Replaces: the LayerNorm backward of the TPU layer kernel
//   _layer_bwd_kernel (mudpt_tpu/ops/fused_block.py:868): _ln_bwd_dx
//   (:160-165) after the VPU-only recompute of _ln_fp32 (:150), with the
//   residual gradient added in fp32 and one bf16 rounding, in
//   _mlp_bwd_core (:439-441, r = g, giving dy1) and _attn_bwd_core
//   (:353-355, r = dy1, giving dx), which the half-blocks' backwards
//   (:358, :369, :444, :451) run too, and the chunked MLP half's backward
//   (_mlp_chunk_bwd_kernel :527-532, r = g, dxn summed over the chunks).  Without a residual and with a bf16
//   dxn it is also the dx of the towers' own LayerNorms (ln_pre, ln_post,
//   ln_final; XLA's autodiff of models/layers.layer_norm in JAX).
// Bound on the H100: device-memory bytes.  A row reads x, r (bf16) and
//   dxn (fp32) and writes dx (bf16): 10 bytes per element for ~15 fp32
//   operations, far below the ~295 operations per byte where the tensor
//   cores would bind.
// Design: as layernorm_fwd, one warp owns one row, so the four row means
//   are warp shuffle reductions with no shared memory and no block barrier.
//   Each lane loads 16-byte vectors with neighbouring lanes on neighbouring
//   addresses and keeps its slice of x and g in registers between the
//   passes, so every input is read from device memory once.  Supports
//   D % 8 == 0 and D <= 1024 (four vectors a lane), and, compiled as cases
//   of their own so that the narrower rows keep their code, D % 64 == 0
//   and D <= 2048 (eight vectors a lane).

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

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&out)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* b = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
  for (int j = 0; j < 8; ++j) out[j] = __bfloat162float(b[j]);
}

__device__ __forceinline__ void load8(const float* p, float (&out)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

// kMaxVecPerLane: 4 (32 lanes * 4 vectors * 8 = 1024 columns) or 8 (2048)
template <typename DXN, int kMaxVecPerLane>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
layernorm_bwd_kernel(const DXN* __restrict__ dxn, const __nv_bfloat16* __restrict__ x,
                     const float* __restrict__ scale, const __nv_bfloat16* __restrict__ r,
                     __nv_bfloat16* __restrict__ dx, int rows, int D, float eps) {
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // warp-uniform
  const int nvec = D >> 3;
  const size_t base = (size_t)row * D;

  // pass 1: x into registers, its mean
  float xv[kMaxVecPerLane][8];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxVecPerLane; ++i) {
    const int c = lane + i * 32;
    if (c < nvec) {
      load8(x + base + 8 * c, xv[i]);
#pragma unroll
      for (int j = 0; j < 8; ++j) sum += xv[i][j];
    }
  }
  const float mean = warp_sum(sum) / (float)D;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxVecPerLane; ++i) {
    if (lane + i * 32 < nvec) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float d = xv[i][j] - mean;
        sq += d * d;
      }
    }
  }
  const float inv = rsqrtf(warp_sum(sq) / (float)D + eps);

  // pass 2: g = dxn * scale and xhat in registers, their two row means
  float gv[kMaxVecPerLane][8];
  float gsum = 0.f, gxsum = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxVecPerLane; ++i) {
    const int c = lane + i * 32;
    if (c < nvec) {
      float sc[8];
      load8(dxn + base + 8 * c, gv[i]);
      load8(scale + 8 * c, sc);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        gv[i][j] *= sc[j];
        xv[i][j] = (xv[i][j] - mean) * inv;  // now xhat
        gsum += gv[i][j];
        gxsum += gv[i][j] * xv[i][j];
      }
    }
  }
  const float gm = warp_sum(gsum) / (float)D;
  const float gx = warp_sum(gxsum) / (float)D;

  // pass 3: dx = bf16(f32(r) + (g - gm - xhat * gx) * inv)
#pragma unroll
  for (int i = 0; i < kMaxVecPerLane; ++i) {
    const int c = lane + i * 32;
    if (c < nvec) {
      float rv[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (r != nullptr) load8(r + base + 8 * c, rv);
      uint4 u;
      __nv_bfloat16* o = reinterpret_cast<__nv_bfloat16*>(&u);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        o[j] = __float2bfloat16(rv[j] + (gv[i][j] - gm - xv[i][j] * gx) * inv);
      }
      *reinterpret_cast<uint4*>(dx + base + 8 * c) = u;
    }
  }
}

}  // namespace

// dxn: (rows, D), fp32, or bf16 when dxn_bf16 != 0.  r: (rows, D) bf16 or
// null.  x, dx: (rows, D) bf16.  scale: (D) fp32.
extern "C" int layernorm_bwd(const void* dxn, int dxn_bf16, const void* x, const void* scale,
                             const void* r, void* dx, int rows, int D, float eps,
                             void* stream) {
  if (D % 8 || D > 2048 || (D > 1024 && D % 64)) return (int)cudaErrorInvalidValue;
  const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* sc = static_cast<const float*>(scale);
  const auto* rb = static_cast<const __nv_bfloat16*>(r);
  auto* out = static_cast<__nv_bfloat16*>(dx);
  const cudaStream_t s = (cudaStream_t)stream;
  const auto* d16 = static_cast<const __nv_bfloat16*>(dxn);
  const auto* d32 = static_cast<const float*>(dxn);
  const int threads = kRowsPerBlock * 32;
  if (D <= 1024 && dxn_bf16) {
    layernorm_bwd_kernel<__nv_bfloat16, 4><<<blocks, threads, 0, s>>>(d16, xb, sc, rb, out, rows,
                                                                        D, eps);
  } else if (D <= 1024) {
    layernorm_bwd_kernel<float, 4><<<blocks, threads, 0, s>>>(d32, xb, sc, rb, out, rows, D, eps);
  } else if (dxn_bf16) {
    layernorm_bwd_kernel<__nv_bfloat16, 8><<<blocks, threads, 0, s>>>(d16, xb, sc, rb, out, rows,
                                                                        D, eps);
  } else {
    layernorm_bwd_kernel<float, 8><<<blocks, threads, 0, s>>>(d32, xb, sc, rb, out, rows, D, eps);
  }
  return (int)cudaGetLastError();
}
