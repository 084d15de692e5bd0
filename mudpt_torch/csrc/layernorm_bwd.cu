// layernorm_bwd: dx = T(f32(r) + LN_dx(dxn)), one warp per row, for rows
// of T = bf16 or fp32 (the activation dtype), where LN_dx is LayerNorm's
// input gradient from the gradient dxn on its normalized output, with the
// statistics recomputed from x in fp32:
//   g = dxn * scale, xhat = (x - mean) * inv, inv = rsqrt(var + eps)
//   LN_dx = (g - mean(g) - xhat * mean(g * xhat)) * inv
//
// Replaces: the LayerNorm backward of the TPU layer kernel
//   _layer_bwd_kernel (mudpt_tpu/ops/fused_block.py:868): _ln_bwd_dx
//   (:160-165) after the VPU-only recompute of _ln_fp32 (:150), with the
//   residual gradient added in fp32 and one rounding to x.dtype, in
//   _mlp_bwd_core (:439-441, r = g, giving dy1) and _attn_bwd_core
//   (:353-355, r = dy1, giving dx), which the half-blocks' backwards
//   (:358, :369, :444, :451) run too, and the chunked MLP half's backward
//   (_mlp_chunk_bwd_kernel :527-532, r = g, dxn summed over the chunks).
//   Without a residual and with a dxn of x's type it is also the dx of the
//   towers' own LayerNorms (ln_pre, ln_post, ln_final; XLA's autodiff of
//   models/layers.layer_norm in JAX).
// Bound on the H100: device-memory bytes.  A row reads x, r and dxn and
//   writes dx: 10 bytes per element in bf16 (dxn fp32), 16 in fp32, for
//   ~15 fp32 operations, far below the ~295 operations per byte where the
//   tensor cores would bind.
// Design: as layernorm_fwd, one warp owns one row, so the four row means
//   are warp shuffle reductions with no shared memory and no block barrier.
//   Each lane loads 16-byte vectors with neighbouring lanes on neighbouring
//   addresses and keeps its slice of x and g in registers between the
//   passes, so every input is read from device memory once.  A lane's
//   vector is 8 elements for bf16 rows (dxn bf16 or fp32) and 4 for fp32
//   rows (dxn fp32).  Supports D % 8 == 0 and D <= 1024, and, compiled as
//   cases of their own so that the narrower rows keep their code,
//   D % 64 == 0 and D <= 2048.  Both element types are instances of one
//   template: the bf16 instances compute what they did before fp32 rows
//   were added, in the same order.

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

// kN consecutive elements as floats: 8 bf16 are one 16-byte vector, kN
// floats kN / 4 of them
template <int kN>
__device__ __forceinline__ void loadn(const __nv_bfloat16* p, float (&out)[kN]) {
  static_assert(kN == 8, "bf16 rows take 8-element vectors");
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* b = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
  for (int j = 0; j < 8; ++j) out[j] = __bfloat162float(b[j]);
}

template <int kN>
__device__ __forceinline__ void loadn(const float* p, float (&out)[kN]) {
#pragma unroll
  for (int q = 0; q < kN / 4; ++q) {
    const float4 a = reinterpret_cast<const float4*>(p)[q];
    out[4 * q] = a.x; out[4 * q + 1] = a.y; out[4 * q + 2] = a.z; out[4 * q + 3] = a.w;
  }
}

__device__ __forceinline__ void storen(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 u;
  __nv_bfloat16* o = reinterpret_cast<__nv_bfloat16*>(&u);
#pragma unroll
  for (int j = 0; j < 8; ++j) o[j] = __float2bfloat16(v[j]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ void storen(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// T: the element type of x, r and dx; DXN: of dxn (T, or fp32 beside bf16
// rows); kN: elements a lane's vector (16 / sizeof(T)); kMaxVecPerLane:
// 1024 (or 2048) columns over 32 lanes of such vectors
template <typename T, typename DXN, int kN, int kMaxVecPerLane>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
layernorm_bwd_kernel(const DXN* __restrict__ dxn, const T* __restrict__ x,
                     const float* __restrict__ scale, const T* __restrict__ r,
                     T* __restrict__ dx, int rows, int D, float eps) {
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // warp-uniform
  const int nvec = D >> (kN == 8 ? 3 : 2);
  const size_t base = (size_t)row * D;

  // pass 1: x into registers, its mean
  float xv[kMaxVecPerLane][kN];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxVecPerLane; ++i) {
    const int c = lane + i * 32;
    if (c < nvec) {
      loadn<kN>(x + base + kN * c, xv[i]);
#pragma unroll
      for (int j = 0; j < kN; ++j) sum += xv[i][j];
    }
  }
  const float mean = warp_sum(sum) / (float)D;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxVecPerLane; ++i) {
    if (lane + i * 32 < nvec) {
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        const float d = xv[i][j] - mean;
        sq += d * d;
      }
    }
  }
  const float inv = rsqrtf(warp_sum(sq) / (float)D + eps);

  // pass 2: g = dxn * scale and xhat in registers, their two row means
  float gv[kMaxVecPerLane][kN];
  float gsum = 0.f, gxsum = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxVecPerLane; ++i) {
    const int c = lane + i * 32;
    if (c < nvec) {
      float sc[kN];
      loadn<kN>(dxn + base + kN * c, gv[i]);
      loadn<kN>(scale + kN * c, sc);
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        gv[i][j] *= sc[j];
        xv[i][j] = (xv[i][j] - mean) * inv;  // now xhat
        gsum += gv[i][j];
        gxsum += gv[i][j] * xv[i][j];
      }
    }
  }
  const float gm = warp_sum(gsum) / (float)D;
  const float gx = warp_sum(gxsum) / (float)D;

  // pass 3: dx = T(f32(r) + (g - gm - xhat * gx) * inv)
#pragma unroll
  for (int i = 0; i < kMaxVecPerLane; ++i) {
    const int c = lane + i * 32;
    if (c < nvec) {
      float rv[kN];
#pragma unroll
      for (int j = 0; j < kN; ++j) rv[j] = 0.f;
      if (r != nullptr) loadn<kN>(r + base + kN * c, rv);
      float o[kN];
#pragma unroll
      for (int j = 0; j < kN; ++j) o[j] = rv[j] + (gv[i][j] - gm - xv[i][j] * gx) * inv;
      storen(dx + base + kN * c, o);
    }
  }
}

template <typename T, typename DXN>
int launch(const void* dxn, const void* x, const void* scale, const void* r, void* dx,
           int rows, int D, float eps, cudaStream_t s) {
  constexpr int kN = 16 / sizeof(T);
  constexpr int kNarrow = 1024 / 32 / kN;  // vectors a lane at D <= 1024
  const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  const int threads = kRowsPerBlock * 32;
  const auto* d = static_cast<const DXN*>(dxn);
  const auto* xt = static_cast<const T*>(x);
  const auto* sc = static_cast<const float*>(scale);
  const auto* rt = static_cast<const T*>(r);
  auto* out = static_cast<T*>(dx);
  if (D <= 1024) {
    layernorm_bwd_kernel<T, DXN, kN, kNarrow><<<blocks, threads, 0, s>>>(d, xt, sc, rt, out,
                                                                         rows, D, eps);
  } else {
    layernorm_bwd_kernel<T, DXN, kN, 2 * kNarrow><<<blocks, threads, 0, s>>>(d, xt, sc, rt, out,
                                                                             rows, D, eps);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x, r, dx: (rows, D), bf16, or fp32 when x_f32 != 0 (r may be null).
// dxn: (rows, D), fp32, or bf16 when dxn_bf16 != 0 (bf16 rows only).
// scale: (D) fp32.
extern "C" int layernorm_bwd(const void* dxn, int dxn_bf16, const void* x, const void* scale,
                             const void* r, void* dx, int rows, int D, float eps, int x_f32,
                             void* stream) {
  if (D % 8 || D > 2048 || (D > 1024 && D % 64)) return (int)cudaErrorInvalidValue;
  if (x_f32 && dxn_bf16) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (x_f32) return launch<float, float>(dxn, x, scale, r, dx, rows, D, eps, s);
  if (dxn_bf16) {
    return launch<__nv_bfloat16, __nv_bfloat16>(dxn, x, scale, r, dx, rows, D, eps, s);
  }
  return launch<__nv_bfloat16, float>(dxn, x, scale, r, dx, rows, D, eps, s);
}
