// layernorm_bwd: dx = T(f32(r) + LN_dx(dxn)) for rows of T = bf16 or fp32
// (the activation dtype), where LN_dx is LayerNorm's input gradient from the
// gradient dxn on its normalized output, with the statistics recomputed from
// x in fp32:
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
//   writes dx: 10 bytes per element in bf16 (dxn fp32), 16 in fp32 (12
//   without r), for ~15 fp32 operations, far below the ~295 operations per
//   byte where the tensor cores would bind.  So the time is what it takes to
//   keep enough bytes in flight: every round trip to device memory that a
//   row waits for, with little else of its SM's in flight, is lost.
// Statistics, in every instance: fp32, two passes (the mean, then the mean
//   of squared deviations, then rsqrt(var + eps)); a lane sums its elements
//   in order, vector by vector, and the warp adds its 32 lane sums by a
//   shuffle tree, so a row's arithmetic is the same whatever warp or block
//   takes it (no atomics; a relaunch is bit-equal).
// bf16 rows (layernorm_bwd_kernel): one warp owns one row, 16-byte vectors
//   with neighbouring lanes on neighbouring addresses, x and g kept in
//   registers between the passes, so every input is read once.  Supports D %
//   8 == 0 and D <= 1024, and, compiled as cases of their own so that the
//   narrower rows keep their code, D % 64 == 0 and D <= 2048.
// fp32 rows (layernorm_bwd_f32_kernel): that design lost to F.layer_norm's
//   backward on the card.  Its three loads of a row (x; then dxn and the
//   scale; then r) depended on each other only by their place in the code,
//   each a full round trip behind the reductions before it, and its
//   registers, sized for D = 1024 at every width, capped the warps an SM
//   held.  Here every load of the row (x, dxn, r and the scale) is issued
//   before the first reduction, so a row waits for one round trip, and the
//   registers follow the instance's width: D <= 512, 768, 1024, 1280 and
//   2048 are instances of their own (4-16 vectors a lane, 79-255 registers
//   with r, none spilled), blocks of four warps.  One row a warp; dx leaves
//   by 16-byte stores.  Timed beside it on the card (PERF.md, the fp32
//   LayerNorms): a persistent grid walking each warp's rows through a ring
//   of 1-D bulk copies into shared memory (the statistics read from there),
//   at two and three stages, 1.08-1.14x its time at ViT-B/16's 76,416 x
//   768; two rows a warp (kRegRows, the variant), cache-streaming loads and
//   stores and eight warps a block, within 1% there and none faster by more
//   than 0.1 us at the text rows.

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

// ---------------------------------------------------------------------------
// fp32 rows
// ---------------------------------------------------------------------------

constexpr int kRegRows = 1;   // rows a warp to D = 1024 (one beyond)
constexpr int kF32Warps = 4;  // warps a block

// dx of fp32 rows, kR: with a residual.  kRows rows a warp, every load of
// them (x, dxn, r) issued before the first reduction; kVec: 16-byte vectors
// a lane at the instance's widest D, the scale held in registers to kVec = 8
template <int kVec, int kRows, bool kR>
__global__ void __launch_bounds__(kF32Warps * 32)
layernorm_bwd_f32_kernel(const float* __restrict__ dxn, const float* __restrict__ x,
                         const float* __restrict__ scale, const float* __restrict__ r,
                         float* __restrict__ dx, int rows, int D, float eps) {
  constexpr bool kHold = kVec <= 8;
  const int lane = threadIdx.x & 31;
  const int row0 = (blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5)) * kRows;
  const int nvec = D >> 2;
  if (row0 >= rows) return;  // warp-uniform
  const float4* s4 = reinterpret_cast<const float4*>(scale);
  float4 xv[kRows][kVec], gv[kRows][kVec], rv[kRows][kVec], sv[kHold ? kVec : 1];
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const int c = lane + 32 * i;
    if (kHold && c < nvec) sv[kHold ? i : 0] = s4[c];
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      // a row past the end reads the last row's bytes and is not written
      const int rq = row0 + q < rows ? row0 + q : rows - 1;
      const size_t off = (size_t)rq * nvec + c;
      if (c < nvec) {
        xv[q][i] = reinterpret_cast<const float4*>(x)[off];
        gv[q][i] = reinterpret_cast<const float4*>(dxn)[off];
        if (kR) rv[q][i] = reinterpret_cast<const float4*>(r)[off];
      }
    }
  }
  // g = dxn * scale, in place
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const int c = lane + 32 * i;
    if (c < nvec) {
      const float4 sc = kHold ? sv[kHold ? i : 0] : s4[c];
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        gv[q][i].x *= sc.x; gv[q][i].y *= sc.y; gv[q][i].z *= sc.z; gv[q][i].w *= sc.w;
      }
    }
  }
  float mean[kRows], inv[kRows], gm[kRows], gx[kRows];
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      if (lane + 32 * i < nvec) {
        sum += xv[q][i].x; sum += xv[q][i].y; sum += xv[q][i].z; sum += xv[q][i].w;
      }
    }
    mean[q] = warp_sum(sum) / (float)D;
  }
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      if (lane + 32 * i < nvec) {
        float d = xv[q][i].x - mean[q]; sq += d * d;
        d = xv[q][i].y - mean[q]; sq += d * d;
        d = xv[q][i].z - mean[q]; sq += d * d;
        d = xv[q][i].w - mean[q]; sq += d * d;
      }
    }
    inv[q] = rsqrtf(warp_sum(sq) / (float)D + eps);
  }
  // xhat, in place of x; the means of g and of g * xhat
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    float gsum = 0.f, gxsum = 0.f;
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      if (lane + 32 * i < nvec) {
        float4& v = xv[q][i];
        const float4 g = gv[q][i];
        v.x = (v.x - mean[q]) * inv[q]; v.y = (v.y - mean[q]) * inv[q];
        v.z = (v.z - mean[q]) * inv[q]; v.w = (v.w - mean[q]) * inv[q];
        gsum += g.x; gxsum += g.x * v.x;
        gsum += g.y; gxsum += g.y * v.y;
        gsum += g.z; gxsum += g.z * v.z;
        gsum += g.w; gxsum += g.w * v.w;
      }
    }
    gm[q] = warp_sum(gsum) / (float)D;
    gx[q] = warp_sum(gxsum) / (float)D;
  }
  // dx = r + (g - gm - xhat * gx) * inv, 16 bytes a lane
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    if (row0 + q >= rows) continue;
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const int c = lane + 32 * i;
      if (c < nvec) {
        const float4 g = gv[q][i], xh = xv[q][i];
        float4 o = make_float4((g.x - gm[q] - xh.x * gx[q]) * inv[q],
                               (g.y - gm[q] - xh.y * gx[q]) * inv[q],
                               (g.z - gm[q] - xh.z * gx[q]) * inv[q],
                               (g.w - gm[q] - xh.w * gx[q]) * inv[q]);
        if (kR) {
          o.x = rv[q][i].x + o.x; o.y = rv[q][i].y + o.y;
          o.z = rv[q][i].z + o.z; o.w = rv[q][i].w + o.w;
        }
        reinterpret_cast<float4*>(dx)[(size_t)(row0 + q) * nvec + c] = o;
      }
    }
  }
}

template <int kVec, int kRows, bool kR>
int launch_f32_at(const float* dxn, const float* x, const float* scale, const float* r,
                  float* dx, int rows, int D, float eps, cudaStream_t s) {
  const int per_block = kRows * kF32Warps;
  layernorm_bwd_f32_kernel<kVec, kRows, kR><<<(rows + per_block - 1) / per_block,
                                              kF32Warps * 32, 0, s>>>(dxn, x, scale, r, dx,
                                                                      rows, D, eps);
  return (int)cudaGetLastError();
}

// the instance whose registers fit D: ViT-B/16's text (512) and vision (768)
// rows, the halves' 1024, the chunked half's 1280 and its widest, 2048
template <bool kR>
int launch_f32(const float* dxn, const float* x, const float* scale, const float* r, float* dx,
               int rows, int D, float eps, cudaStream_t s) {
  if (D <= 512) return launch_f32_at<4, kRegRows, kR>(dxn, x, scale, r, dx, rows, D, eps, s);
  if (D <= 768) return launch_f32_at<6, kRegRows, kR>(dxn, x, scale, r, dx, rows, D, eps, s);
  if (D <= 1024) return launch_f32_at<8, kRegRows, kR>(dxn, x, scale, r, dx, rows, D, eps, s);
  if (D <= 1280) return launch_f32_at<10, 1, kR>(dxn, x, scale, r, dx, rows, D, eps, s);
  return launch_f32_at<16, 1, kR>(dxn, x, scale, r, dx, rows, D, eps, s);
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
  if (x_f32) {
    const auto* d = static_cast<const float*>(dxn);
    const auto* xt = static_cast<const float*>(x);
    const auto* sc = static_cast<const float*>(scale);
    const auto* rt = static_cast<const float*>(r);
    auto* out = static_cast<float*>(dx);
    return r != nullptr ? launch_f32<true>(d, xt, sc, rt, out, rows, D, eps, s)
                        : launch_f32<false>(d, xt, sc, rt, out, rows, D, eps, s);
  }
  if (dxn_bf16) {
    return launch<__nv_bfloat16, __nv_bfloat16>(dxn, x, scale, r, dx, rows, D, eps, s);
  }
  return launch<__nv_bfloat16, float>(dxn, x, scale, r, dx, rows, D, eps, s);
}
