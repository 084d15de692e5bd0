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
// The first design, one warp a row with three loads in turn (x; then dxn
//   and the scale; then r), each a full round trip behind the reductions
//   before it, and registers sized for D = 1024 at every width up to 1024
//   and for 2048 above, lost to F.layer_norm's backward on the card (2.2x
//   its time at 33,152 x 1280) and read 0.49-0.85 of its bytes bound.  Both
//   kernels below replace it with one design:
// fp32 rows (layernorm_bwd_f32_kernel) and bf16 rows
//   (layernorm_bwd_kernel): every load of the row (x, dxn, r and the
//   scale) is issued before the first reduction, so a row waits for one
//   round trip, and the registers follow the instance's width: D <= 512,
//   768 (640 too: three 8-element vectors a lane), 1024, 1280 and 2048 are
//   instances of their own, none spilled.  A lane's elements are its
//   vectors lane + 32 * i, 16 bytes each; dx leaves by 16-byte stores.
//   fp32 rows: 4-16 vectors a lane, 79-255 registers with r, one row a
//   warp, blocks of four warps.  Timed beside it on the card (PERF.md, the
//   fp32 LayerNorms): a persistent grid walking each warp's rows through a
//   ring of 1-D bulk copies into shared memory (the statistics read from
//   there), at two and three stages, 1.08-1.14x its time at ViT-B/16's
//   76,416 x 768; two rows a warp (kRegRows, the variant), cache-streaming
//   loads and stores and eight warps a block, within 1% there and none
//   faster by more than 0.1 us at the text rows.
//   bf16 rows: x and r held as loaded (bf16, 4 registers a vector), dxn
//   fp32 or bf16; the scale held in registers to D = 1280.  Each row's
//   arithmetic is the first design's, in its order (x and g converted to
//   fp32 vector by vector, xhat in place of x, the same expressions), so
//   dx is bit-equal to it.  One row a warp, four warps a block: timed
//   beside it on the card (PERF.md), two rows a warp (kBf16Rows, to D =
//   1024) ran 1.10-1.53x its time at the vision rows, two and eight warps a
//   block within 2%.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// bf16 rows
// ---------------------------------------------------------------------------

constexpr int kBf16Rows = 1;   // rows a warp to D = 1024 (one beyond)
constexpr int kBf16Warps = 4;  // warps a block

// 8 consecutive elements as floats, from their 16-byte vectors as loaded:
// one of bf16 (as uint4, or the one vector of a bf16 dxn), two of fp32
__device__ __forceinline__ void to_float(const uint4& u, float (&out)[8]) {
  const __nv_bfloat16* b = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
  for (int j = 0; j < 8; ++j) out[j] = __bfloat162float(b[j]);
}

__device__ __forceinline__ void to_float(const uint4 (&u)[1], float (&out)[8]) {
  to_float(u[0], out);
}

__device__ __forceinline__ void to_float(const uint4 (&u)[2], float (&out)[8]) {
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float* f = reinterpret_cast<const float*>(&u[k]);
#pragma unroll
    for (int j = 0; j < 4; ++j) out[4 * k + j] = f[j];
  }
}

__device__ __forceinline__ void to_float(const float4 (&v)[2], float (&out)[8]) {
  out[0] = v[0].x; out[1] = v[0].y; out[2] = v[0].z; out[3] = v[0].w;
  out[4] = v[1].x; out[5] = v[1].y; out[6] = v[1].z; out[7] = v[1].w;
}

__device__ __forceinline__ void storen(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 u;
  __nv_bfloat16* o = reinterpret_cast<__nv_bfloat16*>(&u);
#pragma unroll
  for (int j = 0; j < 8; ++j) o[j] = __float2bfloat16(v[j]);
  *reinterpret_cast<uint4*>(p) = u;
}

// dx of bf16 rows, DXN: dxn's type (fp32 or bf16), kR: with a residual.
// kRows rows a warp, every load of them (x, dxn, r, the scale) issued
// before the first reduction; kVec: 8-element vectors a lane at the
// instance's widest D
template <typename DXN, int kVec, int kRows, bool kR>
__global__ void __launch_bounds__(kBf16Warps * 32)
layernorm_bwd_kernel(const DXN* __restrict__ dxn, const __nv_bfloat16* __restrict__ x,
                     const float* __restrict__ scale, const __nv_bfloat16* __restrict__ r,
                     __nv_bfloat16* __restrict__ dx, int rows, int D, float eps) {
  constexpr int kG = sizeof(DXN) / 2;  // 16-byte vectors of dxn to 8 elements
  constexpr bool kHold = kVec <= 5;
  const int lane = threadIdx.x & 31;
  const int row0 = (blockIdx.x * kBf16Warps + (threadIdx.x >> 5)) * kRows;
  const int nvec = D >> 3;
  if (row0 >= rows) return;  // warp-uniform
  const uint4* x4 = reinterpret_cast<const uint4*>(x);
  const uint4* d4 = reinterpret_cast<const uint4*>(dxn);
  const uint4* r4 = reinterpret_cast<const uint4*>(r);
  const float4* s4 = reinterpret_cast<const float4*>(scale);
  uint4 xr[kRows][kVec], dr[kRows][kVec][kG], rr[kR ? kRows : 1][kR ? kVec : 1];
  float4 sv[kHold ? kVec : 1][2];
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const int c = lane + 32 * i;
    if (c < nvec) {
      if (kHold) {
        sv[kHold ? i : 0][0] = s4[2 * c];
        sv[kHold ? i : 0][1] = s4[2 * c + 1];
      }
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        // a row past the end reads the last row's bytes and is not written
        const size_t off = (size_t)(row0 + q < rows ? row0 + q : rows - 1) * nvec + c;
        xr[q][i] = x4[off];
#pragma unroll
        for (int k = 0; k < kG; ++k) dr[q][i][k] = d4[off * kG + k];
        if (kR) rr[kR ? q : 0][kR ? i : 0] = r4[off];
      }
    }
  }

  // x's mean and inv, row by row
  float xv[kRows][kVec][8], mean[kRows], inv[kRows];
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      if (lane + 32 * i < nvec) {
        to_float(xr[q][i], xv[q][i]);
#pragma unroll
        for (int j = 0; j < 8; ++j) sum += xv[q][i][j];
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
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float d = xv[q][i][j] - mean[q];
          sq += d * d;
        }
      }
    }
    inv[q] = rsqrtf(warp_sum(sq) / (float)D + eps);
  }

  // g = dxn * scale and xhat (in place of x), the means of g and g * xhat
  float gv[kRows][kVec][8], gm[kRows], gx[kRows];
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    float gsum = 0.f, gxsum = 0.f;
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const int c = lane + 32 * i;
      if (c < nvec) {
        float sc[8];
        if (kHold) {
          to_float(sv[kHold ? i : 0], sc);
        } else {
          const float4 s2[2] = {s4[2 * c], s4[2 * c + 1]};
          to_float(s2, sc);
        }
        to_float(dr[q][i], gv[q][i]);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          gv[q][i][j] *= sc[j];
          xv[q][i][j] = (xv[q][i][j] - mean[q]) * inv[q];  // now xhat
          gsum += gv[q][i][j];
          gxsum += gv[q][i][j] * xv[q][i][j];
        }
      }
    }
    gm[q] = warp_sum(gsum) / (float)D;
    gx[q] = warp_sum(gxsum) / (float)D;
  }

  // dx = bf16(f32(r) + (g - gm - xhat * gx) * inv), r = 0 without a residual
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    if (row0 + q >= rows) continue;
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const int c = lane + 32 * i;
      if (c < nvec) {
        float rv[8];
        if (kR) {
          to_float(rr[kR ? q : 0][kR ? i : 0], rv);
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) rv[j] = 0.f;
        }
        float o[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          o[j] = rv[j] + (gv[q][i][j] - gm[q] - xv[q][i][j] * gx[q]) * inv[q];
        }
        storen(dx + ((size_t)(row0 + q) * nvec + c) * 8, o);
      }
    }
  }
}

template <typename DXN, int kVec, int kRows, bool kR>
int launch_bf16_at(const DXN* dxn, const __nv_bfloat16* x, const float* scale,
                   const __nv_bfloat16* r, __nv_bfloat16* dx, int rows, int D, float eps,
                   cudaStream_t s) {
  const int per_block = kRows * kBf16Warps;
  layernorm_bwd_kernel<DXN, kVec, kRows, kR><<<(rows + per_block - 1) / per_block,
                                               kBf16Warps * 32, 0, s>>>(
      dxn, x, scale, r, dx, rows, D, eps);
  return (int)cudaGetLastError();
}

// the instance whose registers fit D: the text rows (512; RN50x4's 640 and
// ViT-L/14's 768 on the 768 instance), ViT-B/16's vision rows (768), the
// halves' 1024, the chunked half's 1280 and its widest, 2048
template <typename DXN, bool kR>
int launch_bf16(const void* dxn, const void* x, const void* scale, const void* r, void* dx,
                int rows, int D, float eps, cudaStream_t s) {
  using B = __nv_bfloat16;
  const auto* d = static_cast<const DXN*>(dxn);
  const auto* xt = static_cast<const B*>(x);
  const auto* sc = static_cast<const float*>(scale);
  const auto* rt = static_cast<const B*>(r);
  auto* out = static_cast<B*>(dx);
  if (D <= 512) return launch_bf16_at<DXN, 2, kBf16Rows, kR>(d, xt, sc, rt, out, rows, D, eps, s);
  if (D <= 768) return launch_bf16_at<DXN, 3, kBf16Rows, kR>(d, xt, sc, rt, out, rows, D, eps, s);
  if (D <= 1024) return launch_bf16_at<DXN, 4, kBf16Rows, kR>(d, xt, sc, rt, out, rows, D, eps, s);
  if (D <= 1280) return launch_bf16_at<DXN, 5, 1, kR>(d, xt, sc, rt, out, rows, D, eps, s);
  return launch_bf16_at<DXN, 8, 1, kR>(d, xt, sc, rt, out, rows, D, eps, s);
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
  using B = __nv_bfloat16;
  if (dxn_bf16) {
    return r != nullptr ? launch_bf16<B, true>(dxn, x, scale, r, dx, rows, D, eps, s)
                        : launch_bf16<B, false>(dxn, x, scale, r, dx, rows, D, eps, s);
  }
  return r != nullptr ? launch_bf16<float, true>(dxn, x, scale, r, dx, rows, D, eps, s)
                      : launch_bf16<float, false>(dxn, x, scale, r, dx, rows, D, eps, s);
}
