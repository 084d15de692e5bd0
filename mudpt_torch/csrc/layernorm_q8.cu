// layernorm_q8: the fp32 LayerNorm of a bf16 or fp32 row (the activation
// dtype), quantized to int8 at once: symmetric per row (dynamic, with an
// fp32 row scale) or by one static multiplier.  The fp32 LayerNorm output
// never reaches device memory.
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
//   rounding boundary.  The Pallas kernels take x in bf16 or fp32 (their
//   statistics are fp32 either way); so does this one.
//   On bf16 rows it also quantizes xn as the ablations of
//   tools/probe_q8_residual.py quant_rows (:76-102) do, through
//   layernorm_q8_mode only (ops/probe.py), each dropping one step:
//     recip:   m = max(max|xn|, 1e-8), q = clip(rint(xn * (127 / m))), s = m / 127
//     noclip:  the dynamic codes without the clip (equal to them)
//     floor:   q = int8(xn), XLA's convert: toward zero, saturated, NaN -> 0
// Bound on the H100: device-memory bytes (sizeof(T) read and 1 written per
//   element, ~12 fp32 operations each).
// Design: one warp owns a row at a time (D % 8 == 0, D <= 1024), 16-byte
//   loads (8 bf16 or 4 fp32) kept in registers through the statistics, the
//   affine, the row max (one more warp shuffle reduction) and the
//   quantization; a vector's codes leave as one store a lane (8 bytes from
//   bf16 rows, 4 from fp32).  The registers follow the instance's width: D
//   <= 512, 768 and 1024 are instances of their own.  A row's loads are
//   issued first; the scale and the bias are staged once a block in shared
//   memory while they fly (laid out so that a warp reads them contiguously),
//   so no load waits behind a reduction.  The first design (one row a warp,
//   registers for D = 1024 at every width, the scale and bias loaded after
//   two reductions, a division a code) read 0.56-0.85 of its bytes bound on
//   the card (PERF.md); at about 40 instructions an element in the dynamic
//   mode, half of them the IEEE division, it was bound by the instructions
//   a warp issues as much as by the bytes.  Here a dynamic code is one
//   multiply by the row scale's reciprocal unless it lies next to a rounding
//   boundary (kRecipFirst, below), a clipped code one max and one saturating
//   convert, and v - mean is kept from the variance for xhat; bf16 rows
//   under a dynamic quantizer walk their rows with the next one in flight
//   (kWalk, below).  Timed beside it on the card and lost: the scale and
//   bias held in registers (110-176 registers halved the warps an SM
//   holds), two rows a warp, the scale and bias read from global memory
//   where each vector needs them.  Both element types are instances of one
//   template; each row's arithmetic is the first design's, in its order,
//   so codes and scales are bit-equal to it.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kQ8Rows = 1;  // rows a warp at a time
// The launch of an instance.  bf16 rows under a dynamic quantizer (and the
// probe's ablations) walk: a grid of the blocks the card holds at once,
// kWalkWarps warps a block, each warp walking its rows with the next row's
// x in flight (a row waits on three reductions there).  The static
// quantizer and fp32 rows take a block of kBlockWarps warps for every
// kBlockWarps rows: there the next row's registers cost more warps than its
// early loads win (timed on the card: PERF.md).
constexpr bool kWalk = true;
constexpr int kWalkWarps = 8;
constexpr int kBlockWarps = 4;
constexpr bool kQ8Stage = true;  // the scale and bias staged in shared memory

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

// the quantizer: dynamic (divide by the row scale), static (multiply by r),
// and the probe's ablations
enum Mode { kDiv = 0, kStatic = 1, kRecip = 2, kNoclip = 3, kFloor = 4 };

// fp32 -> int8 saturating to [-128, 127], NaN to 0: toward zero (RZI, XLA's
// convert) or to the nearest, ties to even (RNI)
__device__ __forceinline__ int8_t cvt_rzi_sat(float v) {
  int q;
  asm("cvt.rzi.sat.s8.f32 %0, %1;" : "=r"(q) : "f"(v));
  return static_cast<int8_t>(q);
}

__device__ __forceinline__ int8_t cvt_rni_sat(float v) {
  int q;
  asm("cvt.rni.sat.s8.f32 %0, %1;" : "=r"(q) : "f"(v));
  return static_cast<int8_t>(q);
}

// int8(clip(rint(v), -127, 127)) for every float v, NaN included (-127):
// rint commutes with the max at the integer -127, and the convert's
// saturation at 127 is the upper clip
__device__ __forceinline__ int8_t clip_rint(float v) { return cvt_rni_sat(fmaxf(v, -127.0f)); }

// The dynamic codes divide by the row scale s: q = rint(RN(v / s)).  With y
// = RN(1 / s), t = RN(v * y) lies within 2^-15 of RN(v / s) wherever |v /
// s| <= 128 (two roundings of 2^-24 each, and that of the quotient), which
// the row scale ensures (|v| <= absmax = 127 s, up to an ulp); so where t
// is more than 2^-15 from every half-integer, rint(t) = rint(RN(v / s)).
// A vector with a code nearer than that (or a NaN or inf) divides.
constexpr bool kRecipFirst = true;
constexpr float kNearHalf = 0.5f - 1.0f / 32768.0f;

// the codes of a vector of n values: mult is the row scale (kDiv, kNoclip;
// y its reciprocal) or a multiplier (kStatic: r, kRecip: 127 / m); kFloor
// takes none
template <int MODE, int n>
__device__ __forceinline__ void codes(const float (&v)[n], float mult, float y,
                                      int8_t (&o)[n]) {
  if (MODE == kDiv || MODE == kNoclip) {
    float t[n];
    bool divide = !kRecipFirst;
#pragma unroll
    for (int j = 0; j < n; ++j) {
      t[j] = __fmul_rn(v[j], y);
      divide |= !(fabsf(__fsub_rn(t[j], rintf(t[j]))) < kNearHalf);
    }
    if (divide) {
#pragma unroll
      for (int j = 0; j < n; ++j) t[j] = __fdiv_rn(v[j], mult);
    }
#pragma unroll
    for (int j = 0; j < n; ++j) o[j] = MODE == kDiv ? clip_rint(t[j]) : cvt_rni_sat(t[j]);
  } else {
#pragma unroll
    for (int j = 0; j < n; ++j) {
      o[j] = MODE == kFloor ? cvt_rzi_sat(v[j]) : clip_rint(__fmul_rn(v[j], mult));
    }
  }
}

// a 16-byte vector of T: kN elements, 2^kShift of them; Codes holds its
// kN int8 codes
template <typename T> struct Vec;

template <> struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8, kShift = 3;
  using Codes = uint2;
  __device__ __forceinline__ static float get(const uint4& u, int j) {
    return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(&u)[j]);
  }
};

template <> struct Vec<float> {
  static constexpr int kN = 4, kShift = 2;
  using Codes = uint32_t;
  __device__ __forceinline__ static float get(const uint4& u, int j) {
    return reinterpret_cast<const float*>(&u)[j];
  }
};

// x's 16-byte vectors of kRows rows from row0 on (a row past the end reads
// the last row's bytes and is not written)
template <int kVec, int kRows>
__device__ __forceinline__ void load_rows(const uint4* x4, int row0, int rows, int nvec,
                                          int lane, uint4 (&xr)[kRows][kVec]) {
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const int c = lane + i * 32;
#pragma unroll
    for (int p = 0; p < kRows; ++p) {
      if (c < nvec) xr[p][i] = x4[(size_t)(row0 + p < rows ? row0 + p : rows - 1) * nvec + c];
    }
  }
}

// kRows rows a warp at a time, the warp walking its rows by the grid's
// stride with the next rows' x in flight; kVec: 16-byte vectors of x a lane
// at the instance's widest D
template <typename T, int MODE, int kVec, int kRows, int kWarps>
__global__ void __launch_bounds__(kWarps * 32)
layernorm_q8_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                    const float* __restrict__ bias, int8_t* __restrict__ q,
                    float* __restrict__ s, const float* __restrict__ r, int rows, int D,
                    float eps) {
  constexpr int kN = Vec<T>::kN;
  constexpr int kQ = kN / 4;  // float4s of parameters a vector
  // the scale and the bias, staged once a block: a vector's k-th float4 of
  // either at k * nvec + c, so that a warp's loads of it are contiguous
  __shared__ float4 sp[2][1024 / 4];
  const int lane = threadIdx.x & 31;
  const int stride = gridDim.x * kWarps * kRows;
  const int nvec = D >> Vec<T>::kShift;
  const uint4* x4 = reinterpret_cast<const uint4*>(x);
  int row0 = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * kRows;

  uint4 xr[kRows][kVec];
  if (row0 < rows) load_rows(x4, row0, rows, nvec, lane, xr);
  const float4* s4 = reinterpret_cast<const float4*>(scale);
  const float4* b4 = reinterpret_cast<const float4*>(bias);
  if (kQ8Stage) {
    for (int k = threadIdx.x; k < D / 4; k += kWarps * 32) {
      sp[0][(k % kQ) * nvec + k / kQ] = s4[k];
      sp[1][(k % kQ) * nvec + k / kQ] = b4[k];
    }
  }
  const float mult_static = MODE == kStatic ? *r : 0.f;
  if (kQ8Stage) __syncthreads();

  for (; row0 < rows; row0 += stride) {  // warp-uniform
    // x as fp32 and its row sums; then the next rows' loads
    float v[kRows][kVec][kN], mean[kRows], inv[kRows];
#pragma unroll
    for (int p = 0; p < kRows; ++p) {
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        if (lane + i * 32 < nvec) {
#pragma unroll
          for (int j = 0; j < kN; ++j) {
            v[p][i][j] = Vec<T>::get(xr[p][i], j);
            sum += v[p][i][j];
          }
        }
      }
      mean[p] = sum;
    }
    if (row0 + stride < rows) load_rows(x4, row0 + stride, rows, nvec, lane, xr);

    // the statistics: the mean, then v - mean in place of v, then inv
#pragma unroll
    for (int p = 0; p < kRows; ++p) mean[p] = __fdiv_rn(warp_sum(mean[p]), (float)D);
#pragma unroll
    for (int p = 0; p < kRows; ++p) {
      float sq = 0.f;
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        if (lane + i * 32 < nvec) {
#pragma unroll
          for (int j = 0; j < kN; ++j) {
            v[p][i][j] = __fsub_rn(v[p][i][j], mean[p]);
            sq = __fadd_rn(sq, __fmul_rn(v[p][i][j], v[p][i][j]));
          }
        }
      }
      inv[p] = __frsqrt_rn(__fadd_rn(__fdiv_rn(warp_sum(sq), (float)D), eps));
    }

    // xn = xhat * scale + bias in place of v, and the row's absmax
    float amax[kRows];
#pragma unroll
    for (int p = 0; p < kRows; ++p) {
      amax[p] = 0.f;
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const int c = lane + i * 32;
        if (c < nvec) {
          float4 sq4[kQ], bq4[kQ];
#pragma unroll
          for (int k = 0; k < kQ; ++k) {
            sq4[k] = kQ8Stage ? sp[0][k * nvec + c] : s4[kQ * c + k];
            bq4[k] = kQ8Stage ? sp[1][k * nvec + c] : b4[kQ * c + k];
          }
          const float* sc = reinterpret_cast<const float*>(sq4);
          const float* bi = reinterpret_cast<const float*>(bq4);
#pragma unroll
          for (int j = 0; j < kN; ++j) {
            const float xhat = __fmul_rn(v[p][i][j], inv[p]);
            v[p][i][j] = __fadd_rn(__fmul_rn(xhat, sc[j]), bi[j]);
            amax[p] = fmaxf(amax[p], fabsf(v[p][i][j]));
          }
        }
      }
    }
    using Codes = typename Vec<T>::Codes;
#pragma unroll
    for (int p = 0; p < kRows; ++p) {
      const int row = row0 + p;
      float mult = 0.f, y = 0.f;
      if (MODE == kStatic) {
        mult = mult_static;
      } else if (MODE == kRecip) {
        const float m = fmaxf(warp_max(amax[p]), 1e-8f);
        if (lane == 0 && row < rows) s[row] = __fdiv_rn(m, 127.0f);
        mult = __fdiv_rn(127.0f, m);
      } else if (MODE != kFloor) {
        mult = fmaxf(__fdiv_rn(warp_max(amax[p]), 127.0f), 1e-8f);
        y = __frcp_rn(mult);
        if (lane == 0 && row < rows) s[row] = mult;
      }
      if (row >= rows) continue;
      Codes* qr = reinterpret_cast<Codes*>(q + (size_t)row * D);
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const int c = lane + i * 32;
        if (c < nvec) {
          Codes u;
          codes<MODE>(v[p][i], mult, y, *reinterpret_cast<int8_t(*)[kN]>(&u));
          qr[c] = u;
        }
      }
    }
  }
}

template <typename T, int MODE, int kVec, int kRows>
int launch_at(const void* x, const void* scale, const void* bias, void* q, void* s,
              const void* r, int rows, int D, float eps, cudaStream_t st) {
  constexpr bool walk = kWalk && sizeof(T) == 2 && MODE != kStatic;
  constexpr int warps = walk ? kWalkWarps : kBlockWarps;
  const auto kernel = layernorm_q8_kernel<T, MODE, kVec, kRows, warps>;
  const int per_block = kRows * warps;
  int blocks = (rows + per_block - 1) / per_block;
  if (walk) {
    static int resident = 0;  // the instance's blocks the card holds at once
    if (resident == 0) {
      int dev = 0, sms = 0, per_sm = 0;
      cudaError_t e = cudaGetDevice(&dev);
      if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (e == cudaSuccess) {
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, warps * 32, 0);
      }
      if (e != cudaSuccess) return (int)e;
      resident = sms * per_sm;
    }
    if (resident > 0 && blocks > resident) blocks = resident;
  }
  kernel<<<blocks, warps * 32, 0, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<int8_t*>(q), static_cast<float*>(s),
      static_cast<const float*>(r), rows, D, eps);
  return (int)cudaGetLastError();
}

// the instance whose registers fit D: the text rows (512; 640 and 768 on
// the 768 instance), ViT-B/16's vision rows (768) and ViT-L/14's (1024)
template <typename T, int MODE>
int launch(const void* x, const void* scale, const void* bias, void* q, void* s,
           const void* r, int rows, int D, float eps, cudaStream_t st) {
  constexpr int kLane = 32 * Vec<T>::kN;  // columns a vector a lane covers
  if (D <= 512) {
    return launch_at<T, MODE, 512 / kLane, kQ8Rows>(x, scale, bias, q, s, r, rows, D, eps, st);
  }
  if (D <= 768) {
    return launch_at<T, MODE, 768 / kLane, kQ8Rows>(x, scale, bias, q, s, r, rows, D, eps, st);
  }
  return launch_at<T, MODE, 1024 / kLane, kQ8Rows>(x, scale, bias, q, s, r, rows, D, eps, st);
}

}  // namespace

// x (rows, D) bf16, or fp32 when x_f32 != 0; scale and bias (D) fp32 -> q
// (rows, D) int8; dynamic (r null): s (rows) fp32; static: r one fp32
// multiplier in device memory.
extern "C" int layernorm_q8(const void* x, const void* scale, const void* bias, void* q,
                            void* s, const void* r, int rows, int D, float eps, int x_f32,
                            void* stream) {
  if (rows < 1 || D % 8 || D > 1024) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (r != nullptr) {
    return x_f32 ? launch<float, kStatic>(x, scale, bias, q, s, r, rows, D, eps, st)
                 : launch<__nv_bfloat16, kStatic>(x, scale, bias, q, s, r, rows, D, eps, st);
  }
  return x_f32 ? launch<float, kDiv>(x, scale, bias, q, s, r, rows, D, eps, st)
               : launch<__nv_bfloat16, kDiv>(x, scale, bias, q, s, r, rows, D, eps, st);
}

// The probe's ablations on bf16 rows: mode 2 recip (s (rows) fp32), 3 noclip
// (s (rows) fp32), 4 floor (s unused); r unused.
extern "C" int layernorm_q8_mode(const void* x, const void* scale, const void* bias, void* q,
                                 void* s, int rows, int D, float eps, int mode, void* stream) {
  if (rows < 1 || D % 8 || D > 1024) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  using B = __nv_bfloat16;
  switch (mode) {
    case kRecip: return launch<B, kRecip>(x, scale, bias, q, s, nullptr, rows, D, eps, st);
    case kNoclip: return launch<B, kNoclip>(x, scale, bias, q, s, nullptr, rows, D, eps, st);
    case kFloor: return launch<B, kFloor>(x, scale, bias, q, s, nullptr, rows, D, eps, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
