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
// Design: layernorm_fwd's: one warp owns a row (D % 8 == 0, D <= 1024),
//   16-byte loads (8 bf16 or 4 fp32) kept in registers through the
//   statistics, the affine, the row max (one more warp shuffle reduction)
//   and the quantization, at most 32 values a lane; a vector's codes leave
//   as one store a lane (8 bytes from bf16 rows, 4 from fp32).  Both
//   element types are instances of one template: the bf16 instances
//   compute what they did before fp32 rows were added, in the same order.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

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

// one code: mult is the row scale (kDiv, kNoclip) or a multiplier (kStatic:
// r, kRecip: 127 / m); kFloor takes none
template <int MODE>
__device__ __forceinline__ int8_t code(float v, float mult) {
  if (MODE == kDiv) return clip_rint(__fdiv_rn(v, mult));
  if (MODE == kNoclip) return cvt_rni_sat(__fdiv_rn(v, mult));
  if (MODE == kFloor) return cvt_rzi_sat(v);
  return clip_rint(__fmul_rn(v, mult));
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

template <typename T, int MODE>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
layernorm_q8_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                    const float* __restrict__ bias, int8_t* __restrict__ q,
                    float* __restrict__ s, const float* __restrict__ r, int rows, int D,
                    float eps) {
  constexpr int kN = Vec<T>::kN;
  constexpr int kMaxVecPerLane = 1024 / 32 / kN;  // 32 values a lane at D = 1024
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
  const float mean = __fdiv_rn(warp_sum(sum), (float)D);
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxVecPerLane; ++i) {
    if (lane + i * 32 < nvec) {
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        const float d = __fsub_rn(v[i][j], mean);
        sq = __fadd_rn(sq, __fmul_rn(d, d));
      }
    }
  }
  const float inv = __frsqrt_rn(__fadd_rn(__fdiv_rn(warp_sum(sq), (float)D), eps));

  const float4* s4 = reinterpret_cast<const float4*>(scale);
  const float4* b4 = reinterpret_cast<const float4*>(bias);
  constexpr int kQ = kN / 4;  // float4s of parameters a vector
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxVecPerLane; ++i) {
    const int c = lane + i * 32;
    if (c < nvec) {
      float4 sq4[kQ], bq4[kQ];
#pragma unroll
      for (int k = 0; k < kQ; ++k) sq4[k] = s4[kQ * c + k];
#pragma unroll
      for (int k = 0; k < kQ; ++k) bq4[k] = b4[kQ * c + k];
      const float* sc = reinterpret_cast<const float*>(sq4);
      const float* bi = reinterpret_cast<const float*>(bq4);
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        const float xhat = __fmul_rn(__fsub_rn(v[i][j], mean), inv);
        v[i][j] = __fadd_rn(__fmul_rn(xhat, sc[j]), bi[j]);
        amax = fmaxf(amax, fabsf(v[i][j]));
      }
    }
  }
  float mult = 0.f;
  if (MODE == kStatic) {
    mult = *r;
  } else if (MODE == kRecip) {
    const float m = fmaxf(warp_max(amax), 1e-8f);
    if (lane == 0) s[row] = __fdiv_rn(m, 127.0f);
    mult = __fdiv_rn(127.0f, m);
  } else if (MODE != kFloor) {
    mult = fmaxf(__fdiv_rn(warp_max(amax), 127.0f), 1e-8f);
    if (lane == 0) s[row] = mult;
  }
  using Codes = typename Vec<T>::Codes;
  Codes* qr = reinterpret_cast<Codes*>(q + (size_t)row * D);
#pragma unroll
  for (int i = 0; i < kMaxVecPerLane; ++i) {
    const int c = lane + i * 32;
    if (c < nvec) {
      Codes u;
      int8_t* o = reinterpret_cast<int8_t*>(&u);
#pragma unroll
      for (int j = 0; j < kN; ++j)
        o[j] = code<MODE>(v[i][j], mult);
      qr[c] = u;
    }
  }
}

template <typename T, int MODE>
int launch(const void* x, const void* scale, const void* bias, void* q, void* s,
           const void* r, int rows, int D, float eps, cudaStream_t st) {
  const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  layernorm_q8_kernel<T, MODE><<<blocks, kRowsPerBlock * 32, 0, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<int8_t*>(q), static_cast<float*>(s),
      static_cast<const float*>(r), rows, D, eps);
  return (int)cudaGetLastError();
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
