// quant_rows: fp32 (M, X) -> int8 (M, X), symmetric per row (dynamic, with
// an fp32 (M) scale) or by one static multiplier.
//
// Replaces: _quant_rows (mudpt_tpu/ops/quant_block.py:70-76) where the TPU
//   int8 layer kernels apply it to an fp32 value they hold: the attention
//   accumulator (:101, :193) and the QuickGELU output g (:107-108,
//   :200-201) of _layer_fwd_q8_kernel (:89) and _layer_fwd_q8_save_kernel
//   (:178); and the static quant_static (:390-392, :575-577) of the
//   attention accumulator in _layer_fwd_q8_static_kernel (:377) and
//   _layer_fwd_q8_static_save_kernel (:563); and tools/probe_int8_mxu.py
//   quant_kernel (:56), the dynamic function at 384 x 768.
//   dynamic: s = max(max|x| / 127, 1e-8), q = clip(rint(x / s), -127, 127)
//   static:  q = clip(rint(x * r), -127, 127)
//   The row max is exact, the division IEEE (__fdiv_rn, not a multiply by
//   127 / max) and rint rounds half to even, as jnp.round does: codes and
//   scales are bit-equal to the plain version's.
//   The other modes are the ablations of tools/probe_q8_residual.py
//   quant_rows (:76-102), each dropping one step of the dynamic one, through
//   quant_rows_mode only (ops/probe.py):
//   recip:   m = max(max|x|, 1e-8), q = clip(rint(x * (127 / m))), s = m / 127
//   noclip:  the dynamic codes without the clip (equal to them: |x / s| <= 127)
//   floor:   q = int8(x), XLA's convert: toward zero, saturated, NaN -> 0
// Bound on the H100: device-memory bytes (4 read and 1 written per
//   element, a handful of operations each).
// Design: one block of 128 threads owns a row (X <= 4096, up to 8 float4
//   a thread kept in registers between the max and the quantization, so
//   the row is read once); the max is a warp shuffle reduction, then one
//   across the 4 warps through shared memory.  Codes leave as 4 bytes a
//   thread, neighbouring threads on neighbouring addresses.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxVec = 8;  // 128 threads x 8 float4: X <= 4096

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

template <int MODE>
__global__ void __launch_bounds__(kThreads)
quant_rows_kernel(const float* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ s,
                  const float* __restrict__ r, int X) {
  __shared__ float part[kThreads / 32];
  const int row = blockIdx.x, tid = threadIdx.x;
  const int nvec = X >> 2;
  const float4* xr = reinterpret_cast<const float4*>(x + (size_t)row * X);
  float4 v[kMaxVec];
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxVec; ++i) {
    const int c = tid + i * kThreads;
    if (c < nvec) {
      v[i] = xr[c];
      amax = fmaxf(fmaxf(amax, fmaxf(fabsf(v[i].x), fabsf(v[i].y))),
                   fmaxf(fabsf(v[i].z), fabsf(v[i].w)));
    }
  }
  float mult = 0.f;
  if (MODE == kStatic) {
    mult = *r;
  } else if (MODE != kFloor) {
    amax = warp_max(amax);
    if ((tid & 31) == 0) part[tid >> 5] = amax;
    __syncthreads();
    amax = fmaxf(fmaxf(part[0], part[1]), fmaxf(part[2], part[3]));
    if (MODE == kRecip) {
      const float m = fmaxf(amax, 1e-8f);
      if (tid == 0) s[row] = __fdiv_rn(m, 127.0f);
      mult = __fdiv_rn(127.0f, m);
    } else {
      const float scale = fmaxf(__fdiv_rn(amax, 127.0f), 1e-8f);
      if (tid == 0) s[row] = scale;
      mult = scale;
    }
  }
  char4* qr = reinterpret_cast<char4*>(q + (size_t)row * X);
#pragma unroll
  for (int i = 0; i < kMaxVec; ++i) {
    const int c = tid + i * kThreads;
    if (c < nvec) {
      char4 o;
      o.x = code<MODE>(v[i].x, mult);
      o.y = code<MODE>(v[i].y, mult);
      o.z = code<MODE>(v[i].z, mult);
      o.w = code<MODE>(v[i].w, mult);
      qr[c] = o;
    }
  }
}

int launch(const void* x, void* q, void* s, const void* r, int rows, int X, int mode,
           cudaStream_t st) {
  if (rows < 1 || X % 4 || X > 4 * kThreads * kMaxVec) return (int)cudaErrorInvalidValue;
  if ((mode == kStatic) != (r != nullptr)) return (int)cudaErrorInvalidValue;
  const auto* xf = static_cast<const float*>(x);
  auto* qo = static_cast<int8_t*>(q);
  auto* so = static_cast<float*>(s);
  const auto* rf = static_cast<const float*>(r);
  switch (mode) {
    case kDiv: quant_rows_kernel<kDiv><<<rows, kThreads, 0, st>>>(xf, qo, so, rf, X); break;
    case kStatic: quant_rows_kernel<kStatic><<<rows, kThreads, 0, st>>>(xf, qo, so, rf, X); break;
    case kRecip: quant_rows_kernel<kRecip><<<rows, kThreads, 0, st>>>(xf, qo, so, rf, X); break;
    case kNoclip: quant_rows_kernel<kNoclip><<<rows, kThreads, 0, st>>>(xf, qo, so, rf, X); break;
    case kFloor: quant_rows_kernel<kFloor><<<rows, kThreads, 0, st>>>(xf, qo, so, rf, X); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x (rows, X) fp32 -> q (rows, X) int8; dynamic (r null): s (rows) fp32;
// static: r one fp32 multiplier in device memory, s unused.
extern "C" int quant_rows(const void* x, void* q, void* s, const void* r, int rows, int X,
                          void* stream) {
  return launch(x, q, s, r, rows, X, r != nullptr ? kStatic : kDiv, (cudaStream_t)stream);
}

// The same in any mode (0 dynamic, 1 static, 2 recip, 3 noclip, 4 floor): s
// (rows) fp32 in modes 0 and 2, unused in the others; r in mode 1 only.
extern "C" int quant_rows_mode(const void* x, void* q, void* s, const void* r, int rows, int X,
                               int mode, void* stream) {
  return launch(x, q, s, r, rows, X, mode, (cudaStream_t)stream);
}
