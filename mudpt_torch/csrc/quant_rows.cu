// quant_rows: fp32 (M, X) -> int8 (M, X), symmetric per row (dynamic, with
// an fp32 (M) scale) or by one static multiplier.
//
// Replaces: _quant_rows (mudpt_tpu/ops/quant_block.py:70-76) where the TPU
//   int8 layer kernels apply it to an fp32 value they hold: the attention
//   accumulator (:101, :193) and the QuickGELU output g (:107-108,
//   :200-201) of _layer_fwd_q8_kernel (:89) and _layer_fwd_q8_save_kernel
//   (:178); and the static quant_static (:390-392, :575-577) of the
//   attention accumulator in _layer_fwd_q8_static_kernel (:377) and
//   _layer_fwd_q8_static_save_kernel (:563).
//   dynamic: s = max(max|x| / 127, 1e-8), q = clip(rint(x / s), -127, 127)
//   static:  q = clip(rint(x * r), -127, 127)
//   The row max is exact, the division IEEE (__fdiv_rn, not a multiply by
//   127 / max) and rint rounds half to even, as jnp.round does: codes and
//   scales are bit-equal to the plain version's.
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

template <bool STATIC>
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
  float mult;
  if (STATIC) {
    mult = *r;
  } else {
    amax = warp_max(amax);
    if ((tid & 31) == 0) part[tid >> 5] = amax;
    __syncthreads();
    amax = fmaxf(fmaxf(part[0], part[1]), fmaxf(part[2], part[3]));
    const float scale = fmaxf(__fdiv_rn(amax, 127.0f), 1e-8f);
    if (tid == 0) s[row] = scale;
    mult = scale;
  }
  char4* qr = reinterpret_cast<char4*>(q + (size_t)row * X);
#pragma unroll
  for (int i = 0; i < kMaxVec; ++i) {
    const int c = tid + i * kThreads;
    if (c < nvec) {
      char4 o;
      if (STATIC) {
        o.x = clip_rint(__fmul_rn(v[i].x, mult));
        o.y = clip_rint(__fmul_rn(v[i].y, mult));
        o.z = clip_rint(__fmul_rn(v[i].z, mult));
        o.w = clip_rint(__fmul_rn(v[i].w, mult));
      } else {
        o.x = clip_rint(__fdiv_rn(v[i].x, mult));
        o.y = clip_rint(__fdiv_rn(v[i].y, mult));
        o.z = clip_rint(__fdiv_rn(v[i].z, mult));
        o.w = clip_rint(__fdiv_rn(v[i].w, mult));
      }
      qr[c] = o;
    }
  }
}

}  // namespace

// x (rows, X) fp32 -> q (rows, X) int8; dynamic (r null): s (rows) fp32;
// static: r one fp32 multiplier in device memory, s unused.
extern "C" int quant_rows(const void* x, void* q, void* s, const void* r, int rows, int X,
                          void* stream) {
  if (rows < 1 || X % 4 || X > 4 * kThreads * kMaxVec) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const auto* xf = static_cast<const float*>(x);
  auto* qo = static_cast<int8_t*>(q);
  auto* so = static_cast<float*>(s);
  const auto* rf = static_cast<const float*>(r);
  if (rf != nullptr) {
    quant_rows_kernel<true><<<rows, kThreads, 0, st>>>(xf, qo, so, rf, X);
  } else {
    quant_rows_kernel<false><<<rows, kThreads, 0, st>>>(xf, qo, so, rf, X);
  }
  return (int)cudaGetLastError();
}
