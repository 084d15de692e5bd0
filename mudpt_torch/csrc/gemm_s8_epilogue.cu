// gemm_s8_epilogue: C[M,N] = epilogue(A[M,K] . W[N,K]^T), int8 operands,
// int32 accumulation on the tensor cores, dequantized in fp32.
//
// Replaces: the four projections of the TPU int8 layer kernels in
//   mudpt_tpu/ops/quant_block.py, _q8_matmul (:79-86) and the static
//   matmul_static (:394-399, :579-584), inside _layer_fwd_q8_kernel (:89),
//   _layer_fwd_q8_save_kernel (:178), _layer_fwd_q8_static_kernel (:377)
//   and _layer_fwd_q8_static_save_kernel (:563).  v = f32(acc), then
//   dynamic (per-row activation scale xs, per-column weight scale ws):
//     v = (v * xs) * ws + f32(b)                             (:85-86)
//   static (ws already carries the site's dequant factor, :481-484):
//     v = v * ws + f32(b)                                    (:399)
//   each product and sum rounded on its own (__fmul_rn, __fadd_rn: no FMA
//   contraction), then the epilogue:
//     qkv       C = bf16(v)                                  (:99, :402-404)
//     residual  C = R + bf16(v), a bf16 add                  (:102, :109, :406)
//     fc_gelu   dynamic: C = g fp32 (quantized per row by quant_rows next);
//               static: C = int8 clip(rint(g * r3)), r3 read from device
//               memory (:410-413); g = h * sigmoid(1.702 h), h = v fp32;
//               with C2 given, also C2 = bf16(h), the saved h (:199, :598)
//   The int32 sum is exact (|acc| <= 127^2 * K < 2^26), so given the same
//   int8 operands and scales the qkv and residual epilogues are bit-equal
//   to their plain version; fc_gelu differs by the exp and division of g.
// Bound on the H100: near the ridge.  At the vision shapes (M = 384*199 =
//   76,416 tokens, K, N in 768..3072) a product does 2*M*N*K int8
//   operations over M*K + N*K + M*N*(1..4) bytes: ~660 operations a byte
//   for qkv and proj (the int8 tensor cores bind above ~590: 1,979 TOP/s
//   over 3.35 TB/s), ~360 for fc with its fp32 output and ~300 for the
//   768 -> 768 out-projection, which are bound by their bytes.
// Design: a simple kernel that is right first (wgmma and TMA are later
//   work).  A block of 8 warps owns a 128 x 128 output tile; each warp a
//   64 x 32 slab of int32 accumulators from mma.sync m16n8k32 s8 tiles fed
//   by ldmatrix.  A 4-stage cp.async ring stages 64-byte K slices of A and
//   W (both K-major: W is the (N, K) int8 copy of the weight, the layout
//   the s8 MMA takes for B), rows padded to 80 bytes so the ldmatrix rows
//   fall on distinct banks.  Ragged M rows are zero-filled and not stored;
//   N must be a multiple of 128 and K of 64.  The epilogue works on the
//   accumulator registers and stores from them: a quad of lanes writes 8
//   bf16 or fp32 values of a row at a time.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

enum Mode { kQkv = 0, kResidual = 1, kFcGelu = 2, kSQkv = 3, kSResidual = 4, kSFcGelu = 5 };

__host__ __device__ constexpr bool is_static(int mode) { return mode >= kSQkv; }

constexpr int BM = 128, BN = 128, BK = 64, STAGES = 4;
constexpr int THREADS = 256;      // 8 warps: 2 along M x 4 along N
constexpr int LDS = BK + 16;      // bytes per staged row
constexpr int STAGE_BYTES = (BM + BN) * LDS;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES;  // 81,920

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = pred ? 16 : 0;  // 0 source bytes: 16 zero bytes land in smem
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(bytes));
}

// four 8 x 16-byte matrices, one row address per lane (lanes 8i..8i+7:
// matrix i); lane T gets bytes 4(T%4)..4(T%4)+3 of row T/4 of each
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// c += a (16 x 32, row-major) . b (32 x 8, column-major), int32 accumulate
__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// h * sigmoid(1.702 h) in fp32, IEEE division and accurate exp: within a
// few fp32 ulps of the plain version's
__device__ __forceinline__ float quick_gelu(float h) {
  return __fmul_rn(h, __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-__fmul_rn(1.702f, h)))));
}

__device__ __forceinline__ int8_t quant_static(float v, float r) {
  return static_cast<int8_t>(fminf(fmaxf(rintf(__fmul_rn(v, r)), -127.0f), 127.0f));
}

template <int MODE>
__global__ void __launch_bounds__(THREADS, 2)
gemm_s8_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ W,
               const float* __restrict__ xs, const float* __restrict__ ws,
               const __nv_bfloat16* __restrict__ bias, const __nv_bfloat16* __restrict__ R,
               const float* __restrict__ r, void* __restrict__ C,
               __nv_bfloat16* __restrict__ C2, int M, int N, int K) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int KT = K / BK;

  // one K slice of A (128 rows) and W (128 rows), 16 bytes a copy, two
  // copies of each per thread
  auto load = [&](int stage, int kt) {
    unsigned char* sa = smem + stage * STAGE_BYTES;
    unsigned char* sb = sa + BM * LDS;
    const int k0 = kt * BK;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * THREADS;
      const int row = c >> 2, col = (c & 3) * 16;
      const bool ok = m0 + row < M;
      cp_async16(sa + row * LDS + col, A + (size_t)(ok ? m0 + row : 0) * K + k0 + col, ok);
      cp_async16(sb + row * LDS + col, W + (size_t)(n0 + row) * K + k0 + col, true);
    }
  };

  int acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] = acc[mi][ni][3] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load(s, s);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  for (int kt = 0; kt < KT; ++kt) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2));
    __syncthreads();  // slice kt landed for every thread; slice kt-1's stage is free
    if (kt + STAGES - 1 < KT) load((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
    asm volatile("cp.async.commit_group;\n" ::);
    const unsigned char* sa = smem + (kt % STAGES) * STAGE_BYTES;
    const unsigned char* sb = sa + BM * LDS;
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk) {
      uint32_t af[4][4], bf[2][4];
      // A: rows 16mi + (lane & 15), bytes 16 * (lane >> 4) of the 32
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldsm_x4(af[mi], sa + (wm * 64 + mi * 16 + (lane & 15)) * LDS + kk * 32 + (lane >> 4) * 16);
      // W: n rows 16nj + (lane & 7) + 8 (lane >> 4), bytes 16 ((lane >> 3) & 1):
      // b0, b1 of n-tile 2nj, then of 2nj + 1
#pragma unroll
      for (int nj = 0; nj < 2; ++nj)
        ldsm_x4(bf[nj], sb + (wn * 32 + nj * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDS +
                            kk * 32 + ((lane >> 3) & 1) * 16);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_s8(acc[mi][ni], af[mi], bf[ni >> 1][(ni & 1) * 2], bf[ni >> 1][(ni & 1) * 2 + 1]);
    }
  }

  // acc[mi][ni][0..1]: row 16mi + lane/4, cols 8ni + 2(lane%4) + 0..1;
  // acc[mi][ni][2..3]: row + 8
  const int g = lane >> 2, t = lane & 3;
  float wsc[4][2], bb[4][2];
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int col = n0 + wn * 32 + ni * 8 + 2 * t;
    const float2 w2 = *reinterpret_cast<const float2*>(ws + col);
    const float2 b2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias + col));
    wsc[ni][0] = w2.x;
    wsc[ni][1] = w2.y;
    bb[ni][0] = b2.x;
    bb[ni][1] = b2.y;
  }
  float r3 = 0.f;
  if (MODE == kSFcGelu) r3 = *r;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm * 64 + mi * 16 + g + half * 8;
      if (row >= M) continue;
      const float xr = is_static(MODE) ? 1.f : xs[row];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = n0 + wn * 32 + ni * 8 + 2 * t;
        const size_t off = (size_t)row * N + col;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float a = __int2float_rn(acc[mi][ni][2 * half + e]);
          if (!is_static(MODE)) a = __fmul_rn(a, xr);
          v[e] = __fadd_rn(__fmul_rn(a, wsc[ni][e]), bb[ni][e]);
        }
        if (MODE == kQkv || MODE == kSQkv) {
          *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(C) + off) =
              __floats2bfloat162_rn(v[0], v[1]);
        } else if (MODE == kResidual || MODE == kSResidual) {
          const float2 r2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(R + off));
          *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(C) + off) =
              __floats2bfloat162_rn(__fadd_rn(r2.x, bf16_round(v[0])),
                                    __fadd_rn(r2.y, bf16_round(v[1])));
        } else {
          if (C2 != nullptr)
            *reinterpret_cast<__nv_bfloat162*>(C2 + off) = __floats2bfloat162_rn(v[0], v[1]);
          const float g0 = quick_gelu(v[0]), g1 = quick_gelu(v[1]);
          if (MODE == kFcGelu) {
            *reinterpret_cast<float2*>(static_cast<float*>(C) + off) = make_float2(g0, g1);
          } else {
            char2 q;
            q.x = quant_static(g0, r3);
            q.y = quant_static(g1, r3);
            *reinterpret_cast<char2*>(static_cast<int8_t*>(C) + off) = q;
          }
        }
      }
    }
  }
}

template <int MODE>
int launch(const int8_t* a, const int8_t* w, const float* xs, const float* ws,
           const __nv_bfloat16* b, const __nv_bfloat16* R, const float* r, void* c,
           __nv_bfloat16* c2, int M, int N, int K, cudaStream_t s) {
  auto kernel = gemm_s8_kernel<MODE>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(N / BN, (M + BM - 1) / BM);
  kernel<<<grid, THREADS, SMEM_BYTES, s>>>(a, w, xs, ws, b, R, r, c, c2, M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace

// A (M, K) int8; W (N, K) int8; xs (M) fp32 row scales (dynamic modes
// 0-2, else unused); ws (N) fp32 column scales; bias (N) bf16; R (M, N)
// bf16 residual (modes 1, 4); r one fp32 multiplier (mode 5).  C (M, N):
// bf16 (modes 0, 1, 3, 4), fp32 (2) or int8 (5); C2 (M, N) bf16 h for the
// fc modes 2 and 5, or null.
extern "C" int gemm_s8_epilogue(const void* A, const void* W, const void* xs, const void* ws,
                                const void* bias, const void* R, const void* r, void* C,
                                void* C2, int M, int N, int K, int mode, void* stream) {
  if (M < 1 || N % BN || K % BK || K < BK) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const auto* a = static_cast<const int8_t*>(A);
  const auto* w = static_cast<const int8_t*>(W);
  const auto* x = static_cast<const float*>(xs);
  const auto* wsc = static_cast<const float*>(ws);
  const auto* b = static_cast<const __nv_bfloat16*>(bias);
  const auto* res = static_cast<const __nv_bfloat16*>(R);
  const auto* rr = static_cast<const float*>(r);
  auto* c2 = static_cast<__nv_bfloat16*>(C2);
  switch (mode) {
    case kQkv: return launch<kQkv>(a, w, x, wsc, b, res, rr, C, c2, M, N, K, s);
    case kResidual: return launch<kResidual>(a, w, x, wsc, b, res, rr, C, c2, M, N, K, s);
    case kFcGelu: return launch<kFcGelu>(a, w, x, wsc, b, res, rr, C, c2, M, N, K, s);
    case kSQkv: return launch<kSQkv>(a, w, x, wsc, b, res, rr, C, c2, M, N, K, s);
    case kSResidual: return launch<kSResidual>(a, w, x, wsc, b, res, rr, C, c2, M, N, K, s);
    case kSFcGelu: return launch<kSFcGelu>(a, w, x, wsc, b, res, rr, C, c2, M, N, K, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
