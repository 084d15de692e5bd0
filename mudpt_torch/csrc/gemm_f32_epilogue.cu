// gemm_f32_epilogue: C[M,N] = epilogue(A[M,K] . B[K,N]), fp32 operands,
// fp32 products and accumulation.  B is W in its (in, out) = (K, N)
// row-major layout for the forward epilogues, and W^T for the backward
// ones, with W (N, K) row-major: the layer's weights are used in their
// stored layout both ways, and a column chunk of a wider weight is read in
// place through its row stride.
//
// Replaces: the projections of the TPU layer kernels in
//   mudpt_tpu/ops/fused_block.py on fp32 activations.  The Pallas kernels
//   cast their operands to x.dtype and round to it (_attn_project and
//   _attn_finish :301-315, _mlp_pre and the MLP kernels :392-425, the
//   chunked MLP half :477-525); with x fp32 every rounding point is a
//   no-op, so each epilogue of gemm_bf16_epilogue.cu becomes, in fp32:
//   qkv          (:301-307)                 C = acc + b
//   out-proj     (:310-315), proj (:861-865) C = R + (acc + b)
//   fc           (:392-400, :860)           C = g(acc + b), g(h) = h*sigmoid(1.702h)
//   fc, saving   (:841-843)                 C = h, C2 = g(h), h = acc + b
//   g.proj_w^T   (:430-434)                 C = acc * g'(H), H the saved h
//   dy1.out_w^T, dh.fc_w^T, dqkv.qkv_w^T (:340-352, :435-438)   C = acc
//   fc, gradient (:447, :434)               C = g'(acc + b)
//   g.proj_w^T   (:430-434, recompute)      C = acc * F, F the tile above
//   proj chunk   (:486, :493-497)           C = (R + b) + acc on the first
//                                           chunk (R = x), else C = C + acc
//                                           (y, in place)
//   dh.fc_w^T    (:522-525, chunks)         C = acc, then C += acc
//   with b fp32 (qkv_b.astype(x.dtype), :307).  The kernel and its plain
//   version (fp32 torch.matmul with TF32 off) differ only in the order of
//   the fp32 sums and in the last ulp of exp and division in g and g'.
// Bound on the H100: operations.  At the ViT-B/16 vision shapes (M =
//   384*199 = 76,416 tokens, K, N in 768..3072) a product does 2*M*N*K
//   operations over (M*K + K*N + M*N*(1..3))*4 bytes: ~190-380 operations
//   a byte.  No tensor-core path computes fp32 products exactly: TF32's
//   10-bit mantissa reads ~2^-11, so a product that PREC fp32 asks for runs
//   on the FMA pipes (67 TFLOP/s) or as three TF32 products (3xTF32, the
//   fastest fp32-accurate product: 494.7 / 3 TFLOP/s), both far below the
//   bytes' rate at these shapes.
// Design: a register-blocked SIMT product, the first that is right, in
//   fp32 FMAs with one rounding per multiply-add.  256 threads own a
//   128 x 128 output tile, each 8 x 8 outputs (two 4 x 4 quadrants, rows
//   ty*4 and 64 + ty*4, columns tx*4 and 64 + tx*4, so that its 16-byte
//   shared-memory reads are broadcasts or consecutive).  K advances in
//   slices of 16: A's slice is stored k-major (As[k][m], one thread a row
//   so the transposing stores are consecutive), W's (K, N) slice as it
//   lies, an (N, K) W's slice transposed the same way as A's; each thread
//   reads four 16-byte vectors for 64 FMAs a k step.  Two shared-memory
//   stages: the next slice is loaded into registers while the current
//   one's products run, then stored into the other stage, one barrier a
//   slice.  The epilogue works on the accumulator registers and reads and
//   writes 16-byte vectors, 16 threads covering 64 consecutive columns of
//   a row.  No atomics and a fixed order of sums: a result repeats exactly
//   from launch to launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128, BN = 128, BK = 16, THREADS = 256;

enum Epilogue {
  kQkv = 0,
  kResidual = 1,
  kFcGelu = 2,
  kFcGeluSave = 3,
  kGeluBwd = 4,
  kStore = 5,  // the activation dtype, here fp32
  kStoreF32 = 6,
  kFcGeluGrad = 7,
  kMulF32 = 8,
  kChunkResidual = 9,
  kAddF32 = 10,
};

__device__ __forceinline__ float quick_gelu(float h) { return h / (1.0f + expf(-1.702f * h)); }

__device__ __forceinline__ float quick_gelu_grad(float h) {
  const float s = 1.0f / (1.0f + expf(-1.702f * h));
  return s + 1.702f * h * s * (1.0f - s);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// W_NK: W given as (N, K) and read transposed (the backward epilogues)
template <bool W_NK>
__global__ void __launch_bounds__(THREADS, 2)
gemm_f32_kernel(const float* __restrict__ A, const float* __restrict__ W,
                const float* __restrict__ bias, const float* R, float* C,
                float* __restrict__ C2, int M, int N, int K, int ldw, int mode, int tiles_n) {
  __shared__ __align__(16) float As[2][BK][BM];
  __shared__ __align__(16) float Bs[2][BK][BN];
  const int tid = threadIdx.x;
  const int m0 = (blockIdx.x / tiles_n) * BM;
  const int n0 = (blockIdx.x % tiles_n) * BN;
  const int tx = tid & 15, ty = tid >> 4;

  // each thread brings two 16-byte vectors of A's slice and two of W's
  float4 ra[2], rb[2];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * THREADS;
      const int r = idx & (BM - 1), kk = (idx >> 7) * 4;  // A: a row a thread
      ra[i] = m0 + r < M ? ld4(A + (size_t)(m0 + r) * K + k0 + kk) : make_float4(0, 0, 0, 0);
      if (W_NK) {  // W (N, K): a row of W (an output column) a thread
        const int n = idx & (BN - 1);
        rb[i] = n0 + n < N ? ld4(W + (size_t)(n0 + n) * ldw + k0 + kk) : make_float4(0, 0, 0, 0);
      } else {  // W (K, N): 32 threads cover 128 consecutive columns
        const int k = idx >> 5, n = (idx & 31) * 4;
        rb[i] = n0 + n < N ? ld4(W + (size_t)(k0 + k) * ldw + n0 + n) : make_float4(0, 0, 0, 0);
      }
    }
  };
  auto store = [&](int s) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * THREADS;
      const int r = idx & (BM - 1), kk = (idx >> 7) * 4;
      As[s][kk][r] = ra[i].x;
      As[s][kk + 1][r] = ra[i].y;
      As[s][kk + 2][r] = ra[i].z;
      As[s][kk + 3][r] = ra[i].w;
      if (W_NK) {
        Bs[s][kk][r] = rb[i].x;
        Bs[s][kk + 1][r] = rb[i].y;
        Bs[s][kk + 2][r] = rb[i].z;
        Bs[s][kk + 3][r] = rb[i].w;
      } else {
        *reinterpret_cast<float4*>(&Bs[s][idx >> 5][(idx & 31) * 4]) = rb[i];
      }
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int n_slices = K / BK;
  load(0);
  store(0);
  __syncthreads();
  for (int t = 0; t < n_slices; ++t) {
    const int s = t & 1;
    if (t + 1 < n_slices) load((t + 1) * BK);
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[s][k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[s][k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[s][k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[s][k][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    // the other stage was last read before the previous barrier
    if (t + 1 < n_slices) store(s ^ 1);
    __syncthreads();
  }

  // epilogue: rows ty*4 + i and 64 + ty*4 + i, columns tx*4 and 64 + tx*4
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i >> 2) * 64 + ty * 4 + (i & 3);
    if (m >= M) continue;
#pragma unroll
    for (int jh = 0; jh < 2; ++jh) {
      const int n = n0 + jh * 64 + tx * 4;
      if (n >= N) continue;  // N % 4 == 0: the vector lies inside
      const size_t off = (size_t)m * N + n;
      float v[4] = {acc[i][jh * 4], acc[i][jh * 4 + 1], acc[i][jh * 4 + 2], acc[i][jh * 4 + 3]};
      float b[4] = {0.f, 0.f, 0.f, 0.f};
      if (bias != nullptr) {
        const float4 b4 = ld4(bias + n);
        b[0] = b4.x; b[1] = b4.y; b[2] = b4.z; b[3] = b4.w;
      }
      float o[4];
      float x[4] = {0.f, 0.f, 0.f, 0.f};  // the second operand
      if (mode == kResidual || mode == kGeluBwd || mode == kMulF32 || mode == kChunkResidual ||
          mode == kAddF32) {
        // chunk_residual without R reads y in place; add_f32 adds to C
        const float* src = (mode == kAddF32 || (mode == kChunkResidual && R == nullptr)) ? C : R;
        const float4 x4 = ld4(src + off);
        x[0] = x4.x; x[1] = x4.y; x[2] = x4.z; x[3] = x4.w;
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        switch (mode) {
          case kQkv: o[c] = v[c] + b[c]; break;
          case kResidual: o[c] = x[c] + (v[c] + b[c]); break;
          case kFcGelu: o[c] = quick_gelu(v[c] + b[c]); break;
          case kFcGeluSave: o[c] = v[c] + b[c]; break;
          case kGeluBwd: o[c] = v[c] * quick_gelu_grad(x[c]); break;
          case kFcGeluGrad: o[c] = quick_gelu_grad(v[c] + b[c]); break;
          case kMulF32: o[c] = v[c] * x[c]; break;
          case kChunkResidual: o[c] = (bias != nullptr ? x[c] + b[c] : x[c]) + v[c]; break;
          case kAddF32: o[c] = x[c] + v[c]; break;
          default: o[c] = v[c]; break;  // kStore, kStoreF32
        }
      }
      st4(C + off, o);
      if (mode == kFcGeluSave) {
        float g[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) g[c] = quick_gelu(o[c]);
        st4(C2 + off, g);
      }
    }
  }
}

}  // namespace

// mode: Epilogue.  A: (M, K).  W: (K, N), or (N, K) for modes 4, 5, 6, 8
// and 10 (B = W^T), its rows ldw elements apart.  bias: (N) for modes 0-3
// and 7, optional for mode 9, else unused.  R: the residual (modes 1 and 9;
// for mode 9 null means C itself, y in place), the saved h (mode 4) or the
// factor F (mode 8), (M, N).  C: (M, N) (mode 10 adds to it).  C2: the
// second output of mode 3.  Every tensor fp32 and 16-byte aligned; K a
// multiple of 16, N and ldw of 4.
extern "C" int gemm_f32_epilogue(const void* A, const void* W, const void* bias, const void* R,
                                 void* C, void* C2, int M, int N, int K, int ldw, int mode,
                                 void* stream) {
  if (mode < kQkv || mode > kAddF32) return (int)cudaErrorInvalidValue;
  const bool w_nk = mode == kGeluBwd || mode == kStore || mode == kStoreF32 ||
                    mode == kMulF32 || mode == kAddF32;
  const int w_cols = w_nk ? K : N;
  if (M < 1 || K < BK || K % BK || N < 4 || N % 4 || ldw < w_cols || ldw % 4 ||
      reinterpret_cast<uintptr_t>(W) % 16)
    return (int)cudaErrorInvalidValue;
  const bool biased = mode == kQkv || mode == kResidual || mode == kFcGelu ||
                      mode == kFcGeluSave || mode == kFcGeluGrad;
  if ((biased && bias == nullptr) || (mode == kFcGeluSave && C2 == nullptr) ||
      ((mode == kResidual || mode == kGeluBwd || mode == kMulF32) && R == nullptr))
    return (int)cudaErrorInvalidValue;
  const int tiles_n = (N + BN - 1) / BN;
  const long long tiles = (long long)tiles_n * ((M + BM - 1) / BM);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const auto* a = static_cast<const float*>(A);
  const auto* w = static_cast<const float*>(W);
  const auto* b = static_cast<const float*>(bias);
  const auto* r = static_cast<const float*>(R);
  auto* c = static_cast<float*>(C);
  auto* c2 = static_cast<float*>(C2);
  const cudaStream_t s = (cudaStream_t)stream;
  if (w_nk) {
    gemm_f32_kernel<true><<<(unsigned)tiles, THREADS, 0, s>>>(a, w, b, r, c, c2, M, N, K, ldw,
                                                               mode, tiles_n);
  } else {
    gemm_f32_kernel<false><<<(unsigned)tiles, THREADS, 0, s>>>(a, w, b, r, c, c2, M, N, K, ldw,
                                                                mode, tiles_n);
  }
  return (int)cudaGetLastError();
}
