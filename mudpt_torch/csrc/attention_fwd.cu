// attention_fwd: multi-head softmax attention from a packed qkv, per
// (sequence block, head, 128-query tile), head dim 64.
//
// Replaces: the attention core of the TPU layer kernel, _mha_acc
//   (mudpt_tpu/ops/fused_block.py:222-239) with _head_probs (:197-205) and
//   the masks of _causal_mask / _attn_block_spec (:168-219), inside
//   _layer_fwd_nosave_kernel (:851), _layer_fwd_kernel (:831) and the
//   attention half's _attn_fwd_kernel (:318) and _attn_fwd_save_kernel
//   (:326).  Same numerics: scores are fp32
//   q.k^T (bf16 operands) times hd^-0.5, the mask adds -1e30 (_NEG, :46),
//   softmax is fp32 (exp(s - max) / sum), probabilities are rounded to
//   bf16 before P.V, which accumulates in fp32 and is written as bf16.
// Mask specs: none; causal; packed (period, valid), where the wrapper passes
//   L = period and every `period` consecutive tokens form an independent
//   causal sequence whose keys at position >= valid are masked.
// Bound on the H100: device-memory bytes at the serving shapes.  At S = 199
//   a (image, head) does 4*S*S*64 = 10 M operations on 4*S*64*2 = 102 KB of
//   q, k, v and output, ~100 operations per byte, a third of the ~295 where
//   bf16 tensor cores bind; the packed text rows (S = 16) are further below.
// fp32 output mode: the int8 layer kernels keep the attention accumulator
//   in fp32 (mudpt_tpu/ops/quant_block.py:146, :259, :283, :443, :624:
//   VMEM((S, D), float32) into which _mha_acc stores o unrounded) and
//   quantize it from there (:101); the same kernel then stores o as fp32.
// Design: a block of 8 warps stages K, V and its 128 queries in shared
//   memory with cp.async (zero rows past L, so the ragged S = 199 needs no
//   special path); each warp owns 16 query rows and keeps everything else
//   in registers.  Scores come from mma.sync m16n8k16 bf16 tiles fed by
//   ldmatrix (V read transposed by ldmatrix.trans).  A first pass over the
//   keys takes the row max and the sum of exp(s - max), rescaled online; a
//   second pass recomputes the scores, forms p = exp(s - max) / sum and
//   rounds it to bf16 straight into the A fragments of the P.V products,
//   so the probabilities are normalized before their bf16 rounding, as in
//   the Pallas kernel.  No score or probability leaves the registers, and
//   nothing of size (B, H, S, S) reaches device memory.  Sequence blocks up
//   to 400 tokens fit the shared memory.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int HD = 64;           // head dim
constexpr int QT = 128;          // query rows per block
constexpr int kWarps = QT / 16;  // one warp per 16 query rows
constexpr int LD = HD + 8;       // bf16 elements per staged Q/K row
constexpr int kMaxL = 400;       // longest sequence block the shared memory holds
constexpr float kNeg = -1e30f;

__host__ __device__ __forceinline__ int pad16(int L) { return (L + 15) & ~15; }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = pred ? 16 : 0;  // 0 source bytes: 16 zero bytes land in smem
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(bytes));
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// four 8x8 b16 matrices, one row address per lane (lanes 8i..8i+7: matrix
// i); lane T gets row T/4, columns 2(T%4), 2(T%4)+1 of each, or with .trans
// rows 2(T%4), 2(T%4)+1 of column T/4
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// c += a (16x16, row-major) . b (16x8, column-major), fp32 accumulate
__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <bool F32_OUT>
__global__ void __launch_bounds__(kWarps * 32)
attention_fwd_kernel(const __nv_bfloat16* __restrict__ qkv, void* __restrict__ out,
                     int L, int D, int causal, int valid, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int Lpad = pad16(L);
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);  // QT x LD
  __nv_bfloat16* Ks = Qs + QT * LD;                            // Lpad x LD
  __nv_bfloat16* Vs = Ks + Lpad * LD;                          // Lpad x LD

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_qt = (L + QT - 1) / QT;
  const int seq = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x % n_qt) * QT;
  const int h = blockIdx.y;
  const size_t row_stride = 3 * (size_t)D;
  const __nv_bfloat16* base = qkv + (size_t)seq * L * row_stride + h * HD;

  // stage K, V and this tile's queries with cp.async, every copy in flight
  // together (16-byte rows of 8 bf16; zero rows past L)
  for (int i = tid; i < Lpad * (HD / 8); i += kWarps * 32) {
    const int r = i >> 3, c = (i & 7) * 8;
    const bool ok = r < L;
    const __nv_bfloat16* p = ok ? base + (size_t)r * row_stride + c : base;
    cp_async16(Ks + r * LD + c, p + D, ok);
    cp_async16(Vs + r * LD + c, p + 2 * D, ok);
  }
  for (int i = tid; i < QT * (HD / 8); i += kWarps * 32) {
    const int r = i >> 3, c = (i & 7) * 8;
    const bool ok = q0 + r < L;
    cp_async16(Qs + r * LD + c, ok ? base + (size_t)(q0 + r) * row_stride + c : base, ok);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  const int wr = warp * 16;  // first query row of this warp within the tile
  if (q0 + wr >= L) return;  // warp-uniform; no block barrier follows
  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + wr + g, row1 = row0 + 8;  // positions within the sequence block

  // the warp's 16 query rows as A fragments, one per 16-wide slice of HD
  uint32_t qa[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const __nv_bfloat16* q = Qs + (wr + g) * LD + kk * 16 + 2 * t;
    qa[kk][0] = lds32(q);
    qa[kk][1] = lds32(q + 8 * LD);
    qa[kk][2] = lds32(q + 8);
    qa[kk][3] = lds32(q + 8 * LD + 8);
  }

  // scaled, masked scores of keys n0..n0+7: s[0..1] row0, s[2..3] row1,
  // columns n0+2t and n0+2t+1; keys past L are excluded (-inf)
  auto scores = [&](int n0, float s[4]) {
    s[0] = s[1] = s[2] = s[3] = 0.f;
#pragma unroll
    for (int q = 0; q < HD / 32; ++q) {
      // keys n0..n0+7 at dims 32q + 8*(matrix): b0, b1 of two 16-dim slices
      uint32_t kb[4];
      ldsm_x4(kb, Ks + (n0 + (lane & 7)) * LD + q * 32 + (lane >> 3) * 8);
      mma16816(s, qa[2 * q], kb[0], kb[1]);
      mma16816(s, qa[2 * q + 1], kb[2], kb[3]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = e < 2 ? row0 : row1;
      const int col = n0 + 2 * t + (e & 1);
      float v = s[e] * scale;
      if (col >= L) {
        v = -INFINITY;
      } else if ((causal && col > row) || col >= valid) {
        v += kNeg;
      }
      s[e] = v;
    }
  };

  // pass 1: row max and sum of exp(s - max), rescaled as the max grows
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  for (int n0 = 0; n0 < Lpad; n0 += 8) {
    float s[4];
    scores(n0, s);
    const float n_m0 = fmaxf(m0, quad_max(fmaxf(s[0], s[1])));
    const float n_m1 = fmaxf(m1, quad_max(fmaxf(s[2], s[3])));
    l0 = l0 * __expf(m0 - n_m0) + __expf(s[0] - n_m0) + __expf(s[1] - n_m0);
    l1 = l1 * __expf(m1 - n_m1) + __expf(s[2] - n_m1) + __expf(s[3] - n_m1);
    m0 = n_m0;
    m1 = n_m1;
  }
  const float inv0 = 1.f / quad_sum(l0), inv1 = 1.f / quad_sum(l1);

  // pass 2: p = bf16(exp(s - max) / sum), then O += P . V over 16-key chunks.
  // exp is the hardware approximation (a few fp32 ulps) and / sum a multiply
  // by its reciprocal (one ulp): both far below p's bf16 rounding
  float o[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  for (int k0 = 0; k0 < Lpad; k0 += 16) {
    float sa[4], sb[4];
    scores(k0, sa);
    scores(k0 + 8, sb);
    uint32_t pa[4];
    pa[0] = pack_bf16(__expf(sa[0] - m0) * inv0, __expf(sa[1] - m0) * inv0);
    pa[1] = pack_bf16(__expf(sa[2] - m1) * inv1, __expf(sa[3] - m1) * inv1);
    pa[2] = pack_bf16(__expf(sb[0] - m0) * inv0, __expf(sb[1] - m0) * inv0);
    pa[3] = pack_bf16(__expf(sb[2] - m1) * inv1, __expf(sb[3] - m1) * inv1);
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) {
      // keys k0 + (lane&7) + 8*((lane>>3)&1), dims 16j + 8*(lane>>4), read
      // transposed: b0, b1 of the dim tiles 16j and 16j+8
      uint32_t vb[4];
      ldsm_x4_trans(vb, Vs + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + j * 16 +
                            (lane >> 4) * 8);
      mma16816(o[2 * j], pa, vb[0], vb[1]);
      mma16816(o[2 * j + 1], pa, vb[2], vb[3]);
    }
  }

  // o[j][0..1]: row0, dims 8j+2t, 8j+2t+1; o[j][2..3]: row1
  const size_t off0 = ((size_t)seq * L + row0) * D + h * HD + 2 * t, off1 = off0 + 8 * (size_t)D;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    if (F32_OUT) {
      float* dst = static_cast<float*>(out);
      if (row0 < L) *reinterpret_cast<float2*>(dst + off0 + j * 8) = make_float2(o[j][0], o[j][1]);
      if (row1 < L) *reinterpret_cast<float2*>(dst + off1 + j * 8) = make_float2(o[j][2], o[j][3]);
    } else {
      __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(out);
      if (row0 < L) *reinterpret_cast<uint32_t*>(dst + off0 + j * 8) = pack_bf16(o[j][0], o[j][1]);
      if (row1 < L) *reinterpret_cast<uint32_t*>(dst + off1 + j * 8) = pack_bf16(o[j][2], o[j][3]);
    }
  }
}

int smem_bytes(int L) {
  return (QT * LD + 2 * pad16(L) * LD) * (int)sizeof(__nv_bfloat16);
}

template <bool F32_OUT>
int launch(const void* qkv, void* out, int n_seq, int L, int D, int n_head, int causal,
           int valid, float scale, cudaStream_t stream) {
  const int smem = smem_bytes(L);
  cudaError_t err = cudaFuncSetAttribute(attention_fwd_kernel<F32_OUT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_qt = (L + QT - 1) / QT;
  const dim3 grid(n_seq * n_qt, n_head);
  attention_fwd_kernel<F32_OUT><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), out, L, D, causal, valid, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// out: (n_seq * L, D) bf16, or fp32 when out_f32 is 1.
extern "C" int attention_fwd(const void* qkv, void* out, int n_seq, int L, int D, int n_head,
                             int causal, int valid, float scale, int out_f32, void* stream) {
  if (L < 1 || L > kMaxL || D != n_head * HD) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return out_f32 ? launch<true>(qkv, out, n_seq, L, D, n_head, causal, valid, scale, s)
                 : launch<false>(qkv, out, n_seq, L, D, n_head, causal, valid, scale, s);
}
