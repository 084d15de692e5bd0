// attention_bwd: dq, dk, dv of multi-head softmax attention from the saved
// packed qkv and the bf16 gradient of the attention output, per (sequence
// block, head), head dim 64, written into a packed dqkv.
//
// Replaces: the attention backward of the TPU layer kernel
//   _layer_bwd_kernel (mudpt_tpu/ops/fused_block.py:868): _mha_grads_into
//   (:242-264) with _head_grads (:267-294) and _head_probs (:197-205), the
//   masks of _causal_mask / _attn_block_spec (:168-219).  Same numerics:
//   p is the fp32 softmax of fp32 q.k^T * hd^-0.5 (+ -1e30 where masked),
//   recomputed from the saved bf16 q and k; dp = do.v^T and
//   dv = bf16(p)^T.do accumulate in fp32; ds = p * (dp - rowsum(dp * p))
//   * hd^-0.5 in fp32; dq = bf16(ds).k and dk = bf16(ds)^T.q in fp32; all
//   three are stored as bf16.  The attention half's backwards,
//   _attn_bwd_save_kernel (:369) and _attn_bwd_kernel (:358), run the same
//   _mha_grads_into through _attn_bwd_core (:336).
// Mask specs: none; causal; packed (period, valid), where the wrapper passes
//   L = period and every `period` consecutive tokens form an independent
//   causal sequence whose keys at position >= valid are masked.
// Bound on the H100: at the ViT-B/16 vision shape (L = 199) a (image, head)
//   does five useful products of 2*L*L*64 operations (25 M) on 7*L*64*2 =
//   178 KB of q, k, v, do and dqkv, ~140 operations per byte (~180 at
//   ViT-L/14's L = 259): below the ~295 where bf16 tensor cores bind, so
//   device-memory bytes bound it.
// Design: one block per (sequence block, head) holds q, k, v and do of the
//   whole block in shared memory (staged by cp.async, zero rows past L; at
//   most 384 rows, 221 KB).  Rows go in 16-row tiles, tile i to warp
//   i mod W.  The SM's registers are split over its four sub-partitions,
//   16,384 each, so W sets the cap: up to 208 rows (13 tiles) W = 13, one
//   tile a warp (the tile loop compiled to one pass), four warps on a
//   sub-partition, 128 registers a thread, where the kernel spills a few
//   dozen bytes; longer blocks W = 12, three warps a sub-partition, 168
//   registers and no spill, some warps walking two tiles.  dk and dv of a
//   key tile are summed over all queries in order inside one warp's
//   registers: no atomics, the result is the same from run to run, and it
//   does not depend on which warp takes the tile.  mma.sync m16n8k16 bf16
//   tiles fed by ldmatrix, as in attention_fwd.  The flash-attention shortcut
//   rowsum(dp * p) = rowsum(do * o) needs the attention output, which the
//   layer does not save, so three phases:
//     A (query rows): s = q.k^T and dp = do.v^T over all keys, giving each
//       row's max m, sum l and sum of exp(s - m) * dp, rescaled online as
//       m grows; rowsum(dp * p) is the latter over l.  Stats to shared
//       memory.
//     B (query rows): s and dp again, p = exp(s - m) / l, ds in fp32,
//       rounded to bf16 into the A fragments of dq += ds.k.
//     C (key rows): s^T = k.q^T and dp^T = v.do^T, p^T and ds^T from the
//       row stats, dv += bf16(p^T).do and dk += bf16(ds^T).q.
//   Nine products for the five useful ones, and no score leaves the
//   registers.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int HD = 64;               // head dim
constexpr int LD = HD + 8;           // bf16 elements per staged row
constexpr int kMaxL = 384;           // longest sequence block: 4 * 384 staged rows fit
constexpr int kOneTileWarps = 13;    // up to 13 tiles (208 rows): one warp a tile
constexpr int kWalkWarps = 12;       // longer blocks: 12 warps walk the tiles
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

// A fragments of rows r0 .. r0+15 of a staged (rows x 64) matrix, one per
// 16-wide slice of the head dim
__device__ __forceinline__ void load_a(uint32_t a[HD / 16][4], const __nv_bfloat16* S, int r0,
                                       int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const __nv_bfloat16* p = S + (r0 + g) * LD + kk * 16 + 2 * t;
    a[kk][0] = lds32(p);
    a[kk][1] = lds32(p + 8 * LD);
    a[kk][2] = lds32(p + 8);
    a[kk][3] = lds32(p + 8 * LD + 8);
  }
}

// s (16 x 8) = A (16 x 64) . B[n0 .. n0+7]^T, B a staged (rows x 64) matrix:
// s[0..1] row g, columns n0+2t, n0+2t+1; s[2..3] row g+8
__device__ __forceinline__ void product_nt(float s[4], const uint32_t a[HD / 16][4],
                                           const __nv_bfloat16* B, int n0, int lane) {
  s[0] = s[1] = s[2] = s[3] = 0.f;
#pragma unroll
  for (int q = 0; q < HD / 32; ++q) {
    // rows n0..n0+7 at dims 32q + 8*(matrix): b0, b1 of two 16-dim slices
    uint32_t b[4];
    ldsm_x4(b, B + (n0 + (lane & 7)) * LD + q * 32 + (lane >> 3) * 8);
    mma16816(s, a[2 * q], b[0], b[1]);
    mma16816(s, a[2 * q + 1], b[2], b[3]);
  }
}

// acc (16 x 64) += P (16 x 16, as A fragments) . B[k0 .. k0+15] (16 x 64),
// B a staged (rows x 64) matrix read transposed by ldmatrix.trans
__device__ __forceinline__ void accum_nn(float acc[HD / 8][4], const uint32_t p[4],
                                         const __nv_bfloat16* B, int k0, int lane) {
#pragma unroll
  for (int j = 0; j < HD / 16; ++j) {
    uint32_t b[4];
    ldsm_x4_trans(b, B + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + j * 16 +
                         (lane >> 4) * 8);
    mma16816(acc[2 * j], p, b[0], b[1]);
    mma16816(acc[2 * j + 1], p, b[2], b[3]);
  }
}

// acc[j][0..1]: row r0+g, dims 8j+2t, +1; acc[j][2..3]: row r0+g+8
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, size_t row_stride, int r0, int L,
                                           const float acc[HD / 8][4], int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int row0 = r0 + g, row1 = row0 + 8;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    if (row0 < L)
      *reinterpret_cast<uint32_t*>(dst + row0 * row_stride + j * 8 + 2 * t) =
          pack_bf16(acc[j][0], acc[j][1]);
    if (row1 < L)
      *reinterpret_cast<uint32_t*>(dst + row1 * row_stride + j * 8 + 2 * t) =
          pack_bf16(acc[j][2], acc[j][3]);
  }
}

template <int WARPS>
__global__ void __launch_bounds__(WARPS * 32, 1)
attention_bwd_kernel(const __nv_bfloat16* __restrict__ qkv, const __nv_bfloat16* __restrict__ dout,
                     __nv_bfloat16* __restrict__ dqkv, int L, int D, int causal, int valid,
                     float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int Lpad = pad16(L);
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);  // Lpad x LD each
  __nv_bfloat16* Ks = Qs + Lpad * LD;
  __nv_bfloat16* Vs = Ks + Lpad * LD;
  __nv_bfloat16* Os = Vs + Lpad * LD;  // do
  float* st_m = reinterpret_cast<float*>(Os + Lpad * LD);  // row max
  float* st_inv = st_m + Lpad;                              // 1 / row sum
  float* st_d = st_inv + Lpad;                              // rowsum(dp * p)

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_warps = blockDim.x >> 5, n_tiles = Lpad >> 4;
  const int seq = blockIdx.x, h = blockIdx.y;
  const size_t qkv_stride = 3 * (size_t)D;
  const __nv_bfloat16* base = qkv + (size_t)seq * L * qkv_stride + h * HD;
  const __nv_bfloat16* obase = dout + (size_t)seq * L * D + h * HD;

  // stage q, k, v and do with cp.async, every copy in flight together
  for (int i = tid; i < Lpad * (HD / 8); i += blockDim.x) {
    const int r = i >> 3, c = (i & 7) * 8;
    const bool ok = r < L;
    const __nv_bfloat16* p = ok ? base + (size_t)r * qkv_stride + c : base;
    cp_async16(Qs + r * LD + c, p, ok);
    cp_async16(Ks + r * LD + c, p + D, ok);
    cp_async16(Vs + r * LD + c, p + 2 * D, ok);
    cp_async16(Os + r * LD + c, ok ? obase + (size_t)r * D + c : obase, ok);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  const int g = lane >> 2, t = lane & 3;

  // scaled, masked score of query `row`, key `col`: keys past L excluded
  auto masked = [&](float v, int row, int col) {
    v *= scale;
    if (col >= L) return -INFINITY;
    if ((causal && col > row) || col >= valid) v += kNeg;
    return v;
  };

  // phases A and B over this warp's query tiles
  for (int tile = warp; tile < n_tiles; tile += n_warps) {
    const int r0 = tile * 16;
    uint32_t qa[HD / 16][4], oa[HD / 16][4];
    load_a(qa, Qs, r0, lane);
    load_a(oa, Os, r0, lane);
    const int row[2] = {r0 + g, r0 + g + 8};

    // phase A: per row, max m, sum l of exp(s - m) and sum of exp(s - m)*dp,
    // the sums rescaled as m grows; the quad shares each row's m
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, tp[2] = {0.f, 0.f};
    for (int n0 = 0; n0 < Lpad; n0 += 8) {
      float s[4], dp[4];
      product_nt(s, qa, Ks, n0, lane);
      product_nt(dp, oa, Vs, n0, lane);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float s0 = masked(s[2 * r], row[r], n0 + 2 * t);
        const float s1 = masked(s[2 * r + 1], row[r], n0 + 2 * t + 1);
        const float nm = fmaxf(m[r], quad_max(fmaxf(s0, s1)));
        const float alpha = __expf(m[r] - nm), e0 = __expf(s0 - nm), e1 = __expf(s1 - nm);
        l[r] = l[r] * alpha + e0 + e1;
        tp[r] = tp[r] * alpha + e0 * dp[2 * r] + e1 * dp[2 * r + 1];
        m[r] = nm;
      }
    }
    float inv[2], dsum[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      inv[r] = 1.f / quad_sum(l[r]);
      dsum[r] = quad_sum(tp[r]) * inv[r];
      if (t == 0) {
        st_m[row[r]] = m[r];
        st_inv[row[r]] = inv[r];
        st_d[row[r]] = dsum[r];
      }
    }

    // phase B: ds = p * (dp - rowsum(dp * p)) * scale, p = exp(s - m) / l,
    // rounded to bf16 into A fragments; dq += ds . k over 16-key chunks.
    // exp is the hardware approximation and / l a multiply by 1/l: a few
    // fp32 ulps, as in attention_fwd
    float dq[HD / 8][4];
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;
    for (int k0 = 0; k0 < Lpad; k0 += 16) {
      float ds[2][4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int n0 = k0 + 8 * half;
        float s[4], dp[4];
        product_nt(s, qa, Ks, n0, lane);
        product_nt(dp, oa, Vs, n0, lane);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const float p = __expf(masked(s[e], row[r], n0 + 2 * t + (e & 1)) - m[r]) * inv[r];
          ds[half][e] = p * (dp[e] - dsum[r]) * scale;
        }
      }
      const uint32_t da[4] = {pack_bf16(ds[0][0], ds[0][1]), pack_bf16(ds[0][2], ds[0][3]),
                              pack_bf16(ds[1][0], ds[1][1]), pack_bf16(ds[1][2], ds[1][3])};
      accum_nn(dq, da, Ks, k0, lane);
    }
    store_rows(dqkv + (size_t)seq * L * qkv_stride + h * HD, qkv_stride, r0, L, dq, lane);
    if (WARPS == kOneTileWarps) break;  // launched one warp a tile: no second pass
  }
  __syncthreads();  // every row's stats are in shared memory

  // phase C over this warp's key tiles: for 16-query chunks, s^T and dp^T,
  // then p^T and ds^T from the query rows' stats; dv += bf16(p^T) . do and
  // dk += bf16(ds^T) . q, summed over all queries in registers
  for (int tile = warp; tile < n_tiles; tile += n_warps) {
    const int r0 = tile * 16;
    uint32_t ka[HD / 16][4], va[HD / 16][4];
    load_a(ka, Ks, r0, lane);
    load_a(va, Vs, r0, lane);
    const int key[2] = {r0 + g, r0 + g + 8};
    float dk[HD / 8][4], dv[HD / 8][4];
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      dk[j][0] = dk[j][1] = dk[j][2] = dk[j][3] = 0.f;
      dv[j][0] = dv[j][1] = dv[j][2] = dv[j][3] = 0.f;
    }
    for (int q0 = 0; q0 < Lpad; q0 += 16) {
      float pt[2][4], dst[2][4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int n0 = q0 + 8 * half;
        float s[4], dp[4];
        product_nt(s, ka, Qs, n0, lane);
        product_nt(dp, va, Os, n0, lane);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = n0 + 2 * t + (e & 1);  // the query: a column here
          float p = 0.f, ds = 0.f;
          if (qi < L) {
            p = __expf(masked(s[e], qi, key[e >> 1]) - st_m[qi]) * st_inv[qi];
            ds = p * (dp[e] - st_d[qi]) * scale;
          }
          pt[half][e] = p;
          dst[half][e] = ds;
        }
      }
      const uint32_t pa[4] = {pack_bf16(pt[0][0], pt[0][1]), pack_bf16(pt[0][2], pt[0][3]),
                              pack_bf16(pt[1][0], pt[1][1]), pack_bf16(pt[1][2], pt[1][3])};
      const uint32_t da[4] = {pack_bf16(dst[0][0], dst[0][1]), pack_bf16(dst[0][2], dst[0][3]),
                              pack_bf16(dst[1][0], dst[1][1]), pack_bf16(dst[1][2], dst[1][3])};
      accum_nn(dv, pa, Os, q0, lane);
      accum_nn(dk, da, Qs, q0, lane);
    }
    __nv_bfloat16* out = dqkv + (size_t)seq * L * qkv_stride + h * HD;
    store_rows(out + D, qkv_stride, r0, L, dk, lane);
    store_rows(out + 2 * D, qkv_stride, r0, L, dv, lane);
    if (WARPS == kOneTileWarps) break;
  }
}

int smem_bytes(int L) {
  return 4 * pad16(L) * LD * (int)sizeof(__nv_bfloat16) + 3 * pad16(L) * (int)sizeof(float);
}

template <int WARPS>
int launch(const void* qkv, const void* dout, void* dqkv, int n_seq, int L, int D, int n_head,
           int causal, int valid, float scale, int warps, cudaStream_t stream) {
  const int smem = smem_bytes(L);
  cudaError_t err = cudaFuncSetAttribute(attention_bwd_kernel<WARPS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  attention_bwd_kernel<WARPS><<<dim3(n_seq, n_head), warps * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<const __nv_bfloat16*>(dout),
      static_cast<__nv_bfloat16*>(dqkv), L, D, causal, valid, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// qkv, dqkv: (n_seq * L, 3D) bf16; dout: (n_seq * L, D) bf16.
extern "C" int attention_bwd(const void* qkv, const void* dout, void* dqkv, int n_seq, int L,
                             int D, int n_head, int causal, int valid, float scale,
                             void* stream) {
  if (L < 1 || L > kMaxL || D != n_head * HD) return (int)cudaErrorInvalidValue;
  const int tiles = pad16(L) / 16;
  const cudaStream_t s = (cudaStream_t)stream;
  if (tiles <= kOneTileWarps)
    return launch<kOneTileWarps>(qkv, dout, dqkv, n_seq, L, D, n_head, causal, valid, scale,
                                 tiles, s);
  return launch<kWalkWarps>(qkv, dout, dqkv, n_seq, L, D, n_head, causal, valid, scale,
                            kWalkWarps, s);
}
