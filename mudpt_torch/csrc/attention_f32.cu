// attention_f32: multi-head softmax attention on fp32 activations, forward
// (attention_fwd_f32) and dq, dk, dv (attention_bwd_f32), per (sequence
// block, head), head dim 64, from a packed qkv; any block length.
//
// Replaces: the attention of the TPU layer kernels on fp32 activations
//   (mudpt_tpu/ops/fused_block.py): forward, _mha_acc (:222-240) with
//   _head_probs (:197-205) and the masks of _causal_mask / _attn_block_spec
//   (:168-219), inside _layer_fwd_nosave_kernel (:851), _layer_fwd_kernel
//   (:831), _attn_fwd_kernel (:318), _attn_fwd_save_kernel (:326) and the
//   recompute backward _attn_bwd_kernel (:358); backward, _mha_grads_into
//   (:242-264) with _head_grads (:267-298), inside _layer_bwd_kernel (:868),
//   _attn_bwd_save_kernel (:369) and _attn_bwd_kernel (:358).  The Pallas
//   code casts p and ds to x.dtype (act_dtype=x.dtype): with x fp32 those
//   casts are no-ops, so here
//     s  = q.k^T * hd^-0.5 + mask (-1e30), p = softmax(s) over the whole
//          key range, o = p.v                                 (forward)
//     dv = p^T.do, dp = do.v^T, ds = p * (dp - rowsum(dp * p)) * hd^-0.5,
//     dq = ds.k, dk = ds^T.q                                  (backward)
//   every product with fp32 operands and fp32 sums.  Keys that the mask
//   covers get p exactly 0, as the -1e30 of the Pallas mask gives them.
// Mask specs: none; causal; packed (period, valid), where the wrapper passes
//   L = period and every `period` consecutive tokens form an independent
//   causal sequence whose keys at position >= valid are masked.
// Bound on the H100: operations.  At the ViT-B/16 vision block (199 rows,
//   12 heads) the forward's two useful products, 4 * L^2 * 64 operations a
//   (block, head), meet 4 * L * 64 * 4 bytes of q, k, v and o: ~200
//   operations a byte, and no tensor-core product is fp32-accurate (see
//   gemm_f32_epilogue.cu), so the FMA pipes bind.
// Design: SIMT fp32 FMAs on 64 x 64 tiles in shared memory (rows padded to
//   68 floats so that 16-byte reads of eight rows hit distinct banks), 256
//   threads a block, each owning 4 x 4 elements of a tile product: rows
//   ty + 16a and columns tx + 16b for a product over the head dim (s, dp),
//   columns tx*4 + c for one over keys or queries (o, dq, dk, dv).  K and V
//   tiles are streamed, so any block length fits (579 rows at 336 px).
//     forward (attn_fwd_f32_kernel), one block a (sequence block, head,
//       64-row query tile): pass 1 over the key tiles gives each row's max
//       m and sum l of exp(s - m), rescaled as m grows; pass 2 recomputes s
//       and accumulates o += p.v with p = exp(s - m) / l.
//     backward, two kernels, as attention_bwd.cu's bf16 ones:
//       query-major (attn_bwd_query_f32_kernel): pass 1 over the key tiles,
//         s and dp, giving m, l and rowsum(dp * p) (summed as
//         sum exp(s - m) * dp, rescaled with l, divided by l at the end),
//         written to a small fp32 scratch, 16 bytes a row; pass 2
//         recomputes s and dp, forms ds and accumulates dq += ds.k.
//       key-major (attn_bwd_key_f32_kernel), one block a 64-row key tile:
//         its K and V stay in shared memory while the query tiles stream
//         past; s and dp recomputed, p and ds from the scratch's
//         statistics, dv += p^T.do and dk += ds^T.q.
//   Tiles that the mask covers whole are skipped (causal keys past the
//   query tile, keys at or past `valid`).  No atomics and a fixed order of
//   sums: a result repeats exactly from launch to launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int HD = 64;          // head dim
constexpr int T = 64;           // tile rows
constexpr int LDT = 68;         // a tile row in shared memory, padded
constexpr int TILE = T * LDT;   // floats a tile
constexpr int THREADS = 256;
constexpr float kNeg = -1e30f;  // the Pallas kernels' additive mask value

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// rows [r0, r0 + 64) of a matrix whose rows lie `ld` floats apart (the
// head's 64 columns at g), rows at or past n as zeros
__device__ __forceinline__ void load_tile(float* s, const float* g, int r0, int n, int ld) {
#pragma unroll
  for (int i = 0; i < T * HD / 4 / THREADS; ++i) {
    const int idx = threadIdx.x + i * THREADS;
    const int r = idx >> 4, c = (idx & 15) * 4;
    const float4 v = r0 + r < n ? ld4(g + (size_t)(r0 + r) * ld + c) : make_float4(0, 0, 0, 0);
    *reinterpret_cast<float4*>(s + r * LDT + c) = v;
  }
}

// o[a][b] = sum_d X[ty + 16a][d] * Y[tx + 16b][d]
__device__ __forceinline__ void prod_nt(const float* X, const float* Y, float (&o)[4][4]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) o[a][b] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    float4 x[4], y[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) x[a] = ld4(X + (ty + 16 * a) * LDT + d);
#pragma unroll
    for (int b = 0; b < 4; ++b) y[b] = ld4(Y + (tx + 16 * b) * LDT + d);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        float v = o[a][b];
        v = fmaf(x[a].x, y[b].x, v);
        v = fmaf(x[a].y, y[b].y, v);
        v = fmaf(x[a].z, y[b].z, v);
        o[a][b] = fmaf(x[a].w, y[b].w, v);
      }
  }
}

// o[a][c] += sum_j P[ty + 16a][j] * V[j][tx*4 + c]
__device__ __forceinline__ void prod_nn(const float* P, const float* V, float (&o)[4][4]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll 4
  for (int j = 0; j < T; j += 4) {
    float p[4][4], v[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float4 q = ld4(P + (ty + 16 * a) * LDT + j);
      p[a][0] = q.x; p[a][1] = q.y; p[a][2] = q.z; p[a][3] = q.w;
    }
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float4 q = ld4(V + (j + t) * LDT + tx * 4);
      v[t][0] = q.x; v[t][1] = q.y; v[t][2] = q.z; v[t][3] = q.w;
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int c = 0; c < 4; ++c) o[a][c] = fmaf(p[a][t], v[t][c], o[a][c]);
  }
}

// o[a][c] += sum_i P[i][ty*4 + a] * G[i][tx*4 + c]
__device__ __forceinline__ void prod_tn(const float* P, const float* G, float (&o)[4][4]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll 8
  for (int i = 0; i < T; ++i) {
    const float4 p4 = ld4(P + i * LDT + ty * 4);
    const float4 g4 = ld4(G + i * LDT + tx * 4);
    const float p[4] = {p4.x, p4.y, p4.z, p4.w};
    const float g[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) o[a][c] = fmaf(p[a], g[c], o[a][c]);
  }
}

// over the 16 lanes that share ty (one half of a warp)
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct Mask {
  int L, causal, valid;
  float scale;
  // the score of query row i and key column j (both in the block) from
  // q.k: -inf past the block (no key there), -1e30 added where masked
  __device__ __forceinline__ float score(float qk, int i, int j) const {
    if (j >= L) return -INFINITY;
    const float s = qk * scale;
    return (j >= valid || (causal && j > i)) ? s + kNeg : s;
  }
  // key tiles that a query tile starting at q0 attends: keys below valid,
  // and for a causal mask up to the tile's last row
  __device__ __forceinline__ int key_tiles(int q0) const {
    int end = L < valid ? L : valid;
    if (causal && q0 + T < end) end = q0 + T;
    return (end + T - 1) / T;
  }
};

__global__ void __launch_bounds__(THREADS)
attn_fwd_f32_kernel(const float* __restrict__ qkv, float* __restrict__ out, int n_head, int D,
                    Mask mk, int n_qt) {
  extern __shared__ __align__(16) float sm[];
  float* Qs = sm;
  float* Ks = Qs + TILE;
  float* Vs = Ks + TILE;
  float* Ps = Vs + TILE;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int qt = blockIdx.x % n_qt, h = (blockIdx.x / n_qt) % n_head;
  const int seq = blockIdx.x / n_qt / n_head;
  const int L = mk.L, q0 = qt * T, ld = 3 * D;
  const float* base = qkv + (size_t)seq * L * ld + h * HD;
  load_tile(Qs, base, q0, L, ld);
  const int n_kt = mk.key_tiles(q0);

  // pass 1: each row's max and sum of exp(s - max)
  float m[4], l[4], s[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a) m[a] = -INFINITY, l[a] = 0.f;
  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();
    load_tile(Ks, base + D, kt * T, L, ld);
    __syncthreads();
    prod_nt(Qs, Ks, s);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = q0 + ty + 16 * a;
      float tmax = -INFINITY;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        s[a][b] = mk.score(s[a][b], i, kt * T + tx + 16 * b);
        tmax = fmaxf(tmax, s[a][b]);
      }
      const float m_new = fmaxf(m[a], row_max(tmax));
      float e = 0.f;
#pragma unroll
      for (int b = 0; b < 4; ++b) e += expf(s[a][b] - m_new);
      l[a] = l[a] * expf(m[a] - m_new) + row_sum(e);
      m[a] = m_new;
    }
  }

  // pass 2: o = sum over the key tiles of p.v, p = exp(s - m) / l
  float o[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[a][c] = 0.f;
  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();
    load_tile(Ks, base + D, kt * T, L, ld);
    load_tile(Vs, base + 2 * D, kt * T, L, ld);
    __syncthreads();
    prod_nt(Qs, Ks, s);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = q0 + ty + 16 * a;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const float sc = mk.score(s[a][b], i, kt * T + tx + 16 * b);
        Ps[(ty + 16 * a) * LDT + tx + 16 * b] = expf(sc - m[a]) / l[a];
      }
    }
    __syncthreads();
    prod_nn(Ps, Vs, o);
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = q0 + ty + 16 * a;
    if (i < L) st4(out + ((size_t)seq * L + i) * D + h * HD + tx * 4, o[a]);
  }
}

__global__ void __launch_bounds__(THREADS)
attn_bwd_query_f32_kernel(const float* __restrict__ qkv, const float* __restrict__ dout,
                          float* __restrict__ dqkv, float* __restrict__ stats, int n_head, int D,
                          Mask mk, int n_qt) {
  extern __shared__ __align__(16) float sm[];
  float* Qs = sm;
  float* Gs = Qs + TILE;  // do
  float* Ks = Gs + TILE;
  float* Vs = Ks + TILE;
  float* Ss = Vs + TILE;  // ds
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int qt = blockIdx.x % n_qt, h = (blockIdx.x / n_qt) % n_head;
  const int seq = blockIdx.x / n_qt / n_head;
  const int L = mk.L, q0 = qt * T, ld = 3 * D;
  const float* base = qkv + (size_t)seq * L * ld + h * HD;
  load_tile(Qs, base, q0, L, ld);
  load_tile(Gs, dout + (size_t)seq * L * D + h * HD, q0, L, D);
  const int n_kt = mk.key_tiles(q0);

  // pass 1: m, l and rowsum(dp * p) = (sum exp(s - m) * dp) / l
  float m[4], l[4], dd[4], s[4][4], dp[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a) m[a] = -INFINITY, l[a] = 0.f, dd[a] = 0.f;
  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();
    load_tile(Ks, base + D, kt * T, L, ld);
    load_tile(Vs, base + 2 * D, kt * T, L, ld);
    __syncthreads();
    prod_nt(Qs, Ks, s);
    prod_nt(Gs, Vs, dp);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = q0 + ty + 16 * a;
      float tmax = -INFINITY;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        s[a][b] = mk.score(s[a][b], i, kt * T + tx + 16 * b);
        tmax = fmaxf(tmax, s[a][b]);
      }
      const float m_new = fmaxf(m[a], row_max(tmax));
      float e = 0.f, ed = 0.f;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const float p = expf(s[a][b] - m_new);
        e += p;
        ed += p * dp[a][b];
      }
      const float alpha = expf(m[a] - m_new);
      l[a] = l[a] * alpha + row_sum(e);
      dd[a] = dd[a] * alpha + row_sum(ed);
      m[a] = m_new;
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    dd[a] /= l[a];
    const int i = q0 + ty + 16 * a;
    if (tx == 0 && i < L) {
      const float st[4] = {m[a], l[a], dd[a], 0.f};
      st4(stats + (((size_t)seq * n_head + h) * L + i) * 4, st);
    }
  }

  // pass 2: dq = sum over the key tiles of ds.k
  float dq[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) dq[a][c] = 0.f;
  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();
    load_tile(Ks, base + D, kt * T, L, ld);
    load_tile(Vs, base + 2 * D, kt * T, L, ld);
    __syncthreads();
    prod_nt(Qs, Ks, s);
    prod_nt(Gs, Vs, dp);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = q0 + ty + 16 * a;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const float p = expf(mk.score(s[a][b], i, kt * T + tx + 16 * b) - m[a]) / l[a];
        Ss[(ty + 16 * a) * LDT + tx + 16 * b] = p * (dp[a][b] - dd[a]) * mk.scale;
      }
    }
    __syncthreads();
    prod_nn(Ss, Ks, dq);
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = q0 + ty + 16 * a;
    if (i < L) st4(dqkv + ((size_t)seq * L + i) * ld + h * HD + tx * 4, dq[a]);
  }
}

__global__ void __launch_bounds__(THREADS)
attn_bwd_key_f32_kernel(const float* __restrict__ qkv, const float* __restrict__ dout,
                        const float* __restrict__ stats, float* __restrict__ dqkv, int n_head,
                        int D, Mask mk, int n_kt) {
  extern __shared__ __align__(16) float sm[];
  float* Ks = sm;
  float* Vs = Ks + TILE;
  float* Qs = Vs + TILE;
  float* Gs = Qs + TILE;  // do
  float* Ps = Gs + TILE;
  float* Ss = Ps + TILE;  // ds
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int kt = blockIdx.x % n_kt, h = (blockIdx.x / n_kt) % n_head;
  const int seq = blockIdx.x / n_kt / n_head;
  const int L = mk.L, k0 = kt * T, ld = 3 * D;
  const float* base = qkv + (size_t)seq * L * ld + h * HD;
  const float* gbase = dout + (size_t)seq * L * D + h * HD;
  const float* sbase = stats + ((size_t)seq * n_head + h) * L * 4;
  load_tile(Ks, base + D, k0, L, ld);
  load_tile(Vs, base + 2 * D, k0, L, ld);

  float dk[4][4], dv[4][4], s[4][4], dp[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) dk[a][c] = 0.f, dv[a][c] = 0.f;
  // keys at or past valid are masked for every row: dk = dv = 0; a causal
  // key tile is attended by the query rows from its own first row on
  const int n_qt = (L + T - 1) / T;
  const int qt0 = k0 >= mk.valid ? n_qt : (mk.causal ? kt : 0);
  for (int qt = qt0; qt < n_qt; ++qt) {
    const int q0 = qt * T;
    __syncthreads();
    load_tile(Qs, base, q0, L, ld);
    load_tile(Gs, gbase, q0, L, D);
    __syncthreads();
    prod_nt(Qs, Ks, s);
    prod_nt(Gs, Vs, dp);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = q0 + ty + 16 * a;
      float4 st = make_float4(0.f, 1.f, 0.f, 0.f);
      if (i < L) st = ld4(sbase + (size_t)i * 4);
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const float p = i < L ? expf(mk.score(s[a][b], i, k0 + tx + 16 * b) - st.x) / st.y : 0.f;
        Ps[(ty + 16 * a) * LDT + tx + 16 * b] = p;
        Ss[(ty + 16 * a) * LDT + tx + 16 * b] = p * (dp[a][b] - st.z) * mk.scale;
      }
    }
    __syncthreads();
    prod_tn(Ps, Gs, dv);
    prod_tn(Ss, Qs, dk);
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int j = k0 + ty * 4 + a;
    if (j < L) {
      float* row = dqkv + ((size_t)seq * L + j) * ld + h * HD + tx * 4;
      st4(row + D, dk[a]);
      st4(row + 2 * D, dv[a]);
    }
  }
}

// opt a kernel into more than 48 KB of dynamic shared memory, once
template <typename K>
cudaError_t allow_smem(K kernel, int bytes, bool* done) {
  if (*done) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  *done = e == cudaSuccess;
  return e;
}

bool valid_args(int n_seq, int L, int D, int n_head, int valid) {
  return n_seq >= 1 && L >= 1 && valid >= 1 && n_head >= 1 && D == n_head * HD;
}

}  // namespace

// qkv: (n_seq * L, 3D) fp32, packed [q | k | v], heads of 64 columns.
// out: (n_seq * L, D) fp32.
extern "C" int attention_fwd_f32(const void* qkv, void* out, int n_seq, int L, int D,
                                 int n_head, int causal, int valid, float scale, void* stream) {
  if (!valid_args(n_seq, L, D, n_head, valid)) return (int)cudaErrorInvalidValue;
  const int n_qt = (L + T - 1) / T;
  const long long blocks = (long long)n_seq * n_head * n_qt;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  constexpr int smem = 4 * TILE * (int)sizeof(float);
  static bool ready = false;
  cudaError_t e = allow_smem(attn_fwd_f32_kernel, smem, &ready);
  if (e != cudaSuccess) return (int)e;
  const Mask mk{L, causal, valid, scale};
  attn_fwd_f32_kernel<<<(unsigned)blocks, THREADS, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(qkv), static_cast<float*>(out), n_head, D, mk, n_qt);
  return (int)cudaGetLastError();
}

// qkv, dqkv: (n_seq * L, 3D) fp32.  dout: (n_seq * L, D) fp32.  stats:
// (n_seq * n_head * L, 4) fp32 scratch, written by the query-major kernel
// and read by the key-major one.
extern "C" int attention_bwd_f32(const void* qkv, const void* dout, void* dqkv, void* stats,
                                 int n_seq, int L, int D, int n_head, int causal, int valid,
                                 float scale, void* stream) {
  if (!valid_args(n_seq, L, D, n_head, valid)) return (int)cudaErrorInvalidValue;
  const int n_t = (L + T - 1) / T;
  const long long blocks = (long long)n_seq * n_head * n_t;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  constexpr int smem_q = 5 * TILE * (int)sizeof(float);
  constexpr int smem_k = 6 * TILE * (int)sizeof(float);
  static bool ready_q = false, ready_k = false;
  cudaError_t e = allow_smem(attn_bwd_query_f32_kernel, smem_q, &ready_q);
  if (e == cudaSuccess) e = allow_smem(attn_bwd_key_f32_kernel, smem_k, &ready_k);
  if (e != cudaSuccess) return (int)e;
  const Mask mk{L, causal, valid, scale};
  const cudaStream_t s = (cudaStream_t)stream;
  const auto* q = static_cast<const float*>(qkv);
  const auto* g = static_cast<const float*>(dout);
  auto* d = static_cast<float*>(dqkv);
  auto* st = static_cast<float*>(stats);
  attn_bwd_query_f32_kernel<<<(unsigned)blocks, THREADS, smem_q, s>>>(q, g, d, st, n_head, D,
                                                                      mk, n_t);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  attn_bwd_key_f32_kernel<<<(unsigned)blocks, THREADS, smem_k, s>>>(q, g, st, d, n_head, D, mk,
                                                                    n_t);
  return (int)cudaGetLastError();
}
