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
//   (block, head), meet 4 * L * 64 * 4 bytes of q, k, v and o, the
//   backward's five useful products 10 * L^2 * 64 operations 7 * L * 64 * 4
//   bytes: ~200 operations a byte.  One TF32 product reads ~2^-11 of an
//   fp32 one, so an fp32-accurate product is three TF32 ones (3xTF32, 494.7
//   / 3 TFLOP/s on the tensor cores) or FMAs (67 TFLOP/s).
// Both directions run on Hopper's warpgroup MMA in TF32, every product
//   3xTF32: x = hi + lo exactly, hi = cvt.rna.tf32(x), lo = cvt.rna.tf32(x
//   - hi), lo.hi + hi.lo + hi.hi into one fp32 accumulator, lo.lo (below
//   2^-20 of a product) dropped.  The softmax, its statistics and ds stay in
//   fp32 on the CUDA cores, exp as exp2 with log2(e) folded into the score
//   and / sum a multiply by its reciprocal (a few fp32 ulps on p).
//     forward (attn_fwd_tc_kernel<NWG>): NWG warpgroups a block (one for
//       a block of one tile, the text tower's), each owning a 64-row query
//       tile, its Q split into shared memory once; 32-row key steps stream
//       past, shared by all, K split K-major and V transposed.  One pass:
//       S = Q.K^T (wgmma m64n32k8, both operands from shared memory), each
//       row's running max and sum of exp2(u - max), the output accumulator
//       rescaled as the max grows, O += P.V with P as register A fragments
//       (m64n64k8); O times 1 / sum once at the end.
//     query-major backward (attn_bwd_query_tc_kernel<NWG>): two warpgroups
//       a block (one for a block of one tile), each owning a
//       64-row query tile, its Q and dO split into shared memory once;
//       32-row key steps stream past, shared by both.  Pass 1: S =
//       Q.K^T and dP = dO.V^T (wgmma m64n32k8, both operands from shared
//       memory), each row's max, sum of exp2(u - max) and of exp2(u - max)
//       * dp, rescaled as the max grows; (max, 1 / sum, rowsum(dp * p)) go
//       to a small fp32 scratch, 16 bytes a row.  Pass 2: S and dP again,
//       ds = p * (dp - rowsum(dp * p)) * hd^-0.5 in the accumulator
//       registers, then dQ += dS.K with dS as register A fragments
//       (m64n64k8).
//     key-major backward (attn_bwd_key_tc_kernel): two warpgroups a block,
//       each owning a 64-row key tile, its K and V split into shared memory;
//       32-row query steps stream past, shared by both: S^T = K.Q^T and
//       dP^T = V.dO^T, p^T and ds^T from the scratch's statistics, then dV
//       += P^T.dO and dK += dS^T.Q with P^T and dS^T as register A
//       fragments.
//   TF32 wgmma reads its shared-memory operands K-major only (only 16-bit
//   types transpose through the descriptor).  The products over the head
//   dim (S, dP and their transposes) find all four operands hd-contiguous.
//   The products over the sequence (O, dQ, dK, dV) need V, K, Q and dO with
//   the sequence contiguous: each streamed step is prefetched into registers
//   while the previous step's products run, then split into shared memory
//   K-major, transposed or both (the 32 lanes of a warp writing one
//   transposed row: distinct banks).  Inside each 8-row chunk the
//   transposed copy puts row 2t + e at k = t + 4e, the k where the
//   accumulator fragment that becomes the A operand already holds that
//   column, so the register A fragments need no exchange between threads.
//   Steps that the mask covers whole are skipped (causal keys past a query
//   tile, keys at or past `valid`); any block length, and the text tower's
//   16-row blocks run the same kernels (an m64 tile mostly empty, yet
//   faster than the SIMT kernels these replaced).  No atomics and a fixed
//   order of sums: a result repeats exactly from launch to launch, and a
//   (block, head)'s result does not depend on the blocks beside it.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int HD = 64;          // head dim
constexpr int T = 64;           // tile rows
constexpr int SR = 32;          // rows of the streamed steps
constexpr float kNeg = -1e30f;  // the Pallas kernels' additive mask value
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
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
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// shared-memory matrix descriptor, 128-byte swizzle (atoms of 8 x 128 B)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(16 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// x = hi + lo, both TF32 (lo's own rounding is below 2^-21 of x)
__device__ __forceinline__ void split(float x, float& hi, float& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - hi);
}

__device__ __forceinline__ float4 split4(float4& v) {
  float4 lo;
  split(v.x, v.x, lo.x);
  split(v.y, v.y, lo.y);
  split(v.z, v.z, lo.z);
  split(v.w, v.w, lo.w);
  return lo;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// byte offset of element (row r, k) in a K-major 128-byte-swizzled panel
// (32 fp32 a row): chunk k / 4 of the row moved to chunk (k / 4) ^ (r % 8)
__device__ __forceinline__ int swz(int r, int k) {
  return r * 128 + ((((k >> 2) ^ r) & 7) << 4) + (k & 3) * 4;
}

// the sequence order inside each 8-row chunk of a transposed operand: row
// 2t + e of the chunk at k = t + 4e, where the accumulator fragment of a
// product over that chunk holds it (see frag below)
__device__ __forceinline__ int seq_k(int r) {
  return (r & ~7) + ((r & 7) >> 1) + 4 * (r & 1);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d (64 x 32 fp32) (+)= A (64 x 8 tf32, K-major) . B (8 x 32 tf32, K-major)
__device__ __forceinline__ void wgmma_ss32(float (&d)[16], uint64_t desc_a, uint64_t desc_b,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x 64 fp32) += A (64 x 8 tf32 in registers, fragment a) . B (8 x 64
// tf32, K-major)
__device__ __forceinline__ void wgmma_rs64(float (&d)[32], const uint32_t (&a)[4],
                                           uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d = X . Y^T in 3xTF32 over the head dim: X a 64-row tile (two panels of
// 64 rows), Y a 32-row step (two panels of 32 rows), hi and lo of each
__device__ __forceinline__ void prod_hd(float (&d)[16], uint32_t xh, uint32_t xl, uint32_t yh,
                                        uint32_t yl) {
#pragma unroll
  for (int kk = 0; kk < HD / 8; ++kk) {
    const int ox = (kk >> 2) * 8192 + (kk & 3) * 32, oy = (kk >> 2) * 4096 + (kk & 3) * 32;
    wgmma_ss32(d, smem_desc(xl + ox), smem_desc(yh + oy), kk > 0);
    wgmma_ss32(d, smem_desc(xh + ox), smem_desc(yl + oy), 1);
    wgmma_ss32(d, smem_desc(xh + ox), smem_desc(yh + oy), 1);
  }
}

// the A fragment (hi, lo) of chunk q (columns 8q .. 8q + 7) of a 64 x 32
// accumulator v: fragment register r holds row g + 8 (r & 1), k t + 4 (r >>
// 1); the accumulator holds row g + 8h, column 2t + e at v[4q + 2h + e], so
// k t + 4e is column 2t + e (seq_k), with no exchange between threads
__device__ __forceinline__ void frag(const float (&v)[16], int q, uint32_t (&hi)[4],
                                     uint32_t (&lo)[4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    float h, l;
    split(v[4 * q + 2 * (r & 1) + (r >> 1)], h, l);
    hi[r] = __float_as_uint(h);
    lo[r] = __float_as_uint(l);
  }
}

// dst += A . B over a 32-row step in 3xTF32: A the fragments of v, B a
// transposed panel (64 rows, the step's 32 rows as k in seq_k order)
__device__ __forceinline__ void prod_seq(float (&dst)[32], const float (&v)[16], uint32_t bh,
                                         uint32_t bl) {
  uint32_t ah[SR / 8][4], al[SR / 8][4];
#pragma unroll
  for (int q = 0; q < SR / 8; ++q) frag(v, q, ah[q], al[q]);
  wgmma_fence();
#pragma unroll
  for (int q = 0; q < SR / 8; ++q) {
    wgmma_rs64(dst, al[q], smem_desc(bh + q * 32));
    wgmma_rs64(dst, ah[q], smem_desc(bl + q * 32));
    wgmma_rs64(dst, ah[q], smem_desc(bh + q * 32));
  }
  wgmma_commit_wait();
}

// rows [r0, r0 + 64) of a matrix whose rows lie `ld` floats apart (a
// head's 64 columns at g), rows at or past n as zeros, split into K-major
// hi and lo tiles (two panels of 64 rows each) by one warpgroup, lanes on
// rows (16-byte stores, the eight rows of a swizzle atom on distinct banks)
__device__ __forceinline__ void load_tile_tc(unsigned char* hi, unsigned char* lo, const float* g,
                                             int r0, int n, int ld, int wtid) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int idx = wtid + 128 * i, r = idx & 63, c4 = idx >> 6;
    float4 v = r0 + r < n ? ld4(g + (size_t)(r0 + r) * ld + 4 * c4) : make_float4(0, 0, 0, 0);
    const float4 l = split4(v);
    const int off = (c4 >> 3) * 8192 + swz(r, 4 * (c4 & 7));
    *reinterpret_cast<float4*>(hi + off) = v;
    *reinterpret_cast<float4*>(lo + off) = l;
  }
}

// a streamed step of NT threads: rows [r0, r0 + 32) of two matrices X, Y
// (a head's 64 columns, rows `ld` floats apart), prefetched into registers
// (lanes on rows), then split into shared memory.  The index arithmetic
// (idx % SR, (kr >> 5) * 8192 + swz(.., kr & 31)) is kept in this form:
// idx & 31 and swz(.., kr) give the same addresses, but nvcc then builds
// other SASS, and both directions ran ~3% slower on the H100
template <int NT>
struct Step {
  static constexpr int V = SR * 16 / NT;  // 16-byte vectors of each matrix a thread
  float4 x[V], y[V];
  __device__ __forceinline__ void load(const float* gx, const float* gy, int r0, int n, int ldx,
                                       int ldy) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int idx = threadIdx.x + NT * i, r = idx % SR, c4 = idx / SR;
      const bool in = r0 + r < n;
      x[i] = in ? ld4(gx + (size_t)(r0 + r) * ldx + 4 * c4) : make_float4(0, 0, 0, 0);
      y[i] = in ? ld4(gy + (size_t)(r0 + r) * ldy + 4 * c4) : make_float4(0, 0, 0, 0);
    }
  }
  // hi and lo K-major (two panels of 32 rows) where `k`, and transposed
  // where `t` (one panel: 64 rows, the step's rows as k in seq_k order; the
  // 32 lanes of a warp write one row's 32 k: distinct banks)
  __device__ __forceinline__ static void put(float4 v, unsigned char* hi, unsigned char* lo,
                                             unsigned char* thi, unsigned char* tlo, int r,
                                             int c4, bool k, bool t) {
    const float4 l = split4(v);
    if (k) {
      const int off = (c4 >> 3) * 4096 + swz(r, 4 * (c4 & 7));
      *reinterpret_cast<float4*>(hi + off) = v;
      *reinterpret_cast<float4*>(lo + off) = l;
    }
    if (t) {
      const int kr = seq_k(r);
      const float vh[4] = {v.x, v.y, v.z, v.w}, vl[4] = {l.x, l.y, l.z, l.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int o = (kr >> 5) * 8192 + swz(4 * c4 + e, kr & 31);
        *reinterpret_cast<float*>(thi + o) = vh[e];
        *reinterpret_cast<float*>(tlo + o) = vl[e];
      }
    }
  }
  // the backward's step, sm: X hi, X lo, Y hi, Y lo (8 KB each), then X^T
  // hi, X^T lo where tx, Y^T hi, Y^T lo where ty (8 KB each)
  __device__ __forceinline__ void store(unsigned char* sm, bool tx, bool ty) const {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int idx = threadIdx.x + NT * i, r = idx % SR, c4 = idx / SR;
      put(x[i], sm, sm + 8192, sm + 4 * 8192, sm + 5 * 8192, r, c4, true, tx);
      put(y[i], sm + 2 * 8192, sm + 3 * 8192, sm + 6 * 8192, sm + 7 * 8192, r, c4, true, ty);
    }
  }
  // the forward's step, sm: X (K) hi, X lo K-major, Y (V) hi, Y lo
  // transposed (8 KB each)
  __device__ __forceinline__ void store_fwd(unsigned char* sm) const {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int idx = threadIdx.x + NT * i, r = idx % SR, c4 = idx / SR;
      put(x[i], sm, sm + 8192, nullptr, nullptr, r, c4, true, false);
      put(y[i], nullptr, nullptr, sm + 2 * 8192, sm + 3 * 8192, r, c4, false, true);
    }
  }
};

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// the forward: each of NWG warpgroups owns one 64-row query tile, its Q
// split in shared memory; 32-row key steps (K K-major, V transposed) stream
// past.  One pass: S = Q.K^T, each row's running max m and sum l of
// exp2(u - m) (u = s * log2(e)), O rescaled by exp2(m_old - m) as m grows,
// O += P.V with P = exp2(u - m) as register A fragments; O / l at the end.
// The registers are capped so that as many blocks share an SM as its shared
// memory holds: 3 of one warpgroup (65 KB), 2 of two (97 KB)
template <int NWG>
__global__ void __launch_bounds__(NWG * 128, 4 - NWG)
attn_fwd_tc_kernel(const float* __restrict__ qkv, float* __restrict__ out, int n_head, int D,
                   Mask mk, int per_head) {
  constexpr int NT = NWG * 128;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* const sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x, c = tid >> 7, wtid = tid & 127;
  const int warp = wtid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int grp = blockIdx.x % per_head, h = (blockIdx.x / per_head) % n_head;
  const int seq = blockIdx.x / per_head / n_head;
  const int L = mk.L, ld = 3 * D, q0 = (NWG * grp + c) * T;
  const bool active = q0 < L;  // warpgroup-uniform
  const float* base = qkv + (size_t)seq * L * ld + h * HD;
  // per warpgroup: Q hi, Q lo (16 KB each); then the step: K hi, K lo, V^T
  // hi, V^T lo
  unsigned char* const own = sm + c * 32768;
  unsigned char* const step = sm + NWG * 32768;
  const uint32_t qh = smem_u32(own), ql = qh + 16384, sk = smem_u32(step);
  if (active) load_tile_tc(own, own + 16384, base, q0, L, ld, wtid);
  // keys below valid, and for a causal mask up to the block's last row
  int end = min(L, mk.valid);
  if (mk.causal) end = min(end, (NWG * grp + NWG) * T);
  const int n_ks = (end + SR - 1) / SR;
  const int row0 = q0 + 16 * warp + g, row1 = row0 + 8;

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  Step<NT> pf;
  if (n_ks > 0) pf.load(base + D, base + 2 * D, 0, L, ld, ld);
  for (int js = 0; js < n_ks; ++js) {
    const int k0 = js * SR;
    __syncthreads();  // every warpgroup is done with the last step
    pf.store_fwd(step);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (js + 1 < n_ks) pf.load(base + D, base + 2 * D, k0 + SR, L, ld, ld);
    if (!active || (mk.causal && k0 > q0 + T - 1)) continue;
    float s[16];
    wgmma_fence();
    prod_hd(s, qh, ql, sk, sk + 8192);
    wgmma_commit_wait();
    // s[4j + 2hh + e]: row hh ? row1 : row0, key k0 + 8j + 2t + e
#pragma unroll
    for (int e = 0; e < 16; ++e)
      s[e] = mk.score(s[e], (e & 2) ? row1 : row0, k0 + 8 * (e >> 2) + 2 * t + (e & 1)) * kLog2e;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < SR / 8; ++j)
        tmax = fmaxf(tmax, fmaxf(s[4 * j + 2 * hh], s[4 * j + 2 * hh + 1]));
      // finite: every step holds a key below L, and a row's first step an
      // unmasked one (key 0)
      const float m_new = fmaxf(m[hh], quad_max(tmax));
      const float alpha = ex2(m[hh] - m_new);
      float a = 0.f;
#pragma unroll
      for (int j = 0; j < SR / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = ex2(s[4 * j + 2 * hh + e] - m_new);  // masked: exactly 0
          s[4 * j + 2 * hh + e] = p;
          a += p;
        }
      l[hh] = l[hh] * alpha + a;
      m[hh] = m_new;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        o[4 * j + 2 * hh] *= alpha;
        o[4 * j + 2 * hh + 1] *= alpha;
      }
    }
    prod_seq(o, s, sk + 16384, sk + 24576);
  }
  if (!active) return;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float inv = 1.f / quad_sum(l[hh]);
    const int i = hh ? row1 : row0;
    if (i >= L) continue;
    float* row = out + ((size_t)seq * L + i) * D + h * HD;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<float2*>(row + 8 * j + 2 * t) =
          make_float2(o[4 * j + 2 * hh] * inv, o[4 * j + 2 * hh + 1] * inv);
  }
}

// 1. query-major: each of NWG warpgroups owns one 64-row query tile, its Q
//    and dO split in shared memory; 32-row key steps (K, V; in pass 2 also
//    K^T) stream past.  Pass 1: S and dP, giving each row's max, 1 / sum
//    and rowsum(dp * p) into the scratch; pass 2: S and dP again, ds, and
//    dQ += dS . K
template <int NWG>
__global__ void __launch_bounds__(NWG * 128, 1)
attn_bwd_query_tc_kernel(const float* __restrict__ qkv, const float* __restrict__ dout,
                         float* __restrict__ dqkv, float* __restrict__ stats, int n_head, int D,
                         Mask mk, int per_head) {
  constexpr int NT = NWG * 128;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* const sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x, c = tid >> 7, wtid = tid & 127;
  const int warp = wtid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int grp = blockIdx.x % per_head, h = (blockIdx.x / per_head) % n_head;
  const int seq = blockIdx.x / per_head / n_head;
  const int L = mk.L, ld = 3 * D, q0 = (NWG * grp + c) * T;
  const bool active = q0 < L;  // warpgroup-uniform
  const float* base = qkv + (size_t)seq * L * ld + h * HD;
  const float* gbase = dout + (size_t)seq * L * D + h * HD;
  // per warpgroup: Q hi, Q lo, dO hi, dO lo (16 KB each); then the step
  unsigned char* const own = sm + c * 65536;
  unsigned char* const step = sm + NWG * 65536;
  const uint32_t qh = smem_u32(own), ql = qh + 16384, gh = qh + 32768, gl = qh + 49152;
  const uint32_t sk = smem_u32(step);  // K hi, K lo, V hi, V lo, K^T hi, K^T lo
  if (active) {
    load_tile_tc(own, own + 16384, base, q0, L, ld, wtid);
    load_tile_tc(own + 32768, own + 49152, gbase, q0, L, D, wtid);
  }
  // keys below valid, and for a causal mask up to the block's last row
  int end = min(L, mk.valid);
  if (mk.causal) end = min(end, min(L, (NWG * grp + NWG) * T));
  const int n_ks = (end + SR - 1) / SR;
  const int row0 = q0 + 16 * warp + g, row1 = row0 + 8;
  const float c2 = kLog2e;  // scores in the exp2 domain: u = s * log2(e)

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, dd[2] = {0.f, 0.f};
  float dq[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dq[i] = 0.f;
  for (int pass = 0; pass < 2; ++pass) {
    Step<NT> pf;
    if (n_ks > 0) pf.load(base + D, base + 2 * D, 0, L, ld, ld);
    for (int js = 0; js < n_ks; ++js) {
      const int k0 = js * SR;
      __syncthreads();  // every warpgroup is done with the last step
      pf.store(step, pass == 1, false);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
      if (js + 1 < n_ks) pf.load(base + D, base + 2 * D, k0 + SR, L, ld, ld);
      if (!active || (mk.causal && k0 > q0 + T - 1)) continue;
      float s[16], dp[16];
      wgmma_fence();
      prod_hd(s, qh, ql, sk, sk + 8192);
      prod_hd(dp, gh, gl, sk + 16384, sk + 24576);
      wgmma_commit_wait();
#pragma unroll
      for (int e = 0; e < 16; ++e)
        s[e] = mk.score(s[e], (e & 2) ? row1 : row0, k0 + 8 * (e >> 2) + 2 * t + (e & 1)) * c2;
      if (pass == 0) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float tmax = -INFINITY;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            tmax = fmaxf(tmax, fmaxf(s[4 * j + 2 * hh], s[4 * j + 2 * hh + 1]));
          const float m_new = fmaxf(m[hh], quad_max(tmax));
          float a = 0.f, b = 0.f;
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float p = ex2(s[4 * j + 2 * hh + e] - m_new);
              a += p;
              b += p * dp[4 * j + 2 * hh + e];
            }
          const float alpha = ex2(m[hh] - m_new);
          l[hh] = l[hh] * alpha + a;
          dd[hh] = dd[hh] * alpha + b;
          m[hh] = m_new;
        }
      } else {
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          const int hh = (e >> 1) & 1;
          const float p = ex2(s[e] - m[hh]) * l[hh];  // l holds 1 / sum here
          s[e] = p * (dp[e] - dd[hh]) * mk.scale;    // ds
        }
        prod_seq(dq, s, sk + 32768, sk + 40960);
      }
    }
    if (pass == 0) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        l[hh] = 1.f / quad_sum(l[hh]);
        dd[hh] = quad_sum(dd[hh]) * l[hh];
        const int i = hh ? row1 : row0;
        if (active && t == 0 && i < L) {
          const float st[4] = {m[hh], l[hh], dd[hh], 0.f};
          st4(stats + (((size_t)seq * n_head + h) * L + i) * 4, st);
        }
      }
    }
  }
  if (!active) return;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int i = hh ? row1 : row0;
    if (i >= L) continue;
    float* row = dqkv + ((size_t)seq * L + i) * ld + h * HD;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<float2*>(row + 8 * j + 2 * t) =
          make_float2(dq[4 * j + 2 * hh], dq[4 * j + 2 * hh + 1]);
  }
}

// 2. key-major: each of two warpgroups owns one 64-row key tile, its K and
//    V split in shared memory; 32-row query steps (Q, dO, and both
//    transposed) stream past.  S^T = K.Q^T and dP^T = V.dO^T, p^T and ds^T
//    from the scratch's statistics, dV += P^T.dO and dK += dS^T.Q
__global__ void __launch_bounds__(256, 1)
attn_bwd_key_tc_kernel(const float* __restrict__ qkv, const float* __restrict__ dout,
                       const float* __restrict__ stats, float* __restrict__ dqkv, int n_head,
                       int D, Mask mk, int per_head) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* const sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x, c = tid >> 7, wtid = tid & 127;
  const int warp = wtid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int pair = blockIdx.x % per_head, h = (blockIdx.x / per_head) % n_head;
  const int seq = blockIdx.x / per_head / n_head;
  const int L = mk.L, ld = 3 * D, k0 = (2 * pair + c) * T;
  const bool active = k0 < L;
  const float* base = qkv + (size_t)seq * L * ld + h * HD;
  const float* gbase = dout + (size_t)seq * L * D + h * HD;
  const float4* st = reinterpret_cast<const float4*>(stats + ((size_t)seq * n_head + h) * L * 4);
  unsigned char* const own = sm + c * 65536;   // K hi, K lo, V hi, V lo
  unsigned char* const step = sm + 2 * 65536;  // Q, dO hi / lo, then Q^T, dO^T hi / lo
  const uint32_t kh = smem_u32(own), kl = kh + 16384, vh = kh + 32768, vl = kh + 49152;
  const uint32_t sq = smem_u32(step);
  if (active) {
    load_tile_tc(own, own + 16384, base + D, k0, L, ld, wtid);
    load_tile_tc(own + 32768, own + 49152, base + 2 * D, k0, L, ld, wtid);
  }
  // keys at or past valid are masked for every row (their dk = dv = 0); a
  // causal key tile is attended by the query rows from its own first row on
  const int kb = 2 * pair * T;  // the block's first key
  const int n_qs = kb >= mk.valid ? 0 : (L + SR - 1) / SR;
  const int js0 = mk.causal ? kb / SR : 0;
  const int key0 = k0 + 16 * warp + g, key1 = key0 + 8;

  float dk[32], dv[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;
  Step<256> pf;
  if (js0 < n_qs) pf.load(base, gbase, js0 * SR, L, ld, D);
  for (int js = js0; js < n_qs; ++js) {
    const int q0 = js * SR;
    __syncthreads();
    pf.store(step, true, true);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (js + 1 < n_qs) pf.load(base, gbase, q0 + SR, L, ld, D);
    if (!active || k0 >= mk.valid || (mk.causal && q0 + SR - 1 < k0)) continue;
    float s[16], dp[16];
    wgmma_fence();
    prod_hd(s, kh, kl, sq, sq + 8192);
    prod_hd(dp, vh, vl, sq + 16384, sq + 24576);
    wgmma_commit_wait();
    // s[4j + 2hh + e]: key row key_hh, query column q0 + 8j + 2t + e
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = q0 + 8 * j + 2 * t + e;
        const float4 r = i < L ? st[i] : make_float4(0.f, 0.f, 0.f, 0.f);  // (m, 1/l, dd, 0)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int x = 4 * j + 2 * hh + e;
          const float p = ex2(mk.score(s[x], i, hh ? key1 : key0) * kLog2e - r.x) * r.y;
          s[x] = p;
          dp[x] = p * (dp[x] - r.z) * mk.scale;  // ds^T
        }
      }
    prod_seq(dv, s, sq + 6 * 8192, sq + 7 * 8192);
    prod_seq(dk, dp, sq + 4 * 8192, sq + 5 * 8192);
  }
  if (!active) return;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int j0 = hh ? key1 : key0;
    if (j0 >= L) continue;
    float* row = dqkv + ((size_t)seq * L + j0) * ld + h * HD;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      *reinterpret_cast<float2*>(row + D + 8 * j + 2 * t) =
          make_float2(dk[4 * j + 2 * hh], dk[4 * j + 2 * hh + 1]);
      *reinterpret_cast<float2*>(row + 2 * D + 8 * j + 2 * t) =
          make_float2(dv[4 * j + 2 * hh], dv[4 * j + 2 * hh + 1]);
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

template <int NWG>
int launch_query(const float* q, const float* g, float* d, float* st, long long heads,
                 int n_head, int D, const Mask& mk, int n_t, cudaStream_t s) {
  constexpr int smem = NWG * 65536 + 6 * 8192 + 1024;  // own tiles, the step, alignment
  static bool ready = false;
  const cudaError_t e = allow_smem(attn_bwd_query_tc_kernel<NWG>, smem, &ready);
  if (e != cudaSuccess) return (int)e;
  const int per_q = (n_t + NWG - 1) / NWG;
  attn_bwd_query_tc_kernel<NWG><<<(unsigned)(heads * per_q), NWG * 128, smem, s>>>(
      q, g, d, st, n_head, D, mk, per_q);
  return (int)cudaGetLastError();
}

template <int NWG>
int launch_fwd(const float* q, float* o, long long heads, int n_head, int D, const Mask& mk,
               int n_t, cudaStream_t s) {
  constexpr int smem = NWG * 32768 + 4 * 8192 + 1024;  // own tiles, the step, alignment
  static bool ready = false;
  const cudaError_t e = allow_smem(attn_fwd_tc_kernel<NWG>, smem, &ready);
  if (e != cudaSuccess) return (int)e;
  const int per_q = (n_t + NWG - 1) / NWG;
  attn_fwd_tc_kernel<NWG><<<(unsigned)(heads * per_q), NWG * 128, smem, s>>>(
      q, o, n_head, D, mk, per_q);
  return (int)cudaGetLastError();
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
  const int n_t = (L + T - 1) / T;
  const long long heads = (long long)n_seq * n_head;
  if (heads * n_t > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const Mask mk{L, causal, valid, scale};
  const auto* q = static_cast<const float*>(qkv);
  auto* o = static_cast<float*>(out);
  const cudaStream_t s = (cudaStream_t)stream;
  // two query tiles a block, sharing each key step's split; a block of
  // one tile (the text tower's) takes one warpgroup
  return n_t == 1 ? launch_fwd<1>(q, o, heads, n_head, D, mk, n_t, s)
                  : launch_fwd<2>(q, o, heads, n_head, D, mk, n_t, s);
}

// qkv, dqkv: (n_seq * L, 3D) fp32.  dout: (n_seq * L, D) fp32.  stats:
// (n_seq * n_head * L, 4) fp32 scratch, each row's (max of s * log2(e),
// 1 / sum, rowsum(dp * p), 0), written by the query-major kernel and read
// by the key-major one.
extern "C" int attention_bwd_f32(const void* qkv, const void* dout, void* dqkv, void* stats,
                                 int n_seq, int L, int D, int n_head, int causal, int valid,
                                 float scale, void* stream) {
  if (!valid_args(n_seq, L, D, n_head, valid)) return (int)cudaErrorInvalidValue;
  const int n_t = (L + T - 1) / T;
  const long long heads = (long long)n_seq * n_head;
  if (heads * n_t > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const Mask mk{L, causal, valid, scale};
  const cudaStream_t s = (cudaStream_t)stream;
  const auto* q = static_cast<const float*>(qkv);
  const auto* g = static_cast<const float*>(dout);
  auto* d = static_cast<float*>(dqkv);
  auto* st = static_cast<float*>(stats);
  // query-major: two query tiles a block, sharing each key step's split;
  // a block of one tile (the text tower's) takes one warpgroup
  const int rc = n_t == 1 ? launch_query<1>(q, g, d, st, heads, n_head, D, mk, n_t, s)
                          : launch_query<2>(q, g, d, st, heads, n_head, D, mk, n_t, s);
  if (rc != 0) return rc;
  constexpr int smem_k = 2 * 65536 + 8 * 8192 + 1024;  // own tiles, the step, alignment
  static bool ready_k = false;
  const cudaError_t e = allow_smem(attn_bwd_key_tc_kernel, smem_k, &ready_k);
  if (e != cudaSuccess) return (int)e;
  const int per_k = (n_t + 1) / 2;
  attn_bwd_key_tc_kernel<<<(unsigned)(heads * per_k), 256, smem_k, s>>>(q, g, st, d, n_head, D,
                                                                        mk, per_k);
  return (int)cudaGetLastError();
}
