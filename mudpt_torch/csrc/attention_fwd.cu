// attention_fwd: multi-head softmax attention from a packed qkv, head dim
// 64, one launch per call.
//
// Replaces: the attention core of the TPU layer kernel, _mha_acc
//   (mudpt_tpu/ops/fused_block.py:222-239) with _head_probs (:197-205) and
//   the masks of _causal_mask / _attn_block_spec (:168-219), inside
//   _layer_fwd_nosave_kernel (:851), _layer_fwd_kernel (:831) and the
//   attention half's _attn_fwd_kernel (:318) and _attn_fwd_save_kernel
//   (:326).  Same numerics: scores are fp32
//   q.k^T (bf16 operands) times hd^-0.5, the mask adds -1e30 (_NEG, :46),
//   softmax is fp32 (exp(s - max) / sum), probabilities are normalized,
//   then rounded to bf16 before P.V, which accumulates in fp32 and is
//   written as bf16.  exp is taken as exp2 with log2(e) folded into the
//   scale, and / sum is a multiply by its reciprocal: each moves p by a
//   few fp32 ulps before its bf16 rounding.
// Mask specs: none; causal; packed (period, valid), where the wrapper passes
//   L = period and every `period` consecutive tokens form an independent
//   causal sequence whose keys at position >= valid are masked.
// fp32 output mode: the int8 layer kernels keep the attention accumulator
//   in fp32 (mudpt_tpu/ops/quant_block.py:146, :259, :283, :443, :624:
//   VMEM((S, D), float32) into which _mha_acc stores o unrounded) and
//   quantize it from there (:101); the same kernel then stores o as fp32.
// Bound on the H100: device-memory bytes at the serving shapes.  At S = 199
//   a (image, head) does 4*S*S*64 = 10 M operations on 4*S*64*2 = 102 KB of
//   q, k, v and output, ~100 operations per byte, a third of the ~295 where
//   bf16 tensor cores bind; the packed text rows (S = 16) are further below.
//   Next in line is the exponential: two per score (the two passes below)
//   on the SFU's 16 a clock per SM.
// Design: one block per (sequence block, head), so K and V cross device
//   memory once per (sequence block, head).  TMA brings 64-row tiles of q, k and v (3-D
//   tensor map: columns, rows of the block, block, so rows past L arrive as
//   zeros) into 128-byte-swizzled shared memory, each tile completing its
//   own mbarrier, so the first pass starts on the first key tile while the
//   rest land.  Consumer warpgroups (two, two blocks an SM, while K and V
//   of the block fit twice, L <= 320; else four in one block) take the
//   block's 64-row query tiles in turn; per 64-key tile, S = Q.K^T is one
//   wgmma m64n64k16 chain (Q and K from shared memory, K the K-major B it
//   natively is).  Pass 1 takes the row max and the sum of exp2(s * c -
//   max), c = hd^-0.5 * log2(e) folded into the exponent's fma, rescaled
//   once per key tile; pass 2 recomputes S,
//   forms p = bf16(exp2(s * c - max) * (1 / sum)) in the accumulator
//   registers, which are the A fragments of O += P.V (wgmma with A from
//   registers; V row-major, read through the descriptor's transpose bit).
//   In both passes the scores of the next
//   key tile run on the tensor cores while this tile's exponentials run.
//   A tile that no mask touches skips the mask arithmetic.  The output is
//   staged in the query tile's shared memory (swizzled, so the fragment
//   writes hit distinct banks) and leaves by a TMA store, which clips the
//   rows past L.  While 2 * (key tiles) <= 24 (L <= 768), K and V stay
//   resident for pass 2 and every query tile; longer blocks stream them
//   through a ring of 24 tiles, the warpgroups in step, a named barrier
//   freeing each tile for the next load.  There is no length limit.  What
//   bounds it (PERF.md): latency, two exponentials a score on the SFU and
//   S computed twice, with at most 16 warps an SM at 128 registers.
// Blocks of at most 64 rows (the text tower's 16-token packed rows and
//   causal prompts) are one query tile and one key tile, the rows past L
//   zeros that the masks exclude.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int HD = 64;           // head dim
constexpr float kNeg = -1e30f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

constexpr int TR = 64;                // rows of a query or key tile
constexpr int TILE = TR * HD * 2;     // bytes of one tile: 64 rows x 128 B
constexpr int RMAX = 24;              // key/value tiles the shared memory holds
// Two consumer warpgroups a block, and two blocks an SM, while both blocks'
// K and V fit (up to 5 key tiles); else four warpgroups in one block.
// PERF.md: two blocks of two beat one of four at 199 and 259 rows, and one
// block of two loses by 1.6x
constexpr int kNc2MaxKt = 5;
constexpr int kNc2Blocks = 2;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}

// one arrival that also announces `bytes` of TMA traffic for this phase
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// spin until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// TMA: the box at (c0 innermost, c1, c2) of the tensor map into shared memory
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// TMA store of a shared-memory box; the box's rows past the tensor are not written
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%1, %2, %3}], [%4];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(c1), "r"(c2), "r"(src)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// the stores committed so far have read their shared memory
__device__ __forceinline__ void tma_store_read_wait() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// shared-memory matrix descriptor, 128-byte swizzle (atoms of 8 x 128 B)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

#define WG_D32                                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),   \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),        \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),     \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),     \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),     \
      "+f"(d[31])
#define WG_REGS32                                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "             \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "

// d (64 x 64 fp32) (+)= A (64 x 16, K-major in shared memory) . B (16 x 64,
// K-major in shared memory)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_REGS32
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_D32
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x 64 fp32) (+)= A (64 x 16 bf16 in registers, the accumulator's
// fragment layout) . B (16 x 64, N-major in shared memory: transposed)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_REGS32
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// the accumulator layout of m64nN: d[4j + 0..1] row 16*warp + lane/4, cols
// 8j + 2*(lane%4) + 0..1; d[4j + 2..3] the row 8 further down
template <bool F32_OUT, int NC>
__global__ void __launch_bounds__(NC * 128, NC == 2 ? kNc2Blocks : 1)
attention_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_qkv,
                           const __grid_constant__ CUtensorMap map_out, int n_head, int L, int D,
                           int causal, int valid, float scale, int n_slots, int stream) {
  constexpr int THREADS = NC * 128;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[RMAX + NC];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;  // swizzle atoms: 1 KB aligned
  const uint32_t full0 = smem_addr(bars), qbar0 = full0 + 8 * RMAX;

  const int tid = threadIdx.x, c = tid >> 7, wtid = tid & 127;
  const int warp = wtid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int seq = blockIdx.x / n_head, h = blockIdx.x % n_head;
  const int n_kt = (L + TR - 1) / TR, n_groups = (n_kt + NC - 1) / NC;
  const int col_q = h * HD, col_k = D + h * HD, col_v = 2 * D + h * HD;
  const int per_group = 3 * n_kt, total = n_groups * per_group;
  const uint32_t qslot = base + (n_slots + c) * TILE, qbar = qbar0 + 8 * c;

  if (tid == 0) {
    for (int s = 0; s < n_slots; ++s) mbar_init(full0 + 8 * s, 1);
    for (int s = 0; s < NC; ++s) mbar_init(qbar0 + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // streamed: item `it` of the per-group sequence K_0..K_{n-1}, then K_0,
  // V_0, K_1, V_1, ..., lands in slot it % n_slots
  auto issue = [&](int it) {
    const int r = it % per_group;
    const int col = r < n_kt ? col_k : ((r - n_kt) & 1 ? col_v : col_k);
    const int tile = r < n_kt ? r : (r - n_kt) >> 1;
    const uint32_t bar = full0 + 8 * (it % n_slots);
    mbar_expect_tx(bar, TILE);
    tma_load_3d(base + (it % n_slots) * TILE, &map_qkv, col, tile * TR, seq, bar);
  };
  auto load_q = [&](int qt) {
    mbar_expect_tx(qbar, TILE);
    tma_load_3d(qslot, &map_qkv, col_q, qt * TR, seq, qbar);
  };
  if (wtid == 0 && c < n_kt) load_q(c);
  if (tid == 0) {
    if (stream) {
      for (int it = 0; it < n_slots && it < total; ++it) issue(it);
    } else {
      // resident: K_j in slot j, V_j in slot n + j, each loaded once
      for (int j = 0; j < n_kt; ++j) {
        mbar_expect_tx(full0 + 8 * j, TILE);
        tma_load_3d(base + j * TILE, &map_qkv, col_k, j * TR, seq, full0 + 8 * j);
      }
      for (int j = 0; j < n_kt; ++j) {
        const uint32_t bar = full0 + 8 * (n_kt + j);
        mbar_expect_tx(bar, TILE);
        tma_load_3d(base + (n_kt + j) * TILE, &map_qkv, col_v, j * TR, seq, bar);
      }
    }
  }

  // the slot of stream item `it`, or of resident key (v = 0) or value
  // (v = 1) tile j, waited for
  auto acquire = [&](int it, int j, int v) -> uint32_t {
    if (stream) {
      mbar_wait(full0 + 8 * (it % n_slots), (it / n_slots) & 1);
      return base + (it % n_slots) * TILE;
    }
    const int s = v * n_kt + j;
    mbar_wait(full0 + 8 * s, 0);
    return base + s * TILE;
  };
  // streamed: once every consumer is past this point, items a and b (or
  // -1) are read; their slots take the items n_slots further on.  Every
  // consumer calls it equally often, with or without a query tile
  auto release = [&](int a, int b) {
    if (!stream) return;
    bar_sync(1, THREADS);
    if (tid == 0) {
      if (a >= 0 && a + n_slots < total) issue(a + n_slots);
      if (b >= 0 && b + n_slots < total) issue(b + n_slots);
    }
  };
  // S = Q . K^T of this query tile and one key tile, issued (not waited)
  auto issue_scores = [&](float (&s)[32], uint32_t kslot) {
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < HD / 16; ++k)
      wgmma_ss(s, smem_desc(qslot + k * 32, 16, 1024), smem_desc(kslot + k * 32, 16, 1024), k > 0);
    wgmma_commit();
  };

  const float c2 = scale * kLog2e;
  int n_q = 0;  // query tiles this warpgroup has taken
  for (int gi = 0; gi < n_groups; ++gi) {
    const int qt = gi * NC + c, q0 = qt * TR;
    const bool active = qt < n_kt;                   // warpgroup-uniform
    const bool live = active && q0 + warp * 16 < L;  // warp-uniform: rows of this warp
    const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
    const int gbase = gi * per_group;
    if (active) mbar_wait(qbar, n_q & 1);

    // a tile of scores that no mask touches takes u = s * c2 inside the
    // exponent's fma; one that a mask touches is turned into u first
    // (keys past L -inf, masked keys + kNeg) and takes u * 1
    auto masked_tile = [&](int k0) {
      return k0 + TR > L || k0 + TR > valid || (causal && k0 + TR - 1 > q0);
    };
    auto logits = [&](float (&s)[32], int k0) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = e < 2 ? row0 : row1;
          const int col = k0 + 8 * j + 2 * t + (e & 1);
          float u = s[4 * j + e] * c2;
          if (col >= L) {
            u = -INFINITY;
          } else if ((causal && col > row) || col >= valid) {
            u += kNeg;
          }
          s[4 * j + e] = u;
        }
      }
    };

    // pass 1: row max and sum of exp2(u - max), rescaled once per key tile;
    // the scores of tile j + 1 run on the tensor cores meanwhile
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    auto stats = [&](float (&s)[32], int j) {
      const int k0 = j * TR, kc = L - k0;
      const bool mt = masked_tile(k0);
      if (mt) logits(s, k0);
      float t0 = -INFINITY, t1 = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        t0 = fmaxf(t0, fmaxf(s[4 * jj], s[4 * jj + 1]));
        t1 = fmaxf(t1, fmaxf(s[4 * jj + 2], s[4 * jj + 3]));
      }
      // max(s) * c2 is max(s * c2): rounding a product by c2 > 0 keeps order
      const float cm = mt ? 1.f : c2;
      const float n0 = fmaxf(m0, quad_max(t0) * cm), n1 = fmaxf(m1, quad_max(t1) * cm);
      float a0 = 0.f, a1 = 0.f;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        if (8 * jj < kc) {  // warp-uniform: no exp for the padding keys
          a0 += ex2(fmaf(s[4 * jj], cm, -n0)) + ex2(fmaf(s[4 * jj + 1], cm, -n0));
          a1 += ex2(fmaf(s[4 * jj + 2], cm, -n1)) + ex2(fmaf(s[4 * jj + 3], cm, -n1));
        }
      }
      l0 = l0 * ex2(m0 - n0) + a0;
      l1 = l1 * ex2(m1 - n1) + a1;
      m0 = n0;
      m1 = n1;
    };
    float sa[32], sb[32];
    if (active) issue_scores(sa, acquire(gbase, 0, 0));
    for (int j = 0; j < n_kt; j += 2) {  // tile j in sa, tile j + 1 in sb
      if (active) {
        wgmma_wait<0>();
        if (j + 1 < n_kt) issue_scores(sb, acquire(gbase + j + 1, j + 1, 0));
      }
      release(gbase + j, -1);
      if (live) stats(sa, j);
      if (j + 1 >= n_kt) break;
      if (active) {
        wgmma_wait<0>();
        if (j + 2 < n_kt) issue_scores(sa, acquire(gbase + j + 2, j + 2, 0));
      }
      release(gbase + j + 1, -1);
      if (live) stats(sb, j + 1);
    }
    const float inv0 = live ? 1.f / quad_sum(l0) : 0.f;
    const float inv1 = live ? 1.f / quad_sum(l1) : 0.f;

    // pass 2: p = bf16(exp2(u - max) * (1 / sum)) into the A fragments of
    // O += P . V, 16 keys a wgmma.  Per key tile j: the scores S_{j+1} are
    // issued into the other register set, then S_j and P_{j-1}.V_{j-1} are
    // waited for, P_j is formed while S_{j+1} runs, and P_j.V_j is issued
    float o[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;
    const int it2 = gbase + n_kt;  // stream item of K_0 in pass 2; V_j is it2 + 2j + 1
    uint32_t p[4][4];
    auto step = [&](float (&sc)[32], float (&sn)[32], int j) {
      if (active) {
        if (j + 1 < n_kt) {
          issue_scores(sn, acquire(it2 + 2 * j + 2, j + 1, 0));
          wgmma_wait<1>();
        } else {
          wgmma_wait<0>();
        }
      }
      release(it2 + 2 * j, j >= 1 ? it2 + 2 * j - 1 : -1);  // K_j; V_{j-1}
      if (!active) return;
      const int k0 = j * TR, kc = L - k0;
      const bool mt = masked_tile(k0);
      if (live && mt) logits(sc, k0);
      const float cm = mt ? 1.f : c2;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          // r: 0 row0 and 1 row1 of keys 16kk + 2t, 2 and 3 of keys 16kk + 8 + 2t
          const int e = 8 * kk + 2 * r;
          const float m = (r & 1) ? m1 : m0, inv = (r & 1) ? inv1 : inv0;
          const bool keys = 16 * kk + 8 * (r >> 1) < kc;  // warp-uniform
          p[kk][r] = live && keys ? pack_bf16(ex2(fmaf(sc[e], cm, -m)) * inv,
                                              ex2(fmaf(sc[e + 1], cm, -m)) * inv)
                                  : 0u;
        }
      }
      const uint32_t vslot = acquire(it2 + 2 * j + 1, j, 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(o, p[kk], smem_desc(vslot + kk * 2048, 8192, 1024), 1);
      wgmma_commit();
    };
    if (active) issue_scores(sa, acquire(it2, 0, 0));
    for (int j = 0; j < n_kt; j += 2) {
      step(sa, sb, j);
      if (j + 1 < n_kt) step(sb, sa, j + 1);
    }
    if (active) wgmma_wait<0>();
    release(it2 + 2 * n_kt - 1, -1);  // V_{n-1}
    if (!active) continue;

    // the output through the query tile's shared memory (128-byte swizzled:
    // chunk c of row r at chunk c ^ (r % 8)), then a TMA store
    unsigned char* stage = smem_raw + (qslot - smem_addr(smem_raw));
    bar_sync(2 + c, 128);  // every warp's products are done with Q
    if (F32_OUT) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {  // dims 32hh .. 32hh + 31: 128 B a row
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = warp * 16 + g + 8 * half;
            const int chunk = 2 * jj + (t >> 1);
            const int e = 4 * (4 * hh + jj) + 2 * half;
            *reinterpret_cast<float2*>(stage + r * 128 + ((chunk ^ (r & 7)) << 4) + (t & 1) * 8) =
                make_float2(o[e], o[e + 1]);
          }
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        bar_sync(2 + c, 128);
        if (wtid == 0) {
          tma_store_3d(&map_out, qslot, h * HD + 32 * hh, q0, seq);
          tma_store_read_wait();
        }
        bar_sync(2 + c, 128);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = warp * 16 + g + 8 * half;
          *reinterpret_cast<uint32_t*>(stage + r * 128 + ((j ^ (r & 7)) << 4) + t * 4) =
              pack_bf16(o[4 * j + 2 * half], o[4 * j + 2 * half + 1]);
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      bar_sync(2 + c, 128);
      if (wtid == 0) {
        tma_store_3d(&map_out, qslot, h * HD, q0, seq);
        tma_store_read_wait();
      }
    }
    ++n_q;
    if (wtid == 0 && qt + NC < n_kt) load_q(qt + NC);  // the slot is free again
  }
  if (wtid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// the CUDA driver API's cuTensorMapEncodeTiled, found through the runtime (no -lcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a (n_seq, L, cols) row-major tensor as a 3-D map (cols innermost), read
// or written in boxes of 64 rows x 128 bytes of one sequence block,
// 128-byte swizzled; rows past L lie outside the map
bool make_map(CUtensorMap* map, const void* ptr, bool f32, int n_seq, int L, int cols) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const int elem = f32 ? 4 : 2;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)L, (cuuint64_t)n_seq};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * elem, (cuuint64_t)L * cols * elem};
  const cuuint32_t box[3] = {(cuuint32_t)(128 / elem), (cuuint32_t)TR, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  return fn(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
            const_cast<void*>(ptr), dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool F32_OUT, int NC>
int launch_wgmma_nc(const void* qkv, void* out, int n_seq, int L, int D, int n_head, int causal,
                    int valid, float scale, cudaStream_t s) {
  const int n_kt = (L + TR - 1) / TR;
  const int stream = 2 * n_kt > RMAX;
  const int n_slots = stream ? RMAX : 2 * n_kt;
  const int smem = (n_slots + NC) * TILE + 1024;  // + the 1 KB alignment
  // a runtime call first: it makes the device's primary context current in
  // this thread, which the CUDA driver API's tensor-map encoder below needs
  auto kernel = attention_fwd_wgmma_kernel<F32_OUT, NC>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap map_qkv, map_out;
  if (!make_map(&map_qkv, qkv, false, n_seq, L, 3 * D) ||
      !make_map(&map_out, out, F32_OUT, n_seq, L, D))
    return (int)cudaErrorInvalidValue;
  kernel<<<n_seq * n_head, NC * 128, smem, s>>>(map_qkv, map_out, n_head, L, D, causal, valid,
                                                scale, n_slots, stream);
  return (int)cudaGetLastError();
}

template <bool F32_OUT>
int launch_wgmma(const void* qkv, void* out, int n_seq, int L, int D, int n_head, int causal,
                 int valid, float scale, cudaStream_t s) {
  if ((L + TR - 1) / TR <= kNc2MaxKt)
    return launch_wgmma_nc<F32_OUT, 2>(qkv, out, n_seq, L, D, n_head, causal, valid, scale, s);
  return launch_wgmma_nc<F32_OUT, 4>(qkv, out, n_seq, L, D, n_head, causal, valid, scale, s);
}

}  // namespace

// qkv: (n_seq * L, 3D) bf16, 16-byte aligned.  out: (n_seq * L, D) bf16, or
// fp32 when out_f32 is 1.
extern "C" int attention_fwd(const void* qkv, void* out, int n_seq, int L, int D, int n_head,
                             int causal, int valid, float scale, int out_f32, void* stream) {
  if (L < 1 || n_seq < 1 || D != n_head * HD) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return out_f32 ? launch_wgmma<true>(qkv, out, n_seq, L, D, n_head, causal, valid, scale, s)
                 : launch_wgmma<false>(qkv, out, n_seq, L, D, n_head, causal, valid, scale, s);
}
