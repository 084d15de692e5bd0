// attention_bwd: dq, dk, dv of multi-head softmax attention from the saved
// packed qkv and the bf16 gradient of the attention output, per (sequence
// block, head), head dim 64, written into a packed dqkv.  Any block length.
//
// Replaces: the attention backward of the TPU layer kernel
//   _layer_bwd_kernel (mudpt_tpu/ops/fused_block.py:868): _mha_grads_into
//   (:242-264) with _head_grads (:267-294) and _head_probs (:197-205), the
//   masks of _causal_mask / _attn_block_spec (:168-219).  The attention
//   half's backwards, _attn_bwd_save_kernel (:369) and _attn_bwd_kernel
//   (:358), run the same _mha_grads_into through _attn_bwd_core (:336).
//   Same numerics: p is the fp32 softmax of fp32 q.k^T * hd^-0.5 (masked
//   keys excluded, as the -1e30 of the Pallas mask makes their p exactly
//   0), recomputed from the saved bf16 q and k; dp = do.v^T in fp32;
//   ds = p * (dp - rowsum(dp * p)) * hd^-0.5 in fp32; dv = bf16(p)^T.do,
//   dq = bf16(ds).k and dk = bf16(ds)^T.q accumulate in fp32 and are stored
//   as bf16.  rowsum(dp * p) is summed from dp itself: the flash shortcut
//   rowsum(do * o) needs the attention output, which the layer does not
//   save.  exp is exp2 with log2(e) folded into the scale and / sum a
//   multiply by its reciprocal, as in attention_fwd: a few fp32 ulps on p.
// Mask specs: none; causal; packed (period, valid), where the wrapper passes
//   L = period and every `period` consecutive tokens form an independent
//   causal sequence whose keys at position >= valid are masked.
// Bound on the H100: at the ViT-B/16 and ViT-L/14 vision blocks (199, 259
//   rows) the five useful products, 10 * L^2 * 64 operations a (block,
//   head), meet 7 * L * 128 bytes of q, k, v, do and dqkv: ~180-240
//   operations a byte, below the ~295 where bf16 tensor cores bind, so
//   device-memory bytes bound it; at 579 rows (ViT-L/14@336px) ~530, so
//   the tensor cores do.
// Design: two kernels, each one block per (sequence block, head), so that q,
//   k, v and do cross device memory a bounded number of times, 64-row tiles
//   of them brought by TMA (3-D tensor maps: columns, rows of the block,
//   block; rows past L arrive as zeros) into 128-byte-swizzled shared
//   memory, one mbarrier a tile, and every product on wgmma m64n64k16:
//     1. query-major (attn_bwd_query_kernel): consumer warpgroups take the
//        block's 64-row query tiles in turn, Q and dO of the tile in their
//        own slots.  Pass 1, over the key tiles: S = Q.K^T and dP = dO.V^T
//        (both operands from shared memory), giving each row's max m, sum
//        l of exp2(u - m) and sum of exp2(u - m) * dp, rescaled once per
//        key tile as m grows (u = s * hd^-0.5 * log2(e)).  (m, 1/l,
//        rowsum(dp * p)) go to a small fp32 scratch, 16 bytes a row.
//        Pass 2, over the key tiles again: S and dP recomputed, ds formed
//        in the accumulator registers and rounded to bf16 into the A
//        fragments of dQ += dS.K (A from registers, K through the
//        descriptor's transpose bit).  dQ leaves by a TMA store from the
//        query tile's slot.
//     2. key-major (attn_bwd_key_kernel): warpgroups take 64-row key tiles
//        in turn, K and V of the tile in their own slots, while items of
//        (Q, dO, the scratch's rows) stream past: S^T = K.Q^T and
//        dP^T = V.dO^T, p^T and ds^T from the query rows' statistics, then
//        dV += bf16(P^T).dO and dK += bf16(dS^T).Q (A from registers),
//        16 queries at a time as the fragments are formed.  dK and dV
//        leave by TMA stores from the key tile's slots.
//   Nine products for the five useful ones (S and dP three times each); no
//   float atomics: dq sums the key tiles, dk and dv the query tiles, in
//   order inside one warpgroup's registers, so a result repeats exactly
//   from run to run.  Tiles that a mask covers whole are skipped (their p
//   and ds are exactly 0).  A last tile of at most 16 rows (199, 259 and
//   579 rows end in 7, 3 and 3; the text blocks are 16) enters the other
//   operand's products as 16 rows: S, dP and their transposes on wgmma
//   m64n16k16, one 16-row step of dQ, dK and dV; the choice is made per
//   tile, outside the product sequences (skipping steps inside them timed
//   slower).  While the tiles a kernel holds fit (K and V to 640 rows in
//   the first; Q, dO and the statistics to 640 rows in the second) they
//   stay resident and are loaded once; longer blocks stream them through a
//   ring of slots, the warpgroups in step, a named barrier freeing each
//   slot for the next load.  There is no length limit.  Warpgroups a
//   block: the query-major kernel two (two blocks an SM, 128 registers) up
//   to 4 tiles, three for 5 or 6, else four; the key-major kernel, whose
//   two fp32 sums take 64 registers, up to three (168 registers).  What
//   bounds it (PERF.md): the passes' latency, each tile's products waited
//   for before its exponentials, at 8-16 warps an SM.
// Blocks of at most 64 rows (the text tower's 16-token packed rows and
//   causal prompts) are one query tile and one key tile.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>
#include <type_traits>

namespace {

constexpr int HD = 64;             // head dim
constexpr int TR = 64;             // rows of a query or key tile
constexpr int TILE = TR * HD * 2;  // bytes of one tile: 64 rows x 128 B
constexpr int STAT = TR * 16;      // bytes of a tile's statistics: (m, 1/l, dsum, 0) a row
constexpr int QITEM = 2 * TILE + 1024;  // Q, dO and statistics of one query tile
constexpr int RMAX_Q = 20;         // key/value tiles the query-major kernel holds
constexpr int RMAX_K = 10;         // query items the key-major kernel holds
constexpr int NC_KEY = 3;          // warpgroups of the key-major kernel
constexpr float kLog2e = 1.4426950408889634f;

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

// TMA store of a shared-memory box (not committed); rows past the tensor
// are not written
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%1, %2, %3}], [%4];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(c1), "r"(c2), "r"(src)
      : "memory");
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

// d (64 x 64 fp32) += A (64 x 16 bf16 in registers, the accumulator's
// fragment layout) . B (16 x 64, N-major in shared memory: transposed)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_REGS32
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d (64 x 16 fp32) (+)= A (64 x 16, K-major) . B (16 x 16, K-major)
__device__ __forceinline__ void wgmma_ss_n16(float (&d)[8], uint64_t desc_a, uint64_t desc_b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d = A . B^T of a 64-row tile A and the first NE / 2 rows of a tile B
// (both 64 wide, K-major), issued: NE = 32 a whole tile, NE = 8 its first
// 16 rows (the last tile of a block whose rows end there)
template <int NE>
__device__ __forceinline__ void issue_nt(float (&d)[NE], uint32_t a, uint32_t b) {
#pragma unroll
  for (int k = 0; k < HD / 16; ++k) {
    if constexpr (NE == 32) {
      wgmma_ss(d, smem_desc(a + k * 32, 16, 1024), smem_desc(b + k * 32, 16, 1024), k > 0);
    } else {
      wgmma_ss_n16(d, smem_desc(a + k * 32, 16, 1024), smem_desc(b + k * 32, 16, 1024), k > 0);
    }
  }
}
using Whole = std::integral_constant<int, 32>;   // accumulator elements of 64 columns
using Narrow = std::integral_constant<int, 8>;   // of 16 columns

// rows 16kk .. 16kk + 15 of a row-major 64 x 64 tile, as the B operand of
// an m64n64k16 product whose K runs over those rows
__device__ __forceinline__ uint64_t desc_rows(uint32_t tile, int kk) {
  return smem_desc(tile + kk * 2048, 8192, 1024);
}

// a 64 x 64 fp32 accumulator rounded to bf16 into a 128-byte-swizzled tile
// (chunk c of row r at chunk c ^ (r % 8)), so the fragment writes hit
// distinct banks; then the tile leaves by one TMA store
__device__ __forceinline__ void stage_bf16(unsigned char* stage, const float (&d)[32], int warp,
                                           int g, int t) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = warp * 16 + g + 8 * half;
      *reinterpret_cast<uint32_t*>(stage + r * 128 + ((j ^ (r & 7)) << 4) + t * 4) =
          pack_bf16(d[4 * j + 2 * half], d[4 * j + 2 * half + 1]);
    }
  }
}

// accumulator element e of m64n64: row 16 * warp + g (+ 8 for e % 4 >= 2),
// column 8 * (e / 4) + 2t + e % 2; the A fragment of k-chunk kk (columns
// 16kk .. 16kk + 15) is elements 8kk .. 8kk + 7 packed in pairs

// 1. the query-major kernel: row statistics and dq
template <int NC, int MINB>
__global__ void __launch_bounds__(NC * 128, MINB)
attn_bwd_query_kernel(const __grid_constant__ CUtensorMap map_qkv,
                      const __grid_constant__ CUtensorMap map_do,
                      const __grid_constant__ CUtensorMap map_dqkv, float* __restrict__ stats,
                      int n_head, int L, int D, int causal, int valid, float scale, int n_slots,
                      int stream) {
  constexpr int THREADS = NC * 128;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[RMAX_Q + NC];
  static_assert((RMAX_Q + 2 * NC) * TILE + 1024 <= 232448 - 8 * (RMAX_Q + NC), "smem");
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;  // swizzle atoms: 1 KB aligned
  const uint32_t full0 = smem_addr(bars), qbar0 = full0 + 8 * RMAX_Q;

  const int tid = threadIdx.x, c = tid >> 7, wtid = tid & 127;
  const int warp = wtid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int seq = blockIdx.x / n_head, h = blockIdx.x % n_head;
  const int n_kt = (L + TR - 1) / TR, n_groups = (n_kt + NC - 1) / NC;
  const int col_q = h * HD, col_k = D + h * HD, col_v = 2 * D + h * HD;
  // streamed: per group, K_0, V_0, K_1, V_1, ... for pass 1, then again for pass 2
  const int per_group = 4 * n_kt, total = n_groups * per_group;
  const uint32_t qslot = base + (n_slots + 2 * c) * TILE, doslot = qslot + TILE;
  const uint32_t qbar = qbar0 + 8 * c;
  float* st_rows = stats + (size_t)blockIdx.x * L * 4;

  if (tid == 0) {
    for (int s = 0; s < n_slots; ++s) mbar_init(full0 + 8 * s, 1);
    for (int s = 0; s < NC; ++s) mbar_init(qbar0 + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto issue = [&](int it) {
    const int r = it % per_group;
    const int tile = (r % (2 * n_kt)) >> 1;
    const uint32_t bar = full0 + 8 * (it % n_slots);
    mbar_expect_tx(bar, TILE);
    tma_load_3d(base + (it % n_slots) * TILE, &map_qkv, r & 1 ? col_v : col_k, tile * TR, seq,
                bar);
  };
  auto load_q = [&](int qt) {
    mbar_expect_tx(qbar, 2 * TILE);
    tma_load_3d(qslot, &map_qkv, col_q, qt * TR, seq, qbar);
    tma_load_3d(doslot, &map_do, h * HD, qt * TR, seq, qbar);
  };
  if (wtid == 0 && c < n_kt) load_q(c);
  if (tid == 0) {
    if (stream) {
      for (int it = 0; it < n_slots && it < total; ++it) issue(it);
    } else {
      // resident: K_j in slot j, V_j in slot n + j, each loaded once
      for (int j = 0; j < 2 * n_kt; ++j) {
        mbar_expect_tx(full0 + 8 * j, TILE);
        tma_load_3d(base + j * TILE, &map_qkv, j < n_kt ? col_k : col_v, (j % n_kt) * TR, seq,
                    full0 + 8 * j);
      }
    }
  }
  // the slot of stream item `it`, or of resident key (v = 0) or value (v = 1)
  // tile j, waited for
  auto acquire = [&](int it, int j, int v) -> uint32_t {
    if (stream) {
      mbar_wait(full0 + 8 * (it % n_slots), (it / n_slots) & 1);
      return base + (it % n_slots) * TILE;
    }
    const int s = v * n_kt + j;
    mbar_wait(full0 + 8 * s, 0);
    return base + s * TILE;
  };
  // streamed: once every consumer is past this point, items a and a + 1
  // are read; their slots take the items n_slots further on.  Every
  // consumer calls it equally often, with or without a query tile
  auto release = [&](int a) {
    if (!stream) return;
    bar_sync(1, THREADS);
    if (tid == 0) {
      if (a + n_slots < total) issue(a + n_slots);
      if (a + 1 + n_slots < total) issue(a + 1 + n_slots);
    }
  };

  const float c2 = scale * kLog2e;
  int n_q = 0;  // query tiles this warpgroup has taken
  for (int gi = 0; gi < n_groups; ++gi) {
    const int qt = gi * NC + c, q0 = qt * TR;
    const bool active = qt < n_kt;                   // warpgroup-uniform
    const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
    const int gbase = gi * per_group;
    if (active) mbar_wait(qbar, n_q & 1);
    // a key tile that the mask covers whole for every row of this query tile
    auto dead = [&](int k0) { return k0 >= valid || (causal && k0 > q0 + TR - 1); };
    // a key tile that the mask touches: the per-element test runs
    auto touched = [&](int k0) {
      return k0 + TR > L || k0 + TR > valid || (causal && k0 + TR - 1 > q0);
    };
    auto masked = [&](int row, int col) {
      return col >= L || col >= valid || (causal && col > row);
    };

    // pass 1: row max, sum of exp2(u - max) and of exp2(u - max) * dp
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f, p0 = 0.f, p1 = 0.f;
    for (int j = 0; j < n_kt; ++j) {
      const uint32_t ks = acquire(gbase + 2 * j, j, 0), vs = acquire(gbase + 2 * j + 1, j, 1);
      const int k0 = j * TR;
      // the statistics over one key tile, its first NE / 2 keys
      auto stats = [&](auto ne) {
        constexpr int NE = decltype(ne)::value;
        float s[NE], dp[NE];
        wgmma_fence();
        issue_nt(s, qslot, ks);
        issue_nt(dp, doslot, vs);
        wgmma_commit();
        wgmma_wait0();
        if (touched(k0)) {
#pragma unroll
          for (int e = 0; e < NE; ++e) {
            const int col = k0 + 8 * (e >> 2) + 2 * t + (e & 1);
            if (masked((e & 2) ? row1 : row0, col)) s[e] = -INFINITY;
          }
        }
        float t0 = -INFINITY, t1 = -INFINITY;
#pragma unroll
        for (int jj = 0; jj < NE / 4; ++jj) {
          t0 = fmaxf(t0, fmaxf(s[4 * jj], s[4 * jj + 1]));
          t1 = fmaxf(t1, fmaxf(s[4 * jj + 2], s[4 * jj + 3]));
        }
        // max(s) * c2 is max(s * c2): rounding a product by c2 > 0 keeps order
        const float n0 = fmaxf(m0, quad_max(t0) * c2), n1 = fmaxf(m1, quad_max(t1) * c2);
        float a0 = 0.f, a1 = 0.f, b0 = 0.f, b1 = 0.f;
#pragma unroll
        for (int jj = 0; jj < NE / 4; ++jj) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float e0 = ex2(fmaf(s[4 * jj + e], c2, -n0));
            const float e1 = ex2(fmaf(s[4 * jj + 2 + e], c2, -n1));
            a0 += e0;
            b0 += e0 * dp[4 * jj + e];
            a1 += e1;
            b1 += e1 * dp[4 * jj + 2 + e];
          }
        }
        const float r0 = ex2(m0 - n0), r1 = ex2(m1 - n1);
        l0 = l0 * r0 + a0;
        p0 = p0 * r0 + b0;
        l1 = l1 * r1 + a1;
        p1 = p1 * r1 + b1;
        m0 = n0;
        m1 = n1;
      };
      if (active && !dead(k0)) {
        if (L - k0 <= 16) stats(Narrow{});
        else stats(Whole{});
      }
      release(gbase + 2 * j);
    }
    const float inv0 = 1.f / quad_sum(l0), inv1 = 1.f / quad_sum(l1);
    const float ds0 = quad_sum(p0) * inv0, ds1 = quad_sum(p1) * inv1;
    if (active && t == 0) {
      float4* st = reinterpret_cast<float4*>(st_rows);
      if (row0 < L) st[row0] = make_float4(m0, inv0, ds0, 0.f);
      if (row1 < L) st[row1] = make_float4(m1, inv1, ds1, 0.f);
    }

    // pass 2: S and dP again; ds = p * (dp - dsum) * scale, rounded to bf16
    // 16 keys at a time into the A fragments of dQ += dS . K
    float dq[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dq[i] = 0.f;
    const int it2 = gbase + 2 * n_kt;
    for (int j = 0; j < n_kt; ++j) {
      const uint32_t ks = acquire(it2 + 2 * j, j, 0), vs = acquire(it2 + 2 * j + 1, j, 1);
      const int k0 = j * TR;
      // dQ += dS . K over one key tile, its first NE / 2 keys
      auto grad = [&](auto ne) {
        constexpr int NE = decltype(ne)::value, KK = NE / 8;
        float s[NE], dp[NE];
        wgmma_fence();
        issue_nt(s, qslot, ks);
        issue_nt(dp, doslot, vs);
        wgmma_commit();
        wgmma_wait0();
        const bool mt = touched(k0);
        uint32_t da[KK][4];
#pragma unroll
        for (int kk = 0; kk < KK; ++kk) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            float v[2];
#pragma unroll
            for (int e1 = 0; e1 < 2; ++e1) {
              const int e = 8 * kk + 2 * r + e1;
              const bool lo = (e & 2) == 0;
              float p = ex2(fmaf(s[e], c2, -(lo ? m0 : m1))) * (lo ? inv0 : inv1);
              if (mt && masked(lo ? row0 : row1, k0 + 8 * (e >> 2) + 2 * t + (e & 1))) p = 0.f;
              v[e1] = p * (dp[e] - (lo ? ds0 : ds1)) * scale;
            }
            da[kk][r] = pack_bf16(v[0], v[1]);
          }
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KK; ++kk) wgmma_rs(dq, da[kk], desc_rows(ks, kk));
        wgmma_commit();
        wgmma_wait0();
      };
      if (active && !dead(k0)) {
        if (L - k0 <= 16) grad(Narrow{});
        else grad(Whole{});
      }
      release(it2 + 2 * j);
    }
    if (!active) continue;

    // dq through the query tile's slot, then a TMA store
    unsigned char* stage = smem_raw + (qslot - smem_addr(smem_raw));
    bar_sync(2 + c, 128);  // every warp's products are done with Q
    stage_bf16(stage, dq, warp, g, t);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    bar_sync(2 + c, 128);
    if (wtid == 0) {
      tma_store_3d(&map_dqkv, qslot, col_q, q0, seq);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      if (qt + NC < n_kt) load_q(qt + NC);  // the slots are free again
    }
    ++n_q;
  }
  if (wtid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// 2. the key-major kernel: dk and dv
template <int NC>
__global__ void __launch_bounds__(NC * 128, 1)
attn_bwd_key_kernel(const __grid_constant__ CUtensorMap map_qkv,
                    const __grid_constant__ CUtensorMap map_do,
                    const __grid_constant__ CUtensorMap map_st,
                    const __grid_constant__ CUtensorMap map_dqkv, int n_head, int L, int D,
                    int causal, int valid, float scale, int n_slots, int stream) {
  constexpr int THREADS = NC * 128;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[RMAX_K + NC];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t full0 = smem_addr(bars), kbar0 = full0 + 8 * RMAX_K;
  unsigned char* const base_p = smem_raw + (base - smem_addr(smem_raw));

  const int tid = threadIdx.x, c = tid >> 7, wtid = tid & 127;
  const int warp = wtid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int seq = blockIdx.x / n_head, h = blockIdx.x % n_head;
  const int n_kt = (L + TR - 1) / TR, n_groups = (n_kt + NC - 1) / NC;
  const int col_q = h * HD, col_k = D + h * HD, col_v = 2 * D + h * HD;
  const int total = n_groups * n_kt;  // streamed: per group, the query items 0 .. n - 1
  const uint32_t kslot = base + n_slots * QITEM + 2 * c * TILE, vslot = kslot + TILE;
  const uint32_t kbar = kbar0 + 8 * c;

  if (tid == 0) {
    for (int s = 0; s < n_slots; ++s) mbar_init(full0 + 8 * s, 1);
    for (int s = 0; s < NC; ++s) mbar_init(kbar0 + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // query item i into slot s: Q_i, dO_i and the statistics of its rows
  auto load_item = [&](int s, int i) {
    const uint32_t dst = base + s * QITEM, bar = full0 + 8 * s;
    mbar_expect_tx(bar, 2 * TILE + STAT);
    tma_load_3d(dst, &map_qkv, col_q, i * TR, seq, bar);
    tma_load_3d(dst + TILE, &map_do, h * HD, i * TR, seq, bar);
    tma_load_3d(dst + 2 * TILE, &map_st, 0, i * TR, blockIdx.x, bar);
  };
  auto load_kv = [&](int kt) {
    mbar_expect_tx(kbar, 2 * TILE);
    tma_load_3d(kslot, &map_qkv, col_k, kt * TR, seq, kbar);
    tma_load_3d(vslot, &map_qkv, col_v, kt * TR, seq, kbar);
  };
  if (wtid == 0 && c < n_kt) load_kv(c);
  if (tid == 0) {
    if (stream) {
      for (int it = 0; it < n_slots && it < total; ++it) load_item(it, it % n_kt);
    } else {
      for (int i = 0; i < n_kt; ++i) load_item(i, i);  // resident: item i in slot i
    }
  }
  auto acquire = [&](int it, int i) -> int {
    const int s = stream ? it % n_slots : i;
    mbar_wait(full0 + 8 * s, stream ? (it / n_slots) & 1 : 0);
    return s;
  };
  auto release = [&](int it) {
    if (!stream) return;
    bar_sync(1, THREADS);
    if (tid == 0 && it + n_slots < total) load_item((it + n_slots) % n_slots,
                                                   (it + n_slots) % n_kt);
  };

  const float c2 = scale * kLog2e;
  int n_k = 0;  // key tiles this warpgroup has taken
  for (int gi = 0; gi < n_groups; ++gi) {
    const int kt = gi * NC + c, k0 = kt * TR;
    const bool active = kt < n_kt;  // warpgroup-uniform
    const int key0 = k0 + warp * 16 + g, key1 = key0 + 8;
    if (active) mbar_wait(kbar, n_k & 1);
    float dk[32], dv[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;
    for (int i = 0; i < n_kt; ++i) {
      const int s = acquire(gi * n_kt + i, i);
      const int q0 = i * TR;
      // the mask covers this key tile whole for every query of the item
      const bool dead = k0 >= valid || (causal && k0 > q0 + TR - 1);
      const uint32_t qs = base + s * QITEM, dos = qs + TILE;
      const float4* st = reinterpret_cast<const float4*>(base_p + s * QITEM + 2 * TILE);
      const bool mt = q0 + TR > L || k0 + TR > valid || (causal && k0 + TR - 1 > q0);
      // dV and dK over one query item, its first NE / 2 queries
      auto grads = [&](auto ne) {
        constexpr int NE = decltype(ne)::value, KK = NE / 8;
        float sT[NE], dpT[NE];
        wgmma_fence();
        issue_nt(sT, kslot, qs);
        issue_nt(dpT, vslot, dos);
        wgmma_commit();
        wgmma_wait0();
        // 16 queries at a time: p^T and ds^T of keys x queries 16kk ..
        // 16kk + 15 into A fragments, then their two products issued
        uint32_t pa[KK][4], da[KK][4];
#pragma unroll
        for (int kk = 0; kk < KK; ++kk) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            float pv[2], dv2[2];
#pragma unroll
            for (int e1 = 0; e1 < 2; ++e1) {
              const int e = 8 * kk + 2 * r + e1;
              const int qc = 8 * (e >> 2) + 2 * t + (e & 1);  // the query, a column here
              const float4 q = st[qc];                        // (m, 1/l, dsum, 0)
              float p = ex2(fmaf(sT[e], c2, -q.x)) * q.y;
              if (mt) {
                const int col = q0 + qc, key = (e & 2) ? key1 : key0;
                if (col >= L || key >= valid || (causal && key > col)) p = 0.f;
              }
              pv[e1] = p;
              dv2[e1] = p * (dpT[e] - q.z) * scale;
            }
            pa[kk][r] = pack_bf16(pv[0], pv[1]);
            da[kk][r] = pack_bf16(dv2[0], dv2[1]);
          }
          wgmma_fence();
          wgmma_rs(dv, pa[kk], desc_rows(dos, kk));
          wgmma_rs(dk, da[kk], desc_rows(qs, kk));
        }
        wgmma_commit();
        wgmma_wait0();
      };
      if (active && !dead) {
        if (L - q0 <= 16) grads(Narrow{});
        else grads(Whole{});
      }
      release(gi * n_kt + i);
    }
    if (!active) continue;

    // dk and dv through the key tile's slots, then TMA stores
    bar_sync(2 + c, 128);  // every warp's products are done with K and V
    stage_bf16(base_p + (kslot - base), dk, warp, g, t);
    stage_bf16(base_p + (vslot - base), dv, warp, g, t);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    bar_sync(2 + c, 128);
    if (wtid == 0) {
      tma_store_3d(&map_dqkv, kslot, col_k, k0, seq);
      tma_store_3d(&map_dqkv, vslot, col_v, k0, seq);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      if (kt + NC < n_kt) load_kv(kt + NC);  // the slots are free again
    }
    ++n_k;
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

// a (n, L, cols) row-major tensor as a 3-D map (cols innermost), in boxes
// of 64 rows of one sequence block: bf16, 64 columns, 128-byte swizzled; or
// the fp32 statistics, 4 columns, unswizzled.  Rows past L lie outside the
// map: they load as zeros and are not stored
bool make_map(CUtensorMap* map, const void* ptr, bool stats, int n, int L, int cols) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const int elem = stats ? 4 : 2;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)L, (cuuint64_t)n};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * elem, (cuuint64_t)L * cols * elem};
  const cuuint32_t box[3] = {stats ? 4u : 64u, (cuuint32_t)TR, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  return fn(map, stats ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
            const_cast<void*>(ptr), dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            stats ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct Maps {
  CUtensorMap qkv, dout, dqkv, st;
};

template <int NC, int MINB>
int launch_query(const Maps& m, float* stats, int n_blocks, int L, int D, int n_head,
                 int causal, int valid, float scale, cudaStream_t s) {
  const int n_kt = (L + TR - 1) / TR;
  const int stream = 2 * n_kt > RMAX_Q;
  const int n_slots = stream ? RMAX_Q : 2 * n_kt;
  const int smem = (n_slots + 2 * NC) * TILE + 1024;  // + the 1 KB alignment
  auto kernel = attn_bwd_query_kernel<NC, MINB>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<n_blocks, NC * 128, smem, s>>>(m.qkv, m.dout, m.dqkv, stats, n_head, L, D, causal,
                                          valid, scale, n_slots, stream);
  return (int)cudaGetLastError();
}

template <int NC>
int launch_key(const Maps& m, int n_blocks, int L, int D, int n_head, int causal, int valid,
               float scale, cudaStream_t s) {
  const int n_kt = (L + TR - 1) / TR;
  const int stream = n_kt > RMAX_K;
  const int n_slots = stream ? RMAX_K : n_kt;
  const int smem = n_slots * QITEM + 2 * NC * TILE + 1024;
  auto kernel = attn_bwd_key_kernel<NC>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<n_blocks, NC * 128, smem, s>>>(m.qkv, m.dout, m.st, m.dqkv, n_head, L, D, causal,
                                          valid, scale, n_slots, stream);
  return (int)cudaGetLastError();
}

}  // namespace

// qkv, dqkv: (n_seq * L, 3D) bf16; dout: (n_seq * L, D) bf16; stats: a
// scratch of n_seq * n_head * L * 4 fp32 (written by the first kernel, read
// by the second); every pointer 16-byte aligned.
extern "C" int attention_bwd(const void* qkv, const void* dout, void* dqkv, void* stats,
                             int n_seq, int L, int D, int n_head, int causal, int valid,
                             float scale, void* stream) {
  if (L < 1 || n_seq < 1 || D != n_head * HD || valid < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  // a runtime call first: it makes the device's primary context current in
  // this thread (autograd's backward thread may not have one yet), which
  // the CUDA driver API's tensor-map encoder below needs
  const cudaError_t err =
      cudaFuncSetAttribute(attn_bwd_key_kernel<1>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           QITEM + 2 * TILE + 1024);
  if (err != cudaSuccess) return (int)err;
  Maps m;
  const int n = n_seq * n_head;
  if (!make_map(&m.qkv, qkv, false, n_seq, L, 3 * D) ||
      !make_map(&m.dout, dout, false, n_seq, L, D) ||
      !make_map(&m.dqkv, dqkv, false, n_seq, L, 3 * D) || !make_map(&m.st, stats, true, n, L, 4))
    return (int)cudaErrorInvalidValue;
  float* st = static_cast<float*>(stats);
  const int n_kt = (L + TR - 1) / TR;
  int rc;
  // query-major: one warpgroup for a single tile; two a block, two blocks
  // an SM, while K and V of both fit (up to 4 tiles); three in one block
  // for 5 or 6 tiles, four past that (the fastest of the three at 259 and
  // 579 rows)
  if (n_kt == 1)
    rc = launch_query<1, 4>(m, st, n, L, D, n_head, causal, valid, scale, s);
  else if (n_kt <= 4)
    rc = launch_query<2, 2>(m, st, n, L, D, n_head, causal, valid, scale, s);
  else if (n_kt <= 6)
    rc = launch_query<3, 1>(m, st, n, L, D, n_head, causal, valid, scale, s);
  else
    rc = launch_query<4, 1>(m, st, n, L, D, n_head, causal, valid, scale, s);
  if (rc != 0) return rc;
  // key-major: up to three warpgroups, each holding two 64 x 64 fp32 sums
  // (168 registers); two for 2 and 4 tiles, which three would leave idle
  if (n_kt == 1) return launch_key<1>(m, n, L, D, n_head, causal, valid, scale, s);
  if (n_kt == 2 || n_kt == 4) return launch_key<2>(m, n, L, D, n_head, causal, valid, scale, s);
  return launch_key<NC_KEY>(m, n, L, D, n_head, causal, valid, scale, s);
}
