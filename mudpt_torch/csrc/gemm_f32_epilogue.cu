// gemm_f32_epilogue: C[M,N] = epilogue(A[M,K] . B[K,N]), fp32 operands,
// products accurate to fp32 (three TF32 tensor-core products, 3xTF32) and
// fp32 sums.  B is W in its (in, out) = (K, N) row-major layout for the
// forward epilogues, and W^T for the backward ones, with W (N, K)
// row-major: the layer's weights are used in their stored layout both ways,
// and a column chunk of a wider weight is read in place through its row
// stride.
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
//   version (fp32 torch.matmul with TF32 off) differ in the order of the
//   fp32 sums, in the lo.lo term the split drops (below 2^-20 of a
//   product), and in the few ulps of the hardware exp and division in g
//   and g'.
// Bound on the H100: operations.  At the ViT-B/16 vision shapes (M =
//   384*199 = 76,416 tokens, K, N in 768..3072) a product does 2*M*N*K
//   operations over (M*K + K*N + M*N*(1..3))*4 bytes: ~190-380 operations
//   a byte.  One TF32 product reads ~2^-11 of an fp32 one, so an
//   fp32-accurate product is three TF32 ones (3xTF32, 494.7 / 3 TFLOP/s on
//   the tensor cores), the operations' bound at these shapes.
// Design: Hopper's warpgroup MMA in TF32, fed by TMA, warp-specialized,
//   persistent, one 128 x 128 output tile at a time, both consumers
//   sharing it (64 rows each).
//   The split: x = hi + lo exactly, hi = cvt.rna.tf32(x), lo =
//     cvt.rna.tf32(x - hi) (x - hi is exact in fp32); each product is
//     A_lo.B_hi + A_hi.B_lo + A_hi.B_hi, small terms first, into one fp32
//     accumulator; A_lo.B_lo (below 2^-20 of the product) is dropped.
//   Operand layout: TF32 wgmma reads both shared-memory operands K-major
//     only (only 16-bit types transpose through the descriptor).  A (M, K)
//     and a backward W (N, K) are K-major as they lie: TMA brings 32-wide K
//     slices (one 128-byte swizzle row a row) into the slots where their hi
//     parts will be, and the consumers split them in place, writing lo
//     beside them.  A forward W (K, N) is N-major: TMA brings its slice
//     unswizzled into the lo slot, and the split reads it into registers
//     (four k a thread, consecutive n across a warp: conflict-free) and
//     writes hi and lo transposed, K-major and 128-byte swizzled (a 16-byte
//     store a thread, the eight rows of a swizzle atom on distinct banks).
//     The split runs in shared memory rather than on register A fragments
//     so that every product is shared-memory x shared-memory, the same code
//     for both layouts, with no fragment registers held across a slice.
//   Pipeline: one thread of warpgroup 0 (40 registers by setmaxnreg) keeps
//     a ring of three 64 KB stages (A hi, A lo, W hi, W lo) full with TMA
//     copies, mbarriers saying when a stage is full and free.  The
//     consumer warpgroups 1 and 2 (232 registers) split the stage that has
//     arrived while the previous stage's products run on the tensor cores,
//     meet at a named barrier, then issue the stage's twelve wgmma
//     m64n128k8 (four k8 steps x three products), the previous stage's
//     completion releasing its slots.
//   Accumulation: every K_PROMOTE slices (128 deep) the wgmma accumulator
//     starts afresh and its sum is added into a register fp32 accumulator
//     with FADD, so that the tensor cores' fp32 accumulation (which keeps
//     fewer bits than a rounded fp32 add) runs over 128-deep partial sums
//     only (PERF.md: the error at each mode's K with and without).
//   Epilogue: from the accumulator registers, fp32 float2 loads and stores
//     (each warp writes whole 32-byte sectors), the second operand loaded
//     whole before the first store (C may be R, so the loads would
//     otherwise wait on each store); the producer loads the next tile's
//     first stages meanwhile.  Tiles go in groups of 8 row blocks
//     (grouped rasterization).  TMA zero-fills the ragged M and N edges;
//     the epilogue stores only inside the matrix.
//   No atomics and a fixed order of sums: a result repeats exactly from
//   launch to launch.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

__host__ __device__ constexpr bool w_transposed(int mode) {
  return mode == kGeluBwd || mode == kStore || mode == kStoreF32 || mode == kMulF32 ||
         mode == kAddF32;
}

constexpr int BK = 32;             // K slice: 32 fp32 = one 128-byte swizzle row
constexpr int TM = 128, TN = 128;  // the block's output tile; consumer c owns rows 64c..64c+63
constexpr int THREADS = 384;       // warpgroup 0 loads, warpgroups 1 and 2 split and compute
constexpr int GROUP_M = 8;         // row blocks of a rasterization group
constexpr int PANEL = TM * BK * 4; // 16 KB: one 128 x 32 fp32 operand slice
constexpr int STAGE = 4 * PANEL;   // A hi, A lo, W hi, W lo
constexpr int STAGES = 3;
constexpr int SMEM = STAGES * STAGE + 1024;  // + the 1 KB alignment of the swizzle atoms
constexpr int K_PROMOTE = 4;       // slices a wgmma partial sum runs over (128 deep)

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
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

// TMA: a 2-D box at (c0 innermost, c1) of the tensor map into shared memory,
// completing its bytes on the mbarrier
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// the 256 consumer threads (barrier 1; 0 is __syncthreads)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// shared-memory matrix descriptor, 128-byte swizzle (atoms of 8 x 128 B)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(16 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// d (64 x 128 fp32) (+)= A (64 x 8 tf32, K-major) . B (8 x 128 tf32, K-major)
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
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

// hardware exp and division: a few fp32 ulps, far below the limits
__device__ __forceinline__ float quick_gelu(float h) {
  return __fdividef(h, 1.0f + __expf(-1.702f * h));
}

__device__ __forceinline__ float quick_gelu_grad(float h) {
  const float s = __fdividef(1.0f, 1.0f + __expf(-1.702f * h));
  return s + 1.702f * h * s * (1.0f - s);
}

// the block's k-th tile (blockIdx.x + k * gridDim.x), grouped: GROUP_M row
// blocks at a time, row blocks fastest within a group
__device__ __forceinline__ void tile_origin(int tile, int n_mb, int n_nb, int& m0, int& n0) {
  const int per_group = GROUP_M * n_nb, first = (tile / per_group) * GROUP_M;
  const int rows = min(n_mb - first, GROUP_M), r = tile % per_group;
  m0 = (first + r % rows) * TM;
  n0 = (r / rows) * TN;
}

template <bool W_NK>
__global__ void __launch_bounds__(THREADS, 1)
gemm_f32_kernel(const __grid_constant__ CUtensorMap map_a,
                const __grid_constant__ CUtensorMap map_w, const float* __restrict__ bias,
                const float* R, float* C, float* __restrict__ C2, int M, int N, int K, int mode) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023) & ~1023u;  // swizzle atoms need 1024-byte alignment
  unsigned char* const base_p = smem_raw + (base - raw);
  const uint32_t full0 = static_cast<uint32_t>(__cvta_generic_to_shared(full));
  const uint32_t empty0 = static_cast<uint32_t>(__cvta_generic_to_shared(empty));

  const int tid = threadIdx.x, wg = tid >> 7;
  const int KT = K / BK;
  const int n_mb = (M + TM - 1) / TM, n_nb = (N + TN - 1) / TN, n_tiles = n_mb * n_nb;
  // this block's tiles: k = 0, 1, ... for tiles blockIdx.x + k * gridDim.x
  const int n_local = (n_tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);   // the producer's expect_tx arrival (+ bytes)
      mbar_init(empty0 + 8 * s, 8);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // slice kt of the block's k-th tile is slice `it` = k * KT + kt of the
  // ring: its stage it % STAGES, its mbarrier phase it / STAGES.  A stage's
  // panels: 0 A hi, 1 A lo, 2 W hi, 3 W lo
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 0) {
      int it = 0;
      for (int k = 0; k < n_local; ++k) {
        int m0, n0;
        tile_origin(blockIdx.x + k * gridDim.x, n_mb, n_nb, m0, n0);
        for (int kt = 0; kt < KT; ++kt, ++it) {
          const int s = it % STAGES;
          if (it >= STAGES) mbar_wait(empty0 + 8 * s, ((it / STAGES) - 1) & 1);
          const uint32_t bar = full0 + 8 * s, st = base + s * STAGE;
          mbar_expect_tx(bar, 2 * PANEL);
          tma_load_2d(st, &map_a, kt * BK, m0, bar);
          if (W_NK) {
            tma_load_2d(st + 2 * PANEL, &map_w, kt * BK, n0, bar);  // 128 rows of W, K-major
          } else {
#pragma unroll
            for (int b = 0; b < TN / 32; ++b)  // 32 k-rows x 32 columns, unswizzled
              tma_load_2d(st + 3 * PANEL + b * 4096, &map_w, n0 + 32 * b, kt * BK, bar);
          }
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int c = wg - 1, ct = tid - 128;  // consumer, and the thread among the 256
  const int wtid = tid & 127, warp = wtid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const bool releaser = lane == 0;
  const bool biased = mode == kQkv || mode == kResidual || mode == kFcGelu ||
                      mode == kFcGeluSave || mode == kFcGeluGrad ||
                      (mode == kChunkResidual && bias != nullptr);

  for (int k = 0; k < n_local; ++k) {
    int m0, n0;
    tile_origin(blockIdx.x + k * gridDim.x, n_mb, n_nb, m0, n0);
    // no zero-fill: each partial sum's first product is written with
    // scale-d = 0, so no ordinary instruction defines a wgmma register
    float part[64], acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    int it = k * KT;
    for (int kt = 0; kt < KT; ++kt, ++it) {
      const int s = it % STAGES;
      mbar_wait(full0 + 8 * s, (it / STAGES) & 1);
      unsigned char* const st = base_p + s * STAGE;
      // the split, while the previous slice's products run: A's 1,024
      // 16-byte vectors (and a K-major W's) in place, 4 a thread
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int off = 16 * (ct + 256 * i);
        float4 v = *reinterpret_cast<float4*>(st + off);
        const float4 lo = split4(v);
        *reinterpret_cast<float4*>(st + off) = v;
        *reinterpret_cast<float4*>(st + PANEL + off) = lo;
      }
      if (W_NK) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int off = 2 * PANEL + 16 * (ct + 256 * i);
          float4 v = *reinterpret_cast<float4*>(st + off);
          const float4 lo = split4(v);
          *reinterpret_cast<float4*>(st + off) = v;
          *reinterpret_cast<float4*>(st + PANEL + off) = lo;
        }
      } else {
        // W (K, N) transposed: vector i of this thread is column n = ct %
        // 128, k 4q .. 4q + 3 with q = ct / 128 + 2i, read from the
        // unswizzled slice in the lo panel (box n / 32: k-row 128 bytes)
        const int n = ct & 127;
        float4 v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int q = (ct >> 7) + 2 * i;
          const float* col = reinterpret_cast<const float*>(st + 3 * PANEL + (n >> 5) * 4096) +
                             (n & 31);
          v[i] = make_float4(col[(4 * q) * 32], col[(4 * q + 1) * 32], col[(4 * q + 2) * 32],
                             col[(4 * q + 3) * 32]);
        }
        consumers_sync();  // every raw value is read before lo overwrites them
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int q = (ct >> 7) + 2 * i;
          const int off = n * 128 + ((q ^ (n & 7)) << 4);
          const float4 lo = split4(v[i]);
          *reinterpret_cast<float4*>(st + 2 * PANEL + off) = v[i];
          *reinterpret_cast<float4*>(st + 3 * PANEL + off) = lo;
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      consumers_sync();

      const bool fresh = kt % K_PROMOTE == 0;
      if (fresh && kt > 0) {
        // the partial sum of the last K_PROMOTE slices is complete
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] += part[i];
      }
      const uint32_t a = base + s * STAGE + c * 8192, b = base + s * STAGE + 2 * PANEL;
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk) {
        const uint64_t a_hi = smem_desc(a + kk * 32), a_lo = smem_desc(a + PANEL + kk * 32);
        const uint64_t b_hi = smem_desc(b + kk * 32), b_lo = smem_desc(b + PANEL + kk * 32);
        wgmma_tf32(part, a_lo, b_hi, !fresh || kk > 0);
        wgmma_tf32(part, a_hi, b_lo, 1);
        wgmma_tf32(part, a_hi, b_hi, 1);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      // slice `it` stays in flight; slice it-1 is done: release its stage
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      if (kt > 0 && releaser) mbar_arrive(empty0 + 8 * ((it - 1) % STAGES));
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    if (releaser) mbar_arrive(empty0 + 8 * ((it - 1) % STAGES));
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += part[i];

    // the epilogue.  acc[4j + 2h + e]: row 64c + 16warp + g + 8h of the
    // tile, column 8j + 2t + e.  The second operand is loaded whole first,
    // every load in flight before the first store (C may be R)
    const bool has_x = mode == kResidual || mode == kGeluBwd || mode == kMulF32 ||
                       mode == kChunkResidual || mode == kAddF32;
    // chunk_residual without R reads y in place; add_f32 adds to C
    const float* src = (mode == kAddF32 || (mode == kChunkResidual && R == nullptr)) ? C : R;
    float2 x[TN / 8][2];
#pragma unroll
    for (int j = 0; j < TN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + 64 * c + 16 * warp + g + 8 * h, n = n0 + 8 * j + 2 * t;
        x[j][h] = has_x && m < M && n < N ? *reinterpret_cast<const float2*>(src + (size_t)m * N + n)
                                          : make_float2(0.f, 0.f);
      }
#pragma unroll
    for (int j = 0; j < TN / 8; ++j) {
      const int n = n0 + 8 * j + 2 * t;
      if (n >= N) continue;  // N % 8 == 0: the pair lies inside
      const float2 b = biased ? *reinterpret_cast<const float2*>(bias + n) : make_float2(0.f, 0.f);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + 64 * c + 16 * warp + g + 8 * h;
        if (m >= M) continue;
        const size_t off = (size_t)m * N + n;
        const float v[2] = {acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]};
        const float bb[2] = {b.x, b.y}, xx[2] = {x[j][h].x, x[j][h].y};
        float o[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          switch (mode) {
            case kQkv: o[e] = v[e] + bb[e]; break;
            case kResidual: o[e] = xx[e] + (v[e] + bb[e]); break;
            case kFcGelu: o[e] = quick_gelu(v[e] + bb[e]); break;
            case kFcGeluSave: o[e] = v[e] + bb[e]; break;
            case kGeluBwd: o[e] = v[e] * quick_gelu_grad(xx[e]); break;
            case kFcGeluGrad: o[e] = quick_gelu_grad(v[e] + bb[e]); break;
            case kMulF32: o[e] = v[e] * xx[e]; break;
            case kChunkResidual: o[e] = (biased ? xx[e] + bb[e] : xx[e]) + v[e]; break;
            case kAddF32: o[e] = xx[e] + v[e]; break;
            default: o[e] = v[e]; break;  // kStore, kStoreF32
          }
        }
        *reinterpret_cast<float2*>(C + off) = make_float2(o[0], o[1]);
        if (mode == kFcGeluSave)
          *reinterpret_cast<float2*>(C2 + off) = make_float2(quick_gelu(o[0]), quick_gelu(o[1]));
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// the tensor-map encoder cuTensorMapEncodeTiled, found through the runtime (no -lcuda)
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

// a row-major (rows, cols) fp32 matrix whose rows lie ld elements apart, in
// boxes of box_rows x 32 columns: 128-byte swizzled as the wgmma
// descriptors read them, or plain (a forward W, split transposed);
// elements past the matrix load as zeros
bool make_map(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows, int ld,
              bool swizzled) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 4};
  const cuuint32_t box[2] = {32, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(ptr), dims, strides, box,
            estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            swizzled ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool W_NK>
int launch(const float* a, const float* w, const float* b, const float* r, float* c, float* c2,
           int M, int N, int K, int ldw, int mode, cudaStream_t s) {
  // a runtime call first: it makes the device's primary context current in
  // this thread (autograd's backward thread may not have one yet), which
  // the tensor-map encoder below needs
  auto kernel = gemm_f32_kernel<W_NK>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         SMEM);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap map_a, map_w;
  bool ok = make_map(&map_a, a, M, K, TM, K, true);
  ok = ok && (W_NK ? make_map(&map_w, w, N, K, TN, ldw, true)     // W (N, K)
                   : make_map(&map_w, w, K, N, BK, ldw, false));  // W (K, N)
  if (!ok) return (int)cudaErrorInvalidValue;
  static int n_sm = 0;
  if (n_sm == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  }
  const long long n_tiles = (long long)((N + TN - 1) / TN) * ((M + TM - 1) / TM);
  if (n_tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<n_tiles < n_sm ? (int)n_tiles : n_sm, THREADS, SMEM, s>>>(map_a, map_w, b, r, c, c2,
                                                                     M, N, K, mode);
  return (int)cudaGetLastError();
}

}  // namespace

// mode: Epilogue.  A: (M, K).  W: (K, N), or (N, K) for modes 4, 5, 6, 8
// and 10 (B = W^T), its rows ldw elements apart.  bias: (N) for modes 0-3
// and 7, optional for mode 9, else unused.  R: the residual (modes 1 and 9;
// for mode 9 null means C itself, y in place), the saved h (mode 4) or the
// factor F (mode 8), (M, N).  C: (M, N) (mode 10 adds to it).  C2: the
// second output of mode 3.  Every tensor fp32 and 16-byte aligned; K a
// multiple of 32, N of 8, ldw of 4.
extern "C" int gemm_f32_epilogue(const void* A, const void* W, const void* bias, const void* R,
                                 void* C, void* C2, int M, int N, int K, int ldw, int mode,
                                 void* stream) {
  if (mode < kQkv || mode > kAddF32) return (int)cudaErrorInvalidValue;
  const bool w_nk = w_transposed(mode);
  const int w_cols = w_nk ? K : N;
  if (M < 1 || K < BK || K % BK || N < 8 || N % 8 || ldw < w_cols || ldw % 4 ||
      reinterpret_cast<uintptr_t>(W) % 16)
    return (int)cudaErrorInvalidValue;
  const bool biased = mode == kQkv || mode == kResidual || mode == kFcGelu ||
                      mode == kFcGeluSave || mode == kFcGeluGrad;
  if ((biased && bias == nullptr) || (mode == kFcGeluSave && C2 == nullptr) ||
      ((mode == kResidual || mode == kGeluBwd || mode == kMulF32) && R == nullptr))
    return (int)cudaErrorInvalidValue;
  const auto* a = static_cast<const float*>(A);
  const auto* w = static_cast<const float*>(W);
  const auto* b = static_cast<const float*>(bias);
  const auto* r = static_cast<const float*>(R);
  auto* c = static_cast<float*>(C);
  auto* c2 = static_cast<float*>(C2);
  const cudaStream_t s = (cudaStream_t)stream;
  return w_nk ? launch<true>(a, w, b, r, c, c2, M, N, K, ldw, mode, s)
              : launch<false>(a, w, b, r, c, c2, M, N, K, ldw, mode, s);
}
