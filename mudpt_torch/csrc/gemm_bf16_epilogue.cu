// gemm_bf16_epilogue: C[M,N] = epilogue(A[M,K] . B[K,N]), bf16 operands,
// fp32 accumulation.  B is W in its (in, out) = (K, N) row-major layout for
// the forward epilogues, and W^T for the backward ones, with W (N, K)
// row-major: the layer's weights are used in their stored layout both ways.
//
// Replaces: the projections of the TPU layer kernels in
//   mudpt_tpu/ops/fused_block.py, each epilogue rounding to bf16 at the
//   same points as the Pallas code (the half-blocks' kernels, :318-456,
//   run the same projections as the layer's):
//   _layer_fwd_nosave_kernel (:851-865) and _layer_fwd_kernel (:831-848):
//   qkv          _attn_project  (:301-307)  C = bf16(bf16(acc) + bf16(b))
//   out-proj     _attn_finish   (:310-315)  C = R + bf16(bf16(acc) + b)
//   fc           _mlp_pre + QuickGELU (:392-400, :860)
//                                           C = bf16(g(acc + f32(b))), g(h) = h*sigmoid(1.702h)
//   fc, saving   (:841-843)                 C = bf16(h32), C2 = bf16(g(h32)), h32 = acc + f32(b)
//   proj         (:861-865)                 C = R + bf16(bf16(acc) + b)
//   _layer_bwd_kernel (:868-880), through _mlp_bwd_core (:429) and
//   _attn_bwd_core (:336), all four reading W transposed:
//   g.proj_w^T   (:430-434)                 C = bf16(acc * g'(f32(H))), H the saved h
//   dh.fc_w^T    (:435-438)                 C = acc (fp32)
//   dy1.out_w^T  (:340-343, :274-275)       C = bf16(acc)
//   dqkv.qkv_w^T (:349-352)                 C = acc (fp32)
//   and the recompute backward of the MLP half, _mlp_bwd_kernel (:444),
//   whose QuickGELU' takes the fp32 h32 = acc + f32(b) never rounded:
//   fc, gradient (:447, :434)               C = g'(acc + f32(b)) (fp32)
//   g.proj_w^T   (:430-434)                 C = bf16(acc * F), F the fp32 tile above
//   so the kernel and its plain version differ only in the order of the
//   fp32 sums (and the hardware exp and division of g and g').
// Bound on the H100: tensor-core operations.  At the vision shapes
//   (M = 384*199 = 76,416 tokens, K, N in 768..3072) a product does
//   2*M*N*K operations over (M*K + K*N + M*N)*2 bytes, i.e. hundreds of
//   operations per byte, above the ~295 where bf16 tensor cores bind.
// Design: Hopper's warpgroup MMA, fed by TMA, warp-specialized.  A block
//   owns a 128 x 256 output tile.  One thread of warpgroup 0 keeps a 3-stage
//   ring of 64-wide K slices full with TMA copies (A as K-major boxes of
//   128 x 64; a (K, N) W as N-major boxes of 64 x 64, read through the
//   descriptor's transpose bit; an (N, K) W as one K-major box of 256 x 64,
//   wgmma's native B layout; all 128-byte swizzled as the wgmma
//   descriptors read them, so no transposed copy of a weight exists);
//   mbarriers say when a stage is full and when it is free again.
//   Warpgroups 1 and 2 each accumulate a 64 x 256 slab in registers with
//   wgmma m64n256k16 straight from shared memory, keeping one slice's
//   products in flight while they wait for the next.  TMA zero-fills the
//   ragged M edge, which the store masks; N must be a multiple of 8 and K
//   of 64.  The bf16 epilogues run on the accumulator registers and leave
//   through a shared-memory slab in 16-byte rows (the residual read the
//   same way; the saved h copied into the slab by cp.async while the
//   products run, and read back at the fragment positions; the saving fc
//   epilogue's h stored straight from the registers beside it).  The fp32
//   epilogues store straight from the registers: a quad of lanes writes 32
//   contiguous bytes of a row, a whole sector, and a staged fp32 tile would
//   need 64 KB more shared memory than the 3-stage ring leaves (216,064 of
//   232,448 bytes are in use); for the same reason the fp32 factor F of
//   the recompute backward is read at the fragment positions, a sector per
//   quad, not staged.  Blocks are persistent, one per SM walking the tiles,
//   so the producer loads the next tile while the consumers store this one.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

enum Epilogue {
  kQkv = 0, kResidual = 1, kFcGelu = 2, kFcGeluSave = 3,  // B = W, W (K, N)
  kGeluBwd = 4, kStoreBf16 = 5, kStoreF32 = 6,               // B = W^T, W (N, K)
  kFcGeluGrad = 7,                                            // B = W
  kMulF32 = 8                                                 // B = W^T
};

__host__ __device__ constexpr bool w_transposed(int mode) {
  return mode == kGeluBwd || mode == kStoreBf16 || mode == kStoreF32 || mode == kMulF32;
}
__host__ __device__ constexpr bool biased(int mode) {
  return mode <= kFcGeluSave || mode == kFcGeluGrad;
}
__host__ __device__ constexpr bool f32_out(int mode) {
  return mode == kStoreF32 || mode == kFcGeluGrad;
}

// mbarrier helpers (shared-window addresses)
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
// completing `bytes` on the mbarrier
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = pred ? 16 : 0;  // 0 source bytes: 16 zero bytes land in smem
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(bytes));
}

// a 128 x 256 tile, 64-wide K slices, a 3-stage ring: the fastest of the
// tile and ring shapes measured at the serving shapes (PERF.md)
constexpr int BM = 128, BN = 256, BK = 64, STAGES = 3;
constexpr int THREADS = 384;  // warpgroup 0 loads, warpgroups 1 and 2 compute
// one stage: A 128 rows x 128 B (K-major), W 64 k-rows x 512 B (N-major)
constexpr int STAGE_A = BM * BK * 2, STAGE_B = BK * BN * 2;
// each consumer stages its 64 x 256 output slab for 16-byte stores; 8 bf16
// of padding per row keep the fragment-pattern writes on distinct banks
constexpr int OUT_LD = BN + 8;
constexpr int SMEM_BYTES = STAGES * (STAGE_A + STAGE_B) + BM * OUT_LD * 2 + 1024;  // + align

// barrier for the 128 threads of one warpgroup (ids 1, 2; 0 is __syncthreads)
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// shared-memory matrix descriptor, 128-byte swizzle (atoms of 8 x 128 B)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

// d (64 x 256 fp32 per warpgroup) += A (64 x 16, K-major) . B (16 x 256),
// B N-major (TRANS_B = 1) or K-major (TRANS_B = 0)
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t desc_a,
                                                 uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, %131;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TRANS_B));
}

// hardware exp and division (a few fp32 ulps), far below the bf16 rounding
__device__ __forceinline__ float quick_gelu(float h) {
  return __fdividef(h, 1.0f + __expf(-1.702f * h));
}

__device__ __forceinline__ float quick_gelu_grad(float h) {
  const float s = __fdividef(1.0f, 1.0f + __expf(-1.702f * h));
  return s + 1.702f * h * s * (1.0f - s);
}

template <int MODE>
__global__ void __launch_bounds__(THREADS, 1)
gemm_bf16_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_w,
                 const __nv_bfloat16* __restrict__ bias, const void* __restrict__ R_,
                 void* __restrict__ C, __nv_bfloat16* __restrict__ C2, int M, int N, int K) {
  constexpr bool kWt = w_transposed(MODE);  // B = W^T, W (N, K): K-major B
  constexpr bool kBias = biased(MODE);
  const __nv_bfloat16* R = static_cast<const __nv_bfloat16*>(R_);  // residual or h
  const float* F = static_cast<const float*>(R_);                  // kMulF32's factor
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t sA = (raw + 1023) & ~1023u;  // swizzle atoms need 1024-byte alignment
  const uint32_t sB = sA + STAGES * STAGE_A;
  const uint32_t full0 = static_cast<uint32_t>(__cvta_generic_to_shared(full));
  const uint32_t empty0 = static_cast<uint32_t>(__cvta_generic_to_shared(empty));

  const int tid = threadIdx.x, wg = tid >> 7, wtid = tid & 127;
  const int KT = K / BK;
  const int n_nb = (N + BN - 1) / BN, n_tiles = n_nb * ((M + BM - 1) / BM);
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);    // the producer's expect_tx arrival (+ bytes)
      mbar_init(empty0 + 8 * s, 8);   // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // persistent: each block walks tiles blockIdx.x, +gridDim.x, ... (N
  // fastest, so neighbouring tiles share A rows); `it` counts K slices
  // across tiles, giving each slice its ring stage and mbarrier phase
  if (wg == 0) {
    // producer: one thread keeps the ring full with TMA copies, running
    // ahead into the next tile while the consumers store this one
    if (tid == 0) {
      int it = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int m0 = (tile / n_nb) * BM, n0 = (tile % n_nb) * BN;
        for (int kt = 0; kt < KT; ++kt, ++it) {
          const int s = it % STAGES;
          if (it >= STAGES) mbar_wait(empty0 + 8 * s, ((it / STAGES) - 1) & 1);
          const uint32_t bar = full0 + 8 * s;
          mbar_expect_tx(bar, STAGE_A + STAGE_B);
          tma_load_2d(sA + s * STAGE_A, &map_a, kt * BK, m0, bar);
          if (kWt) {
            // W rows n0 .. n0+255, K columns of this slice: 256 x 128 B
            tma_load_2d(sB + s * STAGE_B, &map_w, kt * BK, n0, bar);
          } else {
#pragma unroll
            for (int nb = 0; nb < BN / 64; ++nb)
              tma_load_2d(sB + s * STAGE_B + nb * BK * 128, &map_w, n0 + 64 * nb, kt * BK, bar);
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup c computes rows 64c .. 64c+63 of each tile
  const int c = wg - 1;
  __nv_bfloat16* slab =
      reinterpret_cast<__nv_bfloat16*>(smem_raw + (sB + STAGES * STAGE_B - raw)) + c * 64 * OUT_LD;
  const bool releaser = (wtid & 31) == 0;
  const int warp = wtid >> 5, lane = wtid & 31;
  int it = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int m0 = (tile / n_nb) * BM, n0 = (tile % n_nb) * BN;
    if (MODE == kGeluBwd) {
      // the saved h tile into the slab with cp.async, in flight during the
      // products; read back at the fragment positions in the epilogue
      warpgroup_sync(1 + c);  // the previous tile's copy-out is done with the slab
      for (int i = wtid; i < 64 * (BN / 8); i += 128) {
        const int rl = i / (BN / 8), cl = (i % (BN / 8)) * 8;
        const int gr = m0 + c * 64 + rl, gc = n0 + cl;
        const bool ok = gr < M && gc < N;
        cp_async16(slab + rl * OUT_LD + cl, ok ? R + (size_t)gr * N + gc : R, ok);
      }
      asm volatile("cp.async.commit_group;\n" ::);
    }
    // no zero-fill: the first products are written with scale-d = 0, so no
    // ordinary instruction defines an accumulator register, which would
    // serialize the wgmma pipeline
    float d[BN / 2];
    for (int kt = 0; kt < KT; ++kt, ++it) {
      const int s = it % STAGES;
      mbar_wait(full0 + 8 * s, (it / STAGES) & 1);
      const uint32_t a = sA + s * STAGE_A + c * 64 * 128;
      const uint32_t b = sB + s * STAGE_B;
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int k = 0; k < BK / 16; ++k) {
        // A (and a K-major B): 32 bytes further along the 128-byte row;
        // an N-major B: two k-groups further
        if (kWt) {
          wgmma_m64n256k16<0>(d, smem_desc(a + k * 32, 16, 1024),
                              smem_desc(b + k * 32, 16, 1024), kt > 0 || k > 0);
        } else {
          wgmma_m64n256k16<1>(d, smem_desc(a + k * 32, 16, 1024),
                              smem_desc(b + k * 2048, BK * 128, 1024), kt > 0 || k > 0);
        }
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      // slice `it` stays in flight; slice it-1 is done: release its stage
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      if (kt > 0 && releaser) mbar_arrive(empty0 + 8 * ((it - 1) % STAGES));
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    if (releaser) mbar_arrive(empty0 + 8 * ((it - 1) % STAGES));

    // d[4j + 0..1]: row 16*warp + lane/4, cols 8j + 2*(lane%4) + 0..1;
    // d[4j + 2..3]: row + 8
    if (f32_out(MODE)) {
      float* Cf = static_cast<float*>(C);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int gc = n0 + j * 8 + 2 * (lane & 3);
        float bb[2] = {0.f, 0.f};
        if (kBias && gc < N) {
          const __nv_bfloat162 b2 = *reinterpret_cast<const __nv_bfloat162*>(bias + gc);
          bb[0] = __low2float(b2);
          bb[1] = __high2float(b2);
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int gr = m0 + c * 64 + warp * 16 + (lane >> 2) + half * 8;
          float v0 = d[4 * j + 2 * half], v1 = d[4 * j + 2 * half + 1];
          if (MODE == kFcGeluGrad) {
            v0 = quick_gelu_grad(v0 + bb[0]);
            v1 = quick_gelu_grad(v1 + bb[1]);
          }
          if (gr < M && gc < N)
            *reinterpret_cast<float2*>(Cf + (size_t)gr * N + gc) = make_float2(v0, v1);
        }
      }
      continue;
    }

    // bf16 epilogues: math on the registers, the results through the
    // shared-memory slab, then 16-byte rows out (with the residual added
    // there, in 16-byte reads); the saving fc epilogue's h leaves straight
    // from the registers, a quad of lanes writing 16 contiguous bytes
    if (MODE == kGeluBwd) asm volatile("cp.async.wait_group 0;\n" ::);
    warpgroup_sync(1 + c);  // the slab is free (or holds this tile's h)
    __nv_bfloat16* Cb = static_cast<__nv_bfloat16*>(C);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int cl = j * 8 + 2 * (lane & 3);
      float bb[2] = {0.f, 0.f};
      if (kBias && n0 + cl < N) {
        const __nv_bfloat162 b2 = *reinterpret_cast<const __nv_bfloat162*>(bias + n0 + cl);
        bb[0] = __low2float(b2);
        bb[1] = __high2float(b2);
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int rl = warp * 16 + (lane >> 2) + half * 8;
        __nv_bfloat162* slot = reinterpret_cast<__nv_bfloat162*>(slab + rl * OUT_LD + cl);
        float hv[2] = {0.f, 0.f};
        if (MODE == kGeluBwd) {
          const float2 h2 = __bfloat1622float2(*slot);
          hv[0] = h2.x;
          hv[1] = h2.y;
        } else if (MODE == kMulF32) {
          const int gr = m0 + c * 64 + rl;
          if (gr < M && n0 + cl < N) {
            const float2 f2 = *reinterpret_cast<const float2*>(F + (size_t)gr * N + n0 + cl);
            hv[0] = f2.x;
            hv[1] = f2.y;
          }
        }
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float acc = d[4 * j + 2 * half + e];
          if (MODE == kQkv || MODE == kResidual) {
            v[e] = bf16_round(acc) + bb[e];  // kResidual: + R, after this rounds to bf16
          } else if (MODE == kFcGelu || MODE == kFcGeluSave) {
            hv[e] = acc + bb[e];
            v[e] = quick_gelu(hv[e]);
          } else if (MODE == kGeluBwd) {
            v[e] = acc * quick_gelu_grad(hv[e]);
          } else if (MODE == kMulF32) {
            v[e] = acc * hv[e];
          } else {
            v[e] = acc;  // kStoreBf16
          }
        }
        if (MODE == kFcGeluSave) {
          const int gr = m0 + c * 64 + rl;
          if (gr < M && n0 + cl < N)
            *reinterpret_cast<__nv_bfloat162*>(Cb + (size_t)gr * N + n0 + cl) =
                __floats2bfloat162_rn(hv[0], hv[1]);
        }
        *slot = __floats2bfloat162_rn(v[0], v[1]);
      }
    }
    warpgroup_sync(1 + c);
    __nv_bfloat16* out = MODE == kFcGeluSave ? C2 : Cb;
    for (int i = wtid; i < 64 * (BN / 8); i += 128) {
      const int rl = i / (BN / 8), cl = (i % (BN / 8)) * 8;
      const int gr = m0 + c * 64 + rl, gc = n0 + cl;
      if (gr >= M || gc >= N) continue;
      uint4 v = *reinterpret_cast<const uint4*>(slab + rl * OUT_LD + cl);
      if (MODE == kResidual) {
        const uint4 r = *reinterpret_cast<const uint4*>(R + (size_t)gr * N + gc);
        __nv_bfloat162* vp = reinterpret_cast<__nv_bfloat162*>(&v);
        const __nv_bfloat162* rp = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 a2 = __bfloat1622float2(vp[e]), r2 = __bfloat1622float2(rp[e]);
          vp[e] = __floats2bfloat162_rn(r2.x + a2.x, r2.y + a2.y);
        }
      }
      *reinterpret_cast<uint4*>(out + (size_t)gr * N + gc) = v;
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, found through the runtime (no -lcuda)
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

// a row-major (rows, cols) bf16 matrix read in boxes of box_rows x 64
// columns, 128-byte swizzled as the wgmma descriptors expect
bool make_map(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int MODE>
int launch(const __nv_bfloat16* a, const __nv_bfloat16* w, const __nv_bfloat16* b,
           const void* r, void* c, __nv_bfloat16* c2, int M, int N, int K, cudaStream_t s) {
  if (K % BK || N % 8) return (int)cudaErrorInvalidValue;
  CUtensorMap map_a, map_w;
  const bool w_ok = w_transposed(MODE) ? make_map(&map_w, w, N, K, BN)   // W (N, K)
                                       : make_map(&map_w, w, K, N, BK);  // W (K, N)
  if (!make_map(&map_a, a, M, K, BM) || !w_ok) return (int)cudaErrorInvalidValue;
  auto kernel = gemm_bf16_kernel<MODE>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  static int n_sm = 0;
  if (n_sm == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  }
  const int n_tiles = ((N + BN - 1) / BN) * ((M + BM - 1) / BM);
  kernel<<<n_tiles < n_sm ? n_tiles : n_sm, THREADS, SMEM_BYTES, s>>>(map_a, map_w, b, r, c, c2,
                                                                    M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace

// mode: Epilogue.  bias: (N) bf16 for modes 0-3 and 7, else unused.  R: the
// residual (mode 1) or the saved h (mode 4), (M, N) bf16; the factor F
// (mode 8), (M, N) fp32.  C: (M, N), fp32 for modes 6 and 7, else bf16.
// C2: the second output of mode 3.
extern "C" int gemm_bf16_epilogue(const void* A, const void* W, const void* bias,
                                  const void* R, void* C, void* C2, int M, int N, int K,
                                  int mode, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const auto* a = static_cast<const __nv_bfloat16*>(A);
  const auto* w = static_cast<const __nv_bfloat16*>(W);
  const auto* b = static_cast<const __nv_bfloat16*>(bias);
  auto* c2 = static_cast<__nv_bfloat16*>(C2);
  switch (mode) {
    case kQkv: return launch<kQkv>(a, w, b, R, C, c2, M, N, K, s);
    case kResidual: return launch<kResidual>(a, w, b, R, C, c2, M, N, K, s);
    case kFcGelu: return launch<kFcGelu>(a, w, b, R, C, c2, M, N, K, s);
    case kFcGeluSave: return launch<kFcGeluSave>(a, w, b, R, C, c2, M, N, K, s);
    case kGeluBwd: return launch<kGeluBwd>(a, w, b, R, C, c2, M, N, K, s);
    case kStoreBf16: return launch<kStoreBf16>(a, w, b, R, C, c2, M, N, K, s);
    case kStoreF32: return launch<kStoreF32>(a, w, b, R, C, c2, M, N, K, s);
    case kFcGeluGrad: return launch<kFcGeluGrad>(a, w, b, R, C, c2, M, N, K, s);
    case kMulF32: return launch<kMulF32>(a, w, b, R, C, c2, M, N, K, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
