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
//   On fp32 activations (the Pallas kernels at x.dtype = fp32, where every
//   .astype(x.dtype) is a no-op; gemm_s8_epilogue_f32) the bias is fp32 and
//   the epilogues are
//     qkv       C = v                                        (fp32)
//     residual  C = R + v, one fp32 add, R fp32
//     fc_gelu   g as above; with C2 given, C2 = h = v        (fp32)
//   the qkv, residual and saved-h outputs again bit-equal to the plain
//   version.
//   The floor modes (bf16 only, through ops/probe.py) are the matmul of
//   tools/probe_q8_residual.py's q8_floor ablation (q8_matmul :104-114): no
//   scale, v = f32(acc) + f32(b), then the qkv, residual or (fp32 g)
//   fc_gelu epilogue as above; ws is neither read nor applied.
// Bound on the H100: near the ridge.  At the vision shapes (M = 384*199 =
//   76,416 tokens, K, N in 768..3072) a product does 2*M*N*K int8
//   operations over M*K + N*K + M*N*(1..4) bytes: ~660 operations a byte
//   for qkv and proj (the int8 tensor cores bind above ~590: 1,979 TOP/s
//   over 3.35 TB/s), ~360 for fc with its fp32 output and ~300 for the
//   768 -> 768 out-projection, which are bound by their bytes.
// Design: the bf16 GEMM's skeleton (gemm_bf16_epilogue.cu) with the s8
//   product.  A block owns a 128 x 256 output tile.  One thread of
//   warpgroup 0 keeps a 3-stage ring of 128-byte K slices full with TMA
//   copies (A as boxes of 128 rows, W as boxes of 256 rows, both K-major,
//   the only layout the 8-bit wgmma takes, so no transposed copy exists;
//   128-byte swizzled as the descriptors read them; mbarriers say when a
//   stage is full and when it is free).  Warpgroups 1 and 2 each hold a
//   64 x 256 int32 slab in registers from wgmma m64n256k32.s32.s8.s8,
//   keeping one slice's products in flight while they wait for the next.
//   TMA zero-fills the ragged M, N and K edges (zeros add nothing to the
//   exact sums); N and K must be multiples of 16 (16-byte rows).  The
//   epilogue runs on the int32 registers, the tile's ws and bias columns
//   staged in shared memory and xs read per row; bf16 (qkv, residual, the
//   saved h) and int8 codes are written into a 128-byte-swizzled slab
//   (conflict-free from the fragments) and leave by TMA stores that run on
//   while the next tile's products do, clipped at the matrix's edges; the
//   residual tile arrives in the slab by TMA during the products and is
//   added in place.  The bf16 instances' fp32 g leaves straight from the
//   registers, a quad of lanes writing one whole 32-byte sector of a row.
//   The fp32 instances (F32) keep the products, the ring and the
//   shared-memory budget: a consumer's 64 x 256 fp32 tile (64 KB) would not
//   fit beside the three stages, but the bf16 slab's 32 KB hold two 64 x 64
//   fp32 quarters, so every fp32 output (qkv, R + v, the saved h, the
//   dynamic fc's g) leaves through the slab quarter by quarter, the two
//   buffers in turn: a quarter is written from the fragments (two
//   128-byte-swizzled boxes of 64 rows x 32 fp32), its TMA stores are
//   issued, and the quarter after next waits only until those stores have
//   read the buffer (cp.async.bulk.wait_group.read 1), so writing one
//   quarter overlaps the stores of the one before, and the consumers go on
//   to the next tile's products while the last bytes move.  The residual's
//   R arrives by TMA into the buffers, quarters 0 and 1 during the
//   products, each later one q + 1 into the buffer of quarter q - 1 while
//   quarter q is written; R + v is written in place.  Quarter q - 1's
//   stores are the latest issued when that load is, so the residual
//   instances wait before it until every store has read its buffer
//   (wait_group.read 0), not only the quarter before last's.  The bias columns are staged as fp32 in the bytes the bf16 bias
//   and its padding take (BN x 4 B).  The bf16 instances compute and store
//   exactly what they did before.  Blocks are persistent, one per SM
//   walking the tiles, so the producer loads the
//   next tile while the consumers finish this one; the producer gives up
//   registers (setmaxnreg) for the consumers' epilogue.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

enum Mode { kQkv = 0, kResidual = 1, kFcGelu = 2, kSQkv = 3, kSResidual = 4, kSFcGelu = 5,
            kFQkv = 6, kFResidual = 7, kFFcGelu = 8 };

__host__ __device__ constexpr bool is_static(int mode) { return mode >= kSQkv && mode <= kSFcGelu; }
// the probe's floor: no scale at all
__host__ __device__ constexpr bool is_floor(int mode) { return mode >= kFQkv; }
__host__ __device__ constexpr bool is_fc(int mode) {
  return mode == kFcGelu || mode == kSFcGelu || mode == kFFcGelu;
}
__host__ __device__ constexpr bool is_residual(int mode) {
  return mode == kResidual || mode == kSResidual || mode == kFResidual;
}

constexpr int BM = 128, BN = 256, BK = 128, STAGES = 3;
constexpr int THREADS = 384;  // warpgroup 0 loads, warpgroups 1 and 2 compute
constexpr int STAGE_A = BM * BK, STAGE_B = BN * BK;  // bytes: int8
// each consumer's 64 x 256 output slab, the TMA store's source: four
// 128-byte-swizzled boxes of 64 rows x 128 B (bf16: 64 columns each; int8
// codes: two boxes of 128), then the tile's ws (fp32) and bias (bf16, or
// fp32 in the F32 instances) columns
constexpr int SLAB = 64 * BN * 2, COLS = BN * 8;
constexpr int SMEM_BYTES = STAGES * (STAGE_A + STAGE_B) + 2 * (SLAB + COLS) + 1024;  // + align

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
// completing its bytes on the mbarrier
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// TMA store of a 2-D shared-memory box at (c0 innermost, c1), committed by
// the caller; the box's parts past the matrix are not written
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, uint32_t src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%1, %2}], [%3];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(c1), "r"(src)
      : "memory");
}

// the stores committed so far have read their shared memory
__device__ __forceinline__ void tma_store_read_wait() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// the same for all but the last committed group
__device__ __forceinline__ void tma_store_read_wait_but_last() {
  asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = pred ? 16 : 0;  // 0 source bytes: 16 zero bytes land in smem
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(bytes));
}

// barrier for the 128 threads of one warpgroup (ids 1, 2; 0 is __syncthreads)
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// shared-memory matrix descriptor, 128-byte swizzle (atoms of 8 x 128 B)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

// d (64 x 256 int32 per warpgroup) (+)= A (64 x 32 int8, K-major) . B (32 x
// 256 int8, K-major)
__device__ __forceinline__ void wgmma_s8_m64n256k32(int (&d)[128], uint64_t desc_a,
                                                    uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
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
      "%128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),
        "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]),
        "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]),
        "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
        "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]),
        "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// h * sigmoid(1.702 h) in fp32 with the hardware exp and division (a few
// fp32 ulps): g is held within 2^-15 of its largest value, its codes
// within one step
__device__ __forceinline__ float quick_gelu(float h) {
  return __fdividef(h, 1.0f + __expf(-1.702f * h));
}

__device__ __forceinline__ int8_t quant_static(float v, float r) {
  return static_cast<int8_t>(fminf(fmaxf(rintf(__fmul_rn(v, r)), -127.0f), 127.0f));
}

// the bias columns of a fragment's two outputs (bf16 or fp32 in shared memory)
template <bool F32>
__device__ __forceinline__ float2 bias2(const void* b_s, int cl) {
  if constexpr (F32) {
    return *reinterpret_cast<const float2*>(static_cast<const float*>(b_s) + cl);
  } else {
    return __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(static_cast<const __nv_bfloat16*>(b_s) + cl));
  }
}

// F32: fp32 activations; the bias, R, C (qkv, residual, the dynamic fc's g)
// and C2 (the saved h) are then fp32, every map of 32-column boxes
template <int MODE, bool F32>
__global__ void __launch_bounds__(THREADS, 1)
gemm_s8_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_w,
               const __grid_constant__ CUtensorMap map_c,
               const __grid_constant__ CUtensorMap map_c2,
               const __grid_constant__ CUtensorMap map_r, const float* __restrict__ xs,
               const float* __restrict__ ws, const __nv_bfloat16* __restrict__ bias,
               const float* __restrict__ r, float* __restrict__ G, int save_h, int M, int N,
               int K) {
  constexpr bool kFc = is_fc(MODE);
  constexpr bool kRes = is_residual(MODE);
  extern __shared__ unsigned char smem_raw[];
  // rbar: each consumer's residual slab (two a consumer in F32, one a buffer)
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES], rbar[F32 ? 4 : 2];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t sA = (raw + 1023) & ~1023u;  // swizzle atoms need 1024-byte alignment
  const uint32_t sB = sA + STAGES * STAGE_A;
  const uint32_t full0 = static_cast<uint32_t>(__cvta_generic_to_shared(full));
  const uint32_t empty0 = static_cast<uint32_t>(__cvta_generic_to_shared(empty));
  const uint32_t rbar0 = static_cast<uint32_t>(__cvta_generic_to_shared(rbar));

  const int tid = threadIdx.x, wg = tid >> 7, wtid = tid & 127;
  const int KT = (K + BK - 1) / BK;
  const int n_nb = (N + BN - 1) / BN, n_tiles = n_nb * ((M + BM - 1) / BM);
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);    // the producer's expect_tx arrival (+ bytes)
      mbar_init(empty0 + 8 * s, 8);   // lane 0 of each consumer warp
    }
    for (int b = 0; b < (F32 ? 4 : 2); ++b) mbar_init(rbar0 + 8 * b, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // persistent: each block walks tiles blockIdx.x, +gridDim.x, ... (N
  // fastest, so neighbouring tiles share A rows); `it` counts K slices
  // across tiles, giving each slice its ring stage and mbarrier phase
  if (wg == 0) {
    // producer: one thread keeps the ring full with TMA copies, running
    // ahead into the next tile while the consumers finish this one
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
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
          tma_load_2d(sB + s * STAGE_B, &map_w, kt * BK, n0, bar);
        }
      }
    }
  } else {
    // consumers: warpgroup c computes rows 64c .. 64c+63 of each tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int c = wg - 1;
    const uint32_t slab = sB + STAGES * STAGE_B + c * (SLAB + COLS);  // 4 boxes of 64 x 128 B
    unsigned char* slab_p = smem_raw + (slab - raw);
    float* ws_s = reinterpret_cast<float*>(slab_p + SLAB);  // the tile's ws columns
    __nv_bfloat16* b_s = reinterpret_cast<__nv_bfloat16*>(ws_s + BN);  // and its bias
    float* b32_s = ws_s + BN;  // the F32 instances' fp32 bias, in the same bytes
    const uint32_t my_rbar = rbar0 + 8 * c;
    const uint32_t rb32 = rbar0 + 16 * c;  // F32: the barriers of the two buffers
    const bool releaser = (wtid & 31) == 0;
    const int warp = wtid >> 5, lane = wtid & 31, g = lane >> 2, t = lane & 3;
    const float r3 = MODE == kSFcGelu ? *r : 0.f;
    int it = 0, n_r = 0, n_r1 = 0;  // F32: n_r, n_r1 count the two buffers' phases
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int m0 = (tile / n_nb) * BM, n0 = (tile % n_nb) * BN, mc = m0 + c * 64;
      // the tile's ws and bias columns and its rows' xs are read while the
      // products run (cp.async, zeros past N), once the previous epilogue
      // is done with them
      warpgroup_sync(1 + c);
      if (wtid < BN / 4) {
        const int gc = n0 + 4 * wtid;
        if constexpr (!is_floor(MODE)) cp_async16(ws_s + 4 * wtid, gc < N ? ws + gc : ws, gc < N);
      } else if constexpr (F32) {  // BN / 4 threads, four fp32 bias columns each
        const float* b32 = reinterpret_cast<const float*>(bias);
        const int gc = n0 + 4 * (wtid - BN / 4);
        cp_async16(b32_s + 4 * (wtid - BN / 4), gc < N ? b32 + gc : b32, gc < N);
      } else if (wtid < BN / 4 + BN / 8) {
        const int gc = n0 + 8 * (wtid - BN / 4);
        cp_async16(b_s + 8 * (wtid - BN / 4), gc < N ? bias + gc : bias, gc < N);
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      float xr[2] = {1.f, 1.f};
      if (!is_static(MODE) && !is_floor(MODE)) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int gr = mc + warp * 16 + g + 8 * half;
          xr[half] = gr < M ? xs[gr] : 0.f;
        }
      }
      if (wtid == 0) {
        // the previous tile's stores have read the slab; the residual tile
        // lands in it while the products run
        tma_store_read_wait();
        if (kRes && !F32) {
          mbar_expect_tx(my_rbar, SLAB);
#pragma unroll
          for (int b = 0; b < BN / 64; ++b)
            tma_load_2d(slab + b * 8192, &map_r, n0 + 64 * b, mc, my_rbar);
        }
        if constexpr (F32 && kRes) {  // the fp32 residual's first two quarters
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            if (n0 + 64 * q >= N) break;
            mbar_expect_tx(rb32 + 8 * q, SLAB / 2);
#pragma unroll
            for (int k = 0; k < 2; ++k)
              tma_load_2d(slab + q * 16384 + k * 8192, &map_r, n0 + 64 * q + 32 * k, mc,
                          rb32 + 8 * q);
          }
        }
      }
      // no zero-fill: the first products are written with scale-d = 0
      int d[BN / 2];
      for (int kt = 0; kt < KT; ++kt, ++it) {
        const int s = it % STAGES;
        mbar_wait(full0 + 8 * s, (it / STAGES) & 1);
        const uint32_t a = sA + s * STAGE_A + c * 64 * BK;
        const uint32_t b = sB + s * STAGE_B;
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int k = 0; k < BK / 32; ++k)  // 32 bytes further along the 128-byte rows
          wgmma_s8_m64n256k32(d, smem_desc(a + k * 32, 16, 1024), smem_desc(b + k * 32, 16, 1024),
                              kt > 0 || k > 0);
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        // slice `it` stays in flight; slice it-1 is done: release its stage
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        if (kt > 0 && releaser) mbar_arrive(empty0 + 8 * ((it - 1) % STAGES));
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      if (releaser) mbar_arrive(empty0 + 8 * ((it - 1) % STAGES));

      asm volatile("cp.async.wait_all;\n" ::: "memory");
      warpgroup_sync(1 + c);  // every thread's ws and bias copies have landed
      // v of fragment element e (row half e >> 1) of column group j
      auto dequant = [&](int j, int e, float w, float bb) {
        float a = __int2float_rn(d[4 * j + e]);
        if (is_floor(MODE)) return __fadd_rn(a, bb);
        if (!is_static(MODE)) a = __fmul_rn(a, xr[e >> 1]);
        return __fadd_rn(__fmul_rn(a, w), bb);
      };
      // the slab out by TMA: boxes of 64 rows x 128 B; rows and columns
      // past the matrix are not written
      auto store_slab = [&](const CUtensorMap* map, int box_cols) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        warpgroup_sync(1 + c);
        if (wtid == 0) {
          for (int b = 0; b < BN / box_cols; ++b)
            tma_store_2d(map, slab + b * 8192, n0 + box_cols * b, mc);
          asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        }
      };

      if constexpr (F32) {
        // fp32 element (row rl, column cl) of quarter cl / 64 in buffer bf:
        // box (cl % 64) / 32, chunk (cl % 32) / 4 ^ rl % 8; a fragment's
        // pair (columns 8j + 2t, + 1) is one 8-byte slot
        auto slot = [&](int bf, int j, int rl) {
          return reinterpret_cast<float2*>(slab_p + bf * 16384 + ((j & 7) >> 2) * 8192 +
                                           rl * 128 +
                                           (((2 * (j & 3) + (t >> 1)) ^ (rl & 7)) << 4) +
                                           (t & 1) * 8);
        };
        const int nq = min(BN / 64, (N - n0 + 63) / 64);  // quarters holding columns of C
        int piece = 0;  // quarters written into the slab this tile
        // every quarter of one output: v (qkv, R + v, the saved h) or g
        auto put = [&](const CUtensorMap* map, bool gelu) {
#pragma unroll
          for (int q = 0; q < BN / 64; ++q) {
            if (q >= nq) break;
            const int bf = piece & 1;
            if (kRes) {
              // R's quarter q + 1 lands in the buffer of quarter q - 1 once
              // that quarter's stores, the latest issued, have read it (so
              // every store's: read 0); quarter q's is waited for
              if (q >= 1 && q + 1 < nq && wtid == 0) {
                tma_store_read_wait();
                const uint32_t bar = rb32 + 8 * ((q + 1) & 1);
                mbar_expect_tx(bar, SLAB / 2);
#pragma unroll
                for (int k = 0; k < 2; ++k)
                  tma_load_2d(slab + ((q + 1) & 1) * 16384 + k * 8192, &map_r,
                              n0 + 64 * (q + 1) + 32 * k, mc, bar);
              }
              mbar_wait(rb32 + 8 * (q & 1), ((q & 1) ? n_r1 : n_r) & 1);
              if (q & 1) ++n_r1; else ++n_r;
            } else if (piece >= 2) {
              // the quarter before last's stores have read this buffer
              if (wtid == 0) tma_store_read_wait_but_last();
              warpgroup_sync(1 + c);
            }
#pragma unroll
            for (int jj = 0; jj < 8; ++jj) {
              const int j = 8 * q + jj, cl = 8 * j + 2 * t;
              const float2 w2 = *reinterpret_cast<const float2*>(ws_s + cl);
              const float2 b2 = bias2<true>(b32_s, cl);
#pragma unroll
              for (int half = 0; half < 2; ++half) {
                float2* sl = slot(bf, j, warp * 16 + g + 8 * half);
                float v0 = dequant(j, 2 * half, w2.x, b2.x);
                float v1 = dequant(j, 2 * half + 1, w2.y, b2.y);
                if (gelu) {
                  v0 = quick_gelu(v0);
                  v1 = quick_gelu(v1);
                } else if (kRes) {  // C = R + v, one fp32 add
                  const float2 r2 = *sl;
                  v0 = __fadd_rn(r2.x, v0);
                  v1 = __fadd_rn(r2.y, v1);
                }
                *sl = make_float2(v0, v1);
              }
            }
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            warpgroup_sync(1 + c);
            if (wtid == 0) {
#pragma unroll
              for (int k = 0; k < 2; ++k)
                tma_store_2d(map, slab + bf * 16384 + k * 8192, n0 + 64 * q + 32 * k, mc);
              asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
            }
            ++piece;
          }
        };
        if (!kFc || save_h) put(kFc ? &map_c2 : &map_c, false);
        if constexpr (MODE == kFcGelu) put(&map_c, true);  // g, quantized by quant_rows next
      } else if (!kFc || save_h) {
        // bf16(v): the qkv and residual outputs, or the saved h of the fc modes
        // (bf16 element (row, col) at box col / 64, chunk (col % 64) / 8 ^ row % 8)
        if (kRes) {
          mbar_wait(my_rbar, n_r & 1);
          ++n_r;
        }
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int cl = 8 * j + 2 * t;
          const float2 w2 = *reinterpret_cast<const float2*>(ws_s + cl);
          const float2 b2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b_s + cl));
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int rl = warp * 16 + g + 8 * half;
            __nv_bfloat162* slot = reinterpret_cast<__nv_bfloat162*>(
                slab_p + (j >> 3) * 8192 + rl * 128 + (((j & 7) ^ (rl & 7)) << 4) + t * 4);
            float v0 = dequant(j, 2 * half, w2.x, b2.x), v1 = dequant(j, 2 * half + 1, w2.y, b2.y);
            if (kRes) {  // C = R + bf16(v), one rounding of the bf16 sum
              const float2 r2 = __bfloat1622float2(*slot);
              v0 = __fadd_rn(r2.x, bf16_round(v0));
              v1 = __fadd_rn(r2.y, bf16_round(v1));
            }
            *slot = __floats2bfloat162_rn(v0, v1);
          }
        }
        store_slab(kFc ? &map_c2 : &map_c, 64);
      }
      if ((MODE == kFcGelu || MODE == kFFcGelu) && !F32) {
        // g in fp32 straight from the registers: a quad writes 32 bytes of a row
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int cl = 8 * j + 2 * t;
          const float2 w2 = *reinterpret_cast<const float2*>(ws_s + cl);
          const float2 b2 = bias2<false>(b_s, cl);
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int gr = mc + warp * 16 + g + 8 * half, gc = n0 + cl;
            const float g0 = quick_gelu(dequant(j, 2 * half, w2.x, b2.x));
            const float g1 = quick_gelu(dequant(j, 2 * half + 1, w2.y, b2.y));
            if (gr < M && gc < N)
              *reinterpret_cast<float2*>(G + (size_t)gr * N + gc) = make_float2(g0, g1);
          }
        }
      } else if (MODE == kSFcGelu) {
        // int8 codes of g through the slab (byte (row, col) at box col / 128,
        // chunk (col % 128) / 16 ^ row % 8), once the saved h has left it
        if (save_h) {
          if (wtid == 0) tma_store_read_wait();
          warpgroup_sync(1 + c);
        }
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int cl = 8 * j + 2 * t;
          const float2 w2 = *reinterpret_cast<const float2*>(ws_s + cl);
          const float2 b2 = bias2<F32>(F32 ? static_cast<const void*>(b32_s) : b_s, cl);
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int rl = warp * 16 + g + 8 * half;
            char2 q;
            q.x = quant_static(quick_gelu(dequant(j, 2 * half, w2.x, b2.x)), r3);
            q.y = quant_static(quick_gelu(dequant(j, 2 * half + 1, w2.y, b2.y)), r3);
            const int chunk = ((j & 15) >> 1) ^ (rl & 7);
            *reinterpret_cast<char2*>(slab_p + (j >> 4) * 8192 + rl * 128 + (chunk << 4) +
                                      8 * (j & 1) + 2 * t) = q;
          }
        }
        store_slab(&map_c, 128);
      }
    }
    if (wtid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
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

// a row-major (rows, cols) matrix of 1-, 2- or 4-byte elements (int8,
// bf16, fp32) in boxes of box_rows x 128 bytes, 128-byte swizzled (the wgmma
// descriptors' layout, and the epilogue slab's); out-of-range elements load
// as zeros and are not stored
bool make_map(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows, int elem) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem};
  const cuuint32_t box[2] = {(cuuint32_t)(128 / elem), (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  const CUtensorMapDataType type = elem == 4   ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                   : elem == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                               : CU_TENSOR_MAP_DATA_TYPE_UINT8;
  return fn(map, type, 2, const_cast<void*>(ptr), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int MODE, bool F32>
int launch(const int8_t* a, const int8_t* w, const float* xs, const float* ws, const void* b,
           const void* R, const float* r, void* c, void* c2, int M, int N, int K,
           cudaStream_t s) {
  // a runtime call first: it makes the device's primary context current in
  // this thread, which the CUDA driver API's tensor-map encoder below needs
  auto kernel = gemm_s8_kernel<MODE, F32>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  // by TMA: C as int8 codes (static fc), else in the activation dtype, but
  // the bf16 instances' dynamic fc g (fp32, by pointer); C2 (the saved h)
  // and R in the activation dtype.  Unused maps stay zero
  if (is_residual(MODE) && R == nullptr) return (int)cudaErrorInvalidValue;
  const int act = F32 ? 4 : 2;
  CUtensorMap map_a, map_w, map_c = {}, map_c2 = {}, map_r = {};
  bool ok = make_map(&map_a, a, M, K, BM, 1) && make_map(&map_w, w, N, K, BN, 1);
  if (MODE == kSFcGelu) ok = ok && make_map(&map_c, c, M, N, 64, 1);
  else if ((MODE != kFcGelu && MODE != kFFcGelu) || F32) ok = ok && make_map(&map_c, c, M, N, 64, act);
  if (c2 != nullptr) ok = ok && make_map(&map_c2, c2, M, N, 64, act);
  if (R != nullptr) ok = ok && make_map(&map_r, R, M, N, 64, act);
  if (!ok) return (int)cudaErrorInvalidValue;
  static int n_sm = 0;
  if (n_sm == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  }
  const int n_tiles = ((N + BN - 1) / BN) * ((M + BM - 1) / BM);
  kernel<<<n_tiles < n_sm ? n_tiles : n_sm, THREADS, SMEM_BYTES, s>>>(
      map_a, map_w, map_c, map_c2, map_r, xs, ws, static_cast<const __nv_bfloat16*>(b), r,
      static_cast<float*>(c), c2 != nullptr, M, N, K);
  return (int)cudaGetLastError();
}

template <bool F32>
int dispatch(const void* A, const void* W, const void* xs, const void* ws, const void* bias,
             const void* R, const void* r, void* C, void* C2, int M, int N, int K, int mode,
             void* stream) {
  if (M < 1 || N < 16 || K < 16 || N % 16 || K % 16) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const auto* a = static_cast<const int8_t*>(A);
  const auto* w = static_cast<const int8_t*>(W);
  const auto* x = static_cast<const float*>(xs);
  const auto* wsc = static_cast<const float*>(ws);
  const auto* rr = static_cast<const float*>(r);
  switch (mode) {
    case kQkv: return launch<kQkv, F32>(a, w, x, wsc, bias, R, rr, C, C2, M, N, K, s);
    case kResidual: return launch<kResidual, F32>(a, w, x, wsc, bias, R, rr, C, C2, M, N, K, s);
    case kFcGelu: return launch<kFcGelu, F32>(a, w, x, wsc, bias, R, rr, C, C2, M, N, K, s);
    case kSQkv: return launch<kSQkv, F32>(a, w, x, wsc, bias, R, rr, C, C2, M, N, K, s);
    case kSResidual: return launch<kSResidual, F32>(a, w, x, wsc, bias, R, rr, C, C2, M, N, K, s);
    case kSFcGelu: return launch<kSFcGelu, F32>(a, w, x, wsc, bias, R, rr, C, C2, M, N, K, s);
    default: break;
  }
  if constexpr (!F32) {  // the floor modes take bf16 activations only
    switch (mode) {
      case kFQkv: return launch<kFQkv, F32>(a, w, x, wsc, bias, R, rr, C, C2, M, N, K, s);
      case kFResidual: return launch<kFResidual, F32>(a, w, x, wsc, bias, R, rr, C, C2, M, N, K, s);
      case kFFcGelu: return launch<kFFcGelu, F32>(a, w, x, wsc, bias, R, rr, C, C2, M, N, K, s);
      default: break;
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// A (M, K) int8; W (N, K) int8; xs (M) fp32 row scales (dynamic modes
// 0-2, else unused); ws (N) fp32 column scales (unused in the floor modes
// 6-8); bias (N) bf16; R (M, N) bf16 residual (modes 1, 4, 7); r one fp32
// multiplier (mode 5).  C (M, N): bf16 (modes 0, 1, 3, 4, 6, 7), fp32 (2,
// 8) or int8 (5); C2 (M, N) bf16 h for the fc modes 2, 5 and 8, or null.
// Every pointer 16-byte aligned; N and K multiples of 16.
extern "C" int gemm_s8_epilogue(const void* A, const void* W, const void* xs, const void* ws,
                                const void* bias, const void* R, const void* r, void* C,
                                void* C2, int M, int N, int K, int mode, void* stream) {
  return dispatch<false>(A, W, xs, ws, bias, R, r, C, C2, M, N, K, mode, stream);
}

// The same on fp32 activations: bias (N), R (M, N), C (modes 0-2) and C2
// (the saved h) fp32; C int8 codes in mode 5.
extern "C" int gemm_s8_epilogue_f32(const void* A, const void* W, const void* xs,
                                    const void* ws, const void* bias, const void* R,
                                    const void* r, void* C, void* C2, int M, int N, int K,
                                    int mode, void* stream) {
  return dispatch<true>(A, W, xs, ws, bias, R, r, C, C2, M, N, K, mode, stream);
}
