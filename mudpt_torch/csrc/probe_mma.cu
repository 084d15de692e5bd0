// probe_mma: out[S, DO] = sum_{g < G} sum_{i < ITERS} x_i . W, bf16 x bf16
// -> fp32 or s8 x s8 -> s32, on the tensor cores: the rate probe.
//
// Replaces: mm_kernel of tools/probe_int8_mxu.py (:41, launched by
//   pl.pallas_call at :81).  Each of its G sequential grid steps contracts
//   ITERS = 16 different x slices against one W (so no step can be folded
//   away) and adds their sum into the output; the rate is the work over the
//   time between two grid sizes, so per-call overhead cancels.  Here the G
//   steps are a loop inside the kernel, not G launches.
//   s8: the int32 sum wraps mod 2^32, as the TPU's int32 accumulator does
//     (no .satfinite; the atomics wrap too), so it is exact and bit-equal
//     to the plain version in any order.
//   bf16: fp32 accumulation; the block sums and the atomics run in another
//     order than the Pallas kernel's (the slices' sum, then one add a grid
//     step), so the fp32 result moves by a few ulps of the running sum and
//     is held to a stated tolerance, not bit-equal.
// Bound on the H100: the tensor cores, 2 * S * D * DO * ITERS * G
//   operations at 989 TFLOP/s (bf16) or 1,979 TOP/s (int8); x (ITERS * S *
//   D) and W (DO * D) stay in the 50 MB L2 after their first pass.
// Design: the s8 GEMM's mainloop (gemm_s8_epilogue.cu) on one long K: a
//   block owns a 128 x 256 output tile and a contiguous range of the
//   ITERS * G slice products, p -> slice p % ITERS, and streams p's K
//   slices of x_p and W (128 bytes of K each: 64 bf16 or 128 int8) through
//   a 4-stage TMA ring (x by a 3-D map, so rows past S of a slice load as
//   zeros; W (DO, D), K-major, the only layout the 8-bit wgmma takes, and
//   the bf16 one's native B layout, so one kernel serves both).  Warpgroups
//   1 and 2 each keep a 64 x 256 slab of sums in registers (wgmma
//   m64n256k16 bf16 or m64n256k32 s8, four a slice), warpgroup 0's one
//   thread keeps the ring full.  The probe's shape has only 3 x 12 = 36
//   such tiles for 132 SMs, so the products of each tile are split over
//   `split` blocks (chosen by the wrapper so that the blocks fill whole
//   waves of the SMs) and the blocks add their slabs into the zeroed
//   output with atomics at the end, once each.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BM = 128, BN = 256, BK = 128, STAGES = 4;  // BK in bytes
constexpr int THREADS = 384;  // warpgroup 0 loads, warpgroups 1 and 2 compute
constexpr int STAGE_A = BM * BK, STAGE_B = BN * BK;
constexpr int SMEM_BYTES = STAGES * (STAGE_A + STAGE_B) + 1024;  // + align

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

// TMA: the box at (c0 innermost, c1, c2) of the tensor map into shared
// memory, completing its bytes on the mbarrier
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// shared-memory matrix descriptor, 128-byte swizzle (atoms of 8 x 128 B)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

#define PROBE_D128                                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                     \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "             \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "             \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "             \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "             \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "             \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, " \
  "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "   \
  "%127}, "

#define PROBE_OUT128(C)                                                                          \
  C(d[0]), C(d[1]), C(d[2]), C(d[3]), C(d[4]), C(d[5]), C(d[6]), C(d[7]), C(d[8]), C(d[9]),     \
  C(d[10]), C(d[11]), C(d[12]), C(d[13]), C(d[14]), C(d[15]), C(d[16]), C(d[17]), C(d[18]),      \
  C(d[19]), C(d[20]), C(d[21]), C(d[22]), C(d[23]), C(d[24]), C(d[25]), C(d[26]), C(d[27]),      \
  C(d[28]), C(d[29]), C(d[30]), C(d[31]), C(d[32]), C(d[33]), C(d[34]), C(d[35]), C(d[36]),      \
  C(d[37]), C(d[38]), C(d[39]), C(d[40]), C(d[41]), C(d[42]), C(d[43]), C(d[44]), C(d[45]),      \
  C(d[46]), C(d[47]), C(d[48]), C(d[49]), C(d[50]), C(d[51]), C(d[52]), C(d[53]), C(d[54]),      \
  C(d[55]), C(d[56]), C(d[57]), C(d[58]), C(d[59]), C(d[60]), C(d[61]), C(d[62]), C(d[63]),      \
  C(d[64]), C(d[65]), C(d[66]), C(d[67]), C(d[68]), C(d[69]), C(d[70]), C(d[71]), C(d[72]),      \
  C(d[73]), C(d[74]), C(d[75]), C(d[76]), C(d[77]), C(d[78]), C(d[79]), C(d[80]), C(d[81]),      \
  C(d[82]), C(d[83]), C(d[84]), C(d[85]), C(d[86]), C(d[87]), C(d[88]), C(d[89]), C(d[90]),      \
  C(d[91]), C(d[92]), C(d[93]), C(d[94]), C(d[95]), C(d[96]), C(d[97]), C(d[98]), C(d[99]),      \
  C(d[100]), C(d[101]), C(d[102]), C(d[103]), C(d[104]), C(d[105]), C(d[106]), C(d[107]),        \
  C(d[108]), C(d[109]), C(d[110]), C(d[111]), C(d[112]), C(d[113]), C(d[114]), C(d[115]),        \
  C(d[116]), C(d[117]), C(d[118]), C(d[119]), C(d[120]), C(d[121]), C(d[122]), C(d[123]),        \
  C(d[124]), C(d[125]), C(d[126]), C(d[127])

#define PROBE_F(x) "+f"(x)
#define PROBE_R(x) "+r"(x)

// d (64 x 256 fp32) (+)= A (64 x 16 bf16, K-major) . B (16 x 256, K-major)
__device__ __forceinline__ void wgmma_step(float (&d)[128], uint64_t desc_a, uint64_t desc_b,
                                           int scale_d) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " PROBE_D128
               "%128, %129, p, 1, 1, 0, 0;\n}\n"
               : PROBE_OUT128(PROBE_F)
               : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x 256 int32, wrapping) (+)= A (64 x 32 int8, K-major) . B (32 x 256, K-major)
__device__ __forceinline__ void wgmma_step(int (&d)[128], uint64_t desc_a, uint64_t desc_b,
                                           int scale_d) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 " PROBE_D128
               "%128, %129, p;\n}\n"
               : PROBE_OUT128(PROBE_R)
               : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// the operands of each accumulator type: K elements a 128-byte slice holds
template <typename ACC> struct Operand;
template <> struct Operand<float> {  // bf16
  static constexpr int kSliceK = 64;
  static constexpr bool kBf16 = true;
};
template <> struct Operand<int> {  // int8
  static constexpr int kSliceK = 128;
  static constexpr bool kBf16 = false;
};

// ACC: float (bf16 operands) or int (int8 operands)
template <typename ACC>
__global__ void __launch_bounds__(THREADS, 1)
probe_mma_kernel(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_w,
                 ACC* __restrict__ out, int S, int D, int DO, int iters, int n_products,
                 int split) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t sA = (raw + 1023) & ~1023u;  // swizzle atoms need 1024-byte alignment
  const uint32_t sB = sA + STAGES * STAGE_A;
  const uint32_t full0 = static_cast<uint32_t>(__cvta_generic_to_shared(full));
  const uint32_t empty0 = static_cast<uint32_t>(__cvta_generic_to_shared(empty));

  constexpr int kSliceK = Operand<ACC>::kSliceK;
  const int tid = threadIdx.x, wg = tid >> 7, wtid = tid & 127;
  const int n_nb = (DO + BN - 1) / BN;
  const int tile = blockIdx.x / split, part = blockIdx.x % split;
  const int m0 = (tile / n_nb) * BM, n0 = (tile % n_nb) * BN;
  // this block's products [p0, p1) of the tile's n_products
  const int p0 = (int)((long long)n_products * part / split);
  const int p1 = (int)((long long)n_products * (part + 1) / split);
  const int KT = (D + kSliceK - 1) / kSliceK;
  const int n_it = (p1 - p0) * KT;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);   // the producer's expect_tx arrival (+ bytes)
      mbar_init(empty0 + 8 * s, 8);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 0) {
      for (int it = 0; it < n_it; ++it) {
        const int p = p0 + it / KT, kt = it % KT, s = it % STAGES;
        if (it >= STAGES) mbar_wait(empty0 + 8 * s, ((it / STAGES) - 1) & 1);
        const uint32_t bar = full0 + 8 * s;
        mbar_expect_tx(bar, STAGE_A + STAGE_B);
        tma_load_3d(sA + s * STAGE_A, &map_x, kt * kSliceK, m0, p % iters, bar);
        tma_load_3d(sB + s * STAGE_B, &map_w, kt * kSliceK, n0, 0, bar);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int c = wg - 1;
    const bool releaser = (wtid & 31) == 0;
    ACC d[BN / 2];
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) d[j] = ACC(0);
    for (int it = 0; it < n_it; ++it) {
      const int s = it % STAGES;
      mbar_wait(full0 + 8 * s, (it / STAGES) & 1);
      const uint32_t a = sA + s * STAGE_A + c * 64 * BK;
      const uint32_t b = sB + s * STAGE_B;
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int k = 0; k < BK / 32; ++k)  // 32 bytes further along the 128-byte rows
        wgmma_step(d, smem_desc(a + k * 32, 16, 1024), smem_desc(b + k * 32, 16, 1024), 1);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      // slice `it` stays in flight; slice it-1 is done: release its stage
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      if (it > 0 && releaser) mbar_arrive(empty0 + 8 * ((it - 1) % STAGES));
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    // the slab into the output, once: element e of column group j lies at
    // row 16 warp + lane / 4 + 8 (e / 2), column 8 j + 2 (lane % 4) + e % 2
    const int warp = wtid >> 5, lane = wtid & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + c * 64 + warp * 16 + g + 8 * (e >> 1);
        const int col = n0 + 8 * j + 2 * t + (e & 1);
        if (row < S && col < DO) atomicAdd(out + (size_t)row * DO + col, d[4 * j + e]);
      }
    }
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

// a row-major (n, rows, cols) tensor of 1- or 2-byte elements in boxes of
// box_rows x 128 bytes of one matrix, 128-byte swizzled (the wgmma
// descriptors' layout); out-of-range elements load as zeros
bool make_map(CUtensorMap* map, const void* ptr, int n, int rows, int cols, int box_rows,
              bool bf16) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const int elem = bf16 ? 2 : 1;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)n};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * elem, (cuuint64_t)rows * cols * elem};
  const cuuint32_t box[3] = {(cuuint32_t)(BK / elem), (cuuint32_t)box_rows, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  return fn(map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8, 3,
            const_cast<void*>(ptr), dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename ACC>
int launch(const void* x, const void* w, void* out, int S, int D, int DO, int iters, int G,
           int split, cudaStream_t st) {
  // a runtime call first: it makes the device's primary context current in
  // this thread, which the CUDA driver API's tensor-map encoder below needs
  auto kernel = probe_mma_kernel<ACC>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  constexpr bool bf16 = Operand<ACC>::kBf16;
  CUtensorMap map_x, map_w;
  if (!make_map(&map_x, x, iters, S, D, BM, bf16) || !make_map(&map_w, w, 1, DO, D, BN, bf16))
    return (int)cudaErrorInvalidValue;
  err = cudaMemsetAsync(out, 0, (size_t)S * DO * sizeof(ACC), st);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = ((S + BM - 1) / BM) * ((DO + BN - 1) / BN);
  kernel<<<n_tiles * split, THREADS, SMEM_BYTES, st>>>(map_x, map_w, static_cast<ACC*>(out), S,
                                                        D, DO, iters, iters * G, split);
  return (int)cudaGetLastError();
}

}  // namespace

// x (iters, S, D) and w (DO, D), both bf16 (s8 == 0) or both int8 (s8 !=
// 0), K-major -> out (S, DO) fp32 or int32 (wrapping), zeroed here and
// summed into by the split blocks of each output tile.  D and DO multiples
// of 16, 1 <= split <= iters * G.
extern "C" int probe_mma(const void* x, const void* w, void* out, int S, int D, int DO, int iters,
                         int G, int split, int s8, void* stream) {
  if (S < 1 || D < 16 || DO < 16 || D % 16 || DO % 16 || iters < 1 || G < 1 || split < 1 ||
      (long long)iters * G >= (1LL << 31) || split > iters * G)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  return s8 ? launch<int>(x, w, out, S, D, DO, iters, G, split, st)
            : launch<float>(x, w, out, S, D, DO, iters, G, split, st);
}
