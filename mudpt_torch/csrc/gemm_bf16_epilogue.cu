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
//   and the chunked MLP half (mlp_halfblock_chunked :586), whose kernels
//   _mlp_chunk_fwd_kernel (:477) and _mlp_chunk_bwd_kernel (:500) stream
//   the hidden dim in chunks of c columns of fc_w and rows of proj_w, y
//   rounded after every chunk and dxn summed over the chunks in fp32:
//   fc chunk     (:488-492, :513-516)       the fc epilogues above, W a
//                                           column chunk of fc_w read in
//                                           place through a row stride
//   proj chunk   (:486, :493-497)           C = bf16(R' + bf16(acc)), R' =
//                                           bf16(R + b) on the first chunk
//                                           (R = x), else R' = R = C (y,
//                                           updated in place)
//   dh.fc_w^T    (:522-525)                 C = acc (fp32) on the first
//                                           chunk, then C += acc (fp32, in
//                                           place: one fp32 add of the
//                                           loaded C); W^T a chunk, strided
//   so the kernel and its plain version differ only in the order of the
//   fp32 sums (and the hardware exp and division of g and g').
// Bound on the H100: tensor-core operations for most shapes.  At the vision
//   shapes (M = 384*199 = 76,416 tokens, K, N in 768..4096) a product does
//   2*M*N*K operations over (M*K + K*N + M*N*(1..3))*2 bytes: hundreds of
//   operations per byte, above the ~295 where bf16 tensor cores bind,
//   except the 768 -> 768 and 1024 -> 1024 products with a residual or an
//   fp32 output, which their bytes bind.
// Design: Hopper's warpgroup MMA, fed by TMA, warp-specialized, persistent.
//   One thread of warpgroup 0 (the producer, 40 registers by setmaxnreg)
//   keeps a ring of 64-wide K slices full with TMA copies (A as K-major
//   boxes; a (K, N) W as N-major boxes of 64 x 64, read through the
//   descriptor's transpose bit; an (N, K) W as one K-major box, wgmma's
//   native B layout; all 128-byte swizzled as the wgmma descriptors read
//   them, so no transposed copy of a weight exists); mbarriers say when a
//   stage is full and when it is free again.  The consumer warpgroups 1
//   and 2 (232 registers each) run wgmma m64nNk16 straight from shared
//   memory, one slice's products in flight while they wait for the next,
//   on one of two schedules:
//     ping-pong: each consumer owns a whole 128 x 128 output tile, the
//       two taking the block's tiles in turn and taking turns in the
//       mainloop, ordered by named barriers: while one runs its products,
//       the other runs its epilogue;
//     cooperative: both share a 128 x 256 tile, 64 rows each, which reads
//       a third fewer bytes into shared memory per product.
//   The schedule follows the shape: ping-pong where the epilogue weighs
//   against the products (K at most 256 per byte that the epilogue moves
//   per output element: the residual, h-saving, QuickGELU' and fp32-factor
//   epilogues at K = 768 and 1024), cooperative where the products dominate
//   (PERF.md times both).  Each consumer
//   has a 32 KB slab of shared memory: the epilogue's second operand (the
//   residual or the saved h, bf16; the fp32 factor F, or the fp32 C that
//   add_f32 adds to, in two halves) arrives in it by TMA, the first part
//   while the products run; the epilogue works on the accumulator
//   registers, writes its results into the slab (bf16 boxes of 64 columns,
//   fp32 boxes of 32, 128-byte swizzled so the fragment writes hit distinct
//   banks, in place over the operand where the layouts agree; an fp32 tile
//   in two halves), and they leave by TMA stores that run on while the next
//   tile's products do, clipped at the matrix's edges.  add_f32's C += acc
//   is one fp32 add of the loaded C, stored back.  TMA zero-fills the
//   ragged M and N edges of the loads; N must be a multiple of 8 and K of
//   64.  Tiles go in groups of 8 row blocks (grouped rasterization), so the
//   tiles in flight together share rows of A and columns of W in L2.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

enum Epilogue {
  kQkv = 0, kResidual = 1, kFcGelu = 2, kFcGeluSave = 3,  // B = W, W (K, N)
  kGeluBwd = 4, kStoreBf16 = 5, kStoreF32 = 6,               // B = W^T, W (N, K)
  kFcGeluGrad = 7,                                            // B = W
  kMulF32 = 8,                                                // B = W^T
  kChunkResidual = 9,                                         // B = W
  kAddF32 = 10                                                // B = W^T
};

__host__ __device__ constexpr bool w_transposed(int mode) {
  return mode == kGeluBwd || mode == kStoreBf16 || mode == kStoreF32 || mode == kMulF32 ||
         mode == kAddF32;
}
__host__ __device__ constexpr bool f32_out(int mode) {
  return mode == kStoreF32 || mode == kFcGeluGrad || mode == kAddF32;
}
// the second (M, N) operand, loaded into the slab by TMA: bf16 (residual, h)
// or fp32 (F, or C itself for add_f32)
__host__ __device__ constexpr bool bf16_operand(int mode) {
  return mode == kResidual || mode == kGeluBwd || mode == kChunkResidual;
}
__host__ __device__ constexpr bool f32_operand(int mode) {
  return mode == kMulF32 || mode == kAddF32;
}

constexpr int BK = 64;        // K slice: 64 bf16 = one 128-byte swizzle row
constexpr int THREADS = 384;  // warpgroup 0 loads, warpgroups 1 and 2 compute
constexpr int GROUP_M = 8;    // row blocks of a rasterization group
constexpr int SMEM_MAX = 232448;

// the schedules: ping-pong, each consumer owning a 128 x 128 tile;
// cooperative, both consumers sharing a 128 x 256 tile, 64 rows each.
// Each consumer's epilogue slab holds a bf16 tile of its own, 32 KB (an
// fp32 tile, or an fp32 second operand, passes through it in halves); the
// ring takes as many stages as fit beside the two slabs
enum Schedule { kAuto = 0, kPingPong = 1, kCoop = 2 };
constexpr int SLAB = 32768;

template <int CFG>
struct Shape {
  static constexpr bool PING = CFG == kPingPong;
  static constexpr int WM = PING ? 128 : 64;             // rows of a consumer's tile
  static constexpr int WN = 16384 / WM;
  static constexpr int TM = 128;                         // rows of the block's tile
  static constexpr int MB = WM / 64;                     // m64 blocks of a consumer's tile
  static constexpr int STAGE_A = TM * BK * 2, STAGE_B = BK * WN * 2;
  static constexpr int STAGES = (SMEM_MAX - 2 * SLAB - 1024 - 256) / (STAGE_A + STAGE_B);
  static constexpr int BOX = WM * 128;                   // bytes of one slab box
  static constexpr int SMEM = STAGES * (STAGE_A + STAGE_B) + 2 * SLAB + 1024;  // + align
};

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

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// barrier for the 128 threads of one warpgroup (ids 1, 2; 0 is __syncthreads)
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// the mainloop turns: a consumer waits on its barrier (ids 3, 4) for the
// other's arrival, 256 threads in all
__device__ __forceinline__ void turn_wait(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void turn_pass(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// shared-memory matrix descriptor, 128-byte swizzle (atoms of 8 x 128 B)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

// d (64 x 128 fp32) (+)= A (64 x 16, K-major) . B (16 x 128), B N-major
// (TRANS_B = 1) or K-major (TRANS_B = 0)
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t desc_a,
                                                 uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, %67;\n}\n"
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
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TRANS_B));
}

// d (64 x 256 fp32) (+)= A (64 x 16, K-major) . B (16 x 256), B N-major
// (TRANS_B = 1) or K-major (TRANS_B = 0)
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t desc_a,
                                                 uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
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

template <int WN, int TRANS_B>
__device__ __forceinline__ void wgmma_bf16(float (&d)[WN / 2], uint64_t desc_a, uint64_t desc_b,
                                           int scale_d) {
  if constexpr (WN == 128) {
    wgmma_m64n128k16<TRANS_B>(d, desc_a, desc_b, scale_d);
  } else {
    wgmma_m64n256k16<TRANS_B>(d, desc_a, desc_b, scale_d);
  }
}

// hardware exp and division (a few fp32 ulps), far below the bf16 rounding
__device__ __forceinline__ float quick_gelu(float h) {
  return __fdividef(h, 1.0f + __expf(-1.702f * h));
}

__device__ __forceinline__ float quick_gelu_grad(float h) {
  const float s = __fdividef(1.0f, 1.0f + __expf(-1.702f * h));
  return s + 1.702f * h * s * (1.0f - s);
}

// the block's k-th tile (blockIdx.x + k * gridDim.x), grouped: GROUP_M row
// blocks at a time, row blocks fastest within a group
__device__ __forceinline__ void tile_origin(int tile, int n_mb, int n_nb, int WM, int WN, int& m0,
                                            int& n0) {
  const int per_group = GROUP_M * n_nb, first = (tile / per_group) * GROUP_M;
  const int rows = min(n_mb - first, GROUP_M), r = tile % per_group;
  m0 = (first + r % rows) * WM;
  n0 = (r / rows) * WN;
}

template <int MODE, int CFG>
__global__ void __launch_bounds__(THREADS, 1)
gemm_bf16_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_w,
                 const __grid_constant__ CUtensorMap map_c,
                 const __grid_constant__ CUtensorMap map_c2,
                 const __grid_constant__ CUtensorMap map_r,
                 const __nv_bfloat16* __restrict__ bias, int M, int N, int K) {
  using S = Shape<CFG>;
  constexpr int WN = S::WN, TM = S::TM, MB = S::MB, STAGES = S::STAGES;
  constexpr int BOX = S::BOX, JH = WN / 16;  // fragment column groups in half a tile
  constexpr bool kPing = S::PING;
  constexpr bool kWt = w_transposed(MODE);  // B = W^T, W (N, K): K-major B
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES], rbar[2];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t sA = (raw + 1023) & ~1023u;  // swizzle atoms need 1024-byte alignment
  const uint32_t sB = sA + STAGES * S::STAGE_A;
  const uint32_t full0 = static_cast<uint32_t>(__cvta_generic_to_shared(full));
  const uint32_t empty0 = static_cast<uint32_t>(__cvta_generic_to_shared(empty));
  const uint32_t rbar0 = static_cast<uint32_t>(__cvta_generic_to_shared(rbar));

  const int tid = threadIdx.x, wg = tid >> 7, wtid = tid & 127;
  const int KT = K / BK;
  const int n_mb = (M + TM - 1) / TM, n_nb = (N + WN - 1) / WN, n_tiles = n_mb * n_nb;
  // this block's tiles: k = 0, 1, ... for tiles blockIdx.x + k * gridDim.x
  const int n_local = (n_tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);  // the producer's expect_tx arrival (+ bytes)
      mbar_init(empty0 + 8 * s, kPing ? 4 : 8);  // lane 0 of each consuming warp
    }
    mbar_init(rbar0, 1);
    mbar_init(rbar0 + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // slice kt of the block's k-th tile is slice `it` = k * KT + kt of the
  // ring: its stage it % STAGES, its mbarrier phase it / STAGES
  if (wg == 0) {
    // producer: one thread keeps the ring full, running ahead into the
    // next tile while the consumers finish this one
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 0) {
      int it = 0;
      for (int k = 0; k < n_local; ++k) {
        int m0, n0;
        tile_origin(blockIdx.x + k * gridDim.x, n_mb, n_nb, TM, WN, m0, n0);
        for (int kt = 0; kt < KT; ++kt, ++it) {
          const int s = it % STAGES;
          if (it >= STAGES) mbar_wait(empty0 + 8 * s, ((it / STAGES) - 1) & 1);
          const uint32_t bar = full0 + 8 * s;
          mbar_expect_tx(bar, S::STAGE_A + S::STAGE_B);
          tma_load_2d(sA + s * S::STAGE_A, &map_a, kt * BK, m0, bar);
          if (kWt) {
            // W rows n0 .. n0+WN-1, K columns of this slice: WN x 128 B
            tma_load_2d(sB + s * S::STAGE_B, &map_w, kt * BK, n0, bar);
          } else {
#pragma unroll
            for (int nb = 0; nb < WN / 64; ++nb)
              tma_load_2d(sB + s * S::STAGE_B + nb * BK * 128, &map_w, n0 + 64 * nb, kt * BK, bar);
          }
        }
      }
    }
  } else {
    // ping-pong: consumer c takes the block's tiles k = c, c + 2, ...;
    // cooperative: both take every tile, c its rows 64c .. 64c + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int c = wg - 1;
    const uint32_t slab = sB + STAGES * S::STAGE_B + c * SLAB;
    unsigned char* slab_p = smem_raw + (slab - raw);
    const uint32_t my_rbar = rbar0 + 8 * c;
    const bool releaser = (wtid & 31) == 0;
    const int warp = wtid >> 5, lane = wtid & 31, g = lane >> 2, t = lane & 3;
    int n_r = 0;  // phases of my_rbar waited for
    for (int k = kPing ? c : 0; k < n_local; k += kPing ? 2 : 1) {
      int m0, n0;
      tile_origin(blockIdx.x + k * gridDim.x, n_mb, n_nb, TM, WN, m0, n0);
      if (!kPing) m0 += 64 * c;  // this consumer's rows of the tile
      // the second operand into the slab: bf16, the whole tile; fp32, the
      // tile's columns h * WN/2 onwards, half of it
      auto load_operand = [&](int h) {
        constexpr int cols = bf16_operand(MODE) ? 64 : 32;
        mbar_expect_tx(my_rbar, SLAB);
#pragma unroll
        for (int b = 0; b < WN / 64; ++b)
          tma_load_2d(slab + b * BOX, &map_r, n0 + h * (WN / 2) + cols * b, m0, my_rbar);
      };
      if ((bf16_operand(MODE) || f32_operand(MODE)) && wtid == 0) {
        // the previous tile's stores have read the slab; this tile's second
        // operand lands in it while the products run
        tma_store_read_wait();
        load_operand(0);
      }

      // the mainloop; in ping-pong, in turn with the other consumer
      if (kPing && k > 0) turn_wait(3 + c);
      // no zero-fill: the first products are written with scale-d = 0, so no
      // ordinary instruction defines an accumulator register, which would
      // serialize the wgmma pipeline
      float d[MB][WN / 2];
      int it = k * KT;
      for (int kt = 0; kt < KT; ++kt, ++it) {
        const int s = it % STAGES;
        mbar_wait(full0 + 8 * s, (it / STAGES) & 1);
        const uint32_t a = sA + s * S::STAGE_A + (kPing ? 0 : c * 8192);
        const uint32_t b = sB + s * S::STAGE_B;
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          // A (and a K-major B): 32 bytes further along the 128-byte row;
          // an N-major B: two k-groups further
          const uint64_t db = kWt ? smem_desc(b + kk * 32, 16, 1024)
                                  : smem_desc(b + kk * 2048, BK * 128, 1024);
#pragma unroll
          for (int mb = 0; mb < MB; ++mb)
            wgmma_bf16<WN, kWt ? 0 : 1>(d[mb], smem_desc(a + mb * 8192 + kk * 32, 16, 1024), db,
                                        kt > 0 || kk > 0);
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        // slice `it` stays in flight; slice it-1 is done: release its stage
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        if (kt > 0 && releaser) mbar_arrive(empty0 + 8 * ((it - 1) % STAGES));
      }
      // the last slice's products are issued: the other consumer's may follow
      if (kPing && k + 1 < n_local) turn_pass(3 + (1 - c));
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      if (releaser) mbar_arrive(empty0 + 8 * ((it - 1) % STAGES));

      // the epilogue (in ping-pong, under the other consumer's products).
      // d[mb][4j + 0..1]: tile row 64mb + 16warp + g, columns 8j + 2t + 0..1;
      // [4j + 2..3] the row 8 further down.  Slab boxes of WM rows: bf16 64
      // columns (pair at chunk (j % 8) ^ (row % 8)), fp32 32 columns (chunk
      // 2(j % 4) + t/2 ^ row % 8)
      auto bf16_at = [&](int j, int r) -> unsigned char* {
        return slab_p + (j >> 3) * BOX + r * 128 + (((j & 7) ^ (r & 7)) << 4) + t * 4;
      };
      auto f32_at = [&](int j, int r) -> unsigned char* {
        return slab_p + (j >> 2) * BOX + r * 128 + (((2 * (j & 3) + (t >> 1)) ^ (r & 7)) << 4) +
               (t & 1) * 8;
      };
      // `boxes` of the slab from byte `off` out by TMA at column n0 + col0
      // (bf16 64 columns a box, fp32 32)
      auto store_slab = [&](const CUtensorMap* map, int cols, int boxes, int col0, int off) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        warpgroup_sync(1 + c);
        if (wtid == 0) {
          for (int b = 0; b < boxes; ++b)
            tma_store_2d(map, slab + off + b * BOX, n0 + col0 + cols * b, m0);
          asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        }
      };
      // before the slab takes a second part of the tile, the first has left it
      auto slab_free = [&]() {
        if (wtid == 0) tma_store_read_wait();
        warpgroup_sync(1 + c);
      };
      auto operand_wait = [&]() {
        mbar_wait(my_rbar, n_r & 1);
        ++n_r;
      };
      // the bias pair of fragment column group j, or zeros past N
      auto bias_pair = [&](int j) {
        const int gc = n0 + 8 * j + 2 * t;
        return gc < N ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias + gc))
                      : make_float2(0.f, 0.f);
      };

      if (bf16_operand(MODE)) {
        operand_wait();
      } else if (!f32_operand(MODE)) {
        slab_free();  // the previous tile's stores have read the slab
      }

      if (f32_out(MODE) || f32_operand(MODE)) {
        // the fp32 tile in parts: the fp32 operand (F of mul_f32, the old C
        // of add_f32) half by half into the registers through the whole
        // slab; an fp32 output alone in quarters through its two halves,
        // one quarter written while the one before it leaves
        constexpr int PARTS = f32_operand(MODE) ? 2 : 4, JP = WN / 8 / PARTS;
        constexpr int PART_BYTES = SLAB * 2 / PARTS;
#pragma unroll
        for (int part = 0; part < PARTS; ++part) {
          const int off = f32_operand(MODE) ? 0 : (part & 1) * PART_BYTES;
          if (part > 0 && f32_operand(MODE)) {
            if (f32_out(MODE)) {
              slab_free();
            } else {  // every thread has read the first half of F
              asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
              warpgroup_sync(1 + c);
            }
            if (wtid == 0) load_operand(1);
          } else if (part > 1) {  // the store two parts back has read its half
            if (wtid == 0) asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
            warpgroup_sync(1 + c);
          }
          if (f32_operand(MODE)) operand_wait();
#pragma unroll
          for (int jj = 0; jj < JP; ++jj) {
            const int j = part * JP + jj;
            const float2 bb = MODE == kFcGeluGrad ? bias_pair(j) : make_float2(0.f, 0.f);
#pragma unroll
            for (int mb = 0; mb < MB; ++mb) {
#pragma unroll
              for (int half = 0; half < 2; ++half) {
                const int r = 64 * mb + 16 * warp + g + 8 * half, e = 4 * j + 2 * half;
                float2* slot = reinterpret_cast<float2*>(f32_at(jj, r) + off);
                float v0 = d[mb][e], v1 = d[mb][e + 1];
                if (MODE == kMulF32) {
                  const float2 f = *slot;
                  d[mb][e] = v0 * f.x;
                  d[mb][e + 1] = v1 * f.y;
                  continue;
                }
                if (MODE == kAddF32) {  // as the plain C + acc
                  const float2 f = *slot;
                  v0 = f.x + v0;
                  v1 = f.y + v1;
                } else if (MODE == kFcGeluGrad) {
                  v0 = quick_gelu_grad(v0 + bb.x);
                  v1 = quick_gelu_grad(v1 + bb.y);
                }
                *slot = make_float2(v0, v1);
              }
            }
          }
          if (f32_out(MODE)) store_slab(&map_c, 32, PART_BYTES / BOX, part * JP * 8, off);
        }
        if (f32_out(MODE)) continue;
        warpgroup_sync(1 + c);  // F is read: mul_f32's bf16 writes may follow
      }

      // bf16 outputs, in place over a bf16 operand; the saving fc epilogue
      // writes h, then g once h has left the slab
      constexpr int PASSES = MODE == kFcGeluSave ? 2 : 1;
      const bool has_bias = MODE <= kFcGeluSave || (MODE == kChunkResidual && bias != nullptr);
#pragma unroll
      for (int pass = 0; pass < PASSES; ++pass) {
        if (pass > 0) slab_free();
#pragma unroll
        for (int j = 0; j < WN / 8; ++j) {
          const float2 b2 = has_bias ? bias_pair(j) : make_float2(0.f, 0.f);
          const float bb[2] = {b2.x, b2.y};
#pragma unroll
          for (int mb = 0; mb < MB; ++mb) {
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int r = 64 * mb + 16 * warp + g + 8 * half;
              __nv_bfloat162* slot = reinterpret_cast<__nv_bfloat162*>(bf16_at(j, r));
              float2 op = make_float2(0.f, 0.f);
              if (bf16_operand(MODE)) op = __bfloat1622float2(*slot);
              const float ov[2] = {op.x, op.y};
              float v[2];
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const float acc = d[mb][4 * j + 2 * half + e];
                if (MODE == kQkv) {
                  v[e] = bf16_round(acc) + bb[e];
                } else if (MODE == kResidual) {  // R + bf16(bf16(acc) + b), rounded once more
                  v[e] = ov[e] + bf16_round(bf16_round(acc) + bb[e]);
                } else if (MODE == kFcGelu) {
                  v[e] = quick_gelu(acc + bb[e]);
                } else if (MODE == kFcGeluSave) {  // h32, then g(h32)
                  v[e] = pass == 0 ? acc + bb[e] : quick_gelu(acc + bb[e]);
                } else if (MODE == kGeluBwd) {
                  v[e] = acc * quick_gelu_grad(ov[e]);
                } else if (MODE == kChunkResidual) {  // R' + bf16(acc), R' = bf16(R + b) or R
                  const float rp = has_bias ? bf16_round(ov[e] + bb[e]) : ov[e];
                  v[e] = rp + bf16_round(acc);
                } else {
                  v[e] = acc;  // kStoreBf16; kMulF32, already multiplied by F
                }
              }
              *slot = __floats2bfloat162_rn(v[0], v[1]);
            }
          }
        }
        store_slab(pass == 0 ? &map_c : &map_c2, 64, WN / 64, 0, 0);
      }
    }
    if (wtid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
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

// a row-major (rows, cols) matrix of bf16 (or fp32) elements whose rows lie
// ld elements apart (ld = cols when contiguous; wider for a column chunk of
// a wider matrix, read in place), in boxes of box_rows x 128 bytes,
// 128-byte swizzled as the wgmma descriptors and the epilogue slabs expect;
// elements past the matrix load as zeros and are not stored
bool make_map(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows, int ld,
              bool f32 = false) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const int elem = f32 ? 4 : 2;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * elem};
  const cuuint32_t box[2] = {(cuuint32_t)(128 / elem), (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  return fn(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
            const_cast<void*>(ptr), dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int MODE, int CFG>
int launch(const __nv_bfloat16* a, const __nv_bfloat16* w, const __nv_bfloat16* b,
           const void* r, void* c, __nv_bfloat16* c2, int M, int N, int K, int ldw,
           cudaStream_t s) {
  using S = Shape<CFG>;
  // a runtime call first: it makes the device's primary context current in
  // this thread (autograd's backward thread may not have one yet), which the
  // driver's tensor-map encoder below needs
  auto kernel = gemm_bf16_kernel<MODE, CFG>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         S::SMEM);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap map_a, map_w, map_c, map_c2 = {}, map_r = {};
  bool ok = w_transposed(MODE) ? make_map(&map_w, w, N, K, S::WN, ldw)   // W (N, K)
                               : make_map(&map_w, w, K, N, BK, ldw);     // W (K, N)
  ok = ok && make_map(&map_a, a, M, K, S::TM, K);
  ok = ok && make_map(&map_c, c, M, N, S::WM, N, f32_out(MODE));
  if (MODE == kFcGeluSave) ok = ok && make_map(&map_c2, c2, M, N, S::WM, N);
  // the second operand; chunk_residual with R null reads y in place, through C
  if (bf16_operand(MODE))
    ok = ok && make_map(&map_r, MODE == kChunkResidual && r == nullptr ? c : r, M, N, S::WM, N);
  if (f32_operand(MODE))
    ok = ok && make_map(&map_r, MODE == kAddF32 ? c : r, M, N, S::WM, N, true);
  if (!ok) return (int)cudaErrorInvalidValue;
  static int n_sm = 0;
  if (n_sm == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  }
  const int n_tiles = ((N + S::WN - 1) / S::WN) * ((M + S::TM - 1) / S::TM);
  kernel<<<n_tiles < n_sm ? n_tiles : n_sm, THREADS, S::SMEM, s>>>(map_a, map_w, map_c, map_c2,
                                                                   map_r, b, M, N, K);
  return (int)cudaGetLastError();
}

// the bytes a product's epilogue moves per output element: its output and
// its second operand
constexpr int epilogue_bytes(int mode) {
  return (f32_out(mode) ? 4 : 2) + (mode == kFcGeluSave ? 2 : 0) +
         (bf16_operand(mode) ? 2 : 0) + (f32_operand(mode) ? 4 : 0);
}

template <int MODE>
int launch_mode(const __nv_bfloat16* a, const __nv_bfloat16* w, const __nv_bfloat16* b,
                const void* r, void* c, __nv_bfloat16* c2, int M, int N, int K, int ldw,
                int schedule, cudaStream_t s) {
  // TMA: a 16-byte-aligned start and a row stride of 16-byte multiples
  const int w_cols = w_transposed(MODE) ? K : N;
  if (K % BK || N % 8 || ldw < w_cols || ldw % 8 || reinterpret_cast<uintptr_t>(w) % 16)
    return (int)cudaErrorInvalidValue;
  if ((MODE == kResidual || MODE == kGeluBwd || MODE == kMulF32) && r == nullptr)
    return (int)cudaErrorInvalidValue;
  if (MODE == kFcGeluSave && c2 == nullptr) return (int)cudaErrorInvalidValue;
  // ping-pong where the epilogue weighs against the products (K at most
  // 256 for each byte the epilogue moves per output element), so that one
  // consumer's epilogue hides under the other's products; cooperative where
  // the products dominate, its 128 x 256 tile reading fewer bytes into
  // shared memory per product (PERF.md)
  if (schedule == kAuto) schedule = K <= 256 * epilogue_bytes(MODE) ? kPingPong : kCoop;
  switch (schedule) {
    case kPingPong: return launch<MODE, kPingPong>(a, w, b, r, c, c2, M, N, K, ldw, s);
    case kCoop: return launch<MODE, kCoop>(a, w, b, r, c, c2, M, N, K, ldw, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// mode: Epilogue.  W: (K, N), or (N, K) for the B = W^T modes, its rows
// ldw elements apart.  bias: (N) bf16 for modes 0-3 and 7, optional for
// mode 9, else unused.  R: the residual (modes 1 and 9; for mode 9 null
// means C itself, y in place) or the saved h (mode 4), (M, N) bf16; the
// factor F (mode 8), (M, N) fp32.  C: (M, N), fp32 for modes 6, 7 and 10
// (10 adds to it), else bf16.  C2: the second output of mode 3.
// schedule: 0 chooses by the shape; 1 ping-pong, 128 x 128 a consumer; 2
// cooperative, 128 x 256.  Every pointer 16-byte aligned.
extern "C" int gemm_bf16_epilogue(const void* A, const void* W, const void* bias,
                                  const void* R, void* C, void* C2, int M, int N, int K,
                                  int ldw, int mode, int schedule, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const auto* a = static_cast<const __nv_bfloat16*>(A);
  const auto* w = static_cast<const __nv_bfloat16*>(W);
  const auto* b = static_cast<const __nv_bfloat16*>(bias);
  auto* c2 = static_cast<__nv_bfloat16*>(C2);
  const int g = schedule;
  switch (mode) {
    case kQkv: return launch_mode<kQkv>(a, w, b, R, C, c2, M, N, K, ldw, g, s);
    case kResidual: return launch_mode<kResidual>(a, w, b, R, C, c2, M, N, K, ldw, g, s);
    case kFcGelu: return launch_mode<kFcGelu>(a, w, b, R, C, c2, M, N, K, ldw, g, s);
    case kFcGeluSave: return launch_mode<kFcGeluSave>(a, w, b, R, C, c2, M, N, K, ldw, g, s);
    case kGeluBwd: return launch_mode<kGeluBwd>(a, w, b, R, C, c2, M, N, K, ldw, g, s);
    case kStoreBf16: return launch_mode<kStoreBf16>(a, w, b, R, C, c2, M, N, K, ldw, g, s);
    case kStoreF32: return launch_mode<kStoreF32>(a, w, b, R, C, c2, M, N, K, ldw, g, s);
    case kFcGeluGrad: return launch_mode<kFcGeluGrad>(a, w, b, R, C, c2, M, N, K, ldw, g, s);
    case kMulF32: return launch_mode<kMulF32>(a, w, b, R, C, c2, M, N, K, ldw, g, s);
    case kChunkResidual: return launch_mode<kChunkResidual>(a, w, b, R, C, c2, M, N, K, ldw, g, s);
    case kAddF32: return launch_mode<kAddF32>(a, w, b, R, C, c2, M, N, K, ldw, g, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
