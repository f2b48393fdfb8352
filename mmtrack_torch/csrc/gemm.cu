// bf16 GEMM with f32 accumulation and a fused bias epilogue:
//   out[m, n] = epilogue(sum_k A[m, k] * W[n, k] + bias[n])
// A is (M, K) row-major, W is (N, K) row-major (the torch nn.Linear layout,
// K-major: the layout wgmma reads B in without a transpose), out is (M, N)
// row-major bf16.
//
// Replaces the matrix products of the TPU kernels
// mmtrack_tpu/ops/flash_attn.py::_attn_block_kernel (qkv :99-102, proj
// :122-125) and mmtrack_tpu/ops/mlp_fuse.py::_mlp_kernel (fc1 :64-67, fc2
// :68-71), with their rounding points:
//   EPI_BIAS          bf16(acc + bias)                      (qkv)
//   EPI_BIAS_GELU     bf16(gelu(bf16(acc + bias)))          (fc1)
//   EPI_BIAS_RESIDUAL bf16(res + bf16(acc + bias))          (proj, fc2)
// GELU is the exact-erf form, 0.5 x (1 + erf(x / sqrt 2)) with CUDA's
// erff; the TPU kernel used an Abramowitz-Stegun polynomial because Mosaic
// has no erf (the two differ by < 4e-7 before the bf16 rounding).
//
// Bound: at the main path's shapes (M = B*L = 2448..10240 rows, N and K of
// 768..3072) these products are bound by the tensor cores' bf16 rate
// (0.009-0.05 ms), proj with its residual by a hair on device-memory bytes.
// The design is the usual Hopper one:
//   - a 128 x BN block tile (BN = 64, 128, 192 or 256, chosen per (M, N) by
//     ops/mlp_fuse.py::gemm_plan to fill the last wave on 132 SMs);
//   - one producer thread starts TMA loads of 128 x 64 A and BN x 64 W
//     tiles (128-byte rows, 128-byte swizzle) into a ring of 4-8 stages, each
//     with a full and an empty mbarrier; M rows and K columns past the end
//     are zero-filled by TMA;
//   - two consumer warpgroups (setmaxnreg 232) each run wgmma m64nBNk16 on
//     64 rows, both operands read from shared memory through descriptors
//     whose swizzle matches the TMA box; one wgmma group stays in flight
//     while the next stage is awaited;
//   - the epilogue works on the accumulator registers (bias in f32, bf16
//     round, GELU), passes each warp's 16 x 64 slice through a small padded
//     shared tile and stores the output 16 bytes a thread, masking rows
//     past M; the residual rows are prefetched into L2 before the k-loop
//     and read 16 bytes a thread.
// The TMA descriptors are encoded on the host (cuTensorMapEncodeTiled,
// looked up at run time with cudaGetDriverEntryPointByVersion, so the
// library links no libcuda) and cached by (pointer, shape, box), so a call
// with the same weights encodes nothing. Persistent tiles, split-K and
// fusing fc1 with fc2 (keeping the (M, 4C) hidden on chip) are later work.
#include <cuda.h>

#include <cstddef>
#include <mutex>
#include <unordered_map>

#include "common.cuh"

namespace {

enum Epilogue { EPI_BIAS = 0, EPI_BIAS_GELU = 1, EPI_BIAS_RESIDUAL = 2 };

constexpr int BM = 128;             // block rows: two consumer warpgroups of 64
constexpr int BK = 64;              // 64 bf16 = one 128-byte swizzle row
constexpr int kConsumers = 2;       // warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kEpiLd = 72;          // bf16 row stride of a warp's 16 x 64 epilogue tile
constexpr int kEpiWarpBytes = 16 * kEpiLd * 2;

template <int BN>
struct Tile {
  static constexpr int kABytes = BM * BK * 2;
  static constexpr int kWBytes = BN * BK * 2;
  static constexpr int kStageBytes = kABytes + kWBytes;   // a multiple of 1024
  static constexpr int kStages = (200 * 1024 / kStageBytes) < 8 ? 200 * 1024 / kStageBytes : 8;
  static constexpr int kEpiBytes = 4 * kConsumers * kEpiWarpBytes;
  // + 1024: the ring is aligned to 1024 bytes (the 128-byte swizzle's period)
  static constexpr int kSmemBytes = kStages * kStageBytes + kEpiBytes + 16 * kStages + 1024;
};

__device__ __forceinline__ float gelu_exact(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.7071067811865476f));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// 2-D TMA load of the box at (c0 = column, c1 = row) into shared memory,
// completing `bar`'s transaction count.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

// wgmma shared-memory descriptor of a K-major tile with 128-byte rows and
// the 128-byte swizzle: 8-row groups 1024 bytes apart (stride byte
// offset), leading byte offset unused (1). Adding 2 (32 bytes >> 4) to it
// steps 16 values along K inside the swizzled row.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
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

// D (64 x N, f32 registers) += A (64 x 16, shared) * B (N x 16, shared)^T.
template <int N>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2], uint64_t a, uint64_t b);

template <>
__device__ __forceinline__ void wgmma_bf16<64>(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<128>(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<192>(float (&d)[96], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]),
        "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<256>(float (&d)[128], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]),
        "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
        "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]),
        "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(1));
}

template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
gemm_bf16_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_w,
                 const float* __restrict__ bias, const mmt::bf16* __restrict__ res,
                 mmt::bf16* __restrict__ out, int M, int N, int K, int epi) {
  using T = Tile<BN>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  uint8_t* ring_ptr = smem_raw + (ring - raw);
  mmt::bf16* epi_tiles = reinterpret_cast<mmt::bf16*>(ring_ptr + T::kStages * T::kStageBytes);
  const uint32_t full_bar = ring + T::kStages * T::kStageBytes + T::kEpiBytes;
  const uint32_t empty_bar = full_bar + 8 * T::kStages;

  const int wg = threadIdx.x / 128;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int k_tiles = (K + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < T::kStages; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, 4 * kConsumers);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // Producer warpgroup: one thread keeps the ring full.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      for (int kt = 0; kt < k_tiles; ++kt) {
        const int s = kt % T::kStages;
        if (kt >= T::kStages) mbar_wait(empty_bar + 8 * s, ((kt / T::kStages) - 1) & 1);
        const uint32_t stage = ring + s * T::kStageBytes;
        mbar_expect_tx(full_bar + 8 * s, T::kStageBytes);
        tma_load_2d(stage, &map_a, kt * BK, m0, full_bar + 8 * s);
        tma_load_2d(stage + T::kABytes, &map_w, kt * BK, n0, full_bar + 8 * s);
      }
    }
  } else {
    // Consumer warpgroup c: rows 64 c .. 64 c + 63 of the block tile.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int c = wg - 1;
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const int row0 = m0 + c * 64 + warp * 16;   // the warp's 16 rows
    if (epi == EPI_BIAS_RESIDUAL) {
      // bring the warp's residual rows into L2 while the products run
      for (int i = lane; i < 16 * (BN / 64); i += 32) {
        const int m = row0 + i / (BN / 64);
        if (m < M) prefetch_l2(res + (size_t)m * N + n0 + 64 * (i % (BN / 64)));
      }
    }
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

    for (int kt = 0; kt < k_tiles; ++kt) {
      const int s = kt % T::kStages;
      mbar_wait(full_bar + 8 * s, (kt / T::kStages) & 1);
      const uint32_t stage = ring + s * T::kStageBytes;
      const uint64_t da = smem_desc(stage + c * 64 * BK * 2);
      const uint64_t dw = smem_desc(stage + T::kABytes);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) wgmma_bf16<BN>(acc, da + 2 * kk, dw + 2 * kk);
      wgmma_commit();
      // the group before this one has finished reading its stage: release it
      wgmma_wait<1>();
      if (kt > 0 && lane == 0) mbar_arrive(empty_bar + 8 * ((kt - 1) % T::kStages));
    }
    wgmma_wait<0>();

    // Epilogue. Thread (warp, lane) holds rows 16 warp + lane / 4 (and + 8)
    // of the consumer's 64, columns 8 j + 2 (lane % 4) (and + 1) of every
    // 8-column group j: acc[4 j + 0..1] and acc[4 j + 2..3]. Per 64
    // columns: the lane's residual vectors are loaded first, the rounded
    // values go through the warp's shared tile, and each lane then stores
    // 8 columns of 4 rows, 16 bytes at a time.
    mmt::bf16* tile = epi_tiles + (c * 4 + warp) * (kEpiWarpBytes / 2);
    const int g = lane / 4, q = lane % 4;
#pragma unroll
    for (int cc = 0; cc < BN / 64; ++cc) {
      const int col = n0 + 64 * cc + (lane % 8) * 8;   // the lane's 8 columns when storing
      uint4 rv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = row0 + 4 * i + lane / 8;
        rv[i] = make_uint4(0u, 0u, 0u, 0u);
        if (epi == EPI_BIAS_RESIDUAL && m < M)
          rv[i] = *reinterpret_cast<const uint4*>(res + (size_t)m * N + col);
      }
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int j = cc * 8 + jj;
        const int tc = 8 * jj + 2 * q;
        const float2 bb = *reinterpret_cast<const float2*>(bias + n0 + 64 * cc + tc);
        float h[4] = {mmt::round_bf16(acc[4 * j + 0] + bb.x), mmt::round_bf16(acc[4 * j + 1] + bb.y),
                      mmt::round_bf16(acc[4 * j + 2] + bb.x), mmt::round_bf16(acc[4 * j + 3] + bb.y)};
        if (epi == EPI_BIAS_GELU) {
#pragma unroll
          for (int e = 0; e < 4; ++e) h[e] = gelu_exact(h[e]);
        }
        *reinterpret_cast<__nv_bfloat162*>(tile + g * kEpiLd + tc) = __floats2bfloat162_rn(h[0], h[1]);
        *reinterpret_cast<__nv_bfloat162*>(tile + (g + 8) * kEpiLd + tc) =
            __floats2bfloat162_rn(h[2], h[3]);
      }
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 4 * i + lane / 8;
        const int m = row0 + r;
        if (m < M) {
          uint4 v = *reinterpret_cast<const uint4*>(tile + r * kEpiLd + (lane % 8) * 8);
          if (epi == EPI_BIAS_RESIDUAL) {
            mmt::bf16* hp = reinterpret_cast<mmt::bf16*>(&v);
            const mmt::bf16* rp = reinterpret_cast<const mmt::bf16*>(&rv[i]);
#pragma unroll
            for (int e = 0; e < 8; ++e)
              hp[e] = __float2bfloat16(__bfloat162float(rp[e]) + __bfloat162float(hp[e]));
          }
          *reinterpret_cast<uint4*>(out + (size_t)m * N + col) = v;
        }
      }
      __syncwarp();
    }
  }
}

// --- host side -------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return (err == cudaSuccess && found == cudaDriverEntryPointSuccess) ? (EncodeTiledFn)p : nullptr;
  }();
  return fn;
}

struct MapKey {
  const void* ptr;
  int rows, cols, box_rows;
  bool operator==(const MapKey& o) const {
    return ptr == o.ptr && rows == o.rows && cols == o.cols && box_rows == o.box_rows;
  }
};

struct MapKeyHash {
  size_t operator()(const MapKey& k) const {
    size_t h = std::hash<const void*>()(k.ptr);
    for (int v : {k.rows, k.cols, k.box_rows}) h = h * 1000003u ^ std::hash<int>()(v);
    return h;
  }
};

// The TMA descriptor of a (rows, cols) row-major bf16 matrix read in boxes
// of box_rows x 64 with the 128-byte swizzle. A descriptor is a function of
// exactly these values, so a cached one is never stale. Returns false if
// the encoding fails.
bool tensor_map(const void* ptr, int rows, int cols, int box_rows, CUtensorMap* map) {
  static std::mutex mu;
  static std::unordered_map<MapKey, CUtensorMap, MapKeyHash> cache;
  const MapKey key{ptr, rows, cols, box_rows};
  std::lock_guard<std::mutex> lock(mu);
  const auto hit = cache.find(key);
  if (hit != cache.end()) {
    *map = hit->second;
    return true;
  }
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  if (encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides, box,
             elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  if (cache.size() >= 4096) cache.clear();   // activations come and go; weights re-enter at once
  cache.emplace(key, *map);
  return true;
}

template <int BN>
cudaError_t launch(const void* A, const void* W, const void* bias, const void* res, void* out, int M,
                   int N, int K, int epi, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      gemm_bf16_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile<BN>::kSmemBytes);
  if (attr != cudaSuccess) return attr;
  CUtensorMap map_a, map_w;
  if (!tensor_map(A, M, K, BM, &map_a) || !tensor_map(W, N, K, BN, &map_w))
    return cudaErrorInvalidValue;
  const dim3 grid(N / BN, (M + BM - 1) / BM);
  gemm_bf16_kernel<BN><<<grid, kThreads, Tile<BN>::kSmemBytes, stream>>>(
      map_a, map_w, (const float*)bias, (const mmt::bf16*)res, (mmt::bf16*)out, M, N, K, epi);
  return cudaGetLastError();
}

}  // namespace

// Requires N % bn == 0 for bn in {64, 128, 192, 256} (the block tile's
// width, chosen by ops/mlp_fuse.py::gemm_plan), K % 8 == 0, 16-byte aligned
// operands (checked in Python). `res` may be null unless epi ==
// EPI_BIAS_RESIDUAL.
extern "C" int mmt_gemm_bf16(const void* A, const void* W, const void* bias, const void* res,
                             void* out, int M, int N, int K, int epi, int bn, void* stream) {
  if (M <= 0 || K <= 0 || K % 8 || bn <= 0 || N % bn || epi < EPI_BIAS ||
      epi > EPI_BIAS_RESIDUAL)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (bn) {
    case 64: return (int)launch<64>(A, W, bias, res, out, M, N, K, epi, s);
    case 128: return (int)launch<128>(A, W, bias, res, out, M, N, K, epi, s);
    case 192: return (int)launch<192>(A, W, bias, res, out, M, N, K, epi, s);
    case 256: return (int)launch<256>(A, W, bias, res, out, M, N, K, epi, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
