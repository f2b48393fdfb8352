// bf16 GEMM with f32 accumulation and a fused bias epilogue:
//   out[m, n] = epilogue(sum_k A[m, k] * W[n, k] + bias[n])
// A is (M, K) row-major, W is (N, K) row-major (the torch nn.Linear layout),
// out is (M, N) row-major bf16.
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
// Bound: at the main path's shapes (M = B*L = 2448..5120 rows, N and K of
// 768..3072) these products are tensor-core bound on Hopper. This first
// version is the simple one: 64x64x32 block tiles staged through shared
// memory by plain 16-byte loads, four warps of WMMA m16n16k16 (mma.sync)
// on 32x32 warp tiles, the epilogue through an f32 tile in shared memory.
// It reaches a fraction of the card's bf16 rate; wgmma + TMA + a pipelined
// ring are later work. In mlp_block_fused the (M, 4C) hidden goes through
// device memory between the two GEMMs; keeping it on chip (fusing fc1 and
// fc2) is the first thing later work removes.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int BM = 64, BN = 64, BK = 32;
constexpr int LDS = BK + 8;  // bf16 row stride of the staged tiles (16-byte multiple)
constexpr int LDC = BN + 4;  // f32 row stride of the epilogue tile
constexpr int kThreads = 128;

enum Epilogue { EPI_BIAS = 0, EPI_BIAS_GELU = 1, EPI_BIAS_RESIDUAL = 2 };

__device__ __forceinline__ float gelu_exact(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.7071067811865476f));
}

__global__ void __launch_bounds__(kThreads)
gemm_bf16_kernel(const mmt::bf16* __restrict__ A, const mmt::bf16* __restrict__ W,
                 const float* __restrict__ bias, const mmt::bf16* __restrict__ res,
                 mmt::bf16* __restrict__ out, int M, int N, int K, int epi) {
  __shared__ __align__(32) mmt::bf16 As[BM * LDS];
  __shared__ __align__(32) mmt::bf16 Bs[BN * LDS];
  __shared__ __align__(32) float Cs[BM * LDC];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = (warp >> 1) * 32;  // warp tile origin inside the block tile
  const int wn = (warp & 1) * 32;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int k0 = 0; k0 < K; k0 += BK) {
    // BM x BK tile of A and BN x BK tile of W: 256 vectors of 8 bf16 each.
    for (int v = tid; v < BM * (BK / 8); v += kThreads) {
      const int r = v / (BK / 8);
      const int c = (v % (BK / 8)) * 8;
      uint4 a = zero;
      if (m0 + r < M) a = *reinterpret_cast<const uint4*>(A + (size_t)(m0 + r) * K + k0 + c);
      *reinterpret_cast<uint4*>(As + r * LDS + c) = a;
      // N is a multiple of BN (checked by the wrapper): no mask on W rows.
      *reinterpret_cast<uint4*>(Bs + r * LDS + c) =
          *reinterpret_cast<const uint4*>(W + (size_t)(n0 + r) * K + k0 + c);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, mmt::bf16, wmma::row_major> fa[2];
      // W^T as a col-major (K x N) operand: element (k, n) at Bs[n * LDS + k].
      wmma::fragment<wmma::matrix_b, 16, 16, 16, mmt::bf16, wmma::col_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(fa[i], As + (wm + 16 * i) * LDS + kk, LDS);
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(fb[j], Bs + (wn + 16 * j) * LDS + kk, LDS);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm + 16 * i) * LDC + wn + 16 * j, acc[i][j], LDC,
                              wmma::mem_row_major);
  __syncthreads();

  // Epilogue: 8 consecutive columns per thread, one 16-byte store each.
  for (int g = tid; g < BM * (BN / 8); g += kThreads) {
    const int r = g / (BN / 8);
    const int c = (g % (BN / 8)) * 8;
    const int m = m0 + r;
    if (m >= M) continue;
    const int n = n0 + c;
    uint4 rv = zero;
    if (epi == EPI_BIAS_RESIDUAL) rv = *reinterpret_cast<const uint4*>(res + (size_t)m * N + n);
    const mmt::bf16* rp = reinterpret_cast<const mmt::bf16*>(&rv);
    __align__(16) mmt::bf16 o[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      float h = mmt::round_bf16(Cs[r * LDC + c + e] + bias[n + e]);
      if (epi == EPI_BIAS_GELU) {
        h = gelu_exact(h);
      } else if (epi == EPI_BIAS_RESIDUAL) {
        h = __bfloat162float(rp[e]) + h;
      }
      o[e] = __float2bfloat16(h);
    }
    *reinterpret_cast<uint4*>(out + (size_t)m * N + n) = *reinterpret_cast<const uint4*>(o);
  }
}

}  // namespace

// Requires K % 32 == 0, N % 64 == 0, 16-byte aligned rows (checked in
// Python). `res` may be null unless epi == EPI_BIAS_RESIDUAL.
extern "C" int mmt_gemm_bf16(const void* A, const void* W, const void* bias, const void* res,
                             void* out, int M, int N, int K, int epi, void* stream) {
  const dim3 grid(N / BN, (M + BM - 1) / BM);
  gemm_bf16_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const mmt::bf16*)A, (const mmt::bf16*)W, (const float*)bias, (const mmt::bf16*)res,
      (mmt::bf16*)out, M, N, K, epi);
  return (int)cudaGetLastError();
}
