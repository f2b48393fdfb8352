// Row LayerNorm, bf16 in -> bf16 out, f32 statistics.
//
// Replaces the LayerNorm prologue of the TPU kernels
// mmtrack_tpu/ops/mlp_fuse.py::_mlp_kernel (:58-63) and
// mmtrack_tpu/ops/flash_attn.py::_attn_block_kernel (:93-98): two-pass mean
// and variance in f32, (x - mu) * rsqrt(var + eps) * gamma + beta, rounded
// to bf16 once.
//
// Bound: device-memory bytes (one read of x, one write of the result, a
// few flops per element). One warp per row keeps the two reductions in
// registers and shuffles; the row is re-read from L1/L2 for the second and
// third pass. Later work folds this into the GEMM prologue so the
// normalised rows never reach device memory.
#include "common.cuh"

namespace {

constexpr int kRowsPerBlock = 4;  // one warp per row

__global__ void __launch_bounds__(32 * kRowsPerBlock)
layernorm_bf16_kernel(const mmt::bf16* __restrict__ x, const float* __restrict__ gamma,
                      const float* __restrict__ beta, mmt::bf16* __restrict__ out,
                      int M, int C, float eps) {
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const mmt::bf16* xr = x + (size_t)row * C;
  mmt::bf16* orow = out + (size_t)row * C;

  float s = 0.f;
  for (int c = lane; c < C; c += 32) s += __bfloat162float(xr[c]);
  const float mu = mmt::warp_sum(s) / (float)C;

  float v = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float d = __bfloat162float(xr[c]) - mu;
    v += d * d;
  }
  const float var = mmt::warp_sum(v) / (float)C;
  const float rs = rsqrtf(var + eps);

  for (int c = lane; c < C; c += 32) {
    const float h = (__bfloat162float(xr[c]) - mu) * rs;
    orow[c] = __float2bfloat16(h * gamma[c] + beta[c]);
  }
}

}  // namespace

extern "C" int mmt_layernorm_bf16(const void* x, const void* gamma, const void* beta,
                                  void* out, int M, int C, float eps, void* stream) {
  const dim3 grid((M + kRowsPerBlock - 1) / kRowsPerBlock);
  layernorm_bf16_kernel<<<grid, 32 * kRowsPerBlock, 0, (cudaStream_t)stream>>>(
      (const mmt::bf16*)x, (const float*)gamma, (const float*)beta, (mmt::bf16*)out, M, C,
      eps);
  return (int)cudaGetLastError();
}
