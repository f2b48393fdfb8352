// Row LayerNorm, bf16 in -> bf16 out, f32 statistics.
//
// Replaces the LayerNorm prologue of the TPU kernels
// mmtrack_tpu/ops/mlp_fuse.py::_mlp_kernel (:58-63) and
// mmtrack_tpu/ops/flash_attn.py::_attn_block_kernel (:93-98): two-pass mean
// and variance in f32, (x - mu) * rsqrt(var + eps) * gamma + beta, rounded
// to bf16 once.
//
// Bound: device-memory bytes (one read of x, one write of the result, a
// few flops per element). One warp per row reads the row once, 16 bytes a
// lane (C = 768 is 3 vectors of 8 values a lane), and keeps it in
// registers for both reductions (shuffles) and the output pass; gamma and
// beta are read as float4 and stay in L1/L2 across rows. C is any multiple
// of 8 up to 1024. Folding this into the GEMM prologue, so the normalised
// rows never reach device memory, is later work.
#include "common.cuh"

namespace {

constexpr int kRowsPerBlock = 4;  // one warp per row
constexpr int kMaxVectors = 4;    // 16-byte vectors a lane: C <= 32 * 8 * 4

template <int V>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
layernorm_bf16_kernel(const mmt::bf16* __restrict__ x, const float* __restrict__ gamma,
                      const float* __restrict__ beta, mmt::bf16* __restrict__ out,
                      int M, int C, float eps) {
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * C);
  uint4* orow = reinterpret_cast<uint4*>(out + (size_t)row * C);
  const int nv = C / 8;

  float v[V][8];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = lane + 32 * i;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (c < nv) raw = xr[c];
    const mmt::bf16* p = reinterpret_cast<const mmt::bf16*>(&raw);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      v[i][e] = __bfloat162float(p[e]);
      s += v[i][e];   // zero past C
    }
  }
  const float mu = mmt::warp_sum(s) / (float)C;

  float d2 = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    if (lane + 32 * i < nv) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float d = v[i][e] - mu;
        d2 += d * d;
      }
    }
  }
  const float var = mmt::warp_sum(d2) / (float)C;
  const float rs = rsqrtf(var + eps);

#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = lane + 32 * i;
    if (c < nv) {
      const float4* g4 = reinterpret_cast<const float4*>(gamma) + 2 * c;
      const float4* b4 = reinterpret_cast<const float4*>(beta) + 2 * c;
      const float4 ga = g4[0], gb = g4[1], ba = b4[0], bb = b4[1];
      const float g[8] = {ga.x, ga.y, ga.z, ga.w, gb.x, gb.y, gb.z, gb.w};
      const float b[8] = {ba.x, ba.y, ba.z, ba.w, bb.x, bb.y, bb.z, bb.w};
      __align__(16) mmt::bf16 o[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float h = (v[i][e] - mu) * rs;
        o[e] = __float2bfloat16(h * g[e] + b[e]);
      }
      orow[c] = *reinterpret_cast<const uint4*>(o);
    }
  }
}

}  // namespace

// Requires C % 8 == 0, C <= 1024 and 16-byte aligned x, gamma, beta and
// out (checked in Python).
extern "C" int mmt_layernorm_bf16(const void* x, const void* gamma, const void* beta,
                                  void* out, int M, int C, float eps, void* stream) {
  const int vectors = (C / 8 + 31) / 32;
  if (M <= 0 || C <= 0 || C % 8 || vectors > kMaxVectors) return (int)cudaErrorInvalidValue;
  const dim3 grid((M + kRowsPerBlock - 1) / kRowsPerBlock);
  const cudaStream_t s = (cudaStream_t)stream;
  const mmt::bf16* xp = (const mmt::bf16*)x;
  const float* gp = (const float*)gamma;
  const float* bp = (const float*)beta;
  mmt::bf16* op = (mmt::bf16*)out;
  switch (vectors) {
    case 1: layernorm_bf16_kernel<1><<<grid, 32 * kRowsPerBlock, 0, s>>>(xp, gp, bp, op, M, C, eps); break;
    case 2: layernorm_bf16_kernel<2><<<grid, 32 * kRowsPerBlock, 0, s>>>(xp, gp, bp, op, M, C, eps); break;
    case 3: layernorm_bf16_kernel<3><<<grid, 32 * kRowsPerBlock, 0, s>>>(xp, gp, bp, op, M, C, eps); break;
    default: layernorm_bf16_kernel<4><<<grid, 32 * kRowsPerBlock, 0, s>>>(xp, gp, bp, op, M, C, eps); break;
  }
  return (int)cudaGetLastError();
}
