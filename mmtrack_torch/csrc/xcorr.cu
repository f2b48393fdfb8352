// Depthwise (per-channel) VALID cross-correlation, NHWC, f32:
//   x (N, H, W, C), z (fh, fw, C) shared or (N, fh, fw, C) per sample
//   -> out (N, oh, ow, C), oh = H + 2 pad - fh + 1, ow = W + 2 pad - fw + 1,
//   out[n, i, j, c] = sum over a < fh, b < fw of xp[n, i + a, j + b, c] * z[(n,) a, b, c]
// where xp is x zero-padded by `pad` on each spatial side.
//
// Replaces the TPU kernel mmtrack_tpu/ops/xcorr.py::depthwise_xcorr_pallas
// (:50-80), which keeps one search feature in VMEM per grid step and runs
// the fh*fw shift-multiply-adds on the VPU with C on the lanes. Here blocks
// run in parallel and nothing is carried between them, so the mapping is
// one thread per output element with C fastest: the loads of x and z and
// the store of out are consecutive addresses across a warp. The filter tap
// is read from global memory (it stays in L1: every thread of a pixel row
// reads the same fh*fw*C values), the padding is a bounds test, so the
// padded copy of x is never written.
//
// Bound: bytes. Each output element costs fh*fw loads and 2*fh*fw flops,
// far below the card's 20 flops per byte; at Alpha-Refine's shape (1 x 32 x
// 32 x 64, 3x3, pad 1) the 0.5 MB of traffic takes ~0.16 us at 3.35 TB/s,
// so one launch is dominated by launch latency.
//
// Bit-equality with the plain version (ops/xcorr.py::depthwise_xcorr_plain):
// the sum runs over a, then b, in the Pallas order, starting from +0.0, with
// __fmul_rn and __fadd_rn so nvcc cannot contract acc + x*z into an FMA. A
// padded position multiplies +0.0 by the tap, exactly as the padded tensor
// does (so -0.0, inf and NaN propagate alike).
#include "common.cuh"

namespace {

__global__ void depthwise_xcorr_kernel(const float* __restrict__ x, const float* __restrict__ z,
                                       float* __restrict__ out, int N, int H, int W, int C,
                                       int fh, int fw, int pad, int oh, int ow,
                                       int z_per_sample) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t total = (size_t)N * oh * ow * C;
  if (idx >= total) return;
  const int c = (int)(idx % C);
  size_t t = idx / C;
  const int j = (int)(t % ow);
  t /= ow;
  const int i = (int)(t % oh);
  const int n = (int)(t / oh);

  const float* xn = x + (size_t)n * H * W * C;
  const float* zn = z + (z_per_sample ? (size_t)n * fh * fw * C : 0);
  float acc = 0.0f;
  for (int a = 0; a < fh; ++a) {
    const int y = i + a - pad;
    const bool row_in = y >= 0 && y < H;
    for (int b = 0; b < fw; ++b) {
      const int xx = j + b - pad;
      const float v = (row_in && xx >= 0 && xx < W) ? xn[((size_t)y * W + xx) * C + c] : 0.0f;
      acc = __fadd_rn(acc, __fmul_rn(v, zn[((size_t)a * fw + b) * C + c]));
    }
  }
  out[idx] = acc;
}

}  // namespace

extern "C" int mmt_depthwise_xcorr(const void* x, const void* z, void* out, int N, int H, int W,
                                   int C, int fh, int fw, int pad, int z_per_sample,
                                   void* stream) {
  const int oh = H + 2 * pad - fh + 1;
  const int ow = W + 2 * pad - fw + 1;
  const size_t total = (size_t)N * oh * ow * C;
  const int threads = 256;
  const dim3 grid((unsigned)((total + threads - 1) / threads));
  depthwise_xcorr_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)z, (float*)out, N, H, W, C, fh, fw, pad, oh, ow,
      z_per_sample);
  return (int)cudaGetLastError();
}
