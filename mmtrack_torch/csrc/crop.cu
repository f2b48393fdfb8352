// Batched target-centred square crop + bilinear resize + normalisation:
//   frames (B, H, W, C) uint8, boxes (B, 4) f32 xywh
//   -> out (B, S, S, C) f32 = ((bilinear(crop) / 255) - mean[c]) / std[c]
//   -> resize_factor (B,) f32 = S / crop_sz
//
// Replaces the TPU kernel
// mmtrack_tpu/ops/pallas_preproc.py::crop_resize_normalize_pallas (:21-94),
// which ran one image at a time (under vmap Mosaic rejected its (B, 3)
// scalar block, mmtrack_tpu/ops/crop.py:152-156), and implements the gather
// semantics of mmtrack_tpu/ops/crop.py::crop_resize (:25-83) rather than
// the TPU's matrix-unit contraction: crop side ceil(sqrt(w h) f) (>= 1),
// origin round-half-even(centre - side / 2), cv2 half-pixel source
// coordinates clipped to [0, side - 1], four taps with image row H-1 and
// column W-1 never read (the reference's padding convention), blend in the
// operation order of crop.py:81-82.
//
// Bound: gathered bytes and launch count. One thread per output element;
// the per-sequence geometry is recomputed per thread (a few dozen flops,
// cheaper than a second launch). All arithmetic uses explicitly rounded
// intrinsics (__fmul_rn / __fadd_rn / __fdiv_rn / __fsqrt_rn) so nvcc
// cannot contract it into FMAs: the result equals the plain PyTorch
// version (ops/crop.py::crop_resize_normalized_plain) bit for bit.
#include "common.cuh"

namespace {

__device__ __forceinline__ float tap(const uint8_t* __restrict__ img, int H, int W, int C,
                                     int yi, int xi, int c) {
  const bool valid = yi >= 0 && yi < H - 1 && xi >= 0 && xi < W - 1;
  return valid ? (float)img[((size_t)yi * W + xi) * C + c] : 0.0f;
}

__global__ void crop_resize_normalize_kernel(const uint8_t* __restrict__ frames,
                                             const float* __restrict__ boxes,
                                             const float* __restrict__ mean,
                                             const float* __restrict__ stdv,
                                             float* __restrict__ out, float* __restrict__ rf,
                                             int B, int H, int W, int C, int S, float factor) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t total = (size_t)B * S * S * C;
  if (idx >= total) return;
  const int c = (int)(idx % C);
  size_t t = idx / C;
  const int ox = (int)(t % S);
  t /= S;
  const int oy = (int)(t % S);
  const int b = (int)(t / S);

  const float x = boxes[4 * b + 0], y = boxes[4 * b + 1];
  const float w = boxes[4 * b + 2], h = boxes[4 * b + 3];
  float crop_sz = ceilf(__fmul_rn(__fsqrt_rn(__fmul_rn(w, h)), factor));
  crop_sz = fmaxf(crop_sz, 1.0f);
  const float half = __fmul_rn(crop_sz, 0.5f);
  const float x1 = rintf(__fsub_rn(__fadd_rn(x, __fmul_rn(0.5f, w)), half));
  const float y1 = rintf(__fsub_rn(__fadd_rn(y, __fmul_rn(0.5f, h)), half));
  const float step = __fdiv_rn(crop_sz, (float)S);
  const float hi = __fsub_rn(crop_sz, 1.0f);
  const float sx =
      fminf(fmaxf(__fsub_rn(__fmul_rn(__fadd_rn((float)ox, 0.5f), step), 0.5f), 0.0f), hi);
  const float sy =
      fminf(fmaxf(__fsub_rn(__fmul_rn(__fadd_rn((float)oy, 0.5f), step), 0.5f), 0.0f), hi);
  const float xs = __fadd_rn(x1, sx);
  const float ys = __fadd_rn(y1, sy);
  const float x0f = floorf(xs);
  const float y0f = floorf(ys);
  const float fx = __fsub_rn(xs, x0f);
  const float fy = __fsub_rn(ys, y0f);
  const int x0 = (int)x0f;
  const int y0 = (int)y0f;

  const uint8_t* img = frames + (size_t)b * H * W * C;
  const float p00 = tap(img, H, W, C, y0, x0, c);
  const float p01 = tap(img, H, W, C, y0, x0 + 1, c);
  const float p10 = tap(img, H, W, C, y0 + 1, x0, c);
  const float p11 = tap(img, H, W, C, y0 + 1, x0 + 1, c);
  const float gy = __fsub_rn(1.0f, fy);
  const float gx = __fsub_rn(1.0f, fx);
  float v = __fmul_rn(__fmul_rn(gy, gx), p00);
  v = __fadd_rn(v, __fmul_rn(__fmul_rn(gy, fx), p01));
  v = __fadd_rn(v, __fmul_rn(__fmul_rn(fy, gx), p10));
  v = __fadd_rn(v, __fmul_rn(__fmul_rn(fy, fx), p11));
  out[idx] = __fdiv_rn(__fsub_rn(__fdiv_rn(v, 255.0f), mean[c]), stdv[c]);
  if (ox == 0 && oy == 0 && c == 0) rf[b] = __fdiv_rn((float)S, crop_sz);
}

}  // namespace

extern "C" int mmt_crop_resize_normalize(const void* frames, const void* boxes, const void* mean,
                                         const void* stdv, void* out, void* rf, int B, int H,
                                         int W, int C, int S, float factor, void* stream) {
  const size_t total = (size_t)B * S * S * C;
  const int threads = 256;
  const dim3 grid((unsigned)((total + threads - 1) / threads));
  crop_resize_normalize_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)frames, (const float*)boxes, (const float*)mean, (const float*)stdv,
      (float*)out, (float*)rf, B, H, W, C, S, factor);
  return (int)cudaGetLastError();
}
