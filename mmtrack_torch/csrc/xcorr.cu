// Depthwise (per-channel) VALID cross-correlation, NHWC, f32:
//   x (N, H, W, C), z (fh, fw, C) shared or (N, fh, fw, C) per sample
//   -> out (N, oh, ow, C), oh = H + 2 pad - fh + 1, ow = W + 2 pad - fw + 1,
//   out[n, i, j, c] = sum over a < fh, b < fw of xp[n, i + a, j + b, c] * z[(n,) a, b, c]
// where xp is x zero-padded by `pad` on each spatial side.
//
// Replaces the TPU kernel mmtrack_tpu/ops/xcorr.py::depthwise_xcorr_pallas
// (:50-80), which keeps one search feature in VMEM per grid step and runs
// the fh*fw shift-multiply-adds on the VPU with C on the lanes.
//
// Bound: bytes. Each output element costs 2*fh*fw flops against one read of
// its input and one write, far below the card's 20 flops per byte; at
// Alpha-Refine's shape (1 x 32 x 32 x 64, 3x3, pad 1) the 0.5 MB of traffic
// takes ~0.16 us at 3.35 TB/s, so one launch is mostly launch latency and
// one round trip to device memory.
//
// Design: one block per (sample, band of BR output rows, segment of output
// columns, chunk of 32 channels). The block stages the padded input band it
// needs, (BR + fh - 1) x (segment + fw - 1) x 32 channels, and the fh x fw
// taps of its channels into shared memory once, by 4-byte cp.async copies
// (a warp copies 32 consecutive channels of one pixel or tap, and every copy
// of the block is in flight at once: a plain load-then-store loop would wait
// out each load before issuing the next); padded cells are zero-filled as
// +0.0. Thread (c, run, row) then owns one channel and a run of R
// consecutive output columns of one output row (R = 8 where that still
// leaves 128 threads for every SM, else 2: N = 16 reuses each staged value
// more, N = 1 spreads wider): for each tap it reads the filter value once
// into a register and applies it to the R outputs of its run, all from
// shared memory (consecutive threads read consecutive channels, so no bank
// conflicts) and with no load from device memory on the sum's chain.
// Indices are 32-bit within a sample and the thread's place comes from
// threadIdx, so no thread divides. Channel counts that are not a multiple
// of 32 and output widths that are not a multiple of R are masked inside
// the kernel. The launcher picks BR, the segment width and the grid so that
// small inputs still spread over many SMs; a block needing more than 48 KB
// (square filters beyond 13 x 13) opts in to more, up to the card's 227 KB
// (about 29 x 29).
//
// Bit-equality with the plain version (ops/xcorr.py::depthwise_xcorr_plain):
// each output sums over a, then b, in the Pallas order, starting from +0.0,
// with __fmul_rn and __fadd_rn so nvcc cannot contract acc + x*z into an FMA.
// A padded position multiplies +0.0 by the tap, exactly as the padded
// tensor does (so -0.0, inf and NaN propagate alike).
#include "common.cuh"

namespace {

constexpr int CH = 32;             // channels per block, one per lane
constexpr int kMaxRuns = 8;        // runs per row segment
constexpr int kSMs = 132;          // the H100's SMs
constexpr int kStaticSmem = 48 * 1024;
constexpr int kMaxSmem = 232448;   // the H100's per-block opt-in maximum

// 4 bytes global -> shared, asynchronously; `valid` false writes +0.0.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// R: output columns per thread (2 or 8, chosen by the launcher)
template <int R>
__global__ void depthwise_xcorr_kernel(const float* __restrict__ x, const float* __restrict__ z,
                                       float* __restrict__ out, int H, int W, int C, int fh,
                                       int fw, int pad, int oh, int ow, int z_per_sample,
                                       int chunks) {
  extern __shared__ float xs[];  // [rows][sw][CH] band, then [fh * fw][CH] taps
  const int rs = blockDim.y;     // runs per row segment
  const int br = blockDim.z;     // output rows per band
  const int seg_w = rs * R;
  const int sw = seg_w + fw - 1;
  const int rows = br + fh - 1;
  const int chunk = blockIdx.x % chunks;
  const int seg = blockIdx.x / chunks;
  const int c = chunk * CH + threadIdx.x;
  const int i0 = blockIdx.y * br;
  const int j0 = seg * seg_w;
  const int n = blockIdx.z;
  const float* xn = x + (size_t)n * H * W * C;
  const float* zn = z + (z_per_sample ? (size_t)n * fh * fw * C : 0);
  float* zs = xs + rows * sw * CH;

  // the block's taps, and the padded band (+0.0 outside x and past C), all
  // by asynchronous copies, so that every load of the block is in flight at once
  for (int k = threadIdx.z * rs + threadIdx.y; k < fh * fw; k += rs * br)
    cp_async4(zs + k * CH + threadIdx.x, c < C ? zn + k * C + c : z, c < C);
  for (int r = threadIdx.z; r < rows; r += br) {
    const int y = i0 + r - pad;
    const bool row_in = y >= 0 && y < H;
    for (int col = threadIdx.y; col < sw; col += rs) {
      const int xx = j0 + col - pad;
      const bool in = row_in && xx >= 0 && xx < W && c < C;
      cp_async4(xs + (r * sw + col) * CH + threadIdx.x, in ? xn + (y * W + xx) * C + c : x, in);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const int i = i0 + threadIdx.z;
  const int jr = threadIdx.y * R;  // the run's first column within the segment
  if (i >= oh || c >= C || j0 + jr >= ow) return;
  float acc[R];
#pragma unroll
  for (int e = 0; e < R; ++e) acc[e] = 0.0f;
  for (int a = 0; a < fh; ++a) {
    const float* xr = xs + ((threadIdx.z + a) * sw + jr) * CH + threadIdx.x;
    const float* zr = zs + a * fw * CH + threadIdx.x;
    for (int b = 0; b < fw; ++b) {
      const float tap = zr[b * CH];
#pragma unroll
      for (int e = 0; e < R; ++e) acc[e] = __fadd_rn(acc[e], __fmul_rn(xr[(e + b) * CH], tap));
    }
  }
  float* o = out + (((size_t)n * oh + i) * ow + j0 + jr) * C + c;
#pragma unroll
  for (int e = 0; e < R; ++e)
    if (j0 + jr + e < ow) o[e * C] = acc[e];
}

// shared memory of one block: its padded band and its taps
size_t band_bytes(int br, int rs, int R, int fh, int fw) {
  return ((size_t)(br + fh - 1) * (rs * R + fw - 1) + (size_t)fh * fw) * CH * sizeof(float);
}

template <int R>
int launch(const float* x, const float* z, float* out, int N, int H, int W, int C, int fh,
           int fw, int pad, int oh, int ow, int z_per_sample, cudaStream_t stream) {
  const int runs = (ow + R - 1) / R;
  int rs = runs < kMaxRuns ? runs : kMaxRuns;
  const int chunks = (C + CH - 1) / CH;
  // The tallest band (at most 1024 threads), then the widest segment, that
  // still give one block per SM and fit in 48 KB.
  int br = 1024 / (CH * rs);
  if (br > oh) br = oh;
  auto blocks = [&](int rows_per_band) {
    const int segs = (runs + rs - 1) / rs;
    return (long)N * chunks * segs * ((oh + rows_per_band - 1) / rows_per_band);
  };
  while (br > 1 && (blocks(br) < kSMs || band_bytes(br, rs, R, fh, fw) > kStaticSmem)) br /= 2;
  while (rs > 1 && (blocks(br) < kSMs || band_bytes(br, rs, R, fh, fw) > kStaticSmem)) rs /= 2;
  const size_t smem = band_bytes(br, rs, R, fh, fw);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;  // a filter over ~29 x 29
  if (smem > kStaticSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        depthwise_xcorr_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int segs = (runs + rs - 1) / rs;
  const dim3 grid(chunks * segs, (oh + br - 1) / br, N);
  const dim3 block(CH, rs, br);
  depthwise_xcorr_kernel<R><<<grid, block, smem, stream>>>(x, z, out, H, W, C, fh, fw, pad, oh,
                                                          ow, z_per_sample, chunks);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mmt_depthwise_xcorr(const void* x, const void* z, void* out, int N, int H, int W,
                                   int C, int fh, int fw, int pad, int z_per_sample,
                                   void* stream) {
  const int oh = H + 2 * pad - fh + 1;
  const int ow = W + 2 * pad - fw + 1;
  // Long runs reuse more of each staged row; short ones spread a small input
  // over more threads. Long runs where they still leave a block's worth of
  // threads (128) for every SM.
  const long lanes = (long)N * oh * ow * ((C + CH - 1) / CH * CH);
  const float* xf = (const float*)x;
  const float* zf = (const float*)z;
  float* of = (float*)out;
  const cudaStream_t s = (cudaStream_t)stream;
  if (lanes >= 8L * 128 * kSMs)
    return launch<8>(xf, zf, of, N, H, W, C, fh, fw, pad, oh, ow, z_per_sample, s);
  return launch<2>(xf, zf, of, N, H, W, C, fh, fw, pad, oh, ow, z_per_sample, s);
}
