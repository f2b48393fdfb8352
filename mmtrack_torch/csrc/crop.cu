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
// Bound: the stores. At B=16, S=256, C=6 the output is 25.2 MB of f32
// against well under 1 MB of frame bytes that the crops can sample
// (0.0078 ms at 3.35 TB/s). The design:
//   - one block per 4 consecutive output rows (kRows) of one sequence
//     derives the box geometry and the source x-span once, with 32-bit
//     indices inside a frame;
//   - at its start the block requests the two source rows of each of its
//     output rows into shared memory (one cp.async group per output row,
//     16-byte copies of the aligned chunks that hold the span: the columns
//     the row can read, from the source x of its first output pixel to
//     that of its last + 1, clipped to the sampled columns [0, W - 2]), so
//     the loads' latency is paid once per block and not once per row; a
//     staged byte keeps its offset mod 16 from the frame, and a row or
//     column that is not sampled reads as 0;
//   - each thread computes one output pixel, all C channels (C = 6 and 3
//     unrolled, the channel constants in registers; any other C looped),
//     into a shared copy of the output row; bytes become floats by the
//     exact 2^23 trick (full rate, where I2F is quarter rate);
//   - the block writes the row's S x C floats with 16-byte stores.
// The shared-memory plan comes from the wrapper (ops/crop.py::crop_plan,
// held with the span by tests/test_torch_crop_plan.py).
//
// Every rounding is the plain version's, in its order (__fmul_rn,
// __fadd_rn, __fsub_rn, __fsqrt_rn, rintf, floorf; no contraction), so the
// result equals ops/crop.py::crop_resize_normalized_plain bit for bit. The
// two divisions of the normalisation, ((v / 255) - mean[c]) / std[c], are
// the correctly rounded quotients that __fdiv_rn gives, computed by
// div_rn below in five FMA-unit operations from a correctly rounded
// reciprocal: __fdiv_rn's reciprocal approximation and range check cost
// the quarter-rate MUFU unit and a branch on every element.
#include "common.cuh"

namespace {

constexpr int kRows = 4;   // output rows per block (ops/crop.py::CROP_ROWS)
static_assert(kRows >= 1 && kRows <= 4, "cp_async_wait_pending covers 4 groups");

struct CropGeometry {
  float crop_sz, x1, y1, step, hi;
};

__device__ __forceinline__ CropGeometry crop_geometry(const float* __restrict__ box, float factor,
                                                      int S) {
  const float x = box[0], y = box[1], w = box[2], h = box[3];
  CropGeometry g;
  g.crop_sz = fmaxf(ceilf(__fmul_rn(__fsqrt_rn(__fmul_rn(w, h)), factor)), 1.0f);
  const float half = __fmul_rn(g.crop_sz, 0.5f);
  g.x1 = rintf(__fsub_rn(__fadd_rn(x, __fmul_rn(0.5f, w)), half));
  g.y1 = rintf(__fsub_rn(__fadd_rn(y, __fmul_rn(0.5f, h)), half));
  g.step = __fdiv_rn(g.crop_sz, (float)S);
  g.hi = __fsub_rn(g.crop_sz, 1.0f);
  return g;
}

// Source coordinate of output index o along one axis whose crop starts at
// `origin`: cv2's half-pixel position clipped to [0, crop_sz - 1].
__device__ __forceinline__ float source_coord(int o, float origin, const CropGeometry& g) {
  const float s =
      fminf(fmaxf(__fsub_rn(__fmul_rn(__fadd_rn((float)o, 0.5f), g.step), 0.5f), 0.0f), g.hi);
  return __fadd_rn(origin, s);
}

// A byte as f32, exactly: 2^23 + v has v in its low mantissa bits.
__device__ __forceinline__ float byte_value(uint32_t v) {
  return __fsub_rn(__uint_as_float(0x4B000000u | v), 8388608.0f);
}

// a / b correctly rounded (what __fdiv_rn returns) from y = RN(1 / b),
// in five full-rate operations: q = a y is within 1.5 ulps; one
// correction q + (a - b q) y makes it faithful; the second is then the
// correctly rounded quotient (Markstein: y within half an ulp of 1/b, q
// within one ulp of a/b, the remainder a - b q exact in an FMA). No
// underflow here: |a| is 0 or above 2^-60, b is 255 or a channel's std.
// tests/test_torch_crop_plan.py checks the sequence in exact arithmetic.
__device__ __forceinline__ float div_rn(float a, float b, float y) {
  float q = __fmul_rn(a, y);
  float r = __fmaf_rn(-b, q, a);
  q = __fmaf_rn(r, y, q);
  r = __fmaf_rn(-b, q, a);
  return __fmaf_rn(r, y, q);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Wait until at most `pending` (0 to kRows - 1, uniform over the block) of
// this thread's cp.async groups are still in flight.
__device__ __forceinline__ void cp_async_wait_pending(int pending) {
  switch (pending) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    default: cp_async_wait<3>(); break;
  }
}

// One output row's source rows: y0 and y0 + 1 (sampled if in [0, H - 2]),
// the blend fraction, and where the staged span starts in each.
struct SourceRows {
  int y0;
  float fy;
  bool ok0, ok1;
  const uint8_t* src0;   // frame address of the span's first byte in row y0
  const uint8_t* src1;
};

__device__ __forceinline__ SourceRows source_rows(int oy, const CropGeometry& g,
                                                  const uint8_t* img, int H, int W, int C,
                                                  int lo, int nbytes) {
  SourceRows s;
  const float ys = source_coord(oy, g.y1, g);
  const float y0f = floorf(ys);
  s.fy = __fsub_rn(ys, y0f);
  s.y0 = (int)y0f;
  s.ok0 = s.y0 >= 0 && s.y0 < H - 1 && nbytes > 0;
  s.ok1 = s.y0 >= -1 && s.y0 < H - 2 && nbytes > 0;
  s.src0 = s.ok0 ? img + (s.y0 * W + lo) * C : img;
  s.src1 = s.ok1 ? img + ((s.y0 + 1) * W + lo) * C : img;
  return s;
}

__device__ __forceinline__ int head_of(const uint8_t* p) {
  return (int)(reinterpret_cast<uintptr_t>(p) & 15);
}

// Stage the aligned 16-byte chunks that hold [src, src + nbytes) of both
// source rows into stage (two rows of row_bytes), one cp.async each.
__device__ __forceinline__ void stage_rows(uint8_t* stage, const SourceRows& s, int nbytes,
                                           int row_bytes) {
  const int c0 = s.ok0 ? (head_of(s.src0) + nbytes + 15) >> 4 : 0;
  const int c1 = s.ok1 ? (head_of(s.src1) + nbytes + 15) >> 4 : 0;
  for (int i = threadIdx.x; i < c0 + c1; i += blockDim.x) {
    const bool r = i >= c0;
    const int k = i - (r ? c0 : 0);
    const uint8_t* base = (r ? s.src1 : s.src0) - head_of(r ? s.src1 : s.src0);
    cp_async16(stage + (r ? row_bytes : 0) + 16 * k, base + 16 * k);
  }
  cp_async_commit();
}

// kC > 0: the channel count, unrolled with its constants in registers;
// kC == 0: any C, looped.
template <int kC>
__global__ void __launch_bounds__(256)
    crop_rows_kernel(const uint8_t* __restrict__ frames, const float* __restrict__ boxes,
                     const float* __restrict__ mean, const float* __restrict__ stdv,
                     float* __restrict__ out, float* __restrict__ rf, int H, int W, int C_, int S,
                     float factor, int row_bytes) {
  constexpr int kMaxC = kC > 0 ? kC : 1;
  const int C = kC > 0 ? kC : C_;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* const stages = smem;                     // kRows stages of 2 source rows
  float* const orow = reinterpret_cast<float*>(smem + 2 * kRows * row_bytes);
  const int oy0 = blockIdx.x * kRows;
  const int rows = min(kRows, S - oy0);
  const int b = blockIdx.y;
  const CropGeometry g = crop_geometry(boxes + 4 * b, factor, S);
  // Source x is non-decreasing in the output x, so every row's taps lie in
  // [x0 of the first pixel, x0 of the last + 1]; only [0, W - 2] is sampled.
  const int lo = max((int)floorf(source_coord(0, g.x1, g)), 0);
  const int n = min((int)floorf(source_coord(S - 1, g.x1, g)), W - 3) + 1 - lo + 1;
  const int nbytes = max(n, 0) * C;
  const uint8_t* const img = frames + (size_t)b * H * W * C;

  // Every row's sources are requested at once, one cp.async group per
  // row (an empty group past the last row keeps the counts uniform).
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    if (k < rows)
      stage_rows(stages + k * 2 * row_bytes, source_rows(oy0 + k, g, img, H, W, C, lo, nbytes),
                 nbytes, row_bytes);
    else
      cp_async_commit();
  }
  const float inv255 = __frcp_rn(255.0f);
  float mu[kMaxC], sd[kMaxC], inv_sd[kMaxC];
  if constexpr (kC > 0) {
#pragma unroll
    for (int c = 0; c < kMaxC; ++c) {
      mu[c] = __ldg(mean + c);
      sd[c] = __ldg(stdv + c);
      inv_sd[c] = __frcp_rn(sd[c]);
    }
  }
  if (oy0 == 0 && threadIdx.x == 0) rf[b] = __fdiv_rn((float)S, g.crop_sz);

#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    if (k >= rows) break;
    const int oy = oy0 + k;
    // Row k's group has landed once at most kRows - 1 - k newer ones are
    // pending; the barrier also keeps orow until every thread stored row k - 1.
    cp_async_wait_pending(kRows - 1 - k);
    __syncthreads();

    const SourceRows s = source_rows(oy, g, img, H, W, C, lo, nbytes);
    const uint8_t* const row0 = stages + k * 2 * row_bytes + head_of(s.src0);
    const uint8_t* const row1 = stages + k * 2 * row_bytes + row_bytes + head_of(s.src1);
    const float fy = s.fy;
    const float gy = __fsub_rn(1.0f, fy);
    for (int ox = threadIdx.x; ox < S; ox += blockDim.x) {
      const float xs = source_coord(ox, g.x1, g);
      const float x0f = floorf(xs);
      const float fx = __fsub_rn(xs, x0f);
      const float gx = __fsub_rn(1.0f, fx);
      const int x0 = (int)x0f;
      const bool c0 = x0 >= 0 && x0 < W - 1;
      const bool c1 = x0 >= -1 && x0 < W - 2;
      const int o0 = c0 ? (x0 - lo) * C : 0;
      const int o1 = c1 ? (x0 + 1 - lo) * C : 0;
      const bool t00 = s.ok0 && c0, t01 = s.ok0 && c1;
      const bool t10 = s.ok1 && c0, t11 = s.ok1 && c1;
      const float w00 = __fmul_rn(gy, gx), w01 = __fmul_rn(gy, fx);
      const float w10 = __fmul_rn(fy, gx), w11 = __fmul_rn(fy, fx);
      float* const o = orow + ox * C;
      auto channel = [&](int c, float m, float d, float inv_d) {
        const float p00 = byte_value(t00 ? row0[o0 + c] : 0u);
        const float p01 = byte_value(t01 ? row0[o1 + c] : 0u);
        const float p10 = byte_value(t10 ? row1[o0 + c] : 0u);
        const float p11 = byte_value(t11 ? row1[o1 + c] : 0u);
        float v = __fmul_rn(w00, p00);
        v = __fadd_rn(v, __fmul_rn(w01, p01));
        v = __fadd_rn(v, __fmul_rn(w10, p10));
        v = __fadd_rn(v, __fmul_rn(w11, p11));
        return div_rn(__fsub_rn(div_rn(v, 255.0f, inv255), m), d, inv_d);
      };
      if constexpr (kC > 0) {
#pragma unroll
        for (int c = 0; c < kMaxC; ++c) o[c] = channel(c, mu[c], sd[c], inv_sd[c]);
      } else {
        for (int c = 0; c < C; ++c) {
          const float d = __ldg(stdv + c);
          o[c] = channel(c, __ldg(mean + c), d, __frcp_rn(d));
        }
      }
    }
    __syncthreads();

    // Store the row: 16-byte stores from the 16-byte aligned shared row
    // where the output row is 16-byte aligned too; otherwise scalars up
    // to the first 16-byte boundary, float4s, the tail.
    float* const dst = out + ((size_t)b * S + oy) * S * C;
    const int total = S * C;
    const int lead = min((int)(((16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15) >> 2), total);
    const int n4 = (total - lead) >> 2;
    if (lead == 0) {
      for (int i = threadIdx.x; i < n4; i += blockDim.x)
        reinterpret_cast<float4*>(dst)[i] = reinterpret_cast<const float4*>(orow)[i];
    } else {
      if (threadIdx.x < lead) dst[threadIdx.x] = orow[threadIdx.x];
      for (int i = threadIdx.x; i < n4; i += blockDim.x) {
        const int e = lead + 4 * i;
        *reinterpret_cast<float4*>(dst + e) =
            make_float4(orow[e], orow[e + 1], orow[e + 2], orow[e + 3]);
      }
    }
    for (int e = lead + 4 * n4 + threadIdx.x; e < total; e += blockDim.x) dst[e] = orow[e];
  }
}

}  // namespace

// threads <= 256 and smem_bytes = 2 * kRows * row_bytes + 4 * S * C come
// from ops/crop.py::crop_plan; above 48 KB the kernel is given the larger
// limit.
extern "C" int mmt_crop_resize_normalize(const void* frames, const void* boxes, const void* mean,
                                         const void* stdv, void* out, void* rf, int B, int H,
                                         int W, int C, int S, float factor, int threads,
                                         int row_bytes, int smem_bytes, void* stream) {
  if (B <= 0 || S <= 0 || C <= 0 || threads <= 0 || threads > 256 || row_bytes % 16 ||
      smem_bytes != 2 * kRows * row_bytes + 4 * S * C)
    return (int)cudaErrorInvalidValue;
  auto kernel = C == 6 ? crop_rows_kernel<6> : C == 3 ? crop_rows_kernel<3> : crop_rows_kernel<0>;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((S + kRows - 1) / kRows, B);
  kernel<<<grid, threads, smem_bytes, (cudaStream_t)stream>>>(
      (const uint8_t*)frames, (const float*)boxes, (const float*)mean, (const float*)stdv,
      (float*)out, (float*)rf, H, W, C, S, factor, row_bytes);
  return (int)cudaGetLastError();
}
