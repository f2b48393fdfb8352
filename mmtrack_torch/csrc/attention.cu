// Multi-head self-attention over a short token stream, read straight from
// the fused qkv projection:
//   qkv (B, L, 3C) bf16 = [q_0..q_{H-1} | k_0..k_{H-1} | v_0..v_{H-1}], D = 64
//   out (B, L, C)  bf16, head h at lane offset h * 64 (token-major, ready for
//   the output projection).
//
// Replaces the middle of the TPU kernel
// mmtrack_tpu/ops/flash_attn.py::_attn_block_kernel (:103-121), and the
// whole of mmtrack_tpu/ops/flash_attn.py::flash_mhsa_qkv (:34-85, the same
// function on its own), with their rounding points: q scaled in bf16 before
// the dot; logits and the max-subtracted softmax in f32; the NORMALISED
// probabilities p / sum rounded to bf16 before PV; PV accumulated in f32 and
// rounded to bf16 per head.
//
// Bound: bytes. qkv is read once and out written once (at B=32, L=320: 47 MB
// and 16 MB, ~19 us at 3.35 TB/s), against 10 GFLOP of products (~10 us at
// the bf16 peak). What stands between the kernel and that bound is the
// softmax's f32 work: an accurate expf and a division per logit, many more
// instructions than the product's share of a tensor-core instruction. So
// the design keeps everything but qkv and out on chip, computes each expf
// once where it can, and keeps enough blocks in flight to hide the loads:
//
// * One block per (64 query rows, head, sequence), 4 warps; each warp owns
//   16 query rows. Its Q fragments are loaded once (ldmatrix), scaled in
//   bf16 and kept in registers.
// * K and V of the head stream through a ring of 64-row tiles in shared
//   memory, filled by cp.async (16 B per thread, zero-filled past L) while
//   earlier tiles are in use. Rows are padded to 72 bf16 so that ldmatrix
//   reads are free of bank conflicts. Static shared memory only (45 KB), so
//   no launch needs an opt-in attribute.
// * S = Q K^T runs on mma.sync.m16n8k16 (bf16 -> f32), masked to -inf past
//   L. The normalised rounding point forbids the usual flash form, which
//   rounds unnormalised probabilities and rescales O at the end: every
//   probability needs its row's final max and sum before it is rounded.
// * L <= 320 (every shape of the tracking and training paths): the
//   resident kernel keeps the warp's whole S row in registers (at most
//   5 tiles x 32 f32 per thread). One pass over the K tiles gives S and the
//   exact row max; e = expf(s - max) is taken once per logit, summed, and
//   p = e / sum is rounded to bf16 straight into the A-operand registers of
//   the PV product (the m16n8k16 accumulator layout is the A-fragment
//   layout); then a pass over the V tiles accumulates O += P V in f32
//   registers. Its S row takes up to 160 registers a thread, so only two
//   blocks share an SM; a 4-slot ring filled 3 tiles ahead keeps their
//   loads in flight, and the V tiles arrive while the expf pass runs.
// * L > 320: the streaming kernel makes two passes over the K tiles: the
//   first keeps each row's running max and rescaled sum in registers
//   (rescaling changes only the sum's f32 rounding), the second recomputes
//   S (the same products in the same order), forms p as above and
//   accumulates O += P V, with 2-slot K and V rings. No cap on L.
// * The division p = e / sum is correctly rounded as the plain version's:
//   with r = 1/sum correctly rounded once per row, q = e r and
//   q + (e - q sum) r (two FMAs) is the rounded quotient (Markstein's
//   theorem) for every normal quotient; a subnormal one (p < 2^-126) may
//   differ by one subnormal ulp, far below anything O can show.
// * O is rounded to bf16, staged through the warp's own rows of the Q tile
//   and written with 16-byte stores.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int HD = 64;        // head dim
constexpr int BM = 64;        // query rows per block
constexpr int BN = 64;        // key rows per streamed tile
constexpr int LDS = HD + 8;   // bf16 row stride of every shared tile
constexpr int kThreads = 128;
constexpr int kTile = BM * LDS;
constexpr int kResidentTiles = 5;  // the resident kernel's limit: L <= 320
constexpr int kSlots = 4;          // the resident kernel's ring of K / V tiles

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, asynchronously; `valid` false writes zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// x / y rounded to nearest, given r = 1/y rounded to nearest (Markstein).
__device__ __forceinline__ float div_rn(float x, float y, float r) {
  const float q = __fmul_rn(x, r);
  return __fmaf_rn(__fmaf_rn(-q, y, x), r, q);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Rows [r0, r0 + 64) of one head's 64 columns into a padded tile; rows >= L
// are zero-filled (so masked probabilities multiply zeros, never garbage).
__device__ __forceinline__ void load_tile(mmt::bf16* tile, const mmt::bf16* src, int r0, int L,
                                          int row_stride) {
#pragma unroll
  for (int i = 0; i < BM * HD / 8 / kThreads; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int r = c >> 3;
    const int col = (c & 7) * 8;
    const bool valid = r0 + r < L;
    const mmt::bf16* g = src + (size_t)(valid ? r0 + r : 0) * row_stride + col;
    cp_async16(smem_addr(tile + r * LDS + col), g, valid);
  }
}

// The warp's 16 query rows as A fragments (one per 16 dims), scaled in bf16
// (the scale is a bf16 value, so the product is exact before its rounding).
__device__ __forceinline__ void load_q(uint32_t (&qf)[4][4], const mmt::bf16* Qs, float scale) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    ldmatrix_x4(qf[kk],
                smem_addr(Qs + (warp * 16 + (lane & 15)) * LDS + kk * 16 + (lane >> 4) * 8));
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&qf[kk][e]));
      qf[kk][e] = pack_bf16(f.x * scale, f.y * scale);
    }
  }
}

// S (16 x 64) = Q K^T for one 64-row K tile, columns j0 + ... >= L masked to
// -inf. Accumulator (n, e): row g + 8 (e >> 1), column j0 + 8n + 2t + (e & 1)
// with g = lane / 4, t = lane % 4.
__device__ __forceinline__ void qk_tile(float (&s)[8][4], const uint32_t (&qf)[4][4],
                                        const mmt::bf16* Kt, int j0, int L) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
  const int krow = (lane & 7) + ((lane >> 4) << 3);
  const int kcol = ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      ldmatrix_x4(b, smem_addr(Kt + (np * 16 + krow) * LDS + kk * 16 + kcol));
      mma_bf16(s[2 * np], qf[kk], b[0], b[1]);
      mma_bf16(s[2 * np + 1], qf[kk], b[2], b[3]);
    }
  }
  if (j0 + BN > L) {
    const int t = lane & 3;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (j0 + n * 8 + 2 * t + (e & 1) >= L) s[n][e] = -INFINITY;
  }
}

// The tile's row maxima (rows g, g + 8), reduced over the quad.
__device__ __forceinline__ void tile_max(const float (&s)[8][4], float (&mx)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float v = -INFINITY;
#pragma unroll
    for (int n = 0; n < 8; ++n) v = fmaxf(v, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
    mx[r] = quad_max(v);
  }
}

// P = e / sum rounded to bf16, packed as the A fragments of the PV product
// (the m16n8k16 accumulator layout of S is the A-fragment layout).
__device__ __forceinline__ void probs(uint32_t (&pa)[4][4], const float (&e)[8][4],
                                      const float (&sum)[2], const float (&rcp)[2]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int n = 2 * kk + half;
      pa[kk][2 * half] =
          pack_bf16(div_rn(e[n][0], sum[0], rcp[0]), div_rn(e[n][1], sum[0], rcp[0]));
      pa[kk][2 * half + 1] =
          pack_bf16(div_rn(e[n][2], sum[1], rcp[1]), div_rn(e[n][3], sum[1], rcp[1]));
    }
}

// O += P V for one 64-row V tile.
__device__ __forceinline__ void pv_tile(float (&o)[8][4], const uint32_t (&pa)[4][4],
                                        const mmt::bf16* Vt) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t v[4];
      ldmatrix_x4_trans(v, smem_addr(Vt + (kk * 16 + (lane & 15)) * LDS + np * 16 +
                                     (lane >> 4) * 8));
      mma_bf16(o[2 * np], pa[kk], v[0], v[1]);
      mma_bf16(o[2 * np + 1], pa[kk], v[2], v[3]);
    }
}

// O in bf16 through the warp's own 16 rows of the (dead) Q tile, then
// 16-byte stores of the rows < L.
__device__ __forceinline__ void store_out(const float (&o)[8][4], mmt::bf16* Qs,
                                          mmt::bf16* out, int b, int q0, int L, int C, int h) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  mmt::bf16* Ow = Qs + warp * 16 * LDS;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    *reinterpret_cast<uint32_t*>(Ow + g * LDS + n * 8 + 2 * t) = pack_bf16(o[n][0], o[n][1]);
    *reinterpret_cast<uint32_t*>(Ow + (g + 8) * LDS + n * 8 + 2 * t) =
        pack_bf16(o[n][2], o[n][3]);
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 16 * HD / 8 / 32; ++i) {
    const int c = lane + i * 32;
    const int r = c >> 3;
    const int col = (c & 7) * 8;
    const int q = q0 + warp * 16 + r;
    if (q < L)
      *reinterpret_cast<uint4*>(out + ((size_t)b * L + q) * C + h * HD + col) =
          *reinterpret_cast<const uint4*>(Ow + r * LDS + col);
  }
}

// L <= 64 * NT: S of the warp's rows stays in registers. Stage st < NT
// brings K tile st, stage NT + k V tile k, through a ring of kSlots tiles
// filled kSlots - 1 stages ahead (one commit group per stage, empty past
// the last, so that wait_group counts stay uniform).
template <int NT>
__global__ void __launch_bounds__(kThreads)
attention_resident_kernel(const mmt::bf16* __restrict__ qkv, mmt::bf16* __restrict__ out,
                          int L, int H, float scale) {
  __shared__ __align__(128) mmt::bf16 Qs[kTile];
  __shared__ __align__(128) mmt::bf16 ring[kSlots][kTile];

  const int q0 = blockIdx.x * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int C = H * HD;
  const int row = 3 * C;
  const mmt::bf16* base = qkv + (size_t)b * L * row + h * HD;
  auto stage = [&](int st) {
    if (st < 2 * NT)
      load_tile(ring[st % kSlots], base + (st < NT ? C : 2 * C), (st < NT ? st : st - NT) * BN,
                L, row);
    cp_async_commit();
  };

  load_tile(Qs, base, q0, L, row);
#pragma unroll
  for (int st = 0; st < kSlots - 1; ++st) stage(st);

  uint32_t qf[4][4];
  float s[NT][8][4];
  float m[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int k = 0; k < NT; ++k) {  // S and the row max, K tile by K tile
    stage(k + kSlots - 1);
    cp_async_wait<kSlots - 1>();
    __syncthreads();
    if (k == 0) load_q(qf, Qs, scale);
    qk_tile(s[k], qf, ring[k % kSlots], k * BN, L);
    float mx[2];
    tile_max(s[k], mx);
    m[0] = fmaxf(m[0], mx[0]);
    m[1] = fmaxf(m[1], mx[1]);
    __syncthreads();
  }

  // e = expf(s - max) once per logit, the row sums, then P in bf16
  float part[2] = {0.f, 0.f};
#pragma unroll
  for (int k = 0; k < NT; ++k)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[k][n][e] = expf(s[k][n][e] - m[e >> 1]);
        part[e >> 1] += s[k][n][e];
      }
  const float sum[2] = {quad_sum(part[0]), quad_sum(part[1])};
  const float rcp[2] = {__frcp_rn(sum[0]), __frcp_rn(sum[1])};
  uint32_t p[NT][4][4];
#pragma unroll
  for (int k = 0; k < NT; ++k) probs(p[k], s[k], sum, rcp);

  float o[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
#pragma unroll
  for (int k = 0; k < NT; ++k) {  // O += P V, V tile by V tile
    stage(NT + k + kSlots - 1);
    cp_async_wait<kSlots - 1>();
    __syncthreads();
    pv_tile(o, p[k], ring[(NT + k) % kSlots]);
    __syncthreads();
  }
  store_out(o, Qs, out, b, q0, L, C, h);
}

// Any L: two passes over the K tiles (running max and sum, then P and PV),
// K and V through 2-slot rings.
__global__ void __launch_bounds__(kThreads, 4)
attention_streaming_kernel(const mmt::bf16* __restrict__ qkv, mmt::bf16* __restrict__ out,
                           int L, int H, float scale) {
  __shared__ __align__(128) mmt::bf16 Qs[kTile];
  __shared__ __align__(128) mmt::bf16 Ks[2][kTile];
  __shared__ __align__(128) mmt::bf16 Vs[2][kTile];

  const int q0 = blockIdx.x * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int C = H * HD;
  const int row = 3 * C;
  const mmt::bf16* base = qkv + (size_t)b * L * row + h * HD;
  const int n_tiles = (L + BN - 1) / BN;
  const int stages = 2 * n_tiles;  // pass 1: K tiles; pass 2: K and V tiles

  load_tile(Qs, base, q0, L, row);
  load_tile(Ks[0], base + C, 0, L, row);
  cp_async_commit();

  uint32_t qf[4][4];
  float m[2] = {-INFINITY, -INFINITY};
  float sum[2] = {0.f, 0.f};
  float rcp[2] = {0.f, 0.f};
  float o[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  for (int st = 0; st < stages; ++st) {
    if (st + 1 < stages) {
      const int nx = st + 1;
      const int tile = nx < n_tiles ? nx : nx - n_tiles;
      load_tile(Ks[nx & 1], base + C, tile * BN, L, row);
      if (nx >= n_tiles) load_tile(Vs[nx & 1], base + 2 * C, tile * BN, L, row);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (st == 0) load_q(qf, Qs, scale);

    const int tile = st < n_tiles ? st : st - n_tiles;
    float s[8][4];
    qk_tile(s, qf, Ks[st & 1], tile * BN, L);
    if (st < n_tiles) {  // pass 1: running max and rescaled sum of each row
      float mx[2];
      tile_max(s, mx);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m[r], mx[r]);
        float part = 0.f;
#pragma unroll
        for (int n = 0; n < 8; ++n)
          part += expf(s[n][2 * r] - m_new) + expf(s[n][2 * r + 1] - m_new);
        sum[r] = sum[r] * expf(m[r] - m_new) + quad_sum(part);
        m[r] = m_new;
      }
      if (st == n_tiles - 1) {
        rcp[0] = __frcp_rn(sum[0]);
        rcp[1] = __frcp_rn(sum[1]);
      }
    } else {  // pass 2: e = expf(s - max), P = e / sum, O += P V
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = expf(s[n][e] - m[e >> 1]);
      uint32_t pa[4][4];
      probs(pa, s, sum, rcp);
      pv_tile(o, pa, Vs[st & 1]);
    }
    __syncthreads();  // the slot just read is refilled next stage
  }
  store_out(o, Qs, out, b, q0, L, C, h);
}

template <int NT>
void launch_resident(const dim3& grid, cudaStream_t stream, const void* qkv, void* out, int L,
                     int H, float scale) {
  attention_resident_kernel<NT><<<grid, kThreads, 0, stream>>>(
      (const mmt::bf16*)qkv, (mmt::bf16*)out, L, H, scale);
}

}  // namespace

// head dim must be 64; `scale` must already be rounded to bf16; qkv and out
// 16-byte aligned. Any L >= 1.
extern "C" int mmt_attention_bf16(const void* qkv, void* out, int B, int L, int H, float scale,
                                  void* stream) {
  const int n_tiles = (L + BN - 1) / BN;
  const dim3 grid(n_tiles, H, B);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (n_tiles) {
    case 1: launch_resident<1>(grid, s, qkv, out, L, H, scale); break;
    case 2: launch_resident<2>(grid, s, qkv, out, L, H, scale); break;
    case 3: launch_resident<3>(grid, s, qkv, out, L, H, scale); break;
    case 4: launch_resident<4>(grid, s, qkv, out, L, H, scale); break;
    case 5: launch_resident<5>(grid, s, qkv, out, L, H, scale); break;
    default:
      attention_streaming_kernel<<<grid, kThreads, 0, s>>>((const mmt::bf16*)qkv,
                                                           (mmt::bf16*)out, L, H, scale);
  }
  static_assert(kResidentTiles == 5, "the switch above instantiates 1..5 tiles");
  return (int)cudaGetLastError();
}
