// ViPT's deep-prompt re-injection: one prompt step of ViTCEPrompt.forward
// (models/vipt.py; ops/prompt.py::prompt_step_plain) for every lane and
// both parts (template Lz rows, search grid Lx rows), bf16 in and out.
//
//   a = LayerNorm_a(token row; a zero row where CE pruned the grid position)
//   b = LayerNorm_b(previous prompt state row)
//   x0 = a W0^T + b0,  x1 = b W1^T + b1                (768 -> 8)
//   h  = softmax over the part's rows of (x0 * smooth) * x0 + x1
//   p  = h W2^T + b2                                    (8 -> 768)
//   new state row = p; for a live row, token + p
//
// Rounding points are the plain path's: LayerNorm in f32 (mean, then the
// mean of squared deviations; every product and sum rounded on its own,
// no contraction), rounded to bf16; the products accumulated in f32,
// rounded to bf16, then the bias (rounded to bf16) added and rounded; the
// Fovea in f32 (expf, an IEEE division); h rounded to bf16; the residual
// added in f32 and rounded.
//
// Bound: device-memory bytes. A step reads the live tokens and the prompt
// state and writes both back (~55 MB at 32 lanes, C = 768); its ~0.2
// GFLOP of products are far under the bytes. The one reduction across
// rows, the Fovea's softmax over each part, splits the step in two
// kernels:
//  - prompt_proj_kernel, one persistent block per SM over 16-row tiles of
//    one part of one lane: a producer warp brings each tile's token rows
//    (through the lane's live index: no scatter) and state rows into
//    shared memory with the tensor memory accelerator, three tiles ahead;
//    16 consumer warps normalise the rows in place and multiply them by W0
//    and W1 on the tensor cores, and write x0 and x1 (16 bf16, 32 bytes a
//    row) to a small scratch.
//  - prompt_out_kernel, a block per 16 rows: the softmax's max and sum
//    over its part's x0 from the scratch (4 KB a part, from L2) while W2
//    and the live token rows are copied into shared memory; then one warp
//    per two rows forms h and the 8 -> C product on the CUDA cores and
//    writes the state row and, for a live row, token + p.
// A lane's search rows map to live token rows through an inverse of its
// global_index, built in shared memory for each tile.
#include "common.cuh"

namespace {

constexpr int kHide = 8;            // PromptBlock.hide_channel
constexpr int kRowsPerCta = 16;     // rows of one part a tile: one tensor-core tile
constexpr int kC = 768;             // the channels of every ViPT config (ViT-B)
constexpr int kVectors = kC / 8 / 32;   // 16-byte vectors a lane of a row: 3
constexpr int kProjWarps = 16;      // prompt_proj_kernel's consumer warps, and one producer
constexpr int kProjThreads = 32 * (kProjWarps + 1);
constexpr int kStages = 3;          // tiles in flight in prompt_proj_kernel
constexpr int kWarps = 4;           // prompt_out_kernel
constexpr int kThreads = 32 * kWarps;
constexpr int kStatRows = 2;        // x0 rows a prompt_out_kernel thread keeps for the softmax
constexpr unsigned kFull = 0xffffffffu;
static_assert(kRowsPerCta == 16, "prompt_proj_kernel multiplies one 16-row tile");

struct Params {
  const mmt::bf16* tok[2];        // [part] (B, rows, C), rows of C contiguous
  long long tok_stride[2];        // elements between lanes
  const mmt::bf16* st[2];         // previous prompt state, [part] (B, Lz | Lx, C)
  long long st_stride[2];
  const long long* gidx;          // (B, Ll) grid position of each live search row, or null
  const float* ga; const float* ba; float eps_a;   // LayerNorm of the token rows
  const float* gb; const float* bb; float eps_b;   // LayerNorm of the state rows
  const mmt::bf16* w0; const float* b0;            // (8, C), (8,)
  const mmt::bf16* w1; const float* b1;            // (8, C), (8,)
  const mmt::bf16* w2; const float* b2;            // (C, 8), (C,)
  const float* smooth;                             // the Fovea's temperature, (1,)
  mmt::bf16* proj;                // scratch (B, Lz + Lx, 16): x0, x1
  mmt::bf16* out;                 // (B, Lz + Ll, C) tokens + prompt
  mmt::bf16* st_out;              // (B, Lz + Lx, C) new prompt state
  int Lz, Lx, Ll, C;
  int ctas_z;                     // a lane's template tiles (its search tiles follow)
};

__device__ __forceinline__ void unpack8(const uint4& raw, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 t = __bfloat1622float2(h[e]);
    f[2 * e] = t.x;
    f[2 * e + 1] = t.y;
  }
}

__device__ __forceinline__ unsigned pack2(float a, float b) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16(a)) |
         ((unsigned)__bfloat16_as_ushort(__float2bfloat16(b)) << 16);
}

__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]), pack2(f[6], f[7]));
}

// A tile: kRowsPerCta rows of one part (x counts the lane's template
// tiles first) of lane n; `rows` is the number of rows in the part.
struct Tile {
  int n, part, r0, rows;
};

__device__ __forceinline__ Tile tile_of(const Params& p, int x, int n) {
  Tile t;
  t.n = n;
  t.part = x < p.ctas_z ? 0 : 1;
  t.r0 = (t.part ? x - p.ctas_z : x) * kRowsPerCta;
  t.rows = t.part ? p.Lx : p.Lz;
  return t;
}

// One warp builds the tile's live table: live[i] is the token row of the
// tile's row r0 + i, -1 where CE pruned it or past the part. Returns this
// lane's entry (-1 for lanes past the tile's rows).
__device__ __forceinline__ int live_table(const Params& p, const Tile& t, int* live, int lane) {
  const bool ok = lane < kRowsPerCta && t.r0 + lane < t.rows;
  int j = t.r0 + lane;
  if (t.part && p.gidx) {
    if (lane < kRowsPerCta) live[lane] = -1;
    __syncwarp();
    const long long* g = p.gidx + (size_t)t.n * p.Ll;
#pragma unroll 4
    for (int i = lane; i < p.Ll; i += 32) {
      const long long r = g[i] - t.r0;
      if (r >= 0 && r < kRowsPerCta) live[r] = i;
    }
    __syncwarp();
    j = lane < kRowsPerCta ? live[lane] : -1;
  }
  if (!ok) j = -1;
  __syncwarp();
  if (lane < kRowsPerCta) live[lane] = j;
  __syncwarp();
  return j;
}

// LayerNorm of N shared-memory rows of C bf16 in place, interleaved, with
// one gamma and beta: f32 statistics, the result rounded to bf16. gamma
// and beta are float4 [2][C / 8] in shared memory, the first and the
// second four values of each 8-value vector apart, so that a warp's loads
// are consecutive.
template <int N>
__device__ __forceinline__ void layer_norm_rows(mmt::bf16* const (&row)[N], const float4* gamma,
                                                const float4* beta, float eps, int C, int lane) {
  const int nv = C / 8;
  float v[N][kVectors][8];
  float s[N], d2[N], rs[N];
#pragma unroll
  for (int r = 0; r < N; ++r) {
    s[r] = 0.f;
#pragma unroll
    for (int i = 0; i < kVectors; ++i) {
      const int c = lane + 32 * i;
      unpack8(c < nv ? reinterpret_cast<const uint4*>(row[r])[c] : make_uint4(0u, 0u, 0u, 0u),
              v[r][i]);
#pragma unroll
      for (int e = 0; e < 8; ++e) s[r] += v[r][i][e];
    }
  }
#pragma unroll
  for (int r = 0; r < N; ++r) s[r] = mmt::warp_sum(s[r]) / (float)C;
#pragma unroll
  for (int r = 0; r < N; ++r) {
    d2[r] = 0.f;
#pragma unroll
    for (int i = 0; i < kVectors; ++i) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        v[r][i][e] = __fsub_rn(v[r][i][e], s[r]);
        if (lane + 32 * i < nv) d2[r] = __fadd_rn(d2[r], __fmul_rn(v[r][i][e], v[r][i][e]));
      }
    }
  }
#pragma unroll
  for (int r = 0; r < N; ++r) rs[r] = rsqrtf(__fadd_rn(mmt::warp_sum(d2[r]) / (float)C, eps));
#pragma unroll
  for (int i = 0; i < kVectors; ++i) {
    const int c = lane + 32 * i;
    if (c < nv) {
      const float4 ga = gamma[c], gb = gamma[nv + c], ba = beta[c], bb = beta[nv + c];
      const float g[8] = {ga.x, ga.y, ga.z, ga.w, gb.x, gb.y, gb.z, gb.w};
      const float b[8] = {ba.x, ba.y, ba.z, ba.w, bb.x, bb.y, bb.z, bb.w};
#pragma unroll
      for (int r = 0; r < N; ++r) {
        float a[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          a[e] = __fadd_rn(__fmul_rn(__fmul_rn(v[r][i][e], rs[r]), g[e]), b[e]);
        reinterpret_cast<uint4*>(row[r])[c] = pack8(a);
      }
    }
  }
}

// A zero row's LayerNorm, beta rounded to bf16, into a shared-memory row
// (beta laid out as for layer_norm_rows).
__device__ __forceinline__ void beta_row(mmt::bf16* row, const float4* beta, int C, int lane) {
  const int nv = C / 8;
  for (int c = lane; c < nv; c += 32) {
    const float4 ba = beta[c], bb = beta[nv + c];
    const float b[8] = {ba.x, ba.y, ba.z, ba.w, bb.x, bb.y, bb.z, bb.w};
    reinterpret_cast<uint4*>(row)[c] = pack8(b);
  }
}

// 16 bytes from global to shared memory without a register stop; zeros
// where `valid` is false.
__device__ __forceinline__ void copy16_async(void* dst, const void* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// The tensor memory accelerator's bulk copy: `bytes` (a multiple of 16)
// from global to shared memory, counted on the mbarrier `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n"
      "}\n" :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}

// D += A B for one 16 x 8 x 16 tile: bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const mmt::bf16* p) {
  const unsigned addr = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// The consumer warps' own barrier (the producer warp runs on alone).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(32 * kProjWarps) : "memory");
}

// The first pass, one 16-row tile after another (a persistent block per
// SM, W0, W1 and the LayerNorms' parameters staged once in shared
// memory). A producer warp keeps kStages tiles' token and state rows on
// their way into a ring of buffers, one bulk copy a row by the tensor
// memory accelerator, counted on the stage's `full` mbarrier; the 16
// consumer warps release a stage on its `empty` mbarrier once its rows are
// multiplied. Consumer warps 0-7 normalise two token rows each and warps
// 8-15 two state rows each, the pair together and in place (bf16, rows
// padded by 8 so that the tensor-core loads hit distinct banks; a pruned
// grid position's row is beta, a zero row's LayerNorm; the parameters in
// shared memory as layer_norm_rows reads them); then warps 0-7 multiply
// the token rows by W0 and warps 8-15 the state rows by W1 on the tensor
// cores (f32 accumulation), each over every eighth 16-column step, and
// the eight partial sums are added in a fixed order.
__global__ void __launch_bounds__(kProjThreads, 1) prompt_proj_kernel(const Params p, int tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int live[kStages][kRowsPerCta];
  __shared__ float part_sum[kProjWarps / 2][kRowsPerCta][2 * kHide];
  __shared__ __align__(8) unsigned long long full[kStages], empty[kStages];
  static_assert(kProjWarps == kRowsPerCta, "each warp normalises two of the tile's 32 rows");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int C = p.C, nv = C / 8, pitch = C + 8;
  const int per_lane = p.ctas_z + (p.Lx + kRowsPerCta - 1) / kRowsPerCta;
  // [stage][row: 16 token rows, then 16 state rows][pitch], then W0 / W1
  // rows [2][8][pitch], then gamma_a, beta_a, gamma_b, beta_b [4][2][C / 8] float4
  const size_t stage_elems = (size_t)2 * kRowsPerCta * pitch;
  mmt::bf16* buf = reinterpret_cast<mmt::bf16*>(smem);
  mmt::bf16* ws = buf + kStages * stage_elems;
  float* norms = reinterpret_cast<float*>(ws + 2 * kHide * pitch);
  if (threadIdx.x == 0) {
    for (int b = 0; b < kStages; ++b) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(smem_addr(&full[b])));
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(smem_addr(&empty[b])));
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int step = gridDim.x;

  if (warp == kProjWarps) {
    // The producer: each tile's live table (the token row of each tile
    // row, -1 where CE pruned it or past the part), then a bulk copy of
    // every row there is into its stage.
    for (int k = 0, tile = blockIdx.x; tile < tiles; ++k, tile += step) {
      const int b = k % kStages;
      if (k >= kStages) mbar_wait(&empty[b], (k / kStages - 1) & 1);
      const Tile t = tile_of(p, tile % per_lane, tile / per_lane);
      const bool ok = lane < kRowsPerCta && t.r0 + lane < t.rows;
      const int j = live_table(p, t, live[b], lane);
      const unsigned row_bytes = (unsigned)C * sizeof(mmt::bf16);
      const unsigned bytes =
          (__popc(__ballot_sync(kFull, j >= 0)) + __popc(__ballot_sync(kFull, ok))) * row_bytes;
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      if (lane == 0)   // releases the live table to the consumers
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                     :: "r"(smem_addr(&full[b])), "r"(bytes) : "memory");
      __syncwarp();
      mmt::bf16* stage = buf + b * stage_elems;
      if (j >= 0) {
        const mmt::bf16* tok = t.part ? p.tok[1] + (size_t)t.n * p.tok_stride[1]
                                      : p.tok[0] + (size_t)t.n * p.tok_stride[0];
        bulk_copy(stage + (size_t)lane * pitch, tok + (size_t)j * C, row_bytes, &full[b]);
      }
      if (ok) {
        const mmt::bf16* st = t.part ? p.st[1] + (size_t)t.n * p.st_stride[1]
                                     : p.st[0] + (size_t)t.n * p.st_stride[0];
        bulk_copy(stage + (size_t)(kRowsPerCta + lane) * pitch, st + (size_t)(t.r0 + lane) * C,
                  row_bytes, &full[b]);
      }
    }
    return;
  }

  // W0, W1 and the LayerNorms' parameters, while the first tiles arrive
  for (int e = threadIdx.x; e < 2 * kHide * nv; e += 32 * kProjWarps) {
    const int r = e / nv, c = e % nv;
    copy16_async(ws + (size_t)r * pitch + 8 * c,
                 (r < kHide ? p.w0 : p.w1) + ((size_t)(r % kHide) * nv + c) * 8, true);
  }
  for (int e = threadIdx.x; e < C / 4; e += 32 * kProjWarps) {
    const int at = (e & 1) * nv + (e >> 1);     // layer_norm_rows' layout
    copy16_async(norms + 4 * at, p.ga + 4 * e, true);
    copy16_async(norms + 4 * (2 * nv + at), p.ba + 4 * e, true);
    copy16_async(norms + 4 * (4 * nv + at), p.gb + 4 * e, true);
    copy16_async(norms + 4 * (6 * nv + at), p.bb + 4 * e, true);
  }
  copy_async_wait();
  consumers_sync();

  for (int it = 0, tile = blockIdx.x; tile < tiles; ++it, tile += step) {
    const int b = it % kStages;
    mbar_wait(&full[b], (it / kStages) & 1);
    mmt::bf16* rows = buf + b * stage_elems;
    {
      // warps 0-7 normalise token rows w and w + 8, warps 8-15 state rows
      const Tile t = tile_of(p, tile % per_lane, tile / per_lane);
      const int op = warp / 8, i0 = warp % 8;
      const float4* gamma = reinterpret_cast<const float4*>(norms) + op * 4 * nv;
      const float4* beta = gamma + 2 * nv;
      const float eps = op ? p.eps_b : p.eps_a;
      mmt::bf16* r[2];
      bool need[2], fill[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int i = i0 + 8 * q;
        const bool in_part = t.r0 + i < t.rows;
        r[q] = rows + (size_t)(op * kRowsPerCta + i) * pitch;
        need[q] = in_part && (op || live[b][i] >= 0);
        fill[q] = in_part && !need[q];
      }
      if (need[0] && need[1]) {
        layer_norm_rows<2>(r, gamma, beta, eps, C, lane);
      } else if (need[0] || need[1]) {
        mmt::bf16* const one[1] = {need[0] ? r[0] : r[1]};
        layer_norm_rows<1>(one, gamma, beta, eps, C, lane);
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (fill[q]) beta_row(r[q], beta, C, lane);
      }
    }
    consumers_sync();

    const int op = warp / (kProjWarps / 2), part = warp % (kProjWarps / 2);
    const int g = lane >> 2, q = lane & 3;
    const mmt::bf16* W = ws + (size_t)(op * kHide + g) * pitch + 2 * q;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 2
    for (int k0 = 16 * part; k0 < C; k0 += 16 * (kProjWarps / 2)) {
      unsigned a[4];
      ldmatrix_x4(a, rows + (size_t)(op * kRowsPerCta + (lane & 15)) * pitch + k0 +
                         (lane >> 4) * 8);
      mma_bf16(acc, a, *reinterpret_cast<const unsigned*>(W + k0),
               *reinterpret_cast<const unsigned*>(W + k0 + 8));
    }
    part_sum[part][g][op * kHide + 2 * q] = acc[0];
    part_sum[part][g][op * kHide + 2 * q + 1] = acc[1];
    part_sum[part][g + 8][op * kHide + 2 * q] = acc[2];
    part_sum[part][g + 8][op * kHide + 2 * q + 1] = acc[3];
    consumers_sync();
    if (threadIdx.x == 0)   // the stage's rows are read: the producer may refill it
      asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                   :: "r"(smem_addr(&empty[b])) : "memory");

    const Tile t = tile_of(p, tile % per_lane, tile / per_lane);
    mmt::bf16* proj = p.proj + ((size_t)t.n * (p.Lz + p.Lx) + (t.part ? p.Lz : 0)) * 16;
    if (threadIdx.x < kRowsPerCta * 2 * kHide) {
      const int i = threadIdx.x >> 4, k = threadIdx.x & 15;
      if (t.r0 + i < t.rows) {
        float total = part_sum[0][i][k];
#pragma unroll
        for (int w = 1; w < kProjWarps / 2; ++w) total += part_sum[w][i][k];
        const float bias = mmt::round_bf16(k < kHide ? p.b0[k] : p.b1[k - kHide]);
        proj[(size_t)(t.r0 + i) * 16 + k] = __float2bfloat16(mmt::round_bf16(total) + bias);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads) prompt_out_kernel(const Params p) {
  __shared__ int live[kRowsPerCta];
  __shared__ float red[kWarps][kHide];
  __shared__ float stat[2][kHide];
  // W2's rows, swizzled (row r at r ^ ((r >> 3) & 7)), then the block's live token rows,
  // both copied while the block reads the softmax's statistics
  extern __shared__ uint4 w2[];
  const Tile t = tile_of(p, blockIdx.x, blockIdx.y);
  const int C = p.C, nv = C / 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float smooth = *p.smooth;
  uint4* tok_rows = w2 + C;
  for (int r = threadIdx.x; r < C; r += kThreads)
    copy16_async(w2 + (r ^ ((r >> 3) & 7)), reinterpret_cast<const uint4*>(p.w2) + r, true);
  if (warp == 0) live_table(p, t, live, lane);
  __syncthreads();
  const mmt::bf16* tok = t.part ? p.tok[1] + (size_t)t.n * p.tok_stride[1]
                                : p.tok[0] + (size_t)t.n * p.tok_stride[0];
  for (int i = warp; i < kRowsPerCta; i += kWarps) {
    const int j = live[i];
    for (int c = lane; c < nv; c += 32)
      copy16_async(tok_rows + (size_t)i * nv + c, tok + (size_t)max(j, 0) * C + 8 * c, j >= 0);
  }
  const mmt::bf16* proj = p.proj + ((size_t)t.n * (p.Lz + p.Lx) + (t.part ? p.Lz : 0)) * 16;

  // The softmax's max, then its sum of exp, per channel over the part; a
  // thread's first kStatRows rows stay in registers between the passes.
  float x[kStatRows][kHide], m[kHide], s[kHide];
#pragma unroll
  for (int q = 0; q < kStatRows; ++q) {
    const int r = threadIdx.x + q * kThreads;
    unpack8(r < t.rows ? *reinterpret_cast<const uint4*>(proj + (size_t)r * 16)
                       : make_uint4(0u, 0u, 0u, 0u), x[q]);
  }
#pragma unroll
  for (int k = 0; k < kHide; ++k) m[k] = -INFINITY;
#pragma unroll
  for (int q = 0; q < kStatRows; ++q) {
    if (threadIdx.x + q * kThreads < t.rows) {
#pragma unroll
      for (int k = 0; k < kHide; ++k) m[k] = fmaxf(m[k], __fmul_rn(x[q][k], smooth));
    }
  }
  for (int r = threadIdx.x + kStatRows * kThreads; r < t.rows; r += kThreads) {
    float y[8];
    unpack8(*reinterpret_cast<const uint4*>(proj + (size_t)r * 16), y);
#pragma unroll
    for (int k = 0; k < kHide; ++k) m[k] = fmaxf(m[k], __fmul_rn(y[k], smooth));
  }
#pragma unroll
  for (int k = 0; k < kHide; ++k) {
    m[k] = mmt::warp_max(m[k]);
    if (lane == 0) red[warp][k] = m[k];
  }
  __syncthreads();
  if (threadIdx.x < kHide) {
    float v = red[0][threadIdx.x];
    for (int w = 1; w < kWarps; ++w) v = fmaxf(v, red[w][threadIdx.x]);
    stat[0][threadIdx.x] = v;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kHide; ++k) {
    m[k] = stat[0][k];
    s[k] = 0.f;
  }
#pragma unroll
  for (int q = 0; q < kStatRows; ++q) {
    if (threadIdx.x + q * kThreads < t.rows) {
#pragma unroll
      for (int k = 0; k < kHide; ++k) s[k] += expf(__fsub_rn(__fmul_rn(x[q][k], smooth), m[k]));
    }
  }
  for (int r = threadIdx.x + kStatRows * kThreads; r < t.rows; r += kThreads) {
    float y[8];
    unpack8(*reinterpret_cast<const uint4*>(proj + (size_t)r * 16), y);
#pragma unroll
    for (int k = 0; k < kHide; ++k) s[k] += expf(__fsub_rn(__fmul_rn(y[k], smooth), m[k]));
  }
#pragma unroll
  for (int k = 0; k < kHide; ++k) {
    s[k] = mmt::warp_sum(s[k]);
    if (lane == 0) red[warp][k] = s[k];
  }
  copy_async_wait();
  __syncthreads();
  if (threadIdx.x < kHide) {
    float v = red[0][threadIdx.x];
    for (int w = 1; w < kWarps; ++w) v += red[w][threadIdx.x];
    stat[1][threadIdx.x] = v;
  }
  __syncthreads();

  mmt::bf16* st_out = p.st_out + ((size_t)t.n * (p.Lz + p.Lx) + (t.part ? p.Lz : 0)) * C;
  mmt::bf16* out = p.out + ((size_t)t.n * (p.Lz + p.Ll) + (t.part ? p.Lz : 0)) * C;

  for (int i0 = warp; i0 < kRowsPerCta; i0 += 2 * kWarps) {
    // h of two rows: lanes 0-7 the first row's channels, 8-15 the second's
    float hv = 0.f;
    {
      const int q = (lane >> 3) & 1, k = lane & 7, i = i0 + q * kWarps;
      if (lane < 16 && i < kRowsPerCta && t.r0 + i < t.rows) {
        const mmt::bf16* row = proj + (size_t)(t.r0 + i) * 16;
        const float x0 = __bfloat162float(row[k]), x1 = __bfloat162float(row[8 + k]);
        const float e = expf(__fsub_rn(__fmul_rn(x0, smooth), stat[0][k]));
        hv = mmt::round_bf16(__fadd_rn(__fmul_rn(__fdiv_rn(e, stat[1][k]), x0), x1));
      }
    }
    float h[2][kHide];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
#pragma unroll
      for (int k = 0; k < kHide; ++k) h[q][k] = __shfl_sync(kFull, hv, q * 8 + k);
    }
    bool ok[2];
    int j[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int i = i0 + q * kWarps;
      ok[q] = i < kRowsPerCta && t.r0 + i < t.rows;
      j[q] = ok[q] ? live[i] : -1;
    }
#pragma unroll
    for (int v = 0; v < kVectors; ++v) {
      const int c = lane + 32 * v;
      if (c >= nv) continue;
      const float4* b4 = reinterpret_cast<const float4*>(p.b2) + 2 * c;
      const float4 ba = __ldg(b4), bb = __ldg(b4 + 1);
      const float bias[8] = {ba.x, ba.y, ba.z, ba.w, bb.x, bb.y, bb.z, bb.w};
      float acc[2][8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        float w[8];
        unpack8(w2[8 * c + (e ^ (c & 7))], w);
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          float a = 0.f;
#pragma unroll
          for (int k = 0; k < kHide; ++k) a = __fmaf_rn(h[q][k], w[k], a);
          acc[q][e] = __fadd_rn(mmt::round_bf16(a), mmt::round_bf16(bias[e]));
        }
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (!ok[q]) continue;
        const int r = t.r0 + i0 + q * kWarps;
        float pr[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) pr[e] = mmt::round_bf16(acc[q][e]);
        reinterpret_cast<uint4*>(st_out + (size_t)r * C)[c] = pack8(pr);
        if (j[q] >= 0) {
          float x[8];
          unpack8(tok_rows[(size_t)(i0 + q * kWarps) * nv + c], x);
#pragma unroll
          for (int e = 0; e < 8; ++e) x[e] = __fadd_rn(x[e], pr[e]);
          reinterpret_cast<uint4*>(out + (size_t)j[q] * C)[c] = pack8(x);
        }
      }
    }
  }
}

int sm_count() {
  static int n = 0;
  if (!n) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

cudaError_t launch(const Params& p, dim3 grid, cudaStream_t s) {
  const int smem = (kStages * 2 * kRowsPerCta + 2 * kHide) * (p.C + 8) * (int)sizeof(mmt::bf16) +
                   4 * p.C * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(prompt_proj_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int tiles = (int)(grid.x * grid.y);
  prompt_proj_kernel<<<min(tiles, sm_count()), kProjThreads, smem, s>>>(p, tiles);
  prompt_out_kernel<<<grid, kThreads, (p.C + kRowsPerCta * p.C / 8) * (int)sizeof(uint4), s>>>(
      p);
  return cudaGetLastError();
}

}  // namespace

// One prompt step. Requires C == 768 (kC), 16-byte aligned rows
// and an 8-element batch stride for every (B, rows, C) operand, 1 <= Ll <=
// Lx, and Ll == Lx without gidx (checked in Python). tok_*: the token rows
// (search: the Ll live ones); st_*: the previous prompt state (for the
// first block, the auxiliary modality's tokens).
extern "C" int mmt_prompt_step_bf16(
    const void* tok_z, long long tok_z_stride, const void* tok_s, long long tok_s_stride,
    const void* st_z, long long st_z_stride, const void* st_s, long long st_s_stride,
    const void* gidx, const void* ga, const void* ba, float eps_a, const void* gb,
    const void* bb, float eps_b, const void* w0, const void* b0, const void* w1,
    const void* b1, const void* w2, const void* b2, const void* smooth, void* proj, void* out,
    void* st_out, int B, int Lz, int Lx, int Ll, int C, void* stream) {
  if (B <= 0 || Lz <= 0 || Lx <= 0 || Ll <= 0 || Ll > Lx || (!gidx && Ll != Lx) || C != kC)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.tok[0] = (const mmt::bf16*)tok_z;
  p.tok[1] = (const mmt::bf16*)tok_s;
  p.tok_stride[0] = tok_z_stride;
  p.tok_stride[1] = tok_s_stride;
  p.st[0] = (const mmt::bf16*)st_z;
  p.st[1] = (const mmt::bf16*)st_s;
  p.st_stride[0] = st_z_stride;
  p.st_stride[1] = st_s_stride;
  p.gidx = (const long long*)gidx;
  p.ga = (const float*)ga;
  p.ba = (const float*)ba;
  p.eps_a = eps_a;
  p.gb = (const float*)gb;
  p.bb = (const float*)bb;
  p.eps_b = eps_b;
  p.w0 = (const mmt::bf16*)w0;
  p.b0 = (const float*)b0;
  p.w1 = (const mmt::bf16*)w1;
  p.b1 = (const float*)b1;
  p.w2 = (const mmt::bf16*)w2;
  p.b2 = (const float*)b2;
  p.smooth = (const float*)smooth;
  p.proj = (mmt::bf16*)proj;
  p.out = (mmt::bf16*)out;
  p.st_out = (mmt::bf16*)st_out;
  p.Lz = Lz;
  p.Lx = Lx;
  p.Ll = Ll;
  p.C = C;
  p.ctas_z = (Lz + kRowsPerCta - 1) / kRowsPerCta;
  const dim3 grid(p.ctas_z + (Lx + kRowsPerCta - 1) / kRowsPerCta, B);
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)launch(p, grid, s);
}
