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
// the dot; logits and the
// max-subtracted softmax in f32; probabilities rounded to bf16 before PV;
// PV accumulated in f32 and rounded to bf16 per head.
//
// Bound: L <= 320 tokens, so one head's K and V (<= 320 x 64 bf16 each,
// 80 KB together) fit in shared memory with room for a full row of logits.
// No online-softmax tiling is needed: one block per (query tile of 32 rows,
// head, batch) stages K, V and its Q tile once, computes the 32 x L logits
// on the tensor cores (WMMA m16n16k16), does an exact softmax per row with
// warp shuffles, and runs PV on the tensor cores. The cost is dominated by
// restaging K and V for every query tile (L/32 times per head) from L2;
// later work can keep them resident across query tiles or fuse the qkv GEMM.
// Ragged L (244, 190, 153 after candidate elimination) is handled by
// zero-padding K/V/Q rows to a multiple of 16 and masking the padded
// columns out of the softmax.
#include <math.h>
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int HD = 64;        // head dim
constexpr int QT = 32;        // query rows per block
constexpr int LDKV = HD + 8;  // bf16 row stride of K, V and Q tiles
constexpr int LDO = HD + 4;   // f32 row stride of the output tile
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

__host__ __device__ inline int s_stride(int Lpad) { return Lpad + 4; }  // f32 logits
__host__ __device__ inline int p_stride(int Lpad) { return Lpad + 8; }  // bf16 probs
__host__ __device__ inline int s_floats(int Lpad) {
  return QT * (s_stride(Lpad) > LDO ? s_stride(Lpad) : LDO);  // also holds the output tile
}

size_t smem_bytes(int Lpad) {
  return (size_t)2 * Lpad * LDKV * sizeof(mmt::bf16)     // K, V
         + (size_t)QT * LDKV * sizeof(mmt::bf16)         // Q tile
         + (size_t)s_floats(Lpad) * sizeof(float)        // logits / output
         + (size_t)QT * p_stride(Lpad) * sizeof(mmt::bf16);  // probabilities
}

__global__ void __launch_bounds__(kThreads)
attention_bf16_kernel(const mmt::bf16* __restrict__ qkv, mmt::bf16* __restrict__ out, int L,
                      int H, int Lpad, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  mmt::bf16* Ks = reinterpret_cast<mmt::bf16*>(smem);
  mmt::bf16* Vs = Ks + Lpad * LDKV;
  mmt::bf16* Qs = Vs + Lpad * LDKV;
  float* S = reinterpret_cast<float*>(Qs + QT * LDKV);
  mmt::bf16* P = reinterpret_cast<mmt::bf16*>(S + s_floats(Lpad));
  float* O = S;  // the logits are dead once P is written
  const int lds = s_stride(Lpad);
  const int ldp = p_stride(Lpad);

  const int q0 = blockIdx.x * QT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int C = H * HD;
  const size_t row = (size_t)3 * C;
  const mmt::bf16* base = qkv + (size_t)b * L * row;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  // K and V of head h, rows >= L zero-filled up to Lpad.
  for (int v = tid; v < Lpad * (HD / 8); v += kThreads) {
    const int r = v / (HD / 8);
    const int c = (v % (HD / 8)) * 8;
    uint4 kv = zero, vv = zero;
    if (r < L) {
      kv = *reinterpret_cast<const uint4*>(base + r * row + C + h * HD + c);
      vv = *reinterpret_cast<const uint4*>(base + r * row + 2 * C + h * HD + c);
    }
    *reinterpret_cast<uint4*>(Ks + r * LDKV + c) = kv;
    *reinterpret_cast<uint4*>(Vs + r * LDKV + c) = vv;
  }
  // Q tile, scaled in bf16 (the scale itself is already a bf16 value).
  for (int v = tid; v < QT * (HD / 8); v += kThreads) {
    const int r = v / (HD / 8);
    const int c = (v % (HD / 8)) * 8;
    __align__(16) mmt::bf16 q[8];
    if (q0 + r < L) {
      const uint4 raw = *reinterpret_cast<const uint4*>(base + (q0 + r) * row + h * HD + c);
      const mmt::bf16* rq = reinterpret_cast<const mmt::bf16*>(&raw);
#pragma unroll
      for (int e = 0; e < 8; ++e) q[e] = __float2bfloat16(__bfloat162float(rq[e]) * scale);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) q[e] = __float2bfloat16(0.f);
    }
    *reinterpret_cast<uint4*>(Qs + r * LDKV + c) = *reinterpret_cast<const uint4*>(q);
  }
  __syncthreads();

  // Logits S = Q K^T, (QT/16) x (Lpad/16) fragments spread over the warps.
  const int nt = Lpad / 16;
  for (int t = warp; t < (QT / 16) * nt; t += kWarps) {
    const int i = t / nt;
    const int j = t % nt;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
#pragma unroll
    for (int kk = 0; kk < HD; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, mmt::bf16, wmma::row_major> fa;
      // K^T as a col-major (D x Lpad) operand: element (d, j) at Ks[j * LDKV + d].
      wmma::fragment<wmma::matrix_b, 16, 16, 16, mmt::bf16, wmma::col_major> fb;
      wmma::load_matrix_sync(fa, Qs + (16 * i) * LDKV + kk, LDKV);
      wmma::load_matrix_sync(fb, Ks + (16 * j) * LDKV + kk, LDKV);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(S + (16 * i) * lds + 16 * j, acc, lds, wmma::mem_row_major);
  }
  __syncthreads();

  // Softmax over the L valid columns of each row; padded columns get p = 0.
  for (int r = warp; r < QT; r += kWarps) {
    float* sr = S + r * lds;
    mmt::bf16* prow = P + r * ldp;
    float m = -INFINITY;
    for (int j = lane; j < L; j += 32) m = fmaxf(m, sr[j]);
    m = mmt::warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < L; j += 32) {
      const float e = expf(sr[j] - m);
      sr[j] = e;
      sum += e;
    }
    sum = mmt::warp_sum(sum);
    for (int j = lane; j < Lpad; j += 32) prow[j] = __float2bfloat16(j < L ? sr[j] / sum : 0.f);
  }
  __syncthreads();

  // Output O = P V, (QT/16) x (HD/16) fragments, Lpad/16 steps each.
  for (int t = warp; t < (QT / 16) * (HD / 16); t += kWarps) {
    const int i = t / (HD / 16);
    const int n = t % (HD / 16);
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int kk = 0; kk < Lpad; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, mmt::bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, mmt::bf16, wmma::row_major> fb;
      wmma::load_matrix_sync(fa, P + (16 * i) * ldp + kk, ldp);
      wmma::load_matrix_sync(fb, Vs + kk * LDKV + 16 * n, LDKV);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(O + (16 * i) * LDO + 16 * n, acc, LDO, wmma::mem_row_major);
  }
  __syncthreads();

  for (int v = tid; v < QT * (HD / 8); v += kThreads) {
    const int r = v / (HD / 8);
    const int c = (v % (HD / 8)) * 8;
    if (q0 + r >= L) continue;
    __align__(16) mmt::bf16 o[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) o[e] = __float2bfloat16(O[r * LDO + c + e]);
    *reinterpret_cast<uint4*>(out + ((size_t)b * L + q0 + r) * C + h * HD + c) =
        *reinterpret_cast<const uint4*>(o);
  }
}

}  // namespace

// Largest token count the shared-memory plan admits (checked in Python).
extern "C" int mmt_attention_max_tokens(void) {
  int best = 0;
  for (int Lpad = 16; smem_bytes(Lpad) <= 232448; Lpad += 16) best = Lpad;
  return best;
}

// head dim must be 64; `scale` must already be rounded to bf16.
extern "C" int mmt_attention_bf16(const void* qkv, void* out, int B, int L, int H, float scale,
                                  void* stream) {
  const int Lpad = (L + 15) / 16 * 16;
  const size_t smem = smem_bytes(Lpad);
  cudaError_t err = cudaFuncSetAttribute(attention_bf16_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((L + QT - 1) / QT, H, B);
  attention_bf16_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const mmt::bf16*)qkv, (mmt::bf16*)out, L, H, Lpad, scale);
  return (int)cudaGetLastError();
}
