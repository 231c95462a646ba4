// Paged decode attention for Hopper (sm_90a): one query token per
// sequence attends over that sequence's KV pages in the layer-stacked
// pool [L, NB, bs, KVH, D].
//
// Replaces the TPU kernel production_stack_tpu/ops/pallas_paged_attention.py
// ::pallas_paged_attention (body _decode_kernel), in both of its modes.
// Same contract: q is pre-scaled by 1/sqrt(D) and cast back to its dtype
// by the wrapper; block tables are zero-filled past the live pages, so
// every read is bounded by context_len (clamped to the table width),
// never by table contents; output [B, H, D] in q's dtype. Pages are in
// q's dtype, or (quantized=True there) int8 codes with float32 scales
// [L, NB, bs * KVH], one per (slot, kv head), flat and token-major, so a
// (token, kv head) row has the same index in the data (times D) and in
// the scales; each loaded row is multiplied by its scale as it lands in
// the f32 shared tiles.
//
// Bound on an H100: bytes. Each (sequence, kv head) reads ctx * D * 2
// elements of K/V and does 4 * G * D flops per token, far below the
// ~295 flops/byte the card needs to be compute-bound. int8 pages halve
// the bytes: at 8 sequences x 2048 tokens (Llama-3-8B, 8 kv heads, D 128)
// 33.6 MB of codes plus 1.05 MB of scales, 0.0103 ms at 3.35 TB/s,
// against 67.1 MB and 0.020 ms in bf16. Design: one block
// per (kv head, sequence) holds its G = H/KVH query rows, walks the
// block table tile by tile (32 tokens; a page is any number of tiles or
// a tile spans pages, so any block size and any table width work), and
// keeps an f32 online softmax in shared memory. Loads are 16-byte
// vectors along D, so a warp reads whole contiguous rows. This first
// version has no split-K and no asynchronous prefetch: with few
// sequences the grid (B * KVH blocks) does not fill the 132 SMs, which
// is the first thing a faster version changes.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 32;  // tokens per tile == warp size (one lane per token)

// T: the type of q and out (float or bf16); P: the page type (T, or
// int8_t for quantized pages, which then come with their scales).
template <typename T, typename P, int D>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const T* __restrict__ q,               // [B, H, D] pre-scaled
    const P* __restrict__ k_pages,         // [L, NB, bs, KVH, D]
    const P* __restrict__ v_pages,         // [L, NB, bs, KVH, D]
    const float* __restrict__ k_scales,    // [L, NB, bs * KVH] (int8 only)
    const float* __restrict__ v_scales,
    const int* __restrict__ block_tables,  // [B, MAXB]
    const int* __restrict__ context_lens,  // [B]
    T* __restrict__ out,                   // [B, H, D]
    int H, int KVH, int NB, int bs, int MAXB, int layer) {
  constexpr int D8 = D / 8;
  constexpr bool kQuantized = std::is_same<P, int8_t>::value;
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / KVH;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  constexpr int kWarps = kThreads / 32;

  extern __shared__ float smem[];
  float* q_sh = smem;                      // [G][D]
  float* acc_sh = q_sh + G * D;            // [G][D]
  float* k_sh = acc_sh + G * D;            // [kTile][D + 1]
  float* v_sh = k_sh + kTile * (D + 1);    // [kTile][D]
  float* s_sh = v_sh + kTile * D;          // [G][kTile]
  float* m_sh = s_sh + G * kTile;          // [G]
  float* l_sh = m_sh + G;                  // [G]
  float* alpha_sh = l_sh + G;              // [G]

  const size_t q_base = ((size_t)b * H + (size_t)kvh * G) * D;
  for (int i = tid; i < G * D8; i += kThreads) {
    float tmp[8];
    load8(q + q_base + (size_t)i * 8, tmp);
#pragma unroll
    for (int j = 0; j < 8; ++j) q_sh[i * 8 + j] = tmp[j];
  }
  for (int i = tid; i < G * D; i += kThreads) acc_sh[i] = 0.f;
  if (tid < G) {
    m_sh[tid] = KERNEL_NEG_INF;
    l_sh[tid] = 0.f;
  }
  const int ctx = max(0, min(context_lens[b], MAXB * bs));
  const int* bt = block_tables + (size_t)b * MAXB;
  const size_t layer_pages = (size_t)layer * NB;
  __syncthreads();

  for (int start = 0; start < ctx; start += kTile) {
    const int n = min(kTile, ctx - start);
    for (int i = tid; i < kTile * D8; i += kThreads) {
      const int t = i / D8;
      const int d8 = i % D8;
      float kt[8], vt[8];
      if (t < n) {
        const int tok = start + t;
        const size_t page = (size_t)bt[tok / bs];
        // The (token, kv head) row: of D elements in the pages, of one
        // scale in the scales.
        const size_t row = ((layer_pages + page) * bs + tok % bs) * KVH + kvh;
        load8(k_pages + row * D + d8 * 8, kt);
        load8(v_pages + row * D + d8 * 8, vt);
        if constexpr (kQuantized) {
          scale8(kt, k_scales[row]);
          scale8(vt, v_scales[row]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) kt[j] = vt[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        k_sh[t * (D + 1) + d8 * 8 + j] = kt[j];
        v_sh[t * D + d8 * 8 + j] = vt[j];
      }
    }
    __syncthreads();

    for (int i = tid; i < G * kTile; i += kThreads) {
      const int g = i / kTile;
      const int t = i % kTile;
      float s = KERNEL_NEG_INF;
      if (t < n) {
        const float* qr = q_sh + g * D;
        const float* kr = k_sh + t * (D + 1);
        float a = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) a = fmaf(qr[d], kr[d], a);
        s = a;
      }
      s_sh[g * kTile + t] = s;
    }
    __syncthreads();

    for (int g = warp; g < G; g += kWarps) {
      const float s = s_sh[g * kTile + lane];
      const float m_prev = m_sh[g];
      const float m_new = fmaxf(m_prev, warp_max(s));
      const float p = masked_exp(s, m_new);
      const float sum = warp_sum(p);
      s_sh[g * kTile + lane] = p;
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        alpha_sh[g] = alpha;
        l_sh[g] = l_sh[g] * alpha + sum;
        m_sh[g] = m_new;
      }
    }
    __syncthreads();

    for (int i = tid; i < G * D; i += kThreads) {
      const int g = i / D;
      const int d = i % D;
      const float* pr = s_sh + g * kTile;
      float a = acc_sh[i] * alpha_sh[g];
      for (int t = 0; t < n; ++t) a = fmaf(pr[t], v_sh[t * D + d], a);
      acc_sh[i] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D;
    store1(out + q_base + i, acc_sh[i] / fmaxf(l_sh[g], 1e-30f));
  }
}

size_t smem_bytes(int G, int D) {
  return sizeof(float) *
         (size_t)(2 * G * D + kTile * (D + 1) + kTile * D + G * kTile + 3 * G);
}

struct Args {
  const void *q, *k, *v, *k_scales, *v_scales, *bt, *ctx;
  void* out;
  int B, H, KVH, NB, bs, MAXB, layer;
  cudaStream_t stream;
};

template <typename T, typename P, int D>
int launch(const Args& a) {
  const size_t smem = smem_bytes(a.H / a.KVH, D);
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_kernel<T, P, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(a.KVH, a.B);
  paged_decode_kernel<T, P, D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const P*>(a.k),
      static_cast<const P*>(a.v), static_cast<const float*>(a.k_scales),
      static_cast<const float*>(a.v_scales), static_cast<const int*>(a.bt),
      static_cast<const int*>(a.ctx), static_cast<T*>(a.out), a.H, a.KVH,
      a.NB, a.bs, a.MAXB, a.layer);
  return (int)cudaGetLastError();
}

template <typename T, typename P>
int launch_d(int D, const Args& a) {
  switch (D) {
    case 32: return launch<T, P, 32>(a);
    case 64: return launch<T, P, 64>(a);
    case 128: return launch<T, P, 128>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch_p(int int8_pages, int D, const Args& a) {
  if (!int8_pages) return launch_d<T, T>(D, a);
  if (a.k_scales == nullptr || a.v_scales == nullptr)
    return (int)cudaErrorInvalidValue;
  return launch_d<T, int8_t>(D, a);
}

}  // namespace

// dtype (of q and out): 0 = float32, 1 = bfloat16. int8_pages: 0 = pages
// in q's dtype (the scales are ignored), 1 = int8 pages with float32
// scales. Returns cudaGetLastError() after the launch (0 on success).
extern "C" int paged_attention_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scales, const void* v_scales, const void* block_tables,
    const void* context_lens, void* out, int B, int H, int KVH, int D, int NB,
    int bs, int MAXB, int layer, int dtype, int int8_pages, void* stream) {
  if (B == 0) return 0;
  const Args a{q, k_pages, v_pages, k_scales, v_scales, block_tables,
               context_lens, out, B, H, KVH, NB, bs, MAXB, layer,
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return launch_p<float>(int8_pages, D, a);
  if (dtype == 1) return launch_p<__nv_bfloat16>(int8_pages, D, a);
  return (int)cudaErrorInvalidValue;
}

KERNEL_ERROR_STRING_FN
