// Cached-prefill attention for Hopper (sm_90a): a chunk of T fresh query
// tokens per sequence attends causally to its context, read from the
// layer-stacked page pool [L, NB, bs, KVH, D]. The chunk's own K/V were
// scattered into the pages one op earlier, so the cached prefix and the
// chunk are one key stream.
//
// Replaces the TPU kernel production_stack_tpu/ops/pallas_prefill_attention.py
// ::pallas_prefill_attention (body _prefill_kernel). The Pallas kernel
// streamed only the prefix pages (the chunk's K/V sat in VMEM) and left
// the fresh suffix and the flash merge to XLA; here one kernel walks
// keys 0 .. total_len from the pages, whose last few tiles were just
// written and are still in L2, and the result leaves it normalised in
// q's dtype. Contract kept from the TPU version: q is pre-scaled by
// 1/sqrt(D) and cast back to its dtype; positions ascend along a row.
// Key j is visible to query t iff j <= positions[t] and j < total_len
// (total_len clamped to the table width, never trusting table contents
// past it), the mask of ops/attention.py::_context_prefill_reference.
// Padded query rows (past the chunk's valid tokens) are computed and
// left to the caller to discard.
//
// Both modes of the Pallas kernel: pages in q's dtype, or int8 codes with
// float32 scales [L, NB, bs * KVH] (one per (slot, kv head), flat and
// token-major), each loaded row multiplied by its scale as it lands in
// the f32 shared tiles. With int8 pages the chunk's own keys come back
// from the pages they were just quantized into, as in the plain version;
// the Pallas kernel attended them at full precision from k_new / v_new,
// so under int8 its results differ from both by one quantization step on
// the chunk's own keys and values.
//
// Bound on an H100: operations. A 1024-token chunk over a 1024-token
// prefix does ~4 * H * D flops per (query, key) pair, about 140 flops
// per byte of K/V read, and the attention is compute-bound once the
// products run on tensor cores. Design of this first version: one block
// per (query tile, kv head, sequence) holds 64 query rows (TQ tokens x G
// heads of the group, so every K/V byte loaded to shared memory serves
// all G heads), streams 32-key tiles from the row's live pages up to
// the tile's last query position, and keeps an f32 online softmax. int8
// pages halve the bytes read but leave the operations, so the bound does
// not move.
// Products run on the CUDA cores in f32 with 4x4 register tiles for
// Q.K^T and 8-wide rows for P.V; moving them to wgmma is the next step.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 64;  // query rows per block (TQ tokens x G heads)
constexpr int kTK = 32;    // keys per tile == warp size

// T: the type of q and out (float or bf16); P: the page type (T, or
// int8_t for quantized pages, which then come with their scales).
template <typename T, typename P, int D>
__global__ void __launch_bounds__(kThreads) prefill_kernel(
    const T* __restrict__ q,               // [B, T, H, D] pre-scaled
    const P* __restrict__ k_pages,         // [L, NB, bs, KVH, D]
    const P* __restrict__ v_pages,
    const float* __restrict__ k_scales,    // [L, NB, bs * KVH] (int8 only)
    const float* __restrict__ v_scales,
    const int* __restrict__ block_tables,  // [B, MAXB]
    const int* __restrict__ positions,     // [B, T] ascending
    const int* __restrict__ total_lens,    // [B]
    T* __restrict__ out,                   // [B, T, H, D]
    int T_len, int H, int KVH, int NB, int bs, int MAXB, int layer, int TQ) {
  constexpr int D8 = D / 8;
  constexpr bool kQuantized = std::is_same<P, int8_t>::value;
  constexpr int QS = D + 4;               // padded row stride of q_sh / k_sh
  constexpr int SS = kTK + 1;             // row stride of s_sh
  constexpr int DG = D / 8;               // P.V: d-groups of 8
  constexpr int RPT = kRows * DG / kThreads;  // P.V: rows per thread
  static_assert(RPT * (kThreads / DG) == kRows, "row split");

  const int qt = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / KVH;
  const int rows = G * TQ;  // live rows of this block (<= kRows)
  const int t0 = qt * TQ;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  extern __shared__ __align__(16) float smem[];
  float* q_sh = smem;                  // [kRows][QS]
  float* k_sh = q_sh + kRows * QS;     // [kTK][QS]
  float* v_sh = k_sh + kTK * QS;       // [kTK][D]
  float* s_sh = v_sh + kTK * D;        // [kRows][SS]
  float* m_sh = s_sh + kRows * SS;     // [kRows]
  float* l_sh = m_sh + kRows;          // [kRows]
  float* alpha_sh = l_sh + kRows;      // [kRows]

  // Row r is query token t0 + r / G, head kvh * G + r % G.
  for (int i = tid; i < kRows * D8; i += kThreads) {
    const int r = i / D8;
    const int d8 = i % D8;
    const int t = t0 + r / G;
    float tmp[8];
    if (r < rows && t < T_len) {
      load8(q + (((size_t)b * T_len + t) * H + (size_t)kvh * G + r % G) * D +
                d8 * 8,
            tmp);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) tmp[j] = 0.f;
    }
    store8(q_sh + r * QS + d8 * 8, tmp);
  }
  if (tid < kRows) {
    m_sh[tid] = KERNEL_NEG_INF;
    l_sh[tid] = 0.f;
  }

  float acc[RPT][8];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int total = max(0, min(total_lens[b], MAXB * bs));
  const int* pos = positions + (size_t)b * T_len;
  // Keys some query of this tile can see: up to its last token's position.
  const int n_keys = min(total, pos[min(t0 + TQ, T_len) - 1] + 1);
  const int* bt = block_tables + (size_t)b * MAXB;
  const size_t layer_pages = (size_t)layer * NB;
  // S = Q.K^T tiling: rows rg + 16 i, keys tg + 8 j.
  const int tg = tid % 8;
  const int rg = tid / 8;
  int row_pos[4];  // absolute position of each of this thread's S rows
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = rg + 16 * i;
    const int t = t0 + r / G;
    row_pos[i] = (r < rows && t < T_len) ? pos[t] : -1;
  }
  // P.V tiling: rows pr * RPT + i, columns dg * 8 .. dg * 8 + 7.
  const int dg = tid % DG;
  const int pr = tid / DG;
  __syncthreads();

  for (int k0 = 0; k0 < n_keys; k0 += kTK) {
    const int n = min(kTK, n_keys - k0);
    for (int i = tid; i < kTK * D8; i += kThreads) {
      const int c = i / D8;
      const int d8 = i % D8;
      float kt[8], vt[8];
      if (c < n) {
        const int key = k0 + c;
        const size_t page = (size_t)bt[key / bs];
        // The (key, kv head) row: of D elements in the pages, of one
        // scale in the scales.
        const size_t row = ((layer_pages + page) * bs + key % bs) * KVH + kvh;
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
      store8(k_sh + c * QS + d8 * 8, kt);
      store8(v_sh + c * D + d8 * 8, vt);
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(q_sh + (rg + 16 * i) * QS + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(k_sh + (tg + 8 * j) * QS + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rg + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tg + 8 * j;
        const bool live = c < n && k0 + c <= row_pos[i];
        s_sh[r * SS + c] = live ? s[i][j] : KERNEL_NEG_INF;
      }
    }
    __syncthreads();

    for (int r = warp; r < kRows; r += kThreads / 32) {
      const float sc = s_sh[r * SS + lane];
      const float m_prev = m_sh[r];
      const float m_new = fmaxf(m_prev, warp_max(sc));
      const float p = masked_exp(sc, m_new);
      const float sum = warp_sum(p);
      s_sh[r * SS + lane] = p;
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        alpha_sh[r] = alpha;
        l_sh[r] = l_sh[r] * alpha + sum;
        m_sh[r] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const float a = alpha_sh[pr * RPT + i];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] *= a;
    }
    for (int c = 0; c < n; ++c) {
      const float4 va = *reinterpret_cast<const float4*>(v_sh + c * D + dg * 8);
      const float4 vb = *reinterpret_cast<const float4*>(v_sh + c * D + dg * 8 + 4);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float p = s_sh[(pr * RPT + i) * SS + c];
        acc[i][0] = fmaf(p, va.x, acc[i][0]);
        acc[i][1] = fmaf(p, va.y, acc[i][1]);
        acc[i][2] = fmaf(p, va.z, acc[i][2]);
        acc[i][3] = fmaf(p, va.w, acc[i][3]);
        acc[i][4] = fmaf(p, vb.x, acc[i][4]);
        acc[i][5] = fmaf(p, vb.y, acc[i][5]);
        acc[i][6] = fmaf(p, vb.z, acc[i][6]);
        acc[i][7] = fmaf(p, vb.w, acc[i][7]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = pr * RPT + i;
    const int t = t0 + r / G;
    if (r < rows && t < T_len) {
      const float inv = 1.f / fmaxf(l_sh[r], 1e-30f);
      float o[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) o[j] = acc[i][j] * inv;
      store8(out + (((size_t)b * T_len + t) * H + (size_t)kvh * G + r % G) * D +
                 dg * 8,
             o);
    }
  }
}

size_t smem_bytes(int D) {
  return sizeof(float) * (size_t)(kRows * (D + 4) + kTK * (D + 4) + kTK * D +
                                  kRows * (kTK + 1) + 3 * kRows);
}

struct Args {
  const void *q, *k, *v, *k_scales, *v_scales, *bt, *positions, *total_lens;
  void* out;
  int B, T_len, H, KVH, NB, bs, MAXB, layer;
  cudaStream_t stream;
};

template <typename T, typename P, int D>
int launch(const Args& a) {
  const int G = a.H / a.KVH;
  const int TQ = kRows / G;
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      prefill_kernel<T, P, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.T_len + TQ - 1) / TQ, a.KVH, a.B);
  prefill_kernel<T, P, D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const P*>(a.k),
      static_cast<const P*>(a.v), static_cast<const float*>(a.k_scales),
      static_cast<const float*>(a.v_scales), static_cast<const int*>(a.bt),
      static_cast<const int*>(a.positions),
      static_cast<const int*>(a.total_lens), static_cast<T*>(a.out), a.T_len,
      a.H, a.KVH, a.NB, a.bs, a.MAXB, a.layer, TQ);
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
// scales. Requires H / KVH <= 64. Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int prefill_attention_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scales, const void* v_scales, const void* block_tables,
    const void* positions, const void* total_lens, void* out, int B,
    int T_len, int H, int KVH, int D, int NB, int bs, int MAXB, int layer,
    int dtype, int int8_pages, void* stream) {
  if (B == 0 || T_len == 0) return 0;
  if (H % KVH != 0 || H / KVH > kRows) return (int)cudaErrorInvalidValue;
  const Args a{q, k_pages, v_pages, k_scales, v_scales, block_tables,
               positions, total_lens, out, B, T_len, H, KVH, NB, bs, MAXB,
               layer, static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return launch_p<float>(int8_pages, D, a);
  if (dtype == 1) return launch_p<__nv_bfloat16>(int8_pages, D, a);
  return (int)cudaErrorInvalidValue;
}

KERNEL_ERROR_STRING_FN
