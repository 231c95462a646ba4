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
// the scales.
//
// Bound on an H100: bytes. Each (sequence, kv head) reads ctx * D * 2
// elements of K/V and does 4 * G * D flops per token, far below the
// ~295 flops/byte the card needs to be compute-bound. At 8 sequences x
// 2048 tokens (Llama-3-8B, 8 kv heads, D 128) bf16 pages are 67.1 MB,
// 0.020 ms at 3.35 TB/s; int8 pages 33.6 MB of codes plus 1.05 MB of
// scales, 0.0103 ms.
//
// The bf16 kernel (paged_decode_mma_kernel) is split-K (flash decoding)
// with asynchronous page loads:
// - the grid is (kv head x 16-row tile of its G query rows, split,
//   sequence); a split is a run of whole pages (the wrapper's split plan,
//   ops/paged_attention.py::split_plan, aims at 2-4 blocks an SM, e.g. 4
//   pages of 64 tokens at 8 x 2048), so a few long sequences still fill
//   the 132 SMs; splits past a sequence's context load nothing;
// - each block streams its pages through a two-stage cp.async ring of
//   64-key tiles (int8: codes and scales, dequantized into bf16 tiles by
//   one pass, the plain version's rounding), bounded by context_len; the
//   block and its ring (csrc/decode_ring.cuh) are shared with the strided
//   probe (csrc/page_probes.cu) that splits this kernel's time;
// - the G rows of the kv head are one 16-row mma.sync A fragment (zero
//   padded: 4 live rows on Llama-3-8B); each of the four warps takes 16
//   keys of a tile, computes S = Q.K^T and O += P.V with m16n8k16 bf16
//   products and keeps its own online softmax in registers; the warps'
//   partials are merged through shared memory at the end of the split;
// - with one split the block normalises and stores; with more, it writes
//   its (acc[16, D], m[16], l[16]) in f32 to scratch and takes a ticket
//   (an atomicAdd after a __threadfence) in a per-(sequence, head tile)
//   counter; the last block to finish merges every split by flash
//   recombination, writes [B, H, D] in q's dtype and resets the counter
//   to 0, so a decode layer stays one launch. Empty splits still write
//   an empty partial (m = -1e30, l = 0) and take their ticket.
// A wgmma/TMA version would load each page tile with one TMA copy behind
// an mbarrier from a producer warp (no per-thread address arithmetic or
// cp.async issue), and could give the 64-row warpgroup MMA several kv
// heads' rows at once; at this bound the loads, not the products, are
// what it would save on.
//
// The float32 check mode keeps the first version of this kernel
// (paged_decode_f32_kernel): one block per (kv head, sequence),
// synchronous loads widened to f32 in 32-token tiles, exact f32 products
// on the CUDA cores. The card serves bf16.

#include "common.cuh"
#include "decode_ring.cuh"
#include "mma.cuh"

namespace {

// -- the f32 check mode ---------------------------------------------------

constexpr int kThreads = 128;
constexpr int kTile = 32;  // tokens per tile == warp size (one lane per token)

// The f32 check mode (q, out and pages in float32, or int8 pages): the
// first version of this kernel, exact on the CUDA cores, one block per
// (kv head, sequence). P: the page type (float, or int8_t for quantized
// pages, which then come with their scales).
template <typename P, int D>
__global__ void __launch_bounds__(kThreads) paged_decode_f32_kernel(
    const float* __restrict__ q,           // [B, H, D] pre-scaled
    const P* __restrict__ k_pages,         // [L, NB, bs, KVH, D]
    const P* __restrict__ v_pages,         // [L, NB, bs, KVH, D]
    const float* __restrict__ k_scales,    // [L, NB, bs * KVH] (int8 only)
    const float* __restrict__ v_scales,
    const int* __restrict__ block_tables,  // [B, MAXB]
    const int* __restrict__ context_lens,  // [B]
    float* __restrict__ out,               // [B, H, D]
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

// -- the bf16 kernel: split-K on the tensor cores -------------------------

// The block and its ring of page tiles: csrc/decode_ring.cuh.
constexpr int kMmaWarps = decode_ring::kWarps;
constexpr int kMmaThreads = decode_ring::kThreads;
constexpr int kKeyTile = decode_ring::kKeyTile;
constexpr int kMaxSplits = 64;

// The end of a split: each warp's (m, l) and O of 16 rows, then the
// splits' maxima (turned into weights) and sums, and 1 / L of the final
// merge.
template <int D>
constexpr int merge_bytes() {
  return 4 * (kMmaWarps * 16 * (2 + D) + 2 * kMaxSplits * 16 + 16);
}

template <typename P, int D>
constexpr int mma_smem_bytes() {
  return decode_ring::smem_bytes<P, D>(merge_bytes<D>());
}

// P: the page type (bf16, or int8_t for quantized pages with scales).
template <typename P, int D>
__global__ void __launch_bounds__(kMmaThreads) paged_decode_mma_kernel(
    const __nv_bfloat16* __restrict__ q,   // [B, H, D] pre-scaled
    const P* __restrict__ k_pages,         // [L, NB, bs, KVH, D]
    const P* __restrict__ v_pages,
    const float* __restrict__ k_scales,    // [L, NB, bs * KVH] (int8 only)
    const float* __restrict__ v_scales,
    const int* __restrict__ block_tables,  // [B, MAXB]
    const int* __restrict__ context_lens,  // [B]
    __nv_bfloat16* __restrict__ out,       // [B, H, D]
    float* __restrict__ part_o,   // [B, KVH * MT, splits, 16, D]
    float* __restrict__ part_ml,  // [B, KVH * MT, splits, 2, 16]: m, l
    int* __restrict__ tickets,    // [B * KVH * MT], 0 between launches
    int H, int KVH, int NB, int bs, int MAXB, int layer, int splits) {
  using mma::bf16;
  constexpr int KS = D + 8;  // row stride of the bf16 tiles
  constexpr int NK = D / 16;
  constexpr int ND = D / 8;

  const int G = H / KVH;
  const int MT = (G + 15) / 16;  // 16-row tiles of the group
  const int hx = blockIdx.x;     // kv head * MT + row tile
  const int kvh = hx / MT;
  const int g0 = (hx % MT) * 16;
  const int gn = min(16, G - g0);  // live rows of the tile
  const int split = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  extern __shared__ __align__(16) unsigned char dyn_smem[];
  bf16* q_sh = reinterpret_cast<bf16*>(dyn_smem);           // [16][KS]
  unsigned char* ring = dyn_smem + 16 * KS * sizeof(bf16);

  const size_t q_row0 = (size_t)b * H + (size_t)kvh * G + g0;
  decode_ring::issue_q_tile<D>(q_sh, q + q_row0 * D, gn, tid);

  const int ctx = max(0, min(context_lens[b], MAXB * bs));
  // This split's run of whole pages, cut at the context's end.
  const int split_tokens = (MAXB + splits - 1) / splits * bs;
  const int start = split * split_tokens;
  const int n_keys = max(0, min(ctx - start, split_tokens));
  const mma::PageRows pr{block_tables + (size_t)b * MAXB, (size_t)layer * NB,
                         bs, KVH, kvh};

  uint32_t qf[NK][4];
  float o[ND][4];
#pragma unroll
  for (int dn = 0; dn < ND; ++dn)
#pragma unroll
    for (int j = 0; j < 4; ++j) o[dn][j] = 0.f;
  float m[2] = {KERNEL_NEG_INF, KERNEL_NEG_INF};
  float l[2] = {0.f, 0.f};  // this lane's share of the row sums

  decode_ring::stream_tiles<P, D>(
      ring, k_pages, v_pages, k_scales, v_scales, pr, start, n_keys, tid,
      [&](int it, const bf16* kt, const bf16* vt) {
      if (it == 0) mma::load_a<D, KS>(qf, q_sh, lane);  // q has landed
      const int kw = it * kKeyTile + 16 * warp;  // this warp's first key
      if (kw < n_keys) {
        float s[2][4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[nt][j] = 0.f;
        mma::qk_16<D, KS>(s, qf, kt + 16 * warp * KS, lane);
        if (kw + 16 > n_keys) {  // keys past the context
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (kw + nt * 8 + 2 * (lane & 3) + (j & 1) >= n_keys)
                s[nt][j] = KERNEL_NEG_INF;
        }
        // Online softmax of rows h = 0 (s[.][0..1]) and h = 1 (s[.][2..3]);
        // the four lanes of a quad hold one row.
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float mx = fmaxf(m[h], fmaxf(fmaxf(s[0][2 * h], s[0][2 * h + 1]),
                                       fmaxf(s[1][2 * h], s[1][2 * h + 1])));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float alpha = __expf(m[h] - mx);
          m[h] = mx;
          float sum = 0.f;
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int j = 2 * h; j < 2 * h + 2; ++j) {
              const float p = s[nt][j] > 0.5f * KERNEL_NEG_INF
                                  ? __expf(s[nt][j] - mx)
                                  : 0.f;
              s[nt][j] = p;
              sum += p;
            }
          l[h] = l[h] * alpha + sum;
#pragma unroll
          for (int dn = 0; dn < ND; ++dn) {
            o[dn][2 * h] *= alpha;
            o[dn][2 * h + 1] *= alpha;
          }
        }
        uint32_t pf[4];
        mma::p_fragment(pf, s[0], s[1]);
        mma::pv_16<D, KS>(o, pf, vt + 16 * warp * KS, lane);
      }
      });
  __syncthreads();  // the merge below reuses the ring

  float* mw = reinterpret_cast<float*>(ring);  // [warps][16] row maxima
  float* lw = mw + kMmaWarps * 16;             // [warps][16] row sums
  float* ow = lw + kMmaWarps * 16;             // [warps][16][D]
  float* wgt = ow + kMmaWarps * 16 * D;        // [kMaxSplits][16]
  float* lsp = wgt + kMaxSplits * 16;          // [kMaxSplits][16]
  float* inv_l = lsp + kMaxSplits * 16;        // [16]
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int r = (lane >> 2) + 8 * h;
    if (r >= gn) continue;  // a padding row of the group
    if ((lane & 3) == 0) {
      mw[warp * 16 + r] = m[h];
      lw[warp * 16 + r] = l[h];
    }
#pragma unroll
    for (int dn = 0; dn < ND; ++dn)
      *reinterpret_cast<float2*>(ow + (warp * 16 + r) * D + dn * 8 +
                                 2 * (lane & 3)) =
          make_float2(o[dn][2 * h], o[dn][2 * h + 1]);
  }
  __syncthreads();

  // The split's partial of the tile's live rows: the warps' keys merged.
  const size_t part0 = ((size_t)b * gridDim.x + hx) * splits;
  for (int i = tid; i < gn * (D / 4); i += kMmaThreads) {
    const int r = i / (D / 4);
    const int d = (i % (D / 4)) * 4;
    float M = mw[r];
#pragma unroll
    for (int w = 1; w < kMmaWarps; ++w) M = fmaxf(M, mw[w * 16 + r]);
    float L = 0.f;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < kMmaWarps; ++w) {
      const float e = __expf(mw[w * 16 + r] - M);
      const float4 v = *reinterpret_cast<const float4*>(ow + (w * 16 + r) * D + d);
      L += e * lw[w * 16 + r];
      acc.x += e * v.x;
      acc.y += e * v.y;
      acc.z += e * v.z;
      acc.w += e * v.w;
    }
    if (splits == 1) {
      const float inv = 1.f / fmaxf(L, 1e-30f);
      __nv_bfloat162* dst =
          reinterpret_cast<__nv_bfloat162*>(out + (q_row0 + r) * D + d);
      dst[0] = __floats2bfloat162_rn(acc.x * inv, acc.y * inv);
      dst[1] = __floats2bfloat162_rn(acc.z * inv, acc.w * inv);
    } else {
      const size_t part = part0 + split;
      *reinterpret_cast<float4*>(part_o + (part * 16 + r) * D + d) = acc;
      if (d == 0) {
        part_ml[part * 32 + r] = M;
        part_ml[part * 32 + 16 + r] = L;
      }
    }
  }
  if (splits == 1) return;

  // The last block of this (sequence, head tile) to finish merges.
  __shared__ int last;
  __threadfence();
  __syncthreads();
  const int ticket = b * gridDim.x + hx;
  if (tid == 0) last = atomicAdd(tickets + ticket, 1) == splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // Every split's (m, l) of the live rows, read in one round.
  for (int i = tid; i < splits * 16; i += kMmaThreads) {
    const float* ml = part_ml + (part0 + (i >> 4)) * 32 + (i & 15);
    if ((i & 15) < gn) {
      wgt[i] = __ldcg(ml);
      lsp[i] = __ldcg(ml + 16);
    }
  }
  __syncthreads();
  for (int r = tid; r < gn; r += kMmaThreads) {
    float M = KERNEL_NEG_INF;
    for (int s = 0; s < splits; ++s)
      if (lsp[s * 16 + r] > 0.f) M = fmaxf(M, wgt[s * 16 + r]);
    float L = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float ls = lsp[s * 16 + r];
      const float w = ls > 0.f ? __expf(wgt[s * 16 + r] - M) : 0.f;
      wgt[s * 16 + r] = w;
      L += w * ls;
    }
    inv_l[r] = 1.f / fmaxf(L, 1e-30f);
  }
  __syncthreads();
  for (int i = tid; i < gn * (D / 4); i += kMmaThreads) {
    const int r = i / (D / 4);
    const int d = (i % (D / 4)) * 4;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int s = 0; s < splits; ++s) {
      // An empty split wrote acc = 0 and weighs 0.
      const float w = wgt[s * 16 + r];
      const float4 v = __ldcg(reinterpret_cast<const float4*>(
          part_o + ((part0 + s) * 16 + r) * D + d));
      acc.x += w * v.x;
      acc.y += w * v.y;
      acc.z += w * v.z;
      acc.w += w * v.w;
    }
    const float inv = inv_l[r];
    __nv_bfloat162* dst =
        reinterpret_cast<__nv_bfloat162*>(out + (q_row0 + r) * D + d);
    dst[0] = __floats2bfloat162_rn(acc.x * inv, acc.y * inv);
    dst[1] = __floats2bfloat162_rn(acc.z * inv, acc.w * inv);
  }
  if (tid == 0) tickets[ticket] = 0;  // ready for the next launch
}

// -- launches ---------------------------------------------------------------

size_t f32_smem_bytes(int G, int D) {
  return sizeof(float) *
         (size_t)(2 * G * D + kTile * (D + 1) + kTile * D + G * kTile + 3 * G);
}

struct Args {
  const void *q, *k, *v, *k_scales, *v_scales, *bt, *ctx;
  void *out, *part_o, *part_ml, *tickets;
  int B, H, KVH, NB, bs, MAXB, layer, splits;
  cudaStream_t stream;
};

template <typename P, int D>
int launch_f32(const Args& a) {
  const size_t smem = f32_smem_bytes(a.H / a.KVH, D);
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_f32_kernel<P, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(a.KVH, a.B);
  paged_decode_f32_kernel<P, D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const P*>(a.k),
      static_cast<const P*>(a.v), static_cast<const float*>(a.k_scales),
      static_cast<const float*>(a.v_scales), static_cast<const int*>(a.bt),
      static_cast<const int*>(a.ctx), static_cast<float*>(a.out), a.H, a.KVH,
      a.NB, a.bs, a.MAXB, a.layer);
  return (int)cudaGetLastError();
}

template <typename P, int D>
int launch_mma(const Args& a) {
  if (a.splits < 1 || a.splits > kMaxSplits) return (int)cudaErrorInvalidValue;
  if (a.splits > 1 && (!a.part_o || !a.part_ml || !a.tickets))
    return (int)cudaErrorInvalidValue;
  const int MT = (a.H / a.KVH + 15) / 16;
  const size_t smem = mma_smem_bytes<P, D>();
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_mma_kernel<P, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(a.KVH * MT, a.splits, a.B);
  paged_decode_mma_kernel<P, D><<<grid, kMmaThreads, smem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const P*>(a.k),
      static_cast<const P*>(a.v), static_cast<const float*>(a.k_scales),
      static_cast<const float*>(a.v_scales), static_cast<const int*>(a.bt),
      static_cast<const int*>(a.ctx), static_cast<__nv_bfloat16*>(a.out),
      static_cast<float*>(a.part_o), static_cast<float*>(a.part_ml),
      static_cast<int*>(a.tickets), a.H, a.KVH, a.NB, a.bs, a.MAXB, a.layer,
      a.splits);
  return (int)cudaGetLastError();
}

template <typename P>
int launch_f32_d(int D, const Args& a) { KERNEL_DISPATCH_D(launch_f32, P, D, a) }

template <typename P>
int launch_mma_d(int D, const Args& a) { KERNEL_DISPATCH_D(launch_mma, P, D, a) }

}  // namespace

// dtype (of q and out): 0 = float32 (the check mode; the scratch and
// splits are ignored), 1 = bfloat16. int8_pages: 0 = pages in q's dtype
// (the scales are ignored), 1 = int8 pages with float32 scales. splits:
// the split count of the wrapper's plan (1-64); with more than one,
// part_o [B, KVH * MT, splits, 16, D] and part_ml [B, KVH * MT, splits,
// 2, 16] are f32 scratch and tickets [B * KVH * MT] int32 counters that
// are 0 at the launch and left 0 (MT = ceil(H / KVH / 16)). Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int paged_attention_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scales, const void* v_scales, const void* block_tables,
    const void* context_lens, void* out, void* part_o, void* part_ml,
    void* tickets, int B, int H, int KVH, int D, int NB, int bs, int MAXB,
    int layer, int dtype, int int8_pages, int splits, void* stream) {
  if (B == 0) return 0;
  if (H % KVH != 0) return (int)cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const Args a{q, k_pages, v_pages, k_scales, v_scales, block_tables,
               context_lens, out, part_o, part_ml, tickets, B, H, KVH, NB,
               bs, MAXB, layer, splits, static_cast<cudaStream_t>(stream)};
  if (int8_pages && (a.k_scales == nullptr || a.v_scales == nullptr))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return int8_pages ? launch_f32_d<int8_t>(D, a) : launch_f32_d<float>(D, a);
  return int8_pages ? launch_mma_d<int8_t>(D, a)
                    : launch_mma_d<__nv_bfloat16>(D, a);
}

KERNEL_ERROR_STRING_FN
