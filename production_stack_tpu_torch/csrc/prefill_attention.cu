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
// token-major). With int8 pages the chunk's own keys come back from the
// pages they were just quantized into, as in the plain version; the
// Pallas kernel attended them at full precision from k_new / v_new, so
// under int8 its results differ from both by one quantization step on
// the chunk's own keys and values.
//
// Bound on an H100: operations. A 1024-token chunk over a 1024-token
// prefix does ~4 * H * D flops per visible (query, key) pair, 25.7 GFLOP
// at Llama-3-8B's heads, about 140 flops per byte of K/V read: 0.026 ms
// at 989 TFLOP/s (bf16 dense). int8 pages halve the bytes but leave the
// operations, so the bound does not move.
//
// The bf16 kernel (prefill_mma_kernel) is FlashAttention-2 on mma.sync:
// - one 8-warp block per (query tile, kv head, sequence) holds 128 rows,
//   TQ tokens x the G heads of the group, so every K/V byte brought to
//   shared memory serves all G heads and 128 rows; each warp owns 16 rows
//   and keeps their Q fragments in registers for the whole key walk (172
//   registers a thread at D = 128: one block an SM);
// - keys stream in 64-key tiles through a two-stage cp.async ring (tile
//   k + 1 lands while tile k multiplies), up to the tile's last query
//   position; int8 pages stage codes and scales and one pass dequantizes
//   them into the bf16 tiles (f32 multiply, then bf16 rounding, as the
//   plain version's gather rounds);
// - S = Q.K^T and O += P.V are m16n8k16 bf16 products with f32
//   accumulators (ldmatrix for Q and K, ldmatrix.trans for V), P reused
//   from the S accumulators after rounding to bf16 (the plain version
//   rounds its probabilities to v's dtype too);
// - the online softmax stays in registers (row max and sum over the four
//   lanes of a quad), the causal mask is applied only on tiles that cross
//   a row's position or the context's end, and a warp whose rows see no
//   key of a tile skips its products.
// A wgmma/TMA version would issue the two products as 64-row warpgroup
// MMAs from shared memory (no ldmatrix, no register-file Q), load each
// page tile with one TMA copy behind an mbarrier from a producer warp,
// and overlap the softmax of one tile with the products of the next.
//
// The float32 check mode keeps the first version of this kernel
// (prefill_f32_kernel): exact f32 products on the CUDA cores, 32-key
// tiles, synchronous loads. The card serves bf16.

#include <limits.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

// -- the f32 check mode ---------------------------------------------------

constexpr int kThreads = 128;
constexpr int kRows = 64;  // query rows per block (TQ tokens x G heads)
constexpr int kTK = 32;    // keys per tile == warp size

// The f32 check mode (q, out and pages in float32, or int8 pages): the
// first version of this kernel, exact on the CUDA cores. P: the page type
// (float, or int8_t for quantized pages, which then come with scales).
template <typename P, int D>
__global__ void __launch_bounds__(kThreads) prefill_f32_kernel(
    const float* __restrict__ q,           // [B, T, H, D] pre-scaled
    const P* __restrict__ k_pages,         // [L, NB, bs, KVH, D]
    const P* __restrict__ v_pages,
    const float* __restrict__ k_scales,    // [L, NB, bs * KVH] (int8 only)
    const float* __restrict__ v_scales,
    const int* __restrict__ block_tables,  // [B, MAXB]
    const int* __restrict__ positions,     // [B, T] ascending
    const int* __restrict__ total_lens,    // [B]
    float* __restrict__ out,               // [B, T, H, D]
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

// -- the bf16 kernel: FlashAttention-2 on the tensor cores -------------------

constexpr int kMmaWarps = 8;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMmaRows = 16 * kMmaWarps;  // query rows a block (TQ x G)
constexpr int kKeyTile = 64;              // keys a ring stage
constexpr int kStages = 2;
constexpr int kMinBlocks = 1;             // resident blocks an SM

template <typename P, int D>
constexpr int mma_smem_bytes() {
  return kMmaRows * (D + 8) * 2 +                       // Q tile
         kStages * mma::stage_bytes<P, D, kKeyTile>() +  // the ring
         (sizeof(P) == 1 ? 2 * kKeyTile * (D + 8) * 2 : 0);  // int8: bf16 K, V
}

// P: the page type (bf16, or int8_t for quantized pages with scales).
template <typename P, int D>
__global__ void __launch_bounds__(kMmaThreads, kMinBlocks) prefill_mma_kernel(
    const __nv_bfloat16* __restrict__ q,   // [B, T, H, D] pre-scaled
    const P* __restrict__ k_pages,         // [L, NB, bs, KVH, D]
    const P* __restrict__ v_pages,
    const float* __restrict__ k_scales,    // [L, NB, bs * KVH] (int8 only)
    const float* __restrict__ v_scales,
    const int* __restrict__ block_tables,  // [B, MAXB]
    const int* __restrict__ positions,     // [B, T] ascending
    const int* __restrict__ total_lens,    // [B]
    __nv_bfloat16* __restrict__ out,       // [B, T, H, D]
    int T_len, int H, int KVH, int NB, int bs, int MAXB, int layer, int TQ) {
  using mma::bf16;
  constexpr bool kQuantized = std::is_same<P, int8_t>::value;
  constexpr int KS = D + 8;         // row stride of the bf16 tiles
  constexpr int NK = D / 16;        // k-steps of Q.K^T
  constexpr int NS = kKeyTile / 8;  // score n-tiles of a row
  constexpr int ND = D / 8;         // output n-tiles of a row
  constexpr int kStage = mma::stage_bytes<P, D, kKeyTile>();

  // The longest query tiles (most keys) first, so short ones fill the tail.
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / KVH;
  const int rows = G * TQ;  // live rows of this block (<= kMmaRows)
  const int t0 = qt * TQ;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  extern __shared__ __align__(16) unsigned char dyn_smem[];
  bf16* q_sh = reinterpret_cast<bf16*>(dyn_smem);  // [kMmaRows][KS]
  unsigned char* ring = dyn_smem + kMmaRows * KS * sizeof(bf16);  // kStages
  bf16* kd = reinterpret_cast<bf16*>(ring + kStages * kStage);  // int8 only
  bf16* vd = kd + kKeyTile * KS;

  // Row r is query token t0 + r / G, head kvh * G + r % G; rows past the
  // chunk or the group's padding are zero.
  for (int i = tid; i < kMmaRows * (D / 8); i += kMmaThreads) {
    const int r = i / (D / 8);
    const int c = i % (D / 8);
    const int t = t0 + r / G;
    const bool live = r < rows && t < T_len;
    const size_t src =
        live ? (((size_t)b * T_len + t) * H + (size_t)kvh * G + r % G) * D +
                   c * 8
             : 0;
    mma::cp_async16(q_sh + r * KS + c * 8, q + src, live);
  }
  mma::cp_async_commit();

  const int* pos = positions + (size_t)b * T_len;
  const int total = max(0, min(total_lens[b], MAXB * bs));
  // Keys some query of this tile can see: up to its last token's position.
  const int n_keys = max(0, min(total, pos[min(t0 + TQ, T_len) - 1] + 1));
  const int n_tiles = (n_keys + kKeyTile - 1) / kKeyTile;
  const mma::PageRows pr{block_tables + (size_t)b * MAXB, (size_t)layer * NB,
                         bs, KVH, kvh};

  // This thread's two score rows, 16 * warp + lane / 4 (+ 8), by position
  // (-1: a padding row). The warp's live rows see keys up to hi, and all of
  // them see every key up to lo.
  int row_pos[2];
  int hi = -1, lo = INT_MAX;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 16 * warp + (lane >> 2) + 8 * h;
    const int t = t0 + r / G;
    row_pos[h] = (r < rows && t < T_len) ? pos[t] : -1;
    if (row_pos[h] >= 0) {
      hi = max(hi, row_pos[h]);
      lo = min(lo, row_pos[h]);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
  }

  uint32_t qf[NK][4];
  float o[ND][4];
#pragma unroll
  for (int dn = 0; dn < ND; ++dn)
#pragma unroll
    for (int j = 0; j < 4; ++j) o[dn][j] = 0.f;
  float m[2] = {KERNEL_NEG_INF, KERNEL_NEG_INF};
  float l[2] = {0.f, 0.f};  // this lane's share of the row sums

  auto issue = [&](int tile) {
    const int k0 = tile * kKeyTile;
    mma::issue_kv_tile<D, kKeyTile, kMmaThreads>(
        ring + (tile % kStages) * kStage, k_pages, v_pages, k_scales,
        v_scales, pr, k0, min(kKeyTile, n_keys - k0), tid);
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) issue(s);
    mma::cp_async_commit();
  }

  for (int it = 0; it < n_tiles; ++it) {
    if (it + kStages - 1 < n_tiles) issue(it + kStages - 1);
    mma::cp_async_commit();
    mma::cp_async_wait<kStages - 1>();  // Q and tile it have landed
    __syncthreads();
    if (it == 0) mma::load_a<D, KS>(qf, q_sh + 16 * warp * KS, lane);
    const unsigned char* st = ring + (it % kStages) * kStage;
    const bf16* kt;
    const bf16* vt;
    if constexpr (kQuantized) {
      mma::dequant_kv_tile<D, kKeyTile, kMmaThreads>(st, kd, vd, tid);
      __syncthreads();
      kt = kd;
      vt = vd;
    } else {
      kt = reinterpret_cast<const bf16*>(st);
      vt = kt + kKeyTile * KS;
    }
    const int k0 = it * kKeyTile;
    if (k0 <= hi) {  // some row of this warp sees a key of the tile
      float s[NS][4];
#pragma unroll
      for (int nt = 0; nt < NS; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[nt][j] = 0.f;
#pragma unroll
      for (int np = 0; np < NS / 2; ++np)
        mma::qk_16<D, KS>(&s[2 * np], qf, kt + np * 16 * KS, lane);
      if (k0 + kKeyTile - 1 > lo || k0 + kKeyTile > total) {
        // The tile crosses a row's position or the context's end.
#pragma unroll
        for (int nt = 0; nt < NS; ++nt)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int key = k0 + nt * 8 + 2 * (lane & 3) + (j & 1);
            const int rp = row_pos[j >> 1];
            const bool live = key <= rp && key < total;
            if (!live) s[nt][j] = KERNEL_NEG_INF;
          }
      }
      // Online softmax of rows h = 0 (s[.][0..1]) and h = 1 (s[.][2..3]);
      // the four lanes of a quad hold one row.
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = m[h];
#pragma unroll
        for (int nt = 0; nt < NS; ++nt)
          mx = fmaxf(mx, fmaxf(s[nt][2 * h], s[nt][2 * h + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float alpha = __expf(m[h] - mx);
        m[h] = mx;
        float sum = 0.f;
#pragma unroll
        for (int nt = 0; nt < NS; ++nt)
#pragma unroll
          for (int j = 2 * h; j < 2 * h + 2; ++j) {
            const float p =
                s[nt][j] > 0.5f * KERNEL_NEG_INF ? __expf(s[nt][j] - mx) : 0.f;
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
#pragma unroll
      for (int kp = 0; kp < NS / 2; ++kp) {
        uint32_t pf[4];
        mma::p_fragment(pf, s[2 * kp], s[2 * kp + 1]);
        mma::pv_16<D, KS>(o, pf, vt + kp * 16 * KS, lane);
      }
    }
    __syncthreads();  // the stage is free for the copy issued next
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int r = 16 * warp + (lane >> 2) + 8 * h;
    const int t = t0 + r / G;
    if (r < rows && t < T_len) {
      const float inv = 1.f / fmaxf(l[h], 1e-30f);
      bf16* dst = out +
                  (((size_t)b * T_len + t) * H + (size_t)kvh * G + r % G) * D +
                  2 * (lane & 3);
#pragma unroll
      for (int dn = 0; dn < ND; ++dn)
        *reinterpret_cast<__nv_bfloat162*>(dst + dn * 8) =
            __floats2bfloat162_rn(o[dn][2 * h] * inv, o[dn][2 * h + 1] * inv);
    }
  }
}

// -- launches ---------------------------------------------------------------

size_t f32_smem_bytes(int D) {
  return sizeof(float) * (size_t)(kRows * (D + 4) + kTK * (D + 4) + kTK * D +
                                  kRows * (kTK + 1) + 3 * kRows);
}

struct Args {
  const void *q, *k, *v, *k_scales, *v_scales, *bt, *positions, *total_lens;
  void* out;
  int B, T_len, H, KVH, NB, bs, MAXB, layer;
  cudaStream_t stream;
};

template <typename T, typename P, typename Kernel>
int launch(Kernel kernel, const Args& a, int threads, int rows, size_t smem) {
  const int TQ = rows / (a.H / a.KVH);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.T_len + TQ - 1) / TQ, a.KVH, a.B);
  kernel<<<grid, threads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const P*>(a.k),
      static_cast<const P*>(a.v), static_cast<const float*>(a.k_scales),
      static_cast<const float*>(a.v_scales), static_cast<const int*>(a.bt),
      static_cast<const int*>(a.positions),
      static_cast<const int*>(a.total_lens), static_cast<T*>(a.out), a.T_len,
      a.H, a.KVH, a.NB, a.bs, a.MAXB, a.layer, TQ);
  return (int)cudaGetLastError();
}

template <typename P, int D>
int launch_f32(const Args& a) {
  return launch<float, P>(prefill_f32_kernel<P, D>, a, kThreads, kRows,
                          f32_smem_bytes(D));
}

template <typename P, int D>
int launch_mma(const Args& a) {
  return launch<__nv_bfloat16, P>(prefill_mma_kernel<P, D>, a, kMmaThreads,
                                  kMmaRows, mma_smem_bytes<P, D>());
}

template <typename P>
int launch_f32_d(int D, const Args& a) { KERNEL_DISPATCH_D(launch_f32, P, D, a) }

template <typename P>
int launch_mma_d(int D, const Args& a) { KERNEL_DISPATCH_D(launch_mma, P, D, a) }

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
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const Args a{q, k_pages, v_pages, k_scales, v_scales, block_tables,
               positions, total_lens, out, B, T_len, H, KVH, NB, bs, MAXB,
               layer, static_cast<cudaStream_t>(stream)};
  if (int8_pages && (a.k_scales == nullptr || a.v_scales == nullptr))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return int8_pages ? launch_f32_d<int8_t>(D, a) : launch_f32_d<float>(D, a);
  return int8_pages ? launch_mma_d<int8_t>(D, a)
                    : launch_mma_d<__nv_bfloat16>(D, a);
}

KERNEL_ERROR_STRING_FN
