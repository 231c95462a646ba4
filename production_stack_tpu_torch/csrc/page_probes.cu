// Page probes of the paged decode kernel for Hopper (sm_90a): the gather
// of KV pages that decode attention does, with the attention math taken
// away in steps, so that the time of each step can be read apart.
//
// Replaces two TPU kernels of the JAX package's diagnostics:
// - benchmarks/kernel_dma_only.py::dma_only (body _dma_kernel): every live
//   chunk of P pages of K and V is copied into on-chip memory, and only an
//   [8, D] f32 checksum is kept (dma_only_kernel);
// - benchmarks/kernel_probe_strided.py::build (body _kernel): the same
//   chunks, then for each kv head either the chunk's first G token rows
//   are added up (reads, strided per-head reads) or both products
//   (q_h . K_h^T) . V_h are taken over the whole chunk, unmasked, with no
//   scale and no softmax (dots) (strided_probe_kernel).
//
// Layout and semantics are the TPU kernels': pages [L, NB, bs, KVH, D] in
// any of f32, bf16 or int8 (codes, read as values; no scales), tables
// [B, MAXB] i32, context lengths [B] i32, chunks of P pages, the TPU grid
// (B, MAXB / P). A chunk with c * P * bs >= ctx is neither read nor
// consumed; a live chunk is read in full, tokens past ctx included, as the
// TPU kernels do. The TPU grid ran in order and left in its one output
// block what the last sequence's chunks added; here blocks run in
// parallel, so every contribution is an atomicAdd into an output the
// wrapper zeroed (dma_only: only blocks of sequence B - 1 add).
//
// Bound on an H100: bytes (the pages read over 3.35 TB/s; dots adds
// 4 * KVH * G * D flops a token, below the card's ~295 flops a byte).
//
// The two kernels answer two questions, so they are built differently:
// - dma_only_kernel: how fast the card gathers scattered pages, by how
//   the work is split (P = MAXB: one block walks a sequence; small P:
//   blocks split it). One block per (chunk, sequence) streams its P pages
//   through a two-stage ring in shared memory, one stage = T whole token
//   rows (every kv head) of K and of V, at most 16 KB a side; a page row
//   is contiguous, so a stage is two runs of 16-byte cp.async copies,
//   started one stage ahead of the one being consumed.
// - strided_probe_kernel: what the port's decode kernel
//   (csrc/paged_attention.cu) spends on its reads and on its products.
//   It keeps that kernel's layout: one 128-thread block per (kv head,
//   chunk, sequence), so that at P = MAXB the grid is the decode kernel's
//   (KVH, B); the chunk is walked in the same 32-token tiles, each row of
//   the head loaded with the same synchronous 16-byte loads into the
//   same f32 shared tiles, and dots does the same products with the same
//   thread mappings. Only the softmax (and the score mask) is left out, so
//   at P = MAXB the decode kernel minus dots is its softmax, dots minus
//   reads its products, and reads its gather.
//
// Either way the bytes land in shared memory, where the compiler cannot
// drop them, whatever the block reads of them. A dma_only that copied only
// what it consumes would report more than the card's memory rate, which
// chip_smoke.py rejects. reads runs below that rate whatever it loads; its
// load loop is the one dots runs, where every loaded element feeds the
// output, so the dots value check covers it.

#include "common.cuh"

namespace {

// -- dma_only: the page gather through a cp.async ring -------------------------

constexpr int kRingThreads = 256;
constexpr int kChecksumRows = 8;  // token rows of the checksum

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most one committed group of this thread is in flight.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// E: the page type.
template <typename E>
__global__ void __launch_bounds__(kRingThreads) dma_only_kernel(
    const E* __restrict__ k_pages,         // [L, NB, bs, KVH, D]
    const E* __restrict__ v_pages,         // [L, NB, bs, KVH, D]
    const int* __restrict__ block_tables,  // [B, MAXB]
    const int* __restrict__ context_lens,  // [B]
    float* __restrict__ out,               // [8, D], added to
    int B, int MAXB, int NB, int bs, int KVH, int D, int P, int T,
    int layer) {
  const int c = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int ctx = context_lens[b];
  if ((long long)c * P * bs >= ctx) return;  // not a live chunk

  const int row = KVH * D;                      // elements of a token row
  const int row16 = row * (int)sizeof(E) / 16;  // its 16-byte copies
  const int slice = T * row;                    // elements of a stage side
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* ring = reinterpret_cast<E*>(smem_raw);  // [2 stages][K, V][slice]

  const int* bt = block_tables + (size_t)b * MAXB + (size_t)c * P;
  const int per_page = bs / T;
  const int n_slices = P * per_page;

  // Copy stage s (page p of the chunk, its tokens t0 .. t0 + T) into ring
  // slot s & 1, and commit it as one group.
  auto start_copy = [&](int s) {
    const int p = s / per_page;
    const int t0 = (s % per_page) * T;
    const size_t base =
        (((size_t)layer * NB + (size_t)bt[p]) * bs + t0) * (size_t)row;
    char* dk = reinterpret_cast<char*>(ring + (size_t)(s & 1) * 2 * slice);
    char* dv = dk + (size_t)slice * sizeof(E);
    const char* sk = reinterpret_cast<const char*>(k_pages + base);
    const char* sv = reinterpret_cast<const char*>(v_pages + base);
    // Bytes of this slice: T whole token rows (every kv head) of K and of V.
    const int n16 = T * row16;
    for (int i = tid; i < n16; i += kRingThreads) {
      cp_async16(dk + (size_t)i * 16, sk + (size_t)i * 16);
      cp_async16(dv + (size_t)i * 16, sv + (size_t)i * 16);
    }
    cp_async_commit();
  };

  start_copy(0);
  for (int s = 0; s < n_slices; ++s) {
    if (s + 1 < n_slices) {
      start_copy(s + 1);  // its slot was consumed before the last barrier
    } else {
      cp_async_commit();  // an empty group keeps "all but one" exact
    }
    cp_async_wait_one();
    __syncthreads();  // stage s of every thread has landed
    const E* ks = ring + (size_t)(s & 1) * 2 * slice;
    const E* vs = ks + slice;
    const int p = s / per_page;
    const int t0 = (s % per_page) * T;
    // The checksum: token rows 0-7, kv head 0, of the chunk's first page,
    // in the last sequence's blocks.
    if (b == B - 1 && p == 0 && t0 < kChecksumRows) {
      const int rows = min(T, kChecksumRows - t0);
      for (int i = tid; i < rows * D; i += kRingThreads) {
        const int t = i / D, d = i % D;
        atomicAdd(out + (size_t)(t0 + t) * D + d,
                  to_f32(ks[t * row + d]) + to_f32(vs[t * row + d]));
      }
    }
    __syncthreads();  // before stage s's slot is copied over
  }
}

constexpr size_t kStageBytes = 16384;  // most bytes of K (or V) a stage

enum Mode { kDma = 0, kReads = 1, kDots = 2 };

struct Args {
  const void *q, *k, *v, *bt, *ctx;
  void* out;
  int B, MAXB, NB, bs, KVH, D, G, P, layer;
  cudaStream_t stream;
};

// Token rows a ring stage holds: the largest power of two that divides bs
// and keeps a stage side within kStageBytes.
int stage_tokens(int bs, size_t row_bytes) {
  int T = 1;
  while (bs % (2 * T) == 0 && 2 * T * row_bytes <= kStageBytes) T *= 2;
  return T;
}

template <typename E>
int launch_dma(const Args& a) {
  const int T = stage_tokens(a.bs, (size_t)a.KVH * a.D * sizeof(E));
  const size_t smem = 4 * (size_t)T * a.KVH * a.D * sizeof(E);
  cudaError_t err = cudaFuncSetAttribute(
      dma_only_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(a.MAXB / a.P, a.B);
  dma_only_kernel<E><<<grid, kRingThreads, smem, a.stream>>>(
      static_cast<const E*>(a.k), static_cast<const E*>(a.v),
      static_cast<const int*>(a.bt), static_cast<const int*>(a.ctx),
      static_cast<float*>(a.out), a.B, a.MAXB, a.NB, a.bs, a.KVH, a.D, a.P,
      T, a.layer);
  return (int)cudaGetLastError();
}

// -- reads and dots: the decode kernel's tiles, without its softmax -----------

constexpr int kTileThreads = 128;  // the decode kernel's block
constexpr int kTile = 32;          // the decode kernel's tile of tokens

// E: the page type; DOTS: both products (else the first G rows added);
// D: the head dim.
template <typename E, bool DOTS, int D>
__global__ void __launch_bounds__(kTileThreads) strided_probe_kernel(
    const float* __restrict__ q,           // [B, KVH * G, D] (dots only)
    const E* __restrict__ k_pages,         // [L, NB, bs, KVH, D]
    const E* __restrict__ v_pages,         // [L, NB, bs, KVH, D]
    const int* __restrict__ block_tables,  // [B, MAXB]
    const int* __restrict__ context_lens,  // [B]
    float* __restrict__ out,               // [B, KVH * G, D], added to
    int MAXB, int NB, int bs, int KVH, int G, int P, int layer) {
  constexpr int D8 = D / 8;
  const int kvh = blockIdx.x;
  const int c = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int span = P * bs;  // tokens of a chunk
  if ((long long)c * span >= context_lens[b]) return;  // not a live chunk

  extern __shared__ float smem[];
  float* q_sh = smem;                    // [G][D] (dots only)
  float* acc_sh = q_sh + G * D;          // [G][D]
  float* k_sh = acc_sh + G * D;          // [kTile][D + 1]
  float* v_sh = k_sh + kTile * (D + 1);  // [kTile][D]
  float* s_sh = v_sh + kTile * D;        // [G][kTile] (dots only)

  const size_t o_base = ((size_t)b * KVH * G + (size_t)kvh * G) * D;
  if (DOTS) {
    for (int i = tid; i < G * D8; i += kTileThreads) {
      float tmp[8];
      load8(q + o_base + (size_t)i * 8, tmp);
#pragma unroll
      for (int j = 0; j < 8; ++j) q_sh[i * 8 + j] = tmp[j];
    }
  }
  for (int i = tid; i < G * D; i += kTileThreads) acc_sh[i] = 0.f;
  const int* bt = block_tables + (size_t)b * MAXB + (size_t)c * P;
  const size_t layer_pages = (size_t)layer * NB;
  __syncthreads();

  for (int start = 0; start < span; start += kTile) {
    const int n = min(kTile, span - start);
    for (int i = tid; i < kTile * D8; i += kTileThreads) {
      const int t = i / D8;
      const int d8 = i % D8;
      float kt[8], vt[8];
      if (t < n) {
        const int tok = start + t;  // token of the chunk
        const size_t page = (size_t)bt[tok / bs];
        const size_t row = ((layer_pages + page) * bs + tok % bs) * KVH + kvh;
        load8(k_pages + row * D + d8 * 8, kt);
        load8(v_pages + row * D + d8 * 8, vt);
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

    if (DOTS) {
      for (int i = tid; i < G * kTile; i += kTileThreads) {
        const int g = i / kTile;
        const int t = i % kTile;
        const float* qr = q_sh + g * D;
        const float* kr = k_sh + t * (D + 1);
        float a = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) a = fmaf(qr[d], kr[d], a);
        s_sh[g * kTile + t] = a;
      }
      __syncthreads();
      for (int i = tid; i < G * D; i += kTileThreads) {
        const int g = i / D;
        const int d = i % D;
        const float* sr = s_sh + g * kTile;
        float a = acc_sh[i];
        for (int t = 0; t < n; ++t) a = fmaf(sr[t], v_sh[t * D + d], a);
        acc_sh[i] = a;
      }
    } else if (start < G) {
      // Chunk token j < G adds its K + V to output row j of this head.
      const int rows = min(n, G - start);
      for (int i = tid; i < rows * D; i += kTileThreads) {
        const int t = i / D;
        const int d = i % D;
        acc_sh[(start + t) * D + d] += k_sh[t * (D + 1) + d] + v_sh[t * D + d];
      }
    }
    __syncthreads();
  }

  for (int i = tid; i < G * D; i += kTileThreads)
    atomicAdd(out + o_base + i, acc_sh[i]);
}

size_t strided_smem_bytes(int G, int D) {
  return sizeof(float) *
         (size_t)(2 * G * D + kTile * (D + 1) + kTile * D + G * kTile);
}

template <typename E, bool DOTS, int D>
int launch_strided(const Args& a) {
  const size_t smem = strided_smem_bytes(a.G, D);
  cudaError_t err = cudaFuncSetAttribute(
      strided_probe_kernel<E, DOTS, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(a.KVH, a.MAXB / a.P, a.B);
  strided_probe_kernel<E, DOTS, D><<<grid, kTileThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const E*>(a.k),
      static_cast<const E*>(a.v), static_cast<const int*>(a.bt),
      static_cast<const int*>(a.ctx), static_cast<float*>(a.out), a.MAXB,
      a.NB, a.bs, a.KVH, a.G, a.P, a.layer);
  return (int)cudaGetLastError();
}

template <typename E, bool DOTS>
int launch_strided_d(const Args& a) {
  switch (a.D) {
    case 32: return launch_strided<E, DOTS, 32>(a);
    case 64: return launch_strided<E, DOTS, 64>(a);
    case 128: return launch_strided<E, DOTS, 128>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename E>
int launch_mode(int mode, const Args& a) {
  if (mode == kDma) return launch_dma<E>(a);
  if (mode == kDots) return launch_strided_d<E, true>(a);
  return launch_strided_d<E, false>(a);
}

int launch(int mode, int dtype, const Args& a) {
  if (a.B == 0 || a.MAXB == 0) return 0;
  if (a.P <= 0 || a.MAXB % a.P != 0 || a.bs <= 0 || a.G <= 0 ||
      (mode == kDma && a.bs < kChecksumRows))
    return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return launch_mode<float>(mode, a);
    case 1: return launch_mode<__nv_bfloat16>(mode, a);
    case 2: return launch_mode<int8_t>(mode, a);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype (of the pages): 0 = float32, 1 = bfloat16, 2 = int8. out: [8, D]
// float32, zeroed by the caller. Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int dma_only_launch(const void* k_pages, const void* v_pages,
                               const void* block_tables,
                               const void* context_lens, void* out, int dtype,
                               int B, int MAXB, int NB, int bs, int KVH,
                               int D, int P, int layer, void* stream) {
  const Args a{nullptr, k_pages, v_pages, block_tables, context_lens, out,
               B, MAXB, NB, bs, KVH, D, 1, P, layer,
               static_cast<cudaStream_t>(stream)};
  return launch(kDma, dtype, a);
}

// dots: 0 = per-head reads, 1 = both products. q: [B, KVH * G, D]
// float32 (read by the products only); out: [B, KVH * G, D] float32,
// zeroed by the caller. Other arguments as dma_only_launch.
extern "C" int probe_strided_launch(const void* q, const void* k_pages,
                                    const void* v_pages,
                                    const void* block_tables,
                                    const void* context_lens, void* out,
                                    int dots, int dtype, int B, int MAXB,
                                    int NB, int bs, int KVH, int D, int G,
                                    int P, int layer, void* stream) {
  const Args a{q, k_pages, v_pages, block_tables, context_lens, out,
               B, MAXB, NB, bs, KVH, D, G, P, layer,
               static_cast<cudaStream_t>(stream)};
  return launch(dots ? kDots : kReads, dtype, a);
}

KERNEL_ERROR_STRING_FN
