// Tensor-core building blocks of the bf16 attention kernels (sm_90a):
// 16-byte cp.async copies of KV page rows into shared memory, bf16 tiles
// laid out for conflict-free ldmatrix, the m16n8k16 bf16 mma.sync with
// f32 accumulation, and the int8-page staging that dequantizes a tile of
// codes into the bf16 tile the products read.
//
// A (token, kv head) row of the layer-stacked pool [L, NB, bs, KVH, D] is
// D contiguous elements at row index ((layer * NB + page) * bs + tok % bs)
// * KVH + kvh, page = block_tables[tok / bs]; int8 pages keep one f32
// scale per row at the same index of the flat [L, NB, bs * KVH] scales.
//
// A bf16 tile holds TK key rows of D elements at a row stride of D + 8:
// the 8 rows one ldmatrix phase reads then start 16 bytes apart modulo
// the 128-byte bank line (D = 32, 64, 128), so no two share a bank.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mma {

using bf16 = __nv_bfloat16;

// -- asynchronous copies ---------------------------------------------------

// 16 bytes global -> shared; with live == false nothing is read and the
// destination is zero-filled (src must still be a valid address).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool live) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = live ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(n));
}

// 4 bytes global -> shared (one f32 scale), zero-filled when !live.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool live) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = live ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N committed groups of this thread are in flight; the
// memory clobber keeps shared-memory reads of the landed tile after it
// (the issue and commit carry none, so the page-row loads that address a
// copy can be hoisted above the copies before it).
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// -- fragments ---------------------------------------------------------------

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* smem) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const void* smem) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// d += a . b: a 16x16 bf16 (row), b 16x8 bf16 (col), d 16x8 f32. Thread
// `lane` holds d[0..1] at row lane/4, columns 2*(lane%4) + {0, 1}, and
// d[2..3] at row lane/4 + 8.
__device__ __forceinline__ void mma_16816(float d[4], const uint32_t a[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 and packed (lo in the low half), the
// layout of an A fragment register.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// The A fragments of a 16-row tile at `rows` (row stride KS elements):
// one per 16 columns of D.
template <int D, int KS>
__device__ __forceinline__ void load_a(uint32_t a[D / 16][4],
                                       const bf16* rows, int lane) {
  const bf16* p = rows + (lane & 15) * KS + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) ldmatrix_x4(a[kk], p + kk * 16);
}

// s[0..1] += A . K^T for the 16 keys at `keys` (two n-tiles of 8).
template <int D, int KS>
__device__ __forceinline__ void qk_16(float s[2][4],
                                      const uint32_t a[D / 16][4],
                                      const bf16* keys, int lane) {
  const bf16* p =
      keys + ((lane & 7) + ((lane >> 4) << 3)) * KS + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t b[4];
    ldmatrix_x4(b, p + kk * 16);
    mma_16816(s[0], a[kk], b[0], b[1]);
    mma_16816(s[1], a[kk], b[2], b[3]);
  }
}

// o += P . V for 16 keys: P is the A fragment made of the two score
// n-tiles of those keys, V the 16 rows at `vals`.
template <int D, int KS>
__device__ __forceinline__ void pv_16(float o[D / 8][4], const uint32_t p[4],
                                      const bf16* vals, int lane) {
  const bf16* v =
      vals + ((lane & 7) + ((lane >> 3) & 1) * 8) * KS + (lane >> 4) * 8;
#pragma unroll
  for (int dp = 0; dp < D / 16; ++dp) {
    uint32_t b[4];
    ldmatrix_x4_trans(b, v + dp * 16);
    mma_16816(o[2 * dp], p, b[0], b[1]);
    mma_16816(o[2 * dp + 1], p, b[2], b[3]);
  }
}

// The FA2 reuse of the score accumulators of 16 keys (n-tiles s0, s1) as
// the A operand of P . V, each probability rounded to bf16.
__device__ __forceinline__ void p_fragment(uint32_t p[4], const float s0[4],
                                           const float s1[4]) {
  p[0] = pack_bf16(s0[0], s0[1]);
  p[1] = pack_bf16(s0[2], s0[3]);
  p[2] = pack_bf16(s1[0], s1[1]);
  p[3] = pack_bf16(s1[2], s1[3]);
}

// -- page tiles ----------------------------------------------------------------

// Where each key's (token, kv head) row lies in the pool. A block size
// that is a power of two (the engine's) takes a shift and a mask.
struct PageRows {
  const int* bt;       // this sequence's block table
  size_t layer_pages;  // layer * NB
  int bs, KVH, kvh;
  int shift;  // log2(bs), or -1 when bs is not a power of two

  __device__ PageRows(const int* bt_, size_t layer_pages_, int bs_, int KVH_,
                      int kvh_)
      : bt(bt_), layer_pages(layer_pages_), bs(bs_), KVH(KVH_), kvh(kvh_),
        shift(-1) {
    if ((bs & (bs - 1)) == 0)
      for (shift = 0; (1 << shift) < bs; ++shift) {
      }
  }

  __device__ __forceinline__ size_t row(int key) const {
    const int page = shift >= 0 ? key >> shift : key / bs;
    const int slot = shift >= 0 ? key & (bs - 1) : key % bs;
    return ((layer_pages + (size_t)bt[page]) * bs + slot) * KVH + kvh;
  }
};

// Bytes of one ring stage: bf16 pages stage the K and V tiles themselves
// ([TK][D + 8] each); int8 pages stage the codes ([TK][D] each) and the
// rows' scales ([TK] each), dequantized by dequant_kv_tile into bf16
// tiles kept beside the ring.
template <typename P, int D, int TK>
__host__ __device__ constexpr int stage_bytes() {
  return sizeof(P) == 1 ? 2 * TK * D + 2 * TK * 4
                        : 2 * TK * (D + 8) * (int)sizeof(bf16);
}

// Start the copies of keys k0 .. k0 + n (n <= TK) of one kv head into a
// stage; rows n .. TK are zero-filled and nothing past key k0 + n - 1 is
// read, so the caller bounds every read by the context length.
// The source offsets of this thread's copies of a tile, all computed
// (block-table loads included) before the first copy is issued. R: copies
// a thread; copy j is item tid + j * NT of TK rows x C copies a row.
template <int TK, int C, int NT, int R>
__device__ __forceinline__ void tile_sources(size_t src[R], bool live[R],
                                             const PageRows& pr, int k0,
                                             int n, int tid, int unit) {
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int i = tid + j * NT;
    const int r = i / C;
    live[j] = i < TK * C && r < n;
    src[j] = live[j] ? pr.row(k0 + r) * unit + (i % C) * 16 : 0;
  }
}

// Start the copies of keys k0 .. k0 + n (n <= TK) of one kv head into a
// stage; rows n .. TK are zero-filled and nothing past key k0 + n - 1 is
// read, so the caller bounds every read by the context length.
template <int D, int TK, int NT>
__device__ __forceinline__ void issue_kv_tile(
    unsigned char* stage, const bf16* k_pages, const bf16* v_pages,
    const float*, const float*, const PageRows& pr, int k0, int n, int tid) {
  constexpr int KS = D + 8;
  constexpr int C = D / 8;  // 16-byte copies a row
  constexpr int R = (TK * C + NT - 1) / NT;
  size_t src[R];  // byte offsets
  bool live[R];
  tile_sources<TK, C, NT, R>(src, live, pr, k0, n, tid, D * 2);
  unsigned char* kt = stage;
  unsigned char* vt = stage + TK * KS * 2;
  const unsigned char* kp = reinterpret_cast<const unsigned char*>(k_pages);
  const unsigned char* vp = reinterpret_cast<const unsigned char*>(v_pages);
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int i = tid + j * NT;
    if (i >= TK * C) break;
    const int dst = (i / C) * KS * 2 + (i % C) * 16;
    cp_async16(kt + dst, kp + src[j], live[j]);
    cp_async16(vt + dst, vp + src[j], live[j]);
  }
}

template <int D, int TK, int NT>
__device__ __forceinline__ void issue_kv_tile(
    unsigned char* stage, const int8_t* k_pages, const int8_t* v_pages,
    const float* k_scales, const float* v_scales, const PageRows& pr, int k0,
    int n, int tid) {
  constexpr int C = D / 16;  // 16-byte copies a row of codes
  constexpr int R = (TK * C + NT - 1) / NT;
  static_assert(TK <= NT, "one thread a row's scales");
  size_t src[R];  // byte offsets
  bool live[R];
  tile_sources<TK, C, NT, R>(src, live, pr, k0, n, tid, D);
  const bool scale_live = tid < TK && tid < n;
  const size_t row = scale_live ? pr.row(k0 + tid) : 0;
  unsigned char* kc = stage;
  unsigned char* vc = kc + TK * D;
  float* ks = reinterpret_cast<float*>(vc + TK * D);
  float* vs = ks + TK;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int i = tid + j * NT;
    if (i >= TK * C) break;
    cp_async16(kc + i * 16, reinterpret_cast<const unsigned char*>(k_pages) +
                                src[j], live[j]);
    cp_async16(vc + i * 16, reinterpret_cast<const unsigned char*>(v_pages) +
                                src[j], live[j]);
  }
  if (tid < TK) {
    cp_async4(ks + tid, k_scales + row, scale_live);
    cp_async4(vs + tid, v_scales + row, scale_live);
  }
}

// One pass over an int8 stage: each code times its row's scale in f32,
// rounded to bf16 (the rounding of the plain version's dequantizing
// gather), into the K and V tiles [TK][D + 8].
template <int D, int TK, int NT>
__device__ __forceinline__ void dequant_kv_tile(const unsigned char* stage,
                                                bf16* kt, bf16* vt, int tid) {
  constexpr int KS = D + 8;
  constexpr int C = D / 8;  // 8 codes (one 8-byte load) a step
  const int8_t* codes = reinterpret_cast<const int8_t*>(stage);
  const float* scales = reinterpret_cast<const float*>(codes + 2 * TK * D);
  for (int i = tid; i < 2 * TK * C; i += NT) {
    const int side = i / (TK * C);  // 0: K, 1: V
    const int r = (i / C) % TK;
    const int c = i % C;
    const int2 raw = *reinterpret_cast<const int2*>(
        codes + (side * TK + r) * D + c * 8);
    const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
    const float s = scales[side * TK + r];
    uint4 packed;
    uint32_t* h = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      h[j] = pack_bf16((float)b[2 * j] * s, (float)b[2 * j + 1] * s);
    *reinterpret_cast<uint4*>((side ? vt : kt) + r * KS + c * 8) = packed;
  }
}

}  // namespace mma
