// The block of the split-K decode kernel (csrc/paged_attention.cu,
// paged_decode_mma_kernel) and the ring that feeds it, shared with the
// strided probe that splits that kernel's time (csrc/page_probes.cu,
// strided_probe_mma_kernel), so that the probe runs the decode kernel's
// own block shape and ring schedule, not a copy of them: four warps of 16
// keys, the keys of one kv head streamed through a two-stage cp.async
// ring of 64-key tiles, int8 pages dequantized by one pass into bf16
// tiles kept beside the ring.
//
// A block's shared memory: q's 16-row bf16 tile [16][D + 8], then the
// ring, whose bytes the kernel's epilogue may reuse once stream_tiles has
// returned and the block has synchronized.
#pragma once

#include "mma.cuh"

namespace decode_ring {

using mma::bf16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kKeyTile = 16 * kWarps;  // keys a ring stage, 16 a warp
constexpr int kStages = 2;

template <typename P, int D>
constexpr int ring_bytes() {
  return kStages * mma::stage_bytes<P, D, kKeyTile>() +
         (sizeof(P) == 1 ? 2 * kKeyTile * (D + 8) * 2 : 0);  // int8: bf16 K, V
}

// A block's dynamic shared memory when its epilogue reuses `tail` bytes
// of the ring.
template <typename P, int D>
constexpr int smem_bytes(int tail) {
  return 16 * (D + 8) * 2 +
         (ring_bytes<P, D>() > tail ? ring_bytes<P, D>() : tail);
}

// Start the copies of q's rows 0 .. gn - 1 (at `rows`, D apart) into the
// 16-row tile q_sh; rows gn .. 15 are zero-filled. One commit group.
template <int D>
__device__ __forceinline__ void issue_q_tile(bf16* q_sh, const bf16* rows,
                                             int gn, int tid) {
  constexpr int KS = D + 8;
  for (int i = tid; i < 16 * (D / 8); i += kThreads) {
    const int r = i / (D / 8);
    const int c = i % (D / 8);
    const bool live = r < gn;
    mma::cp_async16(q_sh + r * KS + c * 8, rows + (live ? r * D + c * 8 : 0),
                    live);
  }
  mma::cp_async_commit();
}

// Stream keys start .. start + n_keys - 1 of the kv head `pr` addresses
// through the ring at `ring`: tile `it` (keys start + kKeyTile * it on) is
// handed to body(it, kt, vt) as bf16 tiles [kKeyTile][D + 8], zero rows
// past n_keys, once its copies (and every copy committed before the call,
// q's tile included) have landed and, for int8 pages, the dequantizing
// pass has run; the copies of tile it + 1 are in flight meanwhile. Every
// thread of the block calls it, and body runs between two barriers.
// Returns with every copy landed and no barrier after the last body: the
// block synchronizes before it reuses the ring.
template <typename P, int D, typename Body>
__device__ __forceinline__ void stream_tiles(
    unsigned char* ring, const P* k_pages, const P* v_pages,
    const float* k_scales, const float* v_scales, const mma::PageRows& pr,
    int start, int n_keys, int tid, Body&& body) {
  constexpr int KS = D + 8;
  constexpr int kStage = mma::stage_bytes<P, D, kKeyTile>();
  bf16* kd = reinterpret_cast<bf16*>(ring + kStages * kStage);  // int8 only
  bf16* vd = kd + kKeyTile * KS;
  const int n_tiles = (n_keys + kKeyTile - 1) / kKeyTile;
  auto issue = [&](int tile) {
    const int k = tile * kKeyTile;
    mma::issue_kv_tile<D, kKeyTile, kThreads>(
        ring + (tile % kStages) * kStage, k_pages, v_pages, k_scales,
        v_scales, pr, start + k, min(kKeyTile, n_keys - k), tid);
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) issue(s);
    mma::cp_async_commit();
  }
  for (int it = 0; it < n_tiles; ++it) {
    if (it + kStages - 1 < n_tiles) issue(it + kStages - 1);
    mma::cp_async_commit();
    mma::cp_async_wait<kStages - 1>();  // tile it has landed
    __syncthreads();
    const unsigned char* st = ring + (it % kStages) * kStage;
    if constexpr (sizeof(P) == 1) {
      mma::dequant_kv_tile<D, kKeyTile, kThreads>(st, kd, vd, tid);
      __syncthreads();
      body(it, static_cast<const bf16*>(kd), static_cast<const bf16*>(vd));
    } else {
      const bf16* kt = reinterpret_cast<const bf16*>(st);
      body(it, kt, kt + kKeyTile * KS);
    }
    __syncthreads();  // the stage is free for the copy issued next
  }
  mma::cp_async_wait<0>();
}

}  // namespace decode_ring
