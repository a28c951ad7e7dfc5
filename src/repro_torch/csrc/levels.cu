// Wave levels of one window — Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/levels/levels.py
// (wave_levels_pallas, pallas_call at :109; _kernel :39).
//
// Computes, for a [W, W] conflict matrix C (one byte per cell), valid [W]
// and an optional floor base [W]:
//   level[i] = max(base[i], 1 + max{ level[j] : j < i, C[i, j] }),
//   level[i] = -1 for invalid i.
// Entries at or above the diagonal count for nothing, and entries pointing
// at invalid tasks add -1 + 1 = 0, i.e. nothing beyond the base floor —
// the reference's convention (levels/ref.py), so any matrix is accepted.
//
// What bounds it on this card: bytes in principle — the lower triangle,
// W²/2 bytes (8.4 MB at W = 4096), read once, which the whole card could
// stream in ~2.5 µs at 3.35 TB/s. But the recurrence is sequential, so
// this first kernel runs as ONE CTA on one SM: it is bound by that SM's
// load bandwidth and latency, far from the card's bound (PERF.md records
// the gap; closing it is later work).
//
// Design: the level vector lives in shared memory (4·W bytes, W <= 8192
// without opting in to more than 48 KB). The CTA walks 32-row blocks:
//   1. panel — warp r takes row r0 + r and reduces max{level[j] : j < r0,
//      C[i, j]} over the earlier columns, lane-strided 16-byte loads
//      (four in flight per lane) then a warp shuffle; all 32 rows at once;
//   2. diagonal — warp 0 resolves the 32×32 diagonal block serially: lane
//      l holds row r0 + l's panel max and a bit mask of its in-block
//      dependencies; at step k lane k's level is final and is broadcast
//      with a shuffle to the lanes that depend on it;
//   3. __syncthreads(), so the next panel sees the block's levels.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 32;           // rows per diagonal block = warps per CTA
constexpr int THREADS = ROWS * 32;
constexpr int UNROLL = 4;          // 16-byte loads in flight per lane

__device__ __forceinline__ int max_over_set_bytes(uint32_t word, int base,
                                                  const int* lv, int m) {
  // word holds 4 conflict bytes for columns base..base+3
  if (word == 0) return m;
#pragma unroll
  for (int b = 0; b < 4; ++b)
    if ((word >> (8 * b)) & 0xFFu) m = max(m, lv[base + b]);
  return m;
}

__global__ void __launch_bounds__(THREADS)
wave_levels_kernel(const uint8_t* __restrict__ conf,
                   const uint8_t* __restrict__ valid,
                   const int32_t* __restrict__ base,
                   int32_t* __restrict__ out, int w, int vec) {
  extern __shared__ int lv[];  // [w] levels resolved so far
  __shared__ int dep[ROWS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  for (int r0 = 0; r0 < w; r0 += ROWS) {
    // 1. panel: earlier columns j < r0, one row per warp
    const int i = r0 + warp;
    int m = -1;
    if (i < w) {
      const uint8_t* row = conf + (size_t)i * w;
      if (vec) {  // w % 16 == 0 and a 16-byte aligned matrix
        const uint4* row4 = reinterpret_cast<const uint4*>(row);
        const int chunks = r0 / 16;
        for (int c0 = lane; c0 < chunks; c0 += 32 * UNROLL) {
          uint4 q[UNROLL];
#pragma unroll
          for (int u = 0; u < UNROLL; ++u) {
            const int c = c0 + 32 * u;
            q[u] = c < chunks ? row4[c] : make_uint4(0, 0, 0, 0);
          }
#pragma unroll
          for (int u = 0; u < UNROLL; ++u) {
            const int col = (c0 + 32 * u) * 16;
            m = max_over_set_bytes(q[u].x, col, lv, m);
            m = max_over_set_bytes(q[u].y, col + 4, lv, m);
            m = max_over_set_bytes(q[u].z, col + 8, lv, m);
            m = max_over_set_bytes(q[u].w, col + 12, lv, m);
          }
        }
      } else {
        for (int j = lane; j < r0; j += 32)
          if (row[j]) m = max(m, lv[j]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        m = max(m, __shfl_xor_sync(0xffffffffu, m, off));
    }
    if (lane == 0) dep[warp] = m;
    __syncthreads();

    // 2. diagonal block, serially in warp 0
    if (warp == 0) {
      const int r = r0 + lane;
      uint32_t bits = 0;  // bit k: C[r, r0 + k] for k < lane
      int acc = -1, floor_r = 0;
      bool ok = false;
      if (r < w) {
        acc = dep[lane];
        const uint8_t* row = conf + (size_t)r * w + r0;
        for (int k = 0; k < lane; ++k)
          if (row[k]) bits |= 1u << k;
        ok = valid[r] != 0;
        floor_r = base ? base[r] : 0;
      }
      int mine = -1;
#pragma unroll
      for (int k = 0; k < ROWS; ++k) {
        // lane k's dependencies on lanes < k are all folded in by now
        const int lk = ok ? max(acc + 1, floor_r) : -1;
        if (lane == k) mine = lk;
        const int level_k = __shfl_sync(0xffffffffu, lk, k);
        if ((bits >> k) & 1u) acc = max(acc, level_k);
      }
      if (r < w) {
        lv[r] = mine;
        out[r] = mine;
      }
    }
    __syncthreads();
  }
}

}  // namespace

// Largest window one launch takes: the level vector must fit the 48 KB of
// shared memory a CTA gets without opting in.
extern "C" int wave_levels_max_window(void) { return 8192; }

// conf [w, w] bool, valid [w] bool, base [w] int32 or NULL, out [w] int32;
// all contiguous on the device. vec = 1 selects 16-byte row loads (w % 16
// == 0 and conf 16-byte aligned). Launches on `stream`; returns
// cudaGetLastError() (0 = launched).
extern "C" int wave_levels_launch(const void* conf, const void* valid,
                                  const void* base, void* out, int w,
                                  int vec, void* stream) {
  if (w <= 0 || w > wave_levels_max_window()) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)w * sizeof(int);
  wave_levels_kernel<<<1, THREADS, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)conf, (const uint8_t*)valid, (const int32_t*)base,
      (int32_t*)out, w, vec);
  return (int)cudaGetLastError();
}
