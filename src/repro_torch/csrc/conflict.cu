// Prefix-conflict matrix for one window of tasks — Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/conflict/conflict.py
// (conflict_matrix_pallas, pallas_call at :150; _kernel :87,
// _hazard_tile :54).
//
// Computes C[i, j] = 1 iff j < i, valid[i], valid[j] and later task i
// conflicts with earlier task j on its id footprint:
//   flow   W_j ∩ R_i ≠ ∅                  (always; the paper's record rule)
//   output W_j ∩ W_i ≠ ∅, anti W_i ∩ R_j ≠ ∅   (strict closure)
// Ids < 0 are unused slots. Output is one byte per cell (torch.bool).
//
// What bounds it on this card: bytes. The W² output bytes dominate
// (W = 4096: 16.8 MB against ~0.4 MB of ids); the compares are
// W²/2 · (nr·nw + nw·nw + nw·nr) integer operations, of the same order of
// time at the CUDA-core rate for SIS's nr = 1 + max_degree.
//
// Design: one 32×32 CTA per output tile, one thread per cell, so any W
// works without padding the inputs (edge threads mask themselves). The
// tile's row-side ids (task i) and column-side ids (task j) are staged in
// shared memory once and reused by all 1024 cells; the column side is
// stored transposed ([slot][tile column]) so a warp — one tile row, 32
// consecutive j — reads 32 consecutive words, free of bank conflicts,
// while the row side is one broadcast word per warp. A warp's 32 output
// bytes are contiguous. Tiles strictly above the diagonal only write
// zeros. Kept simple: one byte per thread per store, no vector stores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 32;

__global__ void __launch_bounds__(TILE * TILE)
conflict_matrix_kernel(const int32_t* __restrict__ reads,
                       const int32_t* __restrict__ writes,
                       const uint8_t* __restrict__ valid,
                       uint8_t* __restrict__ out,
                       int w, int nr, int nw, int strict) {
  extern __shared__ int32_t smem[];
  const int bi = blockIdx.y, bj = blockIdx.x;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int i = bi * TILE + ty;  // later task (row)
  const int j = bj * TILE + tx;  // earlier task (column)

  if (bj > bi) {  // strictly above the block diagonal: identically zero
    if (i < w && j < w) out[(size_t)i * w + j] = 0;
    return;
  }

  int32_t* r_i = smem;              // [TILE][nr]  row side
  int32_t* w_i = r_i + TILE * nr;   // [TILE][nw]
  int32_t* r_j = w_i + TILE * nw;   // [nr][TILE]  column side, transposed
  int32_t* w_j = r_j + nr * TILE;   // [nw][TILE]

  const int tid = ty * TILE + tx;
  for (int e = tid; e < TILE * nr; e += TILE * TILE) {
    const int t = e / nr, c = e - t * nr;
    const int gi = bi * TILE + t, gj = bj * TILE + t;
    r_i[e] = gi < w ? reads[(size_t)gi * nr + c] : -1;
    r_j[c * TILE + t] = gj < w ? reads[(size_t)gj * nr + c] : -1;
  }
  for (int e = tid; e < TILE * nw; e += TILE * TILE) {
    const int t = e / nw, c = e - t * nw;
    const int gi = bi * TILE + t, gj = bj * TILE + t;
    w_i[e] = gi < w ? writes[(size_t)gi * nw + c] : -1;
    w_j[c * TILE + t] = gj < w ? writes[(size_t)gj * nw + c] : -1;
  }
  __syncthreads();

  if (i >= w || j >= w) return;
  uint8_t hit = 0;
  if (j < i && valid[i] && valid[j]) {
    for (int a = 0; a < nw && !hit; ++a) {
      const int32_t wj = w_j[a * TILE + tx];
      if (wj < 0) continue;
      for (int c = 0; c < nr; ++c) hit |= (r_i[ty * nr + c] == wj);  // flow
      if (strict)
        for (int c = 0; c < nw; ++c) hit |= (w_i[ty * nw + c] == wj);  // output
    }
    if (strict) {
      for (int a = 0; a < nw && !hit; ++a) {  // anti
        const int32_t wi = w_i[ty * nw + a];
        if (wi < 0) continue;
        for (int c = 0; c < nr; ++c) hit |= (r_j[c * TILE + tx] == wi);
      }
    }
  }
  out[(size_t)i * w + j] = hit;
}

}  // namespace

// Shared memory a launch needs for nr read slots and nw write slots.
extern "C" int conflict_matrix_smem_bytes(int nr, int nw) {
  return 2 * TILE * (nr + nw) * (int)sizeof(int32_t);
}

// reads [w, nr] int32, writes [w, nw] int32, valid [w] bool, out [w, w]
// bool; all contiguous on the device. Launches on `stream`; returns
// cudaGetLastError() (0 = launched).
extern "C" int conflict_matrix_launch(const void* reads, const void* writes,
                                      const void* valid, void* out, int w,
                                      int nr, int nw, int strict,
                                      void* stream) {
  if (w <= 0 || nr <= 0 || nw <= 0) return (int)cudaErrorInvalidValue;
  const int tiles = (w + TILE - 1) / TILE;
  const dim3 grid(tiles, tiles), block(TILE, TILE);
  const size_t smem = (size_t)conflict_matrix_smem_bytes(nr, nw);
  conflict_matrix_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      (const int32_t*)reads, (const int32_t*)writes, (const uint8_t*)valid,
      (uint8_t*)out, w, nr, nw, strict);
  return (int)cudaGetLastError();
}
