// Conflict kernels over task id footprints — Hopper (sm_90a).
//
// Two entry points share one per-cell hazard test (hazard() below), as
// the TPU kernels share _hazard_tile:
//
//   conflict_matrix  replaces src/repro/kernels/conflict/conflict.py
//                    conflict_matrix_pallas (pallas_call at :150; _kernel
//                    :87). The [W, W] prefix-conflict matrix of one window:
//                    C[i, j] = 1 iff j < i, valid[i], valid[j] and hazard.
//   conflict_block   replaces conflict_block_pallas (pallas_call at :219;
//                    _block_kernel :162). The [Wi, Wj] cross-window block:
//                    row i is a task of the later window, column j a task
//                    of the earlier one, so every j precedes every i and
//                    there is no triangle: C[i, j] = 1 iff valid_i[i],
//                    valid_j[j] and hazard. The two sides carry their own
//                    slot counts (nr_i, nw_i) and (nr_j, nw_j).
//
// hazard(i, j): later task i conflicts with earlier task j iff
//   flow   W_j ∩ R_i ≠ ∅                  (always; the paper's record rule)
//   output W_j ∩ W_i ≠ ∅, anti W_i ∩ R_j ≠ ∅   (strict closure)
// Ids < 0 are unused slots. Output is one byte per cell (torch.bool).
//
// What bounds them on this card: bytes at narrow footprints — the output
// bytes dominate (W = 4096: 16.8 MB against ~0.4 MB of ids) — and the
// compares at wide ones: nr·nw + nw·nw + nw·nr integer operations per
// cell, which pass the output's time at the CUDA-core rate from a few
// hundred slots on (SIS reads 1 + max_degree ids a task).
//
// Design: one 32×32 CTA per output tile, one thread per cell, so any W
// works without padding the inputs (edge threads mask themselves). The
// tile's row-side ids (task i) and column-side ids (task j) are staged in
// shared memory and reused by all 1024 cells; the column side is stored
// transposed ([slot][tile column]) so a warp — one tile row, 32
// consecutive j — reads 32 consecutive words, free of bank conflicts,
// while the row side is one broadcast word per warp. A warp's 32 output
// bytes are contiguous. In the prefix matrix, tiles strictly above the
// diagonal only write zeros; the block has no such tiles. Kept simple: one
// byte per thread per store, no vector stores.
//
// Any footprint width: when both sides' slots fit 48 KB of shared memory
// (nr_i + nw_i + nr_j + nw_j <= 384), the narrow kernels stage every slot
// at once (stage_tile, one flat pass). Wider footprints take the chunked
// kernel (conflict_wide_kernel): each pass stages kr read and kw write
// slots of both sides (kr + kw <= 192, chosen by the binding) and ORs the
// pairs it holds into the cell's hit — exact, since the hazard is an OR
// over id pairs. The passes walk every chunk of the reads against every
// chunk pair of the writes; the compares of a pass stop at the last slot
// any of the tile's rows uses (padding past it is -1 and matches nothing:
// SIS pads every neighbour row to the graph's max degree), a cell already
// hit skips its compares, and a tile whose live cells are all hit stops
// early. Nothing bounds the width but the passes' time: every pass still
// stages its slots, 2·32·192 ids a tile.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 32;

// One cell's hazard test. r_i/w_i: the row task's nr_i read and nw_i write
// ids, contiguous. r_j/w_j: the column task's ids in the transposed tile
// layout, slot c at [c * TILE].
__device__ __forceinline__ bool hazard(const int32_t* r_i, int nr_i,
                                       const int32_t* w_i, int nw_i,
                                       const int32_t* r_j, int nr_j,
                                       const int32_t* w_j, int nw_j,
                                       int strict) {
  bool hit = false;
  for (int a = 0; a < nw_j && !hit; ++a) {
    const int32_t wj = w_j[a * TILE];
    if (wj < 0) continue;
    for (int c = 0; c < nr_i; ++c) hit |= (r_i[c] == wj);  // flow
    if (strict)
      for (int c = 0; c < nw_i; ++c) hit |= (w_i[c] == wj);  // output
  }
  if (strict) {
    for (int a = 0; a < nw_i && !hit; ++a) {  // anti
      const int32_t wi = w_i[a];
      if (wi < 0) continue;
      for (int c = 0; c < nr_j; ++c) hit |= (r_j[c * TILE] == wi);
    }
  }
  return hit;
}

// Stage one tile's ids into shared memory, four segments back to back:
// the row side's reads [TILE][nr_i] and writes [TILE][nw_i], then the
// column side's reads [nr_j][TILE] and writes [nw_j][TILE], transposed.
// Rows past the window read -1. One flat loop over all four segments, so
// every load of a thread's first pass is in flight at once: staging is
// latency-bound, and a loop per segment would wait out one load latency
// after another.
__device__ __forceinline__ void stage_tile(
    int32_t* smem, const int32_t* reads_i, const int32_t* writes_i,
    const int32_t* reads_j, const int32_t* writes_j, int base_i, int wi,
    int base_j, int wj, int nr_i, int nw_i, int nr_j, int nw_j, int tid) {
  const int s1 = TILE * nr_i, s2 = s1 + TILE * nw_i;
  const int s3 = s2 + TILE * nr_j, s4 = s3 + TILE * nw_j;
  for (int e = tid; e < s4; e += TILE * TILE) {
    const int32_t* ids;
    int n, base, w, start;
    if (e < s1) {
      ids = reads_i, n = nr_i, base = base_i, w = wi, start = 0;
    } else if (e < s2) {
      ids = writes_i, n = nw_i, base = base_i, w = wi, start = s1;
    } else if (e < s3) {
      ids = reads_j, n = nr_j, base = base_j, w = wj, start = s2;
    } else {
      ids = writes_j, n = nw_j, base = base_j, w = wj, start = s3;
    }
    const int k = e - start, t = k / n, c = k - t * n;
    const int g = base + t;
    smem[start + (start >= s2 ? c * TILE + t : k)] =
        g < w ? ids[(size_t)g * n + c] : -1;
  }
}

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

  stage_tile(smem, reads, writes, reads, writes, bi * TILE, w, bj * TILE, w,
             nr, nw, nr, nw, ty * TILE + tx);
  __syncthreads();

  if (i >= w || j >= w) return;
  const bool hit = j < i && valid[i] && valid[j] &&
                   hazard(r_i + ty * nr, nr, w_i + ty * nw, nw, r_j + tx, nr,
                          w_j + tx, nw, strict);
  out[(size_t)i * w + j] = hit;
}

__global__ void __launch_bounds__(TILE * TILE)
conflict_block_kernel(const int32_t* __restrict__ reads_i,
                      const int32_t* __restrict__ writes_i,
                      const int32_t* __restrict__ reads_j,
                      const int32_t* __restrict__ writes_j,
                      const uint8_t* __restrict__ valid_i,
                      const uint8_t* __restrict__ valid_j,
                      uint8_t* __restrict__ out, int wi, int wj, int nr_i,
                      int nw_i, int nr_j, int nw_j, int strict) {
  extern __shared__ int32_t smem[];
  const int bi = blockIdx.y, bj = blockIdx.x;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int i = bi * TILE + ty;  // later window's task (row)
  const int j = bj * TILE + tx;  // earlier window's task (column)

  int32_t* r_i = smem;                // [TILE][nr_i]  row side
  int32_t* w_i = r_i + TILE * nr_i;   // [TILE][nw_i]
  int32_t* r_j = w_i + TILE * nw_i;   // [nr_j][TILE]  column side, transposed
  int32_t* w_j = r_j + nr_j * TILE;   // [nw_j][TILE]

  stage_tile(smem, reads_i, writes_i, reads_j, writes_j, bi * TILE, wi,
             bj * TILE, wj, nr_i, nw_i, nr_j, nw_j, ty * TILE + tx);
  __syncthreads();

  if (i >= wi || j >= wj) return;
  const bool hit = valid_i[i] && valid_j[j] &&
                   hazard(r_i + ty * nr_i, nr_i, w_i + ty * nw_i, nw_i,
                          r_j + tx, nr_j, w_j + tx, nw_j, strict);
  out[(size_t)i * wj + j] = hit;
}

// Stage one pass of the chunked kernel: read slots [r0, r0 + kr) and
// write slots [a0, a0 + kw) of the row side, read slots [r0, r0 + kr) and
// write slots [b0, b0 + kw) of the column side, in stage_tile's layout
// (row side [TILE][k], column side transposed [k][TILE]). Slots past a
// side's count, and rows past the window, read -1. ext[0..3] (zero on
// entry) receive each segment's used extent: 1 + the last staged slot
// that holds an id >= 0 in any of the tile's rows, so the compares stop
// where every row's slots are unused.
__device__ __forceinline__ void stage_chunk(
    int32_t* smem, int* ext, const int32_t* reads_i,
    const int32_t* writes_i, const int32_t* reads_j,
    const int32_t* writes_j, int base_i, int wi, int base_j, int wj,
    int nr_i, int nw_i, int nr_j, int nw_j, int r0, int a0, int b0, int kr,
    int kw, int tid) {
  const int s1 = TILE * kr, s2 = s1 + TILE * kw;
  const int s3 = s2 + TILE * kr, s4 = s3 + TILE * kw;
  int used[4] = {0, 0, 0, 0};
  for (int e = tid; e < s4; e += TILE * TILE) {
    const int32_t* ids;
    int n, base, w, start, k, off, seg;
    if (e < s1) {
      ids = reads_i, n = nr_i, base = base_i, w = wi, start = 0, k = kr,
      off = r0, seg = 0;
    } else if (e < s2) {
      ids = writes_i, n = nw_i, base = base_i, w = wi, start = s1, k = kw,
      off = a0, seg = 1;
    } else if (e < s3) {
      ids = reads_j, n = nr_j, base = base_j, w = wj, start = s2, k = kr,
      off = r0, seg = 2;
    } else {
      ids = writes_j, n = nw_j, base = base_j, w = wj, start = s3, k = kw,
      off = b0, seg = 3;
    }
    const int q = e - start, t = q / k, c = q - t * k;
    const int g = base + t, slot = off + c;
    const int32_t id = g < w && slot < n ? ids[(size_t)g * n + slot] : -1;
    smem[start + (start >= s2 ? c * TILE + t : q)] = id;
    if (id >= 0) {
#pragma unroll
      for (int x = 0; x < 4; ++x)
        if (x == seg) used[x] = max(used[x], c + 1);
    }
  }
#pragma unroll
  for (int x = 0; x < 4; ++x) {  // a warp max, then one atomic per warp
    const int m = __reduce_max_sync(0xffffffffu, used[x]);
    if ((tid & 31) == 0 && m > 0) atomicMax(ext + x, m);
  }
}

// The chunked kernel of both entry points (PREFIX: the prefix matrix,
// whose two sides are one window; else the cross-window block).
template <bool PREFIX>
__global__ void __launch_bounds__(TILE * TILE)
conflict_wide_kernel(const int32_t* __restrict__ reads_i,
                     const int32_t* __restrict__ writes_i,
                     const int32_t* __restrict__ reads_j,
                     const int32_t* __restrict__ writes_j,
                     const uint8_t* __restrict__ valid_i,
                     const uint8_t* __restrict__ valid_j,
                     uint8_t* __restrict__ out, int wi, int wj, int nr_i,
                     int nw_i, int nr_j, int nw_j, int strict, int kr,
                     int kw) {
  extern __shared__ int32_t smem[];
  const int bi = blockIdx.y, bj = blockIdx.x;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int i = bi * TILE + ty;  // later task (row)
  const int j = bj * TILE + tx;  // earlier task (column)

  if (PREFIX && bj > bi) {  // strictly above the block diagonal: zero
    if (i < wi && j < wj) out[(size_t)i * wj + j] = 0;
    return;
  }

  int32_t* r_i = smem;              // [TILE][kr]  row side
  int32_t* w_i = r_i + TILE * kr;   // [TILE][kw]
  int32_t* r_j = w_i + TILE * kw;   // [kr][TILE]  column side, transposed
  int32_t* w_j = r_j + kr * TILE;   // [kw][TILE]

  const bool live = i < wi && j < wj && (!PREFIX || j < i) && valid_i[i] &&
                    valid_j[j];
  // used extents of the four staged segments, one buffer per pass parity:
  // a pass zeroes the other buffer, which the next pass fills
  __shared__ int ext[2][4];
  const int tid = ty * TILE + tx;
  if (tid < 8) ext[tid >> 2][tid & 3] = 0;
  __syncthreads();
  const int nr = max(nr_i, nr_j);
  bool hit = false;
  int pass = 0;
  for (int a0 = 0; a0 < nw_i; a0 += kw) {
    for (int b0 = 0; b0 < nw_j; b0 += kw) {
      for (int r0 = 0; r0 < nr; r0 += kr, ++pass) {
        int* e = ext[pass & 1];
        stage_chunk(smem, e, reads_i, writes_i, reads_j, writes_j, bi * TILE,
                    wi, bj * TILE, wj, nr_i, nw_i, nr_j, nw_j, r0, a0, b0,
                    kr, kw, tid);
        if (tid < 4) ext[(pass + 1) & 1][tid] = 0;
        __syncthreads();
        if (live && !hit)
          hit = hazard(r_i + ty * kr, e[0], w_i + ty * kw, e[1], r_j + tx,
                       e[2], w_j + tx, e[3], strict);
        // the barrier before the next pass restages; a tile whose live
        // cells are all hit is done
        if (__syncthreads_and(hit || !live)) goto done;
      }
    }
  }
done:
  if (i < wi && j < wj) out[(size_t)i * wj + j] = hit;
}

}  // namespace

// Bytes of one stage: a tile's rows and columns with `row` and `col` slots.
static size_t stage_bytes(int row, int col) {
  return (size_t)TILE * (row + col) * sizeof(int32_t);
}

// The shared memory a CTA gets without opting in; the binding picks (kr,
// kw) within it, or 0 for the narrow kernel when the whole footprint fits.
static constexpr size_t STAGE_LIMIT = 48 * 1024;

// The chunked kernel's few bytes of static shared memory (the used
// extents) come on top of a full stage: it opts in past 48 KB.
template <typename K>
static cudaError_t opt_in(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// reads [w, nr] int32, writes [w, nw] int32, valid [w] bool, out [w, w]
// bool; all contiguous on the device. kr = kw = 0: the narrow kernel
// (every slot staged at once); else the chunked kernel, kr read and kw
// write slots a pass. Launches on `stream`; returns cudaGetLastError()
// (0 = launched).
extern "C" int conflict_matrix_launch(const void* reads, const void* writes,
                                      const void* valid, void* out, int w,
                                      int nr, int nw, int strict, int kr,
                                      int kw, void* stream) {
  if (w <= 0 || nr <= 0 || nw <= 0 || kr < 0 || kw < 0)
    return (int)cudaErrorInvalidValue;
  const int tiles = (w + TILE - 1) / TILE;
  if (tiles > 65535) return (int)cudaErrorInvalidValue;  // grid.y limit
  const dim3 grid(tiles, tiles), block(TILE, TILE);
  const cudaStream_t st = (cudaStream_t)stream;
  if (kr == 0 && kw == 0) {
    const size_t smem = stage_bytes(nr + nw, nr + nw);
    if (smem > STAGE_LIMIT) return (int)cudaErrorInvalidValue;
    conflict_matrix_kernel<<<grid, block, smem, st>>>(
        (const int32_t*)reads, (const int32_t*)writes, (const uint8_t*)valid,
        (uint8_t*)out, w, nr, nw, strict);
  } else {
    const size_t smem = stage_bytes(kr + kw, kr + kw);
    if (kr == 0 || kw == 0 || smem > STAGE_LIMIT)
      return (int)cudaErrorInvalidValue;
    const cudaError_t e = opt_in(conflict_wide_kernel<true>, smem);
    if (e != cudaSuccess) return (int)e;
    conflict_wide_kernel<true><<<grid, block, smem, st>>>(
        (const int32_t*)reads, (const int32_t*)writes, (const int32_t*)reads,
        (const int32_t*)writes, (const uint8_t*)valid, (const uint8_t*)valid,
        (uint8_t*)out, w, w, nr, nw, nr, nw, strict, kr, kw);
  }
  return (int)cudaGetLastError();
}

// reads_i [wi, nr_i], writes_i [wi, nw_i], reads_j [wj, nr_j], writes_j
// [wj, nw_j] int32, valid_i [wi], valid_j [wj] bool, out [wi, wj] bool;
// all contiguous on the device. kr, kw as for conflict_matrix_launch.
// Launches on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int conflict_block_launch(const void* reads_i,
                                     const void* writes_i,
                                     const void* reads_j,
                                     const void* writes_j,
                                     const void* valid_i,
                                     const void* valid_j, void* out, int wi,
                                     int wj, int nr_i, int nw_i, int nr_j,
                                     int nw_j, int strict, int kr, int kw,
                                     void* stream) {
  if (wi <= 0 || wj <= 0 || nr_i <= 0 || nw_i <= 0 || nr_j <= 0 ||
      nw_j <= 0 || kr < 0 || kw < 0)
    return (int)cudaErrorInvalidValue;
  const int tiles_i = (wi + TILE - 1) / TILE, tiles_j = (wj + TILE - 1) / TILE;
  if (tiles_i > 65535) return (int)cudaErrorInvalidValue;  // grid.y limit
  const dim3 grid(tiles_j, tiles_i), block(TILE, TILE);
  const cudaStream_t st = (cudaStream_t)stream;
  if (kr == 0 && kw == 0) {
    const size_t smem = stage_bytes(nr_i + nw_i, nr_j + nw_j);
    if (smem > STAGE_LIMIT) return (int)cudaErrorInvalidValue;
    conflict_block_kernel<<<grid, block, smem, st>>>(
        (const int32_t*)reads_i, (const int32_t*)writes_i,
        (const int32_t*)reads_j, (const int32_t*)writes_j,
        (const uint8_t*)valid_i, (const uint8_t*)valid_j, (uint8_t*)out, wi,
        wj, nr_i, nw_i, nr_j, nw_j, strict);
  } else {
    const size_t smem = stage_bytes(kr + kw, kr + kw);
    if (kr == 0 || kw == 0 || smem > STAGE_LIMIT)
      return (int)cudaErrorInvalidValue;
    const cudaError_t e = opt_in(conflict_wide_kernel<false>, smem);
    if (e != cudaSuccess) return (int)e;
    conflict_wide_kernel<false><<<grid, block, smem, st>>>(
        (const int32_t*)reads_i, (const int32_t*)writes_i,
        (const int32_t*)reads_j, (const int32_t*)writes_j,
        (const uint8_t*)valid_i, (const uint8_t*)valid_j, (uint8_t*)out, wi,
        wj, nr_i, nw_i, nr_j, nw_j, strict, kr, kw);
  }
  return (int)cudaGetLastError();
}
