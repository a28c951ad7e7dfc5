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
// What bounds it on this card: bytes — the lower triangle, W²/2 bytes
// (8.4 MB at W = 4096), read once, which the whole card streams in ~2.5 us
// at 3.35 TB/s — and, behind them, the dependence depth: a row's level
// waits on the levels of the rows it conflicts with.
//
// Design: the levels are the least fixed point of the monotone map
//   F(L)[i] = valid[i] ? max(base[i], 1 + max{ L[j] : j < i, C[i, j] }) : -1
// from L0 = F's floor (base, or -1 for invalid rows). Since only j < i
// counts, F has one fixed point: for a window whose longest chain of
// conflicts has d edges, F applied d times to L0 gives it, so d + 1
// parallel passes reach it and prove it (the last one changes nothing).
// The MABS windows are 2-3 waves deep, so a few passes suffice whatever W.
// One cooperative launch runs every pass on every SM (one CTA of 32 warps
// per SM at most, a warp per row, rows strided over the grid's warps):
//   pass 0 — each warp reads its row's bytes below the diagonal (16-byte
//            loads when W % 16 == 0, a ballot per 32 bytes otherwise),
//            packs them into a bitmap (W·ceil(W/32) words of scratch that
//            the binding allocates; words below the diagonal only) and
//            applies F to L0, writing `out`;
//   pass p — each CTA copies `out` into shared memory when 4·W bytes fit
//            (W <= 56,320), else reads it from L2; each warp applies F to
//            its row from the bitmap (W²/16 bytes for the whole triangle,
//            1 MB at W = 4096, L2-resident) and writes `out` if the level
//            rose. Reading a vector that other CTAs are raising mid-pass is
//            safe: every value is a lower bound that only rises, and a pass
//            in which no row rose read one unchanged vector throughout.
// A warp takes a row's words 32 at a time (one per lane), then each
// nonzero word in turn, broadcast: lane l reads the level of its column
// 32·word + l, so the reads of a word are consecutive (no bank conflicts).
// Each CTA ORs its rows' changes into a per-CTA flag (two buffers by pass
// parity, so a flag is never rewritten before every CTA has read it);
// grid.sync() separates the passes. A window of at most 32 rows runs as
// one CTA, without flags or grid barrier (an ordinary launch), and goes
// from the packing pass straight to the sweep, which resolves it in one
// diagonal block — serving's windows of 8.
//
// The worst case is bounded: after MAX_PASSES = 8 passes without
// convergence (a window whose longest chain of conflicts has d edges takes
// d + 1 passes; the MABS windows take 2-4), CTA 0 recomputes every level from scratch with
// an exact blocked sweep, the other CTAs exit. It walks 32-row blocks,
// right-looking: every row keeps the running max of the levels it
// depends on among the rows resolved so far, so
//   1. diagonal — warp 0 resolves the 32×32 diagonal block serially: lane
//      l holds row r0 + l's running max and its in-block dependencies
//      (one bitmap word); at step k lane k's level is final and is
//      broadcast with a shuffle to the lanes that depend on it;
//   2. tables — a thread per entry computes the max of the block's levels
//      over each subset of each quarter of the block (4 x 256 entries);
//   3. fold — every thread takes rows below the block and folds the
//      block's levels named by the row's bitmap word into its running max
//      with four table lookups (all rows at once, whatever their density);
// with a barrier after each; warp 0 loads the next block's diagonal
// inputs meanwhile, and each thread its first rows' fold words.
// The levels live in shared memory when they fit, else in `out` (L2). No
// window size is refused: W is bounded by device memory (the bitmap) and
// the matrix itself.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int ROWS = 32;           // warps per CTA = rows per finisher block
constexpr int THREADS = ROWS * 32;
constexpr int UNROLL = 4;          // 16-byte loads in flight per lane
// relaxation passes (the packing pass included) before the blocked sweep
constexpr int MAX_PASSES = 8;
constexpr unsigned FULL = 0xffffffffu;
// the level vector is copied to shared memory up to this many bytes (the
// sweep's tables take 4 KB more)
constexpr size_t LV_SMEM_MAX = 220 * 1024;
// per-CTA flag slots in each of the two flag buffers
constexpr int MAX_GRID = 1024;

struct Args {
  const uint8_t* conf;   // [w, w]
  const uint8_t* valid;  // [w]
  const int32_t* base;   // [w] or NULL
  int32_t* out;          // [w] levels
  uint32_t* bits;        // [w, nw] lower-triangle bitmap (scratch)
  int* flags;            // [2, MAX_GRID] per-CTA change flags (scratch)
  int* info;             // [2]: passes run, finisher ran (its own tensor)
  int w, nw, vec, max_passes, lv_smem;
};

__device__ __forceinline__ int warp_max(int m) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = max(m, __shfl_xor_sync(FULL, m, off));
  return m;
}

// 4 conflict bytes (any nonzero byte is set) -> 4 bits, byte b to bit b
__device__ __forceinline__ uint32_t nibble(uint32_t x) {
  const uint32_t set = ((((x & 0x7f7f7f7fu) + 0x7f7f7f7fu) | x) >> 7) &
                       0x01010101u;
  return ((set * 0x01020408u) >> 24) & 0xFu;
}

// L0: the floor a row starts from
__device__ __forceinline__ int floor_of(const Args& a, int j) {
  return a.valid[j] ? (a.base ? a.base[j] : 0) : -1;
}

// the level row j holds now: the CTA's copy, or L2 (never L1, which does
// not see the other SMs' writes)
__device__ __forceinline__ int level_of(const Args& a, const int* s_lv,
                                        int j) {
  return a.lv_smem ? s_lv[j] : __ldcg(a.out + j);
}

// max(m, the levels — or, in pass 0, the floors — of the rows named by
// the warp's words: lane l holds `word`, bitmap word `wd` of the row (0:
// none). Each nonzero word in turn is broadcast and lane l tests its
// column 32·wd + l, so the lanes' reads of a word's rows are consecutive:
// no bank conflicts in shared memory, one 128-byte line in L2.
template <bool FLOOR>
__device__ __forceinline__ int max_over_set(const Args& a, const int* s_lv,
                                            uint32_t word, int wd, int lane,
                                            int m) {
  for (uint32_t nz = __ballot_sync(FULL, word != 0); nz; nz &= nz - 1) {
    const int src = __ffs(nz) - 1;
    const uint32_t bits = __shfl_sync(FULL, word, src);
    const int j = (__shfl_sync(FULL, wd, src) << 5) + lane;
    if ((bits >> lane) & 1u)
      m = max(m, FLOOR ? floor_of(a, j) : level_of(a, s_lv, j));
  }
  return m;
}

// Pass 0 for row i: pack its bytes below the diagonal into bitmap words
// and reduce the floors of the rows they name; returns the max on every
// lane (-1: no dependency).
__device__ int pack_row(const Args& a, int i, int lane) {
  const uint8_t* row = a.conf + (size_t)i * a.w;
  uint32_t* brow = a.bits + (size_t)i * a.nw;
  const int nwords = (i + 31) >> 5;
  int m = -1;
  if (a.vec) {  // w % 16 == 0 and a 16-byte aligned matrix
    const uint4* row4 = reinterpret_cast<const uint4*>(row);
    for (int c0 = 0; c0 < i; c0 += 512 * UNROLL) {
      uint4 q[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {  // lane l: 16 columns from 16·l
        const int col = c0 + 512 * u + 16 * lane;
        q[u] = col < i ? row4[col >> 4] : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int cbase = c0 + 512 * u;  // warp-uniform
        if (cbase >= i) break;
        const int col = cbase + 16 * lane;
        uint32_t h = nibble(q[u].x) | nibble(q[u].y) << 4 |
                     nibble(q[u].z) << 8 | nibble(q[u].w) << 12;
        const int keep = i - col;  // columns of this lane below i
        if (keep < 16) h &= keep > 0 ? (1u << keep) - 1 : 0u;
        const uint32_t hi = __shfl_down_sync(FULL, h, 1);
        // even lane l holds word (cbase / 32) + l / 2
        const uint32_t word = lane & 1 ? 0u : h | hi << 16;
        const int wd = (cbase >> 5) + (lane >> 1);
        if (!(lane & 1) && wd < nwords) brow[wd] = word;
        m = max_over_set<true>(a, nullptr, word, wd, lane, m);
      }
    }
  } else {
    for (int c0 = 0; c0 < i; c0 += 32) {
      const int j = c0 + lane;
      const bool set = j < i && row[j] != 0;
      const uint32_t word = __ballot_sync(FULL, set);
      if (lane == 0) brow[c0 >> 5] = word;
      if (set) m = max(m, floor_of(a, j));
    }
  }
  return warp_max(m);
}

// max(m, the levels of the rows named by words [0, nwords) of a bitmap
// row): lane-strided loads, UNROLL words in flight per lane
__device__ __forceinline__ int max_over_words(const Args& a, const int* s_lv,
                                              const uint32_t* brow,
                                              int nwords, int lane, int m) {
  for (int wd0 = 0; wd0 < nwords; wd0 += 32 * UNROLL) {
    uint32_t word[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int wd = wd0 + 32 * u + lane;
      word[u] = wd < nwords ? __ldcg(brow + wd) : 0u;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      m = max_over_set<false>(a, s_lv, word[u], wd0 + 32 * u + lane, lane,
                              m);
  }
  return m;
}

// Row j's entry of the sweep's vector: its level once resolved, before
// that the running max over the resolved rows it depends on.
__device__ __forceinline__ void set_level(const Args& a, int* s_lv, int j,
                                          int v) {
  if (a.lv_smem)
    s_lv[j] = v;
  else
    a.out[j] = v;
}

// The exact blocked sweep, in one CTA, from scratch, right-looking: each
// row keeps the running max of the levels it depends on among the rows
// resolved so far, so a 32-row block needs only its own diagonal before
// it is final, and the rows below it fold its levels in all at once,
// through four 256-entry tables of the max over each subset of each
// quarter of the block (so a row's fold costs four lookups whatever its
// density).
__device__ void finish(const Args& a, int* s_lv, int (*table)[256],
                       int warp, int lane) {
  static_assert(THREADS == 4 * 256, "a thread per table entry");
  const int w = a.w;
  for (int i = threadIdx.x; i < w; i += THREADS) set_level(a, s_lv, i, -1);
  // warp 0's diagonal inputs of the next block (they do not depend on any
  // level, so each block's are loaded while the previous block is folded
  // in): row r0 + lane's dependencies inside the block (bit k: C[r, r0 +
  // k], k < lane), validity and floor
  uint32_t bits = 0;
  int floor_r = 0;
  bool ok = false;
  auto diagonal_inputs = [&](int r0) {
    const int r = r0 + lane;
    bits = 0, floor_r = 0, ok = false;
    if (r < w) {
      if (lane > 0)
        bits = __ldcg(a.bits + (size_t)r * a.nw + (r0 >> 5)) &
               ((1u << lane) - 1);
      ok = a.valid[r] != 0;
      floor_r = a.base ? a.base[r] : 0;
    }
  };
  if (warp == 0) diagonal_inputs(0);
  __syncthreads();
  for (int r0 = 0; r0 < w; r0 += ROWS) {
    // the fold's words of the thread's first UNROLL rows below the block,
    // in flight during the diagonal and the tables
    uint32_t ahead[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = r0 + ROWS + threadIdx.x + u * THREADS;
      ahead[u] = i < w ? __ldcg(a.bits + (size_t)i * a.nw + (r0 >> 5)) : 0u;
    }
    // 1. the diagonal block, serially in warp 0
    if (warp == 0) {
      const int r = r0 + lane;
      int acc = r < w ? level_of(a, s_lv, r) : -1;
      int mine = -1;
#pragma unroll
      for (int k = 0; k < ROWS; ++k) {
        // lane k's dependencies on lanes < k are all folded in by now
        const int lk = ok ? max(acc + 1, floor_r) : -1;
        if (lane == k) mine = lk;
        const int level_k = __shfl_sync(FULL, lk, k);
        if ((bits >> k) & 1u) acc = max(acc, level_k);
      }
      if (r < w) {
        set_level(a, s_lv, r, mine);
        a.out[r] = mine;
      }
    }
    __syncthreads();
    if (r0 + ROWS >= w) break;  // the last block: no rows below
    if (warp == 0) diagonal_inputs(r0 + ROWS);
    // 2. the tables: table[q][mask] = max of the block's levels at the
    //    bits of mask in quarter q (rows r0 + 8q, ..., r0 + 8q + 7)
    {
      const int q = threadIdx.x >> 8, mask = threadIdx.x & 255;
      int m = -1;
      for (uint32_t t = mask; t; t &= t - 1) {
        const int j = r0 + 8 * q + __ffs(t) - 1;
        if (j < w) m = max(m, level_of(a, s_lv, j));
      }
      table[q][mask] = m;
    }
    __syncthreads();
    // 3. the rows below fold the block's levels into their running max
    for (int i0 = r0 + ROWS + threadIdx.x; i0 < w; i0 += THREADS * UNROLL) {
      uint32_t word[UNROLL];  // UNROLL rows' words in flight at once
      const bool first = i0 == r0 + ROWS + (int)threadIdx.x;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int i = i0 + u * THREADS;
        word[u] = first ? ahead[u]
                  : i < w ? __ldcg(a.bits + (size_t)i * a.nw + (r0 >> 5))
                          : 0u;
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const uint32_t t = word[u];
        if (!t) continue;
        const int i = i0 + u * THREADS;
        const int m = max(max(table[0][t & 255], table[1][(t >> 8) & 255]),
                          max(table[2][(t >> 16) & 255], table[3][t >> 24]));
        set_level(a, s_lv, i, max(level_of(a, s_lv, i), m));
      }
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(THREADS, 1)
wave_levels_kernel(Args a) {
  extern __shared__ int s_lv[];  // [w] when a.lv_smem
  __shared__ int table[4][256];  // the sweep's subset maxima
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int first = blockIdx.x * ROWS + warp, stride = gridDim.x * ROWS;
  const int w = a.w;
  // one CTA needs no grid barrier and no flags: its barrier suffices
  const bool solo = gridDim.x == 1;

  // pass 0: pack the bitmap and apply F to the floors
  bool changed = false;
  for (int i = first; i < w; i += stride) {
    const int m = pack_row(a, i, lane);
    if (lane == 0) {
      const int l0 = floor_of(a, i);
      const int v = a.valid[i] ? max(m + 1, l0) : -1;
      a.out[i] = v;
      changed |= v != l0;
    }
  }
  int passes = 1, swept = 0;
  int any = __syncthreads_or(changed);
  for (;;) {
    if (!solo) {  // did the last pass raise a level in any CTA?
      int* flags = a.flags + ((passes - 1) & 1) * MAX_GRID;
      if (threadIdx.x == 0) flags[blockIdx.x] = any;
      cg::this_grid().sync();
      int seen = 0;
      for (int b = threadIdx.x; b < gridDim.x; b += THREADS)
        seen |= __ldcg(flags + b);
      any = __syncthreads_or(seen);
    }
    if (!any) break;                     // no: the fixed point
    if (passes == a.max_passes) {        // not converging fast: the sweep
      if (blockIdx.x == 0) finish(a, s_lv, table, warp, lane);
      swept = 1;
      break;
    }
    if (a.lv_smem) {
      for (int j = threadIdx.x; j < w; j += THREADS)
        s_lv[j] = __ldcg(a.out + j);
      __syncthreads();
    }
    changed = false;
    for (int i = first; i < w; i += stride) {
      const int m = warp_max(max_over_words(
          a, s_lv, a.bits + (size_t)i * a.nw, (i + 31) >> 5, lane, -1));
      if (lane == 0 && a.valid[i]) {
        const int old = level_of(a, s_lv, i);
        const int v = max(m + 1, a.base ? a.base[i] : 0);
        if (v != old) {
          a.out[i] = v;
          changed = true;
        }
      }
    }
    ++passes;
    any = __syncthreads_or(changed);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    a.info[0] = passes;
    a.info[1] = swept;
  }
}

}  // namespace

// Scratch the binding allocates for a window of w: the bitmap's 32-bit
// words (w rows of ceil(w / 32)), then 2·MAX_GRID flag words.
extern "C" long long wave_levels_scratch_words(int w) {
  return (long long)w * ((w + 31) / 32) + 2 * MAX_GRID;
}

namespace {

// The grid of the last launch's device and shared memory size (the
// occupancy query and the opt-in cost host time on every window).
struct Grid {
  int dev = -1;
  size_t smem = 0;
  int ctas = 0;  // resident CTAs on the whole card
};
thread_local Grid last_grid;

cudaError_t resident_ctas(int dev, size_t smem, int* ctas) {
  if (last_grid.dev != dev || last_grid.smem != smem) {
    int sms = 0, per_sm = 0;
    cudaError_t e =
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess && smem > 48 * 1024)
      e = cudaFuncSetAttribute(wave_levels_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)LV_SMEM_MAX);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, wave_levels_kernel, THREADS, smem);
    if (e != cudaSuccess) return e;
    last_grid.dev = dev;
    last_grid.smem = smem;
    last_grid.ctas = sms * per_sm;
  }
  *ctas = last_grid.ctas;
  return cudaSuccess;
}

}  // namespace

// conf [w, w] bool, valid [w] bool, base [w] int32 or NULL, out [w] int32,
// scratch (wave_levels_scratch_words(w) int32 words), info [2] int32 (the
// launch writes its passes and whether it swept); all contiguous on the
// device. vec = 1 selects 16-byte row loads (w % 16 == 0 and conf 16-byte
// aligned). One launch on `stream` — cooperative, of as many
// CTAs as are resident at once (at most one per 32 rows), unless one CTA
// takes the window; returns the CUDA error (0 = launched).
extern "C" int wave_levels_launch(const void* conf, const void* valid,
                                  const void* base, void* out, void* scratch,
                                  void* info, int w, int vec, void* stream) {
  if (w <= 0) return (int)cudaErrorInvalidValue;
  int dev = 0, grid = 0;
  cudaError_t e = cudaGetDevice(&dev);
  const bool lv_smem = (size_t)w * sizeof(int) <= LV_SMEM_MAX;
  const size_t smem = lv_smem ? (size_t)w * sizeof(int) : 0;
  if (e == cudaSuccess) e = resident_ctas(dev, smem, &grid);
  if (e != cudaSuccess) return (int)e;
  const int needed = (w + ROWS - 1) / ROWS;
  if (grid > needed) grid = needed;
  if (grid > MAX_GRID) grid = MAX_GRID;
  if (grid < 1) return (int)cudaErrorInvalidConfiguration;
  // a window of at most ROWS tasks is one diagonal block: the sweep
  // resolves it in one step, so it follows the packing pass directly
  const int max_passes = w <= ROWS ? 1 : MAX_PASSES;
  uint32_t* words = (uint32_t*)scratch;
  const size_t nbits = (size_t)w * ((w + 31) / 32);
  Args a;
  a.conf = (const uint8_t*)conf;
  a.valid = (const uint8_t*)valid;
  a.base = (const int32_t*)base;
  a.out = (int32_t*)out;
  a.bits = words;
  a.flags = (int*)(words + nbits);
  a.info = (int*)info;
  a.w = w;
  a.nw = (w + 31) / 32;
  a.vec = vec;
  a.max_passes = max_passes;
  a.lv_smem = lv_smem ? 1 : 0;
  if (grid == 1) {  // no grid barrier: an ordinary launch
    wave_levels_kernel<<<1, THREADS, smem, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
  }
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel((const void*)wave_levels_kernel,
                                  dim3(grid), dim3(THREADS), args, smem,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
