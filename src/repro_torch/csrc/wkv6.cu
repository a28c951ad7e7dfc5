// RWKV6 ("Finch") time-mix recurrence, forward — Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/wkv6/wkv6.py
// (wkv6_pallas :120, pallas_call at :133; _kernel :39).
//
// Computes, per row bh of B·H with u row h = bh % H, state S [D, D]
// (key index i, value index j) starting from s0[bh] (or zeros) and
// data-dependent decays w_t ∈ (0, 1)^D:
//   o_t[j] = Σ_i r_t[i]·S[i][j] + (Σ_i r_t[i]·u[i]·k_t[i])·v_t[j]
//   S[i][j] <- w_t[i]·S[i][j] + k_t[i]·v_t[j]
// for t = 0 .. T−1 in order (the oracle's recurrence,
// src/repro/kernels/wkv6/ref.py:25-30), in float32, for r, k, v, w in
// float32 or bfloat16 (one dtype, read as float32) and any T >= 1 and
// D <= 128. Writes o [B·H, T, D] and the final S into s_out [B·H, D, D],
// float32 — only for the rows whose batch b = bh / H has commit[b] set
// (all rows without a mask); the other rows of s_out are not written.
// s_out may be s0 itself: the serving path's state is updated in place.
// Unlike the TPU kernel it takes an initial state, needs no T % 32 == 0
// (a decode step has T = 1, the last prefill chunk is ragged), and never
// takes log w, so a bfloat16 w that rounds to 0 or 1 is harmless.
//
// What bounds it on this card. At rwkv6-3b's prefill (B·H = 40, T = 2048,
// D = 64, bf16 in) the bytes are ~64 MB (19 us at 3.35 TB/s) and the
// operations 5·T·D² per row, 1.68 GFLOP (25 us at the 67 TFLOP/s float32
// CUDA-core rate): operations bound it, and so they do at the engine's
// prefill chunk (T = 128). A decode wave (B·H = 320, T = 1) is bound by
// the state's bytes: 5.2 MB read and 5.2 MB written.
//
// Design. The loop-carried dependence is one FMA per state entry and
// step; the columns of S are independent, and o_t is a reduction over i
// that nothing carries forward. So a row is split over column blocks
// (one CTA each) and, inside a block, over key rows (threads), and every
// thread carries a small register tile of S (16 or 32 entries), so no
// width spills.
//
// The tiled kernel (T > SHORT_T). CTA (bh, column block of CB = 32) with
// two kinds of warps. Compute thread (rg, jg) owns rows NI·rg ..
// NI·rg + NI − 1 (NI = 4, 8 at D > 64) and four consecutive columns: per
// step it reads r, k, w of its rows from the raw tile in shared memory
// (bf16 unpacked in registers) and v of its columns, the next step's
// before this step's arithmetic, does 3·NI·4 float32 multiply-adds and
// stores four partial o's. Helper warps (256 threads) keep three raw tiles
// of TT steps (32 for bf16 at D <= 64, else 16) in flight with 16-byte
// cp.async (plain copies where a row is not aligned or D < DT, whose
// padding stays zero), convert v's columns and reduce each step's bonus
// Σ_i r·u·k with warp shuffles for tile c + 2, and sum tile c's partial
// o's across the row groups into o, four consecutive columns a helper
// (16-byte loads and stores). Named barriers hand each converted tile and each
// tile of partials between the two groups (two buffers of each); one
// barrier among the helpers per tile. At the engine's chunk (B·H = 40,
// D = 64) that is 80 CTAs of 4 compute and 8 helper warps.
// What tuning on an H100 showed (PERF.md §6): the helpers' per-tile
// work, not shared-memory bandwidth, sets the pace, and a tile has a
// fixed cost besides its steps, so longer tiles win while shared memory
// lasts; a staging pass that converted r, k, w to float32 once per tile
// was no faster than unpacking at each load and took more shared memory.
//
// The short kernel (T <= SHORT_T: decode waves, short last chunks). CTA
// (bh, column block of 32), 2·DT threads (DT = D rounded up to 32, 64 or
// 128); thread (rg, jg) owns rows 4·rg .. 4·rg+3 and four consecutive
// columns, so the state is read and written once with 16-byte accesses
// (scalar ones where D % 4 != 0), 640 CTAs at the decode wave. The
// state's loads are issued before the inputs are staged (a thread per
// eight elements of a step, the bonus reduced with shuffles); the
// partial o's of a step are reduced through shared memory (one barrier
// per step).
//
// Each column block of a row is read and written by one CTA only, so the
// in-place update needs no other synchronisation. No fast math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_D = 128;
// short kernel
constexpr int SHORT_T = 8;     // T <= SHORT_T takes the short kernel
constexpr int SNI = 4;         // key rows per thread
constexpr int SNJ = 4;         // value columns per thread (one float4)
constexpr int SCB = 32;        // value columns per CTA
constexpr int SJG = SCB / SNJ; // column groups per CTA

// the tiled kernel's tiling for inputs of type T and a padded head width
// DT: NI x NJ entries of S per compute thread, CB value columns per CTA,
// TT steps per tile, NH helper threads
template <typename T, int DT>
struct Tile {
  static constexpr int NI = DT <= 64 ? 4 : 8;
  static constexpr int NJ = 4;
  static constexpr int CB = 32;
  // 32 steps where shared memory allows (bf16, D <= 64): each tile has a
  // fixed cost in the pipeline besides its steps
  static constexpr int TT = sizeof(T) == 2 && DT <= 64 ? 32 : 16;
  static constexpr int NH = 256;
  static constexpr int STAGES = 3;  // raw tiles: in use, ready, in flight
  static constexpr int RG = DT / NI, JG = CB / NJ;
  static constexpr int NC = RG * JG;        // compute threads
  static constexpr int NT = NC + NH;        // threads
  static constexpr int CH = DT / 8;         // helpers per step (bonus)
  static constexpr int PSTRIDE = RG * CB + 16;  // partial o's per step
  // the helpers' outputs of a tile: v [TT][CB], bonus [TT]
  static constexpr int FSZ = TT * CB + TT;
  static_assert(NC % 32 == 0 && NH % 32 == 0 && CH * TT <= NH &&
                    (CH & (CH - 1)) == 0 && CH <= 32 && RG % 4 == 0 &&
                    FSZ % 4 == 0,
                "tiling");
};

// named barriers of the tiled kernel (0 is __syncthreads')
constexpr int BAR_FULL = 1;   // + b: converted tile in buffer b is ready
constexpr int BAR_PFULL = 3;  // + b: partial o's in buffer b are ready
constexpr int BAR_HELP = 5;   // the helper warps among themselves

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// up to 8 consecutive elements as float32, zero past the n valid ones:
// 16-byte loads where p is aligned and all 8 are valid
__device__ __forceinline__ void load8(const float* p, int n, float (&x)[8]) {
  if (n >= 8 && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) x[e] = e < n ? p[e] : 0.f;
  }
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, int n,
                                      float (&x)[8]) {
  if (n >= 8 && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    const unsigned m[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      x[2 * e] = __uint_as_float(m[e] << 16);
      x[2 * e + 1] = __uint_as_float(m[e] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) x[e] = e < n ? to_float(p[e]) : 0.f;
  }
}

__device__ __forceinline__ void store8(float* p, const float (&x)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(x[4], x[5], x[6], x[7]);
}

// Σ_e r[e]·u[e]·k[e] over 8 elements, accumulated into b
__device__ __forceinline__ float dot8(const float (&r)[8], const float (&u)[8],
                                      const float (&k)[8], float b) {
#pragma unroll
  for (int e = 0; e < 8; ++e) b = fmaf(r[e] * u[e], k[e], b);
  return b;
}

// sum over aligned groups of CH lanes (CH a power of two)
template <int CH>
__device__ __forceinline__ float group_sum(float b) {
#pragma unroll
  for (int m = CH / 2; m > 0; m >>= 1)
    b += __shfl_xor_sync(0xffffffffu, b, m);
  return b;
}

// N consecutive inputs of a raw tile row as float32 (N in 4, 8; p aligned
// to N elements)
template <int N>
__device__ __forceinline__ void lds_in(const float* p, float (&x)[N]) {
#pragma unroll
  for (int q = 0; q < N / 4; ++q) {
    const float4 a = reinterpret_cast<const float4*>(p)[q];
    x[4 * q] = a.x;
    x[4 * q + 1] = a.y;
    x[4 * q + 2] = a.z;
    x[4 * q + 3] = a.w;
  }
}
template <int N>
__device__ __forceinline__ void lds_in(const __nv_bfloat16* p,
                                       float (&x)[N]) {
#pragma unroll
  for (int q = 0; q < N / 4; ++q) {
    const uint2 a = reinterpret_cast<const uint2*>(p)[q];
    x[4 * q] = __uint_as_float(a.x << 16);
    x[4 * q + 1] = __uint_as_float(a.x & 0xffff0000u);
    x[4 * q + 2] = __uint_as_float(a.y << 16);
    x[4 * q + 3] = __uint_as_float(a.y & 0xffff0000u);
  }
}

// N consecutive floats of shared memory (N in 1, 2, 4, 8; p aligned to
// min(N, 4) floats)
template <int N>
__device__ __forceinline__ void lds(const float* p, float (&x)[N]) {
  if constexpr (N == 1) {
    x[0] = p[0];
  } else if constexpr (N == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    x[0] = a.x;
    x[1] = a.y;
  } else {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const float4 a = reinterpret_cast<const float4*>(p)[q];
      x[4 * q] = a.x;
      x[4 * q + 1] = a.y;
      x[4 * q + 2] = a.z;
      x[4 * q + 3] = a.w;
    }
  }
}
template <int N>
__device__ __forceinline__ void sts(float* p, const float (&x)[N]) {
  if constexpr (N == 1) {
    p[0] = x[0];
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else {
#pragma unroll
    for (int q = 0; q < N / 4; ++q)
      reinterpret_cast<float4*>(p)[q] =
          make_float4(x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]);
  }
}

// n contiguous elements from global src to shared dst (16-byte aligned):
// 16-byte cp.async where src is 16-byte aligned, element copies for the
// tail and for a misaligned src
template <typename T>
__device__ __forceinline__ void stage_copy(T* dst, const T* src, int n,
                                           int tid, int nthr) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int n16 = n * (int)sizeof(T) / 16;
    for (int c = tid; c < n16; c += nthr)
      cp_async16(reinterpret_cast<char*>(dst) + 16 * c,
                 reinterpret_cast<const char*>(src) + 16 * c);
    done = n16 * 16 / (int)sizeof(T);
  }
  for (int e = done + tid; e < n; e += nthr) dst[e] = src[e];
}

// bytes of dynamic shared memory of the tiled kernel
template <typename T, int DT>
struct TileSmem {
  using C = Tile<T, DT>;
  static constexpr size_t RAW =
      (size_t)C::STAGES * 4 * C::TT * DT * sizeof(T);
  static constexpr size_t FLOATS =
      2 * C::FSZ + 2 * C::TT * C::PSTRIDE + DT;
  static constexpr size_t BYTES = RAW + FLOATS * sizeof(float);
};

template <typename T, int DT>
__global__ void __launch_bounds__(Tile<T, DT>::NT)
wkv6_tile_kernel(const T* __restrict__ r, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ w,
                 const float* __restrict__ u, const float* s0,
                 float* __restrict__ o, float* s_out,
                 const uint8_t* __restrict__ commit, int n_heads,
                 int t_len, int d) {
  using C = Tile<T, DT>;
  constexpr int NI = C::NI, NJ = C::NJ, CB = C::CB, TT = C::TT;
  constexpr int STAGES = C::STAGES, RG = C::RG, JG = C::JG;
  constexpr int NC = C::NC, NH = C::NH, NT = C::NT;
  constexpr int CH = C::CH, PSTRIDE = C::PSTRIDE, FSZ = C::FSZ;
  extern __shared__ __align__(16) unsigned char smem[];
  // raw tiles: [STAGES][r, k, w, v][TT][DT], rows padded to DT with zeros
  T* raw = reinterpret_cast<T*>(smem);
  // per tile buffer b: v's columns of this block [TT][CB], bonus [TT]
  float* fbuf = reinterpret_cast<float*>(smem + TileSmem<T, DT>::RAW);
  float* part = fbuf + 2 * FSZ;                 // [2][TT][PSTRIDE]
  float* us = part + 2 * TT * PSTRIDE;          // [DT]

  const int bh = blockIdx.x;
  const int j0 = blockIdx.y * CB;
  const size_t base = (size_t)bh * t_len * d;
  const int ntiles = (t_len + TT - 1) / TT;
  auto tile = [&](int c) { return raw + (size_t)(c % STAGES) * 4 * TT * DT; };

  if (threadIdx.x < NC) {
    // compute warps: the steps of tile after tile, reading r, k, w straight
    // from the raw tiles; partial o's of this thread's rows to part
    const int tid = threadIdx.x;
    const int jg = tid % JG, rg = tid / JG;
    const int i0 = rg * NI, jl = jg * NJ;
    float S[NI][NJ];  // S[i0 + a][j0 + jl + b]
#pragma unroll
    for (int a = 0; a < NI; ++a)
#pragma unroll
      for (int b = 0; b < NJ; ++b) {
        const int i = i0 + a, j = j0 + jl + b;
        S[a][b] = (s0 != nullptr && i < d && j < d)
                      ? s0[(size_t)bh * d * d + (size_t)i * d + j]
                      : 0.f;
      }
    for (int c = 0; c < ntiles; ++c) {
      const int nt = min(TT, t_len - c * TT);
      const T* tr = tile(c) + i0;
      const T* tk = tr + TT * DT;
      const T* tw = tk + TT * DT;
      const float* fvc = fbuf + (c & 1) * FSZ + jl;
      float* pc = part + (c & 1) * TT * PSTRIDE + rg * CB + jl;
      bar_sync(BAR_FULL + (c & 1), NT);
      // the next step's inputs are loaded before this step's arithmetic
      float ra[NI], ka[NI], wa[NI], vb[NJ];
      lds_in<NI>(tr, ra);
      lds_in<NI>(tk, ka);
      lds_in<NI>(tw, wa);
      lds<NJ>(fvc, vb);
#pragma unroll 2
      for (int tt = 0; tt < nt; ++tt) {
        const int tn = min(tt + 1, TT - 1);
        float rn[NI], kn[NI], wn[NI], vn[NJ];
        lds_in<NI>(tr + tn * DT, rn);
        lds_in<NI>(tk + tn * DT, kn);
        lds_in<NI>(tw + tn * DT, wn);
        lds<NJ>(fvc + tn * CB, vn);
        float p[NJ];
#pragma unroll
        for (int b = 0; b < NJ; ++b) p[b] = 0.f;
#pragma unroll
        for (int a = 0; a < NI; ++a)
#pragma unroll
          for (int b = 0; b < NJ; ++b) {
            p[b] = fmaf(ra[a], S[a][b], p[b]);
            S[a][b] = fmaf(S[a][b], wa[a], ka[a] * vb[b]);
          }
        sts<NJ>(pc + tt * PSTRIDE, p);
#pragma unroll
        for (int a = 0; a < NI; ++a) {
          ra[a] = rn[a];
          ka[a] = kn[a];
          wa[a] = wn[a];
        }
#pragma unroll
        for (int b = 0; b < NJ; ++b) vb[b] = vn[b];
      }
      bar_arrive(BAR_PFULL + (c & 1), NT);
    }
    if (commit == nullptr || commit[bh / n_heads]) {
#pragma unroll
      for (int a = 0; a < NI; ++a)
#pragma unroll
        for (int b = 0; b < NJ; ++b) {
          const int i = i0 + a, j = j0 + jl + b;
          if (i < d && j < d)
            s_out[(size_t)bh * d * d + (size_t)i * d + j] = S[a][b];
        }
    }
    return;
  }

  // helper warps: copy the raw tiles in, prepare tile c + 2 (v's columns
  // and the bonus) while the compute warps run tile c + 1, and reduce
  // tile c's partial o's to o
  const int h = threadIdx.x - NC;

  // tile c's r, k, w, v rows into raw tile c % STAGES: one contiguous
  // copy of nt·d elements per input where d == DT, else row by row
  auto issue = [&](int c) {
    if (c < ntiles) {
      T* dst = tile(c);
      const size_t off = base + (size_t)c * TT * d;
      const int nt = min(TT, t_len - c * TT);
      const T* src[4] = {r + off, k + off, w + off, v + off};
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        if (d == DT) {
          stage_copy(dst + a * TT * DT, src[a], nt * d, h, NH);
        } else {
          for (int e = h; e < nt * d; e += NH)
            dst[a * TT * DT + (e / d) * DT + e % d] = src[a][e];
        }
      }
    }
    cp_async_commit();
  };

  // tile c's v columns of this block as float32, and each step's bonus
  // Σ_i r·u·k: helper (tt, chunk) takes 8 consecutive i of step tt, the
  // bonus reduced across the step's CH helpers
  auto prep = [&](int c) {
    const T* tr = tile(c);
    float* fvc = fbuf + (c & 1) * FSZ;
    float* bonus = fvc + TT * CB;
    const int nt = min(TT, t_len - c * TT);
    for (int e = 4 * h; e < TT * CB; e += 4 * NH) {  // four columns a helper
      const int tt = e / CB;
      float x[4] = {0.f, 0.f, 0.f, 0.f};  // the rows' padding past d is zero
      if (tt < nt) lds_in<4>(tr + 3 * TT * DT + tt * DT + j0 + e % CB, x);
      sts<4>(fvc + e, x);
    }
    if (h < CH * TT) {
      const int tt = h / CH, i8 = (h % CH) * 8;
      float rv[8], kv[8], uv[8];
      load8(tr + tt * DT + i8, 8, rv);
      load8(tr + TT * DT + tt * DT + i8, 8, kv);
      lds<8>(us + i8, uv);
      const float b = group_sum<CH>(dot8(rv, uv, kv, 0.f));
      if (h % CH == 0) bonus[tt] = b;
    }
  };

  // o of tile c: four consecutive outputs per helper and round, four
  // chains over the row groups' partials, stored 16 bytes at a time where
  // d % 4 == 0
  auto reduce = [&](int c) {
    const float* fvc = fbuf + (c & 1) * FSZ;
    const float* bonus = fvc + TT * CB;
    const float* pc = part + (c & 1) * TT * PSTRIDE;
    const int nt = min(TT, t_len - c * TT);
    for (int e = 4 * h; e < nt * CB; e += 4 * NH) {
      const int tt = e / CB, jj = e % CB, j = j0 + jj;
      const float* pp = pc + tt * PSTRIDE + jj;
      float y[4][4] = {};
#pragma unroll
      for (int g = 0; g < RG; ++g) {
        float x[4];
        lds<4>(pp + g * CB, x);
#pragma unroll
        for (int b = 0; b < 4; ++b) y[g % 4][b] += x[b];
      }
      float vv[4], out[4];
      lds<4>(fvc + e, vv);
#pragma unroll
      for (int b = 0; b < 4; ++b)
        out[b] = fmaf(bonus[tt], vv[b],
                      (y[0][b] + y[1][b]) + (y[2][b] + y[3][b]));
      float* dst = o + base + (size_t)(c * TT + tt) * d + j;
      if ((d & 3) == 0 && j + 4 <= d) {
        sts<4>(dst, out);
      } else {
#pragma unroll
        for (int b = 0; b < 4; ++b)
          if (j + b < d) dst[b] = out[b];
      }
    }
  };

  // the raw rows' padding past d is zero for the whole run
  if (d < DT)
    for (int e = h; e < STAGES * 4 * TT * DT; e += NH)
      if (e % DT >= d) raw[e] = T(0.f);
  for (int i = h; i < DT; i += NH)
    us[i] = i < d ? u[(size_t)(bh % n_heads) * d + i] : 0.f;
  for (int c = 0; c < STAGES; ++c) issue(c);
  cp_async_wait<STAGES - 1>();
  bar_sync(BAR_HELP, NH);  // every helper's copies of tile 0, us, padding
  prep(0);
  bar_arrive(BAR_FULL, NT);
  if (ntiles > 1) {
    cp_async_wait<STAGES - 2>();
    bar_sync(BAR_HELP, NH);
    prep(1);
    bar_arrive(BAR_FULL + 1, NT);
  }
  for (int c = 0; c < ntiles; ++c) {
    bar_sync(BAR_PFULL + (c & 1), NT);  // the compute warps are past tile c
    reduce(c);
    issue(c + STAGES);  // into raw tile c's buffer
    if (c + 2 < ntiles) {
      cp_async_wait<STAGES - 2>();
      bar_sync(BAR_HELP, NH);  // tile c + 2's copies; reduce(c) done
      prep(c + 2);
      bar_arrive(BAR_FULL + (c & 1), NT);
    }
  }
}

template <typename T, int DT>
__global__ void __launch_bounds__(2 * DT)
wkv6_short_kernel(const T* __restrict__ r, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ w,
                  const float* __restrict__ u, const float* s0,
                  float* __restrict__ o, float* s_out,
                  const uint8_t* __restrict__ commit, int n_heads,
                  int t_len, int d) {
  constexpr int RG = DT / SNI;
  constexpr int NT = RG * SJG;  // threads: 2·DT
  constexpr int CH = DT / 8;    // 8-element chunks per step
  static_assert(NT / CH >= SHORT_T, "a chunk per thread stages every step");
  __shared__ __align__(16) float fr[SHORT_T][DT];
  __shared__ __align__(16) float fk[SHORT_T][DT];
  __shared__ __align__(16) float fw[SHORT_T][DT];
  __shared__ __align__(16) float fv[SHORT_T][SCB];
  __shared__ __align__(16) float part[2][RG][SCB];
  __shared__ float bonus[SHORT_T];

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int j0 = blockIdx.y * SCB;
  const int jg = tid % SJG, rg = tid / SJG;
  const int i0 = rg * SNI, jc = j0 + jg * SNJ;
  const size_t base = (size_t)bh * t_len * d;
  const size_t sbase = (size_t)bh * d * d;
  // 16-byte state rows: d % 4 == 0 keeps every row's columns aligned
  const bool vec = (d & 3) == 0 && jc + SNJ <= d;

  float S[SNI][SNJ];  // S[i0 + a][jc + b]; loads issued first
#pragma unroll
  for (int a = 0; a < SNI; ++a) {
    const int i = i0 + a;
    const float* src = s0 + sbase + (size_t)i * d + jc;
    if (s0 != nullptr && i < d && vec) {
      const float4 x = *reinterpret_cast<const float4*>(src);
      S[a][0] = x.x;
      S[a][1] = x.y;
      S[a][2] = x.z;
      S[a][3] = x.w;
    } else {
#pragma unroll
      for (int b = 0; b < SNJ; ++b)
        S[a][b] = (s0 != nullptr && i < d && jc + b < d) ? src[b] : 0.f;
    }
  }

  // stage every step: thread (t, chunk) converts 8 consecutive i of step
  // t, and the bonus is reduced across the step's CH lanes
  {
    const int t = tid / CH, i8 = (tid % CH) * 8;
    const int n = t < t_len ? d - i8 : 0;
    const size_t row = base + (size_t)min(t, t_len - 1) * d + i8;
    float rv[8], kv[8], wv[8], uv[8];
    load8(r + row, n, rv);
    load8(k + row, n, kv);
    load8(w + row, n, wv);
    load8(u + (size_t)(bh % n_heads) * d + i8, d - i8, uv);
    const float b = group_sum<CH>(dot8(rv, uv, kv, 0.f));
    if (t < SHORT_T) {
      store8(&fr[t][i8], rv);
      store8(&fk[t][i8], kv);
      store8(&fw[t][i8], wv);
      if (tid % CH == 0) bonus[t] = b;
    }
    for (int e = tid; e < t_len * SCB; e += NT) {
      const int t2 = e / SCB, j = j0 + e % SCB;
      fv[t2][e % SCB] = j < d ? to_float(v[base + (size_t)t2 * d + j]) : 0.f;
    }
  }
  __syncthreads();

  for (int t = 0; t < t_len; ++t) {
    const float4 rr = *reinterpret_cast<const float4*>(&fr[t][i0]);
    const float4 kk = *reinterpret_cast<const float4*>(&fk[t][i0]);
    const float4 ww = *reinterpret_cast<const float4*>(&fw[t][i0]);
    const float4 vv = *reinterpret_cast<const float4*>(&fv[t][jg * SNJ]);
    const float ra[SNI] = {rr.x, rr.y, rr.z, rr.w};
    const float ka[SNI] = {kk.x, kk.y, kk.z, kk.w};
    const float wa[SNI] = {ww.x, ww.y, ww.z, ww.w};
    const float vb[SNJ] = {vv.x, vv.y, vv.z, vv.w};
    float p[SNJ] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int a = 0; a < SNI; ++a)
#pragma unroll
      for (int b = 0; b < SNJ; ++b) {
        p[b] = fmaf(ra[a], S[a][b], p[b]);
        S[a][b] = fmaf(S[a][b], wa[a], ka[a] * vb[b]);
      }
    *reinterpret_cast<float4*>(&part[t & 1][rg][jg * SNJ]) =
        make_float4(p[0], p[1], p[2], p[3]);
    __syncthreads();
    if (tid < SCB && j0 + tid < d) {
      float y[4] = {0.f, 0.f, 0.f, 0.f};  // four chains over the groups
#pragma unroll
      for (int g = 0; g < RG; ++g) y[g % 4] += part[t & 1][g][tid];
      o[base + (size_t)t * d + j0 + tid] =
          fmaf(bonus[t], fv[t][tid], (y[0] + y[1]) + (y[2] + y[3]));
    }
  }

  if (commit == nullptr || commit[bh / n_heads]) {
#pragma unroll
    for (int a = 0; a < SNI; ++a) {
      const int i = i0 + a;
      if (i >= d) continue;
      float* dst = s_out + sbase + (size_t)i * d + jc;
      if (vec) {
        *reinterpret_cast<float4*>(dst) =
            make_float4(S[a][0], S[a][1], S[a][2], S[a][3]);
      } else {
#pragma unroll
        for (int b = 0; b < SNJ; ++b)
          if (jc + b < d) dst[b] = S[a][b];
      }
    }
  }
}

template <typename T, int DT>
int launch_dt(const void* r, const void* k, const void* v, const void* w,
              const float* u, const float* s0, float* o, float* s_out,
              const uint8_t* commit, int bh, int n_heads, int t_len, int d,
              cudaStream_t stream) {
  if (t_len <= SHORT_T) {
    const dim3 grid(bh, (d + SCB - 1) / SCB);
    wkv6_short_kernel<T, DT><<<grid, 2 * DT, 0, stream>>>(
        (const T*)r, (const T*)k, (const T*)v, (const T*)w, u, s0, o,
        s_out, commit, n_heads, t_len, d);
    return (int)cudaGetLastError();
  }
  constexpr size_t smem = TileSmem<T, DT>::BYTES;
  static bool attr_set[64] = {};  // once per instantiation and device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!attr_set[dev]) {
    e = cudaFuncSetAttribute(wkv6_tile_kernel<T, DT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    attr_set[dev] = true;
  }
  using C = Tile<T, DT>;
  const dim3 grid(bh, (d + C::CB - 1) / C::CB);
  wkv6_tile_kernel<T, DT><<<grid, C::NT, smem, stream>>>(
      (const T*)r, (const T*)k, (const T*)v, (const T*)w, u, s0, o, s_out,
      commit, n_heads, t_len, d);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* w,
           const float* u, const float* s0, float* o, float* s_out,
           const uint8_t* commit, int bh, int n_heads, int t_len, int d,
           cudaStream_t stream) {
  if (d <= 32)
    return launch_dt<T, 32>(r, k, v, w, u, s0, o, s_out, commit, bh,
                            n_heads, t_len, d, stream);
  if (d <= 64)
    return launch_dt<T, 64>(r, k, v, w, u, s0, o, s_out, commit, bh,
                            n_heads, t_len, d, stream);
  return launch_dt<T, 128>(r, k, v, w, u, s0, o, s_out, commit, bh,
                           n_heads, t_len, d, stream);
}

}  // namespace

// r, k, v, w [bh, t, d] (float32: dtype 0, bfloat16: dtype 1), u [H, d]
// float32 (row bh uses u[bh % H]), s0 [bh, d, d] float32 or null (zeros);
// o [bh, t, d] and s_out [bh, d, d] float32, s_out may be s0; commit
// [bh / H] bool (one byte each) or null (every row). All contiguous on
// the device; 1 <= d <= 128, t >= 1, bh % n_heads == 0. The final state
// of row bh goes to s_out[bh] iff commit[bh / H] (or no mask); the other
// rows of s_out are not written. Launches on `stream`; returns
// cudaGetLastError() (0 = launched). Allocates nothing.
extern "C" int wkv6_launch(const void* r, const void* k, const void* v,
                           const void* w, const void* u, const void* s0,
                           void* o, void* s_out, const void* commit, int bh,
                           int n_heads, int t_len, int d, int dtype,
                           void* stream) {
  if (bh <= 0 || t_len <= 0 || d < 1 || d > MAX_D || n_heads <= 0 ||
      bh % n_heads)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const float* uf = (const float*)u;
  const float* sf = (const float*)s0;
  const uint8_t* cm = (const uint8_t*)commit;
  if (dtype == 0)
    return launch<float>(r, k, v, w, uf, sf, (float*)o, (float*)s_out, cm,
                         bh, n_heads, t_len, d, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(r, k, v, w, uf, sf, (float*)o,
                                 (float*)s_out, cm, bh, n_heads, t_len, d,
                                 st);
  return (int)cudaErrorInvalidValue;
}
