// Fused attention (flash attention, forward) — Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash/flash.py
// (flash_attention_pallas :105, pallas_call at :127; _kernel :38).
//
// Computes, for q [B·H, T, D] and k, v [B·Hkv, S, D] (float32 or bfloat16,
// one dtype) with query row t at absolute position t + (S − T) (ends
// aligned, chunked-prefill semantics), kv head (bh % H) / (H / Hkv) of
// batch bh / H (GQA), and key j valid iff
//   (!causal || j <= pos) && (window < 1 || j > pos − window):
//   o[bh, t] = Σ_j softmax_j(scale · q[bh, t] · k[kv, j]) · v[kv, j]
// in float32, rounded to q's dtype once at the end. The softmax is the
// online one of the TPU kernel: a running max m, sum l and accumulator
// acc per row, rescaled by exp(m_old − m_new) as each key tile arrives.
// Masked scores are −inf; a row whose keys so far are all masked keeps
// m = −inf and is left untouched by the tile (the guard the TPU kernel's
// finite −1e30 sentinel makes unnecessary there); a row that never sees a
// valid key (only possible for T > S under a mask, which the entry point
// refuses) comes out as zeros, as the TPU kernel's l == 0 -> 1 rule gives.
// Any T and S >= 1, T > S without a causal mask or a window only (the
// encoder-decoder's cross-attention): there pos = t + S − T is negative
// for the first rows, but no mask reads it — k_begin is 0 and k_end is S,
// and the tile-skip test masks only the ragged last tile. Ragged q and kv
// tiles are masked, not padded in memory.
//
// What bounds it on this card: operations. At smollm-360m's prefill
// (H 15, Hkv 5, D 64, T = S = 2048, causal, bf16) the two products are
// 4·H·T·S·D / 2 = 8.1 GFLOP, 8.1 us at the tensor cores' 989 TFLOP/s,
// against 10.5 MB of q, k, v and o (3.1 us at 3.35 TB/s).
//
// Two kernels, chosen by dtype in flash_attention_launch (the binding's
// one entry point):
//
// bfloat16 — on the tensor cores (flash_tc_kernel). One CTA of 4 warps
// per (query tile of 64 rows, bh), each warp 16 rows; the CTAs run in any
// order, the heaviest (last, under a causal mask) q tiles first. The q
// tile and two buffers of k and v tiles of 64 keys sit in shared memory
// as bf16, rows padded by 16 bytes so the 8 rows of an ldmatrix hit
// distinct banks; head dims are padded with zeros in shared memory (never
// in device memory) to DP = 32, 64 or 128 (danube's D = 120 runs at 128).
// cp.async fills the next k/v tile while the current one is consumed
// (16-byte copies when D % 8 == 0 and the tensors are 16-byte aligned,
// element loads otherwise). The loop over kv tiles runs from the first
// tile the window can reach to the last the causal mask allows — the
// tile-skip test of flash.py:54-66 as loop bounds; only tiles that cross
// a mask edge or the end of the keys test each score. Per tile and warp:
//   S = q·kᵀ — mma.sync.m16n8k16 bf16 with float32 accumulation, q's
//   fragments held in registers for the whole loop (ldmatrix once), k's
//   loaded with ldmatrix; the bf16 products are exact, so S differs from
//   the plain version's float32 sums only in the order of the adds;
//   the online softmax on the accumulator fragments (each thread holds 2
//   rows × 16 scores; row max and sum over the 4 threads of a quad by
//   shuffles), in base 2 with log2(e) folded into the scale, applied in
//   the subtraction's fma, and the hardware's ex2.approx;
//   O += P·V — P from the score fragments (the accumulator layout of two
//   n8 tiles is the A layout of one k16 step), V by ldmatrix.trans. P is
//   split into p_hi = bf16(p) and p_lo = bf16(p − p_hi), two products into
//   one float32 accumulator: rounding P to bf16 alone costs 2^-9 of each
//   weight, which the bf16 tolerance (atol 2e-3, rtol 1e-2) does not
//   leave room for on peaked softmaxes (PERF.md); the split leaves 2^-17.
// Shared memory: 2·(64 + 4·64)·(DP + 8) bytes, 46,080 at D = 64 and
// 87,040 at D = 128 (opted in above 48 KB).
//
// float32 — on the CUDA cores (flash_fwd_kernel): TF32 would not meet the
// float32 tolerance of the checked serving runs. One CTA of 8 warps per
// (query tile of 64 rows, bh), in the same order and with the same loop
// bounds. Each tile of k and v is staged in shared memory as float32; the
// q tile stays in shared memory for the whole loop. Rows are padded to D4
// = D rounded up to 4 floats (zeros), so the products read q and k as
// float4; k rows get a further pad that makes their stride an odd number
// of float4s, so the eight lanes of each 128-byte phase of a float4 load
// hit distinct banks. A warp owns 8 query rows and works on all 8 at once
// (register blocking): lane l computes the scores of keys l and l + 32 for
// the 8 rows, each float4 of k loaded once for 8 rows and each float4 of q
// broadcast to the warp; the warp reduces each row's max and sum with
// shuffles; in the p·v product each key's v values are loaded once for
// the 8 rows and its 8 p values broadcast with shuffles, while lane l
// accumulates output columns l, l + 32, l + 64, l + 96 (D <= 128; columns
// >= D idle). m, l and acc of the 8 rows live in registers in float32.
// No fast math. Shared memory is 4·64·(2·D4 + kstride) bytes: 50,176 at
// D = 64, 99,328 at D = 128 (dynamic, opted in above 48 KB).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int BQ = 64;                 // query rows per CTA
constexpr int BK = 64;                 // keys per staged tile
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int RPW = BQ / WARPS;        // query rows per warp
constexpr int MAX_D = 128;
constexpr int NC = MAX_D / 32;         // output columns per lane
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

__host__ __device__ __forceinline__ int pad4(int d) { return (d + 3) & ~3; }

// k row stride in floats: D4 plus a pad that makes it an odd number of
// float4s (conflict-free float4 loads by 8 lanes of consecutive rows)
__host__ __device__ __forceinline__ int k_stride(int d) {
  const int d4 = pad4(d);
  return d4 + ((d4 / 4) % 2 == 0 ? 4 : 8);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int bh_total,
                 int n_heads, int n_kv_heads, int t_len, int s_len, int d,
                 int causal, int window, float scale, int n_qtiles) {
  extern __shared__ __align__(16) float smem[];
  const int d4 = pad4(d), kst = k_stride(d);
  float* qs = smem;                    // [BQ][d4]
  float* ks = qs + BQ * d4;            // [BK][kst]
  float* vs = ks + BK * kst;           // [BK][d4]

  const int bh = blockIdx.x % bh_total;
  const int qt = n_qtiles - 1 - blockIdx.x / bh_total;  // heavy tiles first
  const int q0 = qt * BQ;
  const int nrows = min(BQ, t_len - q0);
  const int group = n_heads / n_kv_heads;
  const int kvh = (bh / n_heads) * n_kv_heads + (bh % n_heads) / group;
  const int off = s_len - t_len;       // query row t sits at t + off
  const T* qb = q + ((size_t)bh * t_len + q0) * d;
  const T* kb = k + (size_t)kvh * s_len * d;
  const T* vb = v + (size_t)kvh * s_len * d;
  T* ob = o + ((size_t)bh * t_len + q0) * d;

  for (int i = threadIdx.x; i < BQ * d4; i += THREADS) {
    const int r = i / d4, c = i - r * d4;
    qs[i] = r < nrows && c < d ? to_float(qb[(size_t)r * d + c]) : 0.f;
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * RPW;           // the warp's first row in the tile
  float m[RPW], l[RPW], acc[RPW][NC];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }

  // the tile-skip test as loop bounds: keys below the window of the
  // tile's first row, or past the causal limit of its last row, are
  // never read
  const int pos_first = q0 + off, pos_last = q0 + nrows - 1 + off;
  const int k_end = causal ? min(s_len, pos_last + 1) : s_len;
  int k_begin = window > 0 ? max(0, pos_first - window + 1) : 0;
  k_begin -= k_begin % BK;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    const int nk = min(BK, s_len - k0);
    __syncthreads();  // the previous tile is consumed (q staged, at first)
    for (int i = threadIdx.x; i < BK * d4; i += THREADS) {
      const int r = i / d4, c = i - r * d4;
      float kx = 0.f, vx = 0.f;
      if (r < nk && c < d) {
        const size_t g = (size_t)(k0 + r) * d + c;
        kx = to_float(kb[g]);
        vx = to_float(vb[g]);
      }
      ks[r * kst + c] = kx;
      vs[i] = vx;
    }
    __syncthreads();

    // scores of keys lane and lane + 32 for the warp's 8 rows
    float s0[RPW], s1[RPW];
#pragma unroll
    for (int r = 0; r < RPW; ++r) s0[r] = s1[r] = 0.f;
    const float* k0r = ks + lane * kst;
    const float* k1r = ks + (lane + 32) * kst;
    for (int c = 0; c < d4; c += 4) {
      const float4 ka = *reinterpret_cast<const float4*>(k0r + c);
      const float4 kc = *reinterpret_cast<const float4*>(k1r + c);
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const float4 qv =
            *reinterpret_cast<const float4*>(qs + (r0 + r) * d4 + c);
        s0[r] = fmaf(qv.x, ka.x, s0[r]);
        s0[r] = fmaf(qv.y, ka.y, s0[r]);
        s0[r] = fmaf(qv.z, ka.z, s0[r]);
        s0[r] = fmaf(qv.w, ka.w, s0[r]);
        s1[r] = fmaf(qv.x, kc.x, s1[r]);
        s1[r] = fmaf(qv.y, kc.y, s1[r]);
        s1[r] = fmaf(qv.z, kc.z, s1[r]);
        s1[r] = fmaf(qv.w, kc.w, s1[r]);
      }
    }

    // online softmax per row; a row past the tile's end, or with no
    // valid key yet, gets p = 0 and keeps m, l and acc (corr = 1)
    const int j0 = k0 + lane, j1 = k0 + lane + 32;
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int pos = q0 + r0 + r + off;
      const bool ok0 = r0 + r < nrows && j0 < s_len &&
                       (!causal || j0 <= pos) &&
                       (window < 1 || j0 > pos - window);
      const bool ok1 = r0 + r < nrows && j1 < s_len &&
                       (!causal || j1 <= pos) &&
                       (window < 1 || j1 > pos - window);
      const float a0 = ok0 ? s0[r] * scale : -INFINITY;
      const float a1 = ok1 ? s1[r] * scale : -INFINITY;
      const float m_new = fmaxf(m[r], warp_max(fmaxf(a0, a1)));
      if (m_new == -INFINITY) {  // warp-uniform: nothing valid yet
        s0[r] = s1[r] = 0.f;
        continue;
      }
      const float corr = expf(m[r] - m_new);  // exp(-inf) = 0 at first
      s0[r] = expf(a0 - m_new);               // the p values, in place
      s1[r] = expf(a1 - m_new);
      l[r] = l[r] * corr + warp_sum(s0[r] + s1[r]);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] *= corr;
    }

    // p·v: each key's v values loaded once for the 8 rows
    for (int j = 0; j < nk; ++j) {
      float vj[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = lane + 32 * c;
        vj[c] = col < d ? vs[j * d4 + col] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const float pj = __shfl_sync(FULL, j < 32 ? s0[r] : s1[r], j & 31);
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[r][c] = fmaf(pj, vj[c], acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    if (r0 + r >= nrows) continue;
    const float denom = l[r] == 0.f ? 1.f : l[r];  // never-valid rows: 0
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = lane + 32 * c;
      if (col < d) store(ob + (size_t)(r0 + r) * d + col, acc[r][c] / denom);
    }
  }
}

// ------------------------------------------------ bf16: the tensor cores
namespace tc {

constexpr int BQ = 64;                 // query rows per CTA: 4 warps x 16
constexpr int BK = 64;                 // keys per tile
constexpr int THREADS = 4 * 32;
constexpr int PAD = 8;                 // bf16 of row padding (16 bytes)
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// d += a·b: one m16n8k16 product, bf16 inputs, float32 accumulators
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes from global to shared, zero-filled past `bytes` (0 or 16)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// 2^x, the hardware approximation (relative error ~2^-22; exp2(−inf) = 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bits_of(__nv_bfloat162 v) {
  uint32_t u;
  memcpy(&u, &v, sizeof(u));
  return u;
}

// two probabilities as bf16 pairs (a in the low half): hi = bf16(p),
// lo = bf16(p − hi)
__device__ __forceinline__ void split(float a, float b, uint32_t& hi,
                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 back = __bfloat1622float2(h);
  hi = bits_of(h);
  lo = bits_of(__floats2bfloat162_rn(a - back.x, b - back.y));
}

// A tile of 64 rows x DP columns, row r from src + r·d: columns >= d
// and rows >= valid read zeros. async: 16-byte cp.async (d % 8 == 0,
// 16-byte aligned src); else element by element.
template <int DP>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          int valid, int d, bool async) {
  constexpr int CH = DP / 8;  // 16-byte chunks per row
  for (int e = threadIdx.x; e < BQ * CH; e += THREADS) {
    const int r = e / CH, col = (e - r * CH) * 8;
    __nv_bfloat16* to = dst + r * (DP + PAD) + col;
    const bool in = r < valid && col < d;
    if (async) {
      cp_async16(to, in ? src + (size_t)r * d + col : src, in ? 16 : 0);
    } else {
#pragma unroll
      for (int x = 0; x < 8; ++x)
        to[x] = in && col + x < d ? src[(size_t)r * d + col + x]
                                  : __float2bfloat16_rn(0.f);
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(THREADS)
flash_tc_kernel(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                __nv_bfloat16* __restrict__ o, int bh_total, int n_heads,
                int n_kv_heads, int t_len, int s_len, int d, int causal,
                int window, float scale_log2, int n_qtiles, int async) {
  constexpr int LD = DP + PAD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BQ][LD]
  __nv_bfloat16* ks = qs + BQ * LD;                  // [2][BK][LD]
  __nv_bfloat16* vs = ks + 2 * BK * LD;              // [2][BK][LD]

  const int bh = blockIdx.x % bh_total;
  const int qt = n_qtiles - 1 - blockIdx.x / bh_total;  // heavy tiles first
  const int q0 = qt * BQ;
  const int nrows = min(BQ, t_len - q0);
  const int group = n_heads / n_kv_heads;
  const int kvh = (bh / n_heads) * n_kv_heads + (bh % n_heads) / group;
  const int off = s_len - t_len;       // query row t sits at t + off
  const __nv_bfloat16* qb = q + ((size_t)bh * t_len + q0) * d;
  const __nv_bfloat16* kb = k + (size_t)kvh * s_len * d;
  const __nv_bfloat16* vb = v + (size_t)kvh * s_len * d;
  __nv_bfloat16* ob = o + ((size_t)bh * t_len + q0) * d;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;  // fragment row, column pair
  const int w0 = warp * 16;                // the warp's first row

  // the tile-skip test as loop bounds
  const int pos_first = q0 + off, pos_last = q0 + nrows - 1 + off;
  const int k_end = causal ? min(s_len, pos_last + 1) : s_len;
  int k_begin = window > 0 ? max(0, pos_first - window + 1) : 0;
  k_begin -= k_begin % BK;

  load_tile<DP>(qs, qb, nrows, d, async);
  load_tile<DP>(ks, kb + (size_t)k_begin * d, s_len - k_begin, d, async);
  load_tile<DP>(vs, vb + (size_t)k_begin * d, s_len - k_begin, d, async);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  uint32_t qf[DP / 16][4];  // the warp's 16 q rows as A fragments
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
    ldmatrix_x4(qf[kk], smem_addr(qs + (w0 + (lane & 7) +
                                        ((lane >> 3) & 1) * 8) * LD +
                                  kk * 16 + (lane >> 4) * 8));

  float acc[DP / 8][4];
#pragma unroll
  for (int dt = 0; dt < DP / 8; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const int pos[2] = {q0 + w0 + g + off, q0 + w0 + g + 8 + off};
  // the warp's real rows' positions, for the mask-free tile test
  const int wpos_first = q0 + w0 + off;
  const int wpos_last = q0 + min(w0 + 15, nrows - 1) + off;

  int buf = 0;
  for (int k0 = k_begin; k0 < k_end; k0 += BK, buf ^= 1) {
    if (k0 + BK < k_end) {  // prefetch the next tile into the other buffer
      const size_t nxt = (size_t)(k0 + BK) * d;
      load_tile<DP>(ks + (buf ^ 1) * BK * LD, kb + nxt, s_len - k0 - BK, d,
                    async);
      load_tile<DP>(vs + (buf ^ 1) * BK * LD, vb + nxt, s_len - k0 - BK, d,
                    async);
    }
    cp_async_commit();
    const __nv_bfloat16* kt = ks + buf * BK * LD;
    const __nv_bfloat16* vt = vs + buf * BK * LD;

    // S = q·kᵀ: 16 rows x 64 keys a warp, 8 n8 tiles
    float sc[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
      sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
#pragma unroll
      for (int nt = 0; nt < BK / 8; nt += 2) {
        uint32_t b[4];
        ldmatrix_x4(b, smem_addr(kt + (nt * 8 + (lane & 7) +
                                       (lane >> 4) * 8) * LD +
                                 kk * 16 + ((lane >> 3) & 1) * 8));
        mma(sc[nt], qf[kk], b[0], b[1]);
        mma(sc[nt + 1], qf[kk], b[2], b[3]);
      }
    }

    // mask: only a tile crossing a mask edge or the end of the keys tests
    // each score
    if (!(k0 + BK <= s_len && (!causal || k0 + BK - 1 <= wpos_first) &&
          (window < 1 || k0 > wpos_last - window))) {
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = k0 + nt * 8 + 2 * t4 + (e & 1), p = pos[e >> 1];
          const bool ok = j < s_len && (!causal || j <= p) &&
                          (window < 1 || j > p - window);
          if (!ok) sc[nt][e] = -INFINITY;
        }
      }
    }

    // online softmax on the fragments: rows g (e = 0, 1) and g + 8 (2, 3),
    // in base 2 — m is the running max of the scaled scores, and the scale
    // is applied with the subtraction (the max commutes with it, scale > 0)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      mx[0] = fmaxf(mx[0], fmaxf(sc[nt][0], sc[nt][1]));
      mx[1] = fmaxf(mx[1], fmaxf(sc[nt][2], sc[nt][3]));
    }
    float sum[2] = {0.f, 0.f}, use[2], corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 2));
      mx[r] = fmaxf(m[r], mx[r] * scale_log2);
      // a row with nothing valid yet: p = exp2(−inf) = 0, and its l and
      // acc are 0, so the correction (0) changes nothing
      use[r] = mx[r] == -INFINITY ? 0.f : mx[r];
      corr[r] = exp2_approx(m[r] - use[r]);
      m[r] = mx[r];
    }
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[nt][e] = exp2_approx(fmaf(sc[nt][e], scale_log2, -use[e >> 1]));
        sum[e >> 1] += sc[nt][e];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(FULL, sum[r], 1);
      sum[r] += __shfl_xor_sync(FULL, sum[r], 2);
      l[r] = l[r] * corr[r] + sum[r];
    }
#pragma unroll
    for (int dt = 0; dt < DP / 8; ++dt) {
      acc[dt][0] *= corr[0];
      acc[dt][1] *= corr[0];
      acc[dt][2] *= corr[1];
      acc[dt][3] *= corr[1];
    }

    // O += P·V, 16 keys a step; P's fragments are the scores' own
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t ph[4], pl[4];
      split(sc[2 * kk][0], sc[2 * kk][1], ph[0], pl[0]);
      split(sc[2 * kk][2], sc[2 * kk][3], ph[1], pl[1]);
      split(sc[2 * kk + 1][0], sc[2 * kk + 1][1], ph[2], pl[2]);
      split(sc[2 * kk + 1][2], sc[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int dt = 0; dt < DP / 8; dt += 2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, smem_addr(vt + (kk * 16 + (lane & 7) +
                                             ((lane >> 3) & 1) * 8) * LD +
                                       dt * 8 + (lane >> 4) * 8));
        mma(acc[dt], ph, b[0], b[1]);
        mma(acc[dt + 1], ph, b[2], b[3]);
        mma(acc[dt], pl, b[0], b[1]);
        mma(acc[dt + 1], pl, b[2], b[3]);
      }
    }
    cp_async_wait_all();  // the next tile has landed, and every warp is
    __syncthreads();      // done with this one before it is refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = w0 + g + 8 * r;
    if (row >= nrows) continue;
    const float denom = l[r] == 0.f ? 1.f : l[r];  // never-valid rows: 0
    __nv_bfloat16* orow = ob + (size_t)row * d;
#pragma unroll
    for (int dt = 0; dt < DP / 8; ++dt) {
      const int col = dt * 8 + 2 * t4;
      if (col < d) orow[col] = __float2bfloat16(acc[dt][2 * r] / denom);
      if (col + 1 < d)
        orow[col + 1] = __float2bfloat16(acc[dt][2 * r + 1] / denom);
    }
  }
}

template <int DP>
int launch_dp(const void* q, const void* k, const void* v, void* o, int bh,
              int n_heads, int n_kv_heads, int t_len, int s_len, int d,
              int causal, int window, float scale, int async,
              cudaStream_t stream) {
  const int n_qtiles = (t_len + BQ - 1) / BQ;
  const size_t smem = sizeof(__nv_bfloat16) * (BQ + 4 * BK) * (DP + PAD);
  if ((long long)bh * n_qtiles > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_tc_kernel<DP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  flash_tc_kernel<DP><<<bh * n_qtiles, THREADS, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)o, bh, n_heads, n_kv_heads,
      t_len, s_len, d, causal, window, scale * LOG2E, n_qtiles, async);
  return (int)cudaGetLastError();
}

int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int n_heads, int n_kv_heads, int t_len, int s_len, int d,
           int causal, int window, float scale, cudaStream_t stream) {
  const int async = d % 8 == 0 && (uintptr_t)q % 16 == 0 &&
                    (uintptr_t)k % 16 == 0 && (uintptr_t)v % 16 == 0;
  if (d <= 32)
    return launch_dp<32>(q, k, v, o, bh, n_heads, n_kv_heads, t_len, s_len,
                         d, causal, window, scale, async, stream);
  if (d <= 64)
    return launch_dp<64>(q, k, v, o, bh, n_heads, n_kv_heads, t_len, s_len,
                         d, causal, window, scale, async, stream);
  return launch_dp<128>(q, k, v, o, bh, n_heads, n_kv_heads, t_len, s_len,
                        d, causal, window, scale, async, stream);
}

}  // namespace tc

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int n_heads, int n_kv_heads, int t_len, int s_len, int d,
           int causal, int window, float scale, cudaStream_t stream) {
  const int n_qtiles = (t_len + BQ - 1) / BQ;
  const size_t smem = sizeof(float) * ((size_t)BQ * pad4(d)
                                       + (size_t)BK * k_stride(d)
                                       + (size_t)BK * pad4(d));
  if ((long long)bh * n_qtiles > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  flash_fwd_kernel<T><<<bh * n_qtiles, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, bh, n_heads, n_kv_heads,
      t_len, s_len, d, causal, window, scale, n_qtiles);
  return (int)cudaGetLastError();
}

}  // namespace

// q [bh, t, d], k and v [bh / n_heads · n_kv_heads, s, d], o [bh, t, d]:
// contiguous on the device, float32 (dtype 0: the CUDA-core kernel) or
// bfloat16 (dtype 1: the tensor-core kernel); 1 <= d <= 128, s >= 1,
// t <= s unless the call is unmasked (causal 0, window < 1),
// n_heads % n_kv_heads == 0, bh % n_heads == 0; window < 1 = none.
// Launches on `stream`; returns cudaGetLastError() (0 = launched).
// Allocates nothing.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int bh,
                                      int n_heads, int n_kv_heads, int t_len,
                                      int s_len, int d, int causal,
                                      int window, float scale, int dtype,
                                      void* stream) {
  if (bh <= 0 || t_len <= 0 || s_len <= 0 || d < 1 || d > MAX_D ||
      (t_len > s_len && (causal || window > 0)) ||
      n_heads <= 0 || n_kv_heads <= 0 || n_heads % n_kv_heads ||
      bh % n_heads)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(q, k, v, o, bh, n_heads, n_kv_heads, t_len, s_len,
                         d, causal, window, scale, st);
  if (dtype == 1)
    return tc::launch(q, k, v, o, bh, n_heads, n_kv_heads, t_len, s_len, d,
                      causal, window, scale, st);
  return (int)cudaErrorInvalidValue;
}
