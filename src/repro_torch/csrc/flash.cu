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
// valid key (only possible for T > S, which the binding refuses) comes
// out as zeros, as the TPU kernel's l == 0 -> 1 rule gives. Any T <= S
// and any S: ragged q and kv tiles are masked, not padded in memory.
//
// What bounds it on this card: operations. At smollm-360m's prefill
// (H 15, Hkv 5, D 64, T = S = 2048, causal, bf16) the two products are
// 4·H·T·S·D / 2 = 8.1 GFLOP, 8.1 us at the tensor cores' 989 TFLOP/s,
// against 10.5 MB of q, k, v and o (3.1 us at 3.35 TB/s). This first
// kernel computes both products on the CUDA cores in float32 (67 TFLOP/s
// at most, so >= 120 us) with shared-memory operands: it is right and
// simple, and far from the bound (PERF.md records the gap). Tensor cores
// (mma.sync / wgmma), TMA and a split of the kv loop are later work.
//
// Design: one CTA of 8 warps per (query tile of 64 rows, bh); the CTAs
// run in any order, the heaviest (last, under a causal mask) q tiles
// first. The TPU's sequential kv grid axis is a loop inside the CTA over
// 64-key tiles, from the first tile the window can reach to the last the
// causal mask allows — the tile-skip test of flash.py:54-66 as loop
// bounds, so masked-out tiles cost nothing. Each tile of k and v is
// staged in shared memory as float32; the q tile stays in shared memory
// for the whole loop. Rows are padded to D4 = D rounded up to 4 floats
// (zeros), so the products read q and k as float4; k rows get a further
// pad that makes their stride an odd number of float4s, so the eight
// lanes of each 128-byte phase of a float4 load hit distinct banks.
// A warp owns 8 query rows and works on all 8 at once (register
// blocking): lane l computes the scores of keys l and l + 32 for the 8
// rows, each float4 of k loaded once for 8 rows and each float4 of q
// broadcast to the warp; the warp reduces each row's max and sum with
// shuffles; in the p·v product each key's v values are loaded once for
// the 8 rows and its 8 p values broadcast with shuffles, while lane l
// accumulates output columns l, l + 32, l + 64, l + 96 (D <= 128; columns
// >= D idle). m, l and acc of the 8 rows live in registers in float32.
// No fast math. Shared memory is 4·64·(2·D4 + kstride) bytes: 50,176 at
// D = 64, 99,328 at D = 128 (dynamic, opted in above 48 KB).
//
// Its first version took one row at a time, with scalar shared loads:
// 1.33 ms at smollm's prefill on an H100, no faster than the plain
// version (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as astype does
}

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
// contiguous on the device, float32 (dtype 0) or bfloat16 (dtype 1);
// 1 <= d <= 128, t <= s, n_heads % n_kv_heads == 0, bh % n_heads == 0;
// window < 1 = none. Launches on `stream`; returns cudaGetLastError()
// (0 = launched). Allocates nothing.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int bh,
                                      int n_heads, int n_kv_heads, int t_len,
                                      int s_len, int d, int causal,
                                      int window, float scale, int dtype,
                                      void* stream) {
  if (bh <= 0 || t_len <= 0 || d < 1 || d > MAX_D || t_len > s_len ||
      n_heads <= 0 || n_kv_heads <= 0 || n_heads % n_kv_heads ||
      bh % n_heads)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(q, k, v, o, bh, n_heads, n_kv_heads, t_len, s_len,
                         d, causal, window, scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, o, bh, n_heads, n_kv_heads, t_len,
                                 s_len, d, causal, window, scale, st);
  return (int)cudaErrorInvalidValue;
}
