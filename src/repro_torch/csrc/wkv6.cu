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
// D <= 128. Returns o [B·H, T, D] and the final S [B·H, D, D], float32.
// Unlike the TPU kernel it takes an initial state (the serving path's
// chunked prefill and decode carry one), needs no T % 32 == 0 (a decode
// step has T = 1, the last prefill chunk is ragged), and never takes
// log w, so a bfloat16 w that rounds to 0 or 1 is harmless.
//
// What bounds it on this card. At rwkv6-3b's prefill (B·H = 40, T = 2048,
// D = 64, bf16 in) the bytes are ~64 MB (r, k, v, w in bf16, o in f32,
// s0 and s_final), 19 us at 3.35 TB/s; the operations are 5·T·D² per
// row (r·S, and the decay and outer product of the update), 1.68 GFLOP,
// 25 us at the 67 TFLOP/s float32 CUDA-core rate: operations bound it.
// This kernel reaches neither: it is bound by the serial chain of each
// step. Its 40 CTAs of 64 threads fill 40 of 132 SMs with 2 warps each,
// and every thread issues ~4·D float32 instructions and 3·D/4 broadcast
// 16-byte shared-memory loads per step (r, k, w), for T steps in order.
// A step takes ~0.32 us (~630 cycles, about twice the FMAs' issue time;
// measured with the loads of the inputs hidden), so the loads' shared-
// memory wavefronts are the likely limit. The chunked form (the TPU kernel's: intra-chunk products on
// tensor cores, mma.sync / wgmma), a register-blocked tile of S per
// thread (fewer broadcast loads per FMA), and a split of the value
// columns over more CTAs are later kernel work (PERF.md records the gap).
//
// Design: the RWKV project's own CUDA kernel's shape. One CTA per bh, DT
// threads (D rounded up to a multiple of 32: 32, 64, 96 or 128); thread
// j owns column j of S in DT registers (the i loop is unrolled at
// compile time, so S never leaves the register file). u's bonus is
// folded into the same pass: with x = k_t[i]·v_t[j],
//   y += r_t[i]·(u[i]·x + S[i][j]);  S[i][j] = S[i][j]·w_t[i] + x,
// which reads S before the decay, as the recurrence does; y is kept in
// four partial sums (i mod 4) to shorten the dependent chain. A tile of
// TT steps of r, k, w and v is staged in shared memory as float32 (zero
// padded to DT), so there is one pair of barriers per tile and not per
// step; r, k, w and u are read as broadcast float4s, v[t][j] by lane j.
// Thread j loads column j of the next tile's rows into registers, in the
// inputs' own type, before it computes the current tile, so the loads'
// latency is hidden behind TT steps (staged by a load-then-store loop
// with no prefetch, the first version spent half its time waiting on
// them: 1.82 ms at rwkv6-3b's prefill on an H100, PERF.md). Threads
// j >= D compute on zeros and store nothing. No fast math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_D = 128;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// steps per staged tile: 16 up to D = 64, else 4 (each thread holds the
// next tile's 4·TT values in registers beside its DT state registers)
template <int DT>
struct Tile {
  static constexpr int TT = DT <= 64 ? 16 : 4;
};

template <typename T, int DT>
__global__ void __launch_bounds__(DT)
wkv6_fwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ w,
                const float* __restrict__ u, const float* __restrict__ s0,
                float* __restrict__ o, float* __restrict__ s_out,
                int n_heads, int t_len, int d) {
  constexpr int TT = Tile<DT>::TT;
  __shared__ __align__(16) float rs[TT][DT];
  __shared__ __align__(16) float ks[TT][DT];
  __shared__ __align__(16) float ws[TT][DT];
  __shared__ __align__(16) float vs[TT][DT];
  __shared__ __align__(16) float us[DT];

  const int bh = blockIdx.x;
  const int j = threadIdx.x;
  const size_t base = (size_t)bh * t_len * d;
  const T* rb = r + base;
  const T* kb = k + base;
  const T* vb = v + base;
  const T* wb = w + base;
  float* ob = o + base;

  us[j] = j < d ? u[(size_t)(bh % n_heads) * d + j] : 0.f;

  float S[DT];  // column j of the state: S[i] = S[i][j]
  if (s0 != nullptr && j < d) {
    const float* sb = s0 + (size_t)bh * d * d + j;
#pragma unroll
    for (int i = 0; i < DT; ++i) S[i] = i < d ? sb[(size_t)i * d] : 0.f;
  } else {
#pragma unroll
    for (int i = 0; i < DT; ++i) S[i] = 0.f;
  }

  // thread j fetches column j of the next tile's rows into registers;
  // the loads are in flight while the current tile is computed
  T pr[TT], pk[TT], pw[TT], pv[TT];
  const T zero = T(0.f);
  auto fetch = [&](int t0) {
#pragma unroll
    for (int tt = 0; tt < TT; ++tt) {
      const bool ok = t0 + tt < t_len && j < d;
      const size_t g = (size_t)(t0 + tt) * d + j;
      pr[tt] = ok ? rb[g] : zero;
      pk[tt] = ok ? kb[g] : zero;
      pw[tt] = ok ? wb[g] : zero;
      pv[tt] = ok ? vb[g] : zero;
    }
  };
  fetch(0);

  for (int t0 = 0; t0 < t_len; t0 += TT) {
    const int nt = min(TT, t_len - t0);
    __syncthreads();  // the previous tile is consumed (us written, first)
#pragma unroll
    for (int tt = 0; tt < TT; ++tt) {
      rs[tt][j] = to_float(pr[tt]);
      ks[tt][j] = to_float(pk[tt]);
      ws[tt][j] = to_float(pw[tt]);
      vs[tt][j] = to_float(pv[tt]);
    }
    __syncthreads();
    if (t0 + TT < t_len) fetch(t0 + TT);

    for (int tt = 0; tt < nt; ++tt) {
      const float vj = vs[tt][j];
      const float4* r4 = reinterpret_cast<const float4*>(rs[tt]);
      const float4* k4 = reinterpret_cast<const float4*>(ks[tt]);
      const float4* w4 = reinterpret_cast<const float4*>(ws[tt]);
      const float4* u4 = reinterpret_cast<const float4*>(us);
      float y0 = 0.f, y1 = 0.f, y2 = 0.f, y3 = 0.f;
#pragma unroll
      for (int q = 0; q < DT / 4; ++q) {
        const float4 rr = r4[q], kk = k4[q], ww = w4[q], uu = u4[q];
        float x;
        x = kk.x * vj;
        y0 = fmaf(rr.x, fmaf(uu.x, x, S[4 * q]), y0);
        S[4 * q] = fmaf(S[4 * q], ww.x, x);
        x = kk.y * vj;
        y1 = fmaf(rr.y, fmaf(uu.y, x, S[4 * q + 1]), y1);
        S[4 * q + 1] = fmaf(S[4 * q + 1], ww.y, x);
        x = kk.z * vj;
        y2 = fmaf(rr.z, fmaf(uu.z, x, S[4 * q + 2]), y2);
        S[4 * q + 2] = fmaf(S[4 * q + 2], ww.z, x);
        x = kk.w * vj;
        y3 = fmaf(rr.w, fmaf(uu.w, x, S[4 * q + 3]), y3);
        S[4 * q + 3] = fmaf(S[4 * q + 3], ww.w, x);
      }
      if (j < d) ob[(size_t)(t0 + tt) * d + j] = (y0 + y1) + (y2 + y3);
    }
  }

  if (j < d) {
    float* sb = s_out + (size_t)bh * d * d + j;
#pragma unroll
    for (int i = 0; i < DT; ++i)
      if (i < d) sb[(size_t)i * d] = S[i];
  }
}

template <typename T, int DT>
int launch_dt(const void* r, const void* k, const void* v, const void* w,
              const float* u, const float* s0, float* o, float* s_out,
              int bh, int n_heads, int t_len, int d, cudaStream_t stream) {
  wkv6_fwd_kernel<T, DT><<<bh, DT, 0, stream>>>(
      (const T*)r, (const T*)k, (const T*)v, (const T*)w, u, s0, o, s_out,
      n_heads, t_len, d);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* w,
           const float* u, const float* s0, float* o, float* s_out, int bh,
           int n_heads, int t_len, int d, cudaStream_t stream) {
  if (d <= 32)
    return launch_dt<T, 32>(r, k, v, w, u, s0, o, s_out, bh, n_heads, t_len,
                            d, stream);
  if (d <= 64)
    return launch_dt<T, 64>(r, k, v, w, u, s0, o, s_out, bh, n_heads, t_len,
                            d, stream);
  if (d <= 96)
    return launch_dt<T, 96>(r, k, v, w, u, s0, o, s_out, bh, n_heads, t_len,
                            d, stream);
  return launch_dt<T, 128>(r, k, v, w, u, s0, o, s_out, bh, n_heads, t_len,
                           d, stream);
}

}  // namespace

// r, k, v, w [bh, t, d] (float32: dtype 0, bfloat16: dtype 1), u [H, d]
// float32 (row bh uses u[bh % H]), s0 [bh, d, d] float32 or null (zeros);
// o [bh, t, d] and s_out [bh, d, d] float32. All contiguous on the device;
// 1 <= d <= 128, t >= 1, bh % n_heads == 0; s_out must not alias s0.
// Launches on `stream`; returns cudaGetLastError() (0 = launched).
// Allocates nothing.
extern "C" int wkv6_launch(const void* r, const void* k, const void* v,
                           const void* w, const void* u, const void* s0,
                           void* o, void* s_out, int bh, int n_heads,
                           int t_len, int d, int dtype, void* stream) {
  if (bh <= 0 || t_len <= 0 || d < 1 || d > MAX_D ||
      n_heads <= 0 || bh % n_heads)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const float* uf = (const float*)u;
  const float* sf = (const float*)s0;
  if (dtype == 0)
    return launch<float>(r, k, v, w, uf, sf, (float*)o, (float*)s_out, bh,
                         n_heads, t_len, d, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(r, k, v, w, uf, sf, (float*)o,
                                 (float*)s_out, bh, n_heads, t_len, d, st);
  return (int)cudaErrorInvalidValue;
}
