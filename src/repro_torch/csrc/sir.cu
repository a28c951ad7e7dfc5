// One wave of SIRS type-A updates on the ring — Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/sir/sir.py (sir_wave_pallas,
// pallas_call at :71; _kernel :31) together with the halo gather of its
// wrapper (src/repro/kernels/sir/ops.py:16-41): this kernel reads the
// agent states directly, so the [W, s + k] int32 halo is never
// materialised in device memory.
//
// For task rows i < W with subset id b = subset[i], half = k / 2 and the
// ring halo h[j] = states[(b·s − half + j) mod N], j < s + 2·half:
//   acc[a]  = Σ_{d ≤ 2·half, d ≠ half} (h[a + d] == I)    (float, exact)
//   inf[a]  = acc[a] / k                                   (IEEE division)
//   cur     = h[a + half]
//   nxt[a]  = cur == S && u[i, a] < p_si · inf ? I
//           : cur == I && u[i, a] < p_ir       ? R
//           : cur == R && u[i, a] < p_rs       ? S : cur
// for agents a < s. The rates are rounded to float32 on the host, as the
// reference's weak-typed scalars are. States and next states are int8
// (the model's dtype); their values equal the reference's int32 ones.
//
// What bounds it on this card: bytes. Each row reads s + k halo states
// (1 byte), s uniforms (4 bytes) and its subset id (4 bytes) and writes
// s next states (1 byte): W·(6s + k + 4) bytes, 1.3 MB at W = 4096 and
// s = 50 (launch-bound), 24.6 MB (~7.3 us at 3.35 TB/s) at s = 1000. The
// k compares per agent are far below the operation rate.
//
// Design: one CTA per task row. Its threads stage the halo in shared
// memory (s + k bytes, wrapping at the ring's ends), then each thread
// takes agents a < s in steps of blockDim and reads its k − 1 neighbours
// from shared memory. The ring needs s + k <= N (checked by the binding).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int8_t S_ = 0, I_ = 1, R_ = 2;

__global__ void __launch_bounds__(THREADS)
sir_wave_kernel(const int8_t* __restrict__ states,
                const int32_t* __restrict__ subsets,
                const float* __restrict__ u, int8_t* __restrict__ out,
                int n, int s, int k, float p_si, float p_ir, float p_rs) {
  extern __shared__ int8_t halo[];  // [s + 2·half]
  const int row = blockIdx.x;
  const int half = k / 2;
  const int width = s + 2 * half;
  const long long start = (long long)subsets[row] * s - half;
  for (int j = threadIdx.x; j < width; j += blockDim.x) {
    long long idx = (start + j) % n;
    if (idx < 0) idx += n;
    halo[j] = states[idx];
  }
  __syncthreads();

  const float kf = (float)k;
  const float* ur = u + (size_t)row * s;
  int8_t* orow = out + (size_t)row * s;
  for (int a = threadIdx.x; a < s; a += blockDim.x) {
    float acc = 0.0f;
    for (int d = 0; d <= 2 * half; ++d)
      if (d != half) acc += halo[a + d] == I_ ? 1.0f : 0.0f;
    const float inf = acc / kf;
    const int8_t cur = halo[a + half];
    const float ua = ur[a];
    int8_t nxt = cur;
    if (cur == S_ && ua < p_si * inf)
      nxt = I_;
    else if (cur == I_ && ua < p_ir)
      nxt = R_;
    else if (cur == R_ && ua < p_rs)
      nxt = S_;
    orow[a] = nxt;
  }
}

}  // namespace

// states [n] int8, subsets [w] int32, u [w, s] float32, out [w, s] int8;
// all contiguous on the device; s + k <= n. Launches on `stream`; returns
// cudaGetLastError() (0 = launched).
extern "C" int sir_wave_launch(const void* states, const void* subsets,
                               const void* u, void* out, int w, int n, int s,
                               int k, float p_si, float p_ir, float p_rs,
                               void* stream) {
  if (w <= 0 || s <= 0 || k <= 0 || s + k > n)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)s + 2 * (k / 2);
  sir_wave_kernel<<<w, THREADS, smem, (cudaStream_t)stream>>>(
      (const int8_t*)states, (const int32_t*)subsets, (const float*)u,
      (int8_t*)out, n, s, k, p_si, p_ir, p_rs);
  return (int)cudaGetLastError();
}
