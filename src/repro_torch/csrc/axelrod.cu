// One wave of Axelrod interactions on gathered trait rows — Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/axelrod/axelrod.py
// (axelrod_wave_pallas, pallas_call at :70; _kernel :28).
//
// For task rows i < W with source and target traits s[i, :], t[i, :]
// (int32, F features), uniforms u[i], g[i, :] (float32) and mask[i]:
//   overlap[i]  = #{f : s[i, f] == t[i, f]} / F          (IEEE division)
//   interact[i] = mask[i] && u[i] < overlap && overlap < 1 && overlap >= lo
//   feat[i]     = first argmax over f of (s == t ? -1 : g[i, f])
//   new_t[i, f] = interact[i] && f == feat[i] ? s[i, f] : t[i, f]
// lo is 1 - omega formed in double on the host and rounded to float32, as
// the reference's weak-typed scalar is. Ties in the argmax go to the
// smaller feature index (jnp.argmax, the TPU kernel's cumsum).
//
// What bounds it on this card: bytes. Each row moves 16F + 9 bytes (s, t
// and g read, new_t written, u, mask and interact): 32.8 MB at W = 4096
// and F = 500, ~9.8 us at 3.35 TB/s. The work per byte is a compare and
// a max, far below the card's operation rate. At the paper's default
// F = 3 a window is 0.23 MB: the launch dominates.
//
// Design: one warp per task row, ROWS warps per CTA, any W >= 1 and
// F >= 1, no padding copy (the TPU kernel pads F to 128 lanes and W to
// 128-row blocks). Lanes stride the features, count the equal ones and
// keep the best (score, f) of their features; warp shuffles reduce the
// count and the argmax. Lane 0's gate is computed by every lane (they all
// hold the reduced values), so no broadcast is needed. The lanes then
// write new_t in the same strided order. At F = 3, 29 lanes of each warp
// idle: acceptable for a launch-bound size.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 8;  // warps (task rows) per CTA

__global__ void __launch_bounds__(ROWS * 32)
axelrod_wave_kernel(const int32_t* __restrict__ s,
                    const int32_t* __restrict__ t,
                    const float* __restrict__ u,
                    const float* __restrict__ g,
                    const uint8_t* __restrict__ mask,
                    int32_t* __restrict__ new_t,
                    uint8_t* __restrict__ interact, int w, int f, float lo) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * ROWS + warp;
  if (row >= w) return;  // whole warps leave; no barrier follows
  const size_t base = (size_t)row * f;
  const int32_t* sr = s + base;
  const int32_t* tr = t + base;
  const float* gr = g + base;

  int cnt = 0;
  float best = 0.0f;
  int arg = f;  // f = no feature seen yet
  for (int j = lane; j < f; j += 32) {
    const bool eq = sr[j] == tr[j];
    cnt += eq;
    const float score = eq ? -1.0f : gr[j];
    // strictly greater: a lane sees its features in ascending order, so
    // the first maximum is kept
    if (arg == f || score > best) {
      best = score;
      arg = j;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    cnt += __shfl_xor_sync(0xffffffffu, cnt, off);
    const float ob = __shfl_xor_sync(0xffffffffu, best, off);
    const int oa = __shfl_xor_sync(0xffffffffu, arg, off);
    // symmetric combine (larger score, then smaller index), so every lane
    // ends with the same pair
    if (oa != f && (arg == f || ob > best || (ob == best && oa < arg))) {
      best = ob;
      arg = oa;
    }
  }
  const float overlap = (float)cnt / (float)f;
  const bool act = mask[row] != 0 && u[row] < overlap && overlap < 1.0f &&
                   overlap >= lo;
  int32_t* out = new_t + base;
  for (int j = lane; j < f; j += 32)
    out[j] = (act && j == arg) ? sr[j] : tr[j];
  if (lane == 0) interact[row] = act;
}

}  // namespace

// s, t [w, f] int32, u [w] float32, g [w, f] float32, mask [w] bool,
// new_t [w, f] int32, interact [w] bool; all contiguous on the device.
// Launches on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int axelrod_wave_launch(const void* s, const void* t,
                                   const void* u, const void* g,
                                   const void* mask, void* new_t,
                                   void* interact, int w, int f, float lo,
                                   void* stream) {
  if (w <= 0 || f <= 0) return (int)cudaErrorInvalidValue;
  const int blocks = (w + ROWS - 1) / ROWS;
  axelrod_wave_kernel<<<blocks, ROWS * 32, 0, (cudaStream_t)stream>>>(
      (const int32_t*)s, (const int32_t*)t, (const float*)u,
      (const float*)g, (const uint8_t*)mask, (int32_t*)new_t,
      (uint8_t*)interact, w, f, lo);
  return (int)cudaGetLastError();
}
