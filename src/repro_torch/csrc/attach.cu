// Barabási–Albert attachment — Hopper (sm_90a).
//
// Replaces no pallas_call. The reference runs this step as a compiled
// lax.scan over the arrivals with a lax.while_loop of rejection rounds
// inside (src/repro/topology/generators.py:216-245, barabasi_albert's
// draw_targets and attach; the chunked path vmaps draw_targets over a
// block, :264-276). Eager PyTorch has no device-side loop, and 10^6
// sequential arrivals cannot be host-driven ops, so the loop is this
// kernel.
//
// What it computes, for arrivals i = 0..count-1 (node t = first + i), on
// the endpoint multiset ends (int32) and the targets out [count, m]:
//   fill_i = fill + 2m·i (serial) or fill (a frozen block)
//   kk = fold_in(key, t)
//   repeat: kk, sub = split(kk); cand = ends[randint(sub, (), 0, fill_i)];
//           keep cand unless it is already among the arrival's targets
//   until m targets are kept; then, at slab = fill + 2m·i,
//   ends[slab + j] = target j, ends[slab + m + j] = t.
// The draws are jax.random's (threefry2x32, jax_threefry_partitionable,
// x64 off), computed inline: fold_in(k, d) = H_k(0, d), split(k)[j] =
// H_k(0, j), random_bits(k, ()) = x ^ y of H_k(0, 0), and randint's
// two-word fold into the span with multiplier (2^16 mod span)^2 mod span,
// all in uint32 arithmetic that wraps as XLA's does. A draw depends on t
// and fill_i only, never on the data; only the lookups do.
//
// Serial (frozen = 0): one thread walks the arrivals in order; arrival i
// reads the slabs of arrivals < i, which the same thread wrote (program
// order makes them visible). Frozen (frozen = 1): one thread per arrival;
// every lookup reads below fill and every write lands at or above it, so
// the threads share nothing.
//
// What bounds it on this card: latency, not bytes or operations. The
// serial path is one dependent chain: per round six Threefry hashes (in
// three dependent pairs: the split, the randint's split, the bits) of 20
// add-rotate-xor steps each, then a lookup in ends (16 MB at n = 10^6, in
// the 50 MB L2), ~2.05 rounds per arrival at m = 2, plus the fold_in.
// Its bytes (ends read and written once) and integer operations are
// milliseconds of the card's rates at n = 10^6; the chain of ~10^6 ×
// (3 × 2.05 + 1) dependent hashes is seconds. The design keeps the chain
// short where it can: the two hashes of each pair are independent and
// written side by side for the scheduler to interleave, the randint's
// multiplier is formed once per arrival. The chosen targets are written
// to the arrival's row of out as they are kept, and the duplicate check
// reads them back from there (a few words, in L1). The frozen path fills
// the card with one thread per arrival of the block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int FROZEN_THREADS = 128;

struct Pair {
  uint32_t x, y;
};

__device__ __forceinline__ uint32_t rotl(uint32_t v, int r) {
  return __funnelshift_l(v, v, r);
}

// Threefry's rotations: (13, 15, 26, 6) in even rounds, (17, 29, 16, 24)
// in odd ones
__device__ __forceinline__ constexpr int rotation(int i, int j) {
  return i % 2 == 0 ? (j == 0 ? 13 : j == 1 ? 15 : j == 2 ? 26 : 6)
                    : (j == 0 ? 17 : j == 1 ? 29 : j == 2 ? 16 : 24);
}

// Threefry-2x32, 20 rounds: the hash of the counter (x1, x2) under the key
// k; mirrors repro_torch.utils.prng.threefry2x32.
__device__ __forceinline__ Pair threefry(Pair k, uint32_t x1, uint32_t x2) {
  const uint32_t ks[3] = {k.x, k.y, k.x ^ k.y ^ 0x1BD11BDAu};
  x1 += ks[0];
  x2 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x1 += x2;
      x2 = rotl(x2, rotation(i, j)) ^ x1;
    }
    x1 += ks[(i + 1) % 3];
    x2 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
  return {x1, x2};
}

// One arrival: m distinct targets from ends[0, span), written to row and
// to the slab at ends + slab.
__device__ void attach_one(Pair key, int32_t* ends, int32_t* row,
                           int32_t t, uint32_t span, long long slab,
                           int m) {
  Pair kk = threefry(key, 0u, (uint32_t)t);  // fold_in(key, t)
  uint32_t mult = 65536u % span;
  mult = (mult * mult) % span;
  int cnt = 0;
  while (cnt < m) {
    // kk, sub = split(kk)
    const Pair sub = threefry(kk, 0u, 1u);
    kk = threefry(kk, 0u, 0u);
    // randint(sub, (), 0, span): two words from split(sub)
    const Pair k_hi = threefry(sub, 0u, 0u);
    const Pair k_lo = threefry(sub, 0u, 1u);
    const Pair b_hi = threefry(k_hi, 0u, 0u);
    const Pair b_lo = threefry(k_lo, 0u, 0u);
    const uint32_t higher = b_hi.x ^ b_hi.y, lower = b_lo.x ^ b_lo.y;
    const uint32_t slot = ((higher % span) * mult + lower % span) % span;
    const int32_t cand = ends[slot];
    bool fresh = true;
    for (int j = 0; j < cnt; ++j) {
      fresh &= row[j] != cand;
    }
    if (fresh) {
      row[cnt] = cand;
      ++cnt;
    }
  }
  for (int j = 0; j < m; ++j) {
    ends[slab + j] = row[j];
    ends[slab + m + j] = t;
  }
}

__global__ void __launch_bounds__(FROZEN_THREADS)
attach_kernel(const int64_t* __restrict__ key, int32_t* ends,
              int32_t* __restrict__ out, int first, int count,
              long long fill, int m, int frozen) {
  const Pair k = {(uint32_t)key[0], (uint32_t)key[1]};
  if (frozen) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= count) return;
    attach_one(k, ends, out + (long long)i * m, first + i, (uint32_t)fill,
               fill + 2LL * m * i, m);
    return;
  }
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  for (int i = 0; i < count; ++i) {
    const long long at = fill + 2LL * m * i;
    attach_one(k, ends, out + (long long)i * m, first + i, (uint32_t)at, at,
               m);
  }
}

}  // namespace

// key: int64 [2] on the device (two uint32 words); ends: int32 with at
// least fill + 2m·count slots; out: int32 [count, m]. The binding checks
// shapes and that fill + 2m·count < 2^31.
extern "C" int attach_launch(const void* key, void* ends, void* out,
                             int first, int count, long long fill, int m,
                             int frozen, void* stream) {
  if (count <= 0 || m <= 0 || fill <= 0) return (int)cudaErrorInvalidValue;
  const int blocks =
      frozen ? (count + FROZEN_THREADS - 1) / FROZEN_THREADS : 1;
  const int threads = frozen ? FROZEN_THREADS : 1;
  attach_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)key, (int32_t*)ends, (int32_t*)out, first, count, fill,
      m, frozen);
  return (int)cudaGetLastError();
}
