// Barabási–Albert attachment — Hopper (sm_90a).
//
// Replaces no pallas_call. The reference runs this step as a compiled
// lax.scan over the arrivals with a lax.while_loop of rejection rounds
// inside (src/repro/topology/generators.py:216-245, barabasi_albert's
// draw_targets and attach; the chunked path vmaps draw_targets over a
// block, :264-276). Eager PyTorch has no device-side loop, and 10^6
// sequential arrivals cannot be host-driven ops, so the loop is this
// kernel: one launch for a whole build, exact or chunked.
//
// What it computes, for arrivals i = 0..count-1 (node t = first + i), on
// the endpoint multiset ends (int32) and the targets out [count, m]:
//   span_i = fill + 2m·i                                  (i < warm)
//          = fill + 2m·(warm + block·⌊(i − warm)/block⌋)   (frozen blocks)
//   kk = fold_in(key, t)
//   repeat: kk, sub = split(kk); cand = ends[randint(sub, (), 0, span_i)];
//           keep cand unless it is already among the arrival's targets
//   until m targets are kept; then, at slab = fill + 2m·i,
//   ends[slab + j] = target j, ends[slab + m + j] = t.
// The exact build is warm = count; the chunked one warm = block = C.
// The draws are jax.random's (threefry2x32, jax_threefry_partitionable,
// x64 off), computed inline: fold_in(k, d) = H_k(0, d), split(k)[j] =
// H_k(0, j), random_bits(k, ()) = x ^ y of H_k(0, 0), and randint's
// two-word fold into the span with multiplier (2^16 mod span)^2 mod span,
// all in uint32 arithmetic that wraps as XLA's does.
//
// Design: one thread per arrival. A draw depends on (t, round, span_i)
// only, never on the data, so a thread draws its first min(m, PRE)
// rounds — the fewest an arrival uses (m), so no hash is wasted; the
// key of a round after them is hashed only if it is needed — before its
// first lookup, and the hashes of all arrivals spread over the card.
// Only the lookups depend on other arrivals, and a slot s says what it
// holds:
//   s < fill: ends[s], written before the launch;
//   s >= fill: p = s - fill, owner = p / 2m, o = p mod 2m;
//     o >= m: the source first + owner, known without a load;
//     o < m: target o of the earlier arrival owner — the only wait.
// So the build is a DAG of short backward chains of target-on-target
// lookups (~30 links at n = 10^6, m = 2), not one chain of 10^6
// arrivals. out starts at -1 (a memset before the launch); an arrival
// publishes each target as it keeps it, one 32-bit store, and a thread
// that needs it polls the word until it is not -1: the value is the
// flag. Stores and polls are st/ld.relaxed.gpu, which go to L2 and not
// to the L1 that other SMs' stores never reach; a poll that misses backs
// off with __nanosleep. The duplicate check reads the thread's own row of
// out. Slabs are written into ends at the end; nothing in the launch
// reads ends at or above fill.
//
// Forward progress: a block maps a ticket (an atomicAdd on a counter
// zeroed before the launch), not blockIdx, to its arrivals, so every
// arrival waited on is in a block that started before, or in the
// waiter's own. A started block stays resident, so by induction on the
// arrival index the lowest unfinished arrival waits on nothing
// unfinished. Lanes of one warp that wait on each other rely on
// independent thread scheduling (sm_70 on); a polling lane's nanosleep
// leaves the warp scheduler to the lanes it waits for.
//
// What bounds it on this card: the hashes, ~1.1e9 integer operations at
// n = 10^6, m = 2 (six Threefry hashes of ~80 operations a round, ~2.0
// rounds an arrival), over the SMs' INT32 rate (64 lanes an SM: ~0.064
// ms on an H100 SXM at 1.98 GHz), which the kernel runs at (~0.062 ms
// by torch.profiler on an H100 80GB HBM3 at 700 W). The critical path —
// the longest chain of dependent lookups (29 links there), each a store
// and a poll through L2 plus the backoff's grain — is ~0.01 ms, and the
// bytes (ends and out, ~24 MB) ~0.007 ms at 3.35 TB/s.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
// rounds a thread draws before its first lookup, at most
constexpr int PRE = 4;
// the longest nanosleep between two polls of a target, ns
constexpr unsigned BACKOFF_MAX_NS = 256;

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

// The slot of the round whose key is kk: randint(sub, (), 0, span) with
// sub = split(kk)[1] — two words from split(sub), folded with the
// multiplier mult. The next round's key, split(kk)[0], is hashed only
// when a round is needed (next_key). The two hashes of each pair are
// independent, side by side for the scheduler to interleave.
__device__ __forceinline__ uint32_t slot_of(Pair kk, uint32_t span,
                                            uint32_t mult) {
  const Pair sub = threefry(kk, 0u, 1u);
  const Pair k_hi = threefry(sub, 0u, 0u);
  const Pair k_lo = threefry(sub, 0u, 1u);
  const Pair b_hi = threefry(k_hi, 0u, 0u);
  const Pair b_lo = threefry(k_lo, 0u, 0u);
  const uint32_t higher = b_hi.x ^ b_hi.y, lower = b_lo.x ^ b_lo.y;
  return ((higher % span) * mult + lower % span) % span;
}

__device__ __forceinline__ Pair next_key(Pair kk) {
  return threefry(kk, 0u, 0u);
}

__device__ __forceinline__ int32_t load_relaxed(const int32_t* p) {
  int32_t v;
  asm volatile("ld.relaxed.gpu.global.b32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_relaxed(int32_t* p, int32_t v) {
  asm volatile("st.relaxed.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

// The value in slot `slot` of the multiset (see the head note): a seed
// slot read, a source decoded, an earlier arrival's target waited for.
__device__ __forceinline__ int32_t lookup(const int32_t* ends,
                                          const int32_t* out, uint32_t slot,
                                          uint32_t fill, int first, int m) {
  if (slot < fill) return ends[slot];
  const uint32_t p = slot - fill, two_m = 2u * (uint32_t)m;
  const uint32_t owner = p / two_m, o = p - owner * two_m;
  if (o >= (uint32_t)m) return first + (int32_t)owner;
  const int32_t* flag = out + (long long)owner * m + o;
  int32_t v = load_relaxed(flag);
  for (unsigned ns = 32; v < 0; ns = min(2 * ns, BACKOFF_MAX_NS)) {
    __nanosleep(ns);
    v = load_relaxed(flag);
  }
  return v;
}

// Keeps cand as target cnt of the arrival whose row of out is row, unless
// it is one already, and publishes it; returns 1 if kept.
__device__ __forceinline__ int keep(int32_t* row, int cnt, int32_t cand) {
  for (int j = 0; j < cnt; ++j) {
    if (row[j] == cand) return 0;
  }
  store_relaxed(row + cnt, cand);
  return 1;
}

__global__ void __launch_bounds__(THREADS)
attach_kernel(const int64_t* __restrict__ key, int32_t* __restrict__ ends,
              int32_t* out, int* ticket, int first, int count, uint32_t fill,
              int m, int warm, int block) {
  __shared__ int base;
  if (threadIdx.x == 0) base = atomicAdd(ticket, 1) * THREADS;
  __syncthreads();
  const int i = base + (int)threadIdx.x;
  if (i >= count) return;
  const Pair k = {(uint32_t)key[0], (uint32_t)key[1]};
  const int t = first + i;
  const int at = i < warm ? i : warm + block * ((i - warm) / block);
  const uint32_t span = fill + 2u * (uint32_t)m * (uint32_t)at;
  Pair kk = threefry(k, 0u, (uint32_t)t);  // fold_in(key, t): round 0
  uint32_t mult = 65536u % span;
  mult = (mult * mult) % span;
  // the draws first: every round before m is used, whatever the data
  uint32_t slots[PRE];
#pragma unroll
  for (int r = 0; r < PRE; ++r) {
    if (r < m) {
      if (r > 0) kk = next_key(kk);
      slots[r] = slot_of(kk, span, mult);
    }
  }
  int32_t* row = out + (long long)i * m;
  int cnt = 0;
#pragma unroll
  for (int r = 0; r < PRE; ++r) {
    if (r < m) cnt += keep(row, cnt, lookup(ends, out, slots[r], fill,
                                            first, m));
  }
  while (cnt < m) {
    kk = next_key(kk);
    cnt += keep(row, cnt, lookup(ends, out, slot_of(kk, span, mult), fill,
                                 first, m));
  }
  const long long slab = fill + 2LL * m * i;
  for (int j = 0; j < m; ++j) {
    ends[slab + j] = row[j];
    ends[slab + m + j] = t;
  }
}

}  // namespace

// key: int64 [2] on the device (two uint32 words); ends: int32 with at
// least fill + 2m·count slots; out: int32 [count, m]; ticket: one int32 of
// scratch. out and ticket are set here, on the stream, before the launch.
// The binding checks shapes, 0 <= warm <= count, block >= 1 and that
// fill + 2m·count < 2^31.
extern "C" int attach_launch(const void* key, void* ends, void* out,
                             void* ticket, int first, int count,
                             long long fill, int m, int warm, int block,
                             void* stream) {
  if (count <= 0 || m <= 0 || fill <= 0 || warm < 0 || warm > count ||
      block <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err =
      cudaMemsetAsync(out, 0xFF, (size_t)count * m * sizeof(int32_t), s);
  if (err == cudaSuccess) err = cudaMemsetAsync(ticket, 0, sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  attach_kernel<<<(count + THREADS - 1) / THREADS, THREADS, 0, s>>>(
      (const int64_t*)key, (int32_t*)ends, (int32_t*)out, (int*)ticket,
      first, count, (uint32_t)fill, m, warm, block);
  return (int)cudaGetLastError();
}
