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
// counts per agent are far below the operation rate.
//
// Design. Rows are packed by s: a thread takes G consecutive agents — 16
// (four float4 loads of uniforms in flight) for s >= 256, 4 below — and a
// row gets TPR threads, the least power of two (1 .. 256) with G·TPR >= s
// (plus one group where the row's uniforms start off a 16-byte boundary;
// wider rows loop over their groups);
// a CTA of up to 256 threads holds 256 / TPR rows, fewer where their
// halos would pass 48 KB of shared memory (16 rows of 16 threads at
// s = 50, four rows of 64 threads at s = 1000). Per row:
//   - the halo's start (b·s − half) mod N is computed once; the halo is
//     one contiguous range of the states, or two where it crosses the
//     ring's end, and is copied to shared memory at the same offset mod
//     16 as in device memory, so its body moves as 16-byte cp.async
//     chunks (byte copies at the edges, and for a second range whose
//     offset differs, N % 16 != 0);
//   - a thread's G agents are aligned so that its uniforms are float4
//     loads (scalar loads at a row's head and tail, which are misaligned
//     when s % 4 != 0), issued before the halo is staged;
//   - the neighbour count slides: the window Σ_{d ≤ 2·half} [h[a + d] = I]
//     of a thread's first agent is summed once, then each next agent adds
//     the byte entering and drops the byte leaving (O(1) per agent), and
//     count(a) = window(a) − [h[a + half] = I] — an integer converted to
//     float once, equal to the reference's float sum of 0/1 values, which
//     is exact below 2^24;
//   - the S -> I threshold p_si · (count / k) of each count 0 .. 2·half
//     is computed once per CTA (the IEEE division and the product, as the
//     reference rounds them) and looked up per agent;
//   - the next states are stored four bytes at a time where aligned.
// One barrier, after the halo. The ring needs s + k <= N (checked by the
// binding).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // at most, per CTA
constexpr int WIDE_S = 256;   // s >= WIDE_S: 16 agents a thread, else 4
constexpr int SMEM = 48 * 1024;  // shared bytes a CTA aims at
constexpr int TAB_MAX = 1024;    // largest window with a threshold table
constexpr int8_t S_ = 0, I_ = 1, R_ = 2;

__host__ __device__ inline int align16(int x) { return (x + 15) & ~15; }

// threads per row: the least power of two in [1, THREADS] whose groups
// of g agents cover s + 3 (the row's first group may start up to three
// agents early, to align the uniforms)
__host__ __device__ inline int threads_per_row(int s, int g) {
  int tpr = 1;
  while (tpr < THREADS && g * tpr < s + 3) tpr *= 2;
  return tpr;
}

// shared bytes of a row's halo: its width, the 0-15 byte offset that keeps
// it aligned with device memory, and one byte read past the end by the
// last agent's slide
__host__ __device__ inline int halo_bytes(int width) {
  return align16(width + 16);
}

// shared bytes of the table of S -> I thresholds p_si · (c / k) for the
// window counts c = 0 .. 2·half (none past TAB_MAX: the kernel divides)
__host__ __device__ inline int table_bytes(int half) {
  return 2 * half + 1 <= TAB_MAX ? align16(4 * (2 * half + 1)) : 0;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

// n bytes from src to shared dst: where both share their offset mod 16,
// 16-byte cp.async for the aligned body and byte copies for the edges;
// otherwise byte copies
__device__ __forceinline__ void copy_bytes(int8_t* dst, const int8_t* src,
                                           int n, int t, int nt) {
  const int off = (int)(reinterpret_cast<uintptr_t>(src) & 15);
  int head = n, body = 0;
  if (off == (int)(reinterpret_cast<uintptr_t>(dst) & 15)) {
    head = min(n, (16 - off) & 15);
    body = (n - head) / 16;
  }
  for (int c = t; c < body; c += nt)
    cp_async16(dst + head + 16 * c, src + head + 16 * c);
  for (int e = t; e < head; e += nt) dst[e] = src[e];
  for (int e = head + 16 * body + t; e < n; e += nt) dst[e] = src[e];
}

template <int G>
__global__ void __launch_bounds__(THREADS)
sir_wave_kernel(const int8_t* __restrict__ states,
                const int32_t* __restrict__ subsets,
                const float* __restrict__ u, int8_t* __restrict__ out,
                int w, int n, int s, int k, float p_si, float p_ir,
                float p_rs) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int half = k / 2;
  const int width = s + 2 * half;
  const int tpr = threads_per_row(s, G);
  const int rows = blockDim.x / tpr;
  const int lr = threadIdx.x / tpr, t = threadIdx.x % tpr;
  const int row = blockIdx.x * rows + lr;
  const bool live = row < w;
  // the thresholds of S -> I by window count, rounded as the reference
  // rounds them: (c / k) to float32, then p_si times it
  const float kf = (float)k;
  float* thr = reinterpret_cast<float*>(smem + (size_t)rows *
                                        halo_bytes(width));
  const bool tab = table_bytes(half) > 0;
  if (tab)
    for (int c = threadIdx.x; c <= 2 * half; c += blockDim.x)
      thr[c] = p_si * ((float)c / kf);

  // agents in groups of G, aligned to the uniforms' 16-byte boundaries:
  // group g holds agents G·g − shift .. G·g − shift + G − 1; a thread
  // takes groups t, t + TPR, ... (one, unless s > G·TPR)
  const long long uoff = (long long)row * s;
  const bool u_al = (reinterpret_cast<uintptr_t>(u) & 15) == 0;
  const bool o_al = (reinterpret_cast<uintptr_t>(out) & 3) == 0;
  const int shift = (int)(uoff & 3);
  float ua[G];
  auto load_u = [&](int a0) {
#pragma unroll
    for (int q = 0; q < G / 4; ++q) {
      const int b = a0 + 4 * q;
      const float* src = u + uoff + b;
      if (u_al && b >= 0 && b + 4 <= s) {
        const float4 x = *reinterpret_cast<const float4*>(src);
        ua[4 * q] = x.x;
        ua[4 * q + 1] = x.y;
        ua[4 * q + 2] = x.z;
        ua[4 * q + 3] = x.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ua[4 * q + e] = b + e >= 0 && b + e < s ? src[e] : 0.f;
      }
    }
  };
  if (live) load_u(G * t - shift);  // in flight while the halo is staged

  long long start = 0;
  if (live) {
    start = (long long)subsets[row] * s - half;
    if (start < 0 || start >= n) {
      start %= n;
      if (start < 0) start += n;
    }
  }
  int8_t* h = reinterpret_cast<int8_t*>(smem + (size_t)lr *
                                        halo_bytes(width) + (start & 15));
  if (live) {
    const int n1 = (int)min((long long)width, (long long)n - start);
    copy_bytes(h, states + start, n1, t, tpr);
    if (n1 < width) copy_bytes(h + n1, states, width - n1, t, tpr);
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();
  if (!live) return;

  int8_t* orow = out + uoff;
  for (int a0 = G * t - shift; a0 < s; a0 += G * tpr) {
    if (a0 != G * t - shift) load_u(a0);
    const int lo = max(a0, 0), hi = min(a0 + G, s);
    int win = 0;  // Σ_{d ≤ 2·half} [h[lo + d] = I]
    for (int d = 0; d <= 2 * half; ++d) win += h[lo + d] == I_;
    int8_t nx[G];
#pragma unroll
    for (int e = 0; e < G; ++e) {
      const int a = a0 + e;
      nx[e] = 0;
      if (a < lo || a >= hi) continue;
      const int8_t cur = h[a + half];
      const int cnt = win - (cur == I_);
      int8_t nxt = cur;
      if (cur == S_ &&
          ua[e] < (tab ? thr[cnt] : p_si * ((float)cnt / kf)))
        nxt = I_;
      else if (cur == I_ && ua[e] < p_ir)
        nxt = R_;
      else if (cur == R_ && ua[e] < p_rs)
        nxt = S_;
      nx[e] = nxt;
      win += (h[a + 2 * half + 1] == I_) - (h[a] == I_);
    }
#pragma unroll
    for (int q = 0; q < G / 4; ++q) {
      const int b = a0 + 4 * q;
      if (o_al && b >= 0 && b + 4 <= s) {
        *reinterpret_cast<uint32_t*>(orow + b) =
            (uint32_t)(uint8_t)nx[4 * q] |
            (uint32_t)(uint8_t)nx[4 * q + 1] << 8 |
            (uint32_t)(uint8_t)nx[4 * q + 2] << 16 |
            (uint32_t)(uint8_t)nx[4 * q + 3] << 24;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (b + e >= 0 && b + e < s) orow[b + e] = nx[4 * q + e];
      }
    }
  }
}

template <int G>
int launch_g(const void* states, const void* subsets, const void* u,
             void* out, int w, int n, int s, int k, float p_si, float p_ir,
             float p_rs, cudaStream_t stream) {
  // rows per CTA: as many as THREADS and the SMEM budget allow (at least
  // one)
  const int tpr = threads_per_row(s, G);
  const int hb = halo_bytes(s + 2 * (k / 2)), tb = table_bytes(k / 2);
  const int rows = max(1, min(THREADS / tpr, (SMEM - tb) / hb));
  const size_t smem = (size_t)rows * hb + tb;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sir_wave_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  sir_wave_kernel<G><<<(w + rows - 1) / rows, rows * tpr, smem, stream>>>(
      (const int8_t*)states, (const int32_t*)subsets, (const float*)u,
      (int8_t*)out, w, n, s, k, p_si, p_ir, p_rs);
  return (int)cudaGetLastError();
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
  const cudaStream_t st = (cudaStream_t)stream;
  if (s >= WIDE_S)
    return launch_g<16>(states, subsets, u, out, w, n, s, k, p_si, p_ir,
                        p_rs, st);
  return launch_g<4>(states, subsets, u, out, w, n, s, k, p_si, p_ir, p_rs,
                     st);
}
