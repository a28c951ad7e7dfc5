// Conflict kernels over task id footprints — Hopper (sm_90a).
//
// Two entry points share one kernel (conflict_join_kernel below), as the
// TPU kernels share _hazard_tile:
//
//   conflict_matrix  replaces src/repro/kernels/conflict/conflict.py
//                    conflict_matrix_pallas (pallas_call at :150; _kernel
//                    :87). The [W, W] prefix-conflict matrix of one window:
//                    C[i, j] = 1 iff j < i, valid[i], valid[j] and hazard.
//   conflict_block   replaces conflict_block_pallas (pallas_call at :219;
//                    _block_kernel :162). The [Wi, Wj] cross-window block:
//                    row i is a task of the later window, column j a task
//                    of the earlier one, so every j precedes every i and
//                    there is no triangle: C[i, j] = 1 iff valid_i[i],
//                    valid_j[j] and hazard. The two sides carry their own
//                    slot counts (nr_i, nw_i) and (nr_j, nw_j).
//
// hazard(i, j): later task i conflicts with earlier task j iff
//   flow   W_j ∩ R_i ≠ ∅                  (always; the paper's record rule)
//   output W_j ∩ W_i ≠ ∅, anti W_i ∩ R_j ≠ ∅   (strict closure)
// Ids < 0 are unused slots. Output is one byte per cell (torch.bool).
//
// What bounds them on this card: bytes. The output's Wi·Wj bytes (16.8 MB
// at W = 4096) dominate at narrow footprints; at wide ones (SIS on a hub
// graph pads every row to 1 + max degree slots, 3,057 at 50 MB a side) the
// id bytes, read once, come on top. Almost every cell is 0, and a cell is
// 1 only where two tasks share an id: the work past the bytes is the
// matches, not the W² pairs of slots.
//
// Design: the TPU kernels compare every pair of cells' slots in VMEM
// tiles; here the hazard is a join on the ids, as ref.py's plain version
// computes it. One cooperative launch, grid-stride throughout, in three
// phases separated by grid barriers:
//   1. clear the hash tables;
//   2. insert every used write slot of a valid task into its side's table
//      (the column side's, for the flow and output hazards; the block's
//      row side's too, under the strict rule, for the anti hazard; the
//      prefix matrix's two sides are one window and share one table),
//      then zero-fill the output with 16-byte stores (a byte at a time
//      only at a misaligned head and the ragged tail), so every output
//      byte is written once;
//   3. probe: each used read or write slot of a valid task enumerates the
//      tasks of the other side's table that write its id and stores a 1
//      in each cell it finds (stores of 1 race only with each other).
// The barrier after phase 1 makes the tables empty before any insert; the
// one after phase 2 makes them complete before any probe, and orders every
// zero before any one.
//
// A table maps an id to the tasks that write it, duplicates included (a
// chain window writes one id W times): buckets of GROUP consecutive ranks
// of one id, open-addressed with linear probing. Each table holds `slots`
// (a power of two >= 8 x the side's write slots, sized by the binding) of
//   key[s]    u64  (id << 32) | g: bucket g of id, ranks [GROUP·g, GROUP·g
//                  + GROUP) of its entries;
//   task[s]   GROUP int32 task indices (-1 past the id's last rank);
//   count[s]  u32  bucket 0's slot counts the id's entries: each insert
//                  takes its rank there, in the slot it found or claimed.
// Past the bytes, every phase is latency-bound: a thread's chain of
// dependent loads and atomics sets its time, and the slowest thread the
// phase's. So the tables are at most 1/8 full, which keeps the longest
// linear-probing walk short; an insert is one walk and one atomic unless
// its id has more than GROUP entries, and duplicate ids fill their buckets
// GROUP at a time instead of walking one cluster; a probe looks up the
// buckets (id, 0), (id, 1), ..., each bucket's tasks loaded beside its
// key, until a bucket is missing or ends in -1, so an id no task writes —
// most of them — costs one lookup; and where an id has many buckets (a
// chain, hot ids), each probe runs as up to one copy per bucket of the
// largest id (`top`), copy r taking buckets r, r + copies, ..., so its
// lookups spread over the grid instead of queueing on one thread. Slots
// past the used ones cost one read and nothing else, so every footprint
// width takes the same path. The flat index is spread warp by warp over
// the CTAs, so the few thousand write slots of a window reach every SM.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 1024;
constexpr int GROUP = 8;  // ranks of one id per bucket (one 32-byte sector)
constexpr unsigned long long EMPTY = ~0ull;  // ids < 2^31: no key's high word

struct Table {
  unsigned long long* key;  // [slots]
  int32_t* task;            // [slots][GROUP]
  unsigned* count;          // [slots]
  unsigned* top;            // the largest rank past bucket 0 (0: none)
  unsigned long long mask;  // slots - 1
};

struct Args {
  const int32_t* reads_i;
  const int32_t* writes_i;
  const int32_t* reads_j;
  const int32_t* writes_j;
  const uint8_t* valid_i;
  const uint8_t* valid_j;
  uint8_t* out;
  Table tj;  // writes of the column side (earlier tasks)
  Table ti;  // writes of the row side: the block's anti hazard, strict only
  int wi, wj, nr_i, nw_i, nr_j, nw_j;
  int strict, prefix;
};

__device__ __forceinline__ unsigned long long hash(unsigned long long k) {
  k ^= k >> 33;  // MurmurHash3's 64-bit finaliser
  k *= 0xff51afd7ed558ccdull;
  k ^= k >> 33;
  k *= 0xc4ceb9fe1a85ec53ull;
  return k ^ (k >> 33);
}

__device__ __forceinline__ unsigned long long id_key(int32_t x) {
  return (unsigned long long)(uint32_t)x << 32;
}

__device__ void clear(const Table& t, long long tid, long long stride) {
  const long long slots = (long long)t.mask + 1;
  if (tid == 0) *t.top = 0;
  for (long long s = tid; s < slots; s += stride) {
    t.key[s] = EMPTY;
    t.count[s] = 0;
  }
  int4* task = (int4*)t.task;
  for (long long s = tid; s < slots * (GROUP / 4); s += stride)
    task[s] = make_int4(-1, -1, -1, -1);
}

__device__ void zero_fill(uint8_t* out, size_t n, long long tid,
                          long long stride) {
  size_t head = (16 - ((uintptr_t)out & 15)) & 15;
  if (head > n) head = n;
  const size_t body = (n - head) / 16;
  if (tid < (long long)head) out[tid] = 0;
  int4* vec = (int4*)(out + head);
  for (long long e = tid; e < (long long)body; e += stride)
    vec[e] = make_int4(0, 0, 0, 0);
  for (size_t e = head + body * 16 + tid; e < n; e += stride) out[e] = 0;
}

// The slot of bucket `want`: found, or claimed where the walk meets a free
// slot first.
__device__ __forceinline__ unsigned long long claim(const Table& t,
                                                    unsigned long long want) {
  unsigned long long s = hash(want) & t.mask;
  for (;;) {
    const unsigned long long old = atomicCAS(t.key + s, EMPTY, want);
    if (old == EMPTY || old == want) return s;
    s = (s + 1) & t.mask;
  }
}

// Enter task `task`, which writes id x, into table t.
__device__ void insert(const Table& t, int32_t x, int task) {
  const unsigned long long id = id_key(x);
  unsigned long long s = claim(t, id);  // bucket 0 holds the id's count
  const unsigned rank = atomicAdd(t.count + s, 1u);
  if (rank >= GROUP) {
    atomicMax(t.top, rank);
    s = claim(t, id | (rank / GROUP));
  }
  t.task[s * GROUP + rank % GROUP] = task;
}

// Call emit(task) for every entry of id x in the buckets r, r + reps, ...
// of table t. Only after the grid barrier that completes the table, which
// makes its lines visible to ordinary loads: probes of one id on one SM
// (a chain's) then hit L1.
template <typename Emit>
__device__ __forceinline__ void matches(const Table& t, int32_t x,
                                        unsigned r, unsigned reps,
                                        Emit emit) {
  const unsigned long long id = id_key(x);
  for (unsigned g = r;; g += reps) {
    const unsigned long long want = id | g;
    unsigned long long s = hash(want) & t.mask;
    int4 lo, hi;
    for (;;) {  // the bucket's tasks are loaded beside its key
      const unsigned long long k = t.key[s];
      const int4* task = (const int4*)(t.task + s * GROUP);
      lo = task[0];
      hi = task[1];
      if (k == want) break;
      if (k == EMPTY) return;
      s = (s + 1) & t.mask;
    }
#pragma unroll 1
    for (int q = 0; q < GROUP; ++q) {  // the bucket's tasks, rotated out
      const int task = lo.x;
      if (task < 0) return;
      emit(task);
      lo = make_int4(lo.y, lo.z, lo.w, hi.x);
      hi = make_int4(hi.y, hi.z, hi.w, -1);
    }
  }
}

__device__ __forceinline__ long long quotient(long long e, long long d,
                                              bool narrow) {
  return narrow ? (unsigned)e / (unsigned)d : e / d;
}

// Call f(row, x, r) for every used slot (x >= 0) of ids [rows, per_row]
// and every r < reps: each slot's `reps` copies share its work. Grid-
// stride, four loads in flight per thread, and one copy of f (the code of
// a phase that runs once is fetched once).
template <typename F>
__device__ __forceinline__ void for_used(const int32_t* ids, int rows,
                                         int per_row, unsigned reps,
                                         long long tid, long long stride,
                                         F f) {
  const long long n = (long long)rows * per_row, total = n * reps;
  const bool narrow = total <= 0xffffffffll;
  for (long long v0 = tid; v0 < total; v0 += 4 * stride) {
    int32_t x[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const long long v = v0 + u * stride;
      x[u] = v >= total ? -1
             : __ldg(ids + (reps == 1 ? v : v - quotient(v, n, narrow) * n));
    }
#pragma unroll 1
    for (int u = 0; u < 4; ++u) {
      if (x[0] >= 0) {
        const long long v = v0 + u * stride;
        const long long r = reps == 1 ? 0 : quotient(v, n, narrow);
        f((int)quotient(v - r * n, per_row, narrow), x[0], (unsigned)r);
      }
      x[0] = x[1];
      x[1] = x[2];
      x[2] = x[3];
    }
  }
}

// The copies of each probe of table t among `rows` x `per_row` slots: one
// while no id has more than one bucket, else up to one per bucket of the
// largest id, as far as the grid's threads go.
__device__ __forceinline__ unsigned copies(const Table& t, int rows,
                                           int per_row, long long stride) {
  const long long buckets = *t.top / GROUP + 1;
  const long long spare = stride / ((long long)rows * per_row);
  return (unsigned)max(1ll, min(buckets, spare));
}

// Call emit(row, task) for every used slot of ids [rows, per_row] of a
// valid row and every task of table t that writes the slot's id.
template <typename Emit>
__device__ __forceinline__ void probe(const int32_t* ids, int rows,
                                      int per_row, const uint8_t* valid,
                                      const Table& t, long long tid,
                                      long long stride, Emit emit) {
  const unsigned reps = copies(t, rows, per_row, stride);
  for_used(ids, rows, per_row, reps, tid, stride,
           [&](int row, int32_t x, unsigned r) {
             if (valid[row])
               matches(t, x, r, reps, [&](int task) { emit(row, task); });
           });
}

__global__ void __launch_bounds__(THREADS)
conflict_join_kernel(const __grid_constant__ Args a) {
  cg::grid_group grid = cg::this_grid();
  // consecutive warps of the flat index lie in consecutive CTAs
  const long long tid =
      ((long long)(threadIdx.x >> 5) * gridDim.x + blockIdx.x) * 32 +
      (threadIdx.x & 31);
  const long long stride = (long long)gridDim.x * THREADS;
  const size_t wj = (size_t)a.wj;
  uint8_t* out = a.out;
  const bool row_table = !a.prefix && a.strict;

  // 1. cleared tables
  clear(a.tj, tid, stride);
  if (row_table) clear(a.ti, tid, stride);
  grid.sync();

  // 2. the tables, each used write slot of a valid task; then the zeros,
  // whose stores fill the gaps of the inserts' atomics
  for_used(a.writes_j, a.wj, a.nw_j, 1, tid, stride,
           [&](int j, int32_t x, unsigned) {
             if (a.valid_j[j]) insert(a.tj, x, j);
           });
  if (row_table)
    for_used(a.writes_i, a.wi, a.nw_i, 1, tid, stride,
             [&](int i, int32_t x, unsigned) {
               if (a.valid_i[i]) insert(a.ti, x, i);
             });
  zero_fill(out, (size_t)a.wi * wj, tid, stride);
  grid.sync();

  // 3. the probes
  if (a.prefix) {
    // row i's read x meets task j's write of x: flow if j < i; under the
    // strict rule anti if j > i (later j writes what earlier i read)
    probe(a.reads_i, a.wi, a.nr_i, a.valid_i, a.tj, tid, stride,
          [&](int i, int j) {
            if (j < i) out[i * wj + j] = 1;
            else if (a.strict && j > i) out[j * wj + i] = 1;
          });
    if (a.strict)  // output: row i's write meets an earlier write of its id
      probe(a.writes_i, a.wi, a.nw_i, a.valid_i, a.tj, tid, stride,
            [&](int i, int j) {
              if (j < i) out[i * wj + j] = 1;
            });
    return;
  }
  // the block: every column task precedes every row task
  probe(a.reads_i, a.wi, a.nr_i, a.valid_i, a.tj, tid, stride,
        [&](int i, int j) { out[i * wj + j] = 1; });  // flow
  if (!a.strict) return;
  probe(a.writes_i, a.wi, a.nw_i, a.valid_i, a.tj, tid, stride,
        [&](int i, int j) { out[i * wj + j] = 1; });  // output
  probe(a.reads_j, a.wj, a.nr_j, a.valid_j, a.ti, tid, stride,
        [&](int j, int i) { out[i * wj + j] = 1; });  // anti
}

// The CTAs resident at once on the last launch's device (the occupancy
// query costs host time on every call).
struct Grid {
  int dev = -1;
  int ctas = 0;
};
thread_local Grid last_grid;

cudaError_t resident_ctas(int* ctas) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (last_grid.dev != dev) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, conflict_join_kernel, THREADS, 0);
    if (e != cudaSuccess) return e;
    last_grid.dev = dev;
    last_grid.ctas = sms * per_sm;
  }
  *ctas = last_grid.ctas;
  return cudaSuccess;
}

// Scratch: a header of SCRATCH_HEADER bytes (each table's `top`), then
// the tables, slots * TABLE_SLOT_BYTES bytes each (the binding sizes
// them).
constexpr size_t SCRATCH_HEADER = 32;
constexpr size_t TABLE_SLOT_BYTES = 8 + 4 * GROUP + 4;

// Table `which` of `slots` at `base` in the scratch at `scratch`: false
// unless slots is a power of two of at least 8 x `entries` and the scratch
// is 32-byte aligned.
bool table_at(Table* t, uint8_t* scratch, int which, size_t offset,
              long long slots, long long entries) {
  if (slots < 8 * entries || slots < 8 || (slots & (slots - 1)) ||
      ((uintptr_t)scratch & 31))
    return false;
  uint8_t* base = scratch + SCRATCH_HEADER + offset;
  t->top = (unsigned*)scratch + which;
  t->key = (unsigned long long*)base;
  t->task = (int32_t*)(t->key + slots);
  t->count = (unsigned*)(t->task + slots * GROUP);
  t->mask = (unsigned long long)slots - 1;
  return true;
}

int launch(Args& a, long long table_slots, void* stream) {
  int grid = 0;
  cudaError_t e = resident_ctas(&grid);
  if (e != cudaSuccess) return (int)e;
  // no more CTAs than the largest phase has work for
  long long work = (long long)a.wi * a.wj / 16;
  const long long clears = table_slots * (GROUP / 4);  // int4 stores
  work = work > clears ? work : clears;
  const long long slots = (long long)a.wi * (a.nr_i + a.nw_i) +
                          (long long)a.wj * (a.nr_j + a.nw_j);
  work = work > slots ? work : slots;
  const long long needed = (work + THREADS - 1) / THREADS;
  if (grid > needed) grid = (int)needed;
  if (grid < 1) return (int)cudaErrorInvalidConfiguration;
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel((const void*)conflict_join_kernel,
                                  dim3(grid), dim3(THREADS), args, 0,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of scratch per table slot and of the scratch's header (the binding
// allocates header + the tables' slots x slot bytes).
extern "C" long long conflict_table_slot_bytes() {
  return (long long)TABLE_SLOT_BYTES;
}
extern "C" long long conflict_scratch_header_bytes() {
  return (long long)SCRATCH_HEADER;
}

// reads [w, nr] int32, writes [w, nw] int32, valid [w] bool, out [w, w]
// bool, scratch: one table of `slots` (a power of two >= 8·w·nw); all
// contiguous on the device, scratch 32-byte aligned. One cooperative
// launch on `stream`; returns the CUDA error (0 = launched).
extern "C" int conflict_matrix_launch(const void* reads, const void* writes,
                                      const void* valid, void* out,
                                      void* scratch, int w, int nr, int nw,
                                      int strict, long long slots,
                                      void* stream) {
  if (w <= 0 || nr <= 0 || nw <= 0) return (int)cudaErrorInvalidValue;
  Args a = {};
  a.reads_i = a.reads_j = (const int32_t*)reads;
  a.writes_i = a.writes_j = (const int32_t*)writes;
  a.valid_i = a.valid_j = (const uint8_t*)valid;
  a.out = (uint8_t*)out;
  a.wi = a.wj = w;
  a.nr_i = a.nr_j = nr;
  a.nw_i = a.nw_j = nw;
  a.strict = strict;
  a.prefix = 1;
  if (!table_at(&a.tj, (uint8_t*)scratch, 0, 0, slots, (long long)w * nw))
    return (int)cudaErrorInvalidValue;
  return launch(a, slots, stream);
}

// reads_i [wi, nr_i], writes_i [wi, nw_i], reads_j [wj, nr_j], writes_j
// [wj, nw_j] int32, valid_i [wi], valid_j [wj] bool, out [wi, wj] bool,
// scratch: the column side's table of slots_j (>= 8·wj·nw_j), then, under
// the strict rule, the row side's of slots_i (>= 8·wi·nw_i; else 0); all
// contiguous on the device, scratch 32-byte aligned. One cooperative
// launch on `stream`; returns the CUDA error (0 = launched).
extern "C" int conflict_block_launch(
    const void* reads_i, const void* writes_i, const void* reads_j,
    const void* writes_j, const void* valid_i, const void* valid_j,
    void* out, void* scratch, int wi, int wj, int nr_i, int nw_i, int nr_j,
    int nw_j, int strict, long long slots_i, long long slots_j,
    void* stream) {
  if (wi <= 0 || wj <= 0 || nr_i <= 0 || nw_i <= 0 || nr_j <= 0 || nw_j <= 0)
    return (int)cudaErrorInvalidValue;
  Args a = {};
  a.reads_i = (const int32_t*)reads_i;
  a.writes_i = (const int32_t*)writes_i;
  a.reads_j = (const int32_t*)reads_j;
  a.writes_j = (const int32_t*)writes_j;
  a.valid_i = (const uint8_t*)valid_i;
  a.valid_j = (const uint8_t*)valid_j;
  a.out = (uint8_t*)out;
  a.wi = wi;
  a.wj = wj;
  a.nr_i = nr_i;
  a.nw_i = nw_i;
  a.nr_j = nr_j;
  a.nw_j = nw_j;
  a.strict = strict;
  a.prefix = 0;
  uint8_t* base = (uint8_t*)scratch;
  if (!table_at(&a.tj, base, 0, 0, slots_j, (long long)wj * nw_j))
    return (int)cudaErrorInvalidValue;
  if (strict && !table_at(&a.ti, base, 1, slots_j * TABLE_SLOT_BYTES,
                          slots_i, (long long)wi * nw_i))
    return (int)cudaErrorInvalidValue;
  return launch(a, slots_j > slots_i ? slots_j : slots_i, stream);
}
