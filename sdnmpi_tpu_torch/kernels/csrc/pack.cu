// S2: the greedy phase packer, a dataflow kernel of one block.
//
// Replaces sdnmpi_tpu/sched/phases.py::_pack_greedy_device (:126). That is
// not a Pallas kernel: it is a jitted XLA program, one lax.scan step per
// traffic group. This kernel computes the function of the port's plain
// version (sched/phases.py::_pack_greedy_plain) and of its numpy twin
// pack_phases_host bit for bit. For each group row in the given order
// (heaviest first, stable):
//   cost[k] = max(util_out[s] + out[k, s], util_in[d] + in[k, d])
//   ph      = the first k of least cost
// then out[ph, s] and in[ph, d] each take one float32 add of the row's
// weight. A row with s < 0 adds nothing and gets -1. Compiled without
// fast-math: the adds and the max round as numpy's do.
//
// What bounds it on an H100: a chain of dependent steps, not bytes. But
// the chain is not the G rows in order. Row i reads and writes only the
// column out[:, s_i] and the column in[:, d_i], so it depends only on the
// earlier rows that share its source or its destination. At config 12
// (4,096 rows) the longest such chain is 126 rows and 64 rows are ready
// at once. The bytes (the rows and the background, read once; the phases
// written once) take microseconds.
//
// What the design does about it: rows on different switches run at once.
// One block of 32 warps does, in one launch:
//   1. Turns. Each live row gets its turn in its in column: the number of
//      earlier live rows with the same d. Up to 32 warps rank one segment
//      of the rows each, 32 rows at a time (__match_any_sync groups a
//      chunk's equal columns, a popcount of the lower lanes ranks them, a
//      count row per segment carries over the chunks); a prefix sum over
//      the segments' count rows then gives every row its global turn. The
//      count table takes the shared memory that the dataflow uses later
//      (at config 12, 32 segments of 128 rows; one segment in the device
//      buffer where a count row does not fit 227 KB). The rows are dealt
//      to the warps by source: the sources present, ranked in index order
//      (a block-wide prefix sum), go round the 32 warps, so config 12's 64
//      sources take two a warp (s mod 32 would put them on 16 warps).
//      Each warp gets a mask per 32-row chunk of the rows it takes.
//   2. Dataflow. Each warp takes its rows in increasing order. A source's
//      rows never leave its warp, so the out column needs no turnstile:
//      the warp reads it before it waits. Before a row the warp waits
//      until the turnstile of the row's in column equals its turn
//      (block-scope acquire); it then scores as the single warp of the
//      first port did: lane k scores phase k (K <= 32) on order-preserving
//      unsigned keys, __reduce_min_sync takes the least and the lowest bit
//      of a __ballot_sync of the lanes that hold it gives the first
//      minimum. The chosen lane adds the weight to the two loads it read
//      and passes the turnstile on (block-scope release). A warp stages
//      its chunk's rows in shared memory (two 16-byte broadcasts a row)
//      and loads its next chunk's rows meanwhile.
// Why it is exact: each state cell is written only by rows of its own
// column, in row order, and each row reads its two columns after every
// earlier row of those columns has written and before any later one
// does. So every add and comparison sees the operands of the sequential
// scan, in any interleaving the turnstiles admit.
// Why it cannot hang: every warp is in the one resident block and takes
// its rows in increasing order, so the smallest unfinished row is the
// row its warp is at, and all its predecessors are done.
// Placement (chosen by the wrapper from K and V alone): 32 KB of row
// records, then the [V] int32 turnstiles and the [K, 2V] float32 state in
// shared memory when both fit the rest of 227 KB (11,520 bytes at config
// 12), else the turnstiles alone (4 V bytes), else neither; what does not
// fit is in the wrapper's device buffer.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxPhases = 32;
constexpr int kWarps = 32;
constexpr int kThreads = 32 * kWarps;
// shared memory one block may take on an H100 (227 KB)
constexpr int kSharedBytes = 232448;
// each warp's records of its current chunk's rows, 32 bytes a row
constexpr int kStageBytes = kWarps * 32 * 32;
// a waiting warp's sleep between two polls of a turnstile
constexpr unsigned kPollSleepNs = 20;

// where the turnstiles and the state live (sched/phases.py::pack_placement)
enum Placement { kAllShared = 0, kTurnsShared = 1, kNoneShared = 2 };

// an unsigned key in the order of the float32 value (+0 and -0 alike)
__device__ __forceinline__ unsigned order_key(float x) {
  const unsigned b = __float_as_uint(x == 0.0f ? 0.0f : x);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ unsigned lanes_below(int lane) {
  return (1u << lane) - 1u;
}

// Segment j's turns (warp j): the live rows of [lo, hi) ranked by in
// column, 32 at a time: __match_any_sync groups a chunk's equal columns,
// a popcount of the lower lanes ranks them, and the segment's count row
// carries over the chunks. Each row's source is marked present.
__device__ void rank_segment(const int* __restrict__ src, const int* __restrict__ dst,
                             int lo, int hi, int v, int* count, int* turn_of,
                             int* present, int lane) {
  for (int b = lo; b < hi; b += 32) {
    const int i = b + lane;
    const int s = i < hi ? src[i] : -1;
    const bool live = s >= 0;
    const int d = live ? max(dst[i], 0) : v + lane;  // dead lanes: unique keys
    const unsigned same = __match_any_sync(kFull, d);
    const int base = live ? count[d] : 0;
    __syncwarp();  // every lane's count read before the write
    if (live) {
      turn_of[i] = base + __popc(same & lanes_below(lane));
      if (lane == __ffs(same) - 1) count[d] = base + __popc(same);
      present[s] = 1;
    }
    __syncwarp();
  }
}

// In place exclusive prefix sum of a[0, n) by the whole block; sums: 32
// ints of scratch.
__device__ void block_scan(int* a, int n, int* sums) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int per = (n + kThreads - 1) / kThreads;
  const int lo = min(n, (int)threadIdx.x * per);
  const int hi = min(n, lo + per);
  int total = 0;
  for (int j = lo; j < hi; ++j) total += a[j];
  int run = total;  // inclusive scan of the threads' totals in the warp
  for (int o = 1; o < 32; o <<= 1) {
    const int x = __shfl_up_sync(kFull, run, o);
    if (lane >= o) run += x;
  }
  if (lane == 31) sums[warp] = run;
  __syncthreads();
  if (warp == 0) {
    int w = sums[lane];
    for (int o = 1; o < 32; o <<= 1) {
      const int x = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += x;
    }
    sums[lane] = w;
  }
  __syncthreads();
  run += (warp > 0 ? sums[warp - 1] : 0) - total;
  for (int j = lo; j < hi; ++j) {
    const int x = a[j];
    a[j] = run;
    run += x;
  }
}

// The turnstiles are polled with volatile loads and passed with volatile
// stores, ordered by __threadfence_block (block-scope acquire and
// release): faster on an H100, in A/B builds, than ld.acquire polls or
// cuda::atomic_ref's loads and stores. A waiting warp sleeps kPollSleepNs
// between polls, so that its loads do not queue before the working warps'
// shared memory traffic.
__device__ __forceinline__ void wait_turn(const int* turnstile, int turn) {
  while (*(const volatile int*)turnstile != turn) {
    __nanosleep(kPollSleepNs);
  }
  __threadfence_block();
}

__device__ __forceinline__ void pass_turn(int* turnstile, int next) {
  __threadfence_block();
  *(volatile int*)turnstile = next;
}

// A warp's walk over the chunks that hold rows it takes, 32 chunk masks a
// load: lane l holds the mask of chunk base + l.
struct Chunks {
  const unsigned* masks;
  int n_chunks, warp, lane, base;
  unsigned word, left;

  __device__ void load() {
    const int c = base + lane;
    word = c < n_chunks ? masks[(size_t)c * 32 + warp] : 0u;
    left = __ballot_sync(kFull, word != 0u);
  }
  // the next chunk with rows of this warp (-1: none left) and its rows
  __device__ int next(unsigned& rows) {
    while (left == 0u) {
      base += 32;
      if (base >= n_chunks) return -1;
      load();
    }
    const int c = __ffs(left) - 1;
    left &= left - 1;
    rows = __shfl_sync(kFull, word, c);
    return base + c;
  }
};

// one row's record: int4 {s, d, turn, 0}, float4 {w, util_out[s],
// util_in[d], 0}; a lane holds its chunk row's, then stages it in shared
// memory, where every lane reads it in two 16-byte broadcasts
struct Row {
  int4 cols;
  float4 vals;
};

__device__ __forceinline__ Row load_row(const int* __restrict__ src,
                                        const int* __restrict__ dst,
                                        const float* __restrict__ w,
                                        const float* __restrict__ util_out,
                                        const float* __restrict__ util_in,
                                        const int* turn_of, int chunk, unsigned rows,
                                        int lane) {
  Row r{make_int4(0, 0, 0, 0), make_float4(0.0f, 0.0f, 0.0f, 0.0f)};
  if (chunk >= 0 && (rows >> lane & 1u)) {
    const int i = chunk * 32 + lane;
    const int s = src[i];
    const int d = dst[i] < 0 ? 0 : dst[i];
    r.cols = make_int4(s, d, turn_of[i], 0);
    r.vals = make_float4(w[i], util_out[s], util_in[d], 0.0f);
  }
  return r;
}

template <bool kResident>
__global__ void __launch_bounds__(kThreads, 1)
    pack_dataflow(const int* __restrict__ src, const int* __restrict__ dst,
                  const float* __restrict__ w, const float* __restrict__ util_out,
                  const float* __restrict__ util_in, int g, int v, int k,
                  int placement, int turns_only, int* work, int* __restrict__ out) {
  extern __shared__ __align__(16) int smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_chunks = (g + 31) / 32;
  int* turn_of = work;
  unsigned* masks = reinterpret_cast<unsigned*>(work + g);
  int* rank = work + g + (size_t)n_chunks * 32;
  int* rest = rank + 2 * (size_t)v;  // after the ranks and a spill count row

  // 1. turns, in parallel steps. The count table ([segments][V], one row a
  // segment) takes shared memory, 32 segments where they fit, else one
  // row in the work buffer.
  int* sums = smem;
  const int table_room = (kSharedBytes - 128) / (4 * v);
  const int n_seg = table_room > 0 ? min(kWarps, table_room) : 1;
  int* table = table_room > 0 ? smem + 32 : rank + v;
  const int seg_len = ((g + n_seg - 1) / n_seg + 31) / 32 * 32;
  for (size_t j = threadIdx.x; j < (size_t)n_seg * v; j += kThreads) table[j] = 0;
  for (int j = threadIdx.x; j < v; j += kThreads) rank[j] = 0;
  __syncthreads();
  // (a) each segment's turns and counts; the sources present
  if (warp < n_seg) {
    rank_segment(src, dst, warp * seg_len, min(g, (warp + 1) * seg_len), v,
                 table + (size_t)warp * v, turn_of, rank, lane);
  }
  __syncthreads();
  // (b) each column's counts become the rows before each segment; the
  // present sources' ranks in index order
  for (int c = threadIdx.x; c < v; c += kThreads) {
    int run = 0;
    for (int j = 0; j < n_seg; ++j) {
      const int t = table[(size_t)j * v + c];
      table[(size_t)j * v + c] = run;
      run += t;
    }
  }
  block_scan(rank, v, sums);
  __syncthreads();
  // (c) each row's turn; its warp, the owner of its source: the source's
  // rank mod 32. For chunk c and warp o, masks[32 c + o] holds the bits of
  // the chunk's rows that warp o takes.
  for (int i = threadIdx.x; i < g; i += kThreads) {
    if (src[i] < 0) {
      out[i] = -1;
    } else {
      turn_of[i] += table[(size_t)(i / seg_len) * v + max(dst[i], 0)];
    }
  }
  for (int c = warp; c < n_chunks; c += kWarps) {
    const int i = c * 32 + lane;
    const int s = i < g ? src[i] : -1;
    const int owner = s >= 0 ? rank[s] % kWarps : kWarps + lane;
    unsigned* word = masks + (size_t)c * 32;
    word[lane] = 0u;
    const unsigned mates = __match_any_sync(kFull, owner);
    __syncwarp();  // the zeroed words before the owners' masks
    if (s >= 0 && lane == __ffs(mates) - 1) word[owner] = mates;
  }
  if (turns_only) return;  // the first step alone, for its time
  __syncthreads();
  // (d) the dataflow's shared memory: its row records, the turnstiles at
  // 0 and the state at 0.0
  Row* stage = reinterpret_cast<Row*>(smem) + warp * 32;
  int* shared = smem + kStageBytes / 4;
  int* turn;
  float* state;
  if (kResident) {
    turn = shared;
    state = reinterpret_cast<float*>(shared + v);
  } else {
    turn = placement == kTurnsShared ? shared : rest;
    state = reinterpret_cast<float*>(placement == kTurnsShared ? rest : rest + v);
  }
  const int row_len = 2 * v;
  for (int j = threadIdx.x; j < v; j += kThreads) turn[j] = 0;
  for (size_t j = threadIdx.x; j < (size_t)k * row_len; j += kThreads) state[j] = 0.0f;
  __syncthreads();

  // 2. dataflow: this warp's rows in order, the next chunk's loaded ahead
  float* mine = state + (size_t)(lane < k ? lane : 0) * row_len;
  Chunks chunks{masks, n_chunks, warp, lane, 0, 0u, 0u};
  chunks.load();
  unsigned rows = 0u;
  int chunk = chunks.next(rows);
  Row cur = load_row(src, dst, w, util_out, util_in, turn_of, chunk, rows, lane);
  while (chunk >= 0) {
    unsigned next_rows = 0u;
    const int next_chunk = chunks.next(next_rows);
    const Row next =
        load_row(src, dst, w, util_out, util_in, turn_of, next_chunk, next_rows, lane);
    stage[lane] = cur;  // the last chunk's rows were all read before
    __syncwarp();
    for (unsigned todo = rows; todo != 0u; todo &= todo - 1) {
      const int r = __ffs(todo) - 1;
      const int4 c = stage[r].cols;  // s, d, turn
      const float4 x = stage[r].vals;  // w, util_out[s], util_in[d]
      float load_out = 0.0f, load_in = 0.0f;
      // this warp alone writes the out column: read it before the wait
      if (lane < k) load_out = mine[c.x];
      wait_turn(turn + c.y, c.z);
      unsigned key = 0xffffffffu;
      if (lane < k) {
        load_in = mine[v + c.y];
        key = order_key(fmaxf(x.y + load_out, x.z + load_in));
      }
      const unsigned least = __reduce_min_sync(kFull, key);
      const int ph = __ffs(__ballot_sync(kFull, key == least)) - 1;
      __syncwarp();  // every lane's reads before the chosen lane's writes
      if (lane == ph) {
        mine[c.x] = load_out + x.x;
        mine[v + c.y] = load_in + x.x;
        pass_turn(turn + c.y, c.z + 1);
        out[chunk * 32 + r] = ph;
      }
      __syncwarp();  // the writes before this warp's next reads
    }
    chunk = next_chunk;
    rows = next_rows;
    cur = next;
  }
}

template <bool kResident>
int launch(const int* src, const int* dst, const float* w, const float* util_out,
           const float* util_in, int g, int v, int k, int placement, int turns_only,
           int* work, int* out, cudaStream_t stream) {
  auto kernel = pack_dataflow<kResident>;
  static unsigned raised = 0u;  // the devices (bit d) whose limit is raised
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device >= 32 || !(raised >> device & 1u)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSharedBytes);
    if (err != cudaSuccess) return (int)err;
    if (device < 32) raised |= 1u << device;
  }
  // the first step's count table takes what the dataflow leaves free
  kernel<<<1, kThreads, kSharedBytes, stream>>>(src, dst, w, util_out, util_in, g, v,
                                                k, placement, turns_only, work, out);
  return (int)cudaGetLastError();
}

int run(const int* src, const int* dst, const float* w, const float* util_out,
        const float* util_in, int g, int v, int k, int placement, int turns_only,
        int* work, int* out, void* stream) {
  if (g < 1 || v < 1 || k < 1 || k > kMaxPhases || work == nullptr ||
      placement < kAllShared || placement > kNoneShared) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t turns = (size_t)v * sizeof(int);
  const size_t state = (size_t)k * 2 * v * sizeof(float);
  const size_t dataflow = kStageBytes + (placement == kAllShared     ? turns + state
                                         : placement == kTurnsShared ? turns
                                                                     : 0);
  if (dataflow > (size_t)kSharedBytes) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return placement == kAllShared
             ? launch<true>(src, dst, w, util_out, util_in, g, v, k, placement,
                            turns_only, work, out, s)
             : launch<false>(src, dst, w, util_out, util_in, g, v, k, placement,
                             turns_only, work, out, s);
}

}  // namespace

// work: an int32 device buffer of G words (the rows' turns), 32 words a
// 32-row chunk (the warps' row masks), 2V words (the sources' ranks and a
// count row where shared memory has no room for one), then the
// turnstiles (V words) unless placement puts them in shared memory, then
// the [K, 2V] float32 state unless placement puts it there too. Nothing
// needs zeroing.
extern "C" int pack_launch(const int* src, const int* dst, const float* w,
                           const float* util_out, const float* util_in, int g,
                           int v, int k, int placement, int* work, int* out,
                           void* stream) {
  return run(src, dst, w, util_out, util_in, g, v, k, placement, 0, work, out, stream);
}

// The same launch stopped after the turns and the deal (step 1), to time
// that step: out holds -1 at the dead rows only.
extern "C" int pack_turns_launch(const int* src, const int* dst, const float* w,
                                 const float* util_out, const float* util_in, int g,
                                 int v, int k, int placement, int* work, int* out,
                                 void* stream) {
  return run(src, dst, w, util_out, util_in, g, v, k, placement, 1, work, out, stream);
}
