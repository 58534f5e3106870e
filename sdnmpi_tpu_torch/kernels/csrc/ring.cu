// K3: all-gather of row-sharded blocks as one broadcast copy.
//
// Replaces sdnmpi_tpu/kernels/ring.py::_ring_gather_kernel (the Pallas
// body at ring.py:213-283, reached from ring_all_gather through
// _ring_gather_pallas_fn). Every shard ends with the [s*B, C]
// concatenation of all shards' [B, C] blocks.
//
// The Pallas kernel moves the blocks around a double-buffered
// bidirectional ring, because a TPU chip reaches only its ICI neighbours:
// each block is forwarded hop by hop through comm slots guarded by
// semaphores. Every output here is reachable directly, on one card and
// across H100s on NVSwitch alike, so the ring is dropped: the grid runs
// over (source shard q = blockIdx.y, slice of its block = blockIdx.x), and
// each thread reads a unit of block q once and stores it into rows
// q*B.. of every shard's output. No shard waits on another, so there are
// no flags, no comm slots and no cooperative launch.
//
// What bounds it on an H100: bytes. Each block is read once and s copies
// of the [s*B, C] result are written, s*B*C + s*s*B*C elements against
// 3.35 TB/s; this design moves exactly those bytes (the ring replay added
// a comm-slot write and two reads for every forwarded block). Loads and
// stores are the widest unit (16, 8, 4 or 2 bytes) that the block size
// and every pointer allow, so one kernel serves every wire dtype (bf16,
// int16, int32, f32). The outputs go through a pointer table, so a
// launch can store into memory another process owns.
//
// A mesh over several processes (kernels/ring.py, shardplane/mesh.py)
// launches in each process for its own source blocks only (q0 is the
// ring index of the first, grid.y runs over them) and stores into every
// destination shard's output or view, its own or another process's.
// Each process allocates its receive buffers here (ring_ipc_alloc:
// cudaMalloc, not torch's caching allocator, since
// cudaIpcGetMemHandle maps a whole allocation and expandable segments
// cannot be exported) and exports them; a peer opens them once
// (ring_ipc_open) and stores through the mapped pointers. Arrival is an
// interprocess event (ring_ipc_event: cudaEventInterprocess |
// cudaEventDisableTiming) that a process records after each launch;
// after one host barrier per exchange every consumer queues a wait on
// the events of the processes whose sources it reads. The plan of an
// arrival flag per (destination, source) pair raised after a
// system-scope fence was not taken: a consumer would have to spin on
// the flag, and without MPS two processes' kernels on one card run in
// time slices, so a spin can stall for a whole slice; an event wait
// costs the consumer nothing until the data is there, on one card or
// across cards. The same events order a buffer's reuse: a process
// records one before it hands out a receive buffer again, and the
// peers' stores into it wait for that event.
//
// The step form (ring_step_run) lands one ring step at a time, so that a
// consumer can read the blocks that have arrived while the next step is
// in flight (the reference's ring_stream, ring.py:166-195, and one step of
// the Pallas body, ring.py:251-283). Step t >= 1 stores the block of
// source shard q into the view of shard (q + t) % s when t <= s/2 (the cw
// leg) and of shard (q - t) % s when t <= (s-1)/2 (the ccw leg), at rows
// q*B.. of that shard's [s*B, C] view: the arrivals of step t at every
// shard. Step 0 lands each shard's own block in its own view. The host
// plans every step of an exchange once (kernels/ring.py, StepPlan): a
// table of each source's block and its one or two destinations, and the
// path. A launch is then one call.
//
// What bounds a step on an H100: bytes. Each source block is read once
// and stored to each of its destinations once (94,470,144 B for a
// two-leg step at config 13's int16 next-hop wire: 0.0282 ms at 3.35
// TB/s). A register copy (step_copy, kept below as the vector path)
// needed 256 threads a CTA with four 16-byte loads in flight each, and
// reached its plateau only with 128 of the 132 SMs. The bulk path
// (step_bulk) moves the same bytes with Hopper's bulk asynchronous copies
// (TMA), one thread a CTA: the step's bytes, as one flat range over
// (source, offset), are cut into one equal part a CTA (starts on 512
// bytes, so parts do not split DRAM lines); the thread loads its part in
// 48 KB chunks into a ring of four shared-memory stages (cp.async.bulk,
// completion on an mbarrier) and, as each lands, stores it with one bulk
// copy to each destination (a bulk group, evict-first in L2). A stage is
// loaded again once the stores that read it are done reading
// (wait_group.read), so up to three loads and two stores stay in flight
// a CTA with no registers spent on data. Bulk copies take 16-byte
// aligned addresses and sizes: the bulk path takes a step when every
// source and destination address shares one residue mod 16; the bytes
// before the first 16-byte boundary (head) and after the last (tail), at
// most 14 each, are copied as 2-byte words by the CTA's other lanes.
// Otherwise the step takes the vector path, which copies in the widest
// word that every address and the block size allow: 8, 4 or 2 bytes,
// since addresses that allow 16 go bulk. The choice follows alignment
// only. Measured on an H100 80GB HBM3 at 700 W (PERF.md), the bulk path
// reaches about 2.6 TB/s for a step's one read and two writes at 128
// CTAs (77% of the bound), a 16-byte register copy 1-2.5% less; the bulk
// path spends one thread a CTA on it.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kMaxShards = 64;
constexpr int kThreads = 256;
constexpr int kUnitsPerThread = 4;

struct Blocks {
  const void* in[kMaxShards];
  void* out[kMaxShards];
};

// grid.y runs over the launch's sources: p.in[y] is shard q0 + y's block
template <typename U>
__global__ void __launch_bounds__(kThreads)
    broadcast_gather(Blocks p, int s, int q0, long long n) {
  const int q = blockIdx.y;
  const U* in = (const U*)p.in[q];
  const long long base = (long long)(q0 + q) * n;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
    const U x = in[i];
    for (int r = 0; r < s; ++r) {
      ((U*)p.out[r])[base + i] = x;
    }
  }
}

constexpr int kStepUnroll = 4;

// One step's copies: source q's block and its destinations (dst[1][q] is
// null where q has one), each already offset to rows q*B.. of its view.
struct StepTable {
  const char* src[kMaxShards];
  char* dst[2][kMaxShards];
};

// The vector path: a register copy, grid (CTAs per source, s), each
// thread with four units in flight.
template <typename U>
__global__ void __launch_bounds__(kThreads)
    step_copy(StepTable p, long long n) {
  const int q = blockIdx.y;
  const U* __restrict__ in = (const U*)p.src[q];
  U* d0 = (U*)p.dst[0][q];
  U* d1 = (U*)p.dst[1][q];
  const long long stride = (long long)gridDim.x * kThreads;
  long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  for (; i + (kStepUnroll - 1) * stride < n; i += kStepUnroll * stride) {
    U x[kStepUnroll];
#pragma unroll
    for (int k = 0; k < kStepUnroll; ++k) x[k] = in[i + k * stride];
#pragma unroll
    for (int k = 0; k < kStepUnroll; ++k) {
      d0[i + k * stride] = x[k];
      if (d1 != nullptr) d1[i + k * stride] = x[k];
    }
  }
  for (; i < n; i += stride) {
    const U x = in[i];
    d0[i] = x;
    if (d1 != nullptr) d1[i] = x;
  }
}

// The bulk path's shared-memory ring: kStages stages of kChunk bytes
// (kernels/ring.py's BULK_CHUNK), 192 KB, one CTA an SM.
constexpr int kStages = 4;
constexpr int kChunk = 49152;
constexpr int kBulkSmem = kStages * kChunk;
constexpr int kBulkThreads = 32;
// each CTA's part of a step starts on this many bytes
constexpr int kPartAlign = 512;

// CUTLASS's L2 evict-first policy (cute::TMA::CacheHintSm90::EVICT_FIRST)
constexpr uint64_t kEvictFirst = 0x12F0000000000000ull;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bulk_load(void* stage, const char* src, int bytes,
                                          uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(stage)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The views are read by the consumer only after the step, from device
// memory (a 252 MB exchange at config 13 does not stay in the 50 MB L2):
// the stores go evict-first, which keeps the source blocks' lines.
__device__ __forceinline__ void bulk_store(char* dst, const void* stage, int bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint [%0], [%1], %2, %3;\n" ::"l"(
          dst),
      "r"(smem_addr(stage)), "r"(bytes), "l"(kEvictFirst)
      : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// The bulk path: every address of `p` is congruent to the others mod 16.
// Source q's bytes [0, head) and [head + mid, head + mid + tail) go as
// 2-byte words; [head, head + mid) (a multiple of 16) through the stages.
// The s * mid bulk bytes, as one flat range over (source, offset), are
// cut into gridDim.x equal parts that start on kPartAlign bytes, one a
// CTA, which its thread walks in chunks that end at the part's end or the
// source's.
__global__ void __launch_bounds__(kBulkThreads)
    step_bulk(StepTable p, int s, int head, long long mid, int tail) {
  extern __shared__ __align__(128) unsigned char stages[];
  __shared__ __align__(8) uint64_t full[kStages];
  const int lane = threadIdx.x;
  for (int q = blockIdx.x; q < s; q += gridDim.x) {
    long long off = -1;
    if (lane < 7 && 2 * lane < head) off = 2 * lane;
    if (lane >= 8 && lane < 15 && 2 * (lane - 8) < tail) off = head + mid + 2 * (lane - 8);
    if (off >= 0) {
      const unsigned short x = *(const unsigned short*)(p.src[q] + off);
      *(unsigned short*)(p.dst[0][q] + off) = x;
      if (p.dst[1][q] != nullptr) *(unsigned short*)(p.dst[1][q] + off) = x;
    }
  }
  if (lane != 0) return;
  const long long total = (long long)s * mid;
  const long long parts = total / kPartAlign;
  long long next = parts * blockIdx.x / gridDim.x * kPartAlign;  // the next byte to load
  const long long end = blockIdx.x + 1 == gridDim.x
                            ? total
                            : parts * (blockIdx.x + 1) / gridDim.x * kPartAlign;
  if (next >= end) return;
  for (int i = 0; i < kStages; ++i) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(&full[i])),
                 "r"(1)
                 : "memory");
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  // each stage's chunk: its source, offset and size
  int cq[kStages];
  long long coff[kStages];
  int cbytes[kStages];
  auto load = [&](int st) {
    const int q = (int)(next / mid);
    const long long off = next % mid;
    long long bytes = end - next;
    if (bytes > mid - off) bytes = mid - off;
    if (bytes > kChunk) bytes = kChunk;
    cq[st] = q;
    coff[st] = head + off;
    cbytes[st] = (int)bytes;
    bulk_load(stages + st * kChunk, p.src[q] + head + off, (int)bytes, &full[st]);
    next += bytes;
  };
  int loaded = 0;
  while (loaded < kStages && next < end) load(loaded++);
  for (int j = 0; j < loaded; ++j) {
    const int st = j % kStages;
    bar_wait(&full[st], (uint32_t)((j / kStages) & 1));
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    const int q = cq[st];
    bulk_store(p.dst[0][q] + coff[st], stages + st * kChunk, cbytes[st]);
    if (p.dst[1][q] != nullptr) {
      bulk_store(p.dst[1][q] + coff[st], stages + st * kChunk, cbytes[st]);
    }
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    // the stage of chunk j - 1 is free once its stores have read it
    // (every bulk group but the newest): load the next chunk into it
    if (j >= 1 && next < end) {
      asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
      load(loaded++ % kStages);
    }
  }
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

template <typename U>
int launch_copy(const StepTable& p, int s, long long n_units, int grid,
                cudaStream_t stream) {
  step_copy<U><<<dim3(grid, s), kThreads, 0, stream>>>(p, n_units);
  return (int)cudaGetLastError();
}

int launch_bulk(const StepTable& p, int s, int head, long long mid, int tail, int grid,
                cudaStream_t stream) {
  constexpr int kMaxDevices = 64;
  static bool sized[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices || !sized[dev]) {
    err = cudaFuncSetAttribute(step_bulk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kBulkSmem);
    if (err != cudaSuccess) return (int)err;
    if (dev < kMaxDevices) sized[dev] = true;
  }
  step_bulk<<<grid, kBulkThreads, kBulkSmem, stream>>>(p, s, head, mid, tail);
  return (int)cudaGetLastError();
}

template <typename U>
int launch(const Blocks& p, int n_src, int q0, int s, long long n, cudaStream_t stream) {
  const long long want = (n + (long long)kThreads * kUnitsPerThread - 1) /
                         ((long long)kThreads * kUnitsPerThread);
  const int nblk = (int)(want < 1 ? 1 : (want > 65535 ? 65535 : want));
  broadcast_gather<U><<<dim3(nblk, n_src), kThreads, 0, stream>>>(p, s, q0, n);
  return (int)cudaGetLastError();
}

}  // namespace

// in: the n_src blocks of shards q0 .. q0 + n_src - 1 ([n] units each);
// out: s device pointers ([s * n] units each, every shard's output, in
// this process or mapped from another). Returns the CUDA error of the
// launch (0 on success).
extern "C" int ring_launch(const void* const* in, int n_src, int q0, void* const* out,
                           int s, long long n_units, int unit, void* stream) {
  if (s < 2 || s > kMaxShards || n_src < 1 || q0 < 0 || q0 + n_src > s || n_units < 1) {
    return (int)cudaErrorInvalidValue;
  }
  Blocks p;
  for (int i = 0; i < s; ++i) {
    p.in[i] = i < n_src ? in[i] : nullptr;
    p.out[i] = out[i];
  }
  cudaStream_t st = (cudaStream_t)stream;
  switch (unit) {
    case 16: return launch<uint4>(p, n_src, q0, s, n_units, st);
    case 8: return launch<uint2>(p, n_src, q0, s, n_units, st);
    case 4: return launch<unsigned>(p, n_src, q0, s, n_units, st);
    case 2: return launch<unsigned short>(p, n_src, q0, s, n_units, st);
  }
  return (int)cudaErrorInvalidValue;
}

// One ring step as kernels/ring.py's step_args plans it. table: 3 device
// pointers for each of the s sources this process launches for (its block, then its one or two destinations, null
// where it has one). bulk: the bulk path over the bytes [head, head + mid)
// of every copy, with head and tail as 2-byte words; else the vector path
// in `unit`-byte words (8, 4 or 2: addresses that allow 16 go bulk) over
// `nbytes`. grid: CTAs (bulk) or CTAs a source
// (vector). Returns the CUDA error of the launch (0 on success).
extern "C" int ring_step_run(const void* const* table, int s, int bulk,
                             long long nbytes, int unit, int head, long long mid,
                             int tail, int grid, void* stream) {
  if (s < 1 || s > kMaxShards || nbytes < 1 || grid < 1 || grid > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  StepTable p;
  for (int q = 0; q < s; ++q) {
    p.src[q] = (const char*)table[3 * q];
    p.dst[0][q] = (char*)table[3 * q + 1];
    p.dst[1][q] = (char*)table[3 * q + 2];
    if (p.src[q] == nullptr || p.dst[0][q] == nullptr) return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  if (bulk) {
    if (head < 0 || head > 14 || tail < 0 || tail > 14 || mid < 16 || mid % 16 != 0 ||
        head + mid + tail != nbytes) {
      return (int)cudaErrorInvalidValue;
    }
    return launch_bulk(p, s, head, mid, tail, grid, st);
  }
  if (nbytes % unit != 0) return (int)cudaErrorInvalidValue;
  switch (unit) {
    case 8: return launch_copy<uint2>(p, s, nbytes / 8, grid, st);
    case 4: return launch_copy<unsigned>(p, s, nbytes / 4, grid, st);
    case 2: return launch_copy<unsigned short>(p, s, nbytes / 2, grid, st);
  }
  return (int)cudaErrorInvalidValue;
}

// -- across processes ---------------------------------------------------

// A receive buffer of `bytes` that other processes can map: *ptr gets
// the device pointer, `handle` (64 bytes) its cudaIpcMemHandle_t.
extern "C" int ring_ipc_alloc(long long bytes, void** ptr, void* handle) {
  if (bytes < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMalloc(ptr, (size_t)bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaIpcGetMemHandle((cudaIpcMemHandle_t*)handle, *ptr);
  if (err != cudaSuccess) {
    cudaFree(*ptr);
    *ptr = nullptr;
  }
  return (int)err;
}

extern "C" int ring_ipc_free(void* ptr) { return (int)cudaFree(ptr); }

// Map another process's receive buffer from its 64-byte handle.
extern "C" int ring_ipc_open(const void* handle, void** ptr) {
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof h);
  return (int)cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess);
}

extern "C" int ring_ipc_close(void* ptr) { return (int)cudaIpcCloseMemHandle(ptr); }

// An arrival event other processes can wait on: *event gets the event,
// `handle` (64 bytes) its cudaIpcEventHandle_t.
extern "C" int ring_ipc_event(void** event, void* handle) {
  cudaEvent_t ev;
  cudaError_t err =
      cudaEventCreateWithFlags(&ev, cudaEventInterprocess | cudaEventDisableTiming);
  if (err != cudaSuccess) return (int)err;
  err = cudaIpcGetEventHandle((cudaIpcEventHandle_t*)handle, ev);
  if (err != cudaSuccess) {
    cudaEventDestroy(ev);
    return (int)err;
  }
  *event = (void*)ev;
  return 0;
}

// Open another process's arrival event from its 64-byte handle.
extern "C" int ring_ipc_open_event(const void* handle, void** event) {
  cudaIpcEventHandle_t h;
  memcpy(&h, handle, sizeof h);
  cudaEvent_t ev;
  cudaError_t err = cudaIpcOpenEventHandle(&ev, h);
  if (err == cudaSuccess) *event = (void*)ev;
  return (int)err;
}

extern "C" int ring_event_record(void* event, void* stream) {
  return (int)cudaEventRecord((cudaEvent_t)event, (cudaStream_t)stream);
}

// `stream` waits for the last record of `event` queued before this call.
extern "C" int ring_stream_wait(void* stream, void* event) {
  return (int)cudaStreamWaitEvent((cudaStream_t)stream, (cudaEvent_t)event, 0);
}

extern "C" int ring_event_destroy(void* event) {
  return (int)cudaEventDestroy((cudaEvent_t)event);
}
