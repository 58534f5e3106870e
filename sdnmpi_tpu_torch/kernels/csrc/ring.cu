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
// launch per card across cards can store through peer pointers over
// NVLink; completion there needs an arrival flag per (destination,
// source) pair raised after a system-scope fence (ROADMAP A12).
//
// The step form (ring_step_launch) lands one ring step at a time, so that
// a consumer can read the blocks that have arrived while the next step
// is in flight (the reference's ring_stream, ring.py:166-195, and one
// step of the Pallas body, ring.py:251-283). Step t >= 1 stores the block
// of source shard q into the view of shard (q + t) % s when t <= s/2 (the
// cw leg) and of shard (q - t) % s when t <= (s-1)/2 (the ccw leg), at
// rows q*B.. of that shard's [s*B, C] view: the arrivals of step t at
// every shard. Step 0 lands each shard's own block in its own view. Each
// source unit is read once and stored to both of its destinations. The
// grid is (ctas / s, s): the caller picks the CTA count, so that the
// copy leaves SMs free for the consumer that runs beside it on another
// stream. It is bound by bytes as the broadcast is; each thread keeps
// four loads in flight so that a small grid still streams.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxShards = 64;
constexpr int kThreads = 256;
constexpr int kUnitsPerThread = 4;

struct Blocks {
  const void* in[kMaxShards];
  void* out[kMaxShards];
};

template <typename U>
__global__ void __launch_bounds__(kThreads)
    broadcast_gather(Blocks p, int s, long long n) {
  const int q = blockIdx.y;
  const U* in = (const U*)p.in[q];
  const long long base = (long long)q * n;
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

template <typename U>
__global__ void __launch_bounds__(kThreads)
    step_copy(Blocks p, int s, long long n, int t, int cw, int ccw) {
  const int q = blockIdx.y;
  const U* __restrict__ in = (const U*)p.in[q];
  U* d0 = nullptr;
  U* d1 = nullptr;
  if (t == 0) {
    d0 = (U*)p.out[q];
  } else {
    if (cw) d0 = (U*)p.out[(q + t) % s];
    if (ccw) d1 = (U*)p.out[(q - t + s) % s];
  }
  if (d0 == nullptr) {
    d0 = d1;
    d1 = nullptr;
  }
  if (d0 == nullptr) return;
  d0 += (long long)q * n;
  if (d1 != nullptr) d1 += (long long)q * n;
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

template <typename U>
int launch_step(const Blocks& p, int s, long long n, int t, int ctas,
                cudaStream_t stream) {
  const int n_cw = s / 2;
  const int n_ccw = (s - 1) / 2;
  const int per = ctas / s < 1 ? 1 : (ctas / s > 65535 ? 65535 : ctas / s);
  step_copy<U><<<dim3(per, s), kThreads, 0, stream>>>(
      p, s, n, t, t <= n_cw ? 1 : 0, t <= n_ccw ? 1 : 0);
  return (int)cudaGetLastError();
}

template <typename U>
int launch(const Blocks& p, int s, long long n, cudaStream_t stream) {
  const long long want = (n + (long long)kThreads * kUnitsPerThread - 1) /
                         ((long long)kThreads * kUnitsPerThread);
  const int nblk = (int)(want < 1 ? 1 : (want > 65535 ? 65535 : want));
  broadcast_gather<U><<<dim3(nblk, s), kThreads, 0, stream>>>(p, s, n);
  return (int)cudaGetLastError();
}

}  // namespace

// in/out: s device pointers each (in: [n] units, out: [s * n] units).
// Returns the CUDA error of the launch (0 on success).
extern "C" int ring_launch(const void* const* in, void* const* out, int s,
                           long long n_units, int unit, void* stream) {
  if (s < 2 || s > kMaxShards || n_units < 1) {
    return (int)cudaErrorInvalidValue;
  }
  Blocks p;
  for (int i = 0; i < s; ++i) {
    p.in[i] = in[i];
    p.out[i] = out[i];
  }
  cudaStream_t st = (cudaStream_t)stream;
  switch (unit) {
    case 16: return launch<uint4>(p, s, n_units, st);
    case 8: return launch<uint2>(p, s, n_units, st);
    case 4: return launch<unsigned>(p, s, n_units, st);
    case 2: return launch<unsigned short>(p, s, n_units, st);
  }
  return (int)cudaErrorInvalidValue;
}

// Step t of the ring (0 <= t <= s/2). in: s device pointers ([n] units
// each, shard q's block); out: s device pointers (shard me's [s * n]-unit
// view). ctas: the CTA count of the launch (at least one per source).
// Returns the CUDA error of the launch (0 on success).
extern "C" int ring_step_launch(const void* const* in, void* const* out, int s,
                                long long n_units, int unit, int t, int ctas,
                                void* stream) {
  if (s < 1 || s > kMaxShards || n_units < 1 || t < 0 || t > s / 2 ||
      ctas < 1) {
    return (int)cudaErrorInvalidValue;
  }
  Blocks p;
  for (int i = 0; i < s; ++i) {
    p.in[i] = in[i];
    p.out[i] = out[i];
  }
  cudaStream_t st = (cudaStream_t)stream;
  switch (unit) {
    case 16: return launch_step<uint4>(p, s, n_units, t, ctas, st);
    case 8: return launch_step<uint2>(p, s, n_units, t, ctas, st);
    case 4: return launch_step<unsigned>(p, s, n_units, t, ctas, st);
    case 2: return launch_step<unsigned short>(p, s, n_units, t, ctas, st);
  }
  return (int)cudaErrorInvalidValue;
}
