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
