// K3: double-buffered bidirectional ring all-gather of row-sharded blocks.
//
// Replaces sdnmpi_tpu/kernels/ring.py::_ring_gather_kernel (the Pallas
// body at ring.py:213-283, reached from ring_all_gather through
// _ring_gather_pallas_fn). Every shard ends with the [s*B, C]
// concatenation of all shards' [B, C] blocks, moved by the reference's
// schedule: the own block is copied into its rows; at each step t the
// shard pushes its clockwise block (its own at t = 1, else the one it
// received at t - 1) into its right neighbour's comm slot [0, t%2] and
// its counter-clockwise block into its left neighbour's slot [1, t%2],
// then waits for its own two slots of step t and copies them out to the
// rows of their origin shards, (me - t) % s and (me + t) % s. The cw leg
// runs s/2 steps, the ccw leg (s-1)/2.
//
// The body is written per shard: blockIdx.y is the shard, blockIdx.x a
// slice of the block's bytes, and every remote write goes through a
// pointer, so the same body can later run with pointers into other
// cards' memory. On one card, one launch plays every shard, and blocks
// of one shard wait on flags that blocks of another raise. They must all
// be resident at once: the launch is cooperative (CUDA refuses a
// grid that could not be co-resident, and the wrapper sizes the grid
// from the occupancy it queries first), so it can never deadlock.
//
// Synchronisation, per (shard, direction, byte slice) flag word:
// - recv counts the steps whose slot a neighbour has filled. The sender
//   fences its writes (__threadfence_system) and adds with a release; the
//   receiver spins on an acquire load and reads the slot through L2.
// - rel counts the steps whose slot the receiver is done with (copied
//   out and, unless it was the last step, forwarded). Slot t%2 is written
//   again at step t + 2, so the sender waits for rel >= t - 2 first: the
//   job of send_sem in the Pallas kernel.
// - Flags are never reset: the wrapper passes the call number (epoch),
//   and each leg's counters advance by its step count per call, so a
//   wait compares against epoch * legs + t (wrap-around safe).
// The data are raw units of 2, 4, 8 or 16 bytes, so one kernel serves
// every wire dtype (bf16, int16, int32, f32).
//
// What bounds it on an H100: bytes. Each shard's block is read once and
// s copies of the [s*B, C] result are written: s*B*C + s*s*B*C elements
// at 3.35 TB/s on one card (on several cards the remote writes would
// cross NVLink at 450 GB/s each way instead). The comm slots add one
// write and two reads of every forwarded block, which L2 partly absorbs.
// hopper-kernels section 4 maps the TPU's remote copies to NCCL
// collectives; NCCL is only a yardstick here, not the port: this kernel
// keeps the reference's schedule, which a later slice runs across cards.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxShards = 64;
constexpr int kThreads = 256;

struct Blocks {
  const void* in[kMaxShards];
  void* out[kMaxShards];
};

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.sys.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void add_release(unsigned* p) {
  asm volatile("red.release.sys.global.add.u32 [%0], %1;" ::"l"(p), "r"(1u)
               : "memory");
}

// The whole block waits until *p reaches `want` (wrap-around safe).
__device__ __forceinline__ void wait_for(const unsigned* p, unsigned want) {
  if (threadIdx.x == 0) {
    while ((int)(load_acquire(p) - want) < 0) {
      __nanosleep(32);
    }
  }
  __syncthreads();
}

// Every thread's earlier writes become visible, then one increment.
__device__ __forceinline__ void signal(unsigned* p) {
  __threadfence_system();
  __syncthreads();
  if (threadIdx.x == 0) add_release(p);
}

template <typename U>
__device__ __forceinline__ void copy_range(U* dst, const U* src, long long lo,
                                           long long hi) {
  for (long long i = lo + threadIdx.x; i < hi; i += kThreads) {
    dst[i] = __ldcg(src + i);  // L2, never a stale L1 line of a reused slot
  }
}

// flags: [shard][kind: 0 recv, 1 rel][direction][slice] words
__device__ __forceinline__ unsigned* flag(unsigned* flags, int shard, int kind,
                                          int d, int slice, int nblk) {
  return flags + (size_t)((shard * 2 + kind) * 2 + d) * nblk + slice;
}

// comm: [shard][direction][slot][n units]
template <typename U>
__device__ __forceinline__ U* slot(U* comm, int shard, int d, int k,
                                   long long n) {
  return comm + ((size_t)(shard * 2 + d) * 2 + k) * n;
}

template <typename U>
__global__ void __launch_bounds__(kThreads)
    ring_gather(Blocks p, U* comm, unsigned* flags, int s, int nblk,
                long long n, unsigned epoch, int n_cw, int n_ccw) {
  const int me = blockIdx.y;
  const int b = blockIdx.x;
  const long long per = (n + nblk - 1) / nblk;
  const long long lo = min((long long)b * per, n);
  const long long hi = min(lo + per, n);
  const U* in = (const U*)p.in[me];
  U* out = (U*)p.out[me];
  copy_range(out + (long long)me * n, in, lo, hi);
  const int right = (me + 1) % s;
  const int left = (me + s - 1) % s;
  const int steps = max(n_cw, n_ccw);
  for (int t = 1; t <= steps; ++t) {
    // sends of both directions before any wait for this step's arrivals
    for (int d = 0; d < 2; ++d) {
      const int legs = d == 0 ? n_cw : n_ccw;
      if (t > legs) continue;
      const int peer = d == 0 ? right : left;
      const unsigned base = epoch * (unsigned)legs;
      if (t >= 3) wait_for(flag(flags, peer, 1, d, b, nblk), base + t - 2);
      const U* src = t == 1 ? in : slot(comm, me, d, (t - 1) & 1, n);
      copy_range(slot(comm, peer, d, t & 1, n), src, lo, hi);
      signal(flag(flags, peer, 0, d, b, nblk));
      // step t-1's slot is copied out and now forwarded: release it
      if (t >= 2) signal(flag(flags, me, 1, d, b, nblk));
    }
    for (int d = 0; d < 2; ++d) {
      const int legs = d == 0 ? n_cw : n_ccw;
      if (t > legs) continue;
      const unsigned base = epoch * (unsigned)legs;
      wait_for(flag(flags, me, 0, d, b, nblk), base + t);
      const int origin = d == 0 ? ((me - t) % s + s) % s : (me + t) % s;
      copy_range(out + (long long)origin * n, slot(comm, me, d, t & 1, n), lo,
                 hi);
      if (t == legs) signal(flag(flags, me, 1, d, b, nblk));
    }
  }
}

template <typename U>
int capacity() {
  int dev = 0;
  int sms = 0;
  int per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ring_gather<U>,
                                                      kThreads, 0);
  if (e != cudaSuccess) return -(int)e;
  return per_sm * sms;
}

template <typename U>
int launch(const Blocks& p, void* comm, unsigned* flags, int s, int nblk,
           long long n, unsigned epoch, int n_cw, int n_ccw,
           cudaStream_t stream) {
  U* c = (U*)comm;
  void* args[] = {(void*)&p, (void*)&c,      (void*)&flags,
                  (void*)&s, (void*)&nblk,   (void*)&n,
                  (void*)&epoch, (void*)&n_cw, (void*)&n_ccw};
  cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)ring_gather<U>, dim3(nblk, s), dim3(kThreads), args, 0,
      stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// Blocks of the kernel instantiated for `unit`-byte words that can be
// resident on the current device at once (negative: a CUDA error).
extern "C" int ring_capacity(int unit) {
  switch (unit) {
    case 16: return capacity<uint4>();
    case 8: return capacity<uint2>();
    case 4: return capacity<unsigned>();
    case 2: return capacity<unsigned short>();
  }
  return -1;
}

// in/out: s device pointers each (in: [n] units, out: [s * n] units);
// comm: [s, 2, 2, n] units; flags: [s, 2, 2, nblk] uint32, zeroed once.
// Returns the CUDA error of the launch (0 on success).
extern "C" int ring_launch(const void* const* in, void* const* out, int s,
                           void* comm, unsigned* flags, int nblk,
                           long long n_units, int unit, unsigned epoch,
                           int n_cw, int n_ccw, void* stream) {
  if (s < 2 || s > kMaxShards || nblk < 1) return (int)cudaErrorInvalidValue;
  Blocks p;
  for (int i = 0; i < s; ++i) {
    p.in[i] = in[i];
    p.out[i] = out[i];
  }
  cudaStream_t st = (cudaStream_t)stream;
  switch (unit) {
    case 16:
      return launch<uint4>(p, comm, flags, s, nblk, n_units, epoch, n_cw,
                           n_ccw, st);
    case 8:
      return launch<uint2>(p, comm, flags, s, nblk, n_units, epoch, n_cw,
                           n_ccw, st);
    case 4:
      return launch<unsigned>(p, comm, flags, s, nblk, n_units, epoch, n_cw,
                              n_ccw, st);
    case 2:
      return launch<unsigned short>(p, comm, flags, s, nblk, n_units, epoch,
                                    n_cw, n_ccw, st);
  }
  return (int)cudaErrorInvalidValue;
}
