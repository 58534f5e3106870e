// S1: the greedy load-balanced scanner, one block per call.
//
// Replaces sdnmpi_tpu/oracle/congestion.py::route_flows_balanced (:56). That
// is not a Pallas kernel: it is a jitted XLA program of two nested
// lax.scan loops, chunks at :158 and hops at :149. This kernel computes
// the function of the port's plain version
// (oracle/congestion.py::route_flows_balanced_plain) exactly:
// - chunks of `chunk` flows run in order, and hops run in order within a
//   chunk;
// - at each hop every moving flow of the chunk (a live flow that has not
//   reached its destination) scores the equal-cost candidates of its
//   neighbour row (dist[nbr, dst] == dist[node, dst] - 1) as
//   base + float32(load), reading the load as it stood at the start of
//   the hop;
// - tied minima are dealt round-robin by the flow's batch-wide row id
//   (row mod the tie count picks the tie, in slot order), and with no
//   candidate at all slot 0 is taken, as the plain version's argmax of an
//   empty pick does;
// - only after every flow of the chunk has picked are the weights added
//   at (node, next), a moving flow's add included at the last hop.
//
// The load is float64, as in the plain version. Every weight is a float32
// value, an integer multiple of 2^q for q the exponent of the smallest
// weight's last place; every partial sum of such values is an integer
// multiple of 2^q too, and is exact in float64 while it stays below
// 2^(53 + q) (for weights of at least 1, q >= -23: any link load below
// 2^30). Sub-flow weights such as count / ways are of this kind. So every
// add is exact, the sum does not depend on the order of the adds, and
// the adds can be atomics: load, its float32 cast and the max are equal
// bit for bit to the plain version's.
//
// What bounds it on an H100: a chain of dependent steps, not bytes. Each
// chunk's hops depend on the load the previous hops placed, and each
// chunk on the previous chunks, so the number of hops run in order
// (chunks x hops: one per sub-flow and hop on the phased leg, where
// chunk = 1) times the latency of one hop sets the time: a neighbour
// row, the candidates' distances and loads (dependent reads from L1/L2),
// a warp reduction, then the adds and a block barrier. The bytes moved
// are a few MB at most, microseconds at 3.35 TB/s.
//
// What the design does about it:
// - one block per call, looping over the chunks and hops: the chunks
//   depend on each other through the load, so one block is the honest
//   first form;
// - a warp takes one flow at a time, its lanes over the neighbour slots
//   in groups of 32; a warp minimum, a __ballot_sync mask of the tied
//   minima per group and the k-th set bit, carried across the groups,
//   give the pick, with no shared memory and no sort. The first 64 slots
//   stay in registers (two a lane), so a row of degree <= 64 (16 at
//   config 12, 56 at config 13) reads each slot once; the slots of a
//   wider row past 64 are read again for the tie count and the pick;
// - __syncthreads_or after the picks ends a chunk at the first hop in
//   which no flow moves, and the call ends at the chunk of the last live
//   row (found by a backward scan of src), so the -1 pads of a
//   power-of-two flow bucket and the hops past the longest path are
//   never run: they place no load and their rows stay -1.
//
// A later PR's lead: at config 12 (V = 320, D = 16), uint8 hop counts
// [V, V] (100 KB), the link-indexed [V, D] float64 load (40 KB), the
// neighbour table and the [V, D] base costs fit in the 227 KB of shared
// memory together, which takes every read of a hop off L2; and the
// independent flows of a chunk could fill more than one warp.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// one neighbour slot of a hop: its entry (v past the row's end), whether
// it is an equal-cost candidate, and its score (inf when it is not)
struct Slot {
  int nb;
  bool ok;
  float sc;
};

__device__ __forceinline__ Slot slot_at(const int* nrow, int i, int d, int v,
                                        const float* dist, long long vv, int t,
                                        float want, const float* base,
                                        const double* load, long long link) {
  Slot s{i < d ? nrow[i] : v, false, INFINITY};
  if (s.nb < v && dist[s.nb * vv + t] == want) {
    s.ok = true;
    s.sc = base[link + s.nb] + __double2float_rn(__ldcg(load + link + s.nb));
  }
  return s;
}

// the slot of the r-th set bit of a 32-slot group's mask
__device__ __forceinline__ int nth_set(unsigned mask, int r) {
  for (; r > 0; --r) mask &= mask - 1;
  return __ffs(mask) - 1;
}

__global__ void scan_flows(const int* __restrict__ neigh, int v, int d,
                           const float* __restrict__ dist,
                           const float* __restrict__ base,
                           const int* __restrict__ src,
                           const int* __restrict__ dst,
                           const float* __restrict__ weight, long long u,
                           int max_len, long long chunk, double* load,
                           int* nodes, int* nxt) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_threads = blockDim.x;
  const int n_warps = n_threads >> 5;
  const long long vv = v;

  // the last live row, scanning back from the end in windows of four
  // loads a thread: trailing pads are read, never routed
  __shared__ unsigned long long last_live;
  if (tid == 0) last_live = 0;
  long long n_live = 0;
  const long long span = 4LL * n_threads;
  for (long long hi = u; hi > 0; hi -= span) {
    const long long lo = hi > span ? hi - span : 0;
    long long mine = -1;
    for (long long i = lo + tid; i < hi; i += n_threads) {
      if (src[i] >= 0) mine = i;
    }
    if (__syncthreads_or(mine >= 0)) {
      if (mine >= 0) atomicMax(&last_live, (unsigned long long)(mine + 1));
      __syncthreads();
      n_live = (long long)last_live;
      break;
    }
  }

  for (long long c0 = 0; c0 < n_live; c0 += chunk) {
    const long long rows = chunk < u - c0 ? chunk : u - c0;
    // hop 0: a flow is live when both ends are real and connected
    for (long long f = tid; f < rows; f += n_threads) {
      const long long row = c0 + f;
      const int s = src[row];
      const int t = dst[row];
      if (s >= 0 && t >= 0 && isfinite(dist[s * vv + t])) {
        nodes[row * max_len] = s;
      }
    }
    __syncthreads();
    for (int h = 0; h < max_len; ++h) {
      // the picks: every flow reads the load as the last hop left it
      bool moved = false;
      for (long long f = warp; f < rows; f += n_warps) {
        const long long row = c0 + f;
        const int node = nodes[row * max_len + h];
        const int t = dst[row];
        int next = -1;
        if (node >= 0 && node != t) {
          const float want = dist[node * vv + t] - 1.0f;
          const int* nrow = neigh + node * (long long)d;
          const long long link = node * vv;
          const auto slot = [&](int i) {
            return slot_at(nrow, i, d, v, dist, vv, t, want, base, load, link);
          };
          const Slot a = slot(lane);
          const Slot b = slot(lane + 32);
          float mn = fminf(a.sc, b.sc);
          for (int s0 = 64; s0 < d; s0 += 32) mn = fminf(mn, slot(s0 + lane).sc);
          for (int o = 16; o > 0; o >>= 1) mn = fminf(mn, __shfl_xor_sync(kFull, mn, o));
          const unsigned tied_a = __ballot_sync(kFull, a.ok && a.sc == mn);
          const unsigned tied_b = __ballot_sync(kFull, b.ok && b.sc == mn);
          int m = __popc(tied_a) + __popc(tied_b);
          for (int s0 = 64; s0 < d; s0 += 32) {
            const Slot c = slot(s0 + lane);
            m += __popc(__ballot_sync(kFull, c.ok && c.sc == mn));
          }
          int j = 0;
          if (m > 0) {
            // the (row mod m)-th tied slot: walk the groups to the one
            // that holds it, then clear the lower set bits of its mask
            int r = (int)(row % m);
            int s0 = 0;
            unsigned tied = tied_a;
            while (r >= __popc(tied)) {
              r -= __popc(tied);
              s0 += 32;
              if (s0 == 32) {
                tied = tied_b;
              } else {
                const Slot c = slot(s0 + lane);
                tied = __ballot_sync(kFull, c.ok && c.sc == mn);
              }
            }
            j = s0 + nth_set(tied, r);
          }
          // j is the same in every lane, and below d; the entry is
          // clamped as the plain version's neigh_safe
          const int nb = j < 32 ? __shfl_sync(kFull, a.nb, j)
                       : j < 64 ? __shfl_sync(kFull, b.nb, j - 32)
                                : nrow[j];
          next = nb < v ? nb : v - 1;
          moved = true;
        }
        if (lane == 0) nxt[f] = next;
      }
      if (!__syncthreads_or(moved)) break;
      // the adds, after every pick of the hop
      for (long long f = tid; f < rows; f += n_threads) {
        const int next = nxt[f];
        if (next >= 0) {
          const long long row = c0 + f;
          const int node = nodes[row * max_len + h];
          atomicAdd(load + node * vv + next, (double)weight[row]);
          if (h + 1 < max_len) nodes[row * max_len + h + 1] = next;
        }
      }
      __syncthreads();
    }
  }
}

}  // namespace

extern "C" int scan_launch(const int* neigh, int v, int d, const float* dist,
                           const float* base, const int* src, const int* dst,
                           const float* weight, long long u, int max_len,
                           long long chunk, double* load, int* nodes, int* nxt,
                           void* stream) {
  if (v < 1 || d < 1 || u < 1 || max_len < 1 || chunk < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const long long rows = chunk < u ? chunk : u;
  const int warps = rows < 32 ? (int)rows : 32;
  scan_flows<<<1, 32 * warps, 0, (cudaStream_t)stream>>>(
      neigh, v, d, dist, base, src, dst, weight, u, max_len, chunk, load, nodes,
      nxt);
  return (int)cudaGetLastError();
}
