// K1: multi-source BFS hop counts, bit-parallel, S sources per block.
//
// Replaces sdnmpi_tpu/kernels/bfs.py::_bfs_kernel (bfs_distances_pallas).
// The Pallas kernel expands a [B, V] strip of sources per grid step, one
// bf16 0/1 frontier-by-adjacency product on the MXU per level. This
// kernel computes the same function in the boolean semiring: hop counts
// over directed links, exactly `levels` expansion steps (it stops early
// when a level reaches nothing new, which cannot change the result), 0 on
// the diagonal (padding rows included), inf where no level reached. One
// machine word per node holds the reached bits of the block's S sources,
// and a level ORs words along links (Then et al., "The More the Merrier:
// Efficient Multi-Source Graph Traversal", VLDB 2014).
//
// What bounds it on an H100: the [V, V] f32 output, written once
// (63 MB at V = 3,968, 19 us at 3.35 TB/s), plus the [V, D] topology
// table read once. At V = 1024 that bound is 1.3 us, under the latency
// of a launch and a few levels of block barriers: there the levels'
// latency sets the time.
//
// Design, per block (S consecutive sources, S = 8, 16, 32 or 64 bits):
// - shared memory holds the per-node words seen / front / next, a list
//   of the frontier's nodes, and the level at which each (source, node)
//   pair was reached, node by node, S uint8 (uint16 when levels > 254)
//   in an odd number of 32-bit words per node, so that neighbouring
//   nodes fall in different banks;
// - a level pushes each frontier node's word into the next word of its
//   out-neighbours (shared-memory atomicOr into a 32-bit next word per
//   node, 64-bit for S = 64: no two nodes share the word an atomic
//   locks, and neighbouring nodes sit in different banks). Only the
//   frontier's rows of the
//   table are read: a row takes D (rounded up to a power of two, at most
//   32) neighbouring lanes of a warp, so a warp reads up to 128
//   contiguous bytes per load, and each warp keeps four row groups'
//   loads in flight; a row no source of the block reached at the last
//   level is not read;
// - one pass over the nodes takes the new bits, writes their level into
//   the node's record words under a byte mask (no loop over bits), and
//   appends the node to the next frontier list (one shared atomicAdd per
//   warp); __syncthreads_or over "any new bit" separates the levels and
//   ends the loop early;
// - the block's S output rows are written once: a thread turns one
//   record word into the levels of 4 (or 2) sources at its node, and
//   each warp store covers 128 contiguous bytes of one row: full
//   sectors, no scattered stores.
// S is a launch parameter: the wrapper picks it from V and the SM count
// (kernels/bfs.py sources_per_block), within the shared memory a block
// may use (kernels/bfs.py smem_bytes mirrors the layout below).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 1024;
constexpr int kRows = 4;
// shared memory a block may use on an H100 (227 KB)
constexpr size_t kSmemLimit = 232448;

__host__ __device__ constexpr size_t align16(size_t n) {
  return (n + 15) & ~(size_t)15;
}

// the word a level ORs into: at least 32 bits, so that the shared-memory
// atomicOr of each node has a word of its own
template <typename W>
using Next = typename std::conditional<sizeof(W) == 8, unsigned long long, unsigned>::type;

// 32-bit words of one node's level record: S levels of type L, plus one
// so that the count is odd
template <typename W, typename L>
__host__ __device__ constexpr int record_words() {
  return (int)(8 * sizeof(W) * sizeof(L) / 4 + 1);
}
template <typename W>
__host__ __device__ constexpr size_t word_bytes(int v) {
  return align16((size_t)v * sizeof(W));
}
// the record, next, seen / front, the frontier list, two list counts
template <typename W, typename L>
__host__ __device__ constexpr size_t smem_bytes(int v) {
  return align16((size_t)v * record_words<W, L>() * 4) + word_bytes<Next<W>>(v) +
         2 * word_bytes<W>(v) + align16((size_t)v * 2) + 16;
}

// 0xFF.. over the levels of a record word whose sources are set in
// `bits` (4 uint8 levels or 2 uint16 levels per word)
template <typename L>
__device__ __forceinline__ unsigned level_mask(unsigned bits);
template <>
__device__ __forceinline__ unsigned level_mask<uint8_t>(unsigned bits) {
  return ((bits * 0x00204081u) & 0x01010101u) * 0xFFu;
}
template <>
__device__ __forceinline__ unsigned level_mask<uint16_t>(unsigned bits) {
  return ((bits * 0x00008001u) & 0x00010001u) * 0xFFFFu;
}

template <typename L>
__device__ __forceinline__ float hops(L x) {
  return x == (L)~(L)0 ? INFINITY : (float)x;
}

// W: the word of S = 8 * sizeof(W) sources; L: the level record type
template <typename W, typename L>
__global__ void __launch_bounds__(kThreads)
bfs_groups(const int* __restrict__ neigh, int v, int d, int levels,
           float* __restrict__ out) {
  constexpr int S = 8 * sizeof(W);
  constexpr int kRec = record_words<W, L>();
  constexpr int kPer = 4 / sizeof(L);  // sources per record word
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned* rec = reinterpret_cast<unsigned*>(smem);
  Next<W>* next = reinterpret_cast<Next<W>*>(smem + align16((size_t)v * kRec * 4));
  W* seen = reinterpret_cast<W*>(reinterpret_cast<unsigned char*>(next) + word_bytes<Next<W>>(v));
  W* front = reinterpret_cast<W*>(reinterpret_cast<unsigned char*>(seen) + word_bytes<W>(v));
  uint16_t* list = reinterpret_cast<uint16_t*>(
      reinterpret_cast<unsigned char*>(front) + word_bytes<W>(v));
  int* count = reinterpret_cast<int*>(
      reinterpret_cast<unsigned char*>(list) + align16((size_t)v * 2));

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int s0 = blockIdx.x * S;
  const int rows = min(S, v - s0);

  // every level starts unseen (all ones)
  for (int q = tid; q < v * kRec; q += kThreads) rec[q] = ~0u;
  for (int j = tid; j < v; j += kThreads) {
    const W b = (j >= s0 && j < s0 + rows) ? (W)((W)1 << (j - s0)) : (W)0;
    seen[j] = b;
    front[j] = b;
    next[j] = 0;
  }
  if (tid < rows) list[tid] = (uint16_t)(s0 + tid);
  if (tid == 0) {
    count[0] = rows;
    count[1] = 0;
  }
  __syncthreads();
  if (tid < rows) reinterpret_cast<L*>(rec + (size_t)(s0 + tid) * kRec)[tid] = 0;
  __syncthreads();

  // a warp takes 32 / lp rows of the frontier list at once, lp lanes per
  // row (D rounded up to a power of two, at most 32), each lane up to two
  // entries of its row per pass; kRows such row groups are in flight
  const int lp_log = d <= 1 ? 0 : min(5, 32 - __clz(d - 1));
  const int lp = 1 << lp_log;
  const int kl = lane & (lp - 1);
  const int step = (kThreads / 32) << (5 - lp_log);  // rows per block pass
  const int first = ((tid >> 5) << (5 - lp_log)) + (lane >> lp_log);
  for (int l = 1; l <= levels; ++l) {
    // push: level l walks the list that level l - 1 appended to
    const int cnt = count[(l - 1) & 1];
    if (tid == 0) count[l & 1] = 0;
    for (int a0 = first; a0 < cnt; a0 += kRows * step) {
      for (int kb = kl; kb < d; kb += 2 * lp) {
        int j[kRows][2];
        Next<W> f[kRows];
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
          const int a = a0 + u * step;
          j[u][0] = j[u][1] = v;
          f[u] = 0;
          if (a < cnt) {
            const int i = list[a];
            const int* row = neigh + (size_t)i * d;
            f[u] = front[i];
            j[u][0] = __ldg(row + kb);
            if (kb + lp < d) j[u][1] = __ldg(row + kb + lp);
          }
        }
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (j[u][h] < v) atomicOr(next + j[u][h], f[u]);
          }
        }
      }
    }
    __syncthreads();
    // update: new bits, their level, the next frontier list
    int grew = 0;
    const unsigned lrep = (unsigned)l * (sizeof(L) == 1 ? 0x01010101u : 0x00010001u);
    for (int j0 = tid - lane; j0 < v; j0 += kThreads) {
      const int j = j0 + lane;
      W fresh = 0;
      if (j < v) {
        const W x = (W)next[j];
        if (x) {
          next[j] = 0;
          fresh = x & (W)~seen[j];
        }
        if (fresh) {
          seen[j] |= fresh;
          front[j] = fresh;
          unsigned* r = rec + (size_t)j * kRec;
#pragma unroll
          for (int w = 0; w < S / kPer; ++w) {
            const unsigned bits = (unsigned)(fresh >> (w * kPer)) & ((1u << kPer) - 1);
            if (bits) {
              const unsigned m = level_mask<L>(bits);
              r[w] = (r[w] & ~m) | (lrep & m);
            }
          }
        }
      }
      const unsigned ballot = __ballot_sync(0xffffffffu, fresh != 0);
      if (ballot) {
        int base = 0;
        if (lane == 0) base = atomicAdd(&count[l & 1], __popc(ballot));
        base = __shfl_sync(0xffffffffu, base, 0);
        if (fresh) list[base + __popc(ballot & ((1u << lane) - 1))] = (uint16_t)j;
        grew = 1;
      }
    }
    if (!__syncthreads_or(grew)) break;
  }

  // the block's rows of the output: a thread reads one record word of a
  // node (kPer levels) and stores them into kPer rows; each warp store
  // covers 128 contiguous bytes of one row
  for (int r0 = 0; r0 < rows; r0 += kPer) {
    for (int j = tid; j < v; j += kThreads) {
      const unsigned word = rec[(size_t)j * kRec + r0 / kPer];
#pragma unroll
      for (int t = 0; t < kPer; ++t) {
        if (r0 + t < rows) {
          out[(size_t)(s0 + r0 + t) * v + j] = hops<L>((L)(word >> (t * 8 * sizeof(L))));
        }
      }
    }
  }
}

template <typename W, typename L>
int launch(const int* neigh, int v, int d, int levels, float* out,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<W, L>(v);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  static size_t granted = 48 * 1024;  // per instantiation
  if (smem > granted) {
    cudaError_t e = cudaFuncSetAttribute(
        bfs_groups<W, L>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    granted = smem;
  }
  constexpr int S = 8 * sizeof(W);
  bfs_groups<W, L><<<(v + S - 1) / S, kThreads, smem, stream>>>(neigh, v, d, levels, out);
  return (int)cudaGetLastError();
}

template <typename L>
int launch_sources(int sources, const int* neigh, int v, int d, int levels,
                   float* out, cudaStream_t stream) {
  switch (sources) {
    case 8: return launch<uint8_t, L>(neigh, v, d, levels, out, stream);
    case 16: return launch<uint16_t, L>(neigh, v, d, levels, out, stream);
    case 32: return launch<uint32_t, L>(neigh, v, d, levels, out, stream);
    case 64: return launch<unsigned long long, L>(neigh, v, d, levels, out, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// neigh: [v, d] int32 device pointer (entries >= v are padding); out:
// [v, v] f32 device pointer; levels <= v - 1 (at most 65534); sources:
// 8, 16, 32 or 64 per block. Returns the CUDA error of the launch (0 on
// success; cudaErrorInvalidValue for a width or size it does not take).
extern "C" int bfs_launch(const int* neigh, int v, int d, int levels,
                          int sources, float* out, void* stream) {
  if (v <= 0 || v > 65535 || d <= 0 || levels < 0 || levels > 65534) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  return levels <= 254
      ? launch_sources<uint8_t>(sources, neigh, v, d, levels, out, s)
      : launch_sources<uint16_t>(sources, neigh, v, d, levels, out, s);
}
