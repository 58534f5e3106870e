// K2: one sampled shortest path per flow, a group of lanes per flow, and
// the per-call set-up of its tables.
//
// Replaces sdnmpi_tpu/kernels/sampler.py::_sampler_kernel
// (sample_slots_pallas). At each of `hops` steps a flow standing at
// `node` takes, among node's real out-links one hop closer to its
// destination, argmax(bf16 log w + Gumbel noise), and records the chosen
// neighbour's rank among node's sorted out-neighbours (its slot); -1
// marks the end of the path. The noise is the reference's hash chain
// over (flow id, neighbour, hop, salt) turned into a uniform by a
// mantissa bitcast, so the kernel draws the same numbers as the plain
// version. The flow id is the flow's index plus `fid_base` (mod 2^32), so
// a shard of a flow-sharded batch draws the noise of its flows' global
// ids.
//
// The Pallas kernel gathers the current node's log-weight row and the
// flow's distance row with one-hot [B, V] x [V, V] matmuls, the TPU's way
// to gather, and packs the slots into int32 words for the TPU's (8, 128)
// tiling. Here the inputs are the compact tables of the wrapper's set-up
// (kernels/sampler.py sampler_tables), shared by every launch of one
// call: the topology's sorted out-neighbour table [V, D] (built once per
// topology version; entries >= V are padding), the bf16 log weight of
// each of those links [V, D], the bf16 distance rows the flows read
// [R, V] and, with a destination set, each destination's row [V].
//
// What bounds it on an H100: bytes. The function needs the neighbour
// table, the weights of its links, the distance rows the flows read and
// the flows in and slots out, once each, against 3.35 TB/s (a few
// microseconds, never the [V, V] weights); the arithmetic (two logf per candidate) is far below
// the card's f32 rate. What held the thread-per-flow design back was
// latency: the 32 flows of a warp walked 32 nodes, each lane a chain of
// dependent scattered loads per candidate, and the wrapper rebuilt
// [V, V]-wide tables on every call. Now a group of G lanes takes one
// flow: lane l of the group scores table entries l, l + G, ... of the
// node's row, so the row and its log weights are read coalesced and the
// candidates' distance reads and hashes overlap; the argmax is a
// butterfly within the group over (score, then lowest slot), which keeps
// the first-index tie-break of argmax over an ascending walk. Wider
// groups spend their issue slots on the butterfly and on lanes past the
// node's degree, so a large batch runs fastest with G = 4 (8 flows a
// warp); a batch too small to fill the card at 4 lanes takes G = 8 to
// keep more loads in flight. The wrapper picks G from the flow count and
// the SM count (kernels/sampler.py lane_group). The tables are small enough
// to stay in L2 (0.9 MB of neighbours and 3 MB of [T, V] rows at
// V = 3,968, T = 384). Slots go out as int8 [F, hops] with no limit on
// hops.
//
// The set-up (sampler_setup_launch, one call per device per collective)
// replaces the XLA prep of sample_slots_pallas (sampler.py:270-305): the
// [V, V] log weights, the [V, V] distance transpose and the destination
// set's [T, V] rows and per-flow row. It writes the bf16 log weight of
// each table entry (one strided read of the link's weight), the bf16
// [T, V] rows straight from the distance columns the set names (a
// transpose through a shared-memory tile, so reads and writes are both
// coalesced where the set is dense) and each node's first position in
// the set. Done as torch ops it was some 25 small launches, whose host
// time was ten times their device time; here it is three.
//
// Build without --use_fast_math: logf must round like torch.log on the
// card so that kernel and plain version agree bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // warps per block
constexpr float kUnreach = 16384.0f;
constexpr float kNoLink = -1e4f;
constexpr int kTile = 32;  // set-up transpose tile

__device__ __forceinline__ uint32_t hash_u32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// (s, k) beats (bs, bk): k < 0 is no candidate; a higher score wins, and
// an equal score at a lower slot
__device__ __forceinline__ bool beats(float s, int k, float bs, int bk) {
  return k >= 0 && (bk < 0 || s > bs || (s == bs && k < bk));
}

// One flow per group of G lanes (G = 4 or 8): lane l of a group
// scores entries l, l + G, ... of the node's row.
template <int G>
__global__ void __launch_bounds__(kWarps * 32)
    sample_slots(const int* __restrict__ neigh,
                 const __nv_bfloat16* __restrict__ lw,
                 const __nv_bfloat16* __restrict__ dtab,
                 const int* __restrict__ row_of, const int* __restrict__ src,
                 const int* __restrict__ dst, int n_flows, int v, int d,
                 int hops, uint32_t salt, uint32_t fid_base,
                 int8_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int gl = lane % G;
  const long long f =
      ((long long)blockIdx.x * kWarps + (threadIdx.x >> 5)) * (32 / G) +
      lane / G;
  // every lane of the warp takes part in the shuffles, so a lane past
  // the last flow stays in the loop as a dead flow
  const bool real = f < n_flows;
  const int s = real ? src[f] : -1;
  const int t = real ? dst[f] : -1;
  const int r = t < 0 ? -1 : (row_of != nullptr ? row_of[t] : t);
  const __nv_bfloat16* dist = dtab + (size_t)(r > 0 ? r : 0) * v;
  const bool alive = s >= 0 && r >= 0 && __bfloat162float(dist[s]) < kUnreach;
  int node = alive ? s : -1;
  const uint32_t fid_mix = ((uint32_t)f + fid_base) * 2654435761u;
  int8_t* row_out = out + (real ? f : 0) * hops;
  for (int h = 0; h < hops; ++h) {
    const bool moving = node >= 0 && node != t;
    if (!__any_sync(0xFFFFFFFFu, moving)) {  // every path of the warp ended
      if (real) {
        for (int i = h + gl; i < hops; i += G) row_out[i] = -1;
      }
      return;
    }
    const int* nrow = neigh + (size_t)(moving ? node : 0) * d;
    float best = 0.0f;
    int bk = -1;
    if (moving) {
      const float want = __bfloat162float(dist[node]) - 1.0f;
      const uint32_t hh = (uint32_t)(h + 1) * 0x9E3779B1u + salt;
      const __nv_bfloat16* lrow = lw + (size_t)node * d;
      for (int k = gl; k < d; k += G) {
        const int j = nrow[k];
        if (j >= v) break;  // padding: the row's later entries are too
        const float w = __bfloat162float(lrow[k]);
        if (w <= -1e3f || __bfloat162float(dist[j]) != want) continue;
        const uint32_t u =
            hash_u32(fid_mix ^ ((uint32_t)j * 0x85EBCA77u) ^ hh);
        const float un = __uint_as_float(0x3F800000u | (u >> 9) | 1u) - 1.0f;
        const float score = w + (-logf(-logf(un)));
        if (bk < 0 || score > best) {  // ascending k: the first best stays
          best = score;
          bk = k;
        }
      }
    }
    for (int off = G / 2; off > 0; off >>= 1) {  // within the group
      const float os = __shfl_xor_sync(0xFFFFFFFFu, best, off);
      const int ok = __shfl_xor_sync(0xFFFFFFFFu, bk, off);
      if (beats(os, ok, best, bk)) {
        best = os;
        bk = ok;
      }
    }
    if (real && gl == 0) row_out[h] = (int8_t)bk;
    node = bk >= 0 ? nrow[bk] : -1;
  }
}

template <int G>
int launch_sampler(const int* neigh, const void* lw, const void* dtab,
                   const int* row_of, const int* src, const int* dst,
                   int n_flows, int v, int d, int hops, uint32_t salt,
                   uint32_t fid_base, int8_t* out, cudaStream_t stream) {
  constexpr int per_block = kWarps * (32 / G);
  const int blocks = (n_flows + per_block - 1) / per_block;
  sample_slots<G><<<blocks, kWarps * 32, 0, stream>>>(
      neigh, (const __nv_bfloat16*)lw, (const __nv_bfloat16*)dtab, row_of,
      src, dst, n_flows, v, d, hops, salt, fid_base, out);
  return (int)cudaGetLastError();
}

// lw[i, k]: bf16 log weight of table entry (i, k), NO_LINK on padding
// (torch: where(w > 0, log(clamp(w, 1e-30)), -1e4).to(bfloat16))
__global__ void link_log_weights(const int* __restrict__ neigh,
                                 const float* __restrict__ weights,
                                 long long ldw, int v, int d,
                                 __nv_bfloat16* __restrict__ lw) {
  const long long n = (long long)v * d;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    const int j = neigh[e];
    const float w = j < v ? weights[(e / d) * ldw + j] : 0.0f;
    lw[e] = __float2bfloat16_rn(w > 0.0f ? logf(fmaxf(w, 1e-30f)) : kNoLink);
  }
}

// dtab[t, i] = bf16 hop count of node i to destination col(t), UNREACH
// for inf and for padding; col(t) = dn[t], or t without a set. Block
// (32, 8) moves a 32 x 32 tile through shared memory.
__global__ void dest_rows(const float* __restrict__ dist, long long ldd,
                          const int* __restrict__ dn, int rows, int v,
                          __nv_bfloat16* __restrict__ dtab) {
  __shared__ float tile[kTile][kTile + 1];
  const int t0 = blockIdx.y * kTile;
  const int i0 = blockIdx.x * kTile;
  const int tx = threadIdx.x;
  int col = -1;
  if (t0 + tx < rows) col = dn != nullptr ? dn[t0 + tx] : t0 + tx;
  for (int k = threadIdx.y; k < kTile; k += blockDim.y) {
    const int i = i0 + k;
    tile[k][tx] = (col >= 0 && i < v) ? dist[(long long)i * ldd + col] : INFINITY;
  }
  __syncthreads();
  for (int k = threadIdx.y; k < kTile; k += blockDim.y) {
    const int t = t0 + k;
    const int i = i0 + tx;
    if (t < rows && i < v) {
      const float x = tile[tx][k];
      dtab[(long long)t * v + i] = __float2bfloat16_rn(isfinite(x) ? x : kUnreach);
    }
  }
}

// row_of[n]: first position of node n in the destination set, -1 if
// absent
__global__ void dest_index(const int* __restrict__ dn, int rows, int v,
                           int* __restrict__ row_of) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= v) return;
  int r = -1;
  for (int t = 0; t < rows; ++t) {
    if (dn[t] == n) {
      r = t;
      break;
    }
  }
  row_of[n] = r;
}

}  // namespace

// The set-up: neigh [v, d] int32, weights [v, ldw] f32, dist [v, ldd]
// f32, dn [rows] int32 or null (then rows == v); out lw [v, d] bf16,
// dtab [rows, v] bf16, row_of [v] int32 (unused without dn). Returns the
// CUDA error of the launches (0 on success).
extern "C" int sampler_setup_launch(const int* neigh, const float* weights,
                                    long long ldw, const float* dist,
                                    long long ldd, const int* dn, int rows,
                                    int v, int d, void* lw, void* dtab,
                                    int* row_of, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long n = (long long)v * d;
  if (n > 0) {
    const long long want = (n + 255) / 256;
    link_log_weights<<<(int)(want < 65535 ? want : 65535), 256, 0, st>>>(
        neigh, weights, ldw, v, d, (__nv_bfloat16*)lw);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((v + kTile - 1) / kTile, (rows + kTile - 1) / kTile);
  dest_rows<<<grid, dim3(kTile, 8), 0, st>>>(dist, ldd, dn, rows, v,
                                            (__nv_bfloat16*)dtab);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || dn == nullptr) return (int)e;
  dest_index<<<(v + 255) / 256, 256, 0, st>>>(dn, rows, v, row_of);
  return (int)cudaGetLastError();
}

// neigh [v, d] int32, lw [v, d] bf16, dtab [rows, v] bf16, row_of [v]
// int32 or null (a flow reads row dst), src/dst [n_flows] int32, out
// [n_flows, hops] int8; all device pointers. `group` (4 or 8) is the
// lanes per flow. Returns the CUDA error of the launch (0 on
// success).
extern "C" int sampler_launch(const int* neigh, const void* lw,
                              const void* dtab, const int* row_of,
                              const int* src, const int* dst, int n_flows,
                              int v, int d, int hops, unsigned int salt,
                              unsigned int fid_base, int group, int8_t* out,
                              void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (group) {
    case 4:
      return launch_sampler<4>(neigh, lw, dtab, row_of, src, dst, n_flows, v,
                               d, hops, salt, fid_base, out, st);
    case 8:
      return launch_sampler<8>(neigh, lw, dtab, row_of, src, dst, n_flows, v,
                               d, hops, salt, fid_base, out, st);
  }
  return (int)cudaErrorInvalidValue;
}
