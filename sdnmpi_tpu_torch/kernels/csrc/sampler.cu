// K2: one sampled shortest path per flow, one thread per flow.
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
// tiling. Here a thread walks the node's padded CSR row (neighbours in
// ascending order, bf16 log weights beside them) and reads the
// distances it needs directly; the slot is the CSR position, and the
// ascending walk with a strict `>` keeps argmax's first-index tie-break.
// Slots go out as int8 [F, hops] with no limit on hops.
//
// What bounds it on an H100: the bytes of its inputs (the [V, V] split
// weights and distances, a few MiB) against 3.35 TB/s, a few
// microseconds; the arithmetic (two logf per candidate neighbour) is far
// below the card's f32 rate. The walk touches each flow's path only, so
// the device-memory traffic is one read of the compact tables, which L2
// holds.
//
// Build without --use_fast_math: logf must round like torch.log on the
// card so that kernel and plain version agree bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t hash_u32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

constexpr float kUnreach = 16384.0f;

__global__ void sample_slots(const int* __restrict__ neigh,
                             const __nv_bfloat16* __restrict__ lw,
                             const __nv_bfloat16* __restrict__ dtab,
                             const int* __restrict__ src,
                             const int* __restrict__ dst,
                             const int* __restrict__ drow, int n_flows, int v,
                             int d, int hops, uint32_t salt,
                             uint32_t fid_base, int8_t* __restrict__ out) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= n_flows) return;
  const int s = src[f];
  const int t = dst[f];
  const int r = drow[f];
  const __nv_bfloat16* dist = dtab + (size_t)(r > 0 ? r : 0) * v;
  const bool alive =
      s >= 0 && t >= 0 && r >= 0 && __bfloat162float(dist[s]) < kUnreach;
  int node = alive ? s : -1;
  const uint32_t fid_mix = ((uint32_t)f + fid_base) * 2654435761u;
  int8_t* row_out = out + (size_t)f * hops;
  for (int h = 0; h < hops; ++h) {
    int nxt = -1;
    int slot = -1;
    if (node >= 0 && node != t) {
      const float want = __bfloat162float(dist[node]) - 1.0f;
      const uint32_t hh = (uint32_t)(h + 1) * 0x9E3779B1u + salt;
      const int* nrow = neigh + (size_t)node * d;
      const __nv_bfloat16* lrow = lw + (size_t)node * d;
      float best = 0.0f;
      for (int k = 0; k < d; ++k) {
        const int j = nrow[k];
        if (j >= v) break;
        if (__bfloat162float(dist[j]) != want) continue;
        const uint32_t u =
            hash_u32(fid_mix ^ ((uint32_t)j * 0x85EBCA77u) ^ hh);
        const float un =
            __uint_as_float(0x3F800000u | (u >> 9) | 1u) - 1.0f;
        const float score = __bfloat162float(lrow[k]) + (-logf(-logf(un)));
        if (nxt < 0 || score > best) {
          best = score;
          nxt = j;
          slot = k;
        }
      }
    }
    row_out[h] = (int8_t)slot;
    node = nxt;
  }
}

}  // namespace

// neigh [v, d] int32, lw [v, d] bf16, dtab [rows, v] bf16, src/dst/drow
// [n_flows] int32, out [n_flows, hops] int8; all device pointers.
// Returns the CUDA error of the launch (0 on success).
extern "C" int sampler_launch(const int* neigh, const void* lw,
                              const void* dtab, const int* src, const int* dst,
                              const int* drow, int n_flows, int v, int d,
                              int hops, unsigned int salt,
                              unsigned int fid_base, int8_t* out,
                              void* stream) {
  const int threads = 128;
  const int blocks = (n_flows + threads - 1) / threads;
  sample_slots<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      neigh, (const __nv_bfloat16*)lw, (const __nv_bfloat16*)dtab, src, dst,
      drow, n_flows, v, d, hops, (uint32_t)salt, (uint32_t)fid_base, out);
  return (int)cudaGetLastError();
}
