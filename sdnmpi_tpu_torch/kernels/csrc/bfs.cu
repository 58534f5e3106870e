// K1: multi-source BFS hop counts, one thread block per source row.
//
// Replaces sdnmpi_tpu/kernels/bfs.py::_bfs_kernel (bfs_distances_pallas).
// The Pallas kernel multiplies a [B, V] frontier strip by the bf16 0/1
// adjacency on the MXU once per level; that formulation exists because a
// matrix product is what the TPU does well. This kernel computes the same
// function — hop counts over directed links, exactly `levels` expansion
// steps, 0 on the diagonal (padding rows included), inf where no level
// reached — as a plain level-synchronous BFS.
//
// What bounds it on an H100: the [V, V] f32 output write (4 MiB at
// V=1024) against 3.35 TB/s, about 1.3 us; the adjacency the caller hands
// in was read once, per topology version, to build the neighbour table.
// The per-row work is V x levels shared-memory probes plus one read of
// each reached node's neighbour row, which the 50 MB L2 serves after the
// first blocks.
//
// Design: the distance row lives in shared memory as uint16 (2V bytes, so
// V=1024 needs 2 KiB and any V up to 65535 fits the 227 KB a block may
// use). Each level, the block's threads stride over the nodes; a node at
// level l-1 marks every unvisited out-neighbour with l. Racing writes all
// store the same value l, so they are benign. __syncthreads_or both
// separates the levels and ends the loop as soon as a level reaches
// nothing new, which cannot change the result. The finished row is
// written to device memory once, as f32.
//
// Neighbour rows come from the topology's compact table [V, D], built once
// per topology version without a sort (kernels/bfs.py neighbor_rows): row
// i holds i's out-neighbours in ascending order, padded with V past its
// degree, D the fabric's largest out-degree rounded up.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr uint16_t kUnseen = 0xFFFF;

__global__ void bfs_rows(const int* __restrict__ neigh, int v, int d,
                         int levels, float* __restrict__ out) {
  extern __shared__ uint16_t lvl[];
  const int s = blockIdx.x;
  for (int i = threadIdx.x; i < v; i += blockDim.x) {
    lvl[i] = (i == s) ? 0 : kUnseen;
  }
  __syncthreads();
  for (int l = 1; l <= levels; ++l) {
    int grew = 0;
    const uint16_t prev = (uint16_t)(l - 1);
    for (int i = threadIdx.x; i < v; i += blockDim.x) {
      if (lvl[i] != prev) continue;
      const int* row = neigh + (size_t)i * d;
      for (int k = 0; k < d; ++k) {
        const int j = row[k];
        if (j >= v) break;
        if (lvl[j] == kUnseen) {
          lvl[j] = (uint16_t)l;
          grew = 1;
        }
      }
    }
    if (!__syncthreads_or(grew)) break;
  }
  float* dst = out + (size_t)s * v;
  for (int i = threadIdx.x; i < v; i += blockDim.x) {
    const uint16_t x = lvl[i];
    dst[i] = (x == kUnseen) ? INFINITY : (float)x;
  }
}

}  // namespace

// neigh: [v, d] int32 device pointer; out: [v, v] f32 device pointer.
// Returns the CUDA error of the launch (0 on success).
extern "C" int bfs_launch(const int* neigh, int v, int d, int levels,
                          float* out, void* stream) {
  const size_t smem = (size_t)v * sizeof(uint16_t);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        bfs_rows, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  bfs_rows<<<v, 128, smem, (cudaStream_t)stream>>>(neigh, v, d, levels, out);
  return (int)cudaGetLastError();
}
