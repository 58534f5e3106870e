// S2: the greedy phase packer, one warp per call.
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
// weight. A row with s < 0 adds nothing (the plain version adds 0.0,
// which leaves every non-negative float32 as it was) and gets -1.
// Compiled without fast-math: the adds and the max round as numpy's do.
//
// What bounds it on an H100: a chain of dependent steps, not bytes. Row
// i's choice reads the state rows 0 .. i-1 left, so G rows take G steps
// in order (4,096 at config 12), each a few state reads from L1, a warp
// reduction and two adds. The bytes (the rows and the background, read
// once; the phases written once) take microseconds.
//
// What the design does about it: one warp keeps the whole [K, 2V]
// float32 state (out loads, then in loads, per phase) in a zeroed device
// buffer, which stays in the SM's L1 and L2 (10 KB at config 12, V = 320
// and K = 4; 508 KB at V = 3,968 and K = 16). On an H100 this placement
// took 1.0246 ms against 0.9938 ms for the state in shared memory at
// config 12's 4,096 rows, zeroing included, so the kernel keeps the one
// placement that takes every V. A step is short: lane k scores phase k
// (K <= 32), the float32 costs become order-preserving unsigned keys,
// __reduce_min_sync takes the least and the lowest set bit of a
// __ballot_sync of the lanes that hold it gives the first minimum; lane
// 0 adds the weight, and __syncwarp orders its stores before the next
// step's loads. The rows are read 32 at a time, one per lane, and
// handed to the steps by shuffles, so no step waits on their loads.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxPhases = 32;

// an unsigned key in the order of the float32 value (+0 and -0 alike)
__device__ __forceinline__ unsigned order_key(float x) {
  const unsigned b = __float_as_uint(x == 0.0f ? 0.0f : x);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__global__ void pack_rows(const int* __restrict__ src, const int* __restrict__ dst,
                          const float* __restrict__ w,
                          const float* __restrict__ util_out,
                          const float* __restrict__ util_in, int g, int v, int k,
                          float* state, int* __restrict__ out) {
  const int lane = threadIdx.x;
  const int row_len = 2 * v;
  float* mine = state + (size_t)(lane < k ? lane : 0) * row_len;
  for (int b = 0; b < g; b += 32) {
    const int i = b + lane;
    int s = -1, d = 0;
    float wt = 0.0f;
    if (i < g) {
      s = src[i];
      d = dst[i] < 0 ? 0 : dst[i];
      wt = w[i];
    }
    const int n = g - b < 32 ? g - b : 32;
    for (int r = 0; r < n; ++r) {
      const int rs = __shfl_sync(kFull, s, r);
      const int rd = __shfl_sync(kFull, d, r);
      const float rw = __shfl_sync(kFull, wt, r);
      if (rs < 0) {
        if (lane == 0) out[b + r] = -1;
        continue;
      }
      unsigned key = 0xffffffffu;
      if (lane < k) {
        key = order_key(fmaxf(util_out[rs] + mine[rs], util_in[rd] + mine[v + rd]));
      }
      const unsigned least = __reduce_min_sync(kFull, key);
      const int ph = __ffs(__ballot_sync(kFull, key == least)) - 1;
      if (lane == 0) {
        float* chosen = state + (size_t)ph * row_len;
        chosen[rs] += rw;
        chosen[v + rd] += rw;
        out[b + r] = ph;
      }
      __syncwarp();
    }
  }
}

}  // namespace

// state: a zeroed [K, 2V] float32 buffer on the card
extern "C" int pack_launch(const int* src, const int* dst, const float* w,
                           const float* util_out, const float* util_in, int g,
                           int v, int k, float* state, int* out, void* stream) {
  if (g < 1 || v < 1 || k < 1 || k > kMaxPhases || state == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  pack_rows<<<1, 32, 0, (cudaStream_t)stream>>>(src, dst, w, util_out, util_in, g,
                                                v, k, state, out);
  return (int)cudaGetLastError();
}
