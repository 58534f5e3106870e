// S1: the greedy load-balanced scanner, in two forms.
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
// - tied minima are dealt round-robin by the flow's row id in its batch
//   (row mod the tie count picks the tie, in slot order), and with no
//   candidate at all slot 0 is taken, clamped to V-1, as the plain
//   version's argmax of an empty pick does;
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
// bit for bit to the plain version's. Scores are compared as
// order-preserving uint32 keys (+0 and -0 alike); base costs are finite
// (a NaN score is outside the contract).
//
// The load is kept per link slot, [V, D] float64: slot i of node n is the
// link from n to its i-th neighbour. A pick reads and adds its own slot;
// the wrapper scatters the slots to the [V, V] load, each at its
// neighbour clamped to V-1 (congestion.slot_loads_to_dense), which puts a
// no-candidate add at column V-1 as the plain version does. Neighbour
// rows hold distinct entries in ascending order, padded with entries
// >= V (kernels/bfs.py::neighbor_rows), so a real link has one slot, and
// a pad takes load only in an empty row (a no-candidate pick takes slot
// 0): every [V, V] entry gets at most one nonzero slot, and the scatter
// of the slots' float32 casts is the plain version's float32 load
// exactly.
//
// Hop counts: where every entry of `dist` is a whole number in [0, 254]
// or +inf (every BFS hop count of a fabric of diameter <= 254), the
// scanner reads them as uint8 (255 for inf), destination-major
// (hop[t][n]), so a warp's candidate reads for one flow fall in one row.
// The kernel checks this itself (no host sync); on any other entry it
// reads `dist` as float32 from global memory for that call, as before.
//
// What bounds it on an H100: a chain of dependent steps, not bytes. Each
// chunk's hops depend on the load the previous hops placed, and each
// chunk on the previous chunks, so the hops run in order (at chunk 1, one
// per sub-flow and hop, the phased leg's case) times the latency of one
// hop set the time. The bytes moved are a few MB at most, microseconds at
// 3.35 TB/s.
//
// The resident form (scan_resident), where the tables fit one block's
// 227 KB of shared memory (congestion.scan_form; config 12's V = 320,
// D = 16: 175,364 bytes) and the chunk is narrow (the phased leg's
// chunk 1, the sentinel's and the pair batches' few rows). One launch
// may scan several batches that share the fabric (a phased program's
// phases, each from its own base and a zeroed load): a block a batch,
// each on its own SM, its rows, hop budget, base, nodes and slot loads
// read from a per-batch table (congestion.route_flows_balanced_phases):
// - bound: the latency of a step inside one SM. A step with one
//   candidate is a neighbour read and then a hop-count read from shared
//   memory, a warp vote and the pick handed on by a shuffle; where
//   several candidates exist, also their scores, a warp minimum, a vote
//   and the deal. On an H100 SXM at 1,980 MHz a step took ~535 cycles
//   over config 12's 512-rank phases (chip_smoke.py, phase 20).
// - what the design does: the block loads its tables once (uint8 hop
//   counts with rows of an odd number of words, so the transposing
//   stores do not conflict; int16 neighbours; base costs per slot; a
//   zeroed float64 load per slot), and no step reads global memory. At
//   chunk 1 warp 0 runs the whole chain: the flow's node, destination,
//   weight and row id in registers, the next 32 rows' flows read with
//   one coalesced load ahead of use, dead rows skipped by a ballot, and
//   a flow that picks its destination ends there (no step that finds
//   nothing moving). A step does not diverge (a lane past the row's
//   width reads the last slot and is masked out), rows of at most 32
//   slots take a pick compiled for one group, one candidate is taken
//   without scoring, a power-of-two tie count is dealt by a mask, and
//   the chosen slot's load comes back with its neighbour in the pick's
//   shuffle, so the add is one shared-memory store by one lane, then
//   __syncwarp. `nodes` is only stored: lane p keeps the path's p-th
//   node and the warp stores the path once a flow. At chunk > 1 every
//   warp takes flows of the chunk (lane k of a warp holds one flow's
//   state), and block barriers part picks from adds. Tried on the card
//   and slower: the add stored by the lane that read the slot, residues
//   precomputed per lane, a shuffle minimum, __fns, and explicit
//   ld.shared.

// The spread form (scan_spread), where the tables do not fit or the
// chunk is wide (config 13's shards: V = 3,968, D = 56, chunk 1024;
// random_regular(256, 80)):
// - bound: the latency of a hop across the card: two grid barriers
//   (picks, then adds) and reads that miss L1 (hop counts and loads in
//   L2), a few us a hop, times the chunks' longest paths: a config 13
//   shard's 44 hops took 0.39 ms of device time on an H100 SXM, the
//   uint8 copy of dist and the scatter included (chip_smoke.py, phase
//   25).
// - what the design does: one warp per flow of the chunk, over as many
//   blocks as that takes (capped at what is co-resident; past it a warp
//   takes several flows). The barrier is a cooperative launch's
//   cg::this_grid().sync(): a 1024-flow chunk needs 1024 warps (32K
//   threads), more than a thread-block cluster holds (at most 16 blocks
//   of 1024 threads, 8 portable), so a cluster's hardware barrier would
//   cost a warp several flows picked in turn on every hop; the grid
//   spans every SM. Hop counts are read from a uint8 destination-major
//   copy that a first kernel of the same call builds in scratch the
//   wrapper allocates (15.7 MB at config 13, resident in the 50 MB L2,
//   where the float32 matrix, 63 MB, is not), with the same exactness
//   rule; base costs are gathered per slot; loads are float64 per slot
//   (1.8 MB at config 13), read through L2 (__ldcg) and added with
//   global atomics. A hop ends the chunk's walk when no flow moves
//   (flags in global memory, read after the barrier).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;
// dynamic shared memory one block may use on sm_90
constexpr long long kSmemMax = 232448;
constexpr int kResidentThreads = 512;
constexpr int kSpreadThreads = 256;
constexpr int kSpreadWarps = kSpreadThreads / 32;
// the uint8 hop count of an unreachable pair
constexpr int kNoHop = 255;

// bytes of one row of the resident hop table: an odd number of words, so
// that 32 consecutive rows start in 32 different banks
__host__ __device__ inline int resident_stride(int v) {
  int w = (v + 3) / 4;
  if (!(w & 1)) ++w;
  return 4 * w;
}

// the resident form's shared memory: [V, D] f64 loads, [V, D] f32 base
// costs, [V, D] int16 neighbours (rounded up to a word), [V] hop rows,
// and one word for the last live row (the kernel has no static shared
// memory, so all 227 KB are the layout's)
__host__ __device__ inline long long resident_bytes(int v, int d) {
  const long long vd = (long long)v * d;
  return 12 * vd + 4 * ((2 * vd + 3) / 4) + (long long)v * resident_stride(v) + 4;
}

// a hop count as uint8 when it is a whole number in [0, 254] or +inf;
// anything else sets `bad`
__device__ __forceinline__ uint8_t narrow(float x, bool& bad) {
  if (x == INFINITY) return (uint8_t)kNoHop;
  if (x >= 0.0f && x <= 254.0f && x == truncf(x)) return (uint8_t)x;
  bad = true;
  return (uint8_t)kNoHop;
}

// an order-preserving key of a float32 score, +0 and -0 alike
__device__ __forceinline__ unsigned score_key(float s) {
  const unsigned u = __float_as_uint(s == 0.0f ? 0.0f : s);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// the slot of the r-th set bit of a 32-slot group's mask, in every lane
__device__ __forceinline__ int nth_set(unsigned mask, int r, int lane) {
  const bool mine = (mask >> lane) & 1u;
  const int rank = __popc(mask & ((1u << lane) - 1u));
  return __ffs(__ballot_sync(kFull, mine && rank == r)) - 1;
}


// hop counts, uint8 destination-major: at(t, n) is n's hop count to t
template <bool kGlobal>
struct HopU8 {
  using H = int;
  const uint8_t* p;
  int stride;
  __device__ __forceinline__ H at(int t, int n) const {
    if (kGlobal) return (int)__ldg(p + (long long)t * stride + n);
    return (int)p[t * stride + n];
  }
  static __device__ __forceinline__ H want(H h) { return h == kNoHop ? kNoHop : h - 1; }
  static __device__ __forceinline__ bool reachable(H h) { return h != kNoHop; }
};

// hop counts as given: the [V, V] f32 matrix, row-major
struct HopF32 {
  using H = float;
  const float* p;
  int v;
  __device__ __forceinline__ H at(int t, int n) const {
    return __ldg(p + (long long)n * v + t);
  }
  static __device__ __forceinline__ H want(H h) { return h - 1.0f; }
  static __device__ __forceinline__ bool reachable(H h) { return isfinite(h); }
};

// the resident tables, in shared memory
struct SharedTabs {
  const int16_t* nb;
  const float* base;
  double* load;
  int d, v;
  __device__ __forceinline__ int nbr(int node, int i) const { return nb[node * d + i]; }
  __device__ __forceinline__ float cost(int node, int i) const {
    return base[node * d + i];
  }
  __device__ __forceinline__ double ld(int node, int i) const {
    return load[node * d + i];
  }
  __device__ __forceinline__ void add(int node, int j, double w) const {
    atomicAdd(load + node * d + j, w);
  }
};

// the spread tables, in global memory; loads read through L2, where the
// other SMs' atomics land
struct GlobalTabs {
  const int* nb;
  const float* base;
  double* load;
  int d, v;
  __device__ __forceinline__ int nbr(int node, int i) const {
    return __ldg(nb + (long long)node * d + i);
  }
  __device__ __forceinline__ float cost(int node, int i) const {
    return __ldg(base + (long long)node * d + i);
  }
  __device__ __forceinline__ double ld(int node, int i) const {
    return __ldcg(load + (long long)node * d + i);
  }
  __device__ __forceinline__ void add(int node, int j, double w) const {
    atomicAdd(load + (long long)node * d + j, w);
  }
};

// one neighbour slot of a hop: its entry (>= V past the row's end),
// whether it is an equal-cost candidate, its base cost and load as read
// (scored only where several candidates tie)
struct Slot {
  int nb;
  bool ok;
  float cost;
  double ld;
};

// a slot's score key: all ones when it is not a candidate
__device__ __forceinline__ unsigned slot_key(const Slot& s) {
  return s.ok ? score_key(s.cost + __double2float_rn(s.ld)) : kFull;
}

template <class Tabs, class Hop>
__device__ __forceinline__ Slot slot_at(const Tabs& tb, const Hop& hp, int node, int i,
                                        int t, typename Hop::H want) {
  // branch-free: a slot past the row's width reads the last slot's
  // entries (in bounds) and is masked out, so the warp never diverges
  const bool in = i < tb.d;
  const int ii = in ? i : tb.d - 1;
  const int nb0 = tb.nbr(node, ii);
  const float cost = tb.cost(node, ii);
  const double ld = tb.ld(node, ii);
  const int nb = in ? nb0 : tb.v;
  const bool real = nb < tb.v;
  const bool ok = real && hp.at(t, real ? nb : tb.v - 1) == want;
  return Slot{nb, ok, cost, ld};
}

// a flow's pick at one hop: its slot, the next node (clamped to V-1),
// whether any candidate existed and the slot's load as read (where it
// is one of the first 64 slots); the same in every lane of the warp
struct Pick {
  int j;
  int nb;
  bool cand;
  double ld;
};

// the warp picks for one flow: lanes over the neighbour slots in groups
// of 32 (the first 64 kept in registers, the rest read again); kOne: the
// row is at most 32 slots wide (D <= 32), and the other groups compile away
template <bool kOne, class Tabs, class Hop>
__device__ __forceinline__ Pick pick(const Tabs& tb, const Hop& hp, int node, int t,
                                     typename Hop::H want, unsigned row, int lane) {
  const int d = kOne ? 32 : tb.d;
  const Slot a = slot_at(tb, hp, node, lane, t, want);
  Slot b{tb.v, false, 0.0f, 0.0};
  if (d > 32) b = slot_at(tb, hp, node, lane + 32, t, want);
  const unsigned ca = __ballot_sync(kFull, a.ok);
  const unsigned cb = d > 32 ? __ballot_sync(kFull, b.ok) : 0u;
  int n_cand = __popc(ca) + __popc(cb);
  for (int s0 = 64; s0 < d; s0 += 32) {
    n_cand += __popc(__ballot_sync(kFull, slot_at(tb, hp, node, s0 + lane, t, want).ok));
  }
  int j = 0;
  if (n_cand == 1 && d <= 64) {
    // one candidate is its own minimum
    j = ca ? __ffs(ca) - 1 : 32 + __ffs(cb) - 1;
  } else if (n_cand > 0) {
    const unsigned ka = slot_key(a);
    const unsigned kb = slot_key(b);
    unsigned mn = min(ka, kb);
    for (int s0 = 64; s0 < d; s0 += 32) {
      mn = min(mn, slot_key(slot_at(tb, hp, node, s0 + lane, t, want)));
    }
    mn = __reduce_min_sync(kFull, mn);
    const unsigned ta = __ballot_sync(kFull, a.ok && ka == mn);
    const unsigned tb2 = d > 32 ? __ballot_sync(kFull, b.ok && kb == mn) : 0u;
    int m = __popc(ta) + __popc(tb2);
    for (int s0 = 64; s0 < d; s0 += 32) {
      const Slot c = slot_at(tb, hp, node, s0 + lane, t, want);
      m += __popc(__ballot_sync(kFull, c.ok && slot_key(c) == mn));
    }
    // the (row mod m)-th tied slot (a mask where m is a power of two, as
    // a fat-tree's uplinks tie): walk the groups to the one that holds
    // it, then take its set bit of that rank
    const unsigned um = (unsigned)m;
    int r = (int)((um & (um - 1)) ? row % um : row & (um - 1));
    if (kOne || r < __popc(ta)) {
      j = nth_set(ta, r, lane);
    } else if ((r -= __popc(ta)) < __popc(tb2)) {
      j = 32 + nth_set(tb2, r, lane);
    } else {
      r -= __popc(tb2);
      for (int s0 = 64;; s0 += 32) {
        const Slot c = slot_at(tb, hp, node, s0 + lane, t, want);
        const unsigned tc = __ballot_sync(kFull, c.ok && slot_key(c) == mn);
        if (r < __popc(tc)) {
          j = s0 + nth_set(tc, r, lane);
          break;
        }
        r -= __popc(tc);
      }
    }
  }
  // j is the same in every lane, and below d; the slot's load comes with
  // its entry, so the add needs no second read
  int nb;
  double ld = 0.0;
  if (kOne || j < 32) {
    nb = __shfl_sync(kFull, a.nb, j);
    ld = __shfl_sync(kFull, a.ld, j);
  } else if (j < 64) {
    nb = __shfl_sync(kFull, b.nb, j - 32);
    ld = __shfl_sync(kFull, b.ld, j - 32);
  } else {
    nb = tb.nbr(node, j);
    ld = tb.ld(node, j);
  }
  return Pick{j, nb < tb.v ? nb : tb.v - 1, n_cand > 0, ld};
}

// chunk 1 in one warp: every flow walks to its destination in turn,
// reading the load every earlier flow placed
template <bool kOne, class Hop>
__device__ __forceinline__ void chain_one(const SharedTabs& tb, const Hop& hp,
                                          const int* src, const int* dst,
                                          const float* weight, int n_live, int max_len,
                                          int* nodes, int lane) {
  using H = typename Hop::H;
  int ns = -1, nt = -1;
  float nw = 0.0f;
  if (lane < n_live) {
    ns = src[lane];
    nt = dst[lane];
    nw = weight[lane];
  }
  for (int base = 0; base < n_live; base += 32) {
    const int s = ns, t = nt;
    const float w = nw;
    // the next window of 32 rows, read while this one runs
    const int ahead = base + 32 + lane;
    ns = nt = -1;
    if (ahead < n_live) {
      ns = src[ahead];
      nt = dst[ahead];
      nw = weight[ahead];
    }
    H h0 = H();
    bool alive = false;
    if (s >= 0 && t >= 0) {
      h0 = hp.at(t, s);
      alive = Hop::reachable(h0);
    }
    for (unsigned live = __ballot_sync(kFull, alive); live; live &= live - 1) {
      const int k = __ffs(live) - 1;
      const int row = base + k;
      int node = __shfl_sync(kFull, s, k);
      const int dest = __shfl_sync(kFull, t, k);
      const double wk = (double)__shfl_sync(kFull, w, k);
      H h = __shfl_sync(kFull, h0, k);
      int* out = nodes + (long long)row * max_len;
      // lane p holds the node at position p < 32 of the path, stored
      // once when the flow ends
      int at = lane == 0 ? node : -1;
      int step = 0;
      for (; step < max_len && node != dest; ++step) {
        const H want = Hop::want(h);
        const Pick p = pick<kOne>(tb, hp, node, dest, want, (unsigned)row, lane);
        // one warp: nothing else writes the slot since it was read
        if (lane == 0) tb.load[node * tb.d + p.j] = p.ld + wk;
        __syncwarp();
        at = lane == step + 1 ? p.nb : at;
        if (step + 1 >= 32 && step + 1 < max_len && lane == 0) out[step + 1] = p.nb;
        h = p.cand ? want : hp.at(dest, p.nb);
        node = p.nb;
      }
      if (lane <= step && lane < max_len) out[lane] = at;
    }
  }
}

// a block's barriers, for the resident form's chunks
struct BlockSync {
  __device__ __forceinline__ bool any(bool x) { return __syncthreads_or(x); }
  __device__ __forceinline__ void sync() { __syncthreads(); }
};

// a cooperative grid's barriers, for the spread form: `any` votes through
// three flags in global memory, one set per step and the next one
// cleared for reuse (its readers are two barriers back)
struct GridSync {
  int* flags;
  unsigned step;
  __device__ __forceinline__ bool any(bool x) {
    const unsigned slot = step % 3;
    if (__any_sync(kFull, x) && (threadIdx.x & 31) == 0) __stcg(flags + slot, 1);
    if (blockIdx.x == 0 && threadIdx.x == 0) __stcg(flags + (step + 1) % 3, 0);
    cg::this_grid().sync();
    ++step;
    return __ldcg(flags + slot) != 0;
  }
  __device__ __forceinline__ void sync() { cg::this_grid().sync(); }
};

// chunks of many flows: lane k of warp `warp` (of `n_warps`) holds flow
// warp + k * n_warps of the chunk; a hop's picks, a barrier, its adds
template <bool kOne, class Tabs, class Hop, class Sync>
__device__ __forceinline__ void chain_chunks(const Tabs& tb, const Hop& hp, Sync& sy,
                                             const int* src, const int* dst,
                                             const float* weight, int n_live,
                                             long long chunk, int max_len, int* nodes,
                                             int warp, int n_warps, int lane) {
  using H = typename Hop::H;
  for (long long c0 = 0; c0 < n_live; c0 += chunk) {
    const long long rows = chunk < n_live - c0 ? chunk : n_live - c0;
    const long long f = warp + (long long)lane * n_warps;
    const long long row = c0 + f;
    int s = -1, t = -1;
    float w = 0.0f;
    if (f < rows) {
      s = src[row];
      t = dst[row];
      w = weight[row];
    }
    int node = -1;
    H h = H();
    if (s >= 0 && t >= 0) {
      h = hp.at(t, s);
      if (Hop::reachable(h)) node = s;
    }
    int* out = nodes + (f < rows ? row * max_len : 0);
    if (node >= 0) out[0] = node;
    // the first vote: whether any flow of the chunk moves (and the
    // barrier after the last chunk's adds)
    bool go = sy.any(node >= 0 && node != t);
    for (int step = 0; go && step < max_len; ++step) {
      const bool moving = node >= 0 && node != t;
      int j = 0, next = -1;
      bool cand = true;
      H hn = H();
      for (unsigned mv = __ballot_sync(kFull, moving); mv; mv &= mv - 1) {
        const int k = __ffs(mv) - 1;
        const int nk = __shfl_sync(kFull, node, k);
        const int tk = __shfl_sync(kFull, t, k);
        const H want = Hop::want(__shfl_sync(kFull, h, k));
        const unsigned rk = (unsigned)__shfl_sync(kFull, (int)row, k);
        const Pick p = pick<kOne>(tb, hp, nk, tk, want, rk, lane);
        if (lane == k) {
          j = p.j;
          next = p.nb;
          cand = p.cand;
          hn = want;
        }
      }
      // every pick of the hop has read the load before any add; the vote
      // says whether a flow moves on at the next hop
      go = sy.any(moving && next != t && step + 1 < max_len);
      if (moving) {
        tb.add(node, j, (double)w);
        if (step + 1 < max_len) out[step + 1] = next;
        h = cand ? hn : hp.at(t, next);
        node = next;
      }
      // the adds are in before the next hop's picks
      if (go) sy.sync();
    }
  }
}

// the last live row + 1, scanning back from the end in windows of four
// loads a thread (`found` a word of shared memory): trailing pads are
// read, never routed
__device__ int last_live(const int* src, long long u, int& found) {
  const int tid = threadIdx.x, n_threads = blockDim.x;
  if (tid == 0) found = 0;
  __syncthreads();
  const long long span = 4LL * n_threads;
  for (long long hi = u; hi > 0; hi -= span) {
    const long long lo = hi > span ? hi - span : 0;
    long long mine = -1;
    for (long long i = lo + tid; i < hi; i += n_threads) {
      if (src[i] >= 0) mine = i;
    }
    if (__syncthreads_or(mine >= 0)) {
      if (mine >= 0) atomicMax(&found, (int)(mine + 1));
      break;
    }
  }
  __syncthreads();
  return found;
}

// the resident form's walk: chunk 1 in warp 0, wider chunks in every warp
template <bool kOne>
__device__ __forceinline__ void run_resident(const SharedTabs& tb, const float* dist,
                                             const uint8_t* hop, int hs, bool wide,
                                             const int* src, const int* dst,
                                             const float* weight, int n_live,
                                             long long chunk, int max_len, int* nodes) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int v = tb.v;
  if (chunk == 1) {
    if (warp != 0) return;
    if (wide) {
      chain_one<kOne>(tb, HopF32{dist, v}, src, dst, weight, n_live, max_len, nodes,
                      lane);
    } else {
      chain_one<kOne>(tb, HopU8<false>{hop, hs}, src, dst, weight, n_live, max_len, nodes,
                      lane);
    }
    return;
  }
  BlockSync sy;
  const int n_warps = blockDim.x / 32;
  if (wide) {
    chain_chunks<kOne>(tb, HopF32{dist, v}, sy, src, dst, weight, n_live, chunk, max_len,
                       nodes, warp, n_warps, lane);
  } else {
    chain_chunks<kOne>(tb, HopU8<false>{hop, hs}, sy, src, dst, weight, n_live, chunk,
                       max_len, nodes, warp, n_warps, lane);
  }
}

// one block a batch: with `batches` null the call's one batch, else
// block b's (row0, rows, max_len, nodes0) at batches[4b .. 4b + 3], its
// base at base + b V^2 and its slot loads at slot_load + b V D
__global__ void __launch_bounds__(kResidentThreads, 1)
scan_resident(const int* __restrict__ neigh, int v, int d, const float* __restrict__ dist,
              const float* __restrict__ base, const int* __restrict__ src,
              const int* __restrict__ dst, const float* __restrict__ weight, long long u,
              int max_len, long long chunk, int* __restrict__ nodes,
              double* __restrict__ slot_load, const long long* __restrict__ batches) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int vd = v * d;
  if (batches != nullptr) {
    const long long* m = batches + 4LL * blockIdx.x;
    src += m[0];
    dst += m[0];
    weight += m[0];
    u = m[1];
    max_len = (int)m[2];
    nodes += m[3];
    base += (long long)blockIdx.x * v * v;
    slot_load += (long long)blockIdx.x * vd;
  }
  double* ld = reinterpret_cast<double*>(smem);
  float* bs = reinterpret_cast<float*>(smem + 8LL * vd);
  int16_t* nb = reinterpret_cast<int16_t*>(smem + 12LL * vd);
  uint8_t* hop = smem + 12LL * vd + 4LL * ((2LL * vd + 3) / 4);
  const int hs = resident_stride(v);
  int* found = reinterpret_cast<int*>(hop + (long long)v * hs);
  const int tid = threadIdx.x, n_threads = blockDim.x;

  // the prologue: every table read from global memory once
  for (int i = tid; i < vd; i += n_threads) {
    const int n = neigh[i];
    ld[i] = 0.0;
    nb[i] = (int16_t)(n < v ? n : v);
    bs[i] = base[(long long)(i / d) * v + (n < v ? n : v - 1)];
  }
  bool bad = false;
  for (int i = tid; i < v * v; i += n_threads) {
    hop[(i % v) * hs + i / v] = narrow(dist[i], bad);
  }
  const bool wide = __syncthreads_or(bad);
  const int n_live = last_live(src, u, *found);

  const SharedTabs tb{nb, bs, ld, d, v};
  if (d <= 32) {
    run_resident<true>(tb, dist, hop, hs, wide, src, dst, weight, n_live, chunk, max_len,
                       nodes);
  } else {
    run_resident<false>(tb, dist, hop, hs, wide, src, dst, weight, n_live, chunk, max_len,
                        nodes);
  }
  // the epilogue: the slot loads out, for the wrapper's scatter
  __syncthreads();
  for (int i = tid; i < vd; i += n_threads) slot_load[i] = ld[i];
}

// the spread form's hop table: dist narrowed to uint8 and transposed
// through 64 x 64 tiles (rows of 68 bytes: the tile's stores do not
// conflict), 16 bytes a store; flags[0] set on an entry that does not
// narrow
__global__ void __launch_bounds__(256)
spread_hops(const float* __restrict__ dist, int v, uint8_t* __restrict__ hop, int hs,
            int* flags) {
  __shared__ __align__(16) uint8_t tile[64][68];  // [t - t0][n - n0]
  const int t0 = blockIdx.x * 64, n0 = blockIdx.y * 64;
  const int tx = threadIdx.x & 63, ty = threadIdx.x >> 6;
  bool bad = false;
  for (int r = ty; r < 64; r += 4) {
    const int n = n0 + r, t = t0 + tx;
    uint8_t q = (uint8_t)kNoHop;
    if (n < v && t < v) q = narrow(dist[(long long)n * v + t], bad);
    tile[tx][r] = q;
  }
  __syncthreads();
  const int tl = threadIdx.x >> 2, part = threadIdx.x & 3;
  const int t = t0 + tl, n = n0 + 16 * part;
  if (t < v && n < hs) {
    const uint32_t* w = reinterpret_cast<const uint32_t*>(&tile[tl][16 * part]);
    *reinterpret_cast<uint4*>(hop + (long long)t * hs + n) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
  if (__syncthreads_or(bad) && threadIdx.x == 0) atomicOr(flags, 1);
}

// the spread form's slot tables: base costs gathered per slot, and the
// last live row + 1 into flags[1]
__global__ void __launch_bounds__(256)
spread_slots(const int* __restrict__ neigh, int v, int d, const float* __restrict__ base,
             float* __restrict__ base_slot, const int* __restrict__ src, long long u,
             int* flags) {
  const long long vd = (long long)v * d;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long i = first; i < vd; i += stride) {
    const int n = neigh[i];
    base_slot[i] = base[(i / d) * v + (n < v ? n : v - 1)];
  }
  unsigned mine = 0;
  for (long long i = first; i < u; i += stride) {
    if (src[i] >= 0) mine = (unsigned)(i + 1);
  }
  mine = __reduce_max_sync(kFull, mine);
  if ((threadIdx.x & 31) == 0 && mine) {
    atomicMax(reinterpret_cast<unsigned*>(flags + 1), mine);
  }
}

__global__ void __launch_bounds__(kSpreadThreads)
scan_spread(const int* __restrict__ neigh, int v, int d, const float* __restrict__ dist,
            const uint8_t* __restrict__ hop, int hs, const float* __restrict__ base_slot,
            const int* __restrict__ src, const int* __restrict__ dst,
            const float* __restrict__ weight, int max_len, long long chunk,
            int* __restrict__ nodes, double* slot_load, int* flags) {
  const int n_live = __ldcg(flags + 1);
  const bool wide = __ldcg(flags) != 0;
  const GlobalTabs tb{neigh, base_slot, slot_load, d, v};
  GridSync sy{flags + 2, 0u};
  const int lane = threadIdx.x & 31;
  const int warp = (int)((blockIdx.x * blockDim.x + threadIdx.x) >> 5);
  const int n_warps = (int)(gridDim.x * blockDim.x >> 5);
  if (d <= 32) {
    if (wide) {
      chain_chunks<true>(tb, HopF32{dist, v}, sy, src, dst, weight, n_live, chunk,
                         max_len, nodes, warp, n_warps, lane);
    } else {
      chain_chunks<true>(tb, HopU8<true>{hop, hs}, sy, src, dst, weight, n_live, chunk,
                         max_len, nodes, warp, n_warps, lane);
    }
  } else if (wide) {
    chain_chunks<false>(tb, HopF32{dist, v}, sy, src, dst, weight, n_live, chunk, max_len,
                        nodes, warp, n_warps, lane);
  } else {
    chain_chunks<false>(tb, HopU8<true>{hop, hs}, sy, src, dst, weight, n_live, chunk,
                        max_len, nodes, warp, n_warps, lane);
  }
}

int g_spread_blocks_per_sm = 0;
int g_sms = 0;
bool g_resident_attr = false;

}  // namespace

// Greedy scan of `u` flows; form 0 is the resident form, 1 the spread
// form. The caller zeroes nothing for the resident form; for the spread
// form it passes zeroed `slot_load` [V, D] f64 and `flags` [5] int32,
// and scratch `hop8` [V, hs8] uint8 (hs8 a multiple of 16, >= V) and
// `base_slot` [V, D] f32. `nodes` [u, max_len] int32 holds -1. With
// `batches` > 1 (the resident form only), `batch` [batches, 4] int64 on
// the card holds each batch's (row0, rows, max_len, nodes0) into the
// concatenated src, dst, weight and nodes, `base` [batches, V, V] and
// `slot_load` [batches, V, D]; `u` and `max_len` are then the largest
// batch's rows and hop budget.
extern "C" int scan_launch(int form, const int* neigh, int v, int d, const float* dist,
                           const float* base, const int* src, const int* dst,
                           const float* weight, long long u, int max_len, long long chunk,
                           int* nodes, double* slot_load, uint8_t* hop8, int hs8,
                           float* base_slot, int* flags, int batches,
                           const long long* batch, void* stream) {
  if (v < 1 || d < 1 || u < 1 || u > 0x7fffffffLL || max_len < 1 || chunk < 1 ||
      batches < 1 || (batches > 1 && (form != 0 || batch == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  const long long width = chunk < u ? chunk : u;
  if (form == 0) {
    const long long bytes = resident_bytes(v, d);
    if (bytes > kSmemMax || width > kResidentThreads) return (int)cudaErrorInvalidValue;
    if (!g_resident_attr) {
      const cudaError_t e = cudaFuncSetAttribute(
          scan_resident, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemMax);
      if (e != cudaSuccess) return (int)e;
      g_resident_attr = true;
    }
    scan_resident<<<batches, kResidentThreads, (size_t)bytes, st>>>(
        neigh, v, d, dist, base, src, dst, weight, u, max_len, chunk, nodes, slot_load,
        batches > 1 ? batch : nullptr);
    return (int)cudaGetLastError();
  }
  if (form != 1 || hs8 < v || hs8 % 16 != 0) return (int)cudaErrorInvalidValue;
  if (g_sms == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) {
      e = cudaDeviceGetAttribute(&g_sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (e == cudaSuccess) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &g_spread_blocks_per_sm, scan_spread, kSpreadThreads, 0);
    }
    if (e != cudaSuccess) {
      g_sms = 0;
      return (int)e;
    }
  }
  // one warp a flow of the chunk, up to what is co-resident
  const long long cap = (long long)g_spread_blocks_per_sm * g_sms * kSpreadWarps;
  const long long warps = width < cap ? width : cap;
  if (warps < 1 || width > 32 * warps) return (int)cudaErrorInvalidValue;
  const int tiles = (v + 63) / 64;
  spread_hops<<<dim3(tiles, tiles), 256, 0, st>>>(dist, v, hop8, hs8, flags);
  const long long vd = (long long)v * d;
  const long long most = vd > u ? vd : u;
  const int slot_blocks = (int)((most + 255) / 256 < 1024 ? (most + 255) / 256 : 1024);
  spread_slots<<<slot_blocks, 256, 0, st>>>(neigh, v, d, base, base_slot, src, u, flags);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  void* args[] = {(void*)&neigh, (void*)&v,        (void*)&d,       (void*)&dist,
                  (void*)&hop8,  (void*)&hs8,      (void*)&base_slot, (void*)&src,
                  (void*)&dst,   (void*)&weight,   (void*)&max_len, (void*)&chunk,
                  (void*)&nodes, (void*)&slot_load, (void*)&flags};
  const int blocks = (int)((warps + kSpreadWarps - 1) / kSpreadWarps);
  e = cudaLaunchCooperativeKernel((const void*)scan_spread, dim3(blocks),
                                  dim3(kSpreadThreads), args, 0, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
