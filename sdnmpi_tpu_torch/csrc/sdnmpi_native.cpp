// Native host-side runtime kernels of the PyTorch port's controller.
//
// The device computes routes; the host decodes and installs them. At
// alltoall scale the readback path handles ~10^5 flows per collective,
// and the Python/numpy implementations of these steps (slot decoding,
// scatter-add link accounting, fdb materialization, pair grouping and
// dealing, announcement parsing) become the controller's serial
// bottleneck — np.add.at alone is ~50x slower than a fused loop. These
// C ABI kernels are loaded via ctypes (sdnmpi_tpu_torch/native.py), which
// keeps a pure-numpy fallback for every entry point but the fused
// grouping pair. Wire formats mirror protocol/announcement.py
// (reference: sdnmpi/protocol/announcement.py:3-18).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

// Run body(begin, end) over the rows [0, f), split across the host's
// cores (at most 8) where the batch holds enough cells to pay for the
// threads. Each row is written by one thread alone, so the split
// changes no output; a thread that cannot start runs its rows here.
template <class Body>
static void for_rows(int64_t f, int64_t cells_per_row, Body body) {
  const int64_t min_cells = int64_t(1) << 20;  // ~1 ms of work a thread
  int64_t n = std::min<int64_t>(std::thread::hardware_concurrency(), 8);
  n = std::min<int64_t>(n, f * cells_per_row / min_cells);
  if (n <= 1) { body(int64_t(0), f); return; }
  const int64_t step = (f + n - 1) / n;
  std::vector<std::thread> pool;
  for (int64_t b = step; b < f; b += step) {
    const int64_t e = std::min(f, b + step);
    try {
      pool.emplace_back(body, b, e);
    } catch (...) {
      body(b, e);
    }
  }
  body(int64_t(0), std::min(f, step));
  for (auto& th : pool) th.join();
}

extern "C" {

// Decode per-flow neighbor-slot streams back to node paths.
//
// slots:  [F, L] int8  — slot h = rank of the chosen neighbor among the
//                        current node's sorted out-neighbors; -1 = end
// order:  [V, D] int32 — sorted out-neighbor table (entries >= V invalid)
// src:    [F] int32    — start nodes (-1 = dead flow)
// dst:    [F] int32    — destinations (distinguishes src==dst from dead)
// complete: nonzero -> the slot stream omits the forced final hop (see
//           oracle/dag.sampled_hops); the decoder emits the walked node
//           at column L and appends dst at column L+1 when the walked
//           node is a verified neighbor of dst. Output is then [F, L+2]
//           (entire row -1 if the walk ends non-adjacent to dst —
//           truncated, not installable). Zero -> output [F, L] raw walk.
//
// Mirrors sdnmpi_tpu.oracle.dag.slots_to_nodes exactly.
void decode_slots(const int8_t* slots, const int32_t* order,
                  const int32_t* src, const int32_t* dst,
                  int64_t f, int64_t l, int64_t v, int64_t d,
                  int32_t complete, int32_t* nodes) {
  if (l == 0) return;
  const int64_t out_l = complete ? l + 2 : l;
  for_rows(f, out_l, [=](int64_t begin, int64_t end) {
  for (int64_t i = begin; i < end; ++i) {
    const int8_t* srow = slots + i * l;
    int32_t* nrow = nodes + i * out_l;
    bool valid = (srow[0] >= 0) || (src[i] >= 0 && src[i] == dst[i]);
    int32_t node = valid ? src[i] : -1;
    for (int64_t h = 0; h < l; ++h) {
      nrow[h] = node;
      int8_t s = srow[h];
      if (s >= 0 && node >= 0 && s < d) {
        int32_t nxt = order[(int64_t)node * d + s];
        node = (nxt < v) ? nxt : -1;
      } else {
        node = -1;
      }
    }
    if (complete) {
      nrow[l] = node;
      nrow[l + 1] = -1;
      if (node >= 0 && node != dst[i]) {
        bool adjacent = false;  // linear scan of the sorted slot row
        const int32_t* orow = order + (int64_t)node * d;
        for (int64_t k = 0; k < d && orow[k] < v; ++k) {
          if (orow[k] == dst[i]) { adjacent = true; break; }
        }
        if (adjacent) {
          nrow[l + 1] = dst[i];
        } else {  // truncated walk: whole row not installable
          for (int64_t h = 0; h < out_l; ++h) nrow[h] = -1;
        }
      }
    }
  }
  });
}

// Accumulate per-link loads from node paths: load[a, b] += w per hop.
// nodes: [F, L] int32 (-1 padded), weight: [F] f32, load: [V, V] f32
// (caller zeroes). Replaces np.add.at (buffered fancy-index scatter).
void link_loads(const int32_t* nodes, const float* weight,
                int64_t f, int64_t l, int64_t v, float* load) {
  for (int64_t i = 0; i < f; ++i) {
    const int32_t* row = nodes + i * l;
    const float w = weight[i];
    for (int64_t h = 0; h + 1 < l; ++h) {
      const int32_t a = row[h], b = row[h + 1];
      if (a >= 0 && b >= 0) load[(int64_t)a * v + b] += w;
    }
  }
}

// Materialize (dpid, out_port) fdb hop lists from node paths.
//
// paths:  [F, L] int32 node rows (-1 padded)
// port:   [V, V] int32 out-port matrix
// dpids:  [V] int64 row index -> dpid
// dstsw:  [F] int32 required final switch (install only if the path
//                   ends there; -1 = accept any endpoint)
// final_port: [F] int32 port appended at the last switch
// out_dpid/out_port: [F, L] int64/int32, -1 padded
// out_len: [F] int32 number of hops written (0 = not installable)
void materialize_fdbs(const int32_t* paths, const int32_t* port,
                      const int64_t* dpids, const int32_t* dstsw,
                      const int32_t* final_port,
                      int64_t f, int64_t l, int64_t v,
                      int64_t* out_dpid, int32_t* out_port_arr,
                      int32_t* out_len) {
  for_rows(f, l, [=](int64_t begin, int64_t end) {
  for (int64_t i = begin; i < end; ++i) {
    const int32_t* row = paths + i * l;
    int64_t* od = out_dpid + i * l;
    int32_t* op = out_port_arr + i * l;
    int64_t n = 0;
    while (n < l && row[n] >= 0) ++n;
    out_len[i] = 0;
    bool ok = n > 0 && (dstsw[i] < 0 || row[n - 1] == dstsw[i]);
    // last line of defense before flow install: every consecutive hop
    // must be a real link (port >= 0), or a malformed/discontinuous
    // stitched path that happens to end at dst would install a garbage
    // port (mirrors decode_slots' adjacency guard); one pass checks and
    // writes, and a row that fails is padded whole
    int64_t h = 0;
    for (; ok && h + 1 < n; ++h) {
      const int32_t p = port[(int64_t)row[h] * v + row[h + 1]];
      if (p < 0) { ok = false; break; }
      od[h] = dpids[row[h]];
      op[h] = p;
    }
    if (ok) {
      od[n - 1] = dpids[row[n - 1]];
      op[n - 1] = final_port[i];
      out_len[i] = (int32_t)n;
      h = n;
    } else {
      h = 0;
    }
    for (; h < l; ++h) { od[h] = -1; op[h] = -1; }
  }
  });
}

// Fused per-pair grouping: endpoint -> edge-switch LUT gathers, the
// dense (src_edge, dst_edge) key, and the per-key histogram in ONE
// O(F) pass (the numpy equivalent runs five 16.7M-element passes).
// key_out[i] = -1 marks a pair with an unresolved endpoint.
void group_pairs(const int32_t* src_idx, const int32_t* dst_idx,
                 const int32_t* edge, int64_t f, int64_t v,
                 int64_t* counts_all /* [v*v], caller zeroes */,
                 int64_t* key_out /* [F] */) {
  for (int64_t i = 0; i < f; ++i) {
    const int32_t a = edge[src_idx[i]], b = edge[dst_idx[i]];
    if (a < 0 || b < 0) { key_out[i] = -1; continue; }
    const int64_t k = (int64_t)a * v + b;
    key_out[i] = k;
    ++counts_all[k];
  }
}

// group_pairs' companion: sub-flow deal straight from the dense keys
// (lookup maps key -> group id), fusing what would otherwise be an inv
// gather plus deal_subflows into one pass. members[s] counts the pairs
// dealt onto sub-flow s (caller zeroes); key < 0 pairs are not counted.
void deal_subflows_keyed(const int64_t* key, const int32_t* src_idx,
                         const int32_t* dst_idx, const int64_t* lookup,
                         const int32_t* nsub, const int64_t* sub_base,
                         int64_t f, int32_t* pair_sub, int32_t* members) {
  for (int64_t i = 0; i < f; ++i) {
    if (key[i] < 0) { pair_sub[i] = -1; continue; }
    const int64_t g = lookup[key[i]];
    const uint32_t h = (uint32_t)src_idx[i] * 2654435761u
                     ^ (uint32_t)dst_idx[i] * 0x85EBCA77u;
    const int32_t s = (int32_t)(sub_base[g] + h % (uint32_t)nsub[g]);
    pair_sub[i] = s;
    ++members[s];
  }
}

// Deal collective pairs onto ECMP sub-flows: pair i of group inv[i]
// lands on sub-flow sub_base[g] + hash(src_idx[i], dst_idx[i]) % nsub[g].
// The hash spreads a group's members across its sub-flows (and hence
// across sampled equal-cost paths) deterministically with no sort —
// O(F) for the 16.7M-pair alltoall where argsort costs seconds.
// members[s] counts the pairs dealt onto sub-flow s (caller zeroes).
void deal_subflows(const int32_t* inv, const int32_t* src_idx,
                   const int32_t* dst_idx, const int32_t* nsub,
                   const int64_t* sub_base, int64_t f, int32_t* pair_sub,
                   int32_t* members) {
  for (int64_t i = 0; i < f; ++i) {
    const int32_t g = inv[i];
    const uint32_t h = (uint32_t)src_idx[i] * 2654435761u
                     ^ (uint32_t)dst_idx[i] * 0x85EBCA77u;
    const int32_t s = (int32_t)(sub_base[g] + h % (uint32_t)nsub[g]);
    pair_sub[i] = s;
    ++members[s];
  }
}

// Counting-sort collective pairs by sub-flow, fused with the member-key
// production the block install needs: one O(F) pass computes per-sub
// counts, a prefix sum yields bounds, and a second O(F) pass scatters
// each pair's (src MAC key, vMAC key, rewrite key, final port) into its
// sub-flow's contiguous slice. Keys come from per-ENDPOINT lookup
// tables (N entries, cache-resident), so there is no random access into
// F-sized arrays anywhere — the comparison-sort + 4 fancy-gather
// equivalent in numpy is ~10x slower at alltoall scale.
//
// vmac_src_lut/vmac_dst_lut hold each endpoint's contribution to the
// virtual MAC (vmac = vmac_base | src_part | dst_part — see
// protocol/vmac.py byte layout).
void scatter_members(const int32_t* pair_sub, const int32_t* src_idx,
                     const int32_t* dst_idx, const int64_t* src_key_lut,
                     const int64_t* vmac_src_lut, const int64_t* vmac_dst_lut,
                     const int64_t* rewrite_lut, const int32_t* fport_lut,
                     int64_t vmac_base, int64_t f, int64_t s,
                     int64_t* bounds,  // [s + 1] out
                     int64_t* m_src, int64_t* m_vmac, int64_t* m_rewrite,
                     int32_t* m_fport) {
  for (int64_t j = 0; j <= s; ++j) bounds[j] = 0;
  for (int64_t i = 0; i < f; ++i) {
    if (pair_sub[i] >= 0) ++bounds[pair_sub[i] + 1];
  }
  for (int64_t j = 0; j < s; ++j) bounds[j + 1] += bounds[j];
  // cursor reuses a scratch copy of bounds
  int64_t* cursor = new int64_t[s];
  for (int64_t j = 0; j < s; ++j) cursor[j] = bounds[j];
  for (int64_t i = 0; i < f; ++i) {
    const int32_t sub = pair_sub[i];
    if (sub < 0) continue;
    const int64_t c = cursor[sub]++;
    const int32_t si = src_idx[i], di = dst_idx[i];
    m_src[c] = src_key_lut[si];
    m_vmac[c] = vmac_base | vmac_src_lut[si] | vmac_dst_lut[di];
    m_rewrite[c] = rewrite_lut[di];
    m_fport[c] = fport_lut[di];
  }
  delete[] cursor;
}

// Announcement sideband codec (UDP:61000 payload).
// Layout: little-endian int32 type {0=LAUNCH, 1=EXIT} + int32 rank —
// byte-identical to protocol/announcement.py and the reference's
// construct struct (reference: sdnmpi/protocol/announcement.py:9-16).
// Returns the number of well-formed records decoded.
int64_t decode_announcements(const uint8_t* buf, int64_t n_bytes,
                             int32_t* types, int32_t* ranks) {
  const int64_t rec = 8;
  int64_t n = n_bytes / rec;
  int64_t ok = 0;
  for (int64_t i = 0; i < n; ++i) {
    int32_t t, r;
    std::memcpy(&t, buf + i * rec, 4);
    std::memcpy(&r, buf + i * rec + 4, 4);
    if (t != 0 && t != 1) continue;
    types[ok] = t;
    ranks[ok] = r;
    ++ok;
  }
  return ok;
}

void encode_announcements(const int32_t* types, const int32_t* ranks,
                          int64_t n, uint8_t* buf) {
  for (int64_t i = 0; i < n; ++i) {
    std::memcpy(buf + i * 8, &types[i], 4);
    std::memcpy(buf + i * 8 + 4, &ranks[i], 4);
  }
}

}  // extern "C"
