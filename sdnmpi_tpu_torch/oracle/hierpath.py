"""Vectorized hierarchical path materialization (host numpy).

Counterpart of ``sdnmpi_tpu/oracle/hierpath.py``, copied as it is.
``_Composer.fdb`` walks one pair at a time: a Python next-hop chase
through the pod blocks, a greedy descent over the border skeleton,
another chase, an attach hop. This module builds the same hop arrays
**batched**:

1. decompose every routed pair into an ordered item list — intra-pod
   chase segments ``(pod, a_local, b_local)``, single inter-pod hops,
   and the final attachment hop — by running the greedy border descent
   for ALL pairs simultaneously (one skeleton step per iteration, the
   per-border candidate argmin vectorized through the degree-bucketed
   tables);
2. place every item at its absolute hop offset analytically (segment
   lengths come straight from the pod blocks' distance stacks);
3. chase all intra-pod segments of all pairs together, one block-level
   step per iteration, scattering ``(dpid, port)`` into the final
   ``[F, L]`` hop arrays.

Bit-identity with the scalar walk is the contract (the fused composer
against the escape hatch): the candidate tables preserve CSR order with
inf-weight pads, so every vectorized argmin picks the same first-minimum
winner as ``_descend``; the chases follow the identical next-hop
matrices; and the scalar path-length assertion (``hops == total + 1``)
survives as one vectorized check. Only the fused composer
(``Config.hier_fused``, default on) routes through here.
"""

from __future__ import annotations

import numpy as np


class _PathTables:
    """Per-state lookup tables the batched walk needs (built once per
    HierState and cached on it — state objects are rebuilt whenever the
    delta log invalidates the hierarchy, so staleness is impossible)."""

    def __init__(self, state) -> None:
        # (pod, local) -> global switch index
        sizes = np.array(
            [len(m) for m in state.pods_members], np.int64
        )
        self.pod_mstart = np.zeros(state.n_pods + 1, np.int64)
        np.cumsum(sizes, out=self.pod_mstart[1:])
        self.member_g = (
            np.concatenate(state.pods_members)
            if state.pods_members and sizes.sum()
            else np.zeros(0, np.int32)
        ).astype(np.int64)
        # border -> (descent bucket, row) over the same degree buckets
        # the sweeps use, plus the port tables _degree_buckets keeps
        # beside them (CSR order preserved -> argmin picks match the
        # scalar _descend verbatim)
        self.border_bucket = state.desc_bucket
        self.border_pos = state.desc_pos
        self.tables = [
            (cand, w, prt)
            for (ids, cand, w), prt in zip(
                state.deg_buckets, state.desc_ports
            )
        ]

    @classmethod
    def of(cls, state) -> "_PathTables":
        cached = getattr(state, "_path_tables", None)
        if cached is None:
            cached = cls(state)
            state._path_tables = cached
        return cached


def _pod_block_arrays(state, pods):
    """(bucket, slot) int arrays for ``pods`` plus the per-bucket
    (dist, nxt, port) host stacks."""
    return state.pod_bucket[pods], state.pod_slot[pods]


def _seg_lengths(state, pod, a, b) -> np.ndarray:
    """Intra-pod chase lengths straight from the distance stacks."""
    out = np.zeros(len(pod), np.int64)
    bkt, sl = _pod_block_arrays(state, pod)
    for bi, blk in enumerate(state.buckets):
        m = bkt == bi
        if m.any():
            d = blk.dist[sl[m], a[m], b[m]]
            assert np.isfinite(d).all(), (
                "intra-pod chase hit an unreachable hop"
            )
            out[m] = d.astype(np.int64)
    return out


def build_hop_arrays(state, si, di, fport, total, b1, b2):
    """Batched twin of ``_Composer.fdb`` over [n] resolved pairs.

    Returns ``(hop_dpid [n, L] int64, hop_port [n, L] int32,
    hop_len [n] int32)`` — row k bit-identical to the scalar walk's
    fdb list for pair k (unroutable pairs keep ``hop_len == 0``).
    """
    st = state
    tb = _PathTables.of(st)
    n = len(si)
    routed = np.isfinite(total)
    hop_len = np.zeros(n, np.int32)
    hop_len[routed] = total[routed].astype(np.int64) + 1
    lmax = int(hop_len.max(initial=1)) or 1
    hop_dpid = np.full((n, lmax), -1, np.int64)
    hop_port = np.full((n, lmax), -1, np.int32)
    if not routed.any():
        return hop_dpid, hop_port, hop_len

    pod_s = st.pod_of_g[si]
    pod_d = st.pod_of_g[di]
    ls = st.local_of_g[si].astype(np.int64)
    ld = st.local_of_g[di].astype(np.int64)
    off = np.zeros(n, np.int64)  # next free hop slot per pair
    # intra segments accumulate as (pair, pod, a, b, start) batches and
    # chase together below
    seg_pair: list[np.ndarray] = []
    seg_pod: list[np.ndarray] = []
    seg_a: list[np.ndarray] = []
    seg_b: list[np.ndarray] = []
    seg_start: list[np.ndarray] = []

    def emit_segments(pairs, pods, aa, bb):
        """Queue intra chases and advance the pairs' hop cursors by
        the segments' (block-distance) lengths."""
        if not len(pairs):
            return
        lens = _seg_lengths(st, pods, aa, bb)
        nz = lens > 0
        if nz.any():
            seg_pair.append(pairs[nz])
            seg_pod.append(pods[nz])
            seg_a.append(aa[nz])
            seg_b.append(bb[nz])
            seg_start.append(off[pairs[nz]])
        off[pairs] += lens

    # -- 1. source-side chase ---------------------------------------------
    r = np.nonzero(routed)[0]
    # pairs that leave their pod chase to the source border, the rest to
    # the destination (indexed apart: a one-pod fabric has no borders)
    tgt0 = ld[r].copy()
    via = b1[r] >= 0
    tgt0[via] = st.border_local[b1[r][via]]
    emit_segments(r, pod_s[r], ls[r], tgt0)

    # -- 2. border descent, all pairs in lockstep ---------------------------
    act = r[(b1[r] >= 0) & (b1[r] != b2[r])]
    assert not len(act) or tb.tables, "border with no skeleton candidates"
    cur = b1[act].astype(np.int64)
    tgt = b2[act].astype(np.int64)
    # plane row of each pair's destination border (dist(x -> b2))
    prow = (
        st.plane_base[st.border_pod[tgt]].astype(np.int64)
        + (tgt - st.pod_bstart[st.border_pod[tgt]])
    )
    assert (prow >= 0).all(), "descent without a materialized row plane"
    guard = 0
    while len(act):
        nxt = np.empty(len(act), np.int64)
        prt = np.empty(len(act), np.int32)
        bkt = tb.border_bucket[cur]
        for ti, (cand, w, ports) in enumerate(tb.tables):
            m = np.nonzero(bkt == ti)[0]
            if not len(m):
                continue
            pos = tb.border_pos[cur[m]]
            cnd = cand[pos]  # [ns, K] CSR-ordered candidates
            tot = w[pos] + st.plane_h[prow[m][:, None], cnd]
            k = np.argmin(tot, axis=1)  # first min = lowest candidate
            rows_ = np.arange(len(m))
            nxt[m] = cnd[rows_, k]
            prt[m] = ports[pos][rows_, k]
        inter = prt >= 0
        if inter.any():
            p_i = act[inter]
            hop_dpid[p_i, off[p_i]] = st.dpids[
                st.border_gidx[cur[inter]]
            ]
            hop_port[p_i, off[p_i]] = prt[inter]
            off[p_i] += 1
        intra = ~inter
        if intra.any():
            emit_segments(
                act[intra],
                st.border_pod[cur[intra]],
                st.border_local[cur[intra]].astype(np.int64),
                st.border_local[nxt[intra]].astype(np.int64),
            )
        cur = nxt
        done = cur == tgt
        if done.any():
            keep = ~done
            act, cur, tgt, prow = (
                act[keep], cur[keep], tgt[keep], prow[keep]
            )
        guard += 1
        assert guard <= st.n_borders + 1, "border descent looped"

    # -- 3. destination-side chase ------------------------------------------
    rc = r[b1[r] >= 0]
    if len(rc):
        emit_segments(
            rc, pod_d[rc],
            st.border_local[b2[rc]].astype(np.int64), ld[rc],
        )

    # -- 4. attachment hop + the scalar walk's length assertion -------------
    hop_dpid[r, off[r]] = st.dpids[di[r]]
    hop_port[r, off[r]] = fport[r]
    off[r] += 1
    assert np.array_equal(off[r], hop_len[r]), (
        "hierarchical path length drifted from its composed distance"
    )

    # -- 5. chase every queued intra segment together -----------------------
    if seg_pair:
        pair = np.concatenate(seg_pair)
        pod = np.concatenate(seg_pod)
        a = np.concatenate(seg_a)
        b = np.concatenate(seg_b)
        start = np.concatenate(seg_start)
        bkt, sl = _pod_block_arrays(st, pod)
        glb_base = tb.pod_mstart[pod]
        for bi, blk in enumerate(st.buckets):
            sel = np.nonzero(bkt == bi)[0]
            if not len(sel):
                continue
            nxt_s = blk.nxt[sl[sel]]  # [ns, s, s]
            prt_s = blk.port[sl[sel]]
            curl = a[sel].copy()
            tgtl = b[sel]
            pr = pair[sel]
            stt = start[sel].copy()
            base = glb_base[sel]
            alive = np.nonzero(curl != tgtl)[0]
            guard = 0
            while len(alive):
                rows_ = alive
                nx = nxt_s[rows_, curl[rows_], tgtl[rows_]].astype(
                    np.int64
                )
                assert (nx >= 0).all(), (
                    "intra-pod chase hit an unreachable hop"
                )
                hop_dpid[pr[rows_], stt[rows_]] = st.dpids[
                    tb.member_g[base[rows_] + curl[rows_]]
                ]
                hop_port[pr[rows_], stt[rows_]] = prt_s[
                    rows_, curl[rows_], nx
                ]
                curl[rows_] = nx
                stt[rows_] += 1
                alive = alive[curl[alive] != tgtl[alive]]
                guard += 1
                assert guard <= blk.s, (
                    "intra-pod chase did not terminate"
                )
    return hop_dpid, hop_port, hop_len
