"""The plain reference that decides ``correct`` for a collective routed by
UGAL (Singh, PhD thesis, Stanford 2005): PyTorch on the CPU for the costs
and the choice, NumPy for the routes.

It imports nothing of the program under test, and of the benchmark only
:mod:`portbench.reference`'s fabric arrays and pairs. From a job's
utilization snapshot (the Monitor's ``(dpid, port) -> bps``) it works out
again what UGAL-G decides for each sub-flow of the collective, then
judges the routes the program came back with.

What it recomputes, in float32 as the program states its costs:

- the normalized base: ``(u / capacity) * max(1, pairs / links)`` on
  every directed switch link (the program's ``alpha`` at its default, 1);
- the link cost ``1 + base / mean(base over the directed switch links)``;
- ``D[i, t]``, the cheapest cost over the hop-minimal paths from router
  i to router t, relaxed level by level over the shortest-path DAG:
  ``D[i, t] = min(cost[i, n] + D[n, t])`` over the neighbours n one hop
  nearer to t;
- each sub-flow's decision. Sub-flow ``fid`` (its id, as the routes'
  ``pair_sub`` gives it) from router s to router t draws candidates
  ``m_k = mix(fid * 2654435761 ^ k * 0x85EBCA77 ^ salt) mod V`` for k <
  K, V the fabric's router count, ``mix`` the xorshift-multiply mixer
  below on uint32 values held in int64, salt 0 as the port's collective
  path runs it. A candidate equal to s or t is
  none; the others cost ``D[s, m] + D[m, t]``; the first least is the
  best, and the sub-flow detours through it if ``best + bias < D[s,
  t]``, else routes minimally.

What it judges, on every pair of the collective (each a count of pairs,
or a gap, with limit 0):

- ``unrouted_pairs``, ``wrong_endpoints``, ``off_fabric_hops`` and
  ``wrong_ports``, as :mod:`portbench.reference` counts them;
- ``not_minimal_or_valiant``: a route that is neither a shortest path
  nor a shortest path to an intermediate router followed by a shortest
  path from it to the destination;
- ``ugal_choice_errors``: a route that is non-minimal where the decision
  is minimal, or the reverse; or a detour that does not split at a
  candidate whose cost lies within :data:`TIE` of the best;
- ``detour_count_gap``: the program's ``n_detours`` against the pairs on
  non-minimal routes;
- ``congestion_gap``: the program's ``max_congestion`` against the pairs
  on the most loaded directed switch link, from the returned hop lists.

**Near-ties.** A decision whose ``best + bias - D[s, t]`` lies within
:data:`TIE` of 0 is a near-tie: either way is right, and it is counted
apart, with no limit. The program's mean is a float32 sum over the links
in the device's order, a few ulps away from this one's, and every cost
moves with it. At costs of 1 to 8, 1e-4 is 100 to 800 float32 ulps, far
above that; costs computed in float16 or bfloat16 round by 1e-3 or more,
move decisions by as much, and fail the check.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import Fabric, Pairs

LIMITS = {
    "unrouted_pairs": 0,
    "wrong_endpoints": 0,
    "off_fabric_hops": 0,
    "wrong_ports": 0,
    "not_minimal_or_valiant": 0,
    "ugal_choice_errors": 0,
    "detour_count_gap": 0,
    "congestion_gap": 0,
}
#: a decision or a candidate this near the line is a near-tie (see above)
TIE = 1e-4
MASK = 0xFFFFFFFF
INF = float("inf")


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for int64 tensors of uint32 values, ``x`` taken
    in two 16-bit halves so that no product leaves int64."""
    lo, hi = x & 0xFFFF, x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & MASK


def mix32(x: torch.Tensor) -> torch.Tensor:
    """The xorshift-multiply mixer on uint32 values held in int64."""
    x = x ^ (x >> 16)
    x = mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def candidates(fid: torch.Tensor, k: int, n_routers: int) -> torch.Tensor:
    """``[S, k]`` int64 candidate intermediates of sub-flows ``fid`` (salt 0)."""
    keys = (mul32(fid.long() & MASK, 2654435761)[:, None]
            ^ mul32(torch.arange(k, dtype=torch.int64), 0x85EBCA77)[None, :])
    return mix32(keys) % max(n_routers, 1)


def link_costs(fab: Fabric, util: dict, n_pairs: int, capacity: float) -> torch.Tensor:
    """``[V, V]`` float32 cost of every directed switch link (inf where
    none) from the snapshot ``util``: ``(dpid, port) -> bps``."""
    v = len(fab.dpids)
    li, lj = fab.links()
    bps = [util.get((d, p), 0.0)
           for d, p in zip(fab.dpids[li].tolist(), fab.port[li, lj].tolist())]
    u = torch.tensor(bps, dtype=torch.float32)
    share = max(1.0, n_pairs / max(len(li), 1))
    base = (u / max(capacity, 1.0)) * share
    mean = base.sum() / len(li)
    cost = torch.full((v, v), INF, dtype=torch.float32)
    cost[torch.from_numpy(li), torch.from_numpy(lj)] = (
        1.0 + base / mean if mean > 0 else torch.ones_like(base))
    return cost


def minimal_costs(fab: Fabric, cost: torch.Tensor) -> torch.Tensor:
    """``[V, V]`` float32 cheapest cost over hop-minimal paths, one level
    of the shortest-path DAG at a time: a pair at distance L takes its
    least ``cost[i, n] + D[n, t]`` over the neighbours n at distance L-1
    from t."""
    v = len(fab.dpids)
    dist = torch.from_numpy(fab.dist)
    d = torch.full((v, v), INF, dtype=torch.float32)
    d.fill_diagonal_(0.0)
    for level in range(1, int(dist.max()) + 1):
        nearer = torch.where(dist == level - 1, d, INF)  # [n, t]
        via = (cost[:, :, None] + nearer[None, :, :]).amin(dim=1)  # [i, t]
        d = torch.where(dist == level, via, d)
    return d


class Decision:
    """UGAL-G's decision for sub-flows ``fid`` from router ``s`` to ``t``:
    ``inter`` (the best candidate, or -1 to route minimally), ``near``
    (a near-tie), ``cand`` ``[S, K]`` and ``good`` ``[S, K]`` (the
    candidates within :data:`TIE` of the best)."""

    def __init__(self, dmin: torch.Tensor, fid, s, t, k: int, bias: float):
        s, t = torch.as_tensor(s).long(), torch.as_tensor(t).long()
        m = candidates(torch.as_tensor(fid), k, dmin.shape[0])
        c_min = dmin[s, t]
        c = dmin[s[:, None], m] + dmin[m, t[:, None]]
        c = torch.where((m == s[:, None]) | (m == t[:, None]), INF, c)
        best_k = torch.argmin(c, dim=1)  # the first least
        best = c.gather(1, best_k[:, None])[:, 0]
        margin = (best + torch.tensor(bias, dtype=torch.float32)) - c_min
        self.inter = torch.where(margin < 0, m.gather(1, best_k[:, None])[:, 0], -1).numpy()
        self.near = (margin.abs() <= TIE).numpy()
        self.cand = m.numpy()
        self.good = (c <= best[:, None] + TIE).numpy()


#: the faults a sub-flow or a pair can carry, one bit each
(_OFF, _PORT, _NOT_MV, _EMPTY, _CHOICE, _ENDS, _LAST_PORT,
 _NO_SUB) = (1 << b for b in range(8))


def judge(fab: Fabric, routes, pairs: Pairs, dmin: torch.Tensor, k: int,
          bias: float) -> tuple[dict, int, dict]:
    """Judge a collective's routes (the program's collective form:
    ``pair_sub`` [F], ``final_port`` [F], ``hop_dpid`` / ``hop_port`` /
    ``hop_len`` per sub-flow, ``max_congestion``, ``n_detours``) against
    UGAL-G with ``k`` candidates and ``bias`` on the costs ``dmin`` of
    :func:`minimal_costs`. Returns the counts under :data:`LIMITS`' names,
    the max link load, and what it saw: sub-flows judged, pairs on
    detours, near-ties."""
    v = len(fab.dpids)
    f = len(pairs)
    sub = np.asarray(routes.pair_sub)
    hop_len = np.asarray(routes.hop_len, np.int64)
    hop_port = np.asarray(routes.hop_port, np.int64)
    final_port = np.asarray(routes.final_port)
    n_sub = len(hop_len)
    if sub.shape != (f,) or final_port.shape != (f,):
        return ({**{name: 0 for name in LIMITS}, "unrouted_pairs": f}, 0,
                {"subflows": 0, "detour_pairs": 0, "near_ties": 0})
    rows = fab.rows_of(routes.hop_dpid)
    width = rows.shape[1]
    hop_len = np.minimum(hop_len, width)
    live = np.arange(width)[None, :] < hop_len[:, None]
    step = live[:, 1:]
    a = np.where(step, rows[:, :-1], 0)
    b = np.where(step, rows[:, 1:], 0)
    both = (a >= 0) & (b >= 0)
    link = np.where(both, fab.port[np.maximum(a, 0), np.maximum(b, 0)], -1)
    off = (live & (rows < 0)).any(axis=1) | (step & (link < 0)).any(axis=1)
    bad_port = (step & (link >= 0) & (hop_port[:, :-1] != link)).any(axis=1)
    first = rows[:, 0]
    last = rows[np.arange(n_sub), np.maximum(hop_len - 1, 0)]
    ends = (first >= 0) & (last >= 0)
    f0, l0 = np.maximum(first, 0), np.maximum(last, 0)
    hops = hop_len - 1
    minimal = ends & (hops == fab.dist[f0, l0])
    # a split at hop j: a shortest path to the j-th router, then one from it
    split = np.zeros(rows.shape, bool)
    for j in range(1, width - 1):
        node = np.maximum(rows[:, j], 0)
        split[:, j] = (ends & (j < hops) & (rows[:, j] >= 0)
                       & (fab.dist[f0, node] == j) & (fab.dist[node, l0] == hops - j))
    detour = ends & ~minimal  # the route the program took is not minimal

    # which pairs are routed, and each sub-flow's endpoints as its members want
    s_ok = (sub >= 0) & (sub < n_sub)
    s = np.where(s_ok, sub, n_sub)
    routed_pair = s_ok & (np.append(hop_len, 0)[s] > 0)
    want = np.full(n_sub, -1, np.int64)
    want[s[routed_pair]] = pairs.key[routed_pair]
    judged = np.nonzero(want >= 0)[0]
    dec = Decision(dmin, torch.from_numpy(judged), want[judged] // v, want[judged] % v,
                   k, bias)
    choice = np.zeros(n_sub, bool)
    wrong_way = ~dec.near & (detour[judged] != (dec.inter >= 0))
    at_good = np.zeros(len(judged), bool)
    for j in range(1, width - 1):
        node = rows[judged, j][:, None]
        at_good |= split[judged, j] & (dec.good & (dec.cand == node)).any(axis=1)
    choice[judged] = wrong_way | (detour[judged] & ~at_good)

    code = np.zeros(n_sub + 1, np.uint8)
    code[:n_sub] = (off * _OFF | bad_port * _PORT | (~minimal & ~split.any(axis=1)) * _NOT_MV
                    | (hop_len == 0) * _EMPTY | choice * _CHOICE)
    code[n_sub] = _NO_SUB
    sub_key = np.where(ends, first * v + last, -1)
    mark = code[s]
    mark |= (np.append(sub_key, -1)[s] != pairs.key).astype(np.uint8) * np.uint8(_ENDS)
    mark |= (final_port != pairs.want_port).astype(np.uint8) * np.uint8(_LAST_PORT)
    marks = np.arange(256)
    routed = (marks & (_NO_SUB | _EMPTY)) == 0
    tally = np.bincount(mark, minlength=256)

    def pairs_with(bits: int) -> int:
        return int(tally[routed & ((marks & bits) > 0)].sum())

    members = np.bincount(s[routed_pair], minlength=n_sub + 1)[:n_sub]
    detour_pairs = int(members[detour].sum())
    on = step & both & (link >= 0)
    ids = (a * v + b)[on]
    w = np.broadcast_to(members[:, None], on.shape)[on].astype(np.float64)
    load = int(np.bincount(ids, weights=w, minlength=v * v).max(initial=0.0))
    counts = {
        "unrouted_pairs": int(tally[~routed].sum()),
        "wrong_endpoints": pairs_with(_ENDS),
        "off_fabric_hops": pairs_with(_OFF),
        "wrong_ports": pairs_with(_PORT | _LAST_PORT),
        "not_minimal_or_valiant": pairs_with(_NOT_MV),
        "ugal_choice_errors": pairs_with(_CHOICE),
        "detour_count_gap": abs(int(getattr(routes, "n_detours", 0)) - detour_pairs),
        "congestion_gap": abs(float(routes.max_congestion) - load),
    }
    seen = {"subflows": len(judged), "detour_pairs": detour_pairs,
            "near_ties": int(dec.near.sum())}
    return counts, load, seen
