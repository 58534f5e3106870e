"""The plain reference that decides ``correct``: NumPy only.

It imports nothing of the program under test. It holds a fabric as its
own arrays (``Fabric``, laid out by a module of ``portbench/fabrics/``),
works out the hop distances itself by a breadth-first search over the
fabric's links, and judges the routes a collective came back with: every
pair routed, from its source host's switch to its destination host's,
over a shortest path of real links with their real out-ports, each pair
in exactly one phase, and the congestion the program reported equal to
the count of pairs on the most loaded directed switch link, taken from
the returned hop lists. The program's routes are read only to be judged.
"""

from __future__ import annotations

import dataclasses

import numpy as np

#: what a run compares, each with its limit: counts of pairs that break a
#: guarantee, and the gap between the congestion the program reported and
#: the reference's count. Every one is exact, so every limit is 0.
LIMITS = {
    "unrouted_pairs": 0,
    "wrong_endpoints": 0,
    "longer_than_shortest": 0,
    "off_fabric_hops": 0,
    "wrong_ports": 0,
    "phase_coverage_errors": 0,
    "congestion_gap": 0,
}


def mac_of(i: int) -> str:
    """MAC of host ``i``: 04:00:xx:xx:xx:xx, the port's numbering."""
    raw = f"{(0x04 << 40) | int(i):012x}"
    return ":".join(raw[j:j + 2] for j in range(0, 12, 2))


@dataclasses.dataclass
class Fabric:
    """A fabric as plain arrays. Switch rows follow sorted dpids."""

    dpids: np.ndarray  # [V] int64, sorted
    port: np.ndarray  # [V, V] int32 out-port of the link row i -> row j, -1 if none
    host_mac: list  # [H] str
    host_sw: np.ndarray  # [H] int64 switch row each host hangs off
    host_port: np.ndarray  # [H] int32 that switch's port to the host
    top: np.ndarray  # rows of the top layer (the control's detours)
    dist: np.ndarray = None  # [V, V] int32 hop distances, -1 = unreachable

    def __post_init__(self) -> None:
        if self.dist is None:
            self.dist = bfs_distances(self.port >= 0)
        self._row_of = np.full(int(self.dpids.max()) + 2, -1, np.int64)
        self._row_of[self.dpids] = np.arange(len(self.dpids))

    @property
    def n_hosts(self) -> int:
        return len(self.host_mac)

    def links(self) -> tuple[np.ndarray, np.ndarray]:
        """Rows ``(i, j)`` of every directed switch link, row-major."""
        return np.nonzero(self.port >= 0)

    def rows_of(self, dpid: np.ndarray) -> np.ndarray:
        """Switch rows of dpids: -1 where the dpid is -1 (padding), -2
        where it names no switch of the fabric."""
        dpid = np.asarray(dpid, np.int64)
        known = (dpid >= 0) & (dpid < len(self._row_of))
        out = np.where(dpid < 0, -1, -2).astype(np.int64)
        out[known] = self._row_of[dpid[known]]
        out[known & (out == -1)] = -2
        return out


def bfs_distances(adj: np.ndarray) -> np.ndarray:
    """All-pairs hop distances of a directed 0/1 adjacency, one level of
    the search a boolean matrix product (exact in f32: counts stay far
    below 2**24)."""
    v = adj.shape[0]
    a = adj.astype(np.float32)
    dist = np.full((v, v), -1, np.int32)
    np.fill_diagonal(dist, 0)
    frontier = np.eye(v, dtype=np.float32)
    seen = np.eye(v, dtype=bool)
    level = 0
    while frontier.any():
        level += 1
        reach = (frontier @ a) > 0
        new = reach & ~seen
        dist[new] = level
        seen |= new
        frontier = new.astype(np.float32)
    return dist


@dataclasses.dataclass
class Pairs:
    """What the reference wants of each pair of a collective, worked out
    once a job from the hosts at its ends."""

    key: np.ndarray  # [F] int32 source switch row * V + destination switch row
    want_port: np.ndarray  # [F] int32 the destination host's port

    @classmethod
    def of(cls, fab: Fabric, hosts: np.ndarray, src: np.ndarray,
           dst: np.ndarray) -> "Pairs":
        """The pairs ``src -> dst``, indices into ``hosts``, the host
        index of each endpoint."""
        sw = fab.host_sw[hosts].astype(np.int32)
        key = sw[src] * np.int32(len(fab.dpids)) + sw[dst]
        return cls(key, fab.host_port[hosts][dst])

    def __len__(self) -> int:
        return len(self.key)

    def take(self, idx) -> "Pairs":
        return Pairs(self.key[idx], self.want_port[idx])


#: the faults a sub-flow or a pair can carry, one bit each
_OFF, _PORT, _LONGER, _EMPTY, _ENDS, _LAST_PORT, _NO_SUB = (1 << b for b in range(7))


def judge_phase(fab: Fabric, routes, pairs: Pairs) -> tuple[dict, int]:
    """Judge one phase's routes for ``pairs``. ``routes`` has the
    program's collective form: ``pair_sub`` [F], ``final_port`` [F],
    ``hop_dpid`` / ``hop_port`` / ``hop_len`` per sub-flow,
    ``max_congestion``. Returns the counts under :data:`LIMITS`' names
    and the reference's max link load."""
    v = len(fab.dpids)
    f = len(pairs)
    sub = np.asarray(routes.pair_sub)
    hop_len = np.asarray(routes.hop_len, np.int64)
    hop_port = np.asarray(routes.hop_port, np.int64)
    final_port = np.asarray(routes.final_port)
    n_sub = len(hop_len)
    if sub.shape != (f,) or final_port.shape != (f,):
        return dict(unrouted_pairs=f, wrong_endpoints=0, longer_than_shortest=0,
                    off_fabric_hops=0, wrong_ports=0), 0
    # each sub-flow on its own: its ends, and whether it leaves the fabric
    # (a live hop that names no switch, two consecutive live hops no link
    # joins), takes a wrong out-port, or is longer than a shortest path
    # between its ends
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
    sub_key = np.where(ends, first * v + last, -1)
    shortest = np.where(ends, fab.dist[np.maximum(first, 0), np.maximum(last, 0)], -2)
    code = np.zeros(n_sub + 1, np.uint8)
    code[:n_sub] = (off * _OFF | bad_port * _PORT | (hop_len != shortest + 1) * _LONGER
                    | (hop_len == 0) * _EMPTY)
    code[n_sub] = _NO_SUB

    # then every pair through its sub-flow (row n_sub: no sub-flow)
    s = np.where((sub >= 0) & (sub < n_sub), sub, n_sub)
    mark = code[s]
    key = np.append(sub_key, -1).astype(pairs.key.dtype)
    mark |= (key[s] != pairs.key).astype(np.uint8) * np.uint8(_ENDS)
    mark |= (final_port != pairs.want_port).astype(np.uint8) * np.uint8(_LAST_PORT)
    marks = np.arange(256)
    routed = (marks & (_NO_SUB | _EMPTY)) == 0
    if np.count_nonzero(mark):
        tally = np.bincount(mark, minlength=256)
        members = np.bincount(np.where(routed[mark], s, n_sub), minlength=n_sub + 1)
    else:  # every pair routed and sound: the common case, counted quickly
        tally = np.zeros(256, np.int64)
        members = np.bincount(s, minlength=n_sub + 1)

    def pairs_with(bits: int) -> int:
        return int(tally[routed & ((marks & bits) > 0)].sum())

    counts = {
        "unrouted_pairs": int(tally[~routed].sum()),
        "wrong_endpoints": pairs_with(_ENDS),
        "longer_than_shortest": pairs_with(_LONGER),
        "off_fabric_hops": pairs_with(_OFF),
        "wrong_ports": pairs_with(_PORT | _LAST_PORT),
    }
    # pairs on each directed switch link, from the hop lists: each routed
    # pair adds 1 to every link of its sub-flow's path
    members = members[:n_sub]
    on = step & both & (link >= 0)
    ids = (a * v + b)[on]
    w = np.broadcast_to(members[:, None], on.shape)[on].astype(np.float64)
    loads = np.bincount(ids, weights=w, minlength=v * v)
    return counts, int(loads.max(initial=0.0))


def judge(fab: Fabric, phases: list, pair_phase, pairs: Pairs) -> tuple[dict, int]:
    """Judge a collective's routes. ``phases`` lists ``(phase_id,
    pair_idx, routes)``: the phase's id, the rows of the collective's
    pairs it routes (None for a flat collective: one phase over every
    pair) and its routes; ``pair_phase`` is each pair's phase as the
    program reported it (None for a flat collective). Returns the counts
    under :data:`LIMITS`' names, summed over the phases, and the
    collective's max link load: the sum over phases of each phase's
    maximum, since phases run one after another."""
    f = len(pairs)
    total = {name: 0 for name in LIMITS}
    load = 0
    whole = 0  # phases over every pair
    seen = None  # how many phases each pair is in, where phases take subsets
    for phase_id, idx, routes in phases:
        if idx is None:
            whole += 1
            counts, phase_load = judge_phase(fab, routes, pairs)
            idx = slice(None)
        else:
            idx = np.asarray(idx, np.int64)
            if seen is None:
                seen = np.zeros(f, np.int64)
            seen += np.bincount(idx, minlength=f)[:f]
            counts, phase_load = judge_phase(fab, routes, pairs.take(idx))
        for name, n in counts.items():
            total[name] += n
        total["congestion_gap"] = max(
            total["congestion_gap"], abs(float(routes.max_congestion) - phase_load))
        load += phase_load
        if pair_phase is not None:
            total["phase_coverage_errors"] += int(
                (np.asarray(pair_phase)[idx] != phase_id).sum())
    if seen is None:
        total["phase_coverage_errors"] += 0 if whole == 1 else f
    else:
        total["phase_coverage_errors"] += int((seen + whole != 1).sum())
    return total, load
