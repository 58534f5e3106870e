"""A phased program's scans in one launch of kernel S1
(``oracle/congestion.route_flows_balanced_phases``).

On the CPU the batched wrapper runs the plain scan once a phase: each
phase's nodes and slot loads must equal ``route_flows_balanced_plain`` on
the phase's own rows and base, for phases of unequal length, a one-row
phase, a phase that is all padding, unequal hop budgets and tie-heavy
fat-tree rows, where the row id within the phase decides the deal. The
phased dispatch must route every pair as per-phase scans of the same
tables do, and launch the phases once. The tests marked ``cuda`` hold one
batched launch bit-equal to K single-block launches on the card and skip
without one; they import neither JAX nor the JAX package, so on a machine
with a card they run alone:

    python -m pytest -q -p no:cacheprovider --noconftest tests/test_torch_scan_phases.py
"""

import numpy as np
import pytest
import torch

from sdnmpi_tpu_torch.oracle import congestion, engine
from sdnmpi_tpu_torch.oracle.batch import pad_flow_batch
from sdnmpi_tpu_torch.topogen import fattree


def _tables(k: int, device: str = "cpu"):
    """``(adj, dist, neigh)`` of a k-ary fat-tree on ``device``."""
    db = fattree(k).to_topology_db(backend="torch", device=device)
    oracle = db._oracle_engine()
    t = oracle.refresh(db)
    return t.adj, oracle._dist_full(), t.neigh


def _edges(adj: torch.Tensor) -> np.ndarray:
    """A fat-tree's edge switches: the real switches with hosts' ports
    free, i.e. the fewest switch neighbours (k / 2)."""
    deg = (adj > 0).sum(dim=1).cpu().numpy()
    real = np.nonzero(deg > 0)[0]
    return real[deg[real] == deg[real].min()]


def _phase(rng, edges, n: int, dead: int = 0, ties: bool = False):
    """``n`` sub-flows of weight 1 to 3 between edge switches, end-padded
    to a power of two (a one-row phase stays one row), with ``dead`` more dead rows first (a phase that is
    all padding has ``n`` = 0). With ``ties`` every flow runs from the
    first edge switch to the last, so its hops tie over the uplinks and
    the row id deals them."""
    if ties:
        src = np.full(n, edges[0], np.int32)
        dst = np.full(n, edges[-1], np.int32)
    else:
        src = rng.choice(edges, n).astype(np.int32)
        dst = rng.choice(edges, n).astype(np.int32)
    src = np.concatenate([np.full(dead, -1, np.int32), src])
    dst = np.concatenate([np.full(dead, -1, np.int32), dst])
    src_p, dst_p = pad_flow_batch(src, dst, multiple=1, pow2=True)
    w_p = np.where(src_p >= 0, rng.integers(1, 4, len(src_p)), 0).astype(np.float32)
    return src_p, dst_p, w_p


#: phases by (live rows, dead rows first, tie-heavy, hop budget)
CASES = {
    "unequal": [(40, 0, False, 5), (7, 0, False, 5), (100, 0, False, 5)],
    "one_row": [(30, 0, False, 5), (1, 0, False, 5), (12, 0, False, 5)],
    "all_padding": [(20, 0, False, 5), (0, 8, False, 5), (9, 0, False, 5)],
    "max_len": [(25, 0, False, 5), (25, 0, False, 3), (25, 0, False, 9)],
    "ties": [(33, 0, True, 5), (17, 0, True, 5), (64, 3, True, 5), (5, 0, True, 5)],
}


def _problem(case: str, adj, seed: int = 22):
    rng = np.random.default_rng(seed)
    edges = _edges(adj)
    v = adj.shape[0]
    phases, bases, max_lens = [], [], []
    for n, dead, ties, max_len in CASES[case]:
        phases.append(_phase(rng, edges, n, dead, ties))
        # an integer base a phase; a tie-heavy phase's is zero, so loads
        # alone break the ties
        base = rng.integers(0, 3, (v, v)) * (adj.cpu().numpy() > 0) * (not ties)
        bases.append(base.astype(np.float32))
        max_lens.append(max_len)
    offsets = np.concatenate([[0], np.cumsum([len(p[0]) for p in phases])])
    src, dst, w = (torch.from_numpy(np.concatenate([p[i] for p in phases]))
                   for i in range(3))
    return src, dst, w, torch.from_numpy(np.stack(bases)), offsets, max_lens


def _slot_loads_from_paths(nodes, weight, neigh, v):
    """Per-slot float64 loads of whole paths: hop (a, b) adds to the slot
    of a's row whose clamped neighbour is b."""
    cols = np.minimum(neigh, v - 1)
    out = np.zeros(neigh.shape, np.float64)
    for row, w in zip(nodes, weight):
        for a, b in zip(row[:-1], row[1:]):
            if a >= 0 and b >= 0:
                out[a, int(np.argmax(cols[a] == b))] += w
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_batched_wrapper_equals_plain_scans_per_phase(case):
    """Each phase of the batched wrapper on CPU tensors: its nodes equal
    ``route_flows_balanced_plain`` on the phase's rows and base, its slot
    loads scatter to that call's ``[V, V]`` load, pads hold none, and
    where every path is whole its slot loads are its paths' loads."""
    adj, dist, neigh = _tables(4)
    v = adj.shape[0]
    src, dst, w, bases, offsets, max_lens = _problem(case, adj)
    out = torch.empty(sum((b - a) * m for a, b, m in
                          zip(offsets[:-1], offsets[1:], max_lens)), dtype=torch.int32)
    nodes, slot_load = congestion.route_flows_balanced_phases(
        adj, dist, bases, src, dst, w, offsets, max_lens, chunk=1, neigh=neigh, out=out)
    assert slot_load.shape == (len(max_lens), v, neigh.shape[1])
    assert slot_load.dtype == torch.float64
    pad = (neigh >= v) & (torch.arange(neigh.shape[1]) > 0)
    at = 0
    for p, m in enumerate(max_lens):
        part = slice(offsets[p], offsets[p + 1])
        want = congestion.route_flows_balanced_plain(
            adj, dist, bases[p], src[part], dst[part], w[part], m, chunk=1, neigh=neigh)
        assert nodes[p].shape == (offsets[p + 1] - offsets[p], m)
        assert torch.equal(nodes[p], want[0])
        # the views lie in phase order in the caller's buffer
        assert nodes[p].data_ptr() == out.data_ptr() + 4 * at
        at += nodes[p].numel()
        assert torch.equal(congestion.slot_loads_to_dense(slot_load[p], neigh, v), want[1])
        assert not slot_load[p][pad].any()
        got = nodes[p].numpy()
        live = src[part].numpy() >= 0
        last = got[np.arange(len(got)), np.maximum((got >= 0).sum(axis=1) - 1, 0)]
        if (last[live] == dst[part].numpy()[live]).all():
            np.testing.assert_array_equal(
                slot_load[p].numpy(),
                _slot_loads_from_paths(got, w[part].numpy(), neigh.numpy(), v))
    if case == "all_padding":
        assert (nodes[1] == -1).all() and not slot_load[1].any()


def test_ties_are_dealt_by_the_row_in_the_phase():
    """The tie-heavy phases route otherwise when their rows move down by
    one (a dead row first): the row id decides the deal, so a launch that
    dealt by the row of the concatenated batch would differ from the
    per-phase scans the batched wrapper equals."""
    adj, dist, neigh = _tables(4)
    src, dst, w, bases, offsets, max_lens = _problem("ties", adj)
    one = torch.tensor([-1], dtype=torch.int32)
    for p in range(len(max_lens)):
        part = slice(offsets[p], offsets[p + 1])
        args = (adj, dist, bases[p])
        own = congestion.route_flows_balanced_plain(
            *args, src[part], dst[part], w[part], max_lens[p], chunk=1, neigh=neigh)
        moved = congestion.route_flows_balanced_plain(
            *args, torch.cat([one, src[part]]), torch.cat([one, dst[part]]),
            torch.cat([torch.zeros(1), w[part]]), max_lens[p], chunk=1, neigh=neigh)
        assert not torch.equal(own[0], moved[0][1:])


@pytest.mark.parametrize("bad", ["offsets", "empty_phase", "max_len", "bases"])
def test_batched_wrapper_refuses(bad):
    """Offsets that do not cover the rows from 0, an empty phase, a hop
    budget under 1 and bases that are not ``[K, V, V]`` are refused on
    either device."""
    adj, dist, neigh = _tables(4)
    src, dst, w, bases, offsets, max_lens = _problem("unequal", adj)
    offsets = list(offsets)
    if bad == "offsets":
        offsets[-1] -= 1
    elif bad == "empty_phase":
        offsets[1] = offsets[0]
    elif bad == "max_len":
        max_lens = [0] + max_lens[1:]
    else:
        bases = bases[:2]
    with pytest.raises(ValueError):
        congestion.route_flows_balanced_phases(
            adj, dist, bases, src, dst, w, offsets, max_lens, chunk=1, neigh=neigh)


def _program(spread: bool, monkeypatch):
    """The balanced phased alltoall of a k=4 fat-tree's 16 hosts under a
    seeded utilization, and every scanner call it made; ``spread`` has
    S1's rule give every phase the spread form, so each phase takes its
    own ``route_flows_balanced`` call as before."""
    calls = []

    def recorded(fn, name):
        def call(*args, **kw):
            out = fn(*args, **kw)
            calls.append((name, args, kw, out))
            return out
        return call

    monkeypatch.setattr(engine, "route_flows_balanced",
                        recorded(congestion.route_flows_balanced, "single"))
    monkeypatch.setattr(engine, "route_flows_balanced_phases",
                        recorded(congestion.route_flows_balanced_phases, "phases"))
    if spread:
        monkeypatch.setattr(engine, "scan_form", lambda *a: "spread")
    db = fattree(4).to_topology_db(backend="torch", device="cpu")
    macs = sorted(db.hosts)
    src, dst = np.nonzero(~np.eye(len(macs), dtype=bool))
    rng = np.random.default_rng(5)
    util = {(a, db.links[a][b].src.port_no): float(rng.integers(0, 8)) * 1e9
            for a in sorted(db.links) for b in sorted(db.links[a])}
    program = db._oracle_engine().routes_collective_phased(
        db, macs, src.astype(np.int32), dst.astype(np.int32), "balanced",
        link_util=util)
    monkeypatch.undo()
    return program, calls


def test_phased_dispatch_routes_as_per_phase_scans(monkeypatch):
    """``routes_collective_phased_dispatch`` launches its phases' scans
    once, and every pair's routes equal, pair for pair, what per-phase
    ``route_flows_balanced`` calls of the same phase tables give; the
    batched call's tables are those calls' tables, each phase's base its
    own."""
    got, batched = _program(False, monkeypatch)
    want, singles = _program(True, monkeypatch)
    assert [c[0] for c in batched] == ["phases"]
    assert [c[0] for c in singles] == ["single"] * len(want.phases)
    assert len(got.phases) == len(want.phases) >= 2
    _, args, kw, (nodes, _) = batched[0]
    adj, dist, bases, src, dst, w, offsets, max_lens = args
    assert len(max_lens) == len(singles)
    for p, (_, s_args, s_kw, s_out) in enumerate(singles):
        part = slice(offsets[p], offsets[p + 1])
        assert torch.equal(bases[p], s_args[2])
        for a, b in zip((src[part], dst[part], w[part]), s_args[3:6]):
            assert torch.equal(a, b)
        assert max_lens[p] == s_args[6] and kw["chunk"] == s_kw["chunk"] == 1
        assert torch.equal(nodes[p], s_out[0])
    np.testing.assert_array_equal(got.pair_phase, want.pair_phase)
    for a, b in zip(got.reap_all(), want.reap_all()):
        for field in ("pair_sub", "final_port", "hop_dpid", "hop_port", "hop_len",
                      "endpoint_port"):
            np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
        assert a.max_congestion == b.max_congestion


# -- on the card ---------------------------------------------------------


@pytest.fixture
def card():
    """The first CUDA device; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: kernel S1 has no CPU mode")
    return torch.device("cuda")


def _card_problem(k_phases: int, short: bool, device):
    """``k_phases`` phases at config 12's shape (a k=16 fat-tree: V = 320,
    D = 16), chunk 1: 200-2,000 sub-flows a phase of unequal lengths and
    hop budgets, or 1-40 where ``short``; each phase its own integer base,
    one tie-heavy (zero base) phase in four."""
    adj, dist, neigh = _tables(16, device)
    rng = np.random.default_rng(1000 + k_phases)
    edges = _edges(adj)
    v = adj.shape[0]
    host_adj = adj.cpu().numpy() > 0
    phases, bases, max_lens = [], [], []
    for p in range(k_phases):
        n = int(rng.integers(1, 41) if short else rng.integers(200, 2001))
        ties = p % 4 == 3
        phases.append(_phase(rng, edges, n, dead=int(p % 5 == 4), ties=ties))
        bases.append((rng.integers(0, 3, (v, v)) * host_adj * (not ties)).astype(np.float32))
        max_lens.append(5 + p % 3)
    offsets = np.concatenate([[0], np.cumsum([len(x[0]) for x in phases])])
    src, dst, w = (torch.from_numpy(np.concatenate([x[i] for x in phases])).to(device)
                   for i in range(3))
    return (adj, dist, torch.from_numpy(np.stack(bases)).to(device), src, dst, w,
            offsets, max_lens, neigh)


@pytest.mark.cuda
@pytest.mark.parametrize("k_phases,short", [(1, False), (4, False), (8, False),
                                            (140, True)])
def test_one_launch_equals_single_block_launches(card, k_phases, short):
    """One batched launch of K phases (140 short ones: more blocks than
    the H100's 132 SMs) equals K single-block launches of the same phase
    tables bit for bit, nodes and float64 slot loads, and each phase
    equals ``route_flows_balanced``'s call (the first short phases also
    its plain version, which takes seconds on a long phase)."""
    adj, dist, bases, src, dst, w, offsets, max_lens, neigh = _card_problem(
        k_phases, short, card)
    v = adj.shape[0]
    nodes, slot_load = congestion.route_flows_balanced_phases(
        adj, dist, bases, src, dst, w, offsets, max_lens, chunk=1, neigh=neigh)
    for p in range(k_phases):
        part = slice(offsets[p], offsets[p + 1])
        rows = (src[part].contiguous(), dst[part].contiguous(), w[part].contiguous())
        one_n, one_s = congestion.route_flows_balanced_phases(
            adj, dist, bases[p:p + 1].contiguous(), *rows, [0, len(rows[0])],
            [max_lens[p]], chunk=1, neigh=neigh)
        assert torch.equal(nodes[p], one_n[0]), p
        assert torch.equal(slot_load[p], one_s[0]), p
        single = congestion.route_flows_balanced(
            adj, dist, bases[p].contiguous(), *rows, max_lens[p], chunk=1, neigh=neigh)
        assert torch.equal(nodes[p], single[0]), p
        assert torch.equal(congestion.slot_loads_to_dense(slot_load[p], neigh, v),
                           single[1]), p
        if short and p < 4:
            plain = congestion.route_flows_balanced_plain(
                adj, dist, bases[p], *rows, max_lens[p], chunk=1, neigh=neigh)
            assert torch.equal(nodes[p], plain[0]) and torch.equal(single[1], plain[1])


@pytest.mark.cuda
@pytest.mark.parametrize("k_phases", [1, 4])
def test_one_launch_counts_once(card, k_phases):
    """A batched launch adds 1 to ``route_flows_balanced.launches`` and K
    to ``.phases``; a single call adds 1 to each."""
    adj, dist, bases, src, dst, w, offsets, max_lens, neigh = _card_problem(
        k_phases, True, card)
    fn = congestion.route_flows_balanced
    launches, phases = fn.launches, fn.phases
    congestion.route_flows_balanced_phases(
        adj, dist, bases, src, dst, w, offsets, max_lens, chunk=1, neigh=neigh)
    assert (fn.launches - launches, fn.phases - phases) == (1, k_phases)
    part = slice(offsets[0], offsets[1])
    fn(adj, dist, bases[0].contiguous(), src[part].contiguous(), dst[part].contiguous(),
       w[part].contiguous(), max_lens[0], chunk=1, neigh=neigh)
    assert (fn.launches - launches, fn.phases - phases) == (2, k_phases + 1)
    torch.cuda.synchronize()
