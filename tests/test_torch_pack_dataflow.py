"""Kernel S2's dataflow schedule (``kernels/csrc/pack.cu``) against the
JAX package on the CPU.

The kernel does not run here, so a numpy model of its schedule stands in
for it: it gives each live row its turn in its in column (the number of
earlier live rows with the same destination switch), deals the rows to
32 warps as the kernel does (the present sources, ranked in index order,
round the warps), then runs the rows in a random interleaving that the
turnstiles admit, with the host twin's float32 arithmetic. A warp reads
a row's out column before it waits on the in column's turnstile, as the
kernel does. The model must equal the reference's jitted ``lax.scan``
and ``pack_phases_host`` bit for bit, and it must never find every warp
waiting. The kernel's first step (turns counted in segments of 32-row
chunks, then a prefix sum over the segments) is held against a
brute-force count, and the longest chains that PERF.md quotes are pinned
on the port's own aggregation of config 12's groups.
"""

import jax.numpy as jnp
import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from sdnmpi_tpu.sched import phases as j_phases
from sdnmpi_tpu_torch.sched import phases

WARPS = 32


def _turns(col: np.ndarray, live: np.ndarray) -> np.ndarray:
    """Each live row's rank among the earlier live rows of its column,
    -1 for dead rows: the kernel's definition of a turn."""
    seen: dict = {}
    out = np.full(len(col), -1, np.int64)
    for i in np.nonzero(live)[0]:
        c = int(col[i])
        out[i] = seen.get(c, 0)
        seen[c] = out[i] + 1
    return out


def _owners(src: np.ndarray, v: int) -> np.ndarray:
    """The warp each live row goes to (-1 for dead rows): the owner of
    its source."""
    live = src >= 0
    present = np.zeros(v, np.int64)
    present[src[live]] = 1
    rank = np.cumsum(present) - present  # the block's exclusive prefix sum
    return np.where(live, rank[np.maximum(src, 0)] % WARPS, -1)


def _segment_turns(col: np.ndarray, live: np.ndarray, v: int, n_seg: int) -> np.ndarray:
    """The kernel's first step: segment j (one warp) ranks its live rows
    32 at a time, equal keys grouped and ranked by lane, one count row
    carried over its chunks; a prefix over the segments' count rows is
    then added to each row's local turn."""
    g = len(col)
    seg_len = -(-(-(-g // n_seg)) // 32) * 32
    table = np.zeros((n_seg, v), np.int64)
    local = np.full(g, -1, np.int64)
    for j in range(n_seg):
        for b in range(j * seg_len, min(g, (j + 1) * seg_len), 32):
            lanes = np.arange(b, min(b + 32, (j + 1) * seg_len, g))
            keys = np.where(live[lanes], col[lanes], v + (lanes - b))
            for lane, i in enumerate(lanes):
                if not live[i]:
                    continue
                same = keys == keys[lane]
                local[i] = table[j, col[i]] + int(same[:lane].sum())
            for c in np.unique(col[lanes][live[lanes]]):
                table[j, c] += int((keys == c).sum())
    before = np.cumsum(table, axis=0) - table
    rows = np.nonzero(live)[0]
    local[rows] += before[rows // seg_len, col[rows]]
    return local


def model_schedule(src, dst, w, util_out, util_in, k, seed):
    """Kernel S2's dataflow on the host: every warp takes its rows in
    order, reads a row's out column, then waits until the turnstile of
    its in column reaches its turn; the next warp to act is drawn at
    random among those that can. Returns the phases and the number of
    row steps taken."""
    g, v = len(src), len(util_out)
    live = src >= 0
    d_col = np.maximum(dst, 0)
    t_in = _turns(d_col, live)
    owner = _owners(src, v)
    queues = [list(np.nonzero(owner == o)[0]) for o in range(WARPS)]
    out_l = np.zeros((k, v), np.float32)
    in_l = np.zeros((k, v), np.float32)
    turn_in = np.zeros(v, np.int64)
    pos = [0] * WARPS
    early: list = [None] * WARPS  # the out column, read before the wait
    phases_out = np.full(g, -1, np.int32)
    rng = np.random.default_rng(seed)

    def ready(i):
        return turn_in[d_col[i]] == t_in[i]

    steps = 0
    while True:
        acts = []
        for o in range(WARPS):
            if pos[o] == len(queues[o]):
                continue
            i = queues[o][pos[o]]
            if early[o] is None or ready(i):
                acts.append(o)
        if not acts:
            assert all(pos[o] == len(queues[o]) for o in range(WARPS)), "every warp waits"
            return phases_out, steps
        o = int(rng.choice(acts))
        i = queues[o][pos[o]]
        s, d = int(src[i]), int(d_col[i])
        if early[o] is None:
            early[o] = out_l[:, s].copy()
            continue
        load_out = early[o]
        load_in = in_l[:, d].copy()
        cost = np.maximum(util_out[s] + load_out, util_in[d] + load_in)
        ph = int(np.argmin(cost))
        out_l[ph, s] = load_out[ph] + w[i]
        in_l[ph, d] = load_in[ph] + w[i]
        turn_in[d] += 1
        phases_out[i] = ph
        pos[o] += 1
        early[o] = None
        steps += 1


def _reference(src, dst, w, util_out, util_in, k):
    """The reference's jitted scan on the rows padded to a power of two
    (pads: s = d = -1), and the numpy twin."""
    g = len(src)
    n = 1 << max(0, (g - 1).bit_length())
    pad = lambda a, x: np.concatenate([a, np.full(n - g, x, a.dtype)])  # noqa: E731
    ref = np.asarray(j_phases._pack_greedy_device(
        jnp.asarray(pad(src, -1)), jnp.asarray(pad(dst, -1)), jnp.asarray(pad(w, 0.0)),
        jnp.asarray(util_out), jnp.asarray(util_in), k))[:g]
    host = phases.pack_phases_host(src, dst, w, util_out, util_in, k)
    return ref, host


@st.composite
def packer_rows(draw):
    """Rows as the packer takes them: up to 4,096 rows over up to 512
    switches (sometimes crowded onto a few, for long chains), 1 to 32
    phases, pad rows, zero weights, repeated (s, d) pairs, s == d and a
    seeded background."""
    g = draw(st.integers(1, 4096))
    v = draw(st.integers(1, 512))
    k = draw(st.integers(1, 32))
    used = draw(st.sampled_from([1, 2, 8, v]))
    rng = np.random.default_rng(draw(st.integers(0, 2**32 - 1)))
    src = rng.integers(0, min(used, v), g).astype(np.int32)
    dst = rng.integers(0, min(used, v), g).astype(np.int32)
    if draw(st.booleans()):  # a run of one repeated pair
        a = int(rng.integers(0, g))
        src[a:a + 64], dst[a:a + 64] = src[a], dst[a]
    pads = rng.random(g) < draw(st.sampled_from([0.0, 0.05, 0.3]))
    src[pads] = -1
    dst[pads] = draw(st.sampled_from([-1, 0]))
    w = np.where(draw(st.booleans()), rng.integers(1, 65, g), rng.random(g) * 64)
    w = w.astype(np.float32)
    w[rng.random(g) < draw(st.sampled_from([0.0, 0.2]))] = 0.0
    if draw(st.booleans()):  # heaviest first, as pack_phases orders them
        order = np.argsort(-w, kind="stable")
        src, dst, w = src[order], dst[order], w[order]
    scale = draw(st.sampled_from([0.0, 4.0, 1000.0]))
    util_out = (rng.random(v) * scale).astype(np.float32)
    util_in = (rng.random(v) * scale).astype(np.float32)
    return src, dst, w, util_out, util_in, k


@settings(max_examples=25, deadline=None,
          suppress_health_check=[HealthCheck.too_slow, HealthCheck.data_too_large])
@given(rows=packer_rows(), seed=st.integers(0, 2**32 - 1))
def test_schedule_model_equals_reference(rows, seed):
    """Any interleaving that S2's turnstiles admit gives the reference's
    phases and the numpy twin's, bit for bit, and never hangs."""
    got, steps = model_schedule(*rows, seed)
    ref, host = _reference(*rows)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, host)
    assert steps == int((rows[0] >= 0).sum())


@pytest.mark.parametrize("case", ["serial", "gather", "scatter", "all_pads", "k1", "k32"])
def test_schedule_model_at_the_holds(case):
    """The shapes ``chip_smoke.py`` holds S2 at, cut to 512 rows: one
    source and destination (a chain of every row), every row to one
    destination, every row from one source, pads only, K = 1 and K =
    32."""
    rng = np.random.default_rng(14)
    g, v, k = 512, 64, 4
    src = rng.integers(0, v, g).astype(np.int32)
    dst = rng.integers(0, v, g).astype(np.int32)
    if case == "serial":
        src[:], dst[:] = 7, 9
    elif case == "gather":
        dst[:] = 3
    elif case == "scatter":
        src[:] = 5
    elif case == "all_pads":
        src[:], dst[:] = -1, -1
    k = {"k1": 1, "k32": 32, "serial": 32}.get(case, k)
    w = (rng.random(g) * 16).astype(np.float32)
    util_out = (rng.random(v) * 4).astype(np.float32)
    util_in = (rng.random(v) * 4).astype(np.float32)
    ref, host = _reference(src, dst, w, util_out, util_in, k)
    np.testing.assert_array_equal(ref, host)
    for seed in range(3):
        got, _ = model_schedule(src, dst, w, util_out, util_in, k, seed)
        np.testing.assert_array_equal(got, ref)


@settings(max_examples=40, deadline=None)
@given(g=st.integers(1, 3000), v=st.integers(1, 300), used=st.integers(1, 300),
       n_seg=st.integers(1, 32), pad=st.sampled_from([0.0, 0.1, 0.5]),
       seed=st.integers(0, 2**32 - 1))
def test_segment_turns_equal_brute_force(g, v, used, n_seg, pad, seed):
    """The kernel's first step (segments of 32-row chunks, a prefix over
    the segments' count rows) gives every live row the number of earlier
    live rows of its column, for any number of segments; the deal puts
    every live row in exactly one warp's chunk mask, and no dead row."""
    rng = np.random.default_rng(seed)
    col = rng.integers(0, min(used, v), g)
    live = rng.random(g) >= pad
    brute = np.array([int(((col[:i] == col[i]) & live[:i]).sum()) if live[i] else -1
                      for i in range(g)])
    np.testing.assert_array_equal(_segment_turns(col, live, v, n_seg), brute)
    np.testing.assert_array_equal(_turns(col, live), brute)
    src = np.where(live, col, -1)
    owner = _owners(src, v)
    masks = np.zeros((-(-g // 32), WARPS), np.uint64)
    for i in np.nonzero(live)[0]:
        masks[i // 32, owner[i]] |= np.uint64(1 << (i % 32))
    taken = [(c * 32 + b) for c in range(len(masks)) for o in range(WARPS)
             for b in range(32) if int(masks[c, o]) >> b & 1]
    assert sorted(taken) == list(np.nonzero(live)[0])
    for s in np.unique(src[live]):  # a source's rows stay in one warp
        assert len(set(owner[src == s])) == 1


def _config_rows(k: int, n_ranks: int):
    """The groups of an alltoall of the first ``n_ranks`` hosts by MAC on
    fat-tree k, from the port's own aggregation, heaviest first, as
    ``pack_phases`` and the phased program feed S2."""
    from tests.test_torch_sched import alltoall_idx
    from sdnmpi_tpu_torch.topogen import fattree

    spec = fattree(k)
    db = spec.to_topology_db(backend="torch", device="cpu")
    oracle = db._oracle_engine()
    t = oracle.refresh(db)
    macs = sorted(m for m, _, _ in spec.hosts)[:n_ranks]
    s_idx, d_idx = alltoall_idx(n_ranks)
    edge, _ = oracle._resolve_endpoints_array(db, t, macs)
    _, _, _, _, g_src, g_dst, w = phases.aggregate_groups(edge[s_idx], edge[d_idx], t.v)
    order = np.argsort(-w, kind="stable")
    return g_src[order], g_dst[order], t.v


def _longest_chain(src, dst) -> tuple[int, int]:
    """The longest chain of rows that share a source or a destination
    switch, and the widest level (rows whose longest chain is equal)."""
    last_s: dict = {}
    last_d: dict = {}
    level = np.zeros(len(src), np.int64)
    for i, (s, d) in enumerate(zip(src.tolist(), dst.tolist())):
        level[i] = 1 + max(last_s.get(s, 0), last_d.get(d, 0))
        last_s[s] = last_d[d] = level[i]
    return int(level.max()), int(np.bincount(level).max())


def _makespan(src, dst, owner) -> int:
    """Row steps of the dataflow when every row takes one step: a row
    starts when its warp is free and the earlier rows of its source and
    destination are done."""
    free = np.zeros(WARPS, np.int64)
    done_s: dict = {}
    done_d: dict = {}
    for i, (s, d) in enumerate(zip(src.tolist(), dst.tolist())):
        o = owner[i]
        end = 1 + max(free[o], done_s.get(s, 0), done_d.get(d, 0))
        free[o] = done_s[s] = done_d[d] = end
    return int(free.max())


@pytest.mark.parametrize("k,n_ranks,groups,chain,widest", [
    (16, 512, 4096, 126, 64),  # config 12
    (16, 128, 256, 30, 16),  # its 128-rank hold
    (8, 128, 1024, 62, 32),
])
def test_longest_chains(k, n_ranks, groups, chain, widest):
    """The longest chain of dependent rows (and the widest level) that
    PERF.md quotes for S2, on the groups the port's aggregation gives."""
    src, dst, v = _config_rows(k, n_ranks)
    assert len(src) == groups
    assert _longest_chain(src, dst) == (chain, widest)


def test_config12_deal():
    """At config 12 the deal by source gives every warp two of the 64
    sources and a schedule of 159 row steps for the chain of 126. Dealing
    row i to warp i mod 32 instead strings each source's rows across the
    warps: 2,081 row steps. Dealing by s mod 32 would use 16 warps."""
    src, dst, v = _config_rows(16, 512)
    by_source = _owners(src, v)
    assert np.bincount(by_source, minlength=WARPS).tolist() == [128] * WARPS
    assert len(np.unique(src % WARPS)) == 16
    assert _makespan(src, dst, by_source) == 159
    assert _makespan(src, dst, np.arange(len(src)) % WARPS) == 2081


@pytest.mark.parametrize("k,v,placement", [
    (4, 320, 0),  # config 12: turnstiles and state in shared memory
    (32, 320, 0),
    (16, 3968, 1),  # the wide hold: the turnstiles only
    (1, 16_640, 0),  # 4 V + 8 K V = 199,680 bytes, the room beside the row records
    (2, 16_640, 1),
    (4, 49_920, 1),  # 4 V = 199,680 bytes
    (4, 49_921, 2),
    (4, 65_536, 2),
])
def test_placement(k, v, placement):
    """S2's placement from K and V alone, against the 227 KB a block may
    take less its 32 KB of row records."""
    assert phases.pack_placement(k, v) == placement
