"""The UGAL batch's host splice and segment decode, held bit-equal to the
JAX package's on batches shaped as the dragonfly's: every detour share
from none to all, and the edge rows of the splice.

Both functions touch segment 2 on detour rows only (``inter >= 0``);
the engagement test holds the second decode to exactly those rows.
"""

import numpy as np
import pytest

from sdnmpi_tpu.oracle import adaptive as jad
from sdnmpi_tpu_torch import native
from sdnmpi_tpu_torch import topogen as p_topogen
from sdnmpi_tpu_torch.oracle import adaptive
from sdnmpi_tpu_torch.oracle.dag import sampled_hops

F = 4096


@pytest.fixture(scope="module")
def dfly():
    """Config 5's dragonfly (8 groups x 32 routers): adjacency and the
    sorted-neighbour table the decoders walk."""
    spec = p_topogen.dragonfly(8, 32, 1, 2)
    adj = np.zeros((spec.n_switches, spec.n_switches), np.float32)
    for a, _, b, _ in spec.links:
        adj[a - 1, b - 1] = adj[b - 1, a - 1] = 1.0
    return adj, native.neighbor_order(adj)


def _walks(order, start, hops, rng):
    """Random walks of ``hops`` sorted-neighbour slots from ``start``;
    returns ``(slots [F, hops] int8, end [F])``. About one walk in eight
    stops early (a -1 slot), as a sampler's does at its destination."""
    v = order.shape[0]
    deg = (order < v).sum(axis=1)
    slots = np.full((len(start), hops), -1, np.int8)
    node = start.copy()
    stop = rng.integers(1, hops + 1, len(start))
    stop[rng.random(len(start)) < 0.875] = hops
    for h in range(hops):
        go = h < stop
        s = rng.integers(0, deg[node])
        slots[go, h] = s[go]
        node = np.where(go, order[node, s], node)
    return slots, node


def _batch(dfly, max_len, share, seed=0):
    """A packed UGAL batch: ``(src, dst, inter, slots1, slots2)``, each
    detour row (``round(share * F)`` of them) a walk to its intermediate
    and one on to a neighbour of its end, each minimal row a walk to a
    neighbour of its end. One row in sixteen gets a destination anywhere,
    mostly not adjacent, which decodes to a row of -1. Dead rows' second
    slot streams are noise: they decode to all -1 whatever they hold."""
    adj, order = dfly
    rng = np.random.default_rng(seed)
    v, hops = adj.shape[0], sampled_hops(max_len)
    src = rng.integers(0, v, F).astype(np.int32)
    slots1, end1 = _walks(order, src, hops, rng)
    inter = np.full(F, -1, np.int32)
    det = rng.choice(F, int(round(share * F)), replace=False)
    inter[det] = end1[det]
    slots2, end2 = _walks(order, end1, hops, rng)
    end = np.where(inter >= 0, end2, end1)
    dst = order[end, rng.integers(0, (order[end] < v).sum(axis=1))]
    dst = np.where(rng.random(F) < 1 / 16, rng.integers(0, v, F), dst).astype(np.int32)
    minimal = inter < 0
    slots2[minimal] = rng.integers(-1, 8, (int(minimal.sum()), hops))
    return src, dst, inter, slots1, slots2


@pytest.mark.parametrize("max_len", [4, 8])
@pytest.mark.parametrize("share", [0.0, 0.002, 0.5, 1.0])
def test_stitch_and_decode_match_reference(dfly, max_len, share):
    """Port against reference, bit for bit, at each detour share:
    ``decode_segments`` on the same slot streams, ``stitch_paths`` on
    the column-slice views ``decode_segments`` returns."""
    adj, order = dfly
    src, dst, inter, s1, s2 = _batch(dfly, max_len, share)
    assert int((inter >= 0).sum()) == int(round(share * F))
    got = adaptive.decode_segments(adj, src, dst, inter, s1, s2, max_len, order=order)
    ref = jad.decode_segments(adj, src, dst, inter, s1, s2, max_len)
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)
    assert (got[1][inter < 0] == -1).all()
    assert (got[0] >= 0).any(axis=1).mean() > 0.5  # mostly real paths
    if share:
        assert ((got[1][inter >= 0] >= 0).sum(axis=1) > 1).any()  # real tails
    # the views as the decoder hands them over: [F, L + 2] trimmed to L
    n1 = np.pad(got[0], ((0, 0), (0, 2)), constant_values=-1)[:, :max_len]
    n2 = np.pad(got[1], ((0, 0), (0, 2)), constant_values=-1)[:, :max_len]
    assert not n1.flags.c_contiguous
    out = adaptive.stitch_paths(n1, n2, inter)
    want = jad.stitch_paths(n1, n2, inter)
    assert out.shape == want.shape == (F, 2 * max_len - 1) and out.dtype == want.dtype
    np.testing.assert_array_equal(out, want)


def _rows(*rows):
    """Segment rows padded to L = 4 with -1, as a column-slice view."""
    a = np.full((len(rows), 6), -1, np.int32)
    for i, r in enumerate(rows):
        a[i, :len(r)] = r
    return a[:, :4]


#: (n1 rows, n2 rows, inter) around each edge of the splice, with
#: minimal rows beside the detour under test
EDGES = {
    "empty": (np.empty((0, 6), np.int32)[:, :4], np.empty((0, 6), np.int32)[:, :4],
              np.empty(0, np.int32)),
    "segment1_all_dead": (_rows([0, 1], [], [5, 6, 7]), _rows([], [3, 4, 5], []),
                          [-1, 3, -1]),
    "segment2_all_dead": (_rows([0, 1], [0, 2, 3], [5]), _rows([], [], []),
                          [-1, 3, -1]),
    "len2_one": (_rows([0, 1, 2], [4, 5], [7]), _rows([], [5], []), [-1, 5, -1]),
    "only_detours": (_rows([0, 1], [2, 3, 4, 5], [6], [], [8, 9, 10]),
                     _rows([1, 2, 3, 4], [5, 6], [6, 7], [9, 10], [10]),
                     [1, 5, 6, 9, 10]),
}


@pytest.mark.parametrize("case", list(EDGES))
def test_stitch_edges_match_reference(case):
    """An empty batch; a detour whose segment 1 decoded to all -1 (its
    tail lands at column 0); one whose segment 2 did (no tail); one with
    a one-node segment 2 (no tail); a batch of detours only."""
    n1, n2, inter = EDGES[case]
    inter = np.asarray(inter, np.int32)
    out = adaptive.stitch_paths(n1, n2, inter)
    want = jad.stitch_paths(n1, n2, inter)
    assert out.shape == want.shape and out.dtype == want.dtype
    np.testing.assert_array_equal(out, want)


def test_decode_empty_batch_matches_reference(dfly):
    adj, order = dfly
    e = np.empty(0, np.int32)
    s = np.empty((0, sampled_hops(4)), np.int8)
    got = adaptive.decode_segments(adj, e, e, e, s, s, 4, order=order)
    ref = jad.decode_segments(adj, e, e, e, s, s, 4)
    for g, r in zip(got, ref):
        assert g.shape == r.shape == (0, 4)


@pytest.mark.parametrize("share", [0.002, 0.5])
def test_second_decode_gets_the_detour_rows_only(dfly, monkeypatch, share):
    """The second ``native.decode_slots`` call is handed exactly the
    detour rows: their slot streams and their inter -> dst endpoints."""
    adj, order = dfly
    src, dst, inter, s1, s2 = _batch(dfly, 4, share, seed=3)
    calls = []
    real = native.decode_slots

    def record(slots, order_, a, b, complete=False):
        calls.append((np.array(slots), np.array(a), np.array(b)))
        return real(slots, order_, a, b, complete=complete)

    monkeypatch.setattr(native, "decode_slots", record)
    adaptive.decode_segments(adj, src, dst, inter, s1, s2, 4, order=order)
    assert len(calls) == 2
    det = np.flatnonzero(inter >= 0)
    assert len(det) == int(round(share * F))
    assert len(calls[0][0]) == F
    slots, a, b = calls[1]
    assert len(slots) == len(det)
    np.testing.assert_array_equal(slots, s2[det])
    np.testing.assert_array_equal(a, inter[det])
    np.testing.assert_array_equal(b, dst[det])
