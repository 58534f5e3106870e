"""The shape of the oracle's collective path, held where no other test
holds it.

A collective batch groups its pairs on one of two paths: the C++
library's fused grouping where the library loaded, ``np.unique`` where
it did not. Both must route a flat and a phased balanced collective on a
k=4 fat-tree to bit-equal results, unresolved endpoints included, and
equal to the JAX package's (the reference) where the library is off. And
``tracing.STATS`` takes one sample per entry call and one per batch
dispatch: a flat call, a phased program and a ``schedule=`` call record
the same ops, as many times each, as the layers they pass through.
"""

import numpy as np
import pytest

from sdnmpi_tpu_torch import native
from sdnmpi_tpu_torch.topogen import fattree
from sdnmpi_tpu_torch.utils import tracing

#: what a caller reads of a collective's routes
FIELDS = ("pair_sub", "final_port", "hop_dpid", "hop_port", "hop_len", "endpoint_port")


def _collective(reference: bool = False):
    """A k=4 fat-tree's 16 hosts plus one endpoint that resolves nowhere,
    every ordered pair of them; the port's database, or the reference's."""
    if reference:
        from sdnmpi_tpu.topogen import fattree as j_fattree

        db = j_fattree(4).to_topology_db(backend="jax")
    else:
        db = fattree(4).to_topology_db(backend="torch", device="cpu")
    macs = sorted(db.hosts) + ["0e:00:00:00:00:ff"]
    src, dst = np.nonzero(~np.eye(len(macs), dtype=bool))
    return db, macs, src.astype(np.int32), dst.astype(np.int32)


def _route(phased: bool, reference: bool = False) -> dict:
    db, macs, src, dst = _collective(reference)
    oracle = db._jax_oracle() if reference else db._oracle_engine()
    if phased:
        program = oracle.routes_collective_phased(db, macs, src, dst, "balanced")
        return {"pair_phase": program.pair_phase, "k": program.n_phases,
                "routes": [plan.reap() for plan in program.phases]}
    return {"routes": [oracle.routes_collective(db, macs, src, dst, "balanced")]}


@pytest.mark.parametrize("phased", [False, True], ids=["flat", "phased"])
def test_the_two_grouping_paths_route_alike(phased, monkeypatch):
    if not native.available():
        pytest.skip("no C++ compiler for the native library")
    fused = _route(phased)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)
    plain = _route(phased)
    want = _route(phased, reference=True)
    if phased:
        assert (fused["pair_phase"] == -1).any()
        assert fused["k"] == plain["k"] == want["k"]
        np.testing.assert_array_equal(fused["pair_phase"], plain["pair_phase"])
        np.testing.assert_array_equal(plain["pair_phase"], want["pair_phase"])
    else:
        assert (fused["routes"][0].pair_sub == -1).any()
    assert len(fused["routes"]) == len(plain["routes"]) >= (2 if phased else 1)
    assert len(want["routes"]) == len(plain["routes"])
    for a, b, w in zip(fused["routes"], plain["routes"], want["routes"]):
        for field in FIELDS:
            np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
            np.testing.assert_array_equal(getattr(b, field), np.asarray(getattr(w, field)))
        assert a.max_congestion == b.max_congestion == w.max_congestion
        assert a.n_detours == b.n_detours


def test_timing_samples_follow_the_layers():
    db, macs, src, dst = _collective()
    oracle = db._oracle_engine()
    oracle.refresh(db)

    def samples(call):
        tracing.STATS.samples.clear()
        out = call()
        return {op: len(xs) for op, xs in tracing.STATS.samples.items()}, out

    flat, _ = samples(lambda: oracle.routes_collective(db, macs, src, dst, "balanced"))
    assert flat == {"routes_collective": 1, "routes_collective_dispatch": 1}

    phased, program = samples(lambda: oracle.routes_collective_phased(
        db, macs, src, dst, "balanced", n_phases=2))
    k = len(program.phases)
    assert k == 2
    assert phased == {"routes_collective_phased": 1,
                      "routes_collective_phased_dispatch": 1,
                      "routes_collective_dispatch": k}

    scheduled, program = samples(lambda: oracle.routes_collective(
        db, macs, src, dst, "balanced", schedule=2))
    assert len(program.phases) == k
    assert scheduled == {"routes_collective": 1,
                         "routes_collective_phased_dispatch": 1,
                         "routes_collective_dispatch": 1 + k}
