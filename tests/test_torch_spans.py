"""The oracle's timing spans against the JAX package's.

The reference records one ``STATS`` sample and one ``oracle`` trace event
per call of each of its eleven ``routes_*`` entry points (``_timed_batch``,
with the call's ``n_pairs``) and one ``oracle_refresh`` span around a full
recompute. The launcher's timing summary, the flight recorder's span
trees and the Perfetto slices read them. Each case drives the same call
on both packages' oracles on the CPU and compares the ops of the trace
events in order, with their ``n_pairs``, and the ops ``STATS`` sampled.
"""

import numpy as np
import pytest

from sdnmpi_tpu import topogen as j_topogen
from sdnmpi_tpu.utils import tracing as j_tracing
from sdnmpi_tpu_torch.convert import topology_from_dict
from sdnmpi_tpu_torch.utils import tracing as p_tracing


def _dbs():
    jdb = j_topogen.fattree(4).to_topology_db(backend="jax")
    pdb = topology_from_dict(jdb.to_dict(), backend="torch", device="cpu")
    return jdb, pdb


def _drive(op: str, db, oracle):
    macs = sorted(db.hosts)
    pairs = [(a, b) for a in macs[:4] for b in macs[4:8]]
    src = np.arange(8, dtype=np.int32)
    dst = (src + 3) % 8
    dirty = [sorted(db.switches)[0]]
    calls = {
        "oracle_refresh": lambda: oracle.refresh(db),
        "routes_batch": lambda: oracle.routes_batch(db, pairs),
        "routes_batch_delta": lambda: oracle.routes_batch_delta(db, pairs, dirty),
        "routes_batch_delta_dispatch":
            lambda: oracle.routes_batch_delta_dispatch(db, pairs, dirty).reap(),
        "routes_batch_dispatch": lambda: oracle.routes_batch_dispatch(db, pairs).reap(),
        "routes_batch_balanced": lambda: oracle.routes_batch_balanced(db, pairs),
        "routes_batch_balanced_dispatch":
            lambda: oracle.routes_batch_balanced_dispatch(db, pairs).reap(),
        "routes_batch_adaptive": lambda: oracle.routes_batch_adaptive(db, pairs),
        "routes_collective":
            lambda: oracle.routes_collective(db, macs[:8], src, dst, "shortest"),
        "routes_collective_dispatch": lambda: oracle.routes_collective_dispatch(
            db, macs[:8], src, dst, "shortest").reap(),
        "routes_collective_phased": lambda: oracle.routes_collective_phased(
            db, macs[:8], src, dst, "shortest", n_phases=2),
        "routes_collective_phased_dispatch":
            lambda: oracle.routes_collective_phased_dispatch(
                db, macs[:8], src, dst, "shortest", n_phases=2).reap_all(),
    }
    calls[op]()


def _spans(tracing, op, db, oracle):
    events = []
    tracing.STATS.samples.clear()
    tracing.add_trace_sink(events.append)
    try:
        _drive(op, db, oracle)
    finally:
        tracing.remove_trace_sink(events.append)
    spans = [(e["op"], e.get("n_pairs")) for e in events if e.get("kind") == "oracle"]
    return spans, sorted(tracing.STATS.samples)


SPANS = [
    "oracle_refresh", "routes_batch", "routes_batch_delta",
    "routes_batch_delta_dispatch", "routes_batch_dispatch",
    "routes_batch_balanced", "routes_batch_balanced_dispatch",
    "routes_batch_adaptive", "routes_collective", "routes_collective_dispatch",
    "routes_collective_phased", "routes_collective_phased_dispatch",
]


@pytest.mark.parametrize("op", SPANS)
def test_oracle_spans_match_the_reference(op):
    jdb, pdb = _dbs()
    ref = _spans(j_tracing, op, jdb, jdb._jax_oracle())
    got = _spans(p_tracing, op, pdb, pdb._oracle_engine())
    assert op in ref[1]
    assert got == ref
