"""The port's device utilization plane against the JAX package's.

The same seeded Monitor samples stage into a ``UtilPlane`` of each
package (the port's on the CPU), through the same topology deltas and
flush clocks. The port's snapshot, normalized base and ``hot_links``
must equal the reference plane's bit for bit, and the port's base must
equal the host-dict path's (``_normalized_base`` with the sample dict)
bit for bit, on every routing entry point. The cases are those of
``tests/test_utilplane.py``; ``hot_links`` is also held against a numpy
stable sort on purposely equal samples (the lower index first).
"""

import numpy as np
import pytest

from sdnmpi_tpu import topogen as j_topogen
from sdnmpi_tpu.core import topology_db as j_tdb
from sdnmpi_tpu.oracle.utilplane import UtilPlane as JPlane
from sdnmpi_tpu_torch import topogen as p_topogen
from sdnmpi_tpu_torch.core import topology_db as p_tdb
from sdnmpi_tpu_torch.oracle.congestion import utilization_matrix
from sdnmpi_tpu_torch.oracle.utilplane import UtilPlane as PPlane

SPECS = {
    "linear5": ("linear", (5,)),
    "fattree4": ("fattree", (4,)),
    "torus3x3": ("torus", ((3, 3),)),
    "dragonfly3x4": ("dragonfly", (3, 4)),
}


def _pair(name):
    fn, args = SPECS[name]
    ref = getattr(j_topogen, fn)(*args).to_topology_db(backend="jax")
    got = getattr(p_topogen, fn)(*args).to_topology_db(backend="torch", device="cpu")
    return ref, got


def _samples(db, seed=0):
    """(dpid, port) -> bps for every directed link, seeded."""
    rng = np.random.default_rng(seed)
    out = {}
    for a in sorted(db.links):
        for b in sorted(db.links[a]):
            lk = db.links[a][b]
            out[(lk.src.dpid, lk.src.port_no)] = float(rng.random() * 1e9)
    return out


def _planes(samples, alpha=1.0, horizon=0.0):
    j, p = JPlane(alpha, horizon), PPlane(alpha, horizon)
    for key, bps in samples.items():
        j.stage(key, bps)
        p.stage(key, bps)
    return j, p


class Side:
    """One package's DB, oracle and plane."""

    def __init__(self, db, oracle, plane):
        self.db, self.oracle, self.plane = db, oracle, plane

    def base(self, link_util, n_rows=37):
        t = self.oracle.refresh(self.db)
        return self.oracle._normalized_base(self.db, t, link_util, 1.0, 10e9, n_rows)


def _sides(name, samples=None, **kw):
    ref, got = _pair(name)
    samples = _samples(got) if samples is None else samples
    j, p = _planes(samples, **kw)
    return Side(ref, ref._jax_oracle(), j), Side(got, got._oracle_engine(), p), samples


def _assert_planes(js, ps, samples, n_rows=37):
    """Port plane base == port dict base == reference plane base, and the
    snapshots equal the host rebuild, bit for bit."""
    got = ps.base(ps.plane, n_rows).numpy()
    np.testing.assert_array_equal(got, ps.base(samples, n_rows))
    np.testing.assert_array_equal(got, np.asarray(js.base(js.plane, n_rows)))
    t = ps.oracle.refresh(ps.db)
    np.testing.assert_array_equal(ps.plane.snapshot().numpy(), utilization_matrix(t, samples))
    np.testing.assert_array_equal(ps.plane.snapshot().numpy(), np.asarray(js.plane.snapshot()))


def _cable(db, i):
    cables = [(a, b) for a in sorted(db.links) for b in sorted(db.links[a]) if a < b]
    return cables[i]


@pytest.mark.parametrize("name", sorted(SPECS))
def test_base_bit_identical(name):
    js, ps, samples = _sides(name)
    _assert_planes(js, ps, samples)
    assert ps.plane.epoch == js.plane.epoch == 2  # the bind, the flush


@pytest.mark.parametrize("n_rows", [1, 37, 5000])
def test_base_scales_bit_identical(n_rows):
    """The share term varies with the batch; each scale is its own
    cached base, each bit-equal."""
    js, ps, samples = _sides("fattree4")
    _assert_planes(js, ps, samples, n_rows)


def test_after_link_deltas():
    """A flapped cable: the removal zeroes exactly the dead slots through
    the delta log, the restore leaves them zero until a fresh sample."""
    js, ps, samples = _sides("fattree4")
    _assert_planes(js, ps, samples)
    a, b = _cable(ps.db, 3)
    ports = {}
    for side, tdb in ((js, j_tdb), (ps, p_tdb)):
        for x, y in ((a, b), (b, a)):
            lk = side.db.links[x][y]
            ports[(x, y)] = (lk.src.port_no, lk.dst.port_no)
            side.db.delete_link(lk)
            side.plane.drop((x, lk.src.port_no))
    for x, y in ((a, b), (b, a)):
        samples.pop((x, ports[(x, y)][0]), None)
    _assert_planes(js, ps, samples)
    assert ps.plane.repair_count == js.plane.repair_count >= 2
    assert ps.plane.rebuild_count == 1
    for side, tdb in ((js, j_tdb), (ps, p_tdb)):
        for x, y in ((a, b), (b, a)):
            px, py = ports[(x, y)]
            side.db.add_link(tdb.Link(tdb.Port(x, px), tdb.Port(y, py)))
    _assert_planes(js, ps, samples)
    for x, y in ((a, b), (b, a)):
        key = (x, ports[(x, y)][0])
        samples[key] = 5e8
        js.plane.stage(key, 5e8)
        ps.plane.stage(key, 5e8)
    _assert_planes(js, ps, samples)
    assert ps.plane.rebuild_count == js.plane.rebuild_count == 1
    assert ps.oracle.repair_count == js.oracle.repair_count == 4


def test_structural_break_rebuilds_with_carry_over():
    """A switch departure breaks the delta log: the plane rebuilds its map
    and carries the surviving links' values over on the device."""
    js, ps, samples = _sides("fattree4")
    _assert_planes(js, ps, samples)
    victim = sorted(ps.db.switches)[0]
    for side in (js, ps):
        doomed = [lk for m in side.db.links.values() for lk in m.values()
                  if victim in (lk.src.dpid, lk.dst.dpid)]
        for lk in doomed:
            side.db.delete_link(lk)
        side.db.delete_switch(side.db.switches[victim])
        for key in [k for k in samples if k[0] == victim]:
            side.plane.drop(key)
    for key in [k for k in samples if k[0] == victim]:
        del samples[key]
    _assert_planes(js, ps, samples)
    assert ps.plane.rebuild_count == js.plane.rebuild_count == 2


def test_routes_identical_through_plane_and_dict():
    """The scanner, the DAG leg, the adaptive batch and a collective route
    alike fed by the plane and by the host dict."""
    _, ps, samples = _sides("fattree4")
    db, oracle, plane = ps.db, ps.oracle, ps.plane
    macs = sorted(db.hosts)
    pairs = [(macs[i], macs[(i + 5) % len(macs)]) for i in range(len(macs))]
    assert oracle.routes_batch_balanced(db, pairs, link_util=plane) == (
        oracle.routes_batch_balanced(db, pairs, link_util=samples))
    assert oracle.routes_batch_balanced(db, pairs, link_util=plane, dag_threshold=1) == (
        oracle.routes_batch_balanced(db, pairs, link_util=samples, dag_threshold=1))
    assert oracle.routes_batch_adaptive(db, pairs, link_util=plane) == (
        oracle.routes_batch_adaptive(db, pairs, link_util=samples))
    src = np.arange(len(macs), dtype=np.int32)
    dst = (src + 3) % len(macs)
    ra = oracle.routes_collective(db, macs, src, dst, link_util=plane)
    rb = oracle.routes_collective(db, macs, src, dst, link_util=samples)
    assert ra.fdbs() == rb.fdbs() and ra.max_congestion == rb.max_congestion


def test_published_snapshot_survives_later_ingest():
    _, ps, samples = _sides("fattree4")
    t = ps.oracle.refresh(ps.db)
    ps.plane.sync(ps.db, t)
    ps.plane.flush()
    e1 = ps.plane.epoch
    frozen = ps.plane.snapshot()
    snap1 = frozen.numpy().copy()
    ps.plane.stage(next(iter(samples)), 123456.0)
    ps.plane.flush()
    assert ps.plane.epoch > e1
    assert not np.array_equal(snap1, ps.plane.snapshot().numpy())
    np.testing.assert_array_equal(frozen.numpy(), snap1)


def test_base_cached_within_epoch():
    _, ps, samples = _sides("fattree4")
    b1, b2 = ps.base(ps.plane, 16), ps.base(ps.plane, 16)
    assert b1 is b2
    ps.plane.stage((999, 999), 1.0)  # unmapped: discarded at the flush
    ps.plane.stage(next(iter(samples)), 777.0)
    assert ps.base(ps.plane, 16) is not b1


@pytest.mark.parametrize("alpha,seq", [
    (1.0, (100.0, 7.0, 3e9)),
    (0.25, (100.0, 200.0, 0.0, 400.0)),
    (0.5, (100.0, None, 300.0)),  # None: a flush that touches another key
])
def test_ewma_matches_reference(alpha, seq):
    js, ps, samples = _sides("linear5", samples={}, alpha=alpha)
    keys = sorted(_samples(ps.db))
    for side in (js, ps):
        side.plane.sync(side.db, side.oracle.refresh(side.db))
    expected = np.float32(0.0)
    for bps in seq:
        key, val = (keys[1], 1.0) if bps is None else (keys[0], bps)
        for side in (js, ps):
            side.plane.stage(key, val)
            side.plane.flush()
        if bps is not None:
            expected = expected * np.float32(1.0 - alpha) + np.float32(bps) * np.float32(alpha)
        i, j = divmod(ps.plane._key_to_flat[keys[0]], ps.plane._v)
        assert ps.plane.snapshot()[i, j].item() == expected
        np.testing.assert_array_equal(ps.plane.snapshot().numpy(),
                                      np.asarray(js.plane.snapshot()))


STALE_SCRIPTS = {
    # (key index, bps) stages and flushes at a clock, per step
    "halves_past_horizon": [((0, 800.0),), 0.0, 5.0, 10.0, 11.0],
    "fresh_sample_resets": [((0, 800.0),), 0.0, ((0, 600.0),), 9.0, 12.0, 19.0],
    "only_stale_decay": [((0, 800.0), (1, 500.0)), 0.0, ((1, 500.0),), 12.0],
    "bounded_for_dead_monitors": [((0, 8e9),), 0.0, *[2.0 + i for i in range(40)],
                                  1e6, ((0, 4e9),), 1e6 + 1, 1e6 + 3],
    "dropped_key_stops": [((0, 800.0),), 0.0, "drop0", 50.0],
}


@pytest.mark.parametrize("horizon", [10.0, 0.0])
@pytest.mark.parametrize("script", sorted(STALE_SCRIPTS))
def test_stale_decay_matches_reference(script, horizon):
    """The stale-horizon decay (and its absence at horizon 0) through a
    scripted clock: snapshots, epochs and decay counts equal the
    reference plane's at every flush."""
    js, ps, _ = _sides("linear5", samples={}, horizon=horizon)
    keys = sorted(_samples(ps.db))
    for side in (js, ps):
        side.plane.sync(side.db, side.oracle.refresh(side.db))
    for step in STALE_SCRIPTS[script]:
        for side in (js, ps):
            if step == "drop0":
                side.plane.drop(keys[0])
            elif isinstance(step, tuple):
                for i, bps in step:
                    side.plane.stage(keys[i], bps)
            else:
                side.plane.flush(now=step)
        np.testing.assert_array_equal(ps.plane.snapshot().numpy(),
                                      np.asarray(js.plane.snapshot()))
        assert (ps.plane.epoch, ps.plane.decay_count) == (
            js.plane.epoch, js.plane.decay_count)
        assert sorted(ps.plane._last_sample) == sorted(js.plane._last_sample)
    if script == "bounded_for_dead_monitors" and horizon:
        assert ps.plane.decay_count == ps.plane._DECAY_ROUNDS_MAX


@pytest.mark.parametrize("ties", [False, True])
def test_hot_links_match_reference_and_numpy(ties):
    """``hot_links`` equals the reference's and a numpy stable sort,
    equal loads in lowest-flat-index order (samples set equal on
    purpose)."""
    ref, got = _pair("fattree4")
    samples = _samples(got)
    if ties:
        keys = sorted(samples)
        for i, key in enumerate(keys):
            samples[key] = float((i % 3) * 1e8)
    js = Side(ref, ref._jax_oracle(), _planes(samples)[0])
    ps = Side(got, got._oracle_engine(), _planes(samples)[1])
    for side in (js, ps):
        side.plane.sync(side.db, side.oracle.refresh(side.db))
        side.plane.flush()
    for k in (1, 8, 40):
        hot = ps.plane.hot_links(k)
        assert hot == js.plane.hot_links(k)
        flat = ps.plane.snapshot().numpy().reshape(-1)
        order = np.argsort(-flat, kind="stable")[:k]
        want = [int(i) for i in order if flat[i] > 0]
        v = ps.plane._v
        rows = {r: d for d, r in ps.oracle.refresh(ps.db).index.items()}
        assert [(h["src"], h["dst"], h["bps"]) for h in hot] == [
            (rows[i // v], rows[i % v], float(flat[i])) for i in want]


def test_add_before_remove_keeps_live_mapping():
    """Port p re-cabled a->b to a->c, the link+ logged before the link-:
    the key stays bound to the new slot, as in the reference."""
    ref, got = _pair("linear5")
    samples = _samples(got)
    js = Side(ref, ref._jax_oracle(), _planes(samples)[0])
    ps = Side(got, got._oracle_engine(), _planes(samples)[1])
    _assert_planes(js, ps, samples)
    dpids = sorted(got.switches)
    a, b, c = dpids[1], dpids[2], dpids[0]
    p = got.links[a][b].src.port_no
    for side, tdb in ((js, j_tdb), (ps, p_tdb)):
        old = side.db.links[a][b]
        side.db.add_link(tdb.Link(tdb.Port(a, p), tdb.Port(c, 99)))
        side.db.delete_link(old)
        side.plane.drop((a, p))
    samples.pop((a, p), None)
    _assert_planes(js, ps, samples)
    samples[(a, p)] = 4.2e9
    js.plane.stage((a, p), 4.2e9)
    ps.plane.stage((a, p), 4.2e9)
    _assert_planes(js, ps, samples)
    t = ps.oracle.refresh(ps.db)
    assert ps.plane.snapshot()[t.index[a], t.index[c]].item() == np.float32(4.2e9)
    assert ps.plane.rebuild_count == 1


def test_sample_batches_of_every_bucket_size():
    """Sample batches of 1 to 33 keys pad to the bucket ladder; the pads
    are never scattered (an out-of-range write raises on the CPU) and
    the values equal the reference's."""
    js, ps, samples = _sides("fattree4", samples={})
    items = sorted(_samples(ps.db).items())
    for side in (js, ps):
        side.plane.sync(side.db, side.oracle.refresh(side.db))
    for n in (1, 2, 3, 5, 7, 8, 9, 13, 17, 25, 31, 33):
        for side in (js, ps):
            for key, bps in items[:n]:
                side.plane.stage(key, bps + n)
            side.plane.flush()
        np.testing.assert_array_equal(ps.plane.snapshot().numpy(),
                                      np.asarray(js.plane.snapshot()))
    assert ps.plane.flush_count == js.plane.flush_count == 12


# -- the closed loop: Monitor -> TopologyManager -> oracle --------------------


def _stack(S, **cfg):
    from tests.test_torch_control import build, diamond

    fabric, ctl, _ = build(S, diamond, **cfg)
    return fabric, ctl


def _heat(S, fabric, ctl, n_packets=40, t0=0.0):
    from tests.test_torch_control import MAC, ip_packet

    ctl.monitor.poll(now=t0)
    for _ in range(n_packets):
        fabric.hosts[MAC[1]].send(ip_packet(S, MAC[1], MAC[4], payload=b"x" * 900))
    ctl.monitor.poll(now=t0 + 1.0)


def test_plane_feeds_routing_and_matches_host_dict():
    """The plane is the utilization input the balanced batch reads: the
    route avoids the measured-hot arm, as the reference's does, and the
    plane mirrors the host dict exactly."""
    from tests.test_torch_control import MAC, PORT, REF

    fdbs = []
    for S in (REF, PORT):
        fabric, ctl = _stack(S)
        tm = ctl.topology_manager
        assert tm.util_plane is not None and tm.routing_util() is tm.util_plane
        _heat(S, fabric, ctl)
        reply = ctl.bus.request(S.ev.FindRoutesBatchRequest(
            [(MAC[1], MAC[4])], policy="balanced"))
        fdbs.append(reply.fdbs)
        hot = 2 if tm.link_util.get((1, 2), 0) > 0 else 3
        mids = [dpid for dpid, _ in reply.fdbs[0]]
        assert 5 - hot in mids and hot not in mids
    assert fdbs[0] == fdbs[1]
    db = tm.topologydb
    t = db._oracle_engine().refresh(db)
    tm.util_plane.sync(db, t)
    tm.util_plane.flush()
    np.testing.assert_array_equal(tm.util_plane.snapshot().numpy(),
                                  utilization_matrix(t, tm.link_util))


def test_monitor_pass_flushes_bound_plane():
    from tests.test_torch_control import MAC, PORT

    fabric, ctl = _stack(PORT)
    tm = ctl.topology_manager
    _heat(PORT, fabric, ctl)
    ctl.bus.request(PORT.ev.FindRoutesBatchRequest([(MAC[1], MAC[4])], policy="balanced"))
    e0 = tm.util_plane.epoch
    _heat(PORT, fabric, ctl, n_packets=10, t0=2.0)
    assert tm.util_plane.epoch > e0
    assert tm.congestion is not None


@pytest.mark.parametrize("cfg", [{"util_plane": False}, {"oracle_backend": "py"}])
def test_no_plane_falls_back_to_dict(cfg):
    from sdnmpi_tpu_torch.config import Config
    from sdnmpi_tpu_torch.control.bus import EventBus
    from sdnmpi_tpu_torch.control.topology_manager import TopologyManager

    tm = TopologyManager(EventBus(), None, Config(device="cpu", **cfg))
    assert tm.util_plane is None and tm.routing_util() is tm.link_util


def test_restore_seeds_plane():
    """A checkpoint restore stages the snapshotted utilization into the
    plane, so the first route after it avoids the hot arm, as the
    reference's restore does (``tests/test_utilplane.py``)."""
    import importlib

    from tests.test_torch_control import MAC, PORT, REF

    for S, pkg in ((REF, "sdnmpi_tpu"), (PORT, "sdnmpi_tpu_torch")):
        snapshot = importlib.import_module(f"{pkg}.api.snapshot")
        fabric, ctl = _stack(S)
        _heat(S, fabric, ctl)
        snap = snapshot.snapshot_controller(ctl)
        _, fresh = _stack(S)
        snapshot.restore_controller(fresh, snap)
        tm = fresh.topology_manager
        assert tm.link_util == ctl.topology_manager.link_util
        assert tm.util_plane.has_staged
        hot = 2 if tm.link_util.get((1, 2), 0) > 0 else 3
        reply = fresh.bus.request(S.ev.FindRoutesBatchRequest(
            [(MAC[1], MAC[4])], policy="balanced"))
        mids = [dpid for dpid, _ in reply.fdbs[0]]
        assert 5 - hot in mids and hot not in mids
