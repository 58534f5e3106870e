"""The port's install plane against the JAX package's.

The coalesced window path (packet-ins parked and flushed as one batched
oracle call, installed from the window's ``WindowRoutes`` arrays), its
serial escape hatch, over simulated and wire bytes, the revalidation and
teardown bursts, and the block install of a whole collective, in the
scenarios of ``tests/test_install_plane.py`` and
``tests/test_collective_blocks.py``. Both controllers get the same knobs,
fabric and packets; :func:`tests.test_torch_control.state` must come out
equal.

The largest case, a 64-rank alltoall (4,032 pairs) over the fat-tree
k=8, routes with the balanced and adaptive policies, whose sampled
paths may differ from the reference's on a near-tie (ROADMAP C1). On
these inputs no decision is decided otherwise and the tables compare
exactly; a seeded sample of pairs is delivered through the installed
tables, and every block path of the balanced install is checked to be a
shortest path over live links.
"""

import numpy as np
import pytest

from tests.test_torch_control import (
    MAC,
    PORT,
    announce,
    assert_same,
    build,
    diamond,
    launch_all,
    line,
    make_config,
    send_vmac,
    state,
)

WINDOWS = dict(coalesce_routes=True, coalesce_window_s=10.0, enable_monitor=False)


def _pkt(S, src, dst, payload=b"x"):
    return S.of.Packet(src, dst, payload=payload)


def sc_window_parity(S, wire, pipelined):
    fabric, ctl, events = build(
        S, line, {"wire": wire}, pipelined_install=pipelined, **WINDOWS,
    )
    for src, dst in ((1, 3), (2, 4), (3, 1), (5, 6)):
        fabric.hosts[MAC[src]].send(_pkt(S, MAC[src], MAC[dst]))
    fabric.hosts[MAC[1]].send(_pkt(S, MAC[1], MAC[3], b"y"))
    return state(fabric, ctl, events)


def sc_window_mpi_rewrite(S, pipelined):
    fabric, ctl, events = build(S, line, pipelined_install=pipelined, **WINDOWS)
    announce(S, fabric, MAC[1], "LAUNCH", 0)
    announce(S, fabric, MAC[3], "LAUNCH", 1)
    send_vmac(S, fabric, MAC[1], "P2P", 0, 1)
    ctl.bus.publish(S.ev.EventProcessDelete(1))  # the exit teardown burst
    return state(fabric, ctl, events)


def sc_window_dedup_and_dead_datapath(S):
    fabric, ctl, events = build(S, line, **WINDOWS)
    fabric.hosts[MAC[1]].send(_pkt(S, MAC[1], MAC[3], b"a"))
    ctl.bus.publish(S.ev.EventPacketIn(
        1, 2, _pkt(S, MAC[1], MAC[3], b"b"), S.of.OFP_NO_BUFFER))
    ctl.router.flush_routes()
    ctl.router.dps.discard(2)
    fabric.hosts[MAC[2]].send(_pkt(S, MAC[2], MAC[4]))
    return state(fabric, ctl, events)


def sc_revalidation(S, wire, pipelined):
    """Duplicate topology signals, a disjoint cut, a parallel cable on
    the flows' span, then the cut that partitions the line: the
    revalidation passes and their teardown bursts."""
    fabric, ctl, events = build(
        S, line, {"wire": wire}, pipelined_install=pipelined, **WINDOWS,
    )
    for src, dst in ((1, 3), (2, 4), (3, 2)):
        fabric.hosts[MAC[src]].send(_pkt(S, MAC[src], MAC[dst]))
    for _ in range(2):
        ctl.bus.publish(S.ev.EventTopologyChanged())
    fabric.remove_link(4, 1, 5, 1)
    fabric.add_link(2, 7, 3, 7)
    fabric.bus.publish(S.ev.EventTopologyChanged())
    fabric.remove_link(2, 2, 3, 1)
    return state(fabric, ctl, events)


def sc_diamond_heal(S):
    fabric, ctl, events = build(S, diamond, **WINDOWS)
    for src, dst in ((1, 4), (2, 3), (4, 1)):
        fabric.hosts[MAC[src]].send(_pkt(S, MAC[src], MAC[dst]))
    fabric.remove_link(2, 3, 4, 2)
    fabric.hosts[MAC[1]].send(_pkt(S, MAC[1], MAC[4], b"z"))
    return state(fabric, ctl, events)


SCENARIOS = {
    "window_parity_sim": (sc_window_parity, False, True),
    "window_parity_wire": (sc_window_parity, True, True),
    "serial_sim": (sc_window_parity, False, False),
    "serial_wire": (sc_window_parity, True, False),
    "mpi_rewrite": (sc_window_mpi_rewrite, True),
    "mpi_rewrite_serial": (sc_window_mpi_rewrite, False),
    "dedup_dead_datapath": (sc_window_dedup_and_dead_datapath,),
    "revalidation_sim": (sc_revalidation, False, True),
    "revalidation_wire": (sc_revalidation, True, True),
    "revalidation_serial": (sc_revalidation, False, False),
    "diamond_heal": (sc_diamond_heal,),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_install_plane_matches_jax(name):
    scenario, *args = SCENARIOS[name]
    ref = assert_same(scenario, *args)
    assert ref["fdb_pairs"] or ref["events"]


# -- a 64-rank collective over the fat-tree k=8 -----------------------------

N_RANKS = 64


def sc_collective_k8(S, policy, threshold):
    """Kickoff of a 64-rank alltoall: the block install at
    ``threshold`` 1, the window install at the default 4,096 (4,032
    pairs fall below it)."""
    fabric = S.topogen.fattree(8).to_fabric()
    ctl = S.Controller(fabric, make_config(
        S, collective_policy=policy, block_install_threshold=threshold,
        enable_monitor=False,
    ))
    events: list = []
    ctl.bus.tap(events.append)
    ctl.attach()
    macs = sorted(fabric.hosts)[:N_RANKS]
    launch_all(S, fabric, macs)
    send_vmac(S, fabric, macs[0], "ALLTOALL", 0, 1)
    out = state(fabric, ctl, events)
    out["deliveries"] = _deliver(S, fabric, macs)
    return out


def _deliver(S, fabric, macs) -> list:
    """Send a seeded sample of rank pairs through the installed tables;
    each must arrive at its host with the virtual MAC rewritten."""
    rng = np.random.default_rng(0)
    got = []
    for s, d in rng.integers(0, N_RANKS, (48, 2)):
        if s == d:
            continue
        before = len(fabric.hosts[macs[d]].received)
        send_vmac(S, fabric, macs[s], "ALLTOALL", int(s), int(d))
        inbox = fabric.hosts[macs[d]].received
        assert len(inbox) == before + 1 and inbox[-1].eth_dst == macs[d]
        got.append((int(s), int(d)))
    return got


def _shortest_blocks(ctl) -> int:
    """Every block path of the installed collectives is a shortest
    path over live links (the fabric is idle, so UGAL detours nothing).
    Returns the number of paths checked."""
    db = ctl.topology_manager.topologydb
    t, dist, _ = db._oracle_engine().matrices(db)
    n = 0
    for sw in ctl.southbound.switches.values():
        for entry in sw.block_table:
            b = entry.block
            for hops, length in zip(np.asarray(b.hop_dpid), np.asarray(b.hop_len)):
                path = [int(d) for d in hops[:length]]
                assert all(y in db.links[x] for x, y in zip(path, path[1:]))
                i, j = t.index[path[0]], t.index[path[-1]]
                assert len(path) - 1 == dist[i, j]
                n += 1
    return n


@pytest.mark.parametrize("policy,threshold", [
    ("shortest", 1), ("balanced", 1), ("adaptive", 1), ("adaptive", 4096),
])
def test_collective_k8_matches_jax(policy, threshold):
    ref = assert_same(sc_collective_k8, policy, threshold)
    assert ref["deliveries"]
    if threshold == 1:  # the block install ran
        assert len(ref["collectives"]) == 1 and ref["blocks"]
        assert ref["collectives"][0][8] == N_RANKS * (N_RANKS - 1)
    else:  # the window install ran
        assert not ref["blocks"] and len(ref["fdb_pairs"]) == N_RANKS * (N_RANKS - 1)


def test_block_paths_are_shortest():
    fabric = PORT.topogen.fattree(8).to_fabric()
    ctl = PORT.Controller(fabric, make_config(
        PORT, collective_policy="balanced", block_install_threshold=1,
        enable_monitor=False,
    ))
    ctl.attach()
    macs = sorted(fabric.hosts)[:N_RANKS]
    launch_all(PORT, fabric, macs)
    send_vmac(PORT, fabric, macs[0], "ALLTOALL", 0, 1)
    assert _shortest_blocks(ctl) > 0
