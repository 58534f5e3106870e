"""The port's RPC mirror, its wire ABI and checkpoints against the JAX
package's.

Both controllers (the reference on backend ``"jax"``, the port on
``device="cpu"``, each with its default planes) run the same scenario with an ``RPCInterface`` attached: the JSON-RPC message
streams a client receives, the ``init_*`` snapshots included, must be
equal, and the port must still produce ``tests/test_api.py``'s golden
wire vectors. Checkpoints are the same JSON in both packages and
restore across them. One test runs the mirror over a real WebSocket.
"""

import asyncio
import importlib
import json

import pytest

from tests.test_api import FakeClient
from tests.test_torch_control import (
    MAC,
    PORT,
    REF,
    announce,
    build,
    diamond,
    ip_packet,
    launch_all,
    send_vmac,
)


def api(S, name):
    pkg = "sdnmpi_tpu" if S is REF else "sdnmpi_tpu_torch"
    return importlib.import_module(f"{pkg}.api.{name}")


def _json(x):
    return json.loads(json.dumps(x))


#: pull requests a client may send; replies that carry wall-clock
#: readings (:data:`TIMED`) compare by their keys
PULLS = [
    {"jsonrpc": "2.0", "id": 1, "method": "span_tree", "params": [10**12]},
    {"jsonrpc": "2.0", "id": 2, "method": "flight_dump"},
    {"jsonrpc": "2.0", "id": 3, "method": "traffic_matrix"},
    {"jsonrpc": "2.0", "id": 4, "method": "replica_status"},
    {"jsonrpc": "2.0", "id": 5, "method": "no_such_method"},
    {"jsonrpc": "2.0", "id": 6, "method": "span_tree", "params": []},
    {"jsonrpc": "2.0", "method": "replica_relay", "params": [{}]},
    ["not", "a", "dict"],
    {"jsonrpc": "2.0", "id": 7, "method": "telemetry"},
    {"jsonrpc": "2.0", "id": 8, "method": "timeline", "params": ["n_rows"]},
]
#: ids of the pulls whose results hold timestamps or timings
TIMED = (2, 7)


def _anomaly_shape(messages):
    """``anomaly`` broadcasts carry a bundle's timestamps and metric
    deltas (the reference's also its JAX trace counts): compare their
    trigger and the bundle's keys."""
    return [
        dict(m, params=[m["params"][0], sorted(m["params"][1]), m["params"][2]])
        if isinstance(m, dict) and m.get("method") == "anomaly" else m
        for m in messages
    ]


def _shape(replies):
    return [
        dict(r, result=sorted(r["result"]))
        if isinstance(r, dict) and r.get("id") in TIMED and "result" in r
        else r
        for r in replies
    ]


def sc_mirror(S):
    """A client attached from the start sees every broadcast; one
    attached at the end gets the populated ``init_*`` snapshots."""
    fabric, ctl, _ = build(S, diamond, block_install_threshold=1)
    rpc = api(S, "rpc").RPCInterface(ctl.bus, ctl.config)
    early, dead = FakeClient(), FakeClient()
    rpc.attach_client(early)
    rpc.attach_client(dead)
    dead.dead = True
    launch_all(S, fabric, [MAC[1], MAC[2], MAC[3], MAC[4]])
    fabric.hosts[MAC[1]].send(ip_packet(S, MAC[1], MAC[4]))
    fabric.hosts[MAC[2]].send(ip_packet(S, MAC[2], MAC[3]))
    send_vmac(S, fabric, MAC[1], "ALLTOALL", 0, 1)
    fabric.remove_link(2, 3, 4, 2)
    announce(S, fabric, MAC[4], "EXIT", 3)
    late = FakeClient()
    rpc.attach_client(late)
    replies = [rpc.handle_request(m) for m in PULLS]
    return {
        "early": _anomaly_shape(_json(early.messages)),
        "late": _anomaly_shape(_json(late.messages)),
        "dead_dropped": dead not in rpc.clients,
        "replies": _shape(_json(replies)),
    }


def test_mirror_streams_match_the_reference():
    ref, got = sc_mirror(REF), sc_mirror(PORT)
    assert got == ref
    methods = [m["method"] for m in got["early"]]
    for m in ("init_fdb", "add_process", "update_fdb", "install_collective",
              "delete_link", "remove_collective", "delete_process"):
        assert m in methods, m
    # the flight_dump pull freezes a manual bundle, which both
    # packages broadcast as an anomaly
    assert [m["method"] for m in got["late"]] == [
        "init_fdb", "init_rankdb", "init_topologydb", "init_collectives",
        "anomaly",
    ]
    assert got["dead_dropped"]


def test_telemetry_and_timeline_requests_name_a11():
    """The ``telemetry`` and ``timeline`` pulls answer with the
    reference's payloads (the registry snapshot's sections, the
    timeline's series after two Monitor passes), and ``rpc_telemetry``
    broadcasts one ``update_telemetry`` per pass to attached clients."""
    def pulls(S):
        # every instrument of each package registered, whatever this
        # process imported before
        api(S, "telemetry")._import_instrumented()
        fabric, ctl, _ = build(S, diamond)
        rpc = api(S, "rpc").RPCInterface(ctl.bus, ctl.config)
        client = FakeClient()
        rpc.attach_client(client)
        launch_all(S, fabric, [MAC[1], MAC[4]])
        fabric.hosts[MAC[1]].send(ip_packet(S, MAC[1], MAC[4]))
        ctl.monitor.poll(now=0.0)
        ctl.monitor.poll(now=1.0)
        tel = rpc.handle_request({"jsonrpc": "2.0", "id": 1, "method": "telemetry"})
        tl = rpc.handle_request({"jsonrpc": "2.0", "id": 2, "method": "timeline",
                                 "params": ["desired_flows"]})
        pushed = [m for m in client.messages if m["method"] == "update_telemetry"]
        return {
            "telemetry": sorted(tel["result"]),
            "counters": sorted(tel["result"]["counters"]),
            "timeline": [v for _, v in tl["result"]["series"]["desired_flows"]],
            "n_rows": tl["result"]["n_rows"],
            "pushed": len(pushed),
        }

    ref, got = pulls(REF), pulls(PORT)
    assert got["n_rows"] == ref["n_rows"] == 2 and got["pushed"] == ref["pushed"] == 2
    assert got["timeline"] == ref["timeline"]
    assert got["telemetry"] == ref["telemetry"]
    # every counter the port's snapshot carries, the reference's carries
    assert set(got["counters"]) <= set(ref["counters"])


def _golden_stack():
    fabric, ctl, _ = build(PORT, diamond)
    return fabric, ctl, api(PORT, "rpc").RPCInterface(ctl.bus, ctl.config)


def test_golden_init_fdb_and_rankdb():
    """``tests/test_api.py``'s golden vectors, on the port."""
    fabric, ctl, rpc = _golden_stack()
    fabric.hosts[MAC[1]].send(ip_packet(PORT, MAC[1], MAC[2]))
    announce(PORT, fabric, MAC[1], "LAUNCH", 0)
    announce(PORT, fabric, MAC[2], "LAUNCH", 1)
    client = FakeClient()
    rpc.attach_client(client)
    assert client.messages[0]["params"][0] == [
        {"dpid": 1, "fdb": [{"src": MAC[1], "dst": MAC[2], "out_port": 2}]},
        {"dpid": 2, "fdb": [{"src": MAC[1], "dst": MAC[2], "out_port": 1}]},
    ]
    payload = client.messages[1]["params"][0]
    assert payload == {0: MAC[1], 1: MAC[2]}
    assert json.loads(json.dumps(payload)) == {"0": MAC[1], "1": MAC[2]}


def test_golden_init_topologydb():
    fabric, ctl, rpc = _golden_stack()
    client = FakeClient()
    rpc.attach_client(client)
    topo = client.messages[2]["params"][0]
    sw1 = next(s for s in topo["switches"] if s["dpid"] == "%016x" % 1)
    assert sorted(p["port_no"] for p in sw1["ports"]) == [
        "00000001", "00000002", "00000003",
    ]
    assert all(set(p) == {"dpid", "port_no", "hw_addr", "name"} for p in sw1["ports"])
    assert {p["name"] for p in sw1["ports"]} == {"s1-eth1", "s1-eth2", "s1-eth3"}
    h1 = next(h for h in topo["hosts"] if h["mac"] == MAC[1])
    assert set(h1) == {"mac", "ipv4", "ipv6", "port"}
    assert h1["port"]["dpid"] == "%016x" % 1
    assert set(topo["links"][0]) == {"src", "dst"}


@pytest.mark.parametrize("spec", [("fattree", (4,)), ("torus", ((3, 3),)),
                                  ("dragonfly", (4, 8, 1, 2))])
def test_wire_payloads_match_the_reference(spec):
    name, args = spec
    ref = getattr(REF.topogen, name)(*args).to_topology_db(backend="py")
    got = getattr(PORT.topogen, name)(*args).to_topology_db(backend="py")
    assert _json(api(PORT, "wire").topology(got)) == _json(api(REF, "wire").topology(ref))


# -- checkpoints -------------------------------------------------------------


def sc_populated(S):
    """The diamond with ranks, a routed pair, a block-installed
    collective and a Monitor sample."""
    fabric, ctl, _ = build(S, diamond, block_install_threshold=1)
    ctl.traffic.clock = iter(range(100)).__next__  # a 1 Hz flush clock
    launch_all(S, fabric, [MAC[1], MAC[2], MAC[3], MAC[4]])
    fabric.hosts[MAC[1]].send(ip_packet(S, MAC[1], MAC[4]))
    ctl.monitor.poll(now=0.0)
    fabric.hosts[MAC[1]].send(ip_packet(S, MAC[1], MAC[4]))
    ctl.monitor.poll(now=1.0)
    send_vmac(S, fabric, MAC[2], "ALLTOALL", 1, 2)
    return fabric, ctl


#: checkpoint sections the two packages must write equal
SECTIONS = ("version", "route_cache", "desired_flows", "topology", "fdb",
            "rankdb", "link_util", "collectives", "audit_baselines",
            "traffic_plane")


def test_snapshot_matches_the_reference():
    ref = _json(api(REF, "snapshot").snapshot_controller(sc_populated(REF)[1]))
    got = _json(api(PORT, "snapshot").snapshot_controller(sc_populated(PORT)[1]))
    for key in SECTIONS:
        assert got[key] == ref[key], key
    assert got["collectives"] and got["desired_flows"]["rows"]
    assert got["audit_baselines"]["rows"] and got["traffic_plane"]["mode"] == "edge"
    assert got["hier_border"] is ref["hier_border"] is None


@pytest.mark.parametrize("writer,reader", [(REF, PORT), (PORT, REF)],
                         ids=["ref-to-port", "port-to-ref"])
def test_checkpoint_restores_across_packages(writer, reader, tmp_path):
    """A checkpoint file written by one package restores into a fresh
    controller of the other, which then checkpoints the same state."""
    path = tmp_path / "state.json"
    api(writer, "snapshot").save_checkpoint(sc_populated(writer)[1], path)
    saved = json.loads(path.read_text())
    fabric, ctl, events = build(reader, diamond, block_install_threshold=1)
    api(reader, "snapshot").load_checkpoint(ctl, path)
    again = _json(api(reader, "snapshot").snapshot_controller(ctl))
    for key in ("topology", "fdb", "rankdb", "desired_flows", "collectives", "route_cache"):
        assert again[key] == saved[key], key
    assert ctl.topology_manager.topologydb.find_route(MAC[1], MAC[4]) == [
        (1, 2), (2, 3), (4, 1)
    ]
    assert not [e for e in events if type(e).__name__ == "EventSnapshotColdStart"]


def _border_rows(ctl) -> dict:
    """The hier oracle's materialized border rows, pod -> list."""
    hier = ctl.topology_manager.topologydb._oracle._hier
    return {p: r.tolist() for p, r in sorted(hier.rows.items())}


def test_unported_sections_restore_with_a_cold_start_note():
    """A checkpoint of a controller under the hierarchical oracle, with
    audit baselines, a traffic matrix and hier border rows, restores
    into both packages from either: the audit's counters, the matrix's
    cells and the border rows as the reference restores them, with no
    cold-start note. A border plane of another fabric is rejected
    without a crash."""
    def fattree(S, **kw):
        return S.topogen.fattree(4).to_fabric(**kw)

    for writer in (REF, PORT):
        fabric, ctl, _ = build(writer, fattree, hier_oracle=True)
        macs = sorted(fabric.hosts)
        ctl.traffic.clock = iter(range(100)).__next__  # a 1 Hz flush clock
        launch_all(writer, fabric, [macs[0], macs[9]])
        ctl.router.reinstall_pairs([(macs[0], macs[9]), (macs[3], macs[14])])
        for t in (0.0, 1.0):
            fabric.hosts[macs[0]].send(ip_packet(writer, macs[0], macs[9]))
            ctl.monitor.poll(now=t)
        snap = _json(api(writer, "snapshot").snapshot_controller(ctl))
        assert snap["audit_baselines"]["rows"] and snap["traffic_plane"]["cells"]
        assert snap["hier_border"]["pods"]
        saved_rows = _border_rows(ctl)
        restored = {}
        for name, S in (("ref", REF), ("port", PORT)):
            fabric, ctl, events = build(S, fattree, hier_oracle=True)
            api(S, "snapshot").restore_controller(ctl, snap)
            restored[name] = {
                "notes": [e.reason for e in events
                          if type(e).__name__ == "EventSnapshotColdStart"],
                "counters": ctl.audit._counters, "cycle": ctl.audit.cycle,
                "matrix": ctl.traffic.matrix(),
                "ranks": dict(ctl.process_manager.rankdb.processes),
                "rows": _border_rows(ctl),
            }
        got, ref = restored["port"], restored["ref"]
        assert got["notes"] == ref["notes"] == []
        for key in ("counters", "cycle", "matrix", "ranks", "rows"):
            assert got[key] == ref[key], key
        assert got["rows"] == saved_rows and got["matrix"]["cells"]
    # another fabric's plane: counted, never raised, the lazy path serves
    # (on the diamond, one pod and no borders)
    fabric, ctl, _ = build(PORT, diamond, hier_oracle=True)
    db = ctl.topology_manager.topologydb
    db._oracle_engine()
    rejected = api(PORT, "snapshot").REGISTRY.get("hier_snapshot_rejected_total")
    before = rejected.value
    assert db.hier_restore_border_rows(dict(snap["hier_border"], digest="0" * 32)) == 0
    assert rejected.value == before + 1
    assert db.find_route(MAC[1], MAC[4]) == [(1, 2), (2, 3), (4, 1)]


def test_version_and_digest_mismatch_degrade_to_cold_start():
    snap = _json(api(PORT, "snapshot").snapshot_controller(sc_populated(PORT)[1]))
    fabric, ctl, events = build(PORT, diamond)
    api(PORT, "snapshot").restore_controller(ctl, dict(snap, version=99))
    assert not ctl.process_manager.rankdb.processes
    snap["desired_flows"]["topology_digest"] = "0" * 32
    api(PORT, "snapshot").restore_controller(ctl, snap)
    notes = [e.reason for e in events if type(e).__name__ == "EventSnapshotColdStart"]
    assert notes == ["unsupported snapshot version 99",
                     "desired-flow topology digest mismatch"]


# -- the real transport -----------------------------------------------------


def test_real_websocket_roundtrip():
    """The port's mirror over a real WebSocket: the init snapshots, a
    broadcast, and pull requests answered on the same socket."""
    websockets = pytest.importorskip("websockets")

    async def scenario():
        import socket

        probe = socket.socket()
        probe.bind(("127.0.0.1", 0))
        port = probe.getsockname()[1]
        probe.close()
        fabric, ctl, _ = build(PORT, diamond, rpc_port=port)
        rpc = api(PORT, "rpc").RPCInterface(ctl.bus, ctl.config)
        server = asyncio.create_task(rpc.serve())
        uri = f"ws://{ctl.config.rpc_host}:{port}{ctl.config.rpc_path}"
        for _ in range(100):
            if server.done():
                server.result()
                raise AssertionError("RPC server exited before listening")
            try:
                ws = await websockets.connect(uri)
                break
            except OSError:
                await asyncio.sleep(0.1)
        else:
            raise TimeoutError("RPC server never started listening")
        messages = []
        async with ws:
            await asyncio.sleep(0.1)
            announce(PORT, fabric, MAC[1], "LAUNCH", 3)
            for _ in range(5):
                messages.append(json.loads(await asyncio.wait_for(ws.recv(), 5)))
            for req in ({"jsonrpc": "2.0", "id": 1, "method": "replica_status"},
                        {"jsonrpc": "2.0", "id": 2, "method": "telemetry"}):
                await ws.send(json.dumps(req))
                messages.append(json.loads(await asyncio.wait_for(ws.recv(), 5)))
        server.cancel()
        return messages

    messages = asyncio.run(scenario())
    assert [m.get("method") for m in messages[:5]] == [
        "init_fdb", "init_rankdb", "init_topologydb", "init_collectives",
        "add_process",
    ]
    assert messages[4]["params"] == [3, MAC[1]]
    assert messages[5] == {"jsonrpc": "2.0", "id": 1, "result": {"mode": "off"}}
    assert messages[6]["id"] == 2 and {"counters", "gauges", "histograms"} <= set(
        messages[6]["result"])
