"""The port's command line against the JAX package's.

``sdnmpi_tpu_torch.launch`` takes every flag of ``sdnmpi_tpu.launch``
under the same name. For a table of argument lists both packages'
``config_from_args`` agree field by field, except the deliberate
differences of ROADMAP C (:data:`DIFFERENCES`); ``--distributed`` is
parsed as the reference parses it, and a malformed spec fails the launch
with the reference's message before anything is built (a two-process
launch runs in ``tests/test_torch_multiprocess.py``).
The demo run writes the same checkpoint in both packages, and each
package's checkpoint restores into the other's launcher.
"""

import asyncio
import dataclasses
import json
import logging
import re
import runpy
import sys

import pytest

from sdnmpi_tpu import launch as ref_launch
from sdnmpi_tpu_torch import launch as port_launch

#: Config fields where the port's launcher deliberately differs from
#: the reference's (ROADMAP C), with the port's value
DIFFERENCES = {
    # --backend torch|py where the reference has jax|py
    "oracle_backend": "torch",
    # --device, the port's explicit-device rule
    "device": "cpu",
}

ARGVS = [
    [],
    ["--profile", "no-monitor", "--topo", "fattree:8", "--demo", "--demo-ranks", "64"],
    ["--profile", "debug", "--listen", "127.0.0.1:6633", "--lldp-reprobe", "3"],
    ["--policy", "adaptive", "--mesh-devices", "8", "--shard-oracle", "--ring-exchange"],
    ["--policy", "shortest", "--observe-links", "--wire", "--flow-idle-timeout", "30",
     "--flow-hard-timeout", "300"],
    ["--no-route-cache", "--admission-rate", "50", "--tenants", "4",
     "--offered-rate", "400"],
    ["--compile-cache-dir", "cache", "--warm-serving", "--route-cache"],
    ["--no-recovery", "--no-install-barriers", "--install-retry-max", "2",
     "--install-retry-backoff", "0.5", "--echo-interval", "5", "--echo-timeout", "9"],
    ["--event-log", "e.jsonl", "--event-log-max-bytes", "100", "--trace-log",
     "t.jsonl", "--profile-dir", "prof", "--rpc-host", "0.0.0.0", "--rpc-port", "9"],
    ["--no-fabric-audit", "--no-traffic-plane", "--no-flight-recorder",
     "--no-delta-reval", "--no-hier-snapshot", "--reconcile-max-per-flush", "3",
     "--hier-warm", "--no-ring-exchange"],
    ["--schedule-phases", "4"],
    ["--schedule-phases", "0", "--no-delta-reval", "--policy", "adaptive"],
    # the observability and HA planes' flags
    ["--chaos", "3", "--metrics-dump", "-", "--trace-dump", "trace.json"],
    ["--replica-peer", "ws://peer:8080/v1.0/sdnmpi/ws", "--ownership", "1/2",
     "--lease-interval", "2", "--lease-timeout", "5"],
    ["--slo-target", "victim:50:0.999", "--slo-target", "bulk:200",
     "--flight-dump", "bundles", "--anomaly-latency-threshold", "0.5",
     "--anomaly-p99-factor", "3", "--profile-dump", "prof"],
    ["--audit-switches-per-flush", "8", "--sentinel-sample-per-flush", "8",
     "--sentinel-divergence-factor", "3", "--sentinel-heal"],
    ["--no-fabric-audit", "--sentinel-sample-per-flush", "0"],
    # the hierarchical oracle's flags, alone and beside the planes'
    ["--chaos", "3", "--hier-oracle"],
    ["--metrics-dump", "-", "--hier-pod-target", "16"],
    ["--trace-dump", "trace.json", "--no-hier-warm"],
    ["--ownership", "0/2", "--hier-oracle"],
    ["--lease-interval", "2", "--hier-pod-target", "8"],
    ["--lease-timeout", "5", "--no-hier-warm"],
    ["--slo-target", "victim:50:0.999", "--hier-oracle"],
    ["--anomaly-latency-threshold", "0.5", "--hier-oracle"],
    ["--anomaly-p99-factor", "3", "--hier-pod-target", "4"],
    ["--profile-dump", "prof", "--no-hier-warm"],
    ["--audit-switches-per-flush", "8", "--hier-oracle"],
    ["--sentinel-sample-per-flush", "8", "--hier-oracle"],
    ["--sentinel-heal", "--hier-oracle"],
    ["--schedule-phases", "4", "--hier-oracle"],
    ["--schedule-phases", "0", "--flight-dump", "bundles", "--no-hier-warm"],
    ["--hier-oracle"],
    ["--hier-pod-target", "16"],
    ["--no-hier-warm"],
]


def _configs(argv):
    ref = ref_launch.config_from_args(
        ref_launch.build_parser().parse_args(argv + ["--backend", "jax"]))
    got = port_launch.config_from_args(
        port_launch.build_parser().parse_args(argv + ["--device", "cpu"]))
    return dataclasses.asdict(ref), dataclasses.asdict(got)


@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: " ".join(a) or "defaults")
def test_config_from_args_matches_the_reference(argv):
    ref, got = _configs(argv)
    assert set(got) == set(ref) | {"device"}
    for field in sorted(got):
        if field in DIFFERENCES:
            assert got[field] == DIFFERENCES[field], field
        else:
            assert got[field] == ref[field], field


def test_every_reference_flag_is_accepted():
    """The same flags under the same names and defaults; the port adds
    ``--device`` and takes ``torch`` where the reference takes ``jax``."""
    def actions(parser):
        return {a.dest: a for a in parser._actions if a.option_strings}

    ref = actions(ref_launch.build_parser())
    got = actions(port_launch.build_parser())
    assert set(got) == set(ref) | {"device"}
    flags = lambda acts: sorted(s for a in acts for s in a.option_strings)  # noqa: E731
    assert flags(got.values()) == sorted(flags(ref.values()) + ["--device"])
    for dest, action in ref.items():
        if dest != "backend":
            assert got[dest].default == action.default, dest
    assert got["backend"].choices == ["torch", "py"]
    assert (got["backend"].default, got["device"].default) == ("torch", "cuda")
    # the reference's 68 add_argument calls, beside --help
    ref_flags = [a for a in ref_launch.build_parser()._actions if a.option_strings]
    got_flags = [a for a in port_launch.build_parser()._actions if a.option_strings]
    assert (len(ref_flags), len(got_flags)) == (69, 70)


#: ``--distributed`` beside the flags of other planes, each with a
#: malformed twin of its spec
DISTRIBUTED = [
    (["--replica-peer", "ws://peer:8080/v1.0/sdnmpi/ws", "--distributed",
      "127.0.0.1:1234,2,0"], "127.0.0.1:1234,2"),
    (["--flight-dump", "bundles", "--distributed", "127.0.0.1:1234,2,1"],
     "127.0.0.1:1234,2,2"),
    (["--sentinel-divergence-factor", "3", "--distributed",
      "127.0.0.1:1234,3,2"], "1234,3,2"),
    (["--distributed", "127.0.0.1:1234,2,0"], "127.0.0.1:1234,two,0"),
]


# the ids these cases had while the port refused --distributed
@pytest.mark.parametrize("argv,bad", DISTRIBUTED,
                         ids=[f"{argv[0]}-A12 item 2" for argv, _ in DISTRIBUTED])
def test_unported_flags_refuse_the_launch(argv, bad):
    """Both parsers take ``--distributed``; the port's config equals the
    reference's beside the other planes' flags, and its
    ``parse_distributed`` the reference's. A malformed spec fails the
    launch with the reference's message, before anything is built."""
    ref, got = _configs(argv)
    for field in sorted(got):
        assert got[field] == DIFFERENCES.get(field, ref.get(field)), field
    spec = argv[argv.index("--distributed") + 1]
    assert port_launch.parse_distributed(spec) == ref_launch.parse_distributed(spec)
    with pytest.raises(SystemExit) as want:
        ref_launch.parse_distributed(bad)
    args = port_launch.build_parser().parse_args(
        argv[:-1] + [bad, "--device", "cpu", "--no-rpc"])
    with pytest.raises(SystemExit, match=re.escape(str(want.value))):
        asyncio.run(port_launch.amain(args))


def test_the_mirror_needs_websockets(monkeypatch):
    """Without ``websockets`` a launch that keeps the mirror fails at
    once, naming the ``rpc`` extra; ``--no-rpc`` runs."""
    import importlib.util

    find_spec = importlib.util.find_spec
    monkeypatch.setattr(
        port_launch.importlib.util, "find_spec",
        lambda name, *a: None if name == "websockets" else find_spec(name, *a),
    )
    args = port_launch.build_parser().parse_args(["--device", "cpu", "--duration", "0.01"])
    with pytest.raises(SystemExit, match="rpc extra"):
        asyncio.run(port_launch.amain(args))
    asyncio.run(port_launch.amain(port_launch.build_parser().parse_args(
        ["--device", "cpu", "--duration", "0.01", "--no-rpc"])))


def test_python_dash_m_runs_the_demo(monkeypatch, tmp_path, caplog):
    """``python -m sdnmpi_tpu_torch --device cpu --topo fattree:4 --demo
    --no-rpc --duration 0.2``, run as ``-m`` runs it, in this process."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "argv", [
        "sdnmpi_tpu_torch", "--device", "cpu", "--topo", "fattree:4", "--demo",
        "--no-rpc", "--duration", "0.2",
    ])
    # main() configures logging as the launch profiles do: undo it after
    monitor, root = logging.getLogger("Monitor"), logging.getLogger()
    saved = [(lg, list(lg.handlers), lg.level, lg.propagate) for lg in (monitor, root)]
    try:
        with caplog.at_level(logging.INFO, logger="launch"):
            runpy.run_module("sdnmpi_tpu_torch", run_name="__main__")
    finally:
        for lg, handlers, level, propagate in saved:
            for h in lg.handlers:
                if h not in handlers:
                    h.close()
            lg.handlers[:] = handlers
            lg.setLevel(level)
            lg.propagate = propagate
    assert "demo: 8 ranks, alltoall kicked off, 216 flows installed" in caplog.text
    assert (tmp_path / "log" / "monitor.log").exists()


# -- the demo run and its checkpoint ----------------------------------------


DEMO = ["--topo", "fattree:4", "--demo", "--demo-ranks", "8", "--no-rpc",
        "--duration", "0.1"]
#: checkpoint sections that carry the controller's state
STATE = ("topology", "fdb", "rankdb", "collectives", "desired_flows", "route_cache",
         "audit_baselines", "traffic_plane")


def _run(pkg_launch, argv):
    side = ["--backend", "jax"] if pkg_launch is ref_launch else ["--device", "cpu"]
    asyncio.run(pkg_launch.amain(pkg_launch.build_parser().parse_args(argv + side)))


@pytest.fixture(scope="module")
def demo_checkpoints(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt")
    _run(ref_launch, DEMO + ["--checkpoint", str(d / "ref.json")])
    _run(port_launch, DEMO + ["--checkpoint", str(d / "port.json")])
    return d


def test_demo_checkpoints_match_the_reference(demo_checkpoints):
    ref = json.loads((demo_checkpoints / "ref.json").read_text())
    got = json.loads((demo_checkpoints / "port.json").read_text())
    for key in STATE:
        assert got[key] == ref[key], key
    assert len(got["rankdb"]) == 8
    assert got["desired_flows"]["rows"] and got["fdb"]
    # the demo's balanced window is utilization-keyed: the memo
    # serializes its header only
    assert got["route_cache"]["topology_digest"] == got["desired_flows"]["topology_digest"]
    # the audit and traffic sections are written by both packages; the
    # hier border rows by neither without --hier-oracle
    assert got["audit_baselines"]["topology_digest"] == got["route_cache"]["topology_digest"]
    assert got["traffic_plane"]["mode"] == "edge"
    assert got["hier_border"] is ref["hier_border"] is None


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_demo_checkpoint_restores_across_packages(demo_checkpoints, writer):
    """``--restore`` of each package's checkpoint into both launchers,
    then ``--checkpoint`` again. The two restores write the same state;
    the topology, ranks and collectives are the ones saved, and the
    re-routed unicast pairs are the pairs saved (restore re-routes them
    against the live fabric, as the reference does)."""
    src = demo_checkpoints / f"{writer}.json"
    restored = {}
    for reader in (ref_launch, port_launch):
        out = demo_checkpoints / f"{writer}-into-{reader.__name__}.json"
        _run(reader, ["--topo", "fattree:4", "--no-rpc", "--duration", "0.1",
                      "--restore", str(src), "--checkpoint", str(out)])
        restored[reader] = json.loads(out.read_text())
    saved = json.loads(src.read_text())
    got, ref = restored[port_launch], restored[ref_launch]
    for key in STATE:
        assert got[key] == ref[key], key
    for key in ("topology", "rankdb", "collectives"):
        assert got[key] == saved[key], key

    def pairs(snap):
        return {p for table in snap["fdb"].values() for p in table}

    assert pairs(got) == pairs(saved)


@pytest.mark.parametrize("argv", [
    ["--ownership", "2/2"], ["--ownership", "x"], ["--ownership", "0/0"],
    ["--slo-target", "victim"], ["--slo-target", "t:50:1.5"],
], ids=lambda a: " ".join(a))
def test_malformed_plane_flags_fail_as_the_reference(argv):
    """A malformed ``--ownership`` or ``--slo-target`` fails the launch
    with the reference's message."""
    msgs = []
    for mod, side in ((ref_launch, ["--backend", "jax"]), (port_launch, ["--device", "cpu"])):
        with pytest.raises(SystemExit) as exc:
            mod.config_from_args(mod.build_parser().parse_args(argv + side))
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]
