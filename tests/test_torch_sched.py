"""The port's phase scheduler against the JAX package's.

The packer (``sched/phases.py``: the torch loop on the oracle's device,
run here on the CPU, and its numpy twin) must assign every traffic
group the reference's phase, bit for bit, across shapes, phase counts
and background loads. The phased programs of both packages must
partition the pairs alike and route each phase alike, on the torch and
pure-Python backends and with the utilization plane's per-switch
background; and a controller of each package with
``schedule_collectives`` on must install the same phases, flow tables,
desired rows and bus events. The cases are those of
``tests/test_sched.py`` at fat-tree k=4.
"""

import numpy as np
import pytest

from sdnmpi_tpu import sched as j_sched
from sdnmpi_tpu.sched.phases import aggregate_groups as j_aggregate
from sdnmpi_tpu_torch import sched as p_sched
from sdnmpi_tpu_torch.sched.phases import aggregate_groups as p_aggregate
from sdnmpi_tpu_torch.sched.program import PhasedFlowProgram
from tests.test_torch_control import PORT, REF, make_config, state

N_RANKS = 8
FAST_RECOVERY = dict(install_retry_backoff_s=0.0, barrier_timeout_s=0.0,
                     install_retry_max=3)


def alltoall_idx(n: int):
    src, dst = np.nonzero(~np.eye(n, dtype=bool))
    return src.astype(np.int32), dst.astype(np.int32)


def _dbs(backend="torch", k=4):
    from sdnmpi_tpu.topogen import fattree as j_fattree
    from sdnmpi_tpu_torch.topogen import fattree as p_fattree

    spec = p_fattree(k)
    kw = {"device": "cpu"} if backend == "torch" else {}
    ref = j_fattree(k).to_topology_db(backend="jax" if backend == "torch" else "py")
    return spec, ref, spec.to_topology_db(backend=backend, **kw)


def _routes_equal(a, b):
    for f in ("pair_sub", "final_port", "hop_dpid", "hop_port", "hop_len"):
        np.testing.assert_array_equal(np.asarray(getattr(a, f)), np.asarray(getattr(b, f)))
    assert a.max_congestion == b.max_congestion


def _programs_equal(got, want):
    assert isinstance(got, PhasedFlowProgram)
    assert got.n_phases == want.n_phases
    np.testing.assert_array_equal(got.pair_phase, want.pair_phase)
    assert [p.phase for p in got.phases] == [p.phase for p in want.phases]
    for pg, pw in zip(got.phases, want.phases):
        np.testing.assert_array_equal(pg.pair_idx, pw.pair_idx)
        _routes_equal(pg.reap(), pw.reap())
    assert got.phase_congestion() == want.phase_congestion()


# -- the packer ----------------------------------------------------------------


@pytest.mark.parametrize("g,v,k", [(1, 4, 2), (5, 8, 2), (37, 20, 4), (200, 64, 8),
                                   (63, 16, 4), (64, 16, 4), (65, 16, 4)])
def test_packer_matches_reference(g, v, k):
    """The torch packer, its numpy twin, the reference's jitted scan and
    the reference's twin agree on every assignment (same f32 sums, the
    heaviest-first order, the lowest phase on ties)."""
    rng = np.random.default_rng(7 + g)
    s = rng.integers(0, v, g).astype(np.int32)
    d = rng.integers(0, v, g).astype(np.int32)
    w = (rng.random(g) * 10).astype(np.float32)
    w[: g // 3] = np.float32(2.5)  # equal weights: the stable order decides
    uo = rng.random(v).astype(np.float32)
    ui = rng.random(v).astype(np.float32)
    dev = p_sched.pack_phases(s, d, w, k, v, uo, ui, device="cpu")
    host = p_sched.pack_phases(s, d, w, k, v, uo, ui, device=None)
    want = j_sched.pack_phases(s, d, w, k, v, uo, ui, device=True)
    np.testing.assert_array_equal(dev, host)
    np.testing.assert_array_equal(dev, want)
    np.testing.assert_array_equal(host, j_sched.pack_phases(s, d, w, k, v, uo, ui,
                                                            device=False))
    assert dev.min() >= 0 and dev.max() < k


def test_packer_takes_device_background_tensors():
    """The background loads may be tensors (a plane's base reduced on the
    device); a hot destination steers the packing as in the reference."""
    import torch

    s = np.zeros(8, np.int32)
    d = np.arange(8, dtype=np.int32)
    w = np.ones(8, np.float32)
    hot_in = np.zeros(8, np.float32)
    hot_in[3] = 100.0
    got = p_sched.pack_phases(s, d, w, 4, 8, torch.zeros(8), torch.from_numpy(hot_in),
                              device="cpu")
    np.testing.assert_array_equal(
        got, j_sched.pack_phases(s, d, w, 4, 8, util_in=hot_in, device=False))
    idle = p_sched.pack_phases(s, d, w, 4, 8, device=None)
    counts = np.bincount(idle, minlength=4)
    assert counts.max() - counts.min() <= 1


def test_packer_empty_and_dead_rows():
    from sdnmpi_tpu_torch.sched.phases import _pack_greedy_device

    import torch

    empty = np.empty(0, np.int32)
    assert len(p_sched.pack_phases(empty, empty, np.empty(0, np.float32), 4, 8,
                                   device="cpu")) == 0
    dead = np.array([-1, -1], np.int32)
    host = p_sched.pack_phases_host(dead, dead, np.ones(2, np.float32),
                                    np.zeros(4, np.float32), np.zeros(4, np.float32), 2)
    dev = _pack_greedy_device(torch.tensor([-1, 1]), torch.tensor([-1, 2]),
                              torch.ones(2), torch.zeros(4), torch.zeros(4), 2)
    assert (host == -1).all() and dev.tolist() == [-1, 0]


def test_choose_n_phases_and_aggregate_match_reference():
    for n_groups in (0, 6, 7, 8, 50):
        for requested in (0, 1, 3, 4, 5, 31, 32, 33, 10_000):
            assert p_sched.choose_n_phases(n_groups, requested) == (
                j_sched.choose_n_phases(n_groups, requested))
    assert p_sched.MAX_AUTO_PHASES == j_sched.MAX_AUTO_PHASES
    rng = np.random.default_rng(1)
    s = rng.integers(0, 12, 300).astype(np.int32)
    d = rng.integers(0, 12, 300).astype(np.int32)
    for got, want in zip(p_aggregate(s, d, 16), j_aggregate(s, d, 16)):
        np.testing.assert_array_equal(got, want)


# -- the program contract --------------------------------------------------------


@pytest.mark.parametrize("backend", ["torch", "py"])
def test_phases_partition_pairs(backend):
    spec, ref, got = _dbs(backend)
    macs = sorted(m for m, _, _ in spec.hosts)[:N_RANKS]
    src, dst = alltoall_idx(N_RANKS)
    prog = got.find_routes_collective_phased(macs, src, dst, policy="shortest")
    want = ref.find_routes_collective_phased(macs, src, dst, policy="shortest")
    assert prog.n_phases == 4 and prog.n_pairs == len(src)
    assert (prog.pair_phase >= 0).all()
    parts = np.sort(np.concatenate([p.pair_idx for p in prog.phases]))
    np.testing.assert_array_equal(parts, np.arange(len(src)))
    for plan in prog.phases:
        assert (prog.pair_phase[plan.pair_idx] == plan.phase).all()
        assert plan.reap().n_pairs == plan.n_pairs
    _programs_equal(prog, want)


@pytest.mark.parametrize("backend", ["torch", "py"])
def test_unresolved_endpoints_in_no_phase(backend):
    spec, ref, got = _dbs(backend)
    macs = sorted(m for m, _, _ in spec.hosts)[:4]
    macs[2] = "aa:bb:cc:dd:ee:ff"
    src = np.array([0, 1, 2, 3], np.int32)
    dst = np.array([1, 2, 3, 0], np.int32)
    prog = got.find_routes_collective_phased(macs, src, dst, policy="shortest")
    assert (prog.pair_phase[[1, 2]] == -1).all() and (prog.pair_phase[[0, 3]] >= 0).all()
    _programs_equal(prog, ref.find_routes_collective_phased(macs, src, dst,
                                                            policy="shortest"))


@pytest.mark.parametrize("skewed", [False, True])
def test_torch_and_py_agree_on_grouping(skewed):
    """The device packer and the py backend's host twin derive the same
    pair -> phase map, also with heavy same-switch groups (zero pack
    weight: they claim no budget)."""
    spec, _, got = _dbs()
    py = spec.to_topology_db(backend="py")
    macs = sorted(m for m, _, _ in spec.hosts)[:N_RANKS]
    if skewed:
        src = np.array([0] * 20 + [0, 2, 1, 3], np.int32)
        dst = np.array([1] * 20 + [4, 5, 6, 7], np.int32)
    else:
        src, dst = alltoall_idx(N_RANKS)
    progs = [db.find_routes_collective_phased(macs, src, dst, policy="shortest")
             for db in (got, py)]
    assert progs[0].n_phases == progs[1].n_phases
    np.testing.assert_array_equal(progs[0].pair_phase, progs[1].pair_phase)
    if skewed:
        ph = progs[0].pair_phase
        assert ph[20] != ph[21] and ph[22] != ph[23]


@pytest.mark.parametrize("n_phases", [0, 1, 2, 8])
@pytest.mark.parametrize("policy", ["balanced", "shortest", "adaptive"])
def test_program_matches_reference(policy, n_phases):
    """The whole program, every phase's routes included: the balanced
    phases through the phase-grain scanner (chunk 1, exact member deal),
    the others as their flat batches; the full alltoall of fat-tree k=4."""
    spec, ref, got = _dbs()
    macs = sorted(m for m, _, _ in spec.hosts)
    src, dst = alltoall_idx(len(macs))
    prog = got._oracle_engine().routes_collective_phased(
        got, macs, src, dst, policy, n_phases=n_phases)
    want = ref._jax_oracle().routes_collective_phased(
        ref, macs, src, dst, policy, n_phases=n_phases)
    _programs_equal(prog, want)
    assert prog.total_discrete_congestion() == want.total_discrete_congestion()
    assert prog.max_phase_congestion() == want.max_phase_congestion()


def test_plane_seeded_packing_matches_reference():
    """Measured load from the utilization plane enters the packer as the
    per-switch sums of the base (reduced on the device): the same phases
    and routes as the reference's plane-seeded program."""
    from sdnmpi_tpu.oracle.utilplane import UtilPlane as JPlane
    from sdnmpi_tpu_torch.oracle.utilplane import UtilPlane as PPlane

    spec, ref, got = _dbs()
    rng = np.random.default_rng(5)
    planes = (JPlane(), PPlane())
    for a in sorted(got.links):
        for b in sorted(got.links[a]):
            lk = got.links[a][b]
            bps = float(rng.random() * 8e9) if rng.random() < 0.3 else 0.0
            for plane in planes:
                plane.stage((a, lk.src.port_no), bps)
    macs = sorted(m for m, _, _ in spec.hosts)
    src, dst = alltoall_idx(len(macs))
    prog = got._oracle_engine().routes_collective_phased(
        got, macs, src, dst, "balanced", link_util=planes[1])
    want = ref._jax_oracle().routes_collective_phased(
        ref, macs, src, dst, "balanced", link_util=planes[0])
    _programs_equal(prog, want)


def test_blocking_twin_matches_dispatch():
    spec, _, got = _dbs()
    macs = sorted(m for m, _, _ in spec.hosts)[:N_RANKS]
    src, dst = alltoall_idx(N_RANKS)
    oracle = got._oracle_engine()
    a = oracle.routes_collective(got, macs, src, dst, "balanced", schedule=0)
    b = oracle.routes_collective_phased(got, macs, src, dst, "balanced")
    _programs_equal(a, b)
    c = got.find_routes_collective(macs, src, dst, "balanced", schedule=0)
    _programs_equal(c, b)


def test_phase_batches_never_pair_with_the_flat_bound():
    """A program's per-phase batches leave the flat pass's congestion
    triple alone; a shortest pass clears the fractional pair."""
    from sdnmpi_tpu_torch.utils.metrics import REGISTRY

    spec, _, got = _dbs()
    macs = sorted(m for m, _, _ in spec.hosts)[:N_RANKS]
    src, dst = alltoall_idx(N_RANKS)
    oracle = got._oracle_engine()
    oracle.routes_collective(got, macs, src, dst, "balanced")
    triple = (oracle.last_discrete_congestion, oracle.last_fractional_congestion,
              oracle.last_congestion_ratio)
    assert all(x > 0 for x in triple)
    prog = oracle.routes_collective_phased(got, macs, src, dst, "balanced")
    assert prog.total_discrete_congestion() > 0
    assert (oracle.last_discrete_congestion, oracle.last_fractional_congestion,
            oracle.last_congestion_ratio) == triple
    assert REGISTRY.get("congestion_fractional_max").value == triple[1]
    oracle.routes_collective(got, macs, src, dst, "shortest")
    assert oracle.last_fractional_congestion == oracle.last_congestion_ratio == 0.0


# -- the phased install through both controllers ------------------------------


def make_stack(S, wire=False, **config_kw):
    """fattree(4) fabric and controller with the block install at toy
    scale, ranks announced, every event recorded."""
    fabric = S.topogen.fattree(4).to_fabric(wire=wire)
    ctl = S.Controller(fabric, make_config(
        S, block_install_threshold=1, **{**FAST_RECOVERY, **config_kw}))
    events: list = []
    ctl.bus.tap(events.append)
    ctl.attach()
    macs = sorted(fabric.hosts)[:N_RANKS]
    for rank, mac in enumerate(macs):
        fabric.hosts[mac].send(S.of.Packet(
            eth_src=mac, eth_dst="ff:ff:ff:ff:ff:ff", eth_type=S.of.ETH_TYPE_IP,
            ip_proto=S.of.IPPROTO_UDP, udp_dst=61000,
            payload=S.Announcement(S.AnnouncementType.LAUNCH, rank).encode(),
        ))
    return fabric, ctl, events, macs


def kickoff(S, fabric, macs, src=0, dst=1):
    vmac = S.VirtualMac(S.CollectiveType.ALLTOALL, src, dst).encode()
    fabric.hosts[macs[src]].send(
        S.of.Packet(eth_src=macs[src], eth_dst=vmac, eth_type=S.of.ETH_TYPE_IP))


def installed_flows(fabric):
    return {(d, e.match.dl_src, e.match.dl_dst, repr(e.actions), e.priority)
            for d, sw in fabric.switches.items() for e in sw.flow_table
            if e.match.dl_src is not None}


def desired_flows(S, ctl):
    prio = ctl.config.priority_default
    out = set()
    for d, table in ctl.router.recovery.desired.flows.items():
        for (src, dst), spec in table.items():
            actions: tuple = (S.of.ActionOutput(spec.out_port),)
            if spec.rewrite:
                actions = (S.of.ActionSetDlDst(spec.rewrite),) + actions
            out.add((d, src, dst, repr(actions), prio))
    return out


def _scenario(S, wire, policy, reroute):
    fabric, ctl, events, macs = make_stack(
        S, wire=wire, collective_policy=policy, schedule_collectives=True)
    kickoff(S, fabric, macs)
    if reroute:
        cable = next(c for c in sorted(fabric.links) if not any(
            p.peer and p.peer[0] == "host"
            for p in fabric.switches[c[0]].ports.values()))
        fabric.remove_link(*cable)
    out = state(fabric, ctl, events)
    out["installed"] = sorted(installed_flows(fabric))
    out["desired_rows"] = sorted(desired_flows(S, ctl))
    return out


@pytest.mark.parametrize("reroute", [False, True], ids=["install", "reroute"])
@pytest.mark.parametrize("wire", [False, True], ids=["sim", "wire"])
@pytest.mark.parametrize("policy", ["balanced", "shortest"])
def test_scheduled_install_matches_reference(policy, wire, reroute):
    """Kickoff of an 8-rank alltoall with ``schedule_collectives``: the
    phases install (and, after a link failure, re-install phased) with
    the reference's flow tables, desired rows, collective table and
    every bus event, phase events included; installed == desired."""
    ref = _scenario(REF, wire, policy, reroute)
    got = _scenario(PORT, wire, policy, reroute)
    assert got.keys() == ref.keys()
    for key in ref:
        assert got[key] == ref[key], key
    assert got["installed"] == got["desired_rows"]
    phases = [e for e in got["events"] if e[0] == "EventCollectivePhaseInstalled"]
    assert phases and got["collectives"][0][-1] > 0  # n_phases


@pytest.mark.parametrize("wire", [False, True], ids=["sim", "wire"])
def test_shortest_phased_tables_equal_flat_expansion(wire):
    """Shortest phases route as their flat batch: the phased tables are
    the member x hop expansion of the flat routes, bit for bit."""
    fabric, ctl, _, macs = make_stack(PORT, wire=wire, collective_policy="shortest",
                                      schedule_collectives=True)
    kickoff(PORT, fabric, macs)
    install = next(iter(ctl.router.collectives))
    flat = ctl.bus.request(PORT.ev.FindCollectiveRoutesRequest(
        install.macs, install.src_idx, install.dst_idx, policy="shortest")).routes
    prio = ctl.config.priority_default
    expected = set()
    for k in range(flat.n_pairs):
        fdb = flat.fdb(k)
        si, di = int(install.src_idx[k]), int(install.dst_idx[k])
        vmac = PORT.VirtualMac(PORT.CollectiveType.ALLTOALL, si, di).encode()
        for h, (dpid, port) in enumerate(fdb):
            actions: tuple = (PORT.of.ActionOutput(port),)
            if h == len(fdb) - 1:
                actions = (PORT.of.ActionSetDlDst(install.macs[di]),) + actions
            expected.add((dpid, install.macs[si], vmac, repr(actions), prio))
    assert expected and installed_flows(fabric) == expected
    assert desired_flows(PORT, ctl) == expected


def test_schedule_off_stays_flat():
    fabric, ctl, events, macs = make_stack(PORT)
    kickoff(PORT, fabric, macs)
    assert not [e for e in events if type(e).__name__ == "EventCollectivePhaseInstalled"]
    install = next(iter(ctl.router.collectives))
    assert install.n_phases == 0 and install.phase_rows is None
    assert not [s for t in ctl.router.recovery.desired.flows.values()
                for s in t.values() if s.collective]


def test_phase_events_ascend_and_table_records_program():
    from sdnmpi_tpu_torch.utils.metrics import REGISTRY

    fabric, ctl, events, macs = make_stack(PORT, schedule_collectives=True)
    kickoff(PORT, fabric, macs)
    phases = [e for e in events if type(e).__name__ == "EventCollectivePhaseInstalled"]
    installed = [e for e in events if type(e).__name__ == "EventCollectiveInstalled"]
    assert len(installed) == 1 and phases
    assert [e.phase for e in phases] == sorted(e.phase for e in phases)
    assert sum(e.n_pairs for e in phases) == installed[0].n_pairs
    assert sum(e.n_flows for e in phases) == installed[0].n_flows
    install = next(iter(ctl.router.collectives))
    assert [p for p, _ in install.phase_rows] == [e.phase for e in phases]
    assert ctl.router.recovery.desired.total() == sum(
        len(rows) for _, rows in install.phase_rows)
    assert REGISTRY.get("sched_programs_total").value >= 1


def test_py_backend_phased_install():
    """The pure-Python backend's phased leg (the host-twin packer, the
    scalar oracle per phase) installs as the reference's py backend."""
    ref = _scenario_py(REF)
    got = _scenario_py(PORT)
    assert got == ref and got[0] > 0


def _scenario_py(S):
    fabric = S.topogen.fattree(4).to_fabric()
    ctl = S.Controller(fabric, S.Config(
        oracle_backend="py", block_install_threshold=1, schedule_collectives=True,
        **FAST_RECOVERY))
    ctl.attach()
    macs = sorted(fabric.hosts)[:N_RANKS]
    for rank, mac in enumerate(macs):
        fabric.hosts[mac].send(S.of.Packet(
            eth_src=mac, eth_dst="ff:ff:ff:ff:ff:ff", eth_type=S.of.ETH_TYPE_IP,
            ip_proto=S.of.IPPROTO_UDP, udp_dst=61000,
            payload=S.Announcement(S.AnnouncementType.LAUNCH, rank).encode(),
        ))
    kickoff(S, fabric, macs)
    install = next(iter(ctl.router.collectives))
    assert installed_flows(fabric) == desired_flows(S, ctl)
    return install.n_phases, sorted(installed_flows(fabric))


def test_launcher_schedule_phases_installs(monkeypatch):
    """``--schedule-phases K`` launches, turns the scheduler on with K,
    and the demo's collective installs phase by phase (the block
    threshold lowered so the toy demo takes it)."""
    import asyncio
    import dataclasses

    from sdnmpi_tpu_torch import launch

    argv = ["--device", "cpu", "--no-rpc", "--topo", "fattree:4", "--demo",
            "--demo-ranks", "8", "--duration", "0.05", "--schedule-phases", "2"]
    args = launch.build_parser().parse_args(argv)
    config = launch.config_from_args(args)
    assert config.schedule_collectives and config.schedule_phases == 2
    assert config.delta_reval and config.util_plane
    to_config, run_demo = launch.config_from_args, launch.run_demo
    seen = []
    monkeypatch.setattr(launch, "config_from_args", lambda a: dataclasses.replace(
        to_config(a), block_install_threshold=1))

    def demo(controller, fabric, n):
        run_demo(controller, fabric, n)
        seen.append(controller)

    monkeypatch.setattr(launch, "run_demo", demo)
    asyncio.run(launch.amain(args))
    install = next(iter(seen[0].router.collectives))
    assert install.n_phases == 2
