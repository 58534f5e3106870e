"""The port's fault injection (``control/faults.py``) and chaos outcomes
against the JAX package's.

A ``FaultPlan`` seeds one ``random.Random``, so one seed gives one fault
history: both packages' plans, attached to the same fat-tree, must give
the same verdicts, crashes, flaps and table mutations, and a controller
soaked under them (``tests/test_recovery.py``'s chaos soak) must end
with the same converged fabric, desired store and recovery counters.
``FaultProxy``, the byte-level TCP shim, forwards, holds and cuts a
stream as the reference's does.
"""

import asyncio
import importlib

import numpy as np
import pytest

from tests.test_torch_control import PORT, REF, announce, ip_packet

FAST_RECOVERY = dict(install_retry_backoff_s=0.0, barrier_timeout_s=0.0,
                     install_retry_max=3)
CHAOS = dict(p_send_drop=0.08, p_send_stall=0.05, p_send_truncate=0.04,
             p_ack_drop=0.05, p_stats_delay=0.15, p_crash=0.06, p_redial=0.4,
             p_flap=0.10, p_restore=0.5, p_release=0.5, max_crashed=3)


def mod(S, name):
    pkg = "sdnmpi_tpu" if S is REF else "sdnmpi_tpu_torch"
    return importlib.import_module(f"{pkg}.{name}")


@pytest.fixture(autouse=True)
def _registries():
    for S in (REF, PORT):
        mod(S, "utils.metrics").REGISTRY.reset()
    yield
    for S in (REF, PORT):
        mod(S, "utils.metrics").REGISTRY.reset()


@pytest.mark.parametrize("seed", [0, 11])
def test_fault_plan_history_matches_the_reference(seed):
    """Verdicts of the send, ack and stats hooks interleaved with the
    scenario steps (crashes, redials, flaps, restores, mutations), on
    bare fabrics: the same history and the same fabric afterwards."""
    def history(S):
        fabric = S.topogen.fattree(4).to_fabric(wire=True)
        plan = mod(S, "control.faults").FaultPlan(
            seed=seed, p_mutate=0.3, **CHAOS).attach(fabric)
        out = []
        for step in range(40):
            plan.step()
            for d in sorted(fabric.switches)[:6]:
                out.append((plan.send_fault(d), plan.ack_fault(d),
                            plan.stats_fault(d)))
            out.append(sorted(fabric.switches))
        plan.quiesce()
        return out, dict(plan.counts), list(plan.mutations), sorted(fabric.switches)

    ref, got = history(REF), history(PORT)
    assert got == ref
    assert got[1]["crash"] > 0 and got[1]["flap"] > 0


def _chaos_soak(S, steps, seed, backend):
    spec = S.topogen.fattree(4)
    fabric = spec.to_fabric(wire=True)
    kw = dict(proactive_collectives=False, coalesce_routes=True, **FAST_RECOVERY)
    if backend == "py":
        kw["oracle_backend"] = "py"
    elif S is REF:
        kw["oracle_backend"] = "jax"
    else:
        kw["device"] = "cpu"
    ctl = S.Controller(fabric, S.Config(**kw))
    ctl.attach()
    macs = [S.topogen.host_mac(r) for r in range(8)]
    for rank, mac in enumerate(macs):
        announce(S, fabric, mac, "LAUNCH", rank)
    plan = mod(S, "control.faults").FaultPlan(seed=seed, **CHAOS).attach(fabric)
    rng = np.random.default_rng(seed)
    hosts = sorted(fabric.hosts)
    for step in range(steps):
        plan.step()
        for _ in range(3):
            a, b = rng.choice(len(hosts), size=2, replace=False)
            ha, hb = fabric.hosts[hosts[a]], fabric.hosts[hosts[b]]
            if ha.dpid in fabric.switches and hb.dpid in fabric.switches:
                ha.send(ip_packet(S, hosts[a], hosts[b]))
        if step % 7 == 0:
            s, d = int(rng.integers(0, 8)), int(rng.integers(0, 8))
            if s != d and fabric.hosts[macs[s]].dpid in fabric.switches:
                fabric.hosts[macs[s]].send(ip_packet(
                    S, macs[s], S.VirtualMac(S.CollectiveType.P2P, s, d).encode()))
        ctl.monitor.poll(now=float(step))
        fabric.tick(float(step))
    plan.quiesce()
    for k in range(1 + int(ctl.config.install_retry_max) * 2):
        fabric.release_stalls()
        ctl.monitor.poll(now=float(steps + k))
    installed = sorted(
        (d, e.match.dl_src, e.match.dl_dst, repr(e.actions), e.priority)
        for d, sw in fabric.switches.items() for e in sw.flow_table
        if e.match.dl_src is not None)
    desired = sorted(
        (d, s, t, spec_.out_port, spec_.rewrite)
        for d, tab in ctl.router.recovery.desired.flows.items()
        for (s, t), spec_ in tab.items())
    snap = ctl.telemetry()
    counters = {k: v for k, v in snap["counters"].items() if k.startswith(
        ("reconcile_", "install_", "barrier_", "recovery_", "audit_", "fabric_"))}
    text = mod(S, "api.telemetry").render(snap)
    return {
        "installed": installed, "desired": desired,
        "converged": {r[:3] for r in installed} == {r[:3] for r in desired},
        "plan": dict(plan.counts), "counters": counters,
        "exposed": sorted(n for n in counters if n.split("{")[0] in text),
    }


@pytest.mark.parametrize("seed,backend,steps", [(23, "py", 60), (5, "device", 40)])
def test_chaos_soak_matches_the_reference(seed, backend, steps):
    """Seeded steps of crashes, flaps, drops, stalls, truncations and
    lost acks, then quiesce: both controllers converge to the same
    fabric, equal to their desired stores, with the same counters in
    the snapshot and the Prometheus text."""
    ref = _chaos_soak(REF, steps, seed, backend)
    got = _chaos_soak(PORT, steps, seed, backend)
    assert got == ref
    assert got["converged"] and got["plan"]["crash"] > 0
    assert got["counters"]["reconcile_flows_total"] > 0
    assert got["exposed"] == sorted(got["counters"])


async def _proxy_run(S):
    """An echo server behind the proxy: forward, freeze (bytes held),
    thaw (held bytes delivered), then cut."""
    async def echo(reader, writer):
        while data := await reader.read(65536):
            writer.write(data)
            await writer.drain()
        writer.close()

    server = await asyncio.start_server(echo, "127.0.0.1", 0)
    proxy = mod(S, "control.faults").FaultProxy(
        upstream_port=server.sockets[0].getsockname()[1])
    port = await proxy.serve()
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    got = []
    writer.write(b"hello")
    await writer.drain()
    got.append(await asyncio.wait_for(reader.readexactly(5), 5))
    proxy.freeze()
    writer.write(b"held")
    await writer.drain()
    await asyncio.sleep(0.1)
    got.append((proxy.bytes_to_controller, len(proxy._held)))
    await proxy.thaw()
    got.append(await asyncio.wait_for(reader.readexactly(4), 5))
    proxy.cut()
    got.append(await asyncio.wait_for(reader.read(10), 5))
    writer.close()
    await proxy.close()
    server.close()
    await server.wait_closed()
    return got, proxy.bytes_to_switch


def test_fault_proxy_forwards_holds_and_cuts_as_the_reference():
    ref, got = asyncio.run(_proxy_run(REF)), asyncio.run(_proxy_run(PORT))
    assert got == ref
    assert got[0][0] == b"hello" and got[0][2] == b"held" and got[0][3] == b""
