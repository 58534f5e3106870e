"""One process of the two-process shard meshes of
``tests/test_torch_multiprocess.py``.

Imports torch and the port only (never ``jax`` or ``sdnmpi_tpu``), so a
spawned process starts quickly. :func:`serve` joins a ``gloo`` group of
``world`` processes and runs the named scenarios it is sent, one after
another, as every process of the group does: each returns numpy arrays
and plain values, which the test holds against the port's
single-process mesh and the JAX package's.
"""

from __future__ import annotations

import logging
import os
import tempfile
import traceback

import numpy as np

N_SHARDS = 8
PAD = 8
#: the group's port (set by serve)
PORT = [0]


def fabric():
    from sdnmpi_tpu_torch.topogen import fattree

    return fattree(4)


def chase_batch(t, seed: int = 0, n: int = 48, n_pad: int = 5):
    """A seeded batch of ``n`` flows (the last ``n_pad`` are ``-1``
    pads, the first has src == dst) with final ports, and its hop
    budget, on tensors ``t`` whose host distances are ``dist``."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, t.n_real, n).astype(np.int32)
    dst = rng.integers(0, t.n_real, n).astype(np.int32)
    dst[0] = src[0]
    src[-n_pad:] = -1
    dst[-n_pad:] = -1
    fport = rng.integers(1, 9, n).astype(np.int32)
    return src, dst, fport


def collective_problem(t, dist: np.ndarray) -> dict:
    """The alltoall of fat-tree k=4's hosts, aggregated to edge-switch
    pairs and end-padded to the shard count, on an idle fabric (as
    ``tests/test_torch_shardplane.py`` builds it)."""
    spec = fabric()
    host_edge = np.array([t.index[d] for _, d, _ in spec.hosts], np.int32)
    edges, counts = np.unique(host_edge, return_counts=True)
    ga, gb = np.meshgrid(edges, edges, indexing="ij")
    wa, wb = np.meshgrid(counts, counts, indexing="ij")
    off = ga != gb
    src, dst = ga[off].astype(np.int32), gb[off].astype(np.int32)
    weight = (wa[off] * wb[off]).astype(np.float32)
    pad = (-len(src)) % N_SHARDS
    src = np.concatenate([src, np.full(pad, -1, np.int32)])
    dst = np.concatenate([dst, np.full(pad, -1, np.int32)])
    adj = t.host_adj()
    v = adj.shape[0]
    li, lj = (a.astype(np.int32) for a in np.nonzero(adj > 0))
    traffic = np.zeros((v, v), np.float32)
    live = src >= 0
    np.add.at(traffic, (dst[live], src[live]), weight[: live.sum()])
    levels = int(dist[np.isfinite(dist)].max())
    return dict(adj=adj, li=li, lj=lj, util=np.zeros(len(li), np.float32),
                traffic=traffic, src=src, dst=dst, levels=levels)


def collective_modes():
    """(ring, cached, restrict) cases of the sharded collective."""
    return [(False, True, True), (False, False, False), (True, True, False),
            (True, False, True)]


def run_collectives(mesh, t, dist: np.ndarray) -> list:
    """``route_collective_sharded`` in every mode of
    :func:`collective_modes`: the slots of every shard on this host and
    the fractional max congestion."""
    import torch

    from sdnmpi_tpu_torch.convert import shard_rows
    from sdnmpi_tpu_torch.oracle.dag import make_dst_nodes
    from sdnmpi_tpu_torch.shardplane import route_collective_sharded
    from sdnmpi_tpu_torch.shardplane.mesh import gather_host

    p = collective_problem(t, dist)
    kw = dict(levels=p["levels"], rounds=2, max_len=p["levels"] + 1, salt=3)
    dn = make_dst_nodes(p["dst"][p["src"] >= 0])
    args = [torch.as_tensor(p[k]) for k in ("adj", "li", "lj", "util", "traffic",
                                           "src", "dst")]
    out = []
    for ring, cached, restrict in collective_modes():
        if cached:
            d = shard_rows(dist, mesh) if ring else torch.as_tensor(dist)
        else:
            d = None
        slots, maxc = route_collective_sharded(
            *args, mesh, dist=d, dst_nodes=torch.as_tensor(dn) if restrict else None,
            ring_exchange=ring, **kw)
        out.append((gather_host(slots, mesh), float(maxc)))
    return out


def sharded_db(ring: bool):
    """The port's TopologyDB on fat-tree k=4 with an 8-shard mesh and
    ``shard_oracle`` on the CPU, its device chase forced."""
    db = fabric().to_topology_db(backend="torch", device="cpu", pad_multiple=PAD,
                                 mesh_devices=N_SHARDS, shard_oracle=True,
                                 ring_exchange=ring)
    db._oracle_engine().host_chase_hop_budget = 0
    return db


def window(wr) -> tuple:
    touched = None if wr.touched is None else wr.touched.tolist()
    return wr.hop_dpid.tolist(), wr.hop_port.tolist(), wr.hop_len.tolist(), touched


def collective(c) -> tuple:
    return (c.pair_sub.tolist(), c.hop_dpid.tolist(), c.hop_port.tolist(),
            c.hop_len.tolist(), c.max_congestion, c.n_detours)


def run_engine(db) -> dict:
    """Windows (and a narrowed re-route after a flap), the shortest and
    balanced collectives and the host twins of ``db``."""
    from sdnmpi_tpu_torch.core.topology_db import Link, Port

    macs = sorted(db.hosts)
    pairs = [(a, b) for a in macs[:10] for b in macs[:10] if a != b]
    out = {"window": window(db.find_routes_batch_dispatch(pairs).reap())}
    out["fdbs"] = db.find_routes_batch(pairs)
    warm = db.warm_serving()
    out["warm"] = (warm["shapes"], warm["max_len"])
    n = len(macs)
    src, dst = np.arange(n), np.roll(np.arange(n), 3)
    for policy in ("shortest", "balanced"):
        out[policy] = collective(db.find_routes_collective(macs, src, dst, policy=policy))
    oracle = db._oracle_engine()
    out["dist"], out["next"] = oracle._dist.copy(), oracle._next.copy()
    link = next(iter(db.links[min(db.links)].values()))
    a, pa, b, pb = link.src.dpid, link.src.port_no, link.dst.dpid, link.dst.port_no
    db.delete_link(Link(Port(a, pa), Port(b, pb)))
    out["delta"] = window(db.find_routes_batch_delta_dispatch(pairs * 3, [a, b]).reap())
    return out


# -- the scenarios ------------------------------------------------------------


def scenario_mesh() -> dict:
    from sdnmpi_tpu_torch.control.ownership import mesh_replica_index
    from sdnmpi_tpu_torch.shardplane import mesh as pmesh

    m = pmesh.make_multihost_mesh(N_SHARDS, device="cpu")
    return dict(
        rank=m.rank, local=m.local, processes=[s.process_index for s in m.shards],
        ring=m.ring, shape=m.shape, axes=pmesh.mesh_axes(m),
        n_processes=pmesh.mesh_processes(m), multiprocess=m.multiprocess,
        devices=[None if d is None else str(d) for d in m.devices],
        order=[(s.process_index, s.id) for s in pmesh.device_ring_order(
            reversed(m.shards))],
        replica=mesh_replica_index(2), init_again=pmesh.init_multihost("h:1", 2, m.rank),
    )


def scenario_ring() -> dict:
    """K3 and its step form through their wrappers on the CPU: every
    wire dtype, held against the whole matrix in the test."""
    import torch

    from sdnmpi_tpu_torch.convert import shard_rows
    from sdnmpi_tpu_torch.kernels import ring
    from sdnmpi_tpu_torch.shardplane import mesh as pmesh

    m = pmesh.make_multihost_mesh(N_SHARDS, device="cpu")
    rng = np.random.default_rng(7)
    out = {}
    for name, dtype in (("bf16", torch.bfloat16), ("int16", torch.int16),
                        ("int32", torch.int32)):
        full = rng.integers(-300, 300, (48, 5))
        blocks = [None if b is None else b.to(dtype) for b in shard_rows(full, m)]
        got = ring.ring_all_gather(blocks, m)
        ex = ring.RingExchange(blocks, m)
        ex.join()
        seen = ring.ring_stream(m, blocks, lambda c, blk, src, t: c + [(src, t)],
                                [[] for _ in range(N_SHARDS)])
        out[name] = dict(
            gather=[None if g is None else g.float().numpy() for g in got],
            views=[ex.view(q).float().numpy() for q in m.local],
            seen=[seen[q] for q in m.local],
        )
    dist = rng.integers(0, 5, (48, 48)).astype(np.float32)
    dist[rng.random((48, 48)) < 0.1] = np.inf
    got = ring.exchange_distances(shard_rows(dist, m), m)
    out["dist"] = [g.numpy() for g in got if g is not None]
    try:
        ring.ring_all_gather(shard_rows(np.zeros((44, 3), np.int32), m), m)
        out["uneven"] = ""
    except ValueError as err:
        out["uneven"] = str(err)
    return out


def scenario_shardplane() -> dict:
    """The refresh's sharded distances and next hops (gather and ring)
    and both chases, straight from the shardplane."""
    import torch

    from sdnmpi_tpu_torch.convert import shard_rows
    from sdnmpi_tpu_torch.oracle.engine import tensorize
    from sdnmpi_tpu_torch import shardplane as pshard
    from sdnmpi_tpu_torch.shardplane.mesh import gather_host

    m = pshard.make_multihost_mesh(N_SHARDS, device="cpu")
    db = fabric().to_topology_db(backend="torch", device="cpu", pad_multiple=PAD)
    t = tensorize(db, pad_multiple=PAD, device="cpu")
    dist = pshard.apsp_distances_rowsharded(t.adj, m)
    out = dict(
        dist=gather_host(dist, m),
        next=gather_host(pshard.apsp_next_hops_rowsharded(t.adj, dist, m, t.max_degree), m),
        next_ring=gather_host(pshard.apsp_next_hops_ringed(t.adj, dist, m, t.max_degree), m),
    )
    src, dst, fport = chase_batch(t)
    max_len = int(out["dist"][np.isfinite(out["dist"])].max()) + 1
    nxt = out["next"]
    for name, fn in (("sharded", pshard.batch_fdb_sharded), ("ringed", pshard.batch_fdb_ringed)):
        for form, next_hop in (("rows", shard_rows(nxt, m)), ("full", torch.as_tensor(nxt))):
            got = fn(next_hop, t.port, torch.as_tensor(src), torch.as_tensor(dst),
                     torch.as_tensor(fport), max_len, m)
            out[f"chase_{name}_{form}"] = [gather_host(x, m) for x in got]
    out["collectives"] = run_collectives(m, t, out["dist"])
    return out


def scenario_engine(ring: bool) -> dict:
    return run_engine(sharded_db(ring))


def scenario_later() -> dict:
    """The legs left for later, each given a multi-process mesh: the
    message each raises (NotImplementedError only)."""
    import torch

    from sdnmpi_tpu_torch import shardplane as pshard
    from sdnmpi_tpu_torch.oracle.engine import tensorize
    from sdnmpi_tpu_torch.shardplane import hier

    m = pshard.make_multihost_mesh(N_SHARDS, device="cpu")
    db = fabric().to_topology_db(backend="torch", device="cpu", pad_multiple=PAD)
    t = tensorize(db, pad_multiple=PAD, device="cpu")
    v = t.v
    f = torch.zeros(N_SHARDS, dtype=torch.int32)
    w = torch.zeros(N_SHARDS)
    zeros = torch.zeros((v, v))
    legs = {
        "route_flows_sharded": lambda: pshard.route_flows_sharded(
            t.adj, zeros, zeros, f, f, w, m, 4),
        "route_adaptive_sharded": lambda: pshard.route_adaptive_sharded(
            t.adj, zeros, f, f, w, 0, m, 3),
        "multichip_route_step": lambda: pshard.multichip_route_step(
            t.adj, zeros, f, f, w, m, 4),
        "apsp_distances_sharded": lambda: pshard.apsp_distances_sharded(t.adj, m),
        "pod_stack_apsp": lambda: hier.pod_stack_apsp(
            np.zeros((16, 4, 4), np.float32), m, device="cpu"),
        "sweep_rows_sharded": lambda: hier.sweep_rows_sharded([], 4, [0], m),
        "ring_exchange_border_plane": lambda: hier.ring_exchange_border_plane(
            type("State", (), {"mesh": m, "buckets": []})()),
    }
    out = {}
    for name, fn in legs.items():
        try:
            fn()
            out[name] = "ran"
        except NotImplementedError as err:
            out[name] = str(err)
    return out


def scenario_launch() -> dict:
    """``python -m sdnmpi_tpu_torch --distributed 127.0.0.1:PORT,2,RANK
    --device cpu --shard-oracle --demo`` in this process (its group is
    up already, so ``init_multihost`` is a no-op): the demo's log line
    and the checkpoint it writes."""
    import torch.distributed as dist

    spec = f"127.0.0.1:{PORT[0]},{dist.get_world_size()},{dist.get_rank()}"
    return dict(run_launch(["--distributed", spec]), spec=spec)


def run_launch(extra: list) -> dict:
    import json

    from sdnmpi_tpu_torch import launch

    lines = []

    class Keep(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        keep = Keep()
        logger = logging.getLogger("launch")
        level = logger.level
        logger.setLevel(logging.INFO)
        logger.addHandler(keep)
        try:
            launch.main(["--device", "cpu", "--topo", "fattree:4", "--demo",
                         "--demo-ranks", "16", "--mesh-devices", str(N_SHARDS),
                         "--shard-oracle", "--ring-exchange", "--no-rpc",
                         "--profile", "no-monitor", "--duration", "0.05",
                         "--checkpoint", "ck.json", *extra])
            with open("ck.json") as fh:
                ck = json.load(fh)
        finally:
            logger.removeHandler(keep)
            logger.setLevel(level)
            # main() configures logging as the launch profiles do: undo it
            for name in ("Monitor", None):
                logger = logging.getLogger(name)
                for h in list(logger.handlers):
                    logger.removeHandler(h)
                    h.close()
            os.chdir(cwd)
    demo = [x for x in lines if x.startswith("demo:")]
    return dict(demo=demo, checkpoint=ck)


SCENARIOS = {
    "mesh": scenario_mesh, "ring": scenario_ring, "shardplane": scenario_shardplane,
    "engine": scenario_engine, "later": scenario_later, "launch": scenario_launch,
}


def serve(rank: int, world: int, port: int, inbox, outbox, timeout_s: float) -> None:
    """Join the group of ``world`` processes at ``127.0.0.1:port`` as
    ``rank`` and run ``(name, kwargs)`` scenarios from ``inbox`` until
    ``None``, putting ``(rank, "ok" | "error", result | traceback)`` on
    ``outbox``."""
    import torch

    from sdnmpi_tpu_torch.kernels import ring
    from sdnmpi_tpu_torch.shardplane.mesh import init_multihost

    torch.set_num_threads(1)
    PORT[0] = port
    try:
        init_multihost(f"127.0.0.1:{port}", world, rank, timeout_s=timeout_s)
        while True:
            task = inbox.get()
            if task is None:
                break
            name, kw = task
            outbox.put((rank, "ok", SCENARIOS[name](**kw)))
        ring.close_exchanges()
    except BaseException:
        outbox.put((rank, "error", traceback.format_exc()))
        raise
