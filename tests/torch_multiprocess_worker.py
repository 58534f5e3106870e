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


def balance_problem(adj: np.ndarray, n_real: int, seed: int = 3, n: int = 64,
                    fractional: bool = False) -> dict:
    """A seeded flow batch for the greedy balancer on ``adj``: ``n``
    flows with integer weights, or fractional ones of several magnitudes
    (whose sums depend on their order), the last three dead pads, and an
    integer base cost on the links."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_real, n).astype(np.int32)
    dst = rng.integers(0, n_real, n).astype(np.int32)
    src[-3:] = -1
    dst[-3:] = -1
    weight = (rng.uniform(0.1, 3.0, n) * 10.0 ** rng.integers(-3, 4, n) if fractional
              else rng.integers(1, 4, n)).astype(np.float32)
    weight[-3:] = 0
    v = adj.shape[0]
    base = np.where(adj > 0, rng.integers(0, 3, (v, v)), 0).astype(np.float32)
    return dict(src=src, dst=dst, weight=weight, base=base)


def ugal_problem(adj: np.ndarray, n_real: int, seed: int = 1, n: int = 64,
                 fractional: bool = False) -> dict:
    """``tests/test_torch_shard_legs.py``'s UGAL problem on dragonfly(4, 4):
    flows toward the next group, whose links are hot, so that some
    detour; integer weights, or fractional ones of several magnitudes,
    the last three flows dead pads."""
    v = adj.shape[0]
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_real, n).astype(np.int32)
    dst = ((((src // 4) + 1) % 4) * 4 + rng.integers(0, 4, n)).astype(np.int32)
    src[-3:] = -1
    dst[-3:] = -1
    w = (rng.uniform(0.1, 3.0, n) * 10.0 ** rng.integers(-3, 4, n) if fractional
         else rng.integers(1, 4, n)).astype(np.float32)
    groups = np.arange(v) // 4
    util = np.zeros((v, v), np.float32)
    util[(groups[None, :] == (groups[:, None] + 1) % 4) & (adj > 0)] = 50.0
    return dict(src=src, dst=dst, weight=w, util=util)


def psum_parts(dtype, seed: int = 11, shape=(6, 7)) -> list:
    """One part a shard for the psum, alike in every process: values
    spread over 16 decades, so that their sum depends on its order (in
    float64 too)."""
    import torch

    rng = np.random.default_rng(seed)
    shape = (N_SHARDS, *shape)
    vals = rng.uniform(1.0, 2.0, shape) * 10.0 ** rng.integers(-8, 8, shape)
    return list(torch.as_tensor(vals).to(dtype))


#: the UGAL program's knobs in :func:`scenario_routing`
UGAL_KW = dict(levels=4, max_len=8, n_candidates=8)
#: the greedy balancer's hop budget and chunk in :func:`scenario_routing`
FLOW_KW = dict(max_len=6, chunk=16)


def adaptive_pairs(db) -> list:
    macs = sorted(db.hosts)[:8]
    return [(a, b) for a in macs for b in macs if a != b]


def scenario_routing() -> dict:
    """The routing legs on a mesh of this process group (one process's
    8-shard mesh in the test's own process): the greedy balancer on
    fat-tree k=4 from cached distances, ``multichip_route_step``, the
    UGAL program on dragonfly(4, 4), packed and decoded, with and
    without cached distances; then the engine: the mesh-only refresh's
    host distances and next hops (no ``shard_oracle``), and the adaptive
    pair batch with and without ``shard_oracle``."""
    import torch

    from sdnmpi_tpu_torch import shardplane as pshard
    from sdnmpi_tpu_torch.convert import shard_rows
    from sdnmpi_tpu_torch.oracle.apsp import apsp_distances
    from sdnmpi_tpu_torch.oracle.engine import tensorize
    from sdnmpi_tpu_torch.shardplane import routes
    from sdnmpi_tpu_torch.shardplane.mesh import gather_host
    from sdnmpi_tpu_torch.topogen import dragonfly

    m = pshard.make_multihost_mesh(N_SHARDS, device="cpu")
    t = tensorize(fabric().to_topology_db(backend="torch", device="cpu", pad_multiple=PAD),
                  pad_multiple=PAD, device="cpu")
    p = {k: torch.as_tensor(x) for k, x in balance_problem(t.host_adj(), t.n_real).items()}
    args = (p["src"], p["dst"], p["weight"], m, FLOW_KW["max_len"])
    dist = apsp_distances(t.adj).numpy()
    out = {}
    for name, got in (
        ("flows", pshard.route_flows_sharded(
            t.adj, shard_rows(dist, m), p["base"], *args, chunk=FLOW_KW["chunk"])),
        ("step", pshard.multichip_route_step(
            t.adj, p["base"], *args, chunk=FLOW_KW["chunk"])),
    ):
        nodes, load, maxc = got
        out[name] = (gather_host(nodes, m), load.numpy(), float(maxc))
    out["v_blocks"] = [b.numpy() for b in pshard.apsp_distances_sharded(t.adj, m)]
    f = {k: torch.as_tensor(x)
         for k, x in balance_problem(t.host_adj(), t.n_real, fractional=True).items()}
    nodes, load, maxc = pshard.route_flows_sharded(
        t.adj, shard_rows(dist, m), f["base"], f["src"], f["dst"], f["weight"], m,
        FLOW_KW["max_len"], chunk=FLOW_KW["chunk"])
    out["flows_fractional"] = (gather_host(nodes, m), load.numpy(), float(maxc))
    dt = tensorize(dragonfly(4, 4).to_topology_db(backend="torch", device="cpu",
                                                   pad_multiple=PAD),
                   pad_multiple=PAD, device="cpu")
    u = {k: torch.as_tensor(x) for k, x in ugal_problem(dt.host_adj(), dt.n_real).items()}
    d_full = apsp_distances(dt.adj).numpy()
    for packed in (True, False):
        for cached in (False, True):
            got = pshard.route_adaptive_sharded(
                dt.adj, u["util"], u["src"], u["dst"], u["weight"], dt.n_real, m,
                dist=shard_rows(d_full, m) if cached else None, packed=packed, **UGAL_KW)
            out[("ugal", packed, cached)] = (
                *(gather_host(x, m) for x in got[:3]), got[3].numpy())
    u = {k: torch.as_tensor(x) for k, x in ugal_problem(
        dt.host_adj(), dt.n_real, seed=2, fractional=True).items()}
    got = pshard.route_adaptive_sharded(dt.adj, u["util"], u["src"], u["dst"],
                                        u["weight"], dt.n_real, m, packed=True, **UGAL_KW)
    out["ugal_fractional"] = (*(gather_host(x, m) for x in got[:3]), got[3].numpy())
    out["psum"] = {}
    for dtype in (torch.float32, torch.float64):
        parts = [x if q in m.local else None for q, x in enumerate(psum_parts(dtype))]
        out["psum"][str(dtype)] = routes._sum_over_shards(parts, m).numpy()
    mesh_only = fabric().to_topology_db(backend="torch", device="cpu", pad_multiple=PAD,
                                        mesh_devices=N_SHARDS)
    oracle = mesh_only._oracle_engine()
    oracle.refresh(mesh_only)
    out["refresh"] = (oracle._dist.copy(), oracle._next.copy())
    out["adaptive"] = mesh_only.find_routes_batch_adaptive(adaptive_pairs(mesh_only))
    sharded = sharded_db(False)
    out["adaptive_shard_oracle"] = sharded.find_routes_batch_adaptive(
        adaptive_pairs(sharded))
    return out


def hier_stack(seed: int, n: int, s: int, p: float = 0.3) -> np.ndarray:
    """A seeded stack of ``n`` symmetric pod adjacencies of size ``s``,
    the last member of every pod cut off (inf distances, -1 next hops),
    as ``tests/test_torch_hier.py`` builds them."""
    rng = np.random.default_rng(seed)
    a = (rng.random((n, s, s)) < p).astype(np.float32)
    a = np.maximum(a, a.transpose(0, 2, 1))
    a[:, np.arange(s), np.arange(s)] = 0
    a[:, :, -1] = a[:, -1, :] = 0
    return a


#: the pod stacks of :func:`scenario_hier`: (seed, pods, pod size), pods
#: off the shard count and fewer pods than shards
HIER_STACKS = ((1, 12, 8), (2, 3, 16))


def hier_db(**kw):
    from sdnmpi_tpu_torch.topogen import fattree

    return fattree(8).to_topology_db(device="cpu", hier_oracle=True, **kw)


def hier_pairs(db, n: int = 12) -> list:
    hosts = sorted(db.hosts)[:n]
    return [(a, b) for a in hosts for b in hosts if a != b]


def hier_cable():
    """An intra-pod cable of fattree(8)."""
    from sdnmpi_tpu_torch.topogen import fattree

    spec = fattree(8)
    pm = spec.podmap
    return next(c for c in spec.links if pm.pod_of[c[0]] == pm.pod_of[c[2]])


def flip(db, cable, add: bool) -> None:
    from sdnmpi_tpu_torch.core.topology_db import Link, Port

    a, pa, b, pb = cable
    for x, px, y, py in ((a, pa, b, pb), (b, pb, a, pa)):
        (db.add_link if add else db.delete_link)(Link(Port(x, px), Port(y, py)))


def scenario_hier() -> dict:
    """The hier oracle's three sharded planes on a mesh of this process
    group: the pod blocks (host stacks and resident twins) of seeded
    stacks, then ``TopologyDB(hier_oracle=True, mesh_devices=8,
    ring_exchange=True)`` on fattree(8): its routes, the row sweep of
    every border (host rows and device plane), the border plane, and an
    intra-pod flap's repair (routes, rows and twins after it)."""
    import torch

    from sdnmpi_tpu_torch.shardplane import hier as shier
    from sdnmpi_tpu_torch.shardplane.mesh import gather_host, make_multihost_mesh

    m = make_multihost_mesh(N_SHARDS, device="cpu")
    out = {}
    for seed, n, s in HIER_STACKS:
        adj = hier_stack(seed, n, s)
        dd, nd, nn, sharded = shier.pod_stack_apsp_async(adj, m)
        twins = ((gather_host(dd, m), gather_host(nd, m)) if sharded
                 else (dd.numpy(), nd.numpy()))
        out[("pods", seed)] = (*shier.pod_stack_apsp(adj, m), twins, sharded)
    db = hier_db(mesh_devices=N_SHARDS, ring_exchange=True)
    pairs = hier_pairs(db)
    out["fdbs"] = db.find_routes_batch(pairs)
    macs = sorted(db.hosts)[:12]
    si, di = np.nonzero(~np.eye(12, dtype=bool))
    out["collective"] = db.find_routes_collective(
        macs, si.astype(np.int32), di.astype(np.int32), "shortest").fdbs()
    oracle = db._oracle_engine()
    st = oracle._hier
    targets = np.arange(st.n_borders, dtype=np.int64)
    rows, rows_d = shier.sweep_rows_sharded(st.deg_buckets, st.n_borders, targets, m)
    out["sweep"] = (rows, rows_d.numpy())
    out["plane"] = shier.ring_exchange_border_plane(st)
    out["rows"] = {p: r.copy() for p, r in st.rows.items()}
    builds = oracle.full_refresh_count
    cable = hier_cable()
    flap = []
    for add in (False, True):
        flip(db, cable, add)
        fdbs = db.find_routes_batch(pairs)
        st = oracle._hier
        twins = [(gather_host(b.dist_d, m)[:len(b.pods)], b.dist.copy())
                 for b in st.buckets if isinstance(b.dist_d, list)]
        flap.append((fdbs, twins, {p: r.copy() for p, r in st.rows.items()}))
    out["flap"] = (flap, oracle.full_refresh_count - builds)
    return out


def scenario_launch(hier: bool = False) -> dict:
    """``python -m sdnmpi_tpu_torch --distributed 127.0.0.1:PORT,2,RANK
    --device cpu --shard-oracle --demo`` in this process (its group is
    up already, so ``init_multihost`` is a no-op), or with
    ``--hier-oracle`` in place of ``--shard-oracle`` (the hierarchy, the
    ring carrying its border plane): the demo's log line and the
    checkpoint it writes."""
    import torch.distributed as dist

    spec = f"127.0.0.1:{PORT[0]},{dist.get_world_size()},{dist.get_rank()}"
    return dict(run_launch(["--distributed", spec], hier=hier), spec=spec)


def run_launch(extra: list, hier: bool = False) -> dict:
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
                         "--hier-oracle" if hier else "--shard-oracle",
                         "--ring-exchange", "--no-rpc",
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
    "engine": scenario_engine, "routing": scenario_routing, "hier": scenario_hier,
    "launch": scenario_launch,
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
