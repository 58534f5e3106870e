"""Northbound state mirror: WebSocket JSON-RPC.

Equivalent of the reference's ``RPCInterface``
(reference: sdnmpi/rpc_interface.py:18-110): on client connect, pushes
full snapshots as ``init_fdb`` / ``init_rankdb`` / ``init_topologydb``
(obtained through the same three Current* requests), then re-broadcasts
every state-change event as a JSON-RPC call with the reference's exact
method names and positional params:

    add_process(rank, mac)        delete_process(rank)
    update_fdb(dpid, src, dst, port)
    add_switch(switch_dict)       delete_switch(switch_dict)
    add_link(link_dict)           delete_link(link_dict)
    add_host(host_dict)

plus ``remove_fdb(dpid, src, dst)`` for the flow teardowns the reference
never performs. Calls are JSON-RPC 2.0 *notifications* (no ids — the
reference's tinyrpc stack sent ids but ignored the replies,
rpc_interface.py:74-85). Snapshot and entity payloads are translated to
the reference visualizer's exact schemas by ``api/wire.py`` (Ryu 3.26
entity dicts; list-form ``init_fdb``) — internal ``to_dict`` forms never
reach the wire.

Transport is split from logic for testability: the app broadcasts to any
object with a ``send_json(dict)`` method; ``serve()`` runs the real
asyncio WebSocket endpoint at the reference's path (/v1.0/sdnmpi/ws) and
drops clients whose sockets fail, as the reference does on SocketError
(rpc_interface.py:87-95). ``serve()`` needs the ``websockets`` package
(the ``rpc`` extra).

Counterpart of ``sdnmpi_tpu/api/rpc.py``, copied with its imports
rewritten.
"""

from __future__ import annotations

import json
import logging
from typing import Protocol

from sdnmpi_tpu_torch.api import wire
from sdnmpi_tpu_torch.config import Config, DEFAULT_CONFIG
from sdnmpi_tpu_torch.control import events as ev
from sdnmpi_tpu_torch.control.bus import EventBus

log = logging.getLogger("RPCInterface")


class RPCClient(Protocol):
    def send_json(self, message: dict) -> None: ...


def _timeline_names(params):
    """``timeline`` params -> series-name filter (None = everything).
    A bare string first param is ONE name, not an iterable of chars —
    char-splitting it would silently filter every real series out and
    the empty reply would read as "series does not exist"."""
    if not params:
        return None
    names = params[0]
    if names is None:
        return None
    if isinstance(names, str):
        return [names]
    return [str(n) for n in names]


class RPCInterface:
    name = "RPCInterface"

    def __init__(self, bus: EventBus, config: Config = DEFAULT_CONFIG) -> None:
        self.bus = bus
        self.config = config
        self.clients: list[RPCClient] = []
        #: replication ingest hook: launch.py points this at
        #: RpcReplicaLink.ingest so inbound ``replica_relay``
        #: notifications feed the replica plane's inbox
        self.on_replica_relay = None

        bus.subscribe(ev.EventProcessAdd, lambda e: self._broadcast("add_process", e.rank, e.mac))
        bus.subscribe(ev.EventProcessDelete, lambda e: self._broadcast("delete_process", e.rank))
        bus.subscribe(ev.EventFDBUpdate, lambda e: self._broadcast("update_fdb", e.dpid, e.src, e.dst, e.port))
        bus.subscribe(ev.EventFDBRemove, lambda e: self._broadcast("remove_fdb", e.dpid, e.src, e.dst))
        # teardown BURSTS (revalidation passes, rank exits) arrive as one
        # EventFDBRemoveBatch and leave as one notification — a link flap
        # must not cost the mirror hundreds of remove_fdb broadcasts.
        # Extension method beyond the reference protocol; per-row
        # removals (flow expiry) keep the reference's remove_fdb above.
        bus.subscribe(
            ev.EventFDBRemoveBatch,
            lambda e: self._broadcast(
                "remove_fdb_batch",
                [[dpid, src, dst] for dpid, src, dst in e.rows],
            ),
        )
        # entity payloads go through the Ryu-3.26-exact wire ABI
        # (api/wire.py) so a reference visualizer parses them unchanged
        bus.subscribe(ev.EventSwitchEnter, lambda e: self._broadcast("add_switch", wire.switch(e.switch)))
        bus.subscribe(ev.EventSwitchLeave, lambda e: self._broadcast("delete_switch", wire.switch(e.switch)))
        bus.subscribe(ev.EventLinkAdd, lambda e: self._broadcast("add_link", wire.link(e.link)))
        bus.subscribe(ev.EventLinkDelete, lambda e: self._broadcast("delete_link", wire.link(e.link)))
        bus.subscribe(ev.EventHostAdd, lambda e: self._broadcast("add_host", wire.host(e.host)))
        # block-installed collectives mirror as summaries, never per-pair
        # rows (an alltoall would be 16.7M update_fdb calls); extension
        # methods beyond the reference protocol
        bus.subscribe(
            ev.EventCollectiveInstalled,
            lambda e: self._broadcast(
                "install_collective",
                e.cookie, e.coll_type, e.n_pairs, e.n_flows, e.max_congestion,
            ),
        )
        bus.subscribe(
            ev.EventCollectiveRemoved,
            lambda e: self._broadcast("remove_collective", e.cookie),
        )
        # phase progress of scheduled installs: one summary
        # per phase boundary — a client watching a large scheduled
        # collective sees phases land as they hit the wire, ahead of
        # the program-level install_collective
        bus.subscribe(
            ev.EventCollectivePhaseInstalled,
            lambda e: self._broadcast(
                "install_collective_phase",
                e.cookie, e.phase, e.n_phases, e.n_pairs, e.n_flows,
                e.max_congestion,
            ),
        )
        # live telemetry feed: one update_telemetry notification per
        # Monitor pass (EventStatsFlush), carrying the controller's
        # registry snapshot — the same payload api/telemetry.py renders
        # as the Prometheus text exposition
        if config.rpc_telemetry:
            bus.subscribe(ev.EventStatsFlush, self._telemetry_flush)
        # anomaly push channel: a flight-recorder trigger's
        # frozen bundle summary broadcasts the moment it fires — the
        # "something just went wrong, here is the dump path" signal
        bus.subscribe(
            ev.EventAnomaly,
            lambda e: self._broadcast("anomaly", e.trigger, e.summary,
                                      e.path),
        )

    # -- client lifecycle -------------------------------------------------

    def init_client(self, client: RPCClient) -> None:
        """Push full state snapshots to a newly-connected client
        (reference: rpc_interface.py:34-40)."""
        fdb = self.bus.request(ev.CurrentFDBRequest()).fdb
        self._call(client, "init_fdb", wire.fdb(fdb))
        rankdb = self.bus.request(ev.CurrentProcessAllocationRequest()).processes
        self._call(client, "init_rankdb", wire.rankdb(rankdb))
        topology = self.bus.request(ev.CurrentTopologyRequest()).topology
        self._call(client, "init_topologydb", wire.topology(topology))
        collectives = self.bus.request(ev.CurrentCollectivesRequest()).collectives
        self._call(client, "init_collectives", collectives.to_dict())

    def attach_client(self, client: RPCClient) -> None:
        self.clients.append(client)
        self.init_client(client)

    def detach_client(self, client: RPCClient) -> None:
        if client in self.clients:
            self.clients.remove(client)

    def _telemetry_flush(self, event: ev.EventStatsFlush) -> None:
        """Riding the Monitor cadence: snapshot once, broadcast to every
        client. No clients, no snapshot — the disabled path costs one
        list check per Monitor pass."""
        if not self.clients:
            return
        try:
            snap = self.bus.request(ev.TelemetryRequest()).telemetry
        except LookupError:
            # minimal stacks without a Controller on the bus: fall back
            # to the process-wide registry directly
            from sdnmpi_tpu_torch.api.telemetry import telemetry_snapshot

            snap = telemetry_snapshot()
        self._broadcast("update_telemetry", snap)

    # -- pull-mode requests --------------------------------------
    #
    # Beside the push broadcasts, a client may send JSON-RPC *requests*
    # (messages WITH an id) and get replies. Methods:
    #
    #   telemetry()          -> the registry snapshot (same payload as
    #                           the update_telemetry push)
    #   span_tree(span_id)   -> the flight recorder's completed tree
    #                           containing that span (exemplar
    #                           resolution), or null
    #   flight_dump()        -> freeze + return a diagnostic bundle NOW
    #   timeline([names])    -> the metrics timeline's queryable
    #                           history: {series: {name:
    #                           [[ts, value], ...]}} over the bounded
    #                           multi-resolution ring; names filters
    #   traffic_matrix()     -> the published measured traffic matrix
    #                           {epoch, mode, endpoints,
    #                           cells: [[tenant, src, dst, bps], ...]}

    #: method name -> (request factory, reply-attribute extractor)
    PULL_METHODS = {
        "telemetry": (lambda params: ev.TelemetryRequest(),
                      lambda reply: reply.telemetry),
        "span_tree": (lambda params: ev.SpanTreeRequest(int(params[0])),
                      lambda reply: reply.tree),
        "flight_dump": (lambda params: ev.FlightDumpRequest(),
                        lambda reply: reply.bundle),
        "timeline": (lambda params: ev.TimelineRequest(
                         _timeline_names(params)),
                     lambda reply: reply.timeline),
        "traffic_matrix": (lambda params: ev.TrafficMatrixRequest(),
                           lambda reply: reply.matrix),
        "replica_status": (lambda params: ev.ReplicaStatusRequest(),
                           lambda reply: reply.status),
    }

    def handle_request(self, message: dict):
        """Answer one inbound JSON-RPC message. Returns the reply dict
        for requests (id present), None for notifications (the
        reference's clients never send any — tolerated, ignored).
        Errors use the standard JSON-RPC codes so a stock client
        library's error handling just works."""
        if not isinstance(message, dict):
            return None
        msg_id = message.get("id")
        if msg_id is None:
            # notifications: nothing to answer. The one we act on is
            # the replica pair's replication stream — each
            # ``replica_relay`` notification carries one protocol
            # message for the peer's RpcReplicaLink inbox.
            if message.get("method") == "replica_relay":
                ingest = self.on_replica_relay
                params = message.get("params")
                if ingest is not None and params:
                    ingest(params[0])
            return None
        method = message.get("method")
        entry = self.PULL_METHODS.get(method)
        if entry is None:
            return {
                "jsonrpc": "2.0", "id": msg_id,
                "error": {"code": -32601,
                          "message": f"method not found: {method}"},
            }
        make_request, extract = entry
        try:
            request = make_request(message.get("params") or [])
        except (LookupError, TypeError, ValueError) as e:
            # built OUTSIDE the dispatch try: a missing positional
            # (IndexError) or by-name params the factory doesn't take
            # (KeyError — dict params are legal JSON-RPC 2.0) must read
            # as bad params, not as a missing provider or a dead socket
            return {
                "jsonrpc": "2.0", "id": msg_id,
                "error": {"code": -32602, "message": f"bad params: {e}"},
            }
        try:
            reply = self.bus.request(request)
            result = extract(reply)
        except LookupError:
            # minimal buses without the provider: telemetry falls back
            # to the process registry; the rest report unavailable
            if method == "telemetry":
                from sdnmpi_tpu_torch.api.telemetry import telemetry_snapshot

                result = telemetry_snapshot()
            else:
                return {
                    "jsonrpc": "2.0", "id": msg_id,
                    "error": {"code": -32001,
                              "message": f"{method} unavailable"},
                }
        return {"jsonrpc": "2.0", "id": msg_id, "result": result}

    # -- broadcasting -----------------------------------------------------

    def _call(self, client: RPCClient, method: str, *params) -> bool:
        try:
            client.send_json(
                {"jsonrpc": "2.0", "method": method, "params": list(params)}
            )
            return True
        except Exception:
            log.debug("RPC client failed on %s; dropping", method, exc_info=True)
            return False

    def _broadcast(self, method: str, *params) -> None:
        dead = [c for c in self.clients if not self._call(c, method, *params)]
        for client in dead:
            self.clients.remove(client)

    # -- real transport ---------------------------------------------------

    async def serve(self):
        """Run the WebSocket endpoint until cancelled."""
        import asyncio

        import websockets

        interface = self

        async def handler(ws):
            path = getattr(getattr(ws, "request", None), "path", None)
            if path is not None and path != interface.config.rpc_path:
                await ws.close(code=1008, reason="unknown path")
                return
            loop = asyncio.get_running_loop()
            client = _WebSocketClient(ws, loop)
            interface.attach_client(client)
            log.info("RPC client connected")
            try:
                await client.pump(interface)
            finally:
                interface.detach_client(client)
                log.info("RPC client disconnected")

        async with websockets.serve(
            handler, self.config.rpc_host, self.config.rpc_port
        ):
            log.info(
                "RPC mirror listening on ws://%s:%s%s",
                self.config.rpc_host,
                self.config.rpc_port,
                self.config.rpc_path,
            )
            await asyncio.Future()  # run until cancelled


class _WebSocketClient:
    """Bridges the synchronous bus to one async WebSocket connection via
    an outbound queue (the bus thread is the event-loop thread)."""

    #: outbound backlog bound: a stalled client that stops reading gets
    #: dropped instead of buffering the controller's event stream forever
    MAX_BACKLOG = 4096

    def __init__(self, ws, loop) -> None:
        import asyncio

        self.ws = ws
        self.loop = loop
        self.queue: "asyncio.Queue[str]" = asyncio.Queue(maxsize=self.MAX_BACKLOG)
        self.closed = False

    def send_json(self, message: dict) -> None:
        import asyncio

        if self.closed:
            raise ConnectionError("websocket closed")
        try:
            self.queue.put_nowait(json.dumps(message))
        except asyncio.QueueFull:
            self.closed = True
            # actually tear the connection down: pump() is blocked in
            # ws.send() on backpressure and only a close unblocks it so
            # the handler can release the socket and the full queue
            self.loop.call_soon_threadsafe(
                lambda: self.loop.create_task(self.ws.close())
            )
            raise ConnectionError("websocket client stalled; backlog full")

    async def pump(self, interface=None) -> None:
        """Drain the outbound queue and (when given the interface) serve
        inbound pull-mode requests, until the socket dies. Replies ride
        the same outbound queue as broadcasts — one writer task per
        socket, so frames never interleave — and count against the same
        backlog bound."""
        import asyncio

        tasks = [asyncio.create_task(self._send_loop())]
        if interface is not None:
            tasks.append(asyncio.create_task(self._recv_loop(interface)))
        try:
            done, pending = await asyncio.wait(
                tasks, return_when=asyncio.FIRST_COMPLETED
            )
            for task in pending:
                task.cancel()
            for task in done:
                task.result()  # surface the failure like the old pump
        except Exception:
            self.closed = True
            raise
        finally:
            for task in tasks:
                task.cancel()

    async def _send_loop(self) -> None:
        while True:
            await self.ws.send(await self.queue.get())

    async def _recv_loop(self, interface) -> None:
        import asyncio

        async for raw in self.ws:
            try:
                message = json.loads(raw)
            except json.JSONDecodeError:
                continue  # garbage frame: drop, keep the connection
            reply = interface.handle_request(message)
            if reply is not None:
                # same last-resort encoder the disk dump uses: a bundle
                # context value (numpy scalar, set) must not kill the
                # socket when the file path survives it
                from sdnmpi_tpu_torch.utils.flight import json_default

                try:
                    self.queue.put_nowait(
                        json.dumps(reply, default=json_default)
                    )
                except asyncio.QueueFull:
                    return  # stalled peer: let pump tear us down
