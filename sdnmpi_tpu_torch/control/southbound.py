"""Real OpenFlow 1.0 TCP southbound — physical/OVS switches over bytes.

The reference inherited its transport from Ryu: switches dialed the
controller's TCP port, Ryu ran the version/features handshake, and the
apps saw datapath objects (reference: run_router.sh:2 `ryu-manager`;
every `datapath.send_msg` in sdnmpi/router.py:62, monitor.py:60,
process.py:79). This module is that transport, built directly on the
byte codec (protocol/ofwire.py):

- an asyncio TCP server on the standard OF port (6633);
- per connection: Hello + FeaturesRequest, then a framed read loop
  (``ofwire.peek_header`` lengths) dispatching Echo, FeaturesReply,
  PacketIn, FlowRemoved, and port StatsReply;
- the same app-facing surface as the simulated ``Fabric``
  (``flow_mod`` / ``packet_out`` / ``port_stats`` /
  ``flow_block_set`` / ``connected_dpids`` / the ``on_idle``
  burst-drained hook the route coalescer flushes from) and the same
  bus events (EventDatapathUp/Down, EventSwitchEnter/Leave,
  EventPacketIn, EventFlowRemoved) — so the entire controller,
  including ``Config.coalesce_routes``, runs unchanged against real
  switches; the Fabric remains the hermetic test double.

Asynchrony note: ``port_stats`` is a synchronous pull in the app API
(the Monitor differentiates counters at its own cadence). Over TCP it
returns the switch's most recent StatsReply and fires off a fresh
request — one sampling interval of lag, which the delta computation
absorbs (the first interval is a baseline anyway, reference:
sdnmpi/monitor.py:70-77).

``flow_block_set`` (this framework's array-native collective install,
no OF 1.0 equivalent) degrades to its per-row FlowMods on the wire.

Counterpart of ``sdnmpi_tpu/control/southbound.py``, host code copied
with its imports rewritten.
"""

from __future__ import annotations

import asyncio
import logging
import struct
import time
from collections import deque

import numpy as np

from sdnmpi_tpu_torch.control.events import (
    EventBarrierAck,
    EventDatapathDown,
    EventDatapathUp,
    EventFlowRemoved,
    EventPacketIn,
    EventPortAdd,
    EventPortDelete,
    EventSwitchEnter,
    EventSwitchLeave,
)
from sdnmpi_tpu_torch.control.recovery import InstallVerdict
from sdnmpi_tpu_torch.core.topology_db import Port, Switch
from sdnmpi_tpu_torch.protocol import ofwire
from sdnmpi_tpu_torch.protocol import openflow as of
from sdnmpi_tpu_torch.utils.metrics import REGISTRY, SIZE_BUCKETS

log = logging.getLogger("OFSouthbound")

# queued/dropped verdicts of _send plus the batched-install wire volume
#: the registry the RPC telemetry feed and the text
# exposition both read.
_m_sends = REGISTRY.counter(
    "southbound_sends_total", "payloads queued to a datapath transport"
)
_m_drops = REGISTRY.counter(
    "southbound_drops_total",
    "payloads NOT queued (unknown peer or stalled-peer cut)",
)
_m_stall_cuts = REGISTRY.counter(
    "southbound_stall_cuts_total",
    "datapaths disconnected for exceeding the write-buffer cap",
)
_m_encode_bytes = REGISTRY.counter(
    "southbound_encode_bytes_total",
    "bytes produced by batched FlowMod window encodes",
)
_m_window_bytes = REGISTRY.histogram(
    "southbound_window_bytes", SIZE_BUCKETS,
    "batched encode size per FlowMod window",
)
_m_slices = REGISTRY.counter(
    "southbound_install_slices_total",
    "install_highwater byte slices written by batched installs",
)
_m_slice_wait = REGISTRY.histogram(
    "southbound_slice_wait_seconds",
    help="per-switch wait in the round-robin install scheduler between a "
    "slice being queued behind other switches' slices and its write "
    "(how long a switch's span sat parked while the window's "
    "other spans took their turns)",
)
_m_echo_timeouts = REGISTRY.counter(
    "echo_timeouts_total",
    "half-open datapaths aborted by the controller-side echo keepalive",
)
_m_stale_stats = REGISTRY.counter(
    "monitor_stale_stats_total",
    "stale cached port-stats state discarded when a datapath redialed",
)

OFP_TCP_PORT = 6633


class OFSouthbound:
    """OpenFlow 1.0 controller endpoint (see module docstring)."""

    def __init__(self, host: str = "0.0.0.0", port: int = OFP_TCP_PORT):
        self.host = host
        self.port = port
        self.bus = None
        self._server: asyncio.AbstractServer | None = None
        self._writers: dict[int, asyncio.StreamWriter] = {}
        self._ports: dict[int, set[int]] = {}
        self._stats: dict[int, list[of.PortStatsEntry]] = {}
        #: dpid -> last fully-assembled OFPST_FLOW reply (the audit
        #: plane's pull cache, same one-interval-lag contract as
        #: port_stats) and the in-flight multipart part list
        self._flow_stats: dict[int, list[of.FlowStatsEntry]] = {}
        self._flow_parts: dict[int, list[bytes]] = {}
        self._cookie_flows: dict[int, list] = {}
        self._xid = 0
        #: dpid -> (xid, sent_at monotonic) of the outstanding echo
        #: probe; a reply (any xid — liveness is liveness) clears it,
        #: echo_timeout without one aborts the transport so the reader
        #: loop exits and EventDatapathDown actually fires (the
        #: half-open-peer kill the recovery plane relies on)
        self._echo_pending: dict[int, tuple[int, float]] = {}
        #: controller-side keepalive knobs (Config.echo_interval_s /
        #: echo_timeout_s; the Controller overrides these)
        self.echo_interval: float = 15.0
        self.echo_timeout: float = 45.0
        #: terminate each batched install span with a BARRIER_REQUEST
        #: (Config.install_barriers; the Controller overrides this)
        self.send_barriers: bool = True
        #: called after a connection's read burst fully drains — every
        #: complete frame of one TCP read has been dispatched and no
        #: partial frame remains unhandled in this slice. The same idle
        #: edge the simulated Fabric provides (control/fabric.py), so
        #: the Router's route coalescer works on real switches too: a
        #: burst of packet-ins from one socket read resolves as one
        #: padded batched oracle call when the burst ends, and a lone
        #: parked packet never waits for a companion that isn't coming.
        #: None = no coalescing (Controller arms it).
        self.on_idle = None

    # -- lifecycle --------------------------------------------------------

    def connect(self, bus) -> None:
        """Bus attach; replay already-connected datapaths (none — real
        switches connect over TCP after serve())."""
        self.bus = bus

    async def serve(self) -> None:
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port
        )
        addr = self._server.sockets[0].getsockname()
        log.info("OpenFlow southbound listening on %s:%s", *addr[:2])

    async def close(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        for w in list(self._writers.values()):
            w.close()
        self._writers.clear()

    @property
    def bound_port(self) -> int:
        """The actual listening port (after serve(); for port=0 tests)."""
        return self._server.sockets[0].getsockname()[1]

    def _next_xid(self) -> int:
        self._xid += 1
        return self._xid

    # -- per-connection protocol ------------------------------------------

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        dpid: int | None = None
        writer.write(ofwire.encode_hello(self._next_xid()))
        writer.write(ofwire.encode_features_request(self._next_xid()))
        await writer.drain()
        buf = b""
        try:
            while True:
                data = await reader.read(65536)
                if not data:
                    break
                buf += data
                dpid, buf = self._drain_frames(buf, dpid, writer)
                await writer.drain()
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        except (ValueError, struct.error) as e:
            # framing/version/truncation error: drop the switch
            log.warning("protocol error from dpid=%s: %s", dpid, e)
        finally:
            if dpid is not None and self._writers.get(dpid) is writer:
                del self._writers[dpid]
                self._ports.pop(dpid, None)
                self._stats.pop(dpid, None)
                self._flow_stats.pop(dpid, None)
                self._flow_parts.pop(dpid, None)
                self._echo_pending.pop(dpid, None)
                if self.bus is not None:
                    self.bus.publish(EventDatapathDown(dpid))
                    self.bus.publish(
                        EventSwitchLeave(Switch.make(dpid, []))
                    )
                log.info("datapath %#x disconnected", dpid)
            writer.close()

    def _drain_frames(self, buf: bytes, dpid: int | None,
                      writer: asyncio.StreamWriter):
        """Dispatch every complete frame in ``buf``; returns the
        (possibly learned) dpid and the remaining partial buffer.
        Replies are drained once per burst by the caller.

        The idle notification fires from a ``finally`` so a burst that
        dispatched SOME frames before a later frame raised (protocol
        error, dying socket) still flushes coalesced work — a parked
        route lookup has no timer here to rescue it otherwise."""
        progressed = False
        try:
            while len(buf) >= 8:
                # version-tolerant framing: a peer's HELLO advertises
                # its HIGHEST version (OVS default: 1.3+) and the
                # sides settle on the minimum — 1.0 here. Only a
                # non-HELLO at a version we never negotiated is a
                # protocol error.
                version, msg_type, length, xid = struct.unpack_from(
                    "!BBHI", buf
                )
                if version != ofwire.OFP_VERSION and (
                    msg_type != ofwire.OFPT_HELLO
                ):
                    raise ValueError(
                        f"message type {msg_type} at unnegotiated "
                        f"version 0x{version:02x}"
                    )
                if length < 8:
                    # OF header is 8 bytes; a shorter declared length
                    # would consume nothing and spin this loop forever
                    raise ValueError(f"bad header length {length}")
                if len(buf) < length:
                    break
                msg, buf = buf[:length], buf[length:]
                dpid = self._dispatch(msg_type, msg, xid, dpid, writer)
                progressed = True
        finally:
            if progressed:
                # burst drained: flush coalesced work (see on_idle)
                self._notify_idle()
        return dpid, buf

    def _notify_idle(self) -> None:
        if self.on_idle is not None:
            self.on_idle()

    def _dispatch(self, msg_type: int, msg: bytes, xid: int,
                  dpid: int | None, writer: asyncio.StreamWriter) -> int | None:
        """Handle one framed message; returns the (possibly learned) dpid."""
        if msg_type == ofwire.OFPT_HELLO:
            return dpid
        if msg_type == ofwire.OFPT_ECHO_REQUEST:
            writer.write(ofwire.encode_echo_reply(msg[8:], xid))
            return dpid
        if msg_type == ofwire.OFPT_ECHO_REPLY:
            # controller-side keepalive answered: the peer is live (any
            # reply proves it — no need to match the probe's xid)
            if dpid is not None:
                self._echo_pending.pop(dpid, None)
            return dpid
        if msg_type == ofwire.OFPT_FEATURES_REPLY:
            new_dpid, port_nos = ofwire.decode_features_reply(msg)
            stale = self._writers.get(new_dpid)
            if stale is not None and stale is not writer:
                # switch redialed before its old connection timed out:
                # abort the stale transport so its reader loop exits and
                # stops dispatching into this dpid's shared state (its
                # cleanup is a no-op — _writers already points here)
                log.warning(
                    "datapath %#x reconnected; aborting stale session",
                    new_dpid,
                )
                stale.transport.abort()
            # a redial is a NEW switch process: the previous
            # connection's cached StatsReply and outstanding echo probe
            # are stale. Without this, a dpid that disconnected between
            # Monitor passes and redialed before the next StatsReply
            # would serve the dead connection's counters (or, when its
            # down-path cleanup raced the redial, nothing) forever.
            if self._stats.pop(new_dpid, None) is not None:
                _m_stale_stats.inc()
            # same staleness rule for the flow-stats cache: a redialed
            # switch's table restarted (or at least its counters did)
            self._flow_stats.pop(new_dpid, None)
            self._flow_parts.pop(new_dpid, None)
            self._echo_pending.pop(new_dpid, None)
            self._writers[new_dpid] = writer
            self._ports[new_dpid] = set(port_nos)
            if self.bus is not None:
                self.bus.publish(EventDatapathUp(new_dpid))
                self.bus.publish(EventSwitchEnter(Switch.make(
                    new_dpid, [Port(new_dpid, p) for p in sorted(port_nos)]
                )))
            log.info("datapath %#x connected (%d ports)", new_dpid,
                     len(port_nos))
            return new_dpid
        if msg_type == ofwire.OFPT_ERROR:
            # before the dpid guard: a switch rejecting the handshake's
            # own FEATURES_REQUEST errors while dpid is still unknown.
            # Errors are diagnostics, not disconnects — even malformed
            # ones (a truncated body must not become newly fatal).
            who = f"{dpid:#x}" if dpid is not None else "(pre-handshake)"
            try:
                err_type, code, data = ofwire.decode_error(msg)
            except (ValueError, struct.error):
                log.warning(
                    "switch %s sent a malformed error message (%d bytes)",
                    who, len(msg),
                )
                return dpid
            log.warning(
                "switch %s rejected a request: xid=%d error type=%d "
                "code=%d (%d bytes of offending message)",
                who, xid, err_type, code, len(data),
            )
            return dpid
        if dpid is None:
            log.debug("pre-handshake message type %d ignored", msg_type)
            return dpid
        if msg_type == ofwire.OFPT_PORT_STATUS:
            reason, port_no, state = ofwire.decode_port_status(msg)
            ports = self._ports.setdefault(dpid, set())
            dead = reason == ofwire.OFPPR_DELETE or (
                reason == ofwire.OFPPR_MODIFY
                and state & ofwire.OFPPS_LINK_DOWN
            )
            if dead:
                ports.discard(port_no)
                if self.bus is not None:
                    # TopologyManager prunes the port's links AND drops
                    # it from the Switch entity (broadcast edge-port math)
                    self.bus.publish(EventPortDelete(dpid, port_no))
            elif port_no not in ports:
                # OFPPR_ADD, or a MODIFY back to link-up after a flap —
                # either way the port (re)joins the inventory and
                # EventPortAdd makes LLDP discovery reflood it
                ports.add(port_no)
                if self.bus is not None:
                    self.bus.publish(EventPortAdd(Switch.make(
                        dpid, [Port(dpid, p) for p in sorted(ports)]
                    )))
            return dpid
        if msg_type == ofwire.OFPT_PACKET_IN:
            pkt, in_port, buffer_id, _reason = ofwire.decode_packet_in(msg)
            if self.bus is not None:
                self.bus.publish(EventPacketIn(dpid, in_port, pkt, buffer_id))
        elif msg_type == ofwire.OFPT_FLOW_REMOVED:
            rec = ofwire.decode_flow_removed(msg)
            if self.bus is not None:
                self.bus.publish(EventFlowRemoved(
                    dpid, rec["match"], rec["priority"], rec["reason"],
                    float(rec["duration_sec"]), rec["packet_count"],
                    rec["byte_count"],
                ))
        elif msg_type == ofwire.OFPT_STATS_REPLY:
            stats_type, flags = ofwire.peek_stats_type(msg)
            if stats_type == ofwire.OFPST_FLOW:
                # MULTIPART: parts accumulate until REPLY_MORE clears,
                # then the whole table decodes in one batched pass —
                # a partial accumulation never serves as a table dump
                # (the audit would read the missing tail as divergence)
                parts = self._flow_parts.setdefault(dpid, [])
                parts.append(msg)
                if not flags & ofwire.OFPSF_REPLY_MORE:
                    del self._flow_parts[dpid]
                    self._flow_stats[dpid] = (
                        ofwire.decode_flow_stats_reply(parts)
                    )
            else:
                self._stats[dpid] = ofwire.decode_port_stats_reply(msg)
        elif msg_type == ofwire.OFPT_BARRIER_REPLY:
            # the end-to-end receipt of a batched install span: the
            # switch has processed everything sent before the barrier
            if self.bus is not None:
                self.bus.publish(EventBarrierAck(dpid, xid))
        else:
            log.debug("unhandled message type %d from %#x", msg_type, dpid)
        return dpid

    # -- southbound API used by the apps (Fabric-compatible) ---------------

    #: a switch that stops reading gets disconnected once this much
    #: unsent data accumulates, instead of buffering without bound —
    #: the same stalled-peer policy as the RPC mirror's backlog cap
    MAX_WRITE_BUFFER = 4 * 1024 * 1024

    def _send(self, dpid: int, payload: bytes) -> bool:
        """Write one payload toward a datapath; returns False when the
        bytes were NOT queued (unknown peer, or the stalled-peer cut
        fired) so synchronous burst loops can stop early — the reader
        task that prunes ``_writers`` cannot run mid-loop, so the
        return value is the only in-loop liveness signal."""
        w = self._writers.get(dpid)
        if w is None:  # datapath died between event and send
            log.debug("send to unknown dpid %s dropped", dpid)
            _m_drops.inc()
            return False
        if w.transport.get_write_buffer_size() > self.MAX_WRITE_BUFFER:
            log.warning(
                "datapath %#x stalled (%d bytes unsent); disconnecting",
                dpid, w.transport.get_write_buffer_size(),
            )
            # abort, not close: close() waits to flush a buffer the
            # stalled peer will never read, so connection_lost — and the
            # reader loop's datapath-down publication — would never fire
            w.transport.abort()
            _m_drops.inc()
            _m_stall_cuts.inc()
            return False
        w.write(payload)  # drained by the connection's event loop
        _m_sends.inc()
        return True

    def flow_mod(self, dpid: int, mod: of.FlowMod) -> bool:
        """Returns the queued/dropped send verdict (see _send) so
        callers with bookkeeping — the recovery plane, the block-install
        cookie record — never record a flow the wire never carried."""
        return self._send(
            dpid, ofwire.encode_flow_mod(mod, xid=self._next_xid())
        )

    # -- controller-side echo keepalive --------------------------

    def echo_tick(self, now: float | None = None) -> None:
        """One keepalive pass: probe every connected datapath, abort any
        whose previous probe aged past ``echo_timeout``. A half-open
        peer (switch power-cut, NAT state loss, frozen middlebox)
        otherwise looks connected forever — no bytes flow, so the
        reader loop never errors, and EventDatapathDown never fires.
        The abort forces connection_lost, which runs the reader loop's
        full teardown path (datapath-down + switch-leave publication)."""
        import time as _time

        now = _time.monotonic() if now is None else now
        for dpid in list(self._writers):
            pending = self._echo_pending.get(dpid)
            if pending is not None:
                xid, t0 = pending
                if now - t0 >= self.echo_timeout:
                    log.warning(
                        "datapath %#x half-open: no echo reply in %.1fs; "
                        "disconnecting", dpid, now - t0,
                    )
                    _m_echo_timeouts.inc()
                    del self._echo_pending[dpid]
                    w = self._writers.get(dpid)
                    if w is not None:
                        w.transport.abort()
                continue  # probe still outstanding, not yet timed out
            xid = self._next_xid()
            if self._send(dpid, ofwire.encode_echo_request(b"", xid)):
                self._echo_pending[dpid] = (xid, now)

    async def run_echo(self) -> None:
        """Asyncio keepalive loop (armed by the launcher when
        ``Config.echo_interval_s`` > 0)."""
        while True:
            await asyncio.sleep(self.echo_interval)
            self.echo_tick()

    #: byte cap per batched-install write slice (Config.install_highwater;
    #: the Controller overrides this from its config). Slicing exists to
    #: re-arm the stalled-peer write-buffer check between slices: one
    #: giant burst cannot overshoot MAX_WRITE_BUFFER by more than a
    #: slice, and once the cut fires the rest of the burst is dropped
    #: instead of being pushed into the aborted transport.
    install_highwater: int = 256 * 1024

    def flow_mods_batch(self, dpid: int, batch: of.FlowModBatch):
        """Install a whole per-switch FlowMod burst: ONE batched wire
        encode (ofwire.encode_flow_mods_batch — numpy record assembly,
        no per-message struct.pack) flushed with writev-style sliced
        sends under the ``install_highwater`` backpressure cap. The
        bytes on the wire are identical to ``len(batch)`` flow_mod
        calls (asserted in tests/test_ofwire.py)."""
        return self.flow_mods_window(
            np.full(len(batch), dpid, np.int64), batch
        )

    def flow_mods_window(self, dpids, batch: of.FlowModBatch) -> InstallVerdict:
        """Install a whole *window's* FlowMods across switches: ``dpids``
        is the [N] per-row switch id, grouped (equal dpids contiguous —
        the Router's argsort guarantees it). The entire window is
        serialized in ONE batched encode; each switch receives its
        contiguous byte span of the blob (zero re-encoding per group),
        sliced under the ``install_highwater`` backpressure cap with the
        stalled-peer check re-armed between slices.

        Per-switch send scheduling: the
        slices of DIFFERENT switches interleave round-robin instead of
        each switch's whole span flushing before the next switch sees a
        byte — one slow or enormous span (a stalled peer grinding
        against the write-buffer cap, a hot switch with 100x the rows)
        no longer serializes the entire window behind it; every peer's
        first slice is queued within one round. Each switch's OWN byte
        stream is unchanged (its slices stay in order on its own
        transport), so the wire bytes per switch — and the
        scalar-equivalence the tests fuzz — are byte-identical.

        Returns an :class:`~sdnmpi_tpu_torch.control.recovery.InstallVerdict`:
        which switches got their whole span queued (terminated by an
        OFPT_BARRIER_REQUEST when ``send_barriers`` — the ack is the
        install's receipt), and which dropped mid-span and need the
        recovery plane's retry queue. Fire-and-forget no more. Verdict
        order follows the window's group order regardless of which
        span's slices completed first."""
        dpids = np.asarray(dpids)
        verdict = InstallVerdict()
        n = len(batch)
        if n == 0:
            return verdict
        from sdnmpi_tpu_torch.utils.arrays import group_spans

        blob, offsets = ofwire.encode_flow_mods_spans(
            batch, xid_base=self._xid + 1
        )
        self._xid += n
        _m_encode_bytes.inc(len(blob))
        _m_window_bytes.observe(len(blob))
        step = max(1, int(self.install_highwater))
        spans = [
            (int(dpids[lo]), blob[int(offsets[lo]) : int(offsets[hi])])
            for lo, hi in group_spans(dpids)
        ]
        sent_off = [0] * len(spans)
        #: group index -> ("sent" | "dropped", barrier xid | None)
        outcome: dict[int, tuple] = {}
        t_win = time.monotonic()
        ready = deque((i, t_win) for i in range(len(spans)))
        while ready:
            i, t_parked = ready.popleft()
            # per-switch slice wait: how long this switch's
            # next slice sat parked while other switches' slices took
            # their round-robin turns — the scheduler's fairness signal
            # (a stalled or enormous peer shows up HERE, not as other
            # switches' install latency)
            _m_slice_wait.observe(time.monotonic() - t_parked)
            dpid, span = spans[i]
            off = sent_off[i]
            if off < len(span):
                if not self._send(dpid, span[off : off + step]):
                    # peer unknown or cut for stalling: drop the rest
                    # of THIS switch's burst (other switches continue)
                    outcome[i] = ("dropped", None)
                    continue
                _m_slices.inc()
                sent_off[i] = off + step
                if sent_off[i] < len(span):
                    # back of the round-robin queue
                    ready.append((i, time.monotonic()))
                    continue
            # span fully queued: terminate it with the barrier NOW so
            # the receipt follows the last slice on this peer's stream
            if self.send_barriers:
                xid = self._next_xid()
                if not self._send(dpid, ofwire.encode_barrier_request(xid)):
                    # the span queued but its receipt cannot: treat the
                    # whole span as suspect (the transport just died)
                    outcome[i] = ("dropped", None)
                    continue
                outcome[i] = ("sent", xid)
            else:
                outcome[i] = ("sent", None)
        for i, (dpid, _) in enumerate(spans):
            state, xid = outcome[i]
            if state == "dropped":
                verdict.dropped.append(dpid)
                continue
            if xid is not None:
                verdict.barriers.append((dpid, xid))
            verdict.sent.append(dpid)
        return verdict

    def packet_out(self, dpid: int, out: of.PacketOut) -> None:
        self._send(dpid, ofwire.encode_packet_out(out, xid=self._next_xid()))

    def port_stats(self, dpid: int) -> list[of.PortStatsEntry]:
        """Last cached reply; kicks off the next request (one-interval
        lag — see module docstring)."""
        self._send(
            dpid, ofwire.encode_port_stats_request(xid=self._next_xid())
        )
        return self._stats.get(dpid, [])

    def flow_stats(self, dpid: int):
        """Last fully-assembled OFPST_FLOW table dump; kicks off the
        next request (one-interval lag, like port_stats). Returns None
        — not [] — before the first complete reply lands: the audit
        plane must never read "no answer yet" as "empty table"."""
        self._send(
            dpid, ofwire.encode_flow_stats_request(xid=self._next_xid())
        )
        return self._flow_stats.get(dpid)

    def invalidate_flow_stats(self, dpid: int) -> None:
        """Drop the cached table dump (and any in-flight multipart):
        the audit plane calls this when it KNOWS the table just changed
        out from under the cache (a wipe-and-resync) — the one-interval
        lag must not serve the pre-wipe dump as a post-wipe verify."""
        self._flow_stats.pop(dpid, None)
        self._flow_parts.pop(dpid, None)

    def connected_dpids(self) -> list[int]:
        return sorted(self._writers)

    def flow_block_set(self, block: of.FlowBlockSet) -> None:
        """Array-native collective install, expanded to one exact-match
        FlowMod per (member, hop) — the wire has no block equivalent.
        Installed matches are recorded per cookie so
        ``flow_blocks_delete`` can tear the collective down (OF 1.0 has
        no cookie-based delete; that arrived in 1.1)."""
        from sdnmpi_tpu_torch.utils.mac import int_to_mac

        hop_dpid = np.asarray(block.hop_dpid)
        hop_port = np.asarray(block.hop_port)
        hop_len = np.asarray(block.hop_len)
        bounds = np.asarray(block.bounds)
        srcs = np.asarray(block.src)
        dsts = np.asarray(block.dst)
        final_port = np.asarray(block.final_port)
        rewrite = None if block.rewrite is None else np.asarray(block.rewrite)
        installed = self._cookie_flows.setdefault(block.cookie, [])
        for s in range(len(hop_len)):
            n_hops = int(hop_len[s])
            for m in range(int(bounds[s]), int(bounds[s + 1])):
                match = of.Match(
                    dl_src=int_to_mac(int(srcs[m])),
                    dl_dst=int_to_mac(int(dsts[m])),
                )
                for h in range(n_hops):
                    last = h == n_hops - 1
                    actions: tuple[of.Action, ...]
                    if last:
                        out = of.ActionOutput(int(final_port[m]))
                        actions = (
                            (of.ActionSetDlDst(int_to_mac(int(rewrite[m]))), out)
                            if rewrite is not None else (out,)
                        )
                    else:
                        actions = (of.ActionOutput(int(hop_port[s, h])),)
                    dpid = int(hop_dpid[s, h])
                    if self.flow_mod(dpid, of.FlowMod(
                        match, actions, block.priority, cookie=block.cookie,
                    )):
                        # record only flows the wire actually carried: a
                        # dropped send recorded here would make teardown
                        # delete flows that were never installed (and,
                        # worse, any identical match a later install DID
                        # put there)
                        installed.append((dpid, match, block.priority))

    def flow_blocks_delete(self, cookie: int) -> None:
        """Tear down a collective install: one OFPFC_DELETE per recorded
        exact match (see flow_block_set), the whole teardown serialized
        through ONE batched ``encode_flow_mods_spans`` window per
        priority (the same path as ``Router._del_flows_window`` — a
        large collective's teardown is a delete storm, and per-mod
        scalar encodes cost what the batched installs already
        eliminated). Byte-identical to the scalar per-mod loop modulo
        the xid sequence (differential-tested in tests/test_recovery.py)."""
        rows = self._cookie_flows.pop(cookie, [])
        if not rows:
            return
        from sdnmpi_tpu_torch.utils.mac import macs_to_ints

        # one window per priority (priorities are uniform per block, but
        # a shared cookie across blocks must not cross-contaminate)
        by_prio: dict[int, list] = {}
        for dpid, match, priority in rows:
            by_prio.setdefault(priority, []).append((dpid, match))
        for priority, group in sorted(by_prio.items()):
            kd = np.array([d for d, _ in group], np.int64)
            order = np.argsort(kd, kind="stable")
            self.flow_mods_window(kd[order], of.FlowModBatch(
                src=macs_to_ints([m.dl_src for _, m in group])[order],
                dst=macs_to_ints([m.dl_dst for _, m in group])[order],
                out_port=np.zeros(len(group), np.int32),  # DELETE: no actions
                rewrite=None,
                priority=priority,
                command=of.OFPFC_DELETE,
                cookie=cookie,
            ))
