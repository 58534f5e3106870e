"""Chaos fault-injection harness for the simulated fabric and the wire.

The recovery plane (control/recovery.py) exists for hardware that
fails; this module is the hardware that fails. Two layers:

- :class:`FaultPlan` — a seeded fault schedule attached to the
  simulated :class:`~sdnmpi_tpu_torch.control.fabric.Fabric`
  (``fabric.faults = plan`` / ``plan.attach(fabric)``). The fabric
  consults it on every southbound send (dropped / stalled / truncated
  windows, dropped barrier acks, delayed stats replies), and
  :meth:`FaultPlan.step` drives scenario-level chaos: seeded switch
  crashes + redials, link flaps, and stalled-stream releases.
  :meth:`FaultPlan.quiesce` heals everything — redials every crashed
  switch, restores every flapped link, releases every stalled stream,
  and stops injecting — so a chaos soak can assert the recovery plane
  converged the fabric back to the desired store exactly
  (tests/test_recovery.py).
- :class:`FaultProxy` — a byte-level TCP shim for wire mode: a fake (or
  real) OpenFlow switch dials the proxy, the proxy dials the real
  ``OFSouthbound``, and faults are injected on the actual byte stream —
  frozen forwarding (half-open peer), hard cuts mid-window (crash), and
  truncated frames (a dying switch's last, partial TCP segment).

Nothing here is test-only plumbing in the pejorative sense: ``--chaos``
(sdnmpi_tpu_torch.launch) arms a FaultPlan against the simulated fabric so a
live demo controller can be watched surviving the same schedule.
"""

from __future__ import annotations

import asyncio
import logging
import random

log = logging.getLogger("faults")

#: send-fault kinds a FaultPlan can return for one switch's span
DROP = "drop"  #: the bytes never reach the switch (verdict: dropped)
STALL = "stall"  #: queued behind a frozen stream; applied on release
TRUNCATE = "truncate"  #: a frame boundary is cut mid-span; tail is lost

#: table-mutation kinds: silent flow-table corruption behind
#: the controller's back — no event fires, no verdict reports it; ONLY
#: the audit plane's ground-truth sweep (control/audit.py) can see it
MUTATE_KINDS = (
    "drop_row",  #: a desired row vanishes (missing)
    "insert_row",  #: a bogus row appears (orphan)
    "blackhole",  #: a row's actions become drop (missing via mismatch)
    "freeze",  #: a row forwards but its counters die (counter-dead)
)


class FaultPlan:
    """Seeded fault schedule (see module docstring).

    All probabilities are per-opportunity: send faults per per-switch
    span, scenario faults per :meth:`step`. The RNG is the only state
    shared across fault kinds, so one seed reproduces one chaos
    history bit-for-bit.
    """

    def __init__(
        self,
        seed: int = 0,
        p_send_drop: float = 0.0,
        p_send_stall: float = 0.0,
        p_send_truncate: float = 0.0,
        p_ack_drop: float = 0.0,
        p_stats_delay: float = 0.0,
        p_crash: float = 0.0,
        p_redial: float = 0.5,
        p_flap: float = 0.0,
        p_restore: float = 0.5,
        p_release: float = 0.5,
        max_crashed: int = 2,
        p_mutate: float = 0.0,
        mutate_kinds=MUTATE_KINDS,
        mutate_priority: int = 0x8000,
    ) -> None:
        self.rng = random.Random(seed)
        self.p_send_drop = p_send_drop
        self.p_send_stall = p_send_stall
        self.p_send_truncate = p_send_truncate
        self.p_ack_drop = p_ack_drop
        self.p_stats_delay = p_stats_delay
        self.p_crash = p_crash
        self.p_redial = p_redial
        self.p_flap = p_flap
        self.p_restore = p_restore
        self.p_release = p_release
        self.max_crashed = max_crashed
        self.p_mutate = p_mutate
        self.mutate_kinds = tuple(mutate_kinds)
        #: priority of the rows mutations target (the Router's install
        #: priority — Config.priority_default; the audit plane's scope)
        self.mutate_priority = mutate_priority
        self.fabric = None
        self.active = True
        #: links taken down by step() (not by crashes), awaiting restore
        self.flapped: list[tuple[int, int, int, int]] = []
        #: every injected table mutation: (dpid, kind, (src, dst)) —
        #: the audit soak's ledger (quiesce() deliberately does NOT
        #: repair these: only the audit plane's ground-truth sweep can)
        self.mutations: list[tuple[int, str, tuple[str, str]]] = []
        # injection tallies (the soak prints these beside the registry)
        self.counts: dict[str, int] = {
            DROP: 0, STALL: 0, TRUNCATE: 0, "ack_drop": 0,
            "stats_delay": 0, "crash": 0, "redial": 0, "flap": 0,
            "restore": 0, "mutate": 0,
        }

    def attach(self, fabric) -> "FaultPlan":
        self.fabric = fabric
        fabric.faults = self
        return self

    # -- send-level hooks (consulted by Fabric) ---------------------------

    def send_fault(self, dpid: int) -> str | None:
        """Fault verdict for one switch's span of a send (None = clean)."""
        if not self.active:
            return None
        r = self.rng.random()
        if r < self.p_send_drop:
            self.counts[DROP] += 1
            return DROP
        r -= self.p_send_drop
        if r < self.p_send_stall:
            self.counts[STALL] += 1
            return STALL
        r -= self.p_send_stall
        if r < self.p_send_truncate:
            self.counts[TRUNCATE] += 1
            return TRUNCATE
        return None

    def ack_fault(self, dpid: int) -> bool:
        """True: lose this barrier ack (the install applied, the receipt
        did not — the pure barrier-timeout path)."""
        if self.active and self.rng.random() < self.p_ack_drop:
            self.counts["ack_drop"] += 1
            return True
        return False

    def stats_fault(self, dpid: int) -> bool:
        """True: this stats pull returns nothing (delayed StatsReply)."""
        if self.active and self.rng.random() < self.p_stats_delay:
            self.counts["stats_delay"] += 1
            return True
        return False

    # -- scenario steps ---------------------------------------------------

    def step(self) -> None:
        """One chaos step against the attached fabric: maybe crash a
        switch, maybe redial a crashed one, maybe flap or restore a
        link, maybe release a stalled stream. Seeded, so a failing soak
        replays exactly."""
        fabric = self.fabric
        assert fabric is not None, "attach() a fabric first"
        rng = self.rng
        if (
            len(fabric._crashed) < self.max_crashed
            and fabric.switches and rng.random() < self.p_crash
        ):
            dpid = rng.choice(sorted(fabric.switches))
            self.counts["crash"] += 1
            fabric.crash_switch(dpid)
        for dpid in sorted(fabric._crashed):
            if rng.random() < self.p_redial:
                self.counts["redial"] += 1
                fabric.redial_switch(dpid)
        if fabric.links and rng.random() < self.p_flap:
            link = rng.choice(sorted(fabric.links))
            self.counts["flap"] += 1
            fabric.remove_link(*link)
            self.flapped.append(link)
        for link in list(self.flapped):
            if rng.random() < self.p_restore:
                a, pa, b, pb = link
                self.flapped.remove(link)
                if a in fabric.switches and b in fabric.switches:
                    self.counts["restore"] += 1
                    fabric.add_link(a, pa, b, pb)
                # else: an endpoint crashed meanwhile; its redial's dark-
                # link pass cannot know about flap-removed links, so
                # requeue until both ends are back
                else:
                    self.flapped.append(link)
        for dpid in sorted(fabric._stall_q):
            if rng.random() < self.p_release:
                fabric.release_stalls(dpid)
        if self.p_mutate > 0 and rng.random() < self.p_mutate:
            self.mutate()

    # -- table mutations ---------------------------------------

    def mutate(self, dpid: int | None = None,
               kind: str | None = None) -> tuple | None:
        """Inject ONE silent flow-table mutation behind the
        controller's back (see MUTATE_KINDS) and record it in the
        ledger. No bus event fires and no verdict reports it — exactly
        the divergence class only the audit plane's OFPST_FLOW sweep
        can detect. A row is mutated at most once (re-mutating a row
        the audit already healed would make the soak's
        one-divergence-per-mutation accounting ambiguous). Returns the
        ledger record, or None when no eligible row exists."""
        from sdnmpi_tpu_torch.protocol import openflow as of

        fabric = self.fabric
        assert fabric is not None, "attach() a fabric first"
        rng = self.rng
        kind = kind or rng.choice(self.mutate_kinds)
        mutated = {(d, row) for d, _k, row in self.mutations}

        if kind == "insert_row":
            if not fabric.switches:
                return None
            dpid = rng.choice(sorted(fabric.switches)) if dpid is None \
                else dpid
            # a bogus exact-match row the controller never desired —
            # locally-administered MACs from a range no generator host
            # or vMAC uses, so the row is inert in the data plane
            while True:
                src = "0a:fa:00:00:%02x:%02x" % (
                    rng.randrange(256), rng.randrange(256)
                )
                dst = "0a:fb:00:00:%02x:%02x" % (
                    rng.randrange(256), rng.randrange(256)
                )
                if (dpid, (src, dst)) not in mutated:
                    break
            fabric.switches[dpid].flow_mod(of.FlowMod(
                match=of.Match(dl_src=src, dl_dst=dst),
                actions=(of.ActionOutput(1),),
                priority=self.mutate_priority,
            ))
        else:
            def eligible(e) -> bool:
                return (
                    e.priority == self.mutate_priority
                    and e.match.dl_src is not None
                    and e.match.dl_dst is not None
                    and e.cookie == 0
                    and not e.frozen and e.actions != ()
                )

            def rows_of(d):
                return [
                    e for e in fabric.switches[d].flow_table
                    if eligible(e) and (
                        d, (e.match.dl_src, e.match.dl_dst)
                    ) not in mutated
                ]

            if dpid is None:
                candidates = [
                    d for d in sorted(fabric.switches) if rows_of(d)
                ]
                if not candidates:
                    return None
                dpid = rng.choice(candidates)
            rows = rows_of(dpid)
            if not rows:
                return None
            e = rng.choice(rows)
            src, dst = e.match.dl_src, e.match.dl_dst
            if kind == "drop_row":
                fabric.switches[dpid].drop_entries({id(e)})
            elif kind == "blackhole":
                e.actions = ()
            elif kind == "freeze":
                e.frozen = True
            else:
                raise ValueError(f"unknown mutation kind {kind!r}")
        rec = (dpid, kind, (src, dst))
        self.mutations.append(rec)
        self.counts["mutate"] += 1
        return rec

    def quiesce(self) -> None:
        """Heal the world and stop injecting: every surviving fault is
        repaired so the recovery plane's convergence can be asserted
        against a quiet fabric. Table mutations are deliberately NOT
        repaired — no controller-side machinery ever learns about them
        except the audit plane's ground-truth sweep, so leaving them in
        place is exactly what the audit soak asserts against."""
        fabric = self.fabric
        self.active = False
        for dpid in sorted(fabric._crashed):
            fabric.redial_switch(dpid)
        for a, pa, b, pb in self.flapped:
            if a in fabric.switches and b in fabric.switches:
                fabric.add_link(a, pa, b, pb)
        self.flapped.clear()
        fabric.release_stalls()


class FaultProxy:
    """Byte-level TCP fault shim for wire mode (see module docstring).

    One proxy fronts ONE switch connection: the switch dials
    ``serve()``'s port, the proxy dials ``upstream_port`` (the real
    OFSouthbound), and two pump tasks forward bytes. Faults:

    - ``freeze()`` / ``thaw()`` — stop/resume forwarding in both
      directions while keeping both sockets open: the half-open peer
      the controller-side echo keepalive exists to kill;
    - ``cut()`` — abort both sides mid-stream: a switch crash from the
      controller's point of view;
    - ``truncate_to_switch_next`` — the next controller->switch chunk
      loses its tail half mid-frame, then the connection drops: the
      classic dying-switch partial segment.
    """

    def __init__(self, upstream_port: int, host: str = "127.0.0.1"):
        self.host = host
        self.upstream_port = upstream_port
        self.server: asyncio.AbstractServer | None = None
        self.frozen = False
        self.truncate_to_switch_next = False
        self._held: list[tuple[asyncio.StreamWriter, bytes]] = []
        self._writers: list[asyncio.StreamWriter] = []
        self.bytes_to_switch = 0
        self.bytes_to_controller = 0

    async def serve(self) -> int:
        self.server = await asyncio.start_server(self._handle, self.host, 0)
        return self.server.sockets[0].getsockname()[1]

    async def _handle(self, sw_reader, sw_writer) -> None:
        up_reader, up_writer = await asyncio.open_connection(
            self.host, self.upstream_port
        )
        self._writers += [sw_writer, up_writer]
        await asyncio.gather(
            self._pump(sw_reader, up_writer, to_switch=False),
            self._pump(up_reader, sw_writer, to_switch=True),
            return_exceptions=True,
        )

    async def _pump(self, reader, writer, to_switch: bool) -> None:
        try:
            while True:
                data = await reader.read(65536)
                if not data:
                    break
                if to_switch and self.truncate_to_switch_next:
                    # deliver a partial frame, then die mid-connection
                    self.truncate_to_switch_next = False
                    writer.write(data[: max(1, len(data) // 2)])
                    await writer.drain()
                    self.cut()
                    return
                if self.frozen:
                    self._held.append((writer, data))
                    continue
                if to_switch:
                    self.bytes_to_switch += len(data)
                else:
                    self.bytes_to_controller += len(data)
                writer.write(data)
                await writer.drain()
        except (ConnectionError, RuntimeError):
            pass
        finally:
            if not self.frozen:
                try:
                    writer.close()
                except RuntimeError:
                    pass

    def freeze(self) -> None:
        self.frozen = True

    async def thaw(self) -> None:
        self.frozen = False
        held, self._held = self._held, []
        for writer, data in held:
            writer.write(data)
            await writer.drain()

    def cut(self) -> None:
        for w in self._writers:
            try:
                w.transport.abort()
            except RuntimeError:
                pass
        self._writers.clear()
        self._held.clear()

    async def close(self) -> None:
        self.cut()
        if self.server is not None:
            self.server.close()
            await self.server.wait_closed()
