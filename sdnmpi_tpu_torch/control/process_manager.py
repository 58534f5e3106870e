"""MPI process manager app.

Equivalent of the reference's ``ProcessManager``
(reference: sdnmpi/process.py:53-119): installs the announcement-intercept
flow on every switch (UDP dport 61000 -> controller at control priority),
parses LAUNCH/EXIT announcement broadcasts into the RankAllocationDB, and
answers rank-resolution queries for the router.
"""

from __future__ import annotations

import logging

from sdnmpi_tpu_torch.config import Config, DEFAULT_CONFIG
from sdnmpi_tpu_torch.control import events as ev
from sdnmpi_tpu_torch.control.bus import EventBus
from sdnmpi_tpu_torch.core.rank_allocation_db import RankAllocationDB
from sdnmpi_tpu_torch.protocol import openflow as of
from sdnmpi_tpu_torch.protocol.announcement import AnnouncementType
from sdnmpi_tpu_torch.utils.mac import BROADCAST_MAC

log = logging.getLogger("ProcessManager")


class ProcessManager:
    name = "ProcessManager"

    def __init__(
        self,
        bus: EventBus,
        southbound,
        config: Config = DEFAULT_CONFIG,
    ) -> None:
        self.bus = bus
        self.southbound = southbound
        self.config = config
        self.rankdb = RankAllocationDB()

        bus.subscribe(ev.EventDatapathUp, self._datapath_up)
        bus.subscribe(ev.EventPacketIn, self._packet_in)
        bus.provide(ev.RankResolutionRequest, self._rank_resolution)
        bus.provide(ev.CurrentProcessAllocationRequest, self._current_allocation)

    def _datapath_up(self, event: ev.EventDatapathUp) -> None:
        # announcement packets -> controller (reference: process.py:61-79)
        mod = of.FlowMod(
            match=of.Match(
                dl_type=of.ETH_TYPE_IP,
                nw_proto=of.IPPROTO_UDP,
                tp_dst=self.config.announcement_port,
            ),
            actions=(of.ActionOutput(of.OFPP_CONTROLLER),),
            priority=self.config.priority_control,
        )
        self.southbound.flow_mod(event.dpid, mod)

    def _packet_in(self, event: ev.EventPacketIn) -> None:
        pkt = event.pkt
        # broadcast + IP only (reference: process.py:87-89)
        if pkt.eth_dst != BROADCAST_MAC or pkt.eth_type != of.ETH_TYPE_IP:
            return
        if pkt.udp_dst != self.config.announcement_port:
            return
        # batch-parse the datagram with the native wire codec: a payload
        # may coalesce many records (an MPI runtime launching thousands
        # of ranks batches its announcements; the reference parses only
        # a single fixed-size record, sdnmpi/process.py:101-105).
        # Malformed records are dropped by the decoder.
        from sdnmpi_tpu_torch.native import decode_announcements

        types, ranks = decode_announcements(pkt.payload)
        if len(types) == 0:
            log.warning("malformed announcement from %s", pkt.eth_src)
            return
        for type_code, rank in zip(types, ranks):
            if type_code == AnnouncementType.LAUNCH:
                self.rankdb.add_process(int(rank), pkt.eth_src)
                self.bus.publish(ev.EventProcessAdd(int(rank), pkt.eth_src))
                log.info("MPI process %s started at %s", rank, pkt.eth_src)
            elif type_code == AnnouncementType.EXIT:
                self.rankdb.delete_process(int(rank))
                self.bus.publish(ev.EventProcessDelete(int(rank)))
                log.info("MPI process %s exited at %s", rank, pkt.eth_src)

    def _rank_resolution(self, req: ev.RankResolutionRequest) -> ev.RankResolutionReply:
        return ev.RankResolutionReply(self.rankdb.get_mac(req.rank))

    def _current_allocation(
        self, req: ev.CurrentProcessAllocationRequest
    ) -> ev.CurrentProcessAllocationReply:
        return ev.CurrentProcessAllocationReply(self.rankdb)
