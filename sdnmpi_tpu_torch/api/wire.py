"""Reference-visualizer wire ABI for the RPC mirror.

The reference pushed its ``init_*`` snapshots and topology events to
WebSocket clients through two serializer families, and a visualizer
written against it parses these exact shapes:

- Topology entities came from Ryu 3.26's ``ryu/topology/switches.py``
  ``to_dict`` methods (the reference broadcasts ``ev.switch.to_dict()``
  etc., reference: sdnmpi/rpc_interface.py:54-72): dpid as a 16-hex-digit
  string, port_no as an 8-hex-digit string, each port carrying
  ``hw_addr``/``name``, hosts carrying ``ipv4``/``ipv6`` lists.
- ``init_fdb`` is a LIST of ``{"dpid": int, "fdb": [{"src", "dst",
  "out_port"}]}`` (reference: sdnmpi/util/switch_fdb.py:17-32); and
  ``init_rankdb`` is the raw rank->mac mapping (reference:
  sdnmpi/util/rank_allocation_db.py:16-17; JSON stringifies the int
  keys on the wire).

The richer internal ``to_dict`` forms (core/*) feed checkpoint/resume
(api/snapshot.py) and stay as they are; this module is the translation
applied at the RPC boundary (api/rpc.py) so a reference visualizer can
consume this controller's mirror unchanged.

Counterpart of ``sdnmpi_tpu/api/wire.py``, copied as it is.

This fabric does not model per-port hardware MACs or interface names
(Ryu read them from the switch's port descriptions). They are
synthesized deterministically: Mininet-style names (``s<dpid>-eth<n>``
— what the reference's own environment produced) and
locally-administered MACs derived from (dpid, port_no).
"""

from __future__ import annotations


def dpid_str(dpid: int) -> str:
    """Ryu 3.26 ``dpid_to_str``: 16 hex digits, zero-padded."""
    return "%016x" % dpid


def port_no_str(port_no: int) -> str:
    """Ryu 3.26 ``port_no_to_str``: 8 hex digits, zero-padded."""
    return "%08x" % port_no


def _port_hw_addr(dpid: int, port_no: int) -> str:
    """Deterministic locally-administered MAC for a (dpid, port) pair."""
    return "0e:%02x:%02x:%02x:%02x:%02x" % (
        (dpid >> 24) & 0xFF, (dpid >> 16) & 0xFF, (dpid >> 8) & 0xFF,
        dpid & 0xFF, port_no & 0xFF,
    )


def port(p) -> dict:
    return {
        "dpid": dpid_str(p.dpid),
        "port_no": port_no_str(p.port_no),
        "hw_addr": _port_hw_addr(p.dpid, p.port_no),
        "name": f"s{p.dpid}-eth{p.port_no}",
    }


def switch(sw) -> dict:
    return {
        "dpid": dpid_str(sw.dp.id),
        "ports": [port(p) for p in sw.ports],
    }


def link(lk) -> dict:
    return {"src": port(lk.src), "dst": port(lk.dst)}


def host(h) -> dict:
    return {"mac": h.mac, "ipv4": [], "ipv6": [], "port": port(h.port)}


def topology(db) -> dict:
    """`init_topologydb` payload (reference: sdnmpi/util/topology_db.py:
    44-57 over Ryu entity dicts)."""
    links = []
    for dst_to_link in db.links.values():
        for lk in dst_to_link.values():
            links.append(link(lk))
    return {
        "switches": [switch(sw) for sw in db.switches.values()],
        "links": links,
        "hosts": [host(h) for h in db.hosts.values()],
    }


def fdb(switch_fdb) -> list:
    """`init_fdb` payload (reference: sdnmpi/util/switch_fdb.py:17-32)."""
    return [
        {
            "dpid": dpid,
            "fdb": [
                {"src": src, "dst": dst, "out_port": out_port}
                for (src, dst), out_port in table.items()
            ],
        }
        for dpid, table in switch_fdb.fdb.items()
    ]


def rankdb(rank_db) -> dict:
    """`init_rankdb` payload — the raw int-keyed rank->mac mapping
    (reference: sdnmpi/util/rank_allocation_db.py:16-17); JSON key
    stringification happens at the transport, same as the reference."""
    return dict(rank_db.processes)
