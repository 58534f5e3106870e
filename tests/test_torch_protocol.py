"""The port's wire codecs and host codecs against the JAX package's.

``protocol/{announcement,lldp,ofwire}.py`` and the announcement and
member-scatter entry points of ``native.py`` are host code copied from
the reference. They are held on the golden vectors of
``tests/test_protocol.py``, ``test_ofwire.py`` and ``test_native.py``,
and by seeded fuzz in which both packages encode the same messages and
must produce the same bytes and decode each other's.
"""

import random

import numpy as np
import pytest

import sdnmpi_tpu.native as j_native
import sdnmpi_tpu_torch.native as p_native
from sdnmpi_tpu.protocol import lldp as j_lldp
from sdnmpi_tpu.protocol import ofwire as j_ofwire
from sdnmpi_tpu.protocol import openflow as j_of
from sdnmpi_tpu_torch.protocol import lldp
from sdnmpi_tpu_torch.protocol import ofwire
from sdnmpi_tpu_torch.protocol import openflow as of
from sdnmpi_tpu_torch.protocol.announcement import (
    ANNOUNCEMENT_PACKET_LEN,
    Announcement,
    AnnouncementType,
)

MAC1 = "02:00:00:00:00:01"
MAC2 = "02:00:00:00:00:02"


# -- golden vectors --------------------------------------------------------


def test_announcement_golden():
    assert ANNOUNCEMENT_PACKET_LEN == 8
    raw = Announcement(AnnouncementType.EXIT, 258).encode()
    assert raw == b"\x01\x00\x00\x00\x02\x01\x00\x00"
    for ann in (Announcement(AnnouncementType.LAUNCH, 0),
                Announcement(AnnouncementType.LAUNCH, 4095),
                Announcement(AnnouncementType.EXIT, 17)):
        assert Announcement.decode(ann.encode()) == ann
        assert Announcement.decode(ann.encode() + b"pad") == ann
    with pytest.raises(ValueError):
        Announcement.decode(b"\x00\x00")


@pytest.mark.parametrize("name,got,want", [
    ("hello", lambda: ofwire.encode_hello(xid=1), "0100000800000001"),
    ("echo_request", lambda: ofwire.encode_echo_request(b"ab", xid=2),
     "0102000a000000026162"),
    ("echo_reply", lambda: ofwire.encode_echo_reply(b"ab", xid=2),
     "0103000a000000026162"),
    ("port_stats_request", lambda: ofwire.encode_port_stats_request(xid=3),
     "0110001400000003" "0004" "0000" "ffff" "000000000000"),
    ("flow_mod_exact_l2", lambda: ofwire.encode_flow_mod(of.FlowMod(
        match=of.Match(dl_src=MAC1, dl_dst=MAC2),
        actions=(of.ActionOutput(2),), priority=0x8000,
    ), xid=4),
     "010e0050" "00000004" "003820f3" "0000" "020000000001" "020000000002"
     "0000" "00" "00" "0000" "00" "00" "0000" "00000000" "00000000" "0000"
     "0000" "0000000000000000" "0000" "0000" "0000" "8000" "ffffffff" "ffff"
     "0001" "00000008" "0002" "ffff"),
])
def test_ofwire_golden(name, got, want):
    assert got() == bytes.fromhex(want)


def test_ofwire_announcement_flow_wildcards():
    mod = of.FlowMod(
        match=of.Match(dl_type=of.ETH_TYPE_IP, nw_proto=of.IPPROTO_UDP,
                       tp_dst=61000),
        actions=(of.ActionOutput(of.OFPP_CONTROLLER),), priority=0xFFFF,
    )
    wire = ofwire.encode_flow_mod(mod, xid=5)
    assert wire[8:12] == bytes.fromhex("0038204f")
    assert ofwire.decode_flow_mod(wire) == mod


def test_ofwire_features_and_framing():
    wire = ofwire.encode_features_reply(0x00002AB5, [1, 2, 65534], xid=9)
    assert ofwire.peek_header(wire) == (ofwire.OFPT_FEATURES_REPLY, 8 + 24 + 3 * 48, 9)
    assert ofwire.decode_features_reply(wire) == (0x2AB5, [1, 2])
    assert wire[8:16] == (0x2AB5).to_bytes(8, "big")
    stream = (ofwire.encode_hello(xid=1) + ofwire.encode_port_stats_request(xid=2)
              + ofwire.encode_echo_request(b"ping", xid=3))
    seen, off = [], 0
    while off < len(stream):
        msg_type, length, xid = ofwire.peek_header(stream[off:])
        seen.append((msg_type, xid))
        off += length
    assert seen == [(ofwire.OFPT_HELLO, 1), (ofwire.OFPT_STATS_REQUEST, 2),
                    (ofwire.OFPT_ECHO_REQUEST, 3)]
    with pytest.raises(ValueError):
        ofwire.peek_header(b"\x04\x00\x00\x08\x00\x00\x00\x00")


def test_frame_headers():
    pkt = of.Packet(MAC1, MAC2, ip_proto=of.IPPROTO_UDP, udp_dst=61000,
                    payload=b"xy")
    frame = ofwire.encode_frame(pkt)
    assert frame[12:14] == b"\x08\x00" and frame[14] == 0x45
    assert frame[23] == 17 and frame[36:38] == (61000).to_bytes(2, "big")
    assert frame[-2:] == b"xy"
    back = ofwire.decode_frame(ofwire.encode_frame(
        of.Packet(MAC1, MAC2, udp_dst=61000, payload=b"x")))
    assert (back.udp_dst, back.ip_proto, back.payload) == (61000, 17, b"x")


@pytest.mark.parametrize("dpid,port", [(1, 1), (0xDEAD, 47), (2**48, 65000)])
def test_lldp_roundtrip_and_bytes(dpid, port):
    pkt = lldp.encode_lldp(dpid, port)
    assert pkt.eth_type == of.ETH_TYPE_LLDP
    assert lldp.decode_lldp(pkt) == (dpid, port)
    assert repr(pkt) == repr(j_lldp.encode_lldp(dpid, port))
    with pytest.raises(ValueError):
        lldp.decode_lldp(of.Packet(MAC1, MAC2))


# -- differential fuzz: same messages, same bytes --------------------------


def _rand_mac(rng):
    return ":".join(f"{rng.randrange(256):02x}" for _ in range(6))


def _flow_mod(o, rng):
    match = o.Match(
        in_port=rng.choice([None, rng.randrange(0xFF00)]),
        dl_src=rng.choice([None, _rand_mac(rng)]),
        dl_dst=rng.choice([None, _rand_mac(rng)]),
        dl_type=rng.choice([None, 0x0800, 0x88CC, rng.randrange(65536)]),
        nw_proto=rng.choice([None, 17, rng.randrange(256)]),
        tp_dst=rng.choice([None, 61000, rng.randrange(65536)]),
    )
    actions = tuple(
        rng.choice([o.ActionOutput(rng.randrange(0x10000)),
                    o.ActionSetDlDst(_rand_mac(rng))])
        for _ in range(rng.randrange(4))
    )
    return o.FlowMod(
        match=match, actions=actions, priority=rng.randrange(0x10000),
        command=rng.choice([o.OFPFC_ADD, o.OFPFC_DELETE]),
        idle_timeout=rng.randrange(0x10000),
        hard_timeout=rng.randrange(0x10000), cookie=rng.randrange(2**64),
    )


def _packet(o, rng):
    return o.Packet(
        _rand_mac(rng), _rand_mac(rng),
        eth_type=rng.choice([o.ETH_TYPE_IP, o.ETH_TYPE_LLDP]),
        ip_proto=rng.choice([None, 6, o.IPPROTO_UDP]),
        udp_dst=rng.choice([None, 61000]),
        payload=bytes(rng.randrange(256) for _ in range(rng.randrange(24))),
    )


@pytest.mark.parametrize("seed", range(4))
def test_ofwire_matches_jax(seed):
    """Both packages encode the same messages to the same bytes, and
    each decodes the other's."""
    for k in range(50):
        s = seed * 1000 + k
        xid = random.Random(s).randrange(2**32)
        p_mod, j_mod = _flow_mod(of, random.Random(s)), _flow_mod(j_of, random.Random(s))
        wire = ofwire.encode_flow_mod(p_mod, xid=xid)
        assert wire == j_ofwire.encode_flow_mod(j_mod, xid=xid)
        assert ofwire.decode_flow_mod(wire) == p_mod
        p_pkt, j_pkt = _packet(of, random.Random(s)), _packet(j_of, random.Random(s))
        frame = ofwire.encode_frame(p_pkt)
        assert frame == j_ofwire.encode_frame(j_pkt)
        assert repr(ofwire.decode_frame(frame)) == repr(j_ofwire.decode_frame(frame))
        assert ofwire.encode_packet_in(p_pkt, in_port=k, buffer_id=s) == (
            j_ofwire.encode_packet_in(j_pkt, in_port=k, buffer_id=s))
        out = of.PacketOut(data=p_pkt, actions=p_mod.actions, in_port=k % 7)
        j_out = j_of.PacketOut(data=j_pkt, actions=j_mod.actions, in_port=k % 7)
        assert ofwire.encode_packet_out(out, xid=xid) == j_ofwire.encode_packet_out(j_out, xid=xid)
        removed = dict(priority=k, reason=ofwire.OFPRR_IDLE_TIMEOUT, duration_sec=s % 97,
                       idle_timeout=5, packet_count=s, byte_count=64 * s)
        assert ofwire.encode_flow_removed(p_mod.match, **removed) == (
            j_ofwire.encode_flow_removed(j_mod.match, **removed))
    entries = [(p, p * 3, p * 300, p * 5, p * 500) for p in range(1, 9)]
    assert ofwire.encode_port_stats_reply([of.PortStatsEntry(*e) for e in entries]) == (
        j_ofwire.encode_port_stats_reply([j_of.PortStatsEntry(*e) for e in entries]))


@pytest.mark.parametrize("seed", range(3))
def test_flow_mods_batch_matches_jax(seed):
    """The batched FlowMod encoder, byte for byte against the reference
    and against the concatenation of its scalar twins."""
    rng = np.random.default_rng(seed)
    for _ in range(10):
        n = int(rng.integers(1, 40))
        cols = dict(
            src=rng.integers(0, 1 << 48, n, dtype=np.int64),
            dst=rng.integers(0, 1 << 48, n, dtype=np.int64),
            out_port=rng.integers(0, 0x10000, n).astype(np.int32),
            rewrite=np.where(rng.random(n) < 0.4,
                             rng.integers(0, 1 << 48, n, dtype=np.int64), np.int64(-1)),
            priority=int(rng.integers(0x10000)),
            idle_timeout=int(rng.integers(0x10000)),
            hard_timeout=int(rng.integers(0x10000)),
            command=int(rng.choice([of.OFPFC_ADD, of.OFPFC_DELETE])),
            cookie=int(rng.integers(0, 1 << 63)),
        )
        xid = int(rng.integers(1 << 31))
        got = ofwire.encode_flow_mods_batch(of.FlowModBatch(**cols), xid_base=xid)
        assert got == j_ofwire.encode_flow_mods_batch(j_of.FlowModBatch(**cols), xid_base=xid)
        twins = of.FlowModBatch(**cols).to_flow_mods()
        assert got == b"".join(
            ofwire.encode_flow_mod(m, xid=xid + i) for i, m in enumerate(twins))


def test_flow_stats_reply_matches_jax():
    rng = random.Random(3)
    p_entries, j_entries = [], []
    for k in range(40):
        s = rng.randrange(2**32)
        for o, out in ((of, p_entries), (j_of, j_entries)):
            r = random.Random(s)
            m = _flow_mod(o, r)
            out.append(o.FlowStatsEntry(
                match=m.match, actions=m.actions, priority=m.priority,
                duration_sec=k, idle_timeout=m.idle_timeout,
                hard_timeout=m.hard_timeout, cookie=m.cookie,
                packet_count=k * 7, byte_count=k * 448,
            ))
    got = ofwire.encode_flow_stats_reply(p_entries, xid=11)
    want = j_ofwire.encode_flow_stats_reply(j_entries, xid=11)
    assert got == want
    msgs = got if isinstance(got, list) else [got]
    assert [repr(e) for e in ofwire.decode_flow_stats_reply(msgs)] == [
        repr(e) for e in j_ofwire.decode_flow_stats_reply(msgs)]


# -- native host codecs ----------------------------------------------------


def _no_native(mod):
    class _Off:
        def __enter__(self):
            self.saved = mod._lib, mod._tried
            mod._lib, mod._tried = None, True

        def __exit__(self, *exc):
            mod._lib, mod._tried = self.saved

    return _Off()


def test_announcements_codec_matches_jax():
    ty = np.array([0, 1, 1, 0], np.int32)
    rk = np.array([5, 2, 0, 4095], np.int32)
    buf = p_native.encode_announcements(ty, rk)
    assert buf == j_native.encode_announcements(ty, rk) and len(buf) == 32
    bad = buf + b"\x07\x00\x00\x00\x01\x00\x00\x00" + b"\xff\xff"
    for decoded in (p_native.decode_announcements(bad),
                    j_native.decode_announcements(bad)):
        np.testing.assert_array_equal(decoded[0], ty)
        np.testing.assert_array_equal(decoded[1], rk)
    with _no_native(p_native):
        np.testing.assert_array_equal(p_native.decode_announcements(bad)[1], rk)
        assert p_native.encode_announcements(ty, rk) == buf
    wire = Announcement(AnnouncementType.LAUNCH, 42).encode()
    t1, r1 = p_native.decode_announcements(wire)
    assert list(t1) == [0] and list(r1) == [42]


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_scatter_members_matches_jax(native):
    """The block install's member scatter, with the C++ library and with
    its numpy fall-back, against the reference's."""
    rng = np.random.default_rng(5)
    n, f, s = 24, 300, 17
    src = rng.integers(0, n, f).astype(np.int32)
    dst = rng.integers(0, n, f).astype(np.int32)
    sub = rng.integers(-1, s, f).astype(np.int32)
    luts = [rng.integers(0, 1 << 40, n, dtype=np.int64) for _ in range(4)]
    fport = rng.integers(1, 48, n).astype(np.int32)
    args = (sub, src, dst, *luts, fport, 0x020000000000, s)
    want = j_native.scatter_members(*args)
    if native:
        got = p_native.scatter_members(*args)
    else:
        with _no_native(p_native):
            got = p_native.scatter_members(*args)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
