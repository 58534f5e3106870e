"""ctypes bindings for the port's native host-runtime kernels (csrc/).

The device computes routes; the host decodes and installs them. These
bindings accelerate the host side of that pipeline — slot-stream
decoding, link-load accounting, fdb materialization, pair grouping and
the deal's per-sub-flow member counts, the block install's member
scatter, announcement parsing — with the C++ library built from the
port's own ``sdnmpi_tpu_torch/csrc/sdnmpi_native.cpp``. Every entry
point but the fused grouping pair (``group_pairs``,
``deal_subflows_keyed``) has a pure-numpy fallback with identical
semantics, so the package works without the shared library;
``available()`` reports which path is live.

The library is compiled on first use with the host C++ compiler into
``sdnmpi_tpu_torch/kernels/build/libsdnmpi_torch_host.so`` (written to a
temporary name and renamed, so concurrent processes never load a
half-written file).
"""

from __future__ import annotations

import ctypes
import logging
import os
import pathlib
import shutil
import subprocess
from typing import Optional

import numpy as np

_SRC = pathlib.Path(__file__).resolve().parent / "csrc" / "sdnmpi_native.cpp"
_LIB_PATH = (
    pathlib.Path(__file__).resolve().parent / "kernels" / "build"
    / "libsdnmpi_torch_host.so"
)

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> None:
    """Compile the shared library when it is absent or older than its
    source. A missing compiler or a failed build leaves the numpy
    fallbacks live (logged at debug level)."""
    if _LIB_PATH.exists() and _LIB_PATH.stat().st_mtime >= _SRC.stat().st_mtime:
        return
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        logging.getLogger("native").debug("no C++ compiler; numpy fallbacks")
        return
    _LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
    tmp = _LIB_PATH.with_name(f"{_LIB_PATH.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(
            [cxx, "-O3", "-fPIC", "-shared", "-std=c++17", "-pthread", "-o", str(tmp),
             str(_SRC)],
            capture_output=True, timeout=120, check=True,
        )
        os.replace(tmp, _LIB_PATH)
    except (OSError, subprocess.SubprocessError) as exc:
        logging.getLogger("native").debug(
            "native build failed (%s); using numpy fallbacks", exc
        )
    finally:
        tmp.unlink(missing_ok=True)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if not _SRC.exists():
        return None
    _build()
    if not _LIB_PATH.exists():
        return None
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
        i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i64 = ctypes.c_int64
        lib.decode_slots.argtypes = [
            i8p, i32p, i32p, i32p, i64, i64, i64, i64, ctypes.c_int32, i32p,
        ]
        lib.decode_slots.restype = None
        lib.link_loads.argtypes = [i32p, f32p, i64, i64, i64, f32p]
        lib.link_loads.restype = None
        lib.materialize_fdbs.argtypes = [
            i32p, i32p, i64p, i32p, i32p, i64, i64, i64, i64p, i32p, i32p,
        ]
        lib.materialize_fdbs.restype = None
        lib.deal_subflows.argtypes = [
            i32p, i32p, i32p, i32p, i64p, i64, i32p, i32p,
        ]
        lib.deal_subflows.restype = None
        lib.group_pairs.argtypes = [i32p, i32p, i32p, i64, i64, i64p, i64p]
        lib.group_pairs.restype = None
        lib.deal_subflows_keyed.argtypes = [
            i64p, i32p, i32p, i64p, i32p, i64p, i64, i32p, i32p,
        ]
        lib.deal_subflows_keyed.restype = None
        lib.decode_announcements.argtypes = [u8p, i64, i32p, i32p]
        lib.decode_announcements.restype = i64
        lib.encode_announcements.argtypes = [i32p, i32p, i64, u8p]
        lib.encode_announcements.restype = None
        lib.scatter_members.argtypes = [
            i32p, i32p, i32p, i64p, i64p, i64p, i64p, i32p,
            i64, i64, i64, i64p, i64p, i64p, i64p, i32p,
        ]
        lib.scatter_members.restype = None
        _lib = lib
    except (OSError, AttributeError) as exc:
        logging.getLogger("native").debug("native load failed (%s)", exc)
        _lib = None
    return _lib


#: glibc's ``mallopt`` parameters (malloc.h)
_M_TRIM_THRESHOLD, _M_TOP_PAD, _M_MMAP_MAX = -1, -2, -4
_heap_kept = False


def keep_freed_heap() -> bool:
    """Have glibc keep freed blocks in the process heap for the next
    allocation: no block is mapped on its own (each freed large array
    was unmapped, and its successor's first touch faulted every page in
    again) and the heap's top is never handed back. A collective's
    per-call arrays (hundreds of MB at a 1,024-router rack) then land on
    pages the process already holds. Idempotent; False where the C
    library has no ``mallopt``."""
    global _heap_kept
    if _heap_kept:
        return True
    try:
        mallopt = ctypes.CDLL(None).mallopt
    except (OSError, AttributeError):
        return False
    mallopt.argtypes = [ctypes.c_int, ctypes.c_int]
    _heap_kept = all([  # a list: every option is set, whatever one returns
        mallopt(_M_MMAP_MAX, 0),
        mallopt(_M_TRIM_THRESHOLD, 2**31 - 1),
        mallopt(_M_TOP_PAD, 256 << 20),
    ])
    return _heap_kept


def available() -> bool:
    """Whether the C++ kernels are loaded (False -> numpy fallbacks)."""
    return _load() is not None


def neighbor_order(adj: np.ndarray) -> np.ndarray:
    """[V, V] sorted-out-neighbor table (entries == V mark invalid),
    shared by the decoders — same construction as dag.slots_to_nodes."""
    a = np.asarray(adj) > 0
    v = a.shape[0]
    order = np.where(a, np.arange(v, dtype=np.int32)[None, :], v).astype(np.int32)
    order.sort(axis=1)
    return order


def decode_slots(
    slots: np.ndarray,
    order: np.ndarray,
    src: np.ndarray,
    dst: np.ndarray,
    complete: bool = False,
) -> np.ndarray:
    """slots [F, L] int8 + sorted-neighbor table -> nodes int32.

    ``complete=True`` appends the forced final hop (dag.sampled_hops
    contract): output [F, L + 2], whole row -1 when the walk ends not
    adjacent to dst. ``complete=False``: raw [F, L] walk."""
    lib = _load()
    slots = np.ascontiguousarray(slots, np.int8)
    order = np.ascontiguousarray(order, np.int32)
    src = np.ascontiguousarray(src, np.int32)
    dst = np.ascontiguousarray(dst, np.int32)
    f, l = slots.shape
    v, d = order.shape
    out_l = l + 2 if complete else l
    if l == 0:
        return np.empty((f, out_l), np.int32)
    if lib is None:  # numpy fallback, identical semantics
        s32 = slots.astype(np.int32)
        valid = (s32[:, 0] >= 0) | (src == dst)
        nodes = np.full((f, out_l), -1, np.int32)
        node = np.where(valid & (src >= 0), src, -1)
        for h in range(l):
            nodes[:, h] = node
            s = s32[:, h]
            ok = (s >= 0) & (node >= 0) & (s < d)
            nxt = order[np.maximum(node, 0), np.maximum(np.minimum(s, d - 1), 0)]
            node = np.where(ok & (nxt < v), nxt, -1)
        if complete:
            nodes[:, l] = node
            need = (node >= 0) & (node != dst)
            adjacent = (
                order[np.maximum(node, 0)] == dst[:, None]
            ).any(axis=1)
            nodes[need & adjacent, l + 1] = dst[need & adjacent]
            nodes[need & ~adjacent] = -1
        return nodes
    nodes = np.empty((f, out_l), np.int32)
    lib.decode_slots(slots, order, src, dst, f, l, v, d, int(complete), nodes)
    return nodes


def link_loads(nodes: np.ndarray, weight: np.ndarray, v: int) -> np.ndarray:
    """Discrete [V, V] link loads of node paths (native scatter-add)."""
    lib = _load()
    nodes = np.ascontiguousarray(nodes, np.int32)
    weight = np.ascontiguousarray(weight, np.float32)
    load = np.zeros((v, v), np.float32)
    if lib is None:  # numpy fallback (np.add.at)
        for h in range(nodes.shape[1] - 1):
            a, b = nodes[:, h], nodes[:, h + 1]
            sel = (a >= 0) & (b >= 0)
            np.add.at(load, (a[sel], b[sel]), weight[sel])
        return load
    f, l = nodes.shape
    lib.link_loads(nodes, weight, f, l, v, load)
    return load


def materialize_fdbs(
    paths: np.ndarray,
    port: np.ndarray,
    dpids: np.ndarray,
    dst_switch: np.ndarray,
    final_port: np.ndarray,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Batch fdb hop lists: returns (dpid [F, L] i64, port [F, L] i32,
    length [F] i32); length 0 = not installable (truncated/unreachable).
    ``dst_switch[i] = -1`` accepts any path endpoint."""
    lib = _load()
    paths = np.ascontiguousarray(paths, np.int32)
    port = np.ascontiguousarray(port, np.int32)
    dpids = np.ascontiguousarray(dpids, np.int64)
    dst_switch = np.ascontiguousarray(dst_switch, np.int32)
    final_port = np.ascontiguousarray(final_port, np.int32)
    f, l = paths.shape
    v = port.shape[0]
    if lib is None:
        out_dpid = np.full((f, l), -1, np.int64)
        out_port = np.full((f, l), -1, np.int32)
        out_len = np.zeros(f, np.int32)
        for i in range(f):
            row = paths[i][paths[i] >= 0]
            if len(row) == 0:
                continue
            if dst_switch[i] >= 0 and row[-1] != dst_switch[i]:
                continue
            # adjacency guard: a discontinuous path must not install
            # (port -1 means no such link) — same check as the C++ kernel
            if len(row) > 1 and (port[row[:-1], row[1:]] < 0).any():
                continue
            for h in range(len(row) - 1):
                out_dpid[i, h] = dpids[row[h]]
                out_port[i, h] = port[row[h], row[h + 1]]
            out_dpid[i, len(row) - 1] = dpids[row[-1]]
            out_port[i, len(row) - 1] = final_port[i]
            out_len[i] = len(row)
        return out_dpid, out_port, out_len
    # the library writes every cell, -1 past a row's hops
    out_dpid = np.empty((f, l), np.int64)
    out_port = np.empty((f, l), np.int32)
    out_len = np.empty(f, np.int32)
    lib.materialize_fdbs(
        paths, port, dpids, dst_switch, final_port, f, l, v,
        out_dpid, out_port, out_len,
    )
    return out_dpid, out_port, out_len


def group_pairs(
    src_idx: np.ndarray, dst_idx: np.ndarray, edge: np.ndarray, v: int
) -> Optional[tuple[np.ndarray, np.ndarray]]:
    """Fused endpoint->edge grouping over a dense [V^2] key space.

    Returns (key [F] int64 with -1 for unresolved pairs, counts_all
    [V^2] int64), or None when the C++ library is unavailable — the
    caller (oracle/engine.py) keeps the numpy formulation as fallback."""
    lib = _load()
    if lib is None:
        return None
    src_idx = np.ascontiguousarray(src_idx, np.int32)
    dst_idx = np.ascontiguousarray(dst_idx, np.int32)
    edge = np.ascontiguousarray(edge, np.int32)
    key = np.empty(len(src_idx), np.int64)
    counts_all = np.zeros(v * v, np.int64)
    lib.group_pairs(src_idx, dst_idx, edge, len(src_idx), v, counts_all, key)
    return key, counts_all


def _n_subflows(nsub: np.ndarray, sub_base: np.ndarray) -> int:
    """S, the sub-flow id space a deal writes into."""
    return int((sub_base + nsub).max(initial=0))


def deal_subflows_keyed(
    key: np.ndarray,
    src_idx: np.ndarray,
    dst_idx: np.ndarray,
    lookup: np.ndarray,
    nsub: np.ndarray,
    sub_base: np.ndarray,
) -> tuple[np.ndarray, np.ndarray]:
    """group_pairs' companion deal (see deal_subflows for the hash
    contract and the return); key < 0 pairs come back as -1 and are in
    no sub-flow's count. C++ only — callers without the library use the
    inv-based numpy path."""
    lib = _load()
    if lib is None:
        raise RuntimeError("deal_subflows_keyed requires the native library")
    nsub = np.ascontiguousarray(nsub, np.int32)
    sub_base = np.ascontiguousarray(sub_base, np.int64)
    out = np.empty(len(key), np.int32)
    members = np.zeros(_n_subflows(nsub, sub_base), np.int32)
    lib.deal_subflows_keyed(
        np.ascontiguousarray(key, np.int64),
        np.ascontiguousarray(src_idx, np.int32),
        np.ascontiguousarray(dst_idx, np.int32),
        np.ascontiguousarray(lookup, np.int64),
        nsub, sub_base, len(key), out, members,
    )
    return out, members


def deal_subflows(
    inv: np.ndarray,
    src_idx: np.ndarray,
    dst_idx: np.ndarray,
    nsub: np.ndarray,
    sub_base: np.ndarray,
) -> tuple[np.ndarray, np.ndarray]:
    """Deterministic hash deal of pairs onto their group's sub-flows.

    Returns ([F] int32 sub-flow ids, [S] int32 pairs dealt onto each
    sub-flow), S = ``max(sub_base + nsub)``. O(F), no sort; the same
    hash both here and in the C++ kernel so engines agree bit-for-bit,
    and the kernel counts a sub-flow's members where it deals them."""
    lib = _load()
    inv = np.ascontiguousarray(inv, np.int32)
    src_idx = np.ascontiguousarray(src_idx, np.int32)
    dst_idx = np.ascontiguousarray(dst_idx, np.int32)
    nsub = np.ascontiguousarray(nsub, np.int32)
    sub_base = np.ascontiguousarray(sub_base, np.int64)
    f = len(inv)
    n_sub = _n_subflows(nsub, sub_base)
    if lib is None:  # numpy fallback, identical hash
        h = (
            src_idx.astype(np.uint32) * np.uint32(2654435761)
        ) ^ (dst_idx.astype(np.uint32) * np.uint32(0x85EBCA77))
        out = (
            sub_base[inv] + (h % nsub[inv].astype(np.uint32)).astype(np.int64)
        ).astype(np.int32)
        return out, np.bincount(out, minlength=n_sub).astype(np.int32)
    out = np.empty(f, np.int32)
    members = np.zeros(n_sub, np.int32)
    lib.deal_subflows(inv, src_idx, dst_idx, nsub, sub_base, f, out, members)
    return out, members


def scatter_members(
    pair_sub: np.ndarray,
    src_idx: np.ndarray,
    dst_idx: np.ndarray,
    src_key_lut: np.ndarray,
    vmac_src_lut: np.ndarray,
    vmac_dst_lut: np.ndarray,
    rewrite_lut: np.ndarray,
    fport_lut: np.ndarray,
    vmac_base: int,
    n_subflows: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Counting-sort pairs by sub-flow, producing the contiguous member
    arrays the block install needs: (bounds [S+1] int64, src keys, vMAC
    keys, rewrite keys, final ports), each [F_routed] sorted so sub-flow
    s's members are rows bounds[s]:bounds[s+1]. Pairs with pair_sub < 0
    are dropped. All key production goes through per-endpoint LUTs."""
    lib = _load()
    pair_sub = np.ascontiguousarray(pair_sub, np.int32)
    src_idx = np.ascontiguousarray(src_idx, np.int32)
    dst_idx = np.ascontiguousarray(dst_idx, np.int32)
    src_key_lut = np.ascontiguousarray(src_key_lut, np.int64)
    vmac_src_lut = np.ascontiguousarray(vmac_src_lut, np.int64)
    vmac_dst_lut = np.ascontiguousarray(vmac_dst_lut, np.int64)
    rewrite_lut = np.ascontiguousarray(rewrite_lut, np.int64)
    fport_lut = np.ascontiguousarray(fport_lut, np.int32)
    f = len(pair_sub)
    if lib is None:  # numpy fallback: stable argsort + LUT gathers
        keep = pair_sub >= 0
        order = np.argsort(pair_sub[keep], kind="stable")
        si = src_idx[keep][order]
        di = dst_idx[keep][order]
        bounds = np.zeros(n_subflows + 1, np.int64)
        np.cumsum(
            np.bincount(pair_sub[keep], minlength=n_subflows), out=bounds[1:]
        )
        return (
            bounds,
            src_key_lut[si],
            vmac_base | vmac_src_lut[si] | vmac_dst_lut[di],
            rewrite_lut[di],
            fport_lut[di],
        )
    n_routed = int((pair_sub >= 0).sum())
    bounds = np.empty(n_subflows + 1, np.int64)
    m_src = np.empty(n_routed, np.int64)
    m_vmac = np.empty(n_routed, np.int64)
    m_rewrite = np.empty(n_routed, np.int64)
    m_fport = np.empty(n_routed, np.int32)
    lib.scatter_members(
        pair_sub, src_idx, dst_idx, src_key_lut, vmac_src_lut, vmac_dst_lut,
        rewrite_lut, fport_lut, vmac_base, f, n_subflows,
        bounds, m_src, m_vmac, m_rewrite, m_fport,
    )
    return bounds, m_src, m_vmac, m_rewrite, m_fport


def decode_announcements(buf: bytes) -> tuple[np.ndarray, np.ndarray]:
    """Batch-parse concatenated announcement records -> (types, ranks)."""
    lib = _load()
    data = np.frombuffer(bytes(buf), np.uint8)
    n_max = len(data) // 8
    if lib is None:
        recs = np.frombuffer(bytes(buf[: n_max * 8]), "<i4").reshape(-1, 2)
        ok = (recs[:, 0] == 0) | (recs[:, 0] == 1)
        return recs[ok, 0].astype(np.int32), recs[ok, 1].astype(np.int32)
    types = np.empty(n_max, np.int32)
    ranks = np.empty(n_max, np.int32)
    n = lib.decode_announcements(data, len(data), types, ranks)
    return types[:n], ranks[:n]


def encode_announcements(types: np.ndarray, ranks: np.ndarray) -> bytes:
    """Inverse of decode_announcements (batch wire encoding)."""
    lib = _load()
    types = np.ascontiguousarray(types, np.int32)
    ranks = np.ascontiguousarray(ranks, np.int32)
    if lib is None:
        out = np.empty((len(types), 2), "<i4")
        out[:, 0] = types
        out[:, 1] = ranks
        return out.tobytes()
    buf = np.empty(len(types) * 8, np.uint8)
    lib.encode_announcements(types, ranks, len(types), buf)
    return buf.tobytes()
