"""Device-resident measured traffic matrix: the audit plane's per-row
counter deltas as a per-tenant src->dst byte-rate tensor.

Counterpart of ``sdnmpi_tpu/oracle/trafficplane.py`` on a torch device
(``Config.device``). The audit plane exports its measurement as scalar
rollups (``fabric_tenant_bytes_total``, per-cookie byte sums); this
module keeps the full measured traffic matrix, the offered-load input of
the route sentinel (``control/sentinel.py``), with the utilization
plane's idiom (``oracle/utilplane.py``) applied to measured traffic:

- A flat ``[T * P * P]`` f32 tensor lives on the device: tenant slot x
  source endpoint x destination endpoint, holding EWMA'd byte rates
  (bps). Endpoints are **pods** when ``Config.hier_oracle`` is on
  (``topogen/podmap.podmap_for_db``) and host-edge switches otherwise.
- The audit plane feeds it: every per-row byte delta that
  ``AuditPlane._attribute`` extracts from flow stats is staged here,
  but only when the audited switch is the flow's *source edge*, so each
  flow's bytes enter the matrix exactly once instead of once per hop.
- ``flush()`` (one per stats-flush sweep, after the audit sweep)
  converts staged bytes to rates over the measured interval on the host
  (Python floats, cast to f32 at upload) and folds them in with one
  bucket-padded EWMA scatter (``r' = (1 - a) * r + a * sample``,
  ``a = Config.traffic_ewma_alpha``; at ``a = 1`` the matrix holds the
  raw f32 rate, bit for bit). Cells that were active but saw no fresh
  bytes decay toward zero (pure removal at ``a = 1``) and are exactly
  cleared after a bounded number of silent rounds.
- **Epochs**: readers (sentinel, RPC, snapshot) see the published
  epoch while ingest writes the live buffer; ``flush`` publishes. Every
  update here builds a new tensor and never writes into one in place,
  so a published epoch stays unchanged when later flushes fold new
  rates in (the reference's arrays are immutable, which gives it the
  same guarantee).
- Index vectors are bucket-padded (``kernels/tiling.bucket_pad``) with
  the out-of-range index ``cap``: gathers clamp it, and every scatter
  writes the real entries only (an out-of-range ``index_put_`` is a
  device-side assert on the card).

Readers: ``matrix()`` is the JSON-safe pull-RPC payload
(``traffic_matrix()``), ``rates_by_pair()`` feeds the route sentinel
(one host read of the published tensor per epoch), ``state_dict()`` /
``load_state`` ride the ``api/snapshot`` checkpoint (the reference's
JSON) so a restart resumes the EWMA state.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from sdnmpi_tpu_torch.kernels.tiling import bucket_pad
from sdnmpi_tpu_torch.topogen.podmap import podmap_for_db
from sdnmpi_tpu_torch.utils.metrics import REGISTRY

_m_epoch = REGISTRY.gauge(
    "trafficplane_epoch", "published epoch of the measured traffic matrix"
)
_m_flushes = REGISTRY.counter(
    "trafficplane_flushes_total", "measured-rate scatter flushes"
)
_m_rebuilds = REGISTRY.counter(
    "trafficplane_rebuilds_total",
    "matrix capacity/endpoint-layout rebuilds",
)
_m_unmapped = REGISTRY.counter(
    "trafficplane_unmapped_total",
    "attributed byte deltas dropped for lack of an endpoint mapping",
)
_m_cells = REGISTRY.gauge(
    "trafficplane_active_cells", "nonzero cells in the published matrix"
)
_m_hot = REGISTRY.gauge(
    "trafficplane_hot_pair_bps",
    "hottest measured (tenant, src, dst) cell rate",
)
_m_tenant = REGISTRY.labeled_counter(
    "trafficplane_tenant_bytes_total",
    "tenant",
    "source-edge-attributed measured bytes folded into the matrix",
)

#: silent flushes before an active cell is exactly cleared (mirrors the
#: UtilPlane's stale-horizon policy: decay toward zero, then forget)
_DECAY_ROUNDS_MAX = 20


# -- cell updates ------------------------------------------------------------
#
# Index vectors arrive bucket-padded with an out-of-range sentinel
# (>= T*P*P) at their end, ``n`` real entries first: gathers clamp the
# pads and scatters write the first ``n`` only. Each update returns a
# new tensor (``index_put`` out of place), never writing its input.


def _scatter_ewma(live, idx, bps, n: int, keep, gain):
    """Fold one sweep's measured rates into the live matrix:
    ``live[idx] = live[idx] * keep + bps * gain``. With alpha = 1 this
    stores the raw measured rate, bit for bit."""
    old = live[torch.clamp(idx, max=live.shape[0] - 1)]
    new = old * keep + bps * gain
    return live.index_put((idx[:n],), new[:n])


def _clear_cells(live, idx, n: int):
    """Exactly zero cells whose flows have been silent past the decay
    horizon (a finished collective must stop steering the sentinel)."""
    return live.index_put((idx[:n],), live.new_zeros(n))


def _carry_cells(old_live, old_idx, new_idx, n: int, zeros):
    """Capacity/layout rebuild: gather surviving cells from the old
    flat layout and scatter into the new one, on the device."""
    vals = old_live[torch.clamp(old_idx, max=old_live.shape[0] - 1)]
    return zeros.index_put((new_idx[:n],), vals[:n])


def _hot_cell(live) -> float:
    """Max cell rate of the published matrix (the hot-pair gauge)."""
    return float(torch.max(live))


class TrafficPlane:
    """Measured per-tenant traffic matrix over pod or edge endpoints."""

    def __init__(self, db, config, clock=time.monotonic):
        self.db = db
        self.config = config
        self.clock = clock
        self.alpha = float(config.traffic_ewma_alpha)
        self.pod_mode = bool(config.hier_oracle)
        #: the torch oracle's device; the host backend keeps the matrix
        #: on the CPU, as the Controller's memory sampling does
        self.device = torch.device(
            config.device if config.oracle_backend == "torch" else "cpu"
        )
        self.epoch = 0
        self.flush_count = 0
        self.rebuild_count = 0
        # tenant slot 0 is reserved for unregistered traffic ("-")
        self._tenants: dict[str, int] = {"-": 0}
        self._tenant_names: list[str] = ["-"]
        self._t_cap = 8
        # endpoint slots: key is a pod id (pod mode) or a host-edge
        # switch dpid (flat mode); names are what bundles/RPC show
        self._ep_slots: dict[int, int] = {}
        self._ep_names: list[str] = []
        self._ep_cap = 8
        self._podmap = None
        self._pod_version = -1
        self._live = self._zeros()
        self._snap = self._live
        # staged bytes since the last flush, keyed by flat cell index
        self._staged: dict[int, float] = {}
        # cells currently nonzero in the live buffer, and how many
        # consecutive flushes each has gone without a fresh sample
        self._active: dict[int, int] = {}
        self._t_last: Optional[float] = None
        self._pair_cache: Optional[tuple[int, dict]] = None
        self._host_cache: Optional[tuple] = None

    # -- capacity ----------------------------------------------------------

    def _cells(self) -> int:
        return self._t_cap * self._ep_cap * self._ep_cap

    def _zeros(self):
        return torch.zeros(self._cells(), dtype=torch.float32, device=self.device)

    def _scalar(self, x: float):
        """An f32 0-d tensor on the matrix's device (the EWMA weights)."""
        return torch.tensor(x, dtype=torch.float32, device=self.device)

    def _put(self, arr):
        return torch.from_numpy(arr).to(self.device)

    def _host(self) -> np.ndarray:
        """The published epoch on the host: one device read per
        published tensor, shared by every reader of that epoch."""
        if self._host_cache is None or self._host_cache[0] is not self._snap:
            self._host_cache = (self._snap, self._snap.cpu().numpy())
        return self._host_cache[1]

    def _flat(self, t: int, s: int, d: int) -> int:
        return (t * self._ep_cap + s) * self._ep_cap + d

    def _unflat(self, i: int) -> tuple[int, int, int]:
        t, rem = divmod(i, self._ep_cap * self._ep_cap)
        s, d = divmod(rem, self._ep_cap)
        return t, s, d

    def _regrow(self, t_cap: int, ep_cap: int) -> None:
        """Grow to the new capacities, carrying live cells on device and
        remapping the staged/active host state to the new flat layout."""
        old_cap = self._ep_cap
        survivors = sorted(self._active)
        remap = {}
        for i in survivors:
            t, rem = divmod(i, old_cap * old_cap)
            s, d = divmod(rem, old_cap)
            remap[i] = (t * ep_cap + s) * ep_cap + d
        old_live = self._live
        self._t_cap, self._ep_cap = t_cap, ep_cap
        zeros = self._zeros()
        if survivors:
            cap = self._cells()
            old_idx, _ = bucket_pad(survivors, old_live.shape[0], cap)
            new_idx, _ = bucket_pad([remap[i] for i in survivors], cap, cap)
            self._live = _carry_cells(
                old_live, self._put(old_idx), self._put(new_idx),
                len(survivors), zeros,
            )
        else:
            self._live = zeros
        self._staged = {
            remap.get(i, self._remap_cold(i, old_cap)): v
            for i, v in self._staged.items()
        }
        self._active = {remap[i]: n for i, n in self._active.items()}
        self._pair_cache = None
        self.rebuild_count += 1
        _m_rebuilds.inc()

    def _remap_cold(self, i: int, old_cap: int) -> int:
        t, rem = divmod(i, old_cap * old_cap)
        s, d = divmod(rem, old_cap)
        return (t * self._ep_cap + s) * self._ep_cap + d

    def _tenant_slot(self, tenant: str) -> int:
        slot = self._tenants.get(tenant)
        if slot is not None:
            return slot
        if len(self._tenant_names) >= self._t_cap:
            self._regrow(self._t_cap * 2, self._ep_cap)
        slot = len(self._tenant_names)
        self._tenants[tenant] = slot
        self._tenant_names.append(tenant)
        return slot

    def _ep_slot(self, key: int, name: str) -> int:
        slot = self._ep_slots.get(key)
        if slot is not None:
            return slot
        if len(self._ep_names) >= self._ep_cap:
            self._regrow(self._t_cap, self._ep_cap * 2)
        slot = len(self._ep_names)
        self._ep_slots[key] = slot
        self._ep_names.append(name)
        return slot

    # -- endpoint mapping --------------------------------------------------

    def _refresh_podmap(self) -> None:
        if not self.pod_mode:
            return
        version = self.db.version
        if version == self._pod_version:
            return
        self._pod_version = version
        podmap = podmap_for_db(self.db, self.config.hier_pod_target)
        if podmap is None:
            return
        old = self._podmap
        self._podmap = podmap
        if old is not None and old.pod_of != podmap.pod_of:
            # pod ids renumbered: the old cells describe endpoints that
            # no longer mean the same thing. Forget and re-learn within
            # one sweep rather than attribute traffic to the wrong pod.
            self._staged.clear()
            self._active.clear()
            self._ep_slots.clear()
            self._ep_names = []
            self._live = self._zeros()
            self._pair_cache = None
            self.rebuild_count += 1
            _m_rebuilds.inc()

    def ep_of_mac(self, mac: str) -> Optional[int]:
        """Endpoint slot of a host mac, allocating on first sight."""
        host = self.db.hosts.get(mac)
        if host is None:
            return None
        dpid = host.port.dpid
        if not self.pod_mode:
            return self._ep_slot(dpid, f"sw{dpid}")
        self._refresh_podmap()
        if self._podmap is None:
            return None
        pod = self._podmap.pod_of.get(dpid)
        if pod is None:
            return None
        return self._ep_slot(pod, f"pod{pod}")

    def ep_name(self, mac: str) -> Optional[str]:
        """Endpoint name ("pod3" / "sw5") of a host mac, or None."""
        slot = self.ep_of_mac(mac)
        return self._ep_names[slot] if slot is not None else None

    # -- ingest ------------------------------------------------------------

    def ingest(
        self, dpid: int, src_mac: str, dst_mac: str, tenant: str, d_bytes: int
    ) -> None:
        """Stage one audited per-row byte delta. Counts only when
        ``dpid`` is the flow's source edge switch, so each flow's bytes
        enter the matrix exactly once, not once per audited hop."""
        src = self.db.hosts.get(src_mac)
        if src is None or src.port.dpid != dpid:
            return
        s = self.ep_of_mac(src_mac)
        d = self.ep_of_mac(dst_mac)
        if s is None or d is None:
            _m_unmapped.inc()
            return
        cell = self._flat(self._tenant_slot(tenant), s, d)
        self._staged[cell] = self._staged.get(cell, 0.0) + float(d_bytes)
        _m_tenant.inc(tenant, d_bytes)

    @property
    def has_staged(self) -> bool:
        return bool(self._staged)

    # -- flush / publish ---------------------------------------------------

    def flush(self, now: Optional[float] = None) -> int:
        """Fold the staged sweep into the matrix and publish a new
        epoch. Returns the number of cells scattered."""
        now = self.clock() if now is None else now
        dt = 1.0 if self._t_last is None else max(now - self._t_last, 1e-9)
        self._t_last = now
        idx: list[int] = []
        vals: list[float] = []
        clears: list[int] = []
        for cell, bts in self._staged.items():
            idx.append(cell)
            vals.append(bts / dt)
            self._active[cell] = 0
        for cell, silent in list(self._active.items()):
            if cell in self._staged:
                continue
            silent += 1
            if silent > _DECAY_ROUNDS_MAX or self.alpha >= 1.0:
                clears.append(cell)
                del self._active[cell]
            else:
                # EWMA decay toward zero: stage an explicit 0.0 sample
                idx.append(cell)
                vals.append(0.0)
                self._active[cell] = silent
        self._staged.clear()
        n = len(idx)
        cap = self._cells()
        if idx:
            pad_i, pad_v = bucket_pad(idx, cap, cap, vals)
            self._live = _scatter_ewma(
                self._live,
                self._put(pad_i),
                self._put(pad_v),
                n,
                self._scalar(1.0 - self.alpha),
                self._scalar(self.alpha),
            )
        if clears:
            pad_c, _ = bucket_pad(clears, cap, cap)
            self._live = _clear_cells(self._live, self._put(pad_c), len(clears))
        self._snap = self._live
        self.epoch += 1
        self.flush_count += 1
        self._pair_cache = None
        _m_epoch.set(float(self.epoch))
        _m_flushes.inc()
        _m_cells.set(float(len(self._active)))
        _m_hot.set(_hot_cell(self._snap) if self._active else 0.0)
        return n

    # -- readers -----------------------------------------------------------

    def matrix(self) -> dict:
        """JSON-safe published matrix (the ``traffic_matrix()`` pull-RPC
        payload and the snapshot/forensics view)."""
        host = self._host()
        cells = []
        for i in sorted(self._active):
            bps = float(host[i])
            if bps <= 0.0:
                continue
            t, s, d = self._unflat(i)
            cells.append(
                [
                    self._tenant_names[t],
                    self._ep_names[s],
                    self._ep_names[d],
                    bps,
                ]
            )
        return {
            "epoch": self.epoch,
            "mode": "pod" if self.pod_mode else "edge",
            "endpoints": list(self._ep_names),
            "cells": cells,
        }

    def rates_by_pair(self) -> dict[tuple[int, int], float]:
        """Published (src_slot, dst_slot) -> bps summed over tenants —
        the sentinel's measured weights. Cached per epoch."""
        if self._pair_cache is not None and self._pair_cache[0] == self.epoch:
            return self._pair_cache[1]
        host = self._host()
        out: dict[tuple[int, int], float] = {}
        for i in self._active:
            bps = float(host[i])
            if bps <= 0.0:
                continue
            _, s, d = self._unflat(i)
            out[(s, d)] = out.get((s, d), 0.0) + bps
        self._pair_cache = (self.epoch, out)
        return out

    def pair_bps(self, src_mac: str, dst_mac: str) -> float:
        """Published measured rate between two hosts' endpoints, summed
        over tenants (0.0 when either side is unmapped)."""
        s = self.ep_of_mac(src_mac)
        d = self.ep_of_mac(dst_mac)
        if s is None or d is None:
            return 0.0
        return self.rates_by_pair().get((s, d), 0.0)

    # -- snapshot ----------------------------------------------------------

    def state_dict(self) -> dict:
        """Checkpointable EWMA state, keyed by *names* (tenant, endpoint
        strings) so a restore survives slot-order drift."""
        host = self._host()
        cells = []
        for i, silent in sorted(self._active.items()):
            t, s, d = self._unflat(i)
            cells.append(
                [
                    self._tenant_names[t],
                    self._ep_names[s],
                    self._ep_names[d],
                    float(host[i]),
                    int(silent),
                ]
            )
        return {
            "mode": "pod" if self.pod_mode else "edge",
            "alpha": self.alpha,
            "epoch": self.epoch,
            "cells": cells,
        }

    def load_state(self, state: dict) -> int:
        """Seed the matrix from a checkpoint: re-resolve each named cell
        against the *current* endpoint tables and scatter the surviving
        rates in one batch. Returns the number of cells restored."""
        if state.get("mode") != ("pod" if self.pod_mode else "edge"):
            return 0
        # endpoint names are "sw<dpid>" / "pod<id>"; rebuild the slot
        # tables by re-registering each name's key
        idx: list[int] = []
        vals: list[float] = []
        for tenant, s_name, d_name, bps, silent in state.get("cells", ()):
            s = self._ep_restore(s_name)
            d = self._ep_restore(d_name)
            if s is None or d is None or bps <= 0.0:
                continue
            cell = self._flat(self._tenant_slot(tenant), s, d)
            idx.append(cell)
            vals.append(float(bps))
            self._active[cell] = int(silent)
        if idx:
            cap = self._cells()
            pad_i, pad_v = bucket_pad(idx, cap, cap, vals)
            self._live = _scatter_ewma(
                self._live,
                self._put(pad_i),
                self._put(pad_v),
                len(idx),
                self._scalar(0.0),
                self._scalar(1.0),
            )
            self._snap = self._live
            self.epoch += 1
            self._pair_cache = None
            _m_epoch.set(float(self.epoch))
            _m_cells.set(float(len(self._active)))
        return len(idx)

    def _ep_restore(self, name: str) -> Optional[int]:
        """Endpoint slot for a checkpointed name, validated against the
        live fabric (a pod/switch that no longer exists is dropped)."""
        if name.startswith("sw") and not self.pod_mode:
            try:
                dpid = int(name[2:])
            except ValueError:
                return None
            if dpid not in self.db.switches:
                return None
            return self._ep_slot(dpid, name)
        if name.startswith("pod") and self.pod_mode:
            self._refresh_podmap()
            if self._podmap is None:
                return None
            try:
                pod = int(name[3:])
            except ValueError:
                return None
            if pod >= self._podmap.n_pods:
                return None
            return self._ep_slot(pod, name)
        return None
