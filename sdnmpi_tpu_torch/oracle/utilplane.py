"""Device-resident utilization plane: the Monitor's samples as an oracle
input with no per-call host rebuild.

Counterpart of ``sdnmpi_tpu/oracle/utilplane.py`` on a torch device.
Without it every balanced, adaptive or collective routing call rebuilds
the ``[V, V]`` utilization matrix on the host from the TopologyManager's
``link_util`` dict and uploads it (``oracle/congestion.utilization_matrix``).
The plane keeps it on the device instead:

- A flat ``[V * V]`` f32 tensor, updated in place by one scatter per
  sample batch. Monitor samples stage into a host dict (the latest per
  ``(dpid, port)``) and flush as a ``(flat link index, bps)`` batch,
  bucket-padded (``kernels/tiling.bucket_pad``); the pads clamp at the
  gathers and are sliced away before the scatters.
- Samples fold in by EWMA, ``u' = u * (1 - a) + sample * a`` with
  ``a = Config.util_ewma_alpha``; the default ``a = 1`` stores the raw
  f32 sample, bit-equal to the host rebuild. A link with no fresh sample
  keeps its value, as the host dict does; with
  ``Config.util_stale_horizon_s`` such a link halves per flush past the
  horizon and snaps to zero after 20 halvings.
- Epochs: routing reads the published epoch (:meth:`snapshot`,
  :meth:`base`), a copy taken at each publish, while ingest keeps
  writing the live buffer.
- The ``(dpid, port) -> flat index`` map rides the TopologyDB's delta
  log: link deltas remap keys and zero exactly the affected slots; only
  a structural break (a switch leaving, a log overflow, the node set
  growing) rebuilds the map, and the rebuild carries the surviving
  links' values over on the device.

``RouteOracle._normalized_base`` takes a plane and returns its
``(snapshot / cap) * alpha * share`` as a device tensor, cached per
epoch and scale.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from sdnmpi_tpu_torch.kernels.tiling import bucket_pad
from sdnmpi_tpu_torch.utils.metrics import REGISTRY

_m_epoch = REGISTRY.gauge(
    "utilplane_epoch", "published epoch of the device utilization plane"
)
_m_flushes = REGISTRY.counter(
    "utilplane_flushes_total", "staged-sample scatter flushes"
)
_m_decays = REGISTRY.counter(
    "utilplane_decays_total", "stale-horizon slot decays (halvings + clears)"
)
_m_repairs = REGISTRY.counter(
    "utilplane_repairs_total", "link slots repaired through the delta log"
)
_m_rebuilds = REGISTRY.counter(
    "utilplane_rebuilds_total", "structural index-map rebuilds"
)


# -- slot updates ------------------------------------------------------------
#
# Index vectors arrive bucket-padded with an out-of-range sentinel
# (>= V * V) at their end, ``n`` real entries first: gathers clamp the
# pads and scatters write the first ``n`` only.


def _scatter_ewma(live, idx, bps, n: int, keep, gain) -> None:
    """``live[idx] = live[idx] * keep + bps * gain`` for the real
    entries, in place (keep = 1 - alpha, gain = alpha, f32 scalars)."""
    old = live[torch.clamp(idx, max=live.shape[0] - 1)]
    new = old * keep + bps * gain
    live[idx[:n]] = new[:n]


def _clear_slots(live, idx, n: int) -> None:
    """Zero the slots of removed or rewired links (exactly)."""
    live[idx[:n]] = 0.0


def _decay_slots(live, idx, n: int, factor) -> None:
    """Scale the slots of stale links by ``factor``."""
    real = idx[:n]
    live[real] = live[real] * factor


def _carry_slots(old_live, old_idx, new_idx, n: int, zeros):
    """Structural rebuild: the surviving links' values gathered from the
    old layout and written into the new one (``zeros``)."""
    vals = old_live[torch.clamp(old_idx, max=old_live.shape[0] - 1)]
    zeros[new_idx[:n]] = vals[:n]
    return zeros


def _topk_hot(live, k: int):
    """The ``k`` largest values of the flat buffer and their flat indices,
    descending, the lower index first among equal values (the order of
    ``jax.lax.top_k``): a stable descending sort, whose tie order is
    defined on every device (``torch.topk`` promises none)."""
    vals, idx = torch.sort(live, descending=True, stable=True)
    return vals[:k], idx[:k]


def _scale_base(live, cap, alpha, share):
    """The normalized base cost from the flat snapshot:
    ``(util / cap) * alpha * share``, three f32 operations in that order,
    as the host path computes it. The scalars are 0-d f32 tensors on the
    buffer's device: a true division by a tensor, never the reciprocal
    multiply a CUDA division by a host scalar becomes."""
    v = math.isqrt(live.shape[0])
    return (live.reshape(v, v) / cap) * alpha * share


class UtilPlane:
    """Device-resident per-link utilization state (see module docstring).

    Lifecycle: :meth:`stage` per Monitor sample (host dict, O(1));
    :meth:`sync` absorbs topology deltas through the delta log (binding
    or rebuilding needs the oracle's ``tensors``); :meth:`flush` scatters
    the staged batch and publishes a new epoch; :meth:`base` and
    :meth:`snapshot` read the published epoch. The oracle drives sync,
    flush and base from ``_normalized_base``; the TopologyManager also
    flushes on the Monitor's end-of-pass edge. The buffer lives on the
    device of the tensors it was bound to."""

    #: halvings before a stale link snaps to exact zero and its decay
    #: clock drops
    _DECAY_ROUNDS_MAX = 20

    def __init__(
        self, ewma_alpha: float = 1.0, stale_horizon_s: float = 0.0
    ) -> None:
        self.ewma_alpha = float(ewma_alpha)
        #: seconds after which a link with no fresh sample decays toward
        #: zero (halved per flush past the horizon); 0 keeps the last sample
        self.stale_horizon_s = float(stale_horizon_s)
        #: published-epoch counter; bumps once per publish
        self.epoch = 0
        self._staged: dict[tuple[int, int], float] = {}
        #: clock of each key's last flushed sample (stale horizon armed)
        self._last_sample: dict[tuple[int, int], float] = {}
        #: halvings applied per stale key since its last fresh sample
        self._decay_rounds: dict[tuple[int, int], int] = {}
        #: (dpid, port_no) -> flat index into the [V * V] buffer
        self._key_to_flat: dict[tuple[int, int], int] = {}
        self._flat_to_key: dict[int, tuple[int, int]] = {}
        self._dpid_row: dict[int, int] = {}
        self._row_dpid: dict[int, int] = {}
        self._v = 0
        self._device: Optional[torch.device] = None
        self._live: Optional[torch.Tensor] = None  # [V * V] f32
        self._snap: Optional[torch.Tensor] = None  # published epoch
        self._version: Optional[int] = None  # TopologyDB version of the map
        #: (alpha, cap, share) -> scaled [V, V] base, cleared per epoch
        self._base_cache: dict[tuple, torch.Tensor] = {}
        self.rebuild_count = 0
        self.repair_count = 0
        self.flush_count = 0
        self.decay_count = 0

    @property
    def bound(self) -> bool:
        return self._live is not None

    def _put_idx(self, idx: np.ndarray, vals: Optional[np.ndarray] = None):
        """Bucket-pad a flat-index batch with the sentinel ``V * V`` and
        upload it: ``(idx, vals or None, n real)``."""
        cap = self._v * self._v
        out, v = bucket_pad(idx, cap, cap, vals)
        put = lambda a: torch.as_tensor(a).to(self._device)  # noqa: E731
        return put(out.astype(np.int64)), None if v is None else put(v), len(idx)

    def _scalar(self, x: float) -> torch.Tensor:
        return torch.tensor(x, dtype=torch.float32, device=self._device)

    # -- ingest -----------------------------------------------------------

    def stage(self, key: tuple[int, int], bps: float) -> None:
        """Stage one (dpid, port_no) -> bps sample for the next flush; a
        later sample for the same key overwrites it."""
        self._staged[key] = float(bps)

    @property
    def has_staged(self) -> bool:
        """True while samples wait for a flush. The route cache treats the
        plane as uncacheable then: an uncached dispatch would flush them
        and route on a new epoch."""
        return bool(self._staged)

    def drop(self, key: tuple[int, int]) -> None:
        """Forget a staged sample and its decay clock (its link died)."""
        self._staged.pop(key, None)
        self._last_sample.pop(key, None)
        self._decay_rounds.pop(key, None)

    def flush(self, now: Optional[float] = None) -> None:
        """Scatter the staged batch into the live buffer, decay links
        whose last sample fell off the stale horizon, and publish a new
        epoch when anything changed. Staged keys with no mapped link are
        discarded, as the host rebuild ignores them. ``now`` defaults to
        ``time.monotonic()``. No-op before binding."""
        if self._live is None:
            return
        changed = False
        horizon = self.stale_horizon_s
        if horizon > 0 and now is None:
            import time

            now = time.monotonic()
        if self._staged:
            idx: list[int] = []
            bps: list[float] = []
            for key, val in self._staged.items():
                flat = self._key_to_flat.get(key)
                if flat is not None:
                    idx.append(flat)
                    bps.append(val)
                    if horizon > 0:
                        self._last_sample[key] = now
                        self._decay_rounds.pop(key, None)
            self._staged.clear()
            if idx:
                idx_p, bps_p, n = self._put_idx(
                    np.asarray(idx, np.int32), np.asarray(bps, np.float32)
                )
                _scatter_ewma(
                    self._live, idx_p, bps_p, n,
                    self._scalar(1.0 - self.ewma_alpha),
                    self._scalar(self.ewma_alpha),
                )
                self.flush_count += 1
                _m_flushes.inc()
                changed = True
        if horizon > 0 and self._last_sample:
            halve: list[int] = []
            clear: list[int] = []
            for k, ts in list(self._last_sample.items()):
                if now - ts < horizon or k not in self._key_to_flat:
                    continue
                rounds = self._decay_rounds.get(k, 0) + 1
                if rounds >= self._DECAY_ROUNDS_MAX:
                    clear.append(self._key_to_flat[k])
                    self._last_sample.pop(k)
                    self._decay_rounds.pop(k, None)
                else:
                    self._decay_rounds[k] = rounds
                    halve.append(self._key_to_flat[k])
            if halve:
                idx_p, _, n = self._put_idx(np.asarray(sorted(halve), np.int32))
                _decay_slots(self._live, idx_p, n, self._scalar(0.5))
            if clear:
                idx_p, _, n = self._put_idx(np.asarray(sorted(clear), np.int32))
                _clear_slots(self._live, idx_p, n)
            if halve or clear:
                self.decay_count += len(halve) + len(clear)
                _m_decays.inc(len(halve) + len(clear))
                changed = True
        if changed or self._snap is None:
            self._publish()

    # -- topology repair seam ---------------------------------------------

    def sync(self, db, tensors=None) -> bool:
        """Bring the link-index map (and the affected slots) up to
        ``db.version`` through the delta log. Returns True when the plane
        is current; False when it needs ``tensors`` to (re)bind and none
        were given (staged samples wait for the next sync)."""
        if self._version == db.version and self._live is not None:
            return True
        if self._live is None:
            if tensors is None:
                return False
            self._rebuild(tensors, db.version)
            return True
        deltas_since = getattr(db, "deltas_since", None)
        deltas = deltas_since(self._version) if deltas_since else None
        if deltas is None:
            if tensors is None:
                return False
            self._rebuild(tensors, db.version)
            return True
        dead: list[int] = []
        for entry in deltas:
            kind = entry[1]
            if kind == "switch_upsert":
                continue  # port-set refresh: the link map is untouched
            if kind in ("switch_new", "host"):
                if entry[2] not in self._dpid_row:
                    # the node set grew: rows shift, the map is invalid
                    if tensors is None:
                        return False
                    self._rebuild(tensors, db.version)
                    return True
                continue
            if kind == "link+":
                _, _, a, b, port_no = entry
                ia = self._dpid_row.get(a)
                ib = self._dpid_row.get(b)
                if ia is None or ib is None:
                    if tensors is None:
                        return False
                    self._rebuild(tensors, db.version)
                    return True
                flat = ia * self._v + ib
                # a fresh link or a rewire: no sample yet under the key,
                # so the slot reads zero until the Monitor speaks
                self._remap(flat, (a, port_no))
                dead.append(flat)
            elif kind == "link-":
                _, _, a, b = entry
                ia = self._dpid_row.get(a)
                ib = self._dpid_row.get(b)
                if ia is None or ib is None:
                    if tensors is None:
                        return False
                    self._rebuild(tensors, db.version)
                    return True
                flat = ia * self._v + ib
                old = self._flat_to_key.pop(flat, None)
                # drop the forward mapping only if it still points at this
                # slot: under add-before-remove re-cabling the key already
                # rebound to its new slot and must survive
                if old is not None and self._key_to_flat.get(old) == flat:
                    self._key_to_flat.pop(old, None)
                dead.append(flat)
            else:  # unknown delta kind
                if tensors is None:
                    return False
                self._rebuild(tensors, db.version)
                return True
        if dead:
            idx_p, _, n = self._put_idx(np.asarray(sorted(set(dead)), np.int32))
            _clear_slots(self._live, idx_p, n)
            self.repair_count += len(dead)
            _m_repairs.inc(len(dead))
            self._publish()
        self._version = db.version
        return True

    def _remap(self, flat: int, key: tuple[int, int]) -> None:
        old = self._flat_to_key.get(flat)
        if old is not None and old != key:
            self._key_to_flat.pop(old, None)
        prev = self._key_to_flat.get(key)
        if prev is not None and prev != flat:
            # the key moved slots: clear its old slot's reverse entry so a
            # later removal of that slot cannot strip the live mapping
            if self._flat_to_key.get(prev) == key:
                self._flat_to_key.pop(prev, None)
        self._key_to_flat[key] = flat
        self._flat_to_key[flat] = key

    def _rebuild(self, tensors, version: int) -> None:
        """(Re)bind to a TopoTensors snapshot: rebuild the index maps from
        the port matrix and carry the surviving links' values over on
        the device."""
        port = tensors.host_port()
        dpids = tensors.dpids
        v = tensors.v
        new_map: dict[tuple[int, int], int] = {}
        rows, cols = np.nonzero(port >= 0)
        for r, c in zip(rows.tolist(), cols.tolist()):
            new_map[(int(dpids[r]), int(port[r, c]))] = r * v + c

        old_live, old_map = self._live, self._key_to_flat
        self._device = tensors.adj.device
        self._v = v
        zeros = torch.zeros(v * v, dtype=torch.float32, device=self._device)
        if old_live is not None and old_map:
            common = [k for k in new_map if k in old_map]
            if common:
                old_idx = np.fromiter(
                    (old_map[k] for k in common), np.int32, len(common)
                )
                new_idx = np.fromiter(
                    (new_map[k] for k in common), np.int32, len(common)
                )
                old_p, _, n = self._put_idx(old_idx)
                new_p, _, _ = self._put_idx(new_idx)
                zeros = _carry_slots(old_live.to(self._device), old_p, new_p, n, zeros)
        self._live = zeros
        self._key_to_flat = new_map
        self._flat_to_key = {f: k for k, f in new_map.items()}
        self._dpid_row = dict(tensors.index)
        self._row_dpid = {r: d for d, r in self._dpid_row.items()}
        self._version = version
        self.rebuild_count += 1
        _m_rebuilds.inc()
        self._publish()

    # -- reads (published epoch) ------------------------------------------

    def _publish(self) -> None:
        self._snap = self._live.clone()
        self.epoch += 1
        _m_epoch.set(self.epoch)
        self._base_cache.clear()

    def snapshot(self) -> torch.Tensor:
        """``[V, V]`` device view of the published epoch's raw bps."""
        return self._snap.reshape(self._v, self._v)

    def hot_links(self, k: int = 8) -> list[dict]:
        """Top-k hottest directed links of the published epoch, as
        ``[{"src", "dst", "port", "bps"}, ...]``, descending, the lower
        flat index first among equal loads, idle links dropped. ``port``
        is -1 for a slot with no mapped link key."""
        if self._snap is None:
            return []
        k = max(1, min(int(k), self._v * self._v))
        vals, idx = _topk_hot(self._snap, k)
        out: list[dict] = []
        for bps, flat in zip(vals.cpu().tolist(), idx.cpu().tolist()):
            if bps <= 0.0:
                break  # sorted: the rest are idle slots
            key = self._flat_to_key.get(int(flat))
            out.append({
                "src": self._row_dpid.get(int(flat) // self._v, -1),
                "dst": self._row_dpid.get(int(flat) % self._v, -1),
                "port": -1 if key is None else int(key[1]),
                "bps": float(bps),
            })
        return out

    def base(self, alpha: float, cap: float, share: float) -> torch.Tensor:
        """Normalized ``[V, V]`` base-cost tensor of the published epoch,
        cached per (epoch, scale); at most 8 scales are kept."""
        key = (float(alpha), float(cap), float(share))
        hit = self._base_cache.get(key)
        if hit is None:
            if len(self._base_cache) >= 8:
                self._base_cache.clear()
            hit = _scale_base(
                self._snap, self._scalar(cap), self._scalar(alpha),
                self._scalar(share),
            )
            self._base_cache[key] = hit
        return hit
