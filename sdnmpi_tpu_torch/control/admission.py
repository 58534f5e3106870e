"""Per-tenant admission control for the serving plane.

Multi-tenant fairness under non-uniform offered load is exactly the
regime where serving throughput collapses without admission control
(Throughput-Optimized Networks at Scale, arxiv 2605.27963): one
tenant's alltoall storm fills the route pipeline and every other
tenant's latency-sensitive request queues behind it. The Router gates
every packet-in through an :class:`AdmissionControl` of per-tenant
token buckets: a tenant is whatever the operator registered the source
MAC under (:meth:`AdmissionControl.assign`; unregistered MACs are their
own tenant), each tenant refills at ``Config.admission_rate`` requests
per second (a per-tenant override is possible) up to a burst depth of
``Config.admission_burst``, and a request arriving to an empty bucket
is dropped at the door — before any routing work — and counted in
``admission_rejections_total{tenant=...}``. ``admission_rate=0`` (the
default) admits everything: the pre-serving-plane behavior,
byte-identical.

Open-loop consequence (the config-14 harness measures it): with
admission off, offered load past capacity grows the coalescer queue
without bound and EVERY tenant's p99 diverges; with it on, the
aggressor is clipped at its admitted rate and the victim's p99 stays
within a small factor of its unloaded latency.
"""

from __future__ import annotations

import time
from typing import Optional

from sdnmpi_tpu_torch.utils.metrics import REGISTRY

_m_rejections = REGISTRY.labeled_counter(
    "admission_rejections_total", "tenant",
    "packet-ins dropped at the admission gate, per tenant",
)
_m_admitted = REGISTRY.counter(
    "admission_admitted_total",
    "packet-ins past the admission gate while rate limiting was armed",
)


class TokenBucket:
    """Continuous-refill token bucket: ``rate`` tokens/s up to
    ``burst``. ``take`` is two float ops on the hot path."""

    __slots__ = ("rate", "burst", "tokens", "t")

    def __init__(self, rate: float, burst: float, now: float) -> None:
        self.rate = float(rate)
        self.burst = max(1.0, float(burst))
        self.tokens = self.burst  # a fresh tenant may burst immediately
        self.t = now

    def take(self, now: float, n: float = 1.0) -> bool:
        self.tokens = min(self.burst, self.tokens + (now - self.t) * self.rate)
        self.t = now
        if self.tokens >= n:
            self.tokens -= n
            return True
        return False


class AdmissionControl:
    """Per-tenant packet-in rate limiting for the Router.

    ``rate == 0`` disables the gate entirely (every request admitted,
    zero bookkeeping — the escape hatch the byte-identity pin
    rides on). Buckets are created lazily per tenant on first arrival.
    """

    def __init__(self, rate: float = 0.0, burst: float = 32.0) -> None:
        self.rate = float(rate)
        self.burst = float(burst)
        #: src MAC -> tenant name (unregistered MACs tenant as themselves)
        self._tenants: dict[str, str] = {}
        #: tenant -> rate override (None = Config.admission_rate)
        self._rates: dict[str, float] = {}
        self._buckets: dict[str, TokenBucket] = {}

    def assign(
        self, mac: str, tenant: str, rate: Optional[float] = None
    ) -> None:
        """Bind a source MAC to a tenant (idempotent); ``rate``
        optionally overrides the uniform per-tenant rate for it."""
        self._tenants[mac] = tenant
        if rate is not None:
            self._rates[tenant] = float(rate)
            self._buckets.pop(tenant, None)  # rebuild at the new rate

    def tenant_of(self, mac: str) -> str:
        return self._tenants.get(mac, mac)

    def admit(self, src_mac: str, now: Optional[float] = None) -> bool:
        """True iff the tenant behind ``src_mac`` has a token; a False
        increments the tenant's rejection counter. With no rate armed
        (globally and for this tenant) this is one dict miss + compare."""
        tenant = self._tenants.get(src_mac, src_mac)
        rate = self._rates.get(tenant, self.rate)
        if rate <= 0:
            return True
        now = time.monotonic() if now is None else now
        bucket = self._buckets.get(tenant)
        if bucket is None:
            bucket = self._buckets[tenant] = TokenBucket(
                rate, self.burst, now
            )
        if bucket.take(now):
            _m_admitted.inc()
            return True
        _m_rejections.inc(tenant)
        return False

    def rejections(self, tenant: str) -> int:
        """Current rejection count for one tenant (loadgen reads this
        synchronously around each injection to attribute drops)."""
        return _m_rejections.values.get(tenant, 0)
