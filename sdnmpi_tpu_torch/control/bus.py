"""In-process event bus.

Replaces Ryu's app event machinery (synchronous ``send_request`` /
``reply_to_request`` and pub/sub ``send_event_to_observers`` /
``@set_ev_cls`` — see reference: sdnmpi/router.py:151,185,189 and
sdnmpi/rpc_interface.py:42-72) with a deterministic single-threaded
dispatcher: requests dispatch directly to the one registered handler for
the request type; events fan out synchronously to every subscriber in
registration order. The reference achieves the same data-race-freedom via
eventlet green threads; here it's by construction.
"""

from __future__ import annotations

import logging
from collections import defaultdict
from typing import Callable, Type

from sdnmpi_tpu_torch.control.events import Event, Reply, Request

log = logging.getLogger(__name__)


class EventBus:
    def __init__(self) -> None:
        self._request_handlers: dict[Type[Request], Callable[[Request], Reply]] = {}
        self._subscribers: dict[Type[Event], list[Callable[[Event], None]]] = (
            defaultdict(list)
        )
        #: wildcard observers: called with EVERY published event, after
        #: the typed subscribers (observability taps, e.g. the JSONL
        #: event log — utils/event_log.py)
        self._taps: list[Callable[[Event], None]] = []

    def tap(self, handler: Callable[[Event], None]) -> None:
        self._taps.append(handler)

    # -- request/reply ----------------------------------------------------

    def provide(
        self, request_type: Type[Request], handler: Callable[[Request], Reply]
    ) -> None:
        if request_type in self._request_handlers:
            raise ValueError(f"handler already registered for {request_type.__name__}")
        self._request_handlers[request_type] = handler

    def request(self, req: Request) -> Reply:
        handler = self._request_handlers.get(type(req))
        if handler is None:
            raise LookupError(f"no handler for {type(req).__name__}")
        return handler(req)

    # -- pub/sub ----------------------------------------------------------

    def subscribe(
        self, event_type: Type[Event], handler: Callable[[Event], None]
    ) -> None:
        self._subscribers[event_type].append(handler)

    def publish(self, event: Event) -> None:
        # taps BEFORE subscribers: handlers publish derived events
        # synchronously from inside this dispatch, and the event log must
        # record the cause ahead of its effects for offline causal replay
        for tap in self._taps:
            try:
                tap(event)
            except Exception:
                log.exception("tap %r failed on %s", tap, type(event).__name__)
        for handler in list(self._subscribers[type(event)]):
            try:
                handler(event)
            except Exception:  # one bad observer must not break the rest
                log.exception(
                    "subscriber %r failed on %s", handler, type(event).__name__
                )
