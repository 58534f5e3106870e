"""Device-runtime telemetry: device-memory watermarks and an
anomaly-armed profiler capture window, under the reference's metric
names.

The observability plane watches the *control plane*; this module
watches the *device runtime underneath it*:

- **Compile walls and compile-cache counters** — the reference fills
  ``jit_compile_seconds{kernel=...}``, ``compile_cache_hits_total``,
  ``compile_cache_misses_total`` and ``compile_cache_saved_seconds``
  from ``jax.monitoring`` listeners. The port's device programs are the
  CUDA kernels ``kernels/_build.py`` builds with ``nvcc``, once per
  source and flags, into a build directory a restarted process reuses
  (``oracle/engine.enable_compile_cache``): each build counts as a
  cache miss and each load of a library an earlier process built as a
  hit (:func:`note_kernel_build`, :func:`note_kernel_load`). The
  compile-wall histogram and the saved-seconds gauge have no torch
  source and stay at zero. :func:`install_monitoring` registers nothing
  and returns False, as the reference does on a JAX build without
  monitoring.
- **Device-memory watermarks** — :func:`sample_memory` reads
  ``torch.cuda.memory_stats`` / ``max_memory_allocated`` of a CUDA
  device into ``device_memory_in_use_bytes`` /
  ``device_memory_peak_bytes`` once per Monitor flush; on the CPU it
  reads process RSS (``device_memory_host_fallback = 1``), so the
  gauges never silently read 0.
- **Anomaly-armed profiler window** — :class:`ProfileCapture` opens a
  ``torch.profiler`` window for N seconds when a flight-recorder
  trigger fires and writes it as a Chrome trace under the dump
  directory: the profile of the incident, captured by the incident,
  with zero steady-state overhead.
"""

from __future__ import annotations

import logging
import pathlib
import time
from typing import Optional

from sdnmpi_tpu_torch.utils.metrics import REGISTRY

log = logging.getLogger("devprof")

#: compile walls span ~10 ms (tiny helper jits) to minutes (the DAG
#: engine at pod scale) — wider than the latency buckets
COMPILE_BUCKETS_S = (
    0.01, 0.03, 0.1, 0.3, 1.0, 3.0, 10.0, 30.0, 60.0, 180.0
)

_m_compile_s = REGISTRY.labeled_histogram(
    "jit_compile_seconds", "kernel", COMPILE_BUCKETS_S,
    "backend compile wall per instrumented kernel (the reference's "
    "jax.monitoring figure; no torch source feeds it)",
)
_m_cache_hits = REGISTRY.counter(
    "compile_cache_hits_total",
    "compiled programs loaded from the persistent compile cache",
)
_m_cache_misses = REGISTRY.counter(
    "compile_cache_misses_total",
    "compile requests the persistent cache could not serve",
)
_m_cache_saved = REGISTRY.gauge(
    "compile_cache_saved_seconds",
    "cumulative compile wall the persistent cache saved this process",
)
_m_mem_in_use = REGISTRY.gauge(
    "device_memory_in_use_bytes",
    "bytes in use across local devices (process RSS on the host "
    "fallback), sampled per Monitor flush",
)
_m_mem_peak = REGISTRY.gauge(
    "device_memory_peak_bytes",
    "high-watermark bytes across local devices (peak RSS on the host "
    "fallback)",
)
_m_mem_fallback = REGISTRY.gauge(
    "device_memory_host_fallback",
    "1 when the memory gauges read process RSS because the backend "
    "exposes no per-device memory stats (CPU), else 0",
)
_m_profile_captures = REGISTRY.counter(
    "profile_captures_total",
    "anomaly-armed torch.profiler capture windows opened",
)

def note_kernel_build() -> None:
    """A kernel's library was built (a compile-cache miss)."""
    _m_cache_misses.inc()


def note_kernel_load() -> None:
    """A library an earlier process built was loaded (a compile-cache
    hit)."""
    _m_cache_hits.inc()


def install_monitoring() -> bool:
    """The reference registers its ``jax.monitoring`` compile listeners
    here. PyTorch offers no compile-event stream, so nothing is
    registered and the compile metrics stay at zero: returns False, as
    the reference does when its JAX build has no monitoring module."""
    return False


def sample_memory(device=None) -> dict:
    """Sample memory watermarks into the gauges (one pass per Monitor
    flush): the CUDA caching allocator's figures when ``device`` is a
    CUDA device, process RSS otherwise. Returns the sampled figures."""
    import torch

    device = torch.device(device) if device is not None else None
    fallback = device is None or device.type != "cuda"
    if fallback:
        in_use, peak = _host_rss()
    else:
        stats = torch.cuda.memory_stats(device)
        in_use = int(stats.get("allocated_bytes.all.current", 0))
        peak = int(torch.cuda.max_memory_allocated(device))
    _m_mem_in_use.set(in_use)
    _m_mem_peak.set(peak)
    _m_mem_fallback.set(1.0 if fallback else 0.0)
    return {"in_use": in_use, "peak": peak, "fallback": fallback}


def _host_rss() -> tuple[int, int]:
    """(current RSS, peak RSS) of this process — the CPU-backend twin
    of the device watermarks, so the dev loop's gauges stay live."""
    current = peak = 0
    try:
        import resource

        # linux reports ru_maxrss in KiB
        peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    except Exception:  # pragma: no cover - platform-dependent
        pass
    try:
        with open("/proc/self/statm") as f:
            current = int(f.read().split()[1]) * 4096
    except Exception:  # pragma: no cover - platform-dependent
        current = peak
    return current, max(peak, current)


class ProfileCapture:
    """Anomaly-armed ``torch.profiler`` capture window.

    ``on_anomaly()`` opens a profiler window (once — re-triggering while
    a window is open extends nothing; the window that is already running
    IS the incident's profile) and ``tick()`` closes it after
    ``seconds``, writing a Chrome trace under ``dump_dir``. The
    Controller calls ``on_anomaly`` from the flight recorder's anomaly
    hook and ``tick`` per EventStatsFlush, so the stop needs no timer
    thread — at worst the window runs one Monitor interval long.
    ``close()`` stops an open window at shutdown so the trace file is
    always written."""

    def __init__(self, dump_dir: str, seconds: float = 3.0,
                 max_captures: int = 4, clock=time.monotonic) -> None:
        self.dump_dir = dump_dir
        self.seconds = float(seconds)
        self.max_captures = int(max_captures)
        self.clock = clock
        self.n_captures = 0
        self._t_open: Optional[float] = None
        self._prof = None

    @property
    def active(self) -> bool:
        return self._t_open is not None

    def on_anomaly(self, bundle: Optional[dict] = None) -> bool:
        """Open a capture window (no-op while one is open or after
        ``max_captures`` — a trigger storm must not fill the disk with
        profiles of the same incident). Returns True when opened."""
        if self._t_open is not None or self.n_captures >= self.max_captures:
            return False
        self._prof = _profiler()
        self._prof.__enter__()
        self._t_open = self.clock()
        self.n_captures += 1
        _m_profile_captures.inc()
        log.info("anomaly profiler capture opened under %s (%.1fs)",
                 self.dump_dir, self.seconds)
        return True

    def tick(self, now: Optional[float] = None) -> bool:
        """Close the window once ``seconds`` have elapsed (called per
        EventStatsFlush). Returns True when a window closed."""
        if self._t_open is None:
            return False
        now = self.clock() if now is None else now
        if now - self._t_open < self.seconds:
            return False
        return self.close()

    def close(self) -> bool:
        if self._t_open is None:
            return False
        self._t_open = None
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        path = write_chrome_trace(prof, self.dump_dir, "anomaly")
        log.info("anomaly profiler capture written to %s", path)
        return True


def _profiler():
    """A ``torch.profiler`` over the host and, when a card is present,
    the device."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def write_chrome_trace(prof, dump_dir: str, stem: str) -> pathlib.Path:
    """Export a finished profiler window as ``<stem>-<ns>.json`` under
    ``dump_dir`` (created when absent)."""
    out = pathlib.Path(dump_dir)
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"{stem}-{time.time_ns()}.json"
    prof.export_chrome_trace(str(path))
    return path
