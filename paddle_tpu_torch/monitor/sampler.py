"""paddle_tpu_torch.monitor.sampler — the periodic memory and queue-depth
sampler.

Counterpart of ``paddle_tpu/monitor/sampler.py``. The rest of the monitor
is driven by events; what a live run's operator asks about state (how
close device memory is to its limit, whether the host leaks, how deep a
queue is now) must be sampled. :func:`sample_once`, and the
:class:`Sampler` thread every ``interval_s`` (default 1 s), publish as
gauges:

* ``mem.device.<i>.{bytes_in_use,peak_bytes_in_use,bytes_limit,
  hbm_headroom_bytes}`` for each CUDA card, from the caching allocator
  (``torch.cuda.memory_stats``) and the card's total
  (``torch.cuda.mem_get_info``), and the totals ``mem.hbm_bytes_in_use``,
  ``mem.hbm_peak_bytes_in_use`` and ``mem.hbm_headroom_bytes``. Without a
  card no ``mem.device.*`` gauge is published, as the reference publishes
  none for its CPU backend. With the tracer on, each sample also drops an
  ``hbm.bytes_in_use`` counter sample under the spans;
* ``mem.host.rss_bytes``, the process's resident set (VmRSS, else
  getrusage's peak);
* every registered provider's series (``prefetch.queue_depth`` for each
  live ``io.prefetch_to_device``);
* the serving tier's rollups and fleet gauges, but only where
  ``paddle_tpu_torch.serving.metrics`` or ``.multi`` is already imported.

A provider is ``fn() -> {series: number}``; one that returns ``None`` or
raises has lost its owner and is dropped. Nothing here runs unless
:func:`start` (or a :class:`Sampler`) is started. The reference's host
headroom gauge reads its ``memory_plan``, which is not ported (ROADMAP.md
Queue A item 20); the port publishes no ``mem.host.headroom_bytes``.
"""
from __future__ import annotations

import os
import sys
import threading

__all__ = ["Sampler", "start", "stop", "active", "sample_once",
           "register_provider", "unregister_provider",
           "device_memory_stats"]

DEFAULT_INTERVAL_S = 1.0

_providers_lock = threading.Lock()
_providers = {}           # key -> fn() -> {series: value} | None

_lock = threading.Lock()
_sampler = None           # the singleton of start() / stop()


def register_provider(key, fn):
    """Register a per-tick gauge source. Returns ``key`` (hand it to
    :func:`unregister_provider`); registering a key again replaces it."""
    with _providers_lock:
        _providers[str(key)] = fn
    return str(key)


def unregister_provider(key):
    with _providers_lock:
        _providers.pop(str(key), None)


def _poll_providers(reg):
    with _providers_lock:
        items = list(_providers.items())
    dead = []
    for key, fn in items:
        try:
            series = fn()
        except Exception:
            series = None
        if series is None:
            dead.append(key)
            continue
        for name, value in series.items():
            if value is not None:
                reg.gauge(name).set(value)
    if dead:
        with _providers_lock:
            for key in dead:
                _providers.pop(key, None)


def device_memory_stats():
    """``{card index: {bytes_in_use, peak_bytes_in_use, bytes_limit}}``
    for the cards PyTorch has initialised; ``{}`` without one."""
    import torch
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return {}
    out = {}
    for i in range(torch.cuda.device_count()):
        st = torch.cuda.memory_stats(i)
        _, total = torch.cuda.mem_get_info(i)
        out[i] = {"bytes_in_use": st.get("allocated_bytes.all.current", 0),
                  "peak_bytes_in_use": st.get("allocated_bytes.all.peak", 0),
                  "bytes_limit": total}
    return out


def _host_rss_bytes():
    """Linux VmRSS (current), else getrusage's ru_maxrss (the peak), else
    None."""
    try:
        with open("/proc/self/status", encoding="ascii",
                  errors="replace") as fh:
            for line in fh:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except Exception:
        pass
    try:
        import resource
        rss_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        # Linux reports KiB, macOS bytes
        return int(rss_kb) * (1 if rss_kb > 1 << 30 else 1024)
    except Exception:
        return None


def sample_once(registry=None):
    """One tick, also callable from tests: device memory, host RSS, the
    providers' series and the serving rollups. Publishes into the registry
    whether or not the monitor is enabled, as the reference does."""
    from .. import monitor as _mon
    reg = registry if registry is not None else _mon.registry()

    total_use = total_peak = total_headroom = 0
    have = False
    for did, stats in device_memory_stats().items():
        if not stats:
            continue
        have = True
        for key, value in stats.items():
            reg.gauge(f"mem.device.{did}.{key}").set(value)
        headroom = stats["bytes_limit"] - stats["bytes_in_use"]
        reg.gauge(f"mem.device.{did}.hbm_headroom_bytes").set(headroom)
        total_use += stats["bytes_in_use"]
        total_peak += stats["peak_bytes_in_use"]
        total_headroom += headroom
    if have:
        reg.gauge("mem.hbm_bytes_in_use").set(total_use)
        reg.gauge("mem.hbm_peak_bytes_in_use").set(total_peak)
        reg.gauge("mem.hbm_headroom_bytes").set(total_headroom)
        from . import trace as _trace
        if _trace.enabled():
            _trace.counter("hbm.bytes_in_use", bytes=total_use)

    rss = _host_rss_bytes()
    if rss is not None:
        reg.gauge("mem.host.rss_bytes").set(rss)

    _poll_providers(reg)

    # the serving tier's series, only where it is already loaded
    for name, fn in (("paddle_tpu_torch.serving.metrics", "publish_rollups"),
                     ("paddle_tpu_torch.serving.multi", "publish_gauges")):
        mod = sys.modules.get(name)
        if mod is not None:
            try:
                getattr(mod, fn)()
            except Exception:
                pass


class Sampler:
    """A daemon thread calling :func:`sample_once` every ``interval_s``;
    ``stop()`` joins it with a timeout."""

    def __init__(self, interval_s=DEFAULT_INTERVAL_S):
        self.interval_s = float(interval_s)
        self._stop = threading.Event()
        self._thread = None

    def start(self):
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="paddle_tpu_torch-sampler",
                daemon=True)
            self._thread.start()
        return self

    def stop(self, timeout=5.0):
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=timeout)
            self._thread = None

    def running(self):
        return self._thread is not None and self._thread.is_alive()

    def _run(self):
        # the first sample at once: a read right after start() already
        # sees the gauges
        while True:
            try:
                sample_once()
            except Exception:
                pass  # a failing read must not end the sampler
            if self._stop.wait(self.interval_s):
                return


def start(interval_s=None):
    """Start (or return) the process's sampler;
    ``$PADDLE_TPU_TORCH_SAMPLER_INTERVAL_S`` sets its interval when
    ``interval_s`` is not given."""
    global _sampler
    if interval_s is None:
        env = os.environ.get("PADDLE_TPU_TORCH_SAMPLER_INTERVAL_S", "")
        interval_s = float(env) if env else DEFAULT_INTERVAL_S
    with _lock:
        if _sampler is None:
            _sampler = Sampler(interval_s=interval_s).start()
        return _sampler


def stop(timeout=5.0):
    """Stop and join the process's sampler (idempotent)."""
    global _sampler
    with _lock:
        s, _sampler = _sampler, None
    if s is not None:
        s.stop(timeout=timeout)


def active():
    return _sampler
