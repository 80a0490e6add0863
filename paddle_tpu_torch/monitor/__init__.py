"""paddle_tpu_torch.monitor — the port's metrics and tracing runtime, its
core.

Counterpart of ``paddle_tpu/monitor/__init__.py``'s core: one
process-global :class:`~paddle_tpu_torch.monitor.registry.Registry` of
counters, gauges and histograms, a JSONL event sink, and the span tracer
(:mod:`~paddle_tpu_torch.monitor.trace`). The serving tier reports
through it (:mod:`paddle_tpu_torch.serving.metrics`,
:mod:`paddle_tpu_torch.serving.reqtrace`). Off by default; every record
site is one ``enabled()`` check while it is off. ::

    from paddle_tpu_torch import monitor
    from paddle_tpu_torch.monitor import trace

    monitor.enable("chiprun_out/monitor")   # a directory or a *.jsonl path
    trace.enable()
    ... serve ...
    print(monitor.snapshot("serving.decode."))
    trace.export_chrome_trace("chiprun_out/monitor/trace.json")
    monitor.disable()                       # flushes a counters record

The port's monitor is its own: enabling it never enables the
reference's, and the reverse, also in one process. Its environment
variables carry the port's prefix:

* ``PADDLE_TPU_TORCH_MONITOR_DIR`` — the sink's directory (or
  ``*.jsonl`` path) when ``enable()`` gets none;
* ``PADDLE_TPU_TORCH_MONITOR_MAX_BYTES`` — the sink's rotation size;
* ``PADDLE_TPU_TORCH_TRACE=1`` — ``enable()`` also enables the tracer
  (``PADDLE_TPU_TORCH_TRACE_BRIDGE=1``: each span also enters
  ``torch.profiler.record_function``);
* ``PADDLE_TPU_TORCH_FLIGHT_DIR`` / ``PADDLE_TPU_TORCH_FLIGHT_MAX`` and
  ``PADDLE_TPU_TORCH_REQ_EXEMPLARS`` — the flight recorder's directory
  and cap, and the slow-request rings' size.

:mod:`~paddle_tpu_torch.monitor.xla` keeps the cost that
``Predictor.compile_report`` measures (its ``aot_capture``, ``hlo_text``,
``executable`` and ``measured_mfu`` raise).
:mod:`~paddle_tpu_torch.monitor.sampler` samples device memory, the host's
resident set and registered queue depths (``prefetch.queue_depth``) as
gauges, when started.

Not ported (ROADMAP.md Queue A item 20): the dispatch hook
(``time_dispatch``), ``serve`` (the ``/metrics`` endpoint), ``step`` /
``mfu``, ``export``, ``profile``, ``memory``, ``fleet`` and
``alerts``. The arguments and environment variables that
would start them (``time_dispatch=``, ``telemetry_dir=``,
``PADDLE_TPU_TORCH_MONITOR_TIME_DISPATCH``,
``PADDLE_TPU_TORCH_TELEMETRY_DIR``, ``PADDLE_TPU_TORCH_PROFILE``,
``PADDLE_TPU_TORCH_METRICS_PORT``) raise ``NotImplementedError``.
"""
from __future__ import annotations

import os
import time

from .registry import Registry, JsonlSink, read_jsonl  # noqa: F401

__all__ = ["enable", "disable", "enabled", "registry", "counter", "gauge",
           "histogram", "emit", "snapshot", "reset", "jsonl_path",
           "read_jsonl", "trace", "xla"]

ENV = "PADDLE_TPU_TORCH_"
_NOT_PORTED = "not ported yet (ROADMAP.md Queue A item 20)"
# environment variables that start parts of the monitor left out
_UNPORTED_ENV = ("MONITOR_TIME_DISPATCH", "TELEMETRY_DIR", "PROFILE",
                 "METRICS_PORT")

_registry = Registry()
_sink = None
_enabled = False


def env(name, default=""):
    """The port's environment variable ``PADDLE_TPU_TORCH_<name>``."""
    return os.environ.get(ENV + name, default)


# ---------------------------------------------------------------------------
# lifecycle

def enabled():
    return _enabled


def registry() -> Registry:
    return _registry


def jsonl_path():
    """The sink's file, or None (counters still collect in memory)."""
    return _sink.path if _sink is not None else None


def _resolve_sink_path(path):
    p = str(path)
    if p.endswith(".jsonl"):
        return p
    os.makedirs(p, exist_ok=True)
    return os.path.join(p, f"events-{os.getpid()}.jsonl")


def enable(path=None, time_dispatch=None, max_bytes=None,
           telemetry_dir=None):
    """Turn monitoring on. ``path`` is a directory (an
    ``events-<pid>.jsonl`` inside it) or a ``*.jsonl`` path, by default
    ``$PADDLE_TPU_TORCH_MONITOR_DIR``; with neither, the registry collects
    in memory only. ``max_bytes`` caps the sink, which then rotates
    (``$PADDLE_TPU_TORCH_MONITOR_MAX_BYTES``). Idempotent; a new path
    replaces the old sink. Returns the JSONL path (or None).
    ``time_dispatch`` and ``telemetry_dir`` raise ``NotImplementedError``
    when set (item 20), as do the environment variables that would set
    them."""
    global _enabled, _sink
    if time_dispatch:
        raise NotImplementedError(f"time_dispatch: {_NOT_PORTED}")
    if telemetry_dir:
        raise NotImplementedError(f"telemetry_dir: {_NOT_PORTED}")
    for name in _UNPORTED_ENV:
        if env(name) not in ("", "0"):
            raise NotImplementedError(f"{ENV}{name}: {_NOT_PORTED}")
    if max_bytes is None:
        max_bytes = int(env("MONITOR_MAX_BYTES")) \
            if env("MONITOR_MAX_BYTES") else None
    target = path or env("MONITOR_DIR") or None
    if target:
        fp = _resolve_sink_path(target)
        if (_sink is None or _sink.path != os.path.abspath(fp)
                or _sink.max_bytes != max_bytes):
            # close the old sink before the new one replaces it
            old, _sink = _sink, None
            if old is not None:
                old.close()
            _sink = JsonlSink(fp, max_bytes=max_bytes)
    _enabled = True
    if env("TRACE") not in ("", "0"):
        trace.enable()
    emit(kind="monitor", action="enable", pid=os.getpid(),
         time_dispatch=False)
    return jsonl_path()


def disable(flush_counters=True):
    """Turn monitoring off: emit a last counters record and close the
    sink. The registry keeps its values; :func:`reset` clears them."""
    global _enabled, _sink
    if flush_counters and _enabled:
        emit(kind="counters", counters=snapshot())
    _enabled = False
    if _sink is not None:
        _sink.close()
        _sink = None


# ---------------------------------------------------------------------------
# metric and event surface

def counter(name):
    return _registry.counter(name)


def gauge(name):
    return _registry.gauge(name)


def histogram(name, buckets=None):
    return _registry.histogram(name, buckets=buckets)


def snapshot(prefix=""):
    return _registry.snapshot(prefix)


def reset():
    _registry.reset()


def emit(kind="event", **fields):
    """Append one JSONL record (a no-op without a sink)."""
    if _sink is not None:
        rec = {"ts": time.time(), "kind": kind}
        rec.update(fields)
        _sink.emit(rec)


# imported last: the tracer reaches back into this namespace (env, and in
# the flight recorder emit, snapshot and jsonl_path)
from . import trace, xla  # noqa: E402,F401
