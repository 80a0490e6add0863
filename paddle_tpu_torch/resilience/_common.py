"""Shared event plumbing for paddle_tpu_torch.resilience.

Counterpart of ``paddle_tpu/resilience/_common.py``. Every recovery
action funnels through :func:`record`: a counter ``resilience.<event>``
plus a JSONL record ``{"kind": "resilience", "event": <event>, ...}``
on the port's monitor, while it is on.
"""
from __future__ import annotations

from .. import monitor as _monitor


def record(event, **fields):
    """Count and emit one resilience event (a no-op while the monitor is
    off)."""
    if _monitor.enabled():
        _monitor.counter(f"resilience.{event}").inc()
        _monitor.emit(kind="resilience", event=event, **fields)
