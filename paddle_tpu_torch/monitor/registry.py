"""paddle_tpu_torch.monitor.registry — metric primitives and the JSONL event
sink.

Counterpart of ``paddle_tpu/monitor/registry.py``: counters, gauges and
histograms keyed by dotted names, every mutation behind one lock, and a
line-buffered JSONL sink, so that a run leaves a machine-readable record
a later tool can read without running anything again. Pure Python: the
same records give the same snapshot as the reference's registry.

Not ported (ROADMAP.md Queue A item 20): the exporter and fleet views of
a registry (``Histogram.openmetrics``/``export``,
``Registry.export_snapshot``/``collect``), which serve the ``/metrics``
endpoint and the cross-process aggregator.
"""
from __future__ import annotations

import json
import os
import threading
import time
import warnings


class Counter:
    """Monotonic counter: ``inc`` only; a negative increment raises."""

    kind = "counter"

    def __init__(self, name, lock):
        self.name = name
        self._lock = lock
        self._value = 0

    def inc(self, n=1):
        if n < 0:
            raise ValueError(f"counter {self.name}: negative inc {n}")
        with self._lock:
            self._value += n
        return self

    @property
    def value(self):
        return self._value

    def snapshot(self):
        return self._value


class Gauge:
    """Last-write-wins scalar."""

    kind = "gauge"

    def __init__(self, name, lock):
        self.name = name
        self._lock = lock
        self._value = None

    def set(self, v):
        with self._lock:
            self._value = float(v)
        return self

    @property
    def value(self):
        return self._value

    def snapshot(self):
        return self._value


# the reference's default bounds: ns-scale timings through multi-GB counts
_DEFAULT_BUCKETS = tuple(4.0 ** e for e in range(-10, 18))


class Histogram:
    """Bucketed distribution: count, sum, min, max and bucket counts (an
    observation lands in the first bound >= its value; past the last
    bound, in the overflow)."""

    kind = "histogram"

    def __init__(self, name, lock, buckets=None):
        self.name = name
        self._lock = lock
        self.buckets = tuple(sorted(buckets or _DEFAULT_BUCKETS))
        self._counts = [0] * (len(self.buckets) + 1)
        self.count = 0
        self.sum = 0.0
        self.min = None
        self.max = None

    def observe(self, v):
        v = float(v)
        with self._lock:
            self.count += 1
            self.sum += v
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)
            for i, b in enumerate(self.buckets):
                if v <= b:
                    self._counts[i] += 1
                    break
            else:
                self._counts[-1] += 1
        return self

    @property
    def mean(self):
        return self.sum / self.count if self.count else 0.0

    def snapshot(self):
        out = {"count": self.count, "sum": self.sum, "min": self.min,
               "max": self.max}
        # only the populated buckets
        out["buckets"] = {
            ("inf" if i == len(self.buckets) else repr(self.buckets[i])): c
            for i, c in enumerate(self._counts) if c}
        return out


class Registry:
    """Name -> metric. One RLock guards creation and every mutation;
    asking for a name under another type raises."""

    def __init__(self):
        self._lock = threading.RLock()
        self._metrics = {}

    def _get_or_create(self, name, cls, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, self._lock, **kw)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}")
            return m

    def counter(self, name) -> Counter:
        return self._get_or_create(name, Counter)

    def gauge(self, name) -> Gauge:
        return self._get_or_create(name, Gauge)

    def histogram(self, name, buckets=None) -> Histogram:
        return self._get_or_create(name, Histogram, buckets=buckets)

    def get(self, name):
        return self._metrics.get(name)

    def remove(self, name):
        """Drop one metric by exact name; True when something went."""
        with self._lock:
            return self._metrics.pop(name, None) is not None

    def clear_prefix(self, prefix):
        """Drop every metric under a dotted prefix; returns how many."""
        if not prefix:
            return 0
        with self._lock:
            doomed = [n for n in self._metrics if n.startswith(prefix)]
            for n in doomed:
                del self._metrics[n]
        return len(doomed)

    def value(self, name, default=0):
        """A counter's or gauge's value; a histogram's snapshot dict;
        ``default`` for a missing name."""
        m = self._metrics.get(name)
        if m is None:
            return default
        if isinstance(m, Histogram):
            return m.snapshot()
        return m.value

    def names(self, prefix=""):
        with self._lock:
            return sorted(n for n in self._metrics if n.startswith(prefix))

    def snapshot(self, prefix=""):
        """``{name: scalar or dict}`` for every metric under ``prefix``."""
        with self._lock:
            return {n: m.snapshot() for n, m in sorted(self._metrics.items())
                    if n.startswith(prefix)}

    def reset(self):
        with self._lock:
            self._metrics.clear()


#: rotated generations a size-capped sink keeps (path.1, path.2)
SINK_ROTATIONS = 2


class JsonlSink:
    """Append-only JSONL writer: every record gets a wall-clock ``ts``;
    writes are line-atomic under a lock and flushed at once, so a killed
    run keeps what it emitted. Past ``max_bytes`` the file rotates
    (``path`` -> ``path.1`` -> ``path.2``, the oldest dropped) and
    ``path`` starts afresh."""

    def __init__(self, path, max_bytes=None):
        self.path = os.path.abspath(path)
        self.max_bytes = int(max_bytes) if max_bytes else None
        self.rotations = 0
        parent = os.path.dirname(self.path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self._lock = threading.Lock()
        self._fh = open(self.path, "a", encoding="utf-8")
        self._size = self._fh.tell()

    def _rotate_locked(self):
        self._fh.close()
        for gen in range(SINK_ROTATIONS, 1, -1):
            older = f"{self.path}.{gen - 1}"
            if os.path.exists(older):
                os.replace(older, f"{self.path}.{gen}")
        os.replace(self.path, f"{self.path}.1")
        self._fh = open(self.path, "a", encoding="utf-8")
        self._size = 0
        self.rotations += 1

    def emit(self, record: dict):
        record.setdefault("ts", time.time())
        line = json.dumps(record, default=str)
        with self._lock:
            if self._fh is None:
                return
            self._fh.write(line + "\n")
            self._fh.flush()
            if self.max_bytes is not None:
                self._size += len(line) + 1
                if self._size > self.max_bytes:
                    self._rotate_locked()

    def close(self):
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


def read_jsonl(path):
    """A sink file as a list of dicts; an unparseable line (a killed run's
    truncated last write) is skipped with a warning."""
    out = []
    with open(path, encoding="utf-8") as fh:
        for lineno, line in enumerate(fh, 1):
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                warnings.warn(
                    f"read_jsonl: skipping unparseable line {lineno} of "
                    f"{path} (truncated write from a killed run?)")
    return out
