"""paddle_tpu_torch.monitor.trace — thread-aware span tracing and the flight
recorder.

Counterpart of ``paddle_tpu/monitor/trace.py``. Nested ``span("name")``
context managers record begin/end events into a bounded ring buffer, one
track a thread; resource lanes (a KV slot, the arena) get tracks of their
own; :func:`export_chrome_trace` writes Chrome trace-event JSON that
Perfetto and ``chrome://tracing`` load. Disabled (the default), ``span()``
is one flag check that returns a shared null context manager: no event,
no clock read. Enabled, a span edge costs one ``perf_counter()`` and one
deque append. No event reads the card: a span adds no launch and no
synchronisation.

With ``bridge=True`` (or ``PADDLE_TPU_TORCH_TRACE_BRIDGE=1``) each span
also enters ``torch.profiler.record_function``, so the same names appear
in a ``torch.profiler`` trace (``tools.decode_loadgen --profile``,
``tools.bench_bert --profile``), where the reference enters
``jax.profiler.TraceAnnotation``.

The flight recorder (:func:`flight_record`) dumps the buffered spans as a
Chrome trace, the counter snapshot and the slowest requests' records
into a stamped directory. The reference also writes the last executable's
HLO and its op and memory ledgers there; those parts of the monitor are
not ported (ROADMAP.md Queue A item 20).
"""
from __future__ import annotations

import collections
import functools
import json
import os
import re
import sys
import tempfile
import threading
import time

from . import env as _env

__all__ = [
    "enable", "disable", "enabled", "clear", "span", "complete",
    "instant", "counter", "traced", "events", "export_chrome_trace",
    "flight_record", "last_flight", "flow_start", "flow_step",
    "flow_end", "lane_complete", "lane_instant", "lanes",
]

DEFAULT_BUFFER = 65536

_CLOCK = time.perf_counter

_active = False
_bridge = False
_events = collections.deque(maxlen=DEFAULT_BUFFER)
_thread_names = {}          # thread ident -> name (the first event's)
_t0 = 0.0                   # perf_counter origin of the export's times
_wall0 = 0.0                # the wall clock at enable
_flight_lock = threading.Lock()
_flight_dumps = 0
_last_flight = None

# tracks that belong to a resource rather than a thread: their ids sit
# where no thread ident (a pointer-sized value) does
_LANE_BASE = 1 << 20
_lanes = {}                 # lane name -> track id
_lane_lock = threading.Lock()


def last_flight():
    """The newest flight-recorder directory this process wrote, or None."""
    return _last_flight


# ---------------------------------------------------------------------------
# lifecycle

def enabled():
    return _active


def enable(buffer_size=None, bridge=None):
    """Turn span recording on. ``buffer_size`` resizes the ring buffer
    (old events fall off its front); ``bridge=True`` also enters
    ``torch.profiler.record_function`` for each span. Idempotent."""
    global _active, _bridge, _events, _t0, _wall0
    if buffer_size:
        _events = collections.deque(_events, maxlen=int(buffer_size))
    if bridge is None:
        bridge = _env("TRACE_BRIDGE") not in ("", "0")
    _bridge = bool(bridge)
    if not _active:
        _t0 = _CLOCK()
        _wall0 = time.time()
        _active = True
    _note_thread(threading.get_ident())


def disable():
    """Stop recording; the buffer stays for a later export
    (:func:`clear` empties it)."""
    global _active
    _active = False


def clear():
    global _flight_dumps, _last_flight
    _events.clear()
    _thread_names.clear()
    with _lane_lock:
        _lanes.clear()
    _flight_dumps = 0
    _last_flight = None


def _note_thread(tid):
    if tid not in _thread_names:
        _thread_names[tid] = threading.current_thread().name


# ---------------------------------------------------------------------------
# recording

class _NullSpan:
    """The shared disabled-mode context manager."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()


def _annotation(name):
    import torch
    return torch.profiler.record_function(name)


class _Span:
    __slots__ = ("name", "args", "_ann")

    def __init__(self, name, args):
        self.name = name
        self.args = args
        self._ann = None

    def __enter__(self):
        tid = threading.get_ident()
        if tid not in _thread_names:
            _note_thread(tid)
        _events.append(("B", self.name, tid, _CLOCK(), self.args))
        if _bridge:
            try:
                self._ann = _annotation(self.name)
                self._ann.__enter__()
            except Exception:
                self._ann = None
        return self

    def __exit__(self, *exc):
        if self._ann is not None:
            try:
                self._ann.__exit__(*exc)
            except Exception:
                pass
            self._ann = None
        _events.append(("E", self.name, threading.get_ident(), _CLOCK()))
        return False


def span(name, **args):
    """``with trace.span("serving.enqueue", depth=n): ...`` records a
    begin/end pair on the calling thread's track."""
    if not _active:
        return _NULL
    return _Span(name, args or None)


def complete(name, t0, t1=None, **args):
    """An interval timed already (``perf_counter`` stamps) on the calling
    thread's track."""
    if not _active:
        return
    t1 = _CLOCK() if t1 is None else t1
    tid = threading.get_ident()
    if tid not in _thread_names:
        _note_thread(tid)
    _events.append(("X", name, tid, t0, t1 - t0, args or None))


def instant(name, **args):
    """A zero-duration marker."""
    if not _active:
        return
    tid = threading.get_ident()
    if tid not in _thread_names:
        _note_thread(tid)
    _events.append(("I", name, tid, _CLOCK(), args or None))


def counter(name, values=None, ts=None, **kw):
    """A Chrome counter sample: ``values`` (dict) and keyword series
    render as a stacked counter track; ``ts=`` dates the sample on the
    ``perf_counter`` timeline."""
    if not _active:
        return
    vals = dict(values) if values else {}
    if kw:
        vals.update(kw)
    if not vals:
        return
    tid = threading.get_ident()
    if tid not in _thread_names:
        _note_thread(tid)
    _events.append(("C", name, tid, _CLOCK() if ts is None else ts, vals))


def _flow(kind, name, fid, args):
    if not _active:
        return
    tid = threading.get_ident()
    if tid not in _thread_names:
        _note_thread(tid)
    _events.append((kind, name, tid, _CLOCK(), int(fid), args or None))


def flow_start(name, fid, **args):
    """Open flow ``fid`` (an arrow chain) at the innermost open span on
    this thread."""
    _flow("FS", name, fid, args)


def flow_step(name, fid, **args):
    """Continue flow ``fid`` at the enclosing span."""
    _flow("FT", name, fid, args)


def flow_end(name, fid, **args):
    """End flow ``fid`` at the enclosing span."""
    _flow("FF", name, fid, args)


def _lane_tid(lane):
    with _lane_lock:
        tid = _lanes.get(lane)
        if tid is None:
            tid = _LANE_BASE + len(_lanes)
            _lanes[lane] = tid
            _thread_names[tid] = lane
        return tid


def lanes():
    """Lane names -> their track ids."""
    with _lane_lock:
        return dict(_lanes)


def lane_complete(lane, name, t0, t1=None, **args):
    """An interval timed already on a named resource lane (a KV slot held
    by a request, a prefill), on the clock ``span()`` uses."""
    if not _active:
        return
    t1 = _CLOCK() if t1 is None else t1
    _events.append(("X", name, _lane_tid(lane), t0, t1 - t0, args or None))


def lane_instant(lane, name, ts=None, **args):
    """A zero-duration marker on a resource lane (the arena's growth)."""
    if not _active:
        return
    _events.append(("I", name, _lane_tid(lane),
                    _CLOCK() if ts is None else ts, args or None))


def traced(name=None):
    """Decorator: ``@trace.traced`` or ``@trace.traced("label")``."""
    def deco(fn):
        label = name if isinstance(name, str) else \
            getattr(fn, "__qualname__", getattr(fn, "__name__", "fn"))

        @functools.wraps(fn)
        def wrapped(*a, **k):
            if not _active:
                return fn(*a, **k)
            with _Span(label, None):
                return fn(*a, **k)
        return wrapped
    if callable(name):       # bare @traced
        return deco(name)
    return deco


def events(last=None):
    """The ring buffer's events (tuples, newest last); ``last=N``, only
    the last N."""
    evs = list(_events)
    return evs[-int(last):] if last else evs


# ---------------------------------------------------------------------------
# export

def _us(t):
    return round((t - _t0) * 1e6, 3)


def export_chrome_trace(path=None, last=None):
    """The buffer as Chrome trace-event JSON: one ``pid``, a ``tid`` track
    a thread or lane (named by ``thread_name`` metadata), ``B``/``E``
    pairs for spans, ``X`` for intervals timed already, ``i`` for
    markers, ``C`` for counters and ``s``/``t``/``f`` for flows.
    ``path=None`` returns the dict; a directory gets a
    ``trace-<pid>.json``; another path is written as given. Returns the
    written path (or the dict)."""
    pid = os.getpid()
    out = [{"ph": "M", "pid": pid, "tid": 0, "name": "process_name",
            "args": {"name": f"paddle_tpu_torch[{pid}]"}}]
    for tid, tname in sorted(_thread_names.items()):
        out.append({"ph": "M", "pid": pid, "tid": tid,
                    "name": "thread_name", "args": {"name": tname}})
    for ev in events(last=last):
        kind = ev[0]
        if kind == "B":
            _, name, tid, t, args = ev
            rec = {"ph": "B", "pid": pid, "tid": tid, "name": name,
                   "ts": _us(t), "cat": "span"}
        elif kind == "E":
            _, name, tid, t = ev
            rec = {"ph": "E", "pid": pid, "tid": tid, "name": name,
                   "ts": _us(t), "cat": "span"}
            args = None
        elif kind == "X":
            _, name, tid, t, dur, args = ev
            rec = {"ph": "X", "pid": pid, "tid": tid, "name": name,
                   "ts": _us(t), "dur": round(max(0.0, dur) * 1e6, 3),
                   "cat": "op"}
        elif kind == "C":
            _, name, tid, t, args = ev
            rec = {"ph": "C", "pid": pid, "tid": tid, "name": name,
                   "ts": _us(t), "cat": "counter"}
        elif kind in ("FS", "FT", "FF"):
            _, name, tid, t, fid, args = ev
            rec = {"ph": {"FS": "s", "FT": "t", "FF": "f"}[kind],
                   "pid": pid, "tid": tid, "name": name,
                   "ts": _us(t), "id": fid, "cat": "flow"}
            if kind == "FF":
                # bind to the enclosing slice
                rec["bp"] = "e"
        else:
            _, name, tid, t, args = ev
            rec = {"ph": "i", "pid": pid, "tid": tid, "name": name,
                   "ts": _us(t), "s": "t", "cat": "marker"}
        if args:
            rec["args"] = args
        out.append(rec)
    doc = {"traceEvents": out, "displayTimeUnit": "ms",
           "otherData": {"epoch_wall_s": _wall0, "pid": pid}}
    if path is None:
        return doc
    p = str(path)
    if not p.endswith(".json"):
        os.makedirs(p, exist_ok=True)
        p = os.path.join(p, f"trace-{pid}.json")
    else:
        parent = os.path.dirname(os.path.abspath(p))
        if parent:
            os.makedirs(parent, exist_ok=True)
    with open(p, "w", encoding="utf-8") as fh:
        json.dump(doc, fh, default=str)
    return os.path.abspath(p)


# ---------------------------------------------------------------------------
# flight recorder

def flight_record(reason, step=None, directory=None, extra=None):
    """Dump post-mortem evidence into a stamped directory and return its
    path (None when capped or when anything fails: the recorder never
    adds a second crash to the first)::

        <base>/<stamp>-<reason>-<pid>-<n>/
            meta.json           reason, step, pid, sink path, extra
            counters.json       the registry's snapshot
            trace.json          the span buffer as a Chrome trace
            slow_requests.json  the slowest requests' records (if any)

    ``base`` is ``directory``, else ``$PADDLE_TPU_TORCH_FLIGHT_DIR``, else
    a ``flight/`` beside the monitor's JSONL sink, else the temporary
    directory; at most ``$PADDLE_TPU_TORCH_FLIGHT_MAX`` (8) dumps a
    process."""
    global _flight_dumps, _last_flight
    try:
        from . import emit as _memit
        from . import jsonl_path as _mpath
        from . import snapshot as _msnap
        try:
            cap = int(_env("FLIGHT_MAX", "8") or 8)
        except ValueError:
            cap = 8
        with _flight_lock:
            if _flight_dumps >= cap:
                return None
            _flight_dumps += 1
            n = _flight_dumps
        base = directory or _env("FLIGHT_DIR")
        if not base:
            jp = _mpath()
            base = (os.path.join(os.path.dirname(jp), "flight") if jp
                    else os.path.join(tempfile.gettempdir(),
                                      "paddle_tpu_torch_flight"))
        stamp = time.strftime("%Y%m%d-%H%M%S")
        safe_reason = re.sub(r"[^A-Za-z0-9_.-]+", "_", str(reason))
        d = os.path.join(base, f"{stamp}-{safe_reason}-{os.getpid()}-{n}")
        os.makedirs(d, exist_ok=True)
        meta = {"reason": str(reason), "step": step, "ts": time.time(),
                "pid": os.getpid(), "jsonl": _mpath(),
                "trace_enabled": _active, "events_buffered": len(_events)}
        if extra:
            meta["extra"] = {str(k): v for k, v in dict(extra).items()}
        with open(os.path.join(d, "meta.json"), "w",
                  encoding="utf-8") as fh:
            json.dump(meta, fh, default=str, indent=1)
        with open(os.path.join(d, "counters.json"), "w",
                  encoding="utf-8") as fh:
            json.dump(_msnap(), fh, default=str, indent=1)
        export_chrome_trace(os.path.join(d, "trace.json"))
        # the slowest requests' waterfalls, where the request traces are
        # loaded (looked up, so that the monitor never imports serving)
        try:
            rq = sys.modules.get("paddle_tpu_torch.serving.reqtrace")
            if rq is not None:
                ex = rq.exemplars()
                if ex.get("worst_ttft") or ex.get("worst_tpot"):
                    with open(os.path.join(d, "slow_requests.json"), "w",
                              encoding="utf-8") as fh:
                        json.dump(ex, fh, default=str, indent=1)
        except Exception:
            pass
        _memit(kind="flight_record", reason=str(reason), step=step, path=d)
        _last_flight = d
        return d
    except Exception:
        return None
