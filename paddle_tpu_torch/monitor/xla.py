"""paddle_tpu_torch.monitor.xla — the measured cost of a compiled entry.

Counterpart of ``paddle_tpu/monitor/xla.py``'s store: :func:`analyze`,
:func:`capture`, :func:`get`, :func:`flops`, :func:`bytes_accessed`,
:func:`peak_memory`, :func:`labels`, :func:`last` and :func:`reset`, under
the reference's names, gauges (``xla.flops.<label>``,
``xla.bytes_accessed.<label>``, ``xla.peak_memory.<label>``) and JSONL
event (``xla_cost``), in the port's monitor. The reference reads XLA's
``cost_analysis()`` and ``memory_analysis()`` of an AOT executable; the
port has no compiler to ask, so what it captures is any object with the
same two methods, returning dicts: ``Predictor.compile_report``'s
counts, taken by PyTorch's flop counter and a byte-counting dispatch mode
over one forward, and the CUDA allocator's peak over the signature's
first run and capture.

Not ported (ROADMAP.md Queue A item 20): ``aot_capture``, ``hlo_text``,
``executable`` and ``measured_mfu``, which raise ``NotImplementedError``.
"""
from __future__ import annotations

import threading

__all__ = ["analyze", "capture", "aot_capture", "get", "flops",
           "bytes_accessed", "peak_memory", "labels", "last", "hlo_text",
           "executable", "measured_mfu", "reset"]

MAX_ENTRIES = 64
_NOT_PORTED = "not ported yet (ROADMAP.md Queue A item 20)"

_lock = threading.Lock()
_entries = {}       # label -> analysis dict
_order = []         # labels, oldest first (insertion/refresh order)


def analyze(compiled):
    """The cost and memory of ``compiled`` as a dict (``flops``,
    ``bytes_accessed``, ``transcendentals``, ``peak_memory``: those it
    reports), from its ``cost_analysis()`` (XLA's key names) and
    ``memory_analysis()`` (``{"peak_memory": bytes}``). Never raises;
    negative or missing values are dropped."""
    info = {}
    for method, keys in (("cost_analysis", (
            ("flops", "flops"), ("bytes accessed", "bytes_accessed"),
            ("transcendentals", "transcendentals"))),
            ("memory_analysis", (("peak_memory", "peak_memory"),))):
        try:
            d = getattr(compiled, method)()
        except Exception:  # noqa: BLE001 - best effort, as the reference's
            d = None
        if isinstance(d, (list, tuple)) and d:
            d = d[0]
        if not isinstance(d, dict):
            continue
        for src, dst in keys:
            v = d.get(src)
            if v is not None and float(v) >= 0:
                info[dst] = float(v)
    return info


def capture(label, compiled):
    """Analyze and store under ``label`` (the newest entry is
    :func:`last`); with the monitor on, set the ``xla.*`` gauges and emit
    one ``xla_cost`` record. Returns the analysis dict."""
    label = str(label)
    info = analyze(compiled)
    with _lock:
        if label in _order:
            _order.remove(label)
        _order.append(label)
        _entries[label] = info
        while len(_order) > MAX_ENTRIES:
            _entries.pop(_order.pop(0), None)
    from . import emit, enabled, gauge
    if enabled():
        for key, series in (("flops", "xla.flops"),
                            ("bytes_accessed", "xla.bytes_accessed"),
                            ("peak_memory", "xla.peak_memory")):
            if key in info:
                gauge(f"{series}.{label}").set(info[key])
        emit(kind="xla_cost", label=label, **info)
    return info


def get(label=None):
    """The analysis dict for ``label`` (default: the newest), or None."""
    with _lock:
        if label is None:
            if not _order:
                return None
            label = _order[-1]
        return _entries.get(str(label))


def flops(label=None):
    info = get(label)
    return info.get("flops") if info else None


def bytes_accessed(label=None):
    info = get(label)
    return info.get("bytes_accessed") if info else None


def peak_memory(label=None):
    info = get(label)
    return info.get("peak_memory") if info else None


def labels():
    with _lock:
        return list(_order)


def last():
    """``(label, analysis)`` of the newest capture, or None."""
    with _lock:
        if not _order:
            return None
        label = _order[-1]
        return label, _entries.get(label)


def reset():
    with _lock:
        _entries.clear()
        _order.clear()


def aot_capture(fn, label, args):
    raise NotImplementedError(f"monitor.xla.aot_capture: {_NOT_PORTED}")


def executable(label=None):
    raise NotImplementedError(f"monitor.xla.executable: {_NOT_PORTED}")


def hlo_text(label=None, max_bytes=2_000_000):
    raise NotImplementedError(f"monitor.xla.hlo_text: {_NOT_PORTED}")


def measured_mfu(step_time_s, label=None, peak_flops=None):
    raise NotImplementedError(f"monitor.xla.measured_mfu: {_NOT_PORTED}")
