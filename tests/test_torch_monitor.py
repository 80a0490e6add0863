"""The port's monitor core (``paddle_tpu_torch.monitor``: the registry, the
JSONL sink, the switches, and ``monitor.trace``) against the JAX
package's ``paddle_tpu.monitor``, on the CPU.

Both are pure host Python, so the same records must give equal snapshots
and equal files (times aside), and the same spans, lanes, flows and
markers equal Chrome exports (process ids, thread ids and times aside).
Each monitor is process-wide: every test starts and ends with both off,
reset and cleared (the autouse fixture), so that none leaks into a later
test on its worker.
"""
import json
import os

import pytest
import torch

from paddle_tpu import monitor as ref_monitor
from paddle_tpu.serving import metrics as ref_metrics
from paddle_tpu.serving import reqtrace as ref_reqtrace
from paddle_tpu_torch import monitor
from paddle_tpu_torch.monitor.registry import (Histogram, JsonlSink,
                                               Registry, read_jsonl)
from paddle_tpu_torch.monitor import trace
from paddle_tpu_torch.serving import metrics, reqtrace

MONITORS = (ref_monitor, monitor)


def _all_off():
    for mon in MONITORS:
        mon.disable(flush_counters=False)
        mon.reset()
        mon.trace.disable()
        mon.trace.clear()
    for rq, met in ((ref_reqtrace, ref_metrics), (reqtrace, metrics)):
        rq.reset()
        met.reset_windows()


@pytest.fixture(autouse=True)
def _clean():
    _all_off()
    yield
    _all_off()


LAT = metrics.LATENCY_BUCKETS_MS
SEQUENCES = {
    "counters": [("counter", "a.b", 1), ("counter", "a.b", 4),
                 ("counter", "a.c", 0), ("counter", "z", 7)],
    "gauges": [("gauge", "g.x", 3), ("gauge", "g.x", 2.5),
               ("gauge", "g.y", -1)],
    "histogram_default": [("histogram", "h", v, None)
                          for v in (1e-7, 0.5, 3.0, 3.0, 17.0, 4.0 ** 18)],
    "histogram_latency": [("histogram", "serving.x_ms", v, LAT)
                          for v in (0.0005, 0.2, 2.0, 9.9, 1e6)],
    "mixed": [("counter", "serving.requests", 1),
              ("gauge", "serving.queue_depth", 3),
              ("histogram", "serving.latency_ms", 12.5, LAT),
              ("counter", "serving.requests", 2),
              ("gauge", "serving.queue_depth", 0),
              ("histogram", "serving.latency_ms", 0.75, LAT)],
}


def _apply(reg, ops):
    for op in ops:
        if op[0] == "counter":
            reg.counter(op[1]).inc(op[2])
        elif op[0] == "gauge":
            reg.gauge(op[1]).set(op[2])
        else:
            reg.histogram(op[1], buckets=op[3]).observe(op[2])


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_same_records_give_equal_snapshots(name):
    """Through each package's process registry (``monitor.counter`` and
    friends) and through a fresh ``Registry``: equal snapshots, values and
    names, prefix by prefix."""
    for a, b in ((ref_monitor.registry(), monitor.registry()),
                 (ref_monitor.Registry(), Registry())):
        _apply(a, SEQUENCES[name])
        _apply(b, SEQUENCES[name])
        assert b.snapshot() == a.snapshot()
        for prefix in ("", "a.", "serving.", "g."):
            assert b.snapshot(prefix) == a.snapshot(prefix)
            assert b.names(prefix) == a.names(prefix)
        for n in a.names():
            assert b.value(n) == a.value(n)
        assert b.value("missing", 9) == a.value("missing", 9) == 9
    assert monitor.snapshot() == ref_monitor.snapshot()
    h = monitor.registry().get(a.names()[0])
    if isinstance(h, Histogram):
        assert h.mean == ref_monitor.registry().get(h.name).mean


def test_registry_edges_match_reference():
    for reg in (ref_monitor.Registry(), Registry()):
        reg.counter("x")
        with pytest.raises(TypeError, match="already registered"):
            reg.gauge("x")
        with pytest.raises(ValueError, match="negative"):
            reg.counter("x").inc(-1)
        reg.gauge("serving.replica.3.q").set(1)
        reg.gauge("serving.replica.3.r").set(2)
        assert reg.clear_prefix("serving.replica.3.") == 2
        assert reg.clear_prefix("") == 0
        assert reg.remove("x") and not reg.remove("x")
        assert reg.names() == []
        reg.histogram("h").observe(1.0)
        reg.reset()
        assert reg.snapshot() == {}


@pytest.mark.parametrize("max_bytes", [None, 200])
def test_jsonl_sink_round_trips_as_the_references(tmp_path, max_bytes):
    """The same records into both sinks: the same lines, and at a size
    cap the same rotations and generations."""
    recs = [{"ts": 1.0 + i, "kind": "serving", "event": "x", "i": i,
             "obj": object() if i == 3 else None} for i in range(12)]
    files = {}
    for pkg, cls in (("ref", ref_monitor.JsonlSink), ("port", JsonlSink)):
        path = tmp_path / pkg / "events.jsonl"
        sink = cls(str(path), max_bytes=max_bytes)
        for r in recs:
            sink.emit(dict(r))
        sink.close()
        sink.emit({"after": "close"})       # dropped, not raised
        files[pkg] = (sink.rotations, sorted(p.name for p in
                                             path.parent.iterdir()),
                      [read_jsonl(str(p)) for p in
                       sorted(path.parent.iterdir())])
    assert files["port"] == files["ref"]
    rotations, names, contents = files["port"]
    assert (rotations > 0) == (max_bytes is not None)
    if max_bytes is None:
        assert [r["i"] for r in contents[0]] == list(range(12))


def test_read_jsonl_skips_a_truncated_line(tmp_path):
    p = tmp_path / "e.jsonl"
    p.write_text('{"a": 1}\n\n{"b": 2}\n{"c": \n')
    with pytest.warns(UserWarning, match="line 4"):
        got = read_jsonl(str(p))
    with pytest.warns(UserWarning, match="line 4"):
        assert got == ref_monitor.read_jsonl(str(p)) == [{"a": 1}, {"b": 2}]


def test_enable_writes_the_references_records(tmp_path):
    """``enable(dir)`` makes ``events-<pid>.jsonl`` there; ``emit`` appends;
    ``disable`` writes the counters record and closes the sink; the
    registry keeps its values until ``reset``."""
    kinds = {}
    for name, mon in (("ref", ref_monitor), ("port", monitor)):
        path = mon.enable(str(tmp_path / name))
        assert mon.enabled() and mon.jsonl_path() == path
        assert os.path.basename(path) == f"events-{os.getpid()}.jsonl"
        mon.counter("serving.requests").inc(2)
        mon.emit(kind="serving", event="shed", level=2)
        mon.disable()
        assert not mon.enabled() and mon.jsonl_path() is None
        assert mon.snapshot() == {"serving.requests": 2}
        recs = mon.read_jsonl(path)
        kinds[name] = [(r["kind"], r.get("action"), r.get("event"),
                        r.get("counters")) for r in recs]
        assert all(isinstance(r["ts"], float) for r in recs)
        mon.reset()
    assert kinds["port"] == kinds["ref"]
    jp = monitor.enable(str(tmp_path / "one.jsonl"))
    assert jp.endswith("one.jsonl")
    monitor.enable()            # again, no path: the same sink stays
    assert monitor.jsonl_path() == jp


def test_the_two_monitors_are_independent(tmp_path, monkeypatch):
    """Enabling one package's monitor (or its tracer, from the
    environment) never enables the other's."""
    monkeypatch.setenv("PADDLE_TPU_TORCH_TRACE", "1")
    monitor.enable()
    assert monitor.enabled() and trace.enabled()
    assert not ref_monitor.enabled() and not ref_monitor.trace.enabled()
    assert reqtrace.new_trace() is not None
    assert ref_reqtrace.new_trace() is None
    _all_off()
    monkeypatch.delenv("PADDLE_TPU_TORCH_TRACE")
    monkeypatch.setenv("PADDLE_TPU_TRACE", "1")
    monkeypatch.setenv("PADDLE_TPU_MONITOR_DIR", str(tmp_path / "ref"))
    ref_monitor.enable()
    assert ref_monitor.enabled() and ref_monitor.trace.enabled()
    assert not monitor.enabled() and not trace.enabled()
    monitor.enable()
    assert monitor.jsonl_path() is None and not trace.enabled()
    monkeypatch.setenv("PADDLE_TPU_TORCH_MONITOR_DIR", str(tmp_path / "p"))
    assert monitor.enable().startswith(str(tmp_path / "p"))


@pytest.mark.parametrize("how", ["MONITOR_TIME_DISPATCH", "TELEMETRY_DIR",
                                 "PROFILE", "METRICS_PORT", "time_dispatch",
                                 "telemetry_dir"])
def test_unported_parts_raise_not_implemented(how, monkeypatch, tmp_path):
    """What would start a part of the monitor left out (ROADMAP.md Queue A
    item 20) raises, and leaves the monitor off."""
    kw = {}
    if how.islower():
        kw[how] = True if how == "time_dispatch" else str(tmp_path)
    else:
        monkeypatch.setenv("PADDLE_TPU_TORCH_" + how, "1")
    with pytest.raises(NotImplementedError, match="item 20"):
        monitor.enable(**kw)
    assert not monitor.enabled()


def _record(tr, fid):
    """One sequence of every event kind into tracer ``tr``."""
    tr.enable()

    @tr.traced("decorated")
    def work(x):
        return x + 1

    @tr.traced
    def bare():
        return 0

    with tr.span("serving.batch", requests=3):
        with tr.span("serving.execute", rows=8):
            tr.flow_start("serving.req", fid, rid="r1")
        tr.flow_step("serving.req", fid)
        t0 = tr._CLOCK()
        tr.complete("dispatch.matmul", t0, t0 + 0.001, op="mm")
        tr.instant("collective.psum", bytes=4)
        tr.counter("hbm", bytes_in_use=10, reserved=20)
        tr.counter("empty")
        tr.flow_end("serving.req", fid)
    assert work(1) == 2 and bare() == 0
    tr.lane_complete("kv.slot0", "prefill", t0, t0 + 0.002, tokens=5)
    tr.lane_complete("kv.slot1", "req 1", t0)
    tr.lane_instant("kv.pool", "grow 16->32", old_cap=16, new_cap=32)
    return tr.export_chrome_trace()


def _shape(doc):
    out = []
    for e in doc["traceEvents"]:
        if e["ph"] == "M":
            if e["name"] == "thread_name" and e["args"]["name"].startswith(
                    "kv."):
                out.append(("M", e["args"]["name"]))
            continue
        out.append((e["ph"], e["name"], e.get("cat"), e.get("args"),
                    e.get("id"), e.get("bp"), "dur" in e))
    return out


def test_span_and_lane_names_match_in_the_chrome_export(tmp_path):
    ref_doc = _record(ref_monitor.trace, 7)
    doc = _record(trace, 7)
    assert _shape(doc) == _shape(ref_doc)
    assert set(trace.lanes()) == set(ref_monitor.trace.lanes()) == {
        "kv.slot0", "kv.slot1", "kv.pool"}
    names = {e["name"] for e in doc["traceEvents"]}
    assert {"serving.batch", "serving.execute", "decorated", "prefill",
            "grow 16->32"} <= names
    assert doc["traceEvents"][0]["args"]["name"].startswith(
        "paddle_tpu_torch[")
    path = trace.export_chrome_trace(str(tmp_path / "t"))
    assert path.endswith(f"trace-{os.getpid()}.json")
    with open(path) as fh:
        assert json.load(fh)["traceEvents"] == doc["traceEvents"]
    assert len(trace.events(last=3)) == 3
    trace.enable(buffer_size=4)
    assert len(trace.events()) == 4


def test_a_disabled_tracer_records_nothing():
    s = trace.span("x", a=1)
    assert s is trace.span("y") and type(s).__name__ == "_NullSpan"
    with s:
        pass
    trace.complete("x", 0.0)
    trace.instant("x")
    trace.counter("x", v=1)
    trace.flow_start("x", 1)
    trace.lane_complete("kv.slot0", "x", 0.0)
    trace.lane_instant("kv.slot0", "x")
    assert trace.events() == [] and trace.lanes() == {}
    trace.enable()
    trace.disable()
    trace.instant("after")
    assert [e[1] for e in trace.events()] == []


def test_bridge_enters_record_function():
    """With ``bridge=True`` a span's name appears in a ``torch.profiler``
    trace (the reference enters ``jax.profiler.TraceAnnotation``)."""
    trace.enable(bridge=True)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace.span("serving.decode_tick_probe"):
            torch.ones(4).sum()
    names = {e.name for e in prof.events()}
    assert "serving.decode_tick_probe" in names
    trace.enable(bridge=False)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace.span("serving.unbridged"):
            torch.ones(4).sum()
    assert "serving.unbridged" not in {e.name for e in prof.events()}


def test_flight_record_dumps_its_evidence(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_TORCH_FLIGHT_MAX", "2")
    monitor.enable(str(tmp_path / "mon"))
    monitor.counter("serving.requests").inc()
    trace.enable()
    with trace.span("serving.enqueue"):
        pass
    att = reqtrace.attach(None, kind="decode")
    att.first_token()
    att.note_tokens(3)
    att.finalize("ok")
    d = trace.flight_record("stall step", step=9, extra={"why": 1})
    assert d and os.path.dirname(d) == str(tmp_path / "mon" / "flight")
    assert trace.last_flight() == d
    assert sorted(os.listdir(d)) == ["counters.json", "meta.json",
                                     "slow_requests.json", "trace.json"]
    with open(os.path.join(d, "meta.json")) as fh:
        meta = json.load(fh)
    assert (meta["reason"], meta["step"], meta["extra"]) == (
        "stall step", 9, {"why": 1})
    with open(os.path.join(d, "counters.json")) as fh:
        assert json.load(fh)["serving.requests"] == 1
    assert trace.flight_record("again", directory=str(tmp_path / "x"))
    assert trace.flight_record("capped") is None
    kinds = [r["kind"] for r in monitor.read_jsonl(monitor.jsonl_path())]
    assert kinds.count("flight_record") == 2
