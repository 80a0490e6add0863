"""The port's serving metrics and request traces
(``paddle_tpu_torch.serving.metrics``, ``serving.reqtrace``, and their
call sites in the admission ladder, the batcher, ``ServingEngine`` and
``GenerateEngine``) against the JAX package's, on the CPU, with both
monitors on.

Rules, each with its reason:

* every ``record_*`` is pure host Python over the registry: the same call
  gives the same snapshot and the same JSONL record (``ts`` aside);
* the rolling windows read ``time.monotonic``: their tests put both
  packages on one injected clock, so that rollups at an injected ``now=``
  agree exactly;
* a request's ``serving.request`` record agrees field for field with the
  reference's for the same request through the same engine, except the
  times (``*_ms``, ``recon``) and the request id;
* the engines' counters, gauges and histogram counts agree with the
  reference's over the same ticks (``start=False``), and equal the
  engine's own ``stats()``;
* the reference's keywords are accepted at their defaults (ROADMAP.md
  Queue C, C1); ``replica_id`` and ``on_outcome`` (the fleet's, item
  17.3) also at the values a fleet passes, and the unported ones
  (``metrics_port``, ``seq_buckets``) raise ``NotImplementedError``
  naming their item at any other value.

Each monitor is process-wide: every test starts and ends with both off,
reset and cleared (the autouse fixture).
"""
import inspect
import time

import numpy as np
import pytest

import paddle_tpu.tensor as ref_tensor
from paddle_tpu import monitor as ref_monitor
from paddle_tpu import nn as ref_nn
from paddle_tpu import inference as ref_inference
from paddle_tpu import serving as ref_serving
from paddle_tpu.serving import metrics as ref_metrics
from paddle_tpu.serving import reqtrace as ref_reqtrace
from paddle_tpu.serving.admission import AdmissionController as RefAdmission
from paddle_tpu.serving.engine import ServingEngine as RefServingEngine
from paddle_tpu.serving.generate import GenerateEngine as RefEngine
from paddle_tpu_torch import convert, inference, monitor, nn, serving
from paddle_tpu_torch.serving import metrics, reqtrace
from paddle_tpu_torch.serving.admission import AdmissionController
from paddle_tpu_torch.serving.engine import ServingEngine


@pytest.fixture(autouse=True)
def _no_arena_hook():
    """The reference's flat-arena hook cleared for each test and restored
    after: an earlier file on the worker may leave it set, and then the
    reference's ``Layer._run_forward`` calls ``jax.core.trace_state_clean``,
    which this jax lacks (ROADMAP.md Queue C)."""
    hook = ref_tensor._arena_hook
    ref_tensor._arena_hook = None
    yield
    ref_tensor._arena_hook = hook


PAIRS = ((ref_monitor, ref_metrics, ref_reqtrace),
         (monitor, metrics, reqtrace))
ENGINE = dict(slots=2, page=16, factor=2.0, max_len=64,
              prompt_buckets=(4, 8, 16), shed=False)
SPEC_ENGINE = dict(slots=2, page=16, max_len=16, prompt_buckets=(16,),
                   shed=False)
SAMPLED = {"temperature": 1.0, "top_k": 8, "top_p": 0.9}
TIME_FIELDS = ("rid", "recon")


def _all_off():
    for mon, met, rq in PAIRS:
        mon.disable(flush_counters=False)
        mon.reset()
        mon.trace.disable()
        mon.trace.clear()
        rq.reset()
        met.reset_windows()


@pytest.fixture(autouse=True)
def _clean():
    _all_off()
    yield
    _all_off()


@pytest.fixture
def both_on(tmp_path):
    """Both monitors on, each with its own sink; returns the sink paths."""
    return (ref_monitor.enable(str(tmp_path / "ref")),
            monitor.enable(str(tmp_path / "port")))


@pytest.fixture
def clock(monkeypatch):
    """One injected monotonic clock for both packages' windows."""
    now = [1000.0]
    monkeypatch.setattr(time, "monotonic", lambda: now[0])
    return now


def _events(mon, path):
    return [{k: v for k, v in r.items() if k != "ts"}
            for r in mon.read_jsonl(path)
            if r["kind"] not in ("monitor", "counters")]


RECORDS = [
    ("record_submit", (3,), {}),
    ("record_queue_depth", (5,), {}),
    ("record_reject", (), {}),
    ("record_expired", (), {}),
    ("record_batch", (5, 8, 2), {}),
    ("record_batch", (8, 8, 3), {}),
    ("record_completed", (2, [1.5, 30.0]), {"within_sla": [True, False]}),
    ("record_completed", (1, [2.0]), {}),
    ("record_request_slo", (12.0, 3.0), {}),
    ("record_request_slo", (5.0, None), {}),
    ("record_compiles", (2,), {}),
    ("record_retry", ("serving.execute",), {}),
    ("record_isolated", (3,), {}),
    ("record_poisoned", ("ValueError()",), {}),
    ("record_shed", (2, 1, 25.0), {}),
    ("record_shed_level", (2,), {}),
    ("record_breaker_transition", ("r0", "closed", "open", "x"), {}),
    ("record_breaker_transition", ("r0", "open", "draining"), {}),
    ("record_hedge", (1,), {}),
    ("record_hedge_win", (1,), {}),
    ("record_failover", (0, 3), {}),
    ("record_replica_hung", (0, 1.234567), {}),
    ("record_replica_restart", (0,), {}),
    ("record_active_replicas", (3,), {}),
    ("record_lifecycle", ("drain",), {"replica": 0}),
    ("record_weights_version", (4,), {}),
    ("record_supervisor", ("scale_up",), {"n": 2}),
    ("record_decode_tick", (3, 8, 3, 2.5), {}),
    ("record_decode_tick", (0, 8, 0, 0.1), {}),
    ("record_prefill", (7, 1.25, 8), {}),
    ("record_decode_compile", (1, "decode[cap=16]"), {}),
    ("record_decode_compile", (2,), {}),
    ("record_cache", (1024, 16), {"headroom_bytes": 100,
                                  "limit_bytes": 2000}),
    ("record_cache", (512, 32), {"label": "draft"}),
    ("record_cache_grow", (32,), {}),
    ("record_rollback", (3,), {"label": "draft"}),
    ("record_spec_tick", (32, 20, 24, 8), {}),
    ("record_handoff", (4096, 0.5, 1.2, 2), {}),
    ("record_prefix_lookup", (True, 0.3), {}),
    ("record_prefix_lookup", (False, 0.1), {}),
    ("record_prefix_cache", (4096, 3, 10000), {}),
    ("record_prefix_evict", (2, 100), {}),
]


@pytest.mark.parametrize("i", range(len(RECORDS)),
                         ids=[f"{r[0]}-{i}" for i, r in enumerate(RECORDS)])
def test_each_record_matches_the_reference(both_on, clock, i):
    """Each record, twice (its window's gauges move on the second), gives
    the reference's snapshot and JSONL records; with the monitor off the
    port's registry stays empty."""
    name, args, kw = RECORDS[i]
    for _ in range(2):
        for _, met, _ in PAIRS:
            getattr(met, name)(*args, **kw)
        clock[0] += 0.5
    assert monitor.snapshot() == ref_monitor.snapshot()
    assert monitor.snapshot()
    assert _events(monitor, both_on[1]) == _events(ref_monitor, both_on[0])
    _all_off()
    getattr(metrics, name)(*args, **kw)
    assert monitor.snapshot() == {}


def test_series_hygiene_matches_the_reference(both_on):
    for mon, met, _ in PAIRS:
        met.record_breaker_transition("7", "closed", "open")
        mon.gauge("serving.replica.7.depth").set(2)
        met.record_completed(1, [3.0])
        met.record_request_slo(4.0, 1.0)
        assert met.assert_mergeable_latency_histograms() == [
            "serving.latency_ms", "serving.tpot_ms", "serving.ttft_ms"]
        assert met.clear_replica_series("7") == 2
        assert met.clear_replica_series("7") == 0
    assert monitor.snapshot() == ref_monitor.snapshot()
    monitor.histogram("serving.bad_ms").observe(1.0)
    with pytest.raises(AssertionError, match="non-standard"):
        metrics.assert_mergeable_latency_histograms()
    assert metrics.LATENCY_BUCKETS_MS == ref_metrics.LATENCY_BUCKETS_MS


def _traffic(met, clock):
    """A minute of serving and decode records on the injected clock."""
    for i in range(30):
        met.record_submit(1)
        if i % 3:
            met.record_completed(1, [5.0 + i], within_sla=[i % 4 != 0])
        else:
            met.record_expired()
        met.record_request_slo(2.0 + i, 0.5 + 0.1 * i if i % 2 else None)
        met.record_decode_tick(i % 8, 8, i % 8, 1.0 + 0.25 * i)
        if i % 5 == 0:
            met.record_prefill(12, 3.0 + i, 16)
        met.record_spec_tick(16, 9 + i % 7, 11 + i % 7, 8)
        met.record_prefix_lookup(i % 3 == 0, 0.2)
        clock[0] += 0.1


@pytest.mark.parametrize("after", [0.0, 0.2, 5.0, 14.0, 30.0, 59.0, 61.0,
                                   120.0])
def test_rollups_at_an_injected_now_match(both_on, clock, after):
    """The rolling windows, read at ``now = last record + after``:
    ``slo_rollup``, ``decode_rollup``, ``publish_rollups`` and the control
    reads agree with the reference's, and so do the gauges they set."""
    for _, met, _ in PAIRS:
        clock[0] = 1000.0
        _traffic(met, clock)
    now = clock[0] + after
    got = {}
    for mon, met, _ in PAIRS:
        got[mon] = dict(
            publish=met.publish_rollups(now),
            slo=met.slo_rollup(now), decode=met.decode_rollup(now),
            goodput=met.goodput_window(now), spec=met.spec_window(now),
            tokens=met.tokens_window(now), prefix=met.prefix_window(now),
            qps=met.qps_now(now))
    assert got[monitor] == got[ref_monitor]
    assert monitor.snapshot() == ref_monitor.snapshot()
    stamps, t = [], 1000.0
    for _ in range(30):
        stamps.append(t)
        t += 0.1
    assert got[monitor]["slo"]["submitted"] == sum(
        now - t <= metrics.SLO_WINDOW_S for t in stamps)


@pytest.mark.parametrize("floor", [None, 0.5, 0.9])
def test_slo_goodput_floor_escalates_the_ladder(both_on, floor):
    """Under the floor (20 or more submissions in the window) the ladder
    is one rung higher, in both packages; without a floor, or with the
    monitor off, it never is."""
    for _, met, _ in PAIRS:
        for i in range(20):
            met.record_submit(1)
            met.record_completed(1, [1.0], within_sla=[i < 13])
    levels = {}
    for cls in (RefAdmission, AdmissionController):
        ctl = cls(max_queue_depth=100, slo_goodput_floor=floor)
        levels[cls] = [ctl.shed_level(d) for d in (0, 49, 50, 75, 95)]
        req = type("R", (), {"priority": 2, "deadline": None,
                             "trace": None})()
        if levels[cls][0]:
            with pytest.raises(Exception, match="shed at ladder level 1"):
                ctl.admit(req, 0)
    assert levels[AdmissionController] == levels[RefAdmission]
    esc = 1 if floor == 0.9 else 0
    assert levels[AdmissionController] == [esc, esc, 1 + esc,
                                           min(2 + esc, 3), 3]
    assert monitor.snapshot() == ref_monitor.snapshot()
    _all_off()
    for _, met, _ in PAIRS:
        for i in range(20):
            met.record_submit(1)
    assert AdmissionController(slo_goodput_floor=0.9).shed_level(0) == 0


# -- the engines --------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    ref = ref_serving.demo_model(vocab=32, dim=16, heads=2, layers=2,
                                 max_len=64, seed=1)
    lm = serving.demo_model(vocab=32, dim=16, heads=2, layers=2, max_len=64,
                            device="cpu")
    convert.load_jax_state(lm, {k: np.asarray(v)
                                for k, v in ref.state.items()})
    pair_ref = ref_serving.demo_spec_pair(vocab=32, dim=16, heads=2,
                                          draft_layers=1, extra_layers=1,
                                          max_len=64, seed=1, distill=0.2)
    target, draft = serving.demo_spec_pair(vocab=32, dim=16, heads=2,
                                           draft_layers=1, extra_layers=1,
                                           max_len=64, seed=1, distill=0.2,
                                           device="cpu")
    convert.load_jax_state(target, {k: np.asarray(v)
                                    for k, v in pair_ref[0].state.items()})
    return {"ref": (ref, None, pair_ref), "port": (lm, None, (target,
                                                              draft))}


def _run(cls, model, draft, jobs, ticks, **kw):
    eng = cls(model, start=False, draft_model=draft, spec_k=4, **kw)
    reqs = []
    for p, n, skw in jobs:
        r = eng.make_request(p, max_new_tokens=n, **skw)
        eng.submit_request(r)
        reqs.append(r)
    for _ in range(ticks):
        eng.tick()
    st = eng.stats()
    out = [list(map(int, r.future.result(timeout=10))) if r.future.done()
           else None for r in reqs]
    eng.close(drain=False)
    return st, out, reqs


PLAIN_JOBS = [([1, 2, 3], 6, {}), ([7] * 11, 30, {}),
              ([5, 4, 3, 2, 1, 9, 8], 9, {"sampling": SAMPLED, "seed": 3}),
              ([2, 2], 1, {}), ([4, 6, 8, 1], 5, {"sampling": SAMPLED,
                                                   "seed": 4})]
SPEC_JOBS = [([7, 2], 12, {}), ([3, 1, 4], 12, {"sampling": SAMPLED,
                                                 "seed": 5}),
             ([5, 9, 2, 6], 10, {})]


def _decode_view(snap):
    """The serving series (the reference's monitor also counts its own
    dispatched ops): counters and gauges as they are, but for the rate
    ``serving.qps`` (completions over wall time); histograms by count and,
    where the observations are not times, by bucket."""
    out = {}
    for name, v in snap.items():
        if not name.startswith(("serving.", "slo.")) or name == "serving.qps":
            continue
        if isinstance(v, dict):
            out[name] = (v if name.endswith("occupancy_hist")
                         or name.endswith("batch_fill")
                         else {"count": v["count"]})
        else:
            out[name] = v
    return out


@pytest.mark.parametrize("ticks", [3, 12, 60])
@pytest.mark.parametrize("speculative", [False, True])
def test_engine_counters_match_the_reference(models, both_on, speculative,
                                             ticks):
    """The same submits and ticks through both engines: equal counters,
    gauges, histogram counts and streams; the decode counters equal the
    engine's ``stats()``."""
    got = {}
    for side, cls in (("ref", RefEngine), ("port", serving.GenerateEngine)):
        model, _, (target, draft) = models[side]
        if speculative:
            got[side] = _run(cls, target, draft, SPEC_JOBS, ticks,
                             **SPEC_ENGINE)
        else:
            got[side] = _run(cls, model, None, PLAIN_JOBS, ticks, **ENGINE)
    assert got["port"][1] == got["ref"][1]
    snap, ref_snap = monitor.snapshot(), ref_monitor.snapshot()
    assert _decode_view(snap) == _decode_view(ref_snap)
    st = got["port"][0]
    dec = {k[len("serving.decode."):]: v for k, v in snap.items()
           if k.startswith("serving.decode.")}
    assert dec["ticks"] == st["ticks"] and dec["tokens"] == st["tokens"]
    assert dec["prefills"] == st["prefills"]
    assert dec["prefill_tokens"] == st["prefill_tokens"]
    assert dec["compiles"] == st["compiles"] == snap["serving.compiles"]
    assert dec.get("cache_grows", 0) == st["grows"]
    assert dec["cache_bytes"] == st["pool_cache_bytes"]
    assert snap["serving.requests"] == st["submitted"]
    # a record a request: those done, and those the close failed
    jobs = SPEC_JOBS if speculative else PLAIN_JOBS
    assert snap["serving.request_records"] == len(jobs)
    assert snap.get("serving.ttft_ms", {"count": 0})["count"] == \
        st["completed"]
    if speculative:
        for key in ("draft_steps", "verify_steps", "spec_proposed",
                    "spec_accepted"):
            assert dec[key] == st[key]
        assert dec["rollback_tokens"] >= st["pool_rollback_tokens"] > 0


def _strip(rec):
    out = {k: v for k, v in rec.items()
           if k not in TIME_FIELDS and not k.endswith("_ms")}
    out["hops"] = [{k: v for k, v in h.items() if k != "t_ms"}
                   for h in rec["hops"]]
    out["stages"] = sorted(k for k in rec if k.endswith("_ms"))
    return out


@pytest.mark.parametrize("speculative", [False, True])
def test_decode_request_records_match_field_for_field(models, both_on,
                                                      speculative):
    """Each request's one ``serving.request`` record, emitted to the sink
    and kept in ``recent()``, against the reference's: every field but
    the times and the id; TTFT on every record, TPOT where more than one
    token came."""
    recs = {}
    for side, cls, rq in (("ref", RefEngine, ref_reqtrace),
                          ("port", serving.GenerateEngine, reqtrace)):
        model, _, (target, draft) = models[side]
        if speculative:
            _, out, reqs = _run(cls, target, draft, SPEC_JOBS, 80,
                                **SPEC_ENGINE)
        else:
            _, out, reqs = _run(cls, model, None, PLAIN_JOBS, 80, **ENGINE)
        assert None not in out
        recs[side] = [r.trace.ctx.record() for r in reqs]
        assert sorted(r["rid"] for r in rq.recent()) == sorted(
            r["rid"] for r in recs[side])
    for mine, theirs in zip(recs["port"], recs["ref"]):
        assert _strip(mine) == _strip(theirs)
        assert mine["ttft_ms"] is not None and mine["e2e_ms"] > 0
        assert (mine["tpot_ms"] is None) == (mine["tokens"] == 1)
        assert abs(mine["recon"] - 1.0) <= reqtrace.RECON_TOL
    emitted = [r for r in monitor.read_jsonl(both_on[1])
               if r["kind"] == "serving.request"]
    assert len(emitted) == len(recs["port"])
    assert monitor.snapshot()["serving.ttft_ms"]["count"] == len(emitted)


def test_moved_request_record_keeps_its_lineage(models, both_on):
    """A request exported from one engine and imported by another emits
    one record, with the reference's hops and stages."""
    recs = {}
    for side, cls in (("ref", RefEngine), ("port", serving.GenerateEngine)):
        model = models[side][0]
        a = cls(model, start=False, **ENGINE)
        r = a.make_request([1, 2, 3], max_new_tokens=8)
        a.submit_request(r)
        a.tick()
        a.tick()
        moved = a.disown_inflight(export_kv=True)
        a.close(drain=False)
        b = cls(model, start=False, kv_import=True, **ENGINE)
        b.requeue(moved)
        for _ in range(20):
            b.tick()
        b.close(drain=False)
        recs[side] = r.trace.ctx.record()
    assert _strip(recs["port"]) == _strip(recs["ref"])
    assert [h["hop"] for h in recs["port"]["hops"]] == ["enqueue",
                                                        "requeue"]
    assert recs["port"]["tokens"] == 8


def _ref_linear():
    import paddle_tpu as pt
    pt.seed(0)
    return ref_nn.Sequential(ref_nn.Linear(16, 4))


def test_serving_engine_records_match_the_reference(both_on):
    """``ServingEngine`` over a linear model in both packages: the batch
    series, the compile count and each request's record (stages queue,
    assemble, execute, scatter; TTFT is the end-to-end time)."""
    ref_lin = _ref_linear()
    lin = nn.Sequential(nn.Linear(16, 4))
    got = {}
    for side, eng in (
            ("ref", RefServingEngine(ref_inference.Predictor(ref_lin),
                                     buckets=[4, 8], max_batch=8,
                                     timeout_ms=5.0, start=False)),
            ("port", ServingEngine(inference.Predictor(lin, device="cpu"),
                                   buckets=[4, 8], max_batch=8,
                                   timeout_ms=5.0, start=False))):
        rng = np.random.RandomState(0)
        futs = [eng.submit(rng.rand(n, 16).astype("f4")) for n in (1, 3, 2)]
        eng.start()
        for f in futs:
            f.result(timeout=30)
        eng.close()
        snap = monitor.snapshot() if side == "port" else \
            ref_monitor.snapshot()
        got[side] = ({k: (v["count"] if isinstance(v, dict)
                          and k.endswith("_ms") else v)
                      for k, v in snap.items() if k.startswith("serving.")
                      and k != "serving.qps"},
                     sorted(tuple(sorted(_strip(r).items(),
                                         key=lambda kv: kv[0]))
                            .__repr__() for r in (
                                reqtrace if side == "port" else
                                ref_reqtrace).recent()))
    assert got["port"] == got["ref"]
    assert got["port"][0]["serving.batches"] == 1
    assert got["port"][0]["serving.request_records"] == 3


def test_the_monitor_adds_no_op_to_a_tick(models, both_on):
    """A decode tick dispatches the same PyTorch operations with the
    monitor and the tracer on as with them off: every record reads host
    numbers only."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    model = models["port"][0]
    counts = {}
    for on in (False, True):
        if on:
            monitor.enable()
            monitor.trace.enable()
        else:
            monitor.disable(flush_counters=False)
        eng = serving.GenerateEngine(model, start=False, **ENGINE)
        eng.warmup()
        for p, n, kw in PLAIN_JOBS[:2]:
            eng.submit(p, max_new_tokens=n, **kw)
        eng.tick()                       # admits both, then one tick
        with Count() as c:
            eng.tick()
        counts[on] = c.n
        eng.close(drain=False)
    assert counts[True] == counts[False] > 0


# -- C1: the reference's keywords ----------------------------------------------

def _defaults(fn):
    return {n: p.default for n, p in inspect.signature(fn).parameters.items()
            if p.default is not inspect.Parameter.empty}


def test_reference_keywords_are_accepted_at_their_defaults():
    """Every keyword of the reference's constructors, passed at its
    default, builds the port's; the port's methods take every keyword the
    reference's do."""
    lm = serving.demo_model(vocab=32, dim=16, heads=2, layers=1,
                            max_len=512, device="cpu")
    kw = _defaults(RefEngine.__init__)
    eng = serving.GenerateEngine(lm, **kw)
    try:
        assert eng.admission.slo_goodput_floor == kw["slo_goodput_floor"]
        assert eng.warmup((("x",),), [((4,), "int32")]) > 0
        req = eng.make_request([1, 2], max_new_tokens=2, trace=None)
        assert len(eng.submit_request(req, admit=True).result(30)) == 2
    finally:
        eng.close()
    kw = _defaults(RefServingEngine.__init__)
    kw["start"] = False
    seng = ServingEngine(inference.Predictor(nn.Sequential(nn.Linear(4, 2)),
                                             device="cpu"), **kw)
    seng.close()
    adm = AdmissionController(**_defaults(RefAdmission.__init__))
    assert adm.slo_goodput_floor == 0.9
    for ref_cls, cls, names in (
            (RefEngine, serving.GenerateEngine,
             ("__init__", "make_request", "submit", "submit_request", "run",
              "warmup", "steal_pending", "disown_inflight", "requeue",
              "tick", "close", "stats", "executables")),
            (RefServingEngine, ServingEngine,
             ("__init__", "make_request", "submit", "submit_request", "run",
              "warmup", "close", "stats")),
            (RefAdmission, AdmissionController,
             ("__init__", "admit", "shed_level", "effective_max_batch",
              "expire", "isolate"))):
        for name in names:
            ref_sig = inspect.signature(getattr(ref_cls, name))
            sig = inspect.signature(getattr(cls, name))
            assert list(ref_sig.parameters) == list(sig.parameters), name
            for p in ref_sig.parameters.values():
                assert sig.parameters[p.name].default == p.default, (
                    name, p.name)


def _on_outcome(ok, exc):
    return None


# the fleet's keywords (item 17.3) are ported: item None means accepted at
# the reference's values, as a MultiDeviceEngine passes them
UNPORTED = [
    ("generate", "replica_id", 0, None),
    ("generate", "on_outcome", _on_outcome, None),
    ("serving", "metrics_port", 0, "item 20"),
    ("serving", "replica_id", 1, None),
    ("serving", "on_outcome", _on_outcome, None),
    ("serving", "seq_buckets", [16, 32], "item 17.5"),
]


@pytest.mark.parametrize("which,name,value,item", UNPORTED,
                         ids=[f"{u[0]}-{u[1]}" for u in UNPORTED])
def test_unported_keywords_raise_not_implemented(which, name, value, item):
    """The keywords still unported raise naming their item at any value
    but None; ``replica_id`` and ``on_outcome`` are taken at the values a
    fleet passes, and kept."""
    if which == "generate":
        lm = serving.demo_model(vocab=32, dim=16, heads=2, layers=1,
                                max_len=64, device="cpu")
        make = lambda **kw: serving.GenerateEngine(  # noqa: E731
            lm, slots=1, page=16, max_len=32, prompt_buckets=(4,),
            start=False, **kw)
    else:
        pred = inference.Predictor(nn.Sequential(nn.Linear(4, 2)),
                                   device="cpu")
        make = lambda **kw: ServingEngine(pred, start=False,  # noqa: E731
                                          **kw)
    if item is None:
        eng = make(**{name: value})
        assert getattr(eng, name) is value or getattr(eng, name) == value
        eng.close()
    else:
        with pytest.raises(NotImplementedError, match=item):
            make(**{name: value})
    make(**{name: None}).close()


# -- the load generator ---------------------------------------------------------

def test_loadgen_collects_records_with_the_monitor_on(models):
    """``run_load`` with the monitor on: one record a request, TTFT and
    TPOT percentiles, the run's summed prefill and tick times (as many
    prefills and ticks as the engine ran); with it off, none of these,
    and the decode rollup either way."""
    from paddle_tpu_torch.tools import decode_loadgen as LG
    model = models["port"][0]
    wl = [(p, min(n, 20)) for p, n in LG.make_workload(12, (4, 16), 96)]
    off = LG.run_load(model, "continuous", wl, 4, 64, (4, 16))
    assert "records" not in off and "ttft_p50_ms" not in off
    assert off["decode_rollup"]["tokens_per_s"] > 0
    monitor.enable()
    try:
        on = LG.run_load(model, "continuous", wl, 4, 64, (4, 16),
                         sampling=SAMPLED, seed_base=5)
    finally:
        monitor.disable(flush_counters=False)
    assert len(on["records"]) == len(wl)
    assert all(r["outcome"] == "ok" and r["reqkind"] == "decode"
               for r in on["records"])
    assert 0 < on["ttft_p50_ms"] <= on["ttft_p99_ms"]
    assert 0 < on["tpot_p50_ms"] <= on["tpot_p99_ms"]
    assert on["prefill_ms_total"][0] == on["prefills"] == len(wl)
    assert on["tick_ms_total"][0] == on["ticks"]
    assert on["prefill_ms_total"][1] > 0 and on["tick_ms_total"][1] > 0
    # the monitor changes no stream
    again = LG.run_load(model, "continuous", wl, 4, 64, (4, 16),
                        sampling=SAMPLED, seed_base=5)["outputs"]
    assert [o.tolist() for o in on["outputs"]] == [o.tolist() for o in again]


def test_loadgen_main_monitor_writes_events_and_a_trace(tmp_path, capsys):
    import json
    from paddle_tpu_torch.tools import decode_loadgen as LG
    assert LG.main(["--device", "cpu", "--requests", "6", "--mode",
                    "continuous", "--monitor", str(tmp_path)]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["continuous"]["ttft_p99_ms"] > 0
    with open(out["chrome_trace"]) as fh:
        doc = json.load(fh)
    names = {e["name"] for e in doc["traceEvents"]}
    lanes = {e["args"]["name"] for e in doc["traceEvents"]
             if e["ph"] == "M" and e["name"] == "thread_name"}
    assert {"serving.enqueue", "serving.warmup", "prefill"} <= names
    assert any(n.startswith("kv.slot") for n in lanes)
    events = [f for f in tmp_path.iterdir() if f.name.startswith("events-")]
    recs = monitor.read_jsonl(str(events[0]))
    assert sum(r["kind"] == "serving.request" for r in recs) == 6
    assert not monitor.enabled() and not monitor.trace.enabled()
