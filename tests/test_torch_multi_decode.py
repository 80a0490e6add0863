"""The port's decode fleet and the generative engine's supervision surface
(``paddle_tpu_torch.serving.generate``: ``replicate_decode``,
``MultiDecodeEngine``, ``GenerateEngine(replica_id=, on_outcome=)``,
``heartbeat``, ``probe`` and the four fault sites) against the JAX
package's, on the CPU.

The port's models carry the reference's weights across
(``convert.load_jax_state``); the engines are the reference's
single-capacity ones (``tests/test_spec_decode.py:42-48``: four lanes,
``max_len=16``, one prompt bucket). Rules, each with its reason:

* a request moved off a failing or draining replica (bare, without its
  KV) re-prefills on its new replica and regenerates its stream: sampled
  draws are keyed by the request's ``(seed, generation index)`` alone,
  so the moved stream equals the port's unmoved one bit for bit (one
  arena capacity, the same products), and the reference's own stream
  of the same request token for token (the draws are the reference's
  bits) — plain and speculative, as the reference's
  ``test_failover_requeue_is_bit_identical`` and
  ``test_preempt_between_draft_and_verify_requeues_bit_identical`` hold
  for the reference;
* hangs are driven by the fault's explicit ``delay`` and a short
  ``inflight_timeout_ms``; the hung replica's ticks run on a thread the
  test owns, so that the hang lands in a decode tick while the replica
  holds live lanes; every wait has its own timeout.

Isolation: both fault registries cleared, both packages' preemption
subscribers restored, both monitors off, and the reference's flat-arena
hook cleared, around every test. The reference's engines are built once
a module: each JAX engine compiles every executable it meets.
"""
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu.tensor as ref_tensor
from paddle_tpu import monitor as ref_monitor
from paddle_tpu import serving as ref_serving
from paddle_tpu.resilience import faults as ref_faults
from paddle_tpu.resilience import preempt as ref_preempt
from paddle_tpu.serving.generate import GenerateEngine as RefEngine
from paddle_tpu_torch import convert, monitor, serving
from paddle_tpu_torch.resilience import faults, preempt, retry
from paddle_tpu_torch.serving import generate as G
from paddle_tpu_torch.serving import reqtrace

SMALL = dict(vocab=32, dim=16, heads=2, layers=2, max_len=64)
ENGINE = dict(slots=4, page=16, max_len=16, prompt_buckets=(16,))
K = 4
SAMPLED = {"temperature": 0.9, "top_p": 0.95}
FAILOVER_JOB = ([11, 3, 8], 12, 77)
PREEMPT_JOB = ([9, 4, 17, 2], 12, 88)
# the fleet's traffic: (prompt, new tokens, seed), sampled
FLEET_JOBS = [([1 + i, 7, 2 + i % 3][: 1 + i % 3], 8 + i % 5, 300 + i)
              for i in range(8)]
HANG_S = 3.0


@pytest.fixture(autouse=True)
def _isolated():
    hook = ref_tensor._arena_hook
    ref_tensor._arena_hook = None
    saved = [(m, list(m._subscribers)) for m in (ref_preempt, preempt)]
    for f in (ref_faults, faults):
        f.clear()
    for mon in (ref_monitor, monitor):
        mon.disable(flush_counters=False)
        mon.reset()
    yield
    for f in (ref_faults, faults):
        f.clear()
    for mon in (ref_monitor, monitor):
        mon.disable(flush_counters=False)
        mon.reset()
    reqtrace.reset()
    for m, subs in saved:
        m._subscribers[:] = subs
    ref_tensor._arena_hook = hook


def _drive(eng, futs, ticks=3000):
    futs = futs if isinstance(futs, list) else [futs]
    for _ in range(ticks):
        if all(f.done() for f in futs):
            break
        eng.tick()
    return [[int(t) for t in f.result(timeout=10)] for f in futs]


def _engine(model, draft=None, cls=G.GenerateEngine, **kw):
    return cls(model, start=False, draft_model=draft, spec_k=K,
               **dict(ENGINE, **kw))


def _submit(eng, job):
    prompt, n, seed = job
    return eng.submit(prompt, max_new_tokens=n, sampling=SAMPLED, seed=seed)


@pytest.fixture(scope="module")
def ref_model():
    return ref_serving.demo_model(seed=1, **SMALL)


@pytest.fixture(scope="module")
def model(ref_model):
    lm = serving.demo_model(device="cpu", **SMALL)
    return convert.load_jax_state(lm, {k: np.asarray(v) for k, v in
                                       ref_model.state.items()})


@pytest.fixture(scope="module")
def ref_streams(ref_model):
    """The reference's own streams of every job here, plain and
    speculative (a model drafting for itself)."""
    jobs = [FAILOVER_JOB, PREEMPT_JOB] + FLEET_JOBS
    out = {}
    for kind, draft in (("plain", None), ("speculative", ref_model)):
        eng = _engine(ref_model, draft, cls=RefEngine)
        eng.warmup()
        got = _drive(eng, [_submit(eng, j) for j in jobs])
        eng.close(drain=False)
        out[kind] = {j[2]: g for j, g in zip(jobs, got)}
    return out


@pytest.fixture(scope="module")
def engines(model):
    made = {"plain": _engine(model), "speculative": _engine(model, model)}
    for e in made.values():
        e.warmup()
    yield made
    for e in made.values():
        e.close(drain=False)


# -- failover and preemption replay ----------------------------------------------

@pytest.mark.parametrize("kind", ["plain", "speculative"])
def test_failover_requeue_is_bit_identical(model, engines, ref_streams,
                                           kind):
    """A replica fails mid-generation: its in-flight sequence is disowned
    and requeued on a second engine, whose re-prefill regenerates the
    stream a clean run produces, and the reference's."""
    a = _engine(model, model if kind == "speculative" else None)
    a.warmup()
    fut = _submit(a, FAILOVER_JOB)
    for _ in range(2):
        a.tick()                            # partial output on engine A
    assert not fut.done()
    moved = a.disown_inflight() + a.steal_pending()
    assert len(moved) == 1 and a.pool.used_slots() == 0
    a.close(drain=False)
    b = engines[kind]
    b.requeue(moved)
    got = _drive(b, fut)[0]
    want = _drive(b, _submit(b, FAILOVER_JOB))[0]
    assert got == want == ref_streams[kind][FAILOVER_JOB[2]]


class _VerifyHijack:
    """The model with its ``verify_fn`` wrapped: the first call runs
    ``before`` first (a preemption landing between a speculative tick's
    draft and its verify)."""

    def __init__(self, model, before):
        self._model, self._before, self.fired = model, before, False

    def __getattr__(self, name):
        return getattr(self._model, name)

    def verify_fn(self, *args):
        if not self.fired:
            self.fired = True
            self._before()
        return self._model.verify_fn(*args)


def test_preempt_between_draft_and_verify_requeues_bit_identical(
        model, engines, ref_streams):
    """The drain lands after the draft steps proposed a chunk and before
    the target verified it: the disown reclaims the lane and both
    ledgers, the engine survives verifying into the dead lane, and the
    requeued request regenerates its stream on the adopting replica."""
    a = _engine(model, model)
    a.warmup()
    fut = _submit(a, PREEMPT_JOB)
    a.tick()                                # the prefill seats it
    assert not fut.done() and a.pool.used_slots() == 1
    moved = []
    a.model = _VerifyHijack(model, lambda: moved.extend(a.disown_inflight()))
    for _ in range(4):
        a.tick()
        if moved:
            break
    assert len(moved) == 1 and not fut.done()
    assert a.pool.used_slots() == 0
    assert all(s.req is None for s in a._slots)
    assert a.pool.length(0) == 0 and a.draft_pool.length(0) == 0
    a.tick()                                # the engine survived
    a.close(drain=False)
    b = engines["speculative"]
    b.requeue(moved)
    got = _drive(b, fut)[0]
    want = _drive(b, _submit(b, PREEMPT_JOB))[0]
    assert got == want == ref_streams["speculative"][PREEMPT_JOB[2]]


# -- the decode fleet ----------------------------------------------------------------

def _fleet(model, n=2, **kw):
    kw.setdefault("supervise", False)
    f = serving.MultiDecodeEngine(model, devices=["cpu"] * n,
                                  **dict(ENGINE, **kw))
    f.warmup()
    return f


def test_fleet_serves_the_references_streams(model, ref_streams):
    f = _fleet(model)
    f.start()
    try:
        futs = [f.submit(p, max_new_tokens=n, sampling=SAMPLED, seed=s)
                for p, n, s in FLEET_JOBS]
        got = [[int(t) for t in fut.result(timeout=60)] for fut in futs]
        assert got == [ref_streams["plain"][s] for _, _, s in FLEET_JOBS]
        assert [e.stats()["submitted"] for e in f.engines] == [4, 4]
        assert [e.replica_id for e in f.engines] == [0, 1]
        assert [e._lane for e in f.engines] == ["kv0", "kv1"]
    finally:
        f.close(drain=False, timeout=2.0)


@pytest.mark.parametrize("kind", ["plain", "speculative"])
def test_fleet_hang_fails_over_and_replays(model, ref_streams, kind):
    """Replica 1 hangs in a decode tick while it holds live lanes: the
    supervisor trips its breaker and moves its sequences to replica 0,
    which regenerates the reference's streams before the hang ends."""
    f = _fleet(model, start=False, supervise=True,
               supervisor_interval_s=0.02, inflight_timeout_ms=200,
               restart_after_s=60.0, breaker_cooldown_s=600.0,
               draft_model=model if kind == "speculative" else None)
    hung = f._replicas[1].engine
    f._replicas[0].engine.start()           # replica 1 ticks by hand
    ticker = threading.Thread(target=hung.tick, daemon=True)
    try:
        futs = [f.submit(p, max_new_tokens=n, sampling=SAMPLED, seed=s)
                for p, n, s in FLEET_JOBS]
        hung.tick()                         # seats its four lanes
        assert hung.heartbeat()["active"] == 4
        assert hung.heartbeat()["queue_depth"] == 0
        spec = faults.inject("replica_hang", replica=1, delay=HANG_S)
        t0 = time.monotonic()
        ticker.start()
        got = [[int(t) for t in fut.result(timeout=30)] for fut in futs]
        took = time.monotonic() - t0
        assert spec.fired == 1 and took < HANG_S - 0.5
        assert got == [ref_streams[kind][s] for _, _, s in FLEET_JOBS]
        st = f.stats()
        assert st["failovers"] == 1 and st["breakers"][1] == "open"
        d = [x for x in f.supervisor.decisions
             if x["decision"] == "failover"]
        assert len(d) == 1 and d[0]["replica"] == 1 and d[0]["moved"] == 4
    finally:
        f.close(drain=False, timeout=2.0)
        ticker.join(HANG_S + 10.0)          # the hung tick wakes and ends
        assert not ticker.is_alive()


def test_fleet_preempt_notice_drains_and_replays(model, ref_streams):
    f = _fleet(model, supervise=True, supervisor_interval_s=0.02)
    f.start()
    try:
        futs = [f.submit(p, max_new_tokens=n, sampling=SAMPLED, seed=s)
                for p, n, s in FLEET_JOBS]
        faults.inject("preempt_replica", replica=1, times=1)
        got = [[int(t) for t in fut.result(timeout=60)] for fut in futs]
        assert got == [ref_streams["plain"][s] for _, _, s in FLEET_JOBS]
        deadline = time.monotonic() + 10.0
        while not f._replicas[1].draining and time.monotonic() < deadline:
            time.sleep(0.01)
        assert f._replicas[1].state == "draining"
        assert "drain" in [d["decision"] for d in f.supervisor.decisions]
        futs = [f.submit(p, max_new_tokens=n, sampling=SAMPLED, seed=s)
                for p, n, s in FLEET_JOBS[:2]]
        for fut in futs:
            fut.result(timeout=60)
        assert f.engines[1].stats()["submitted"] <= 4
    finally:
        f.close(drain=False, timeout=2.0)


def test_fleet_hedge_takes_the_first_result(model, ref_streams):
    """A straggling replica's request is hedged onto the other replica
    after ``hedge_ms``; the shadow's stream (the same seed, so the same
    tokens) resolves the request first."""
    f = _fleet(model, hedge_ms=30, hedge_budget=1.0)
    f.start()
    try:
        faults.inject("replica_slow", replica=0, delay=2.0)
        p, n, s = FLEET_JOBS[0]
        t0 = time.monotonic()
        got = [int(t) for t in f.submit(p, max_new_tokens=n,
                                        sampling=SAMPLED,
                                        seed=s).result(timeout=30)]
        assert time.monotonic() - t0 < 1.5
        assert got == ref_streams["plain"][s]
        st = f.stats()
        assert st["hedged"] == 1 and st["hedge_wins"] == 1
    finally:
        f.close(drain=False, timeout=2.0)


def test_decode_swap_stamps_the_weights_version(model, ref_model):
    monitor.enable()
    reqtrace.reset()
    f = _fleet(model)
    f.start()
    try:
        job = FLEET_JOBS[0]
        before = [int(t) for t in _submit(f, job).result(timeout=30)]
        other = serving.demo_model(device="cpu", seed=2, **SMALL)
        assert f.swap_weights(other.state) == 1
        after = [int(t) for t in _submit(f, job).result(timeout=30)]
        versions = [r.get("weights_version") for r in reqtrace.recent()
                    if r.get("reqkind") == "decode"]
        assert 0 in versions and 1 in versions
        assert after != before
        for e in f.engines:
            assert e.model is not model     # each replica owns a copy
            assert all((e.model.state[k] == v).all()
                       for k, v in other.state.items())
        assert all((model.state[k] != other.state[k]).any()
                   for k in ("wq0", "embed"))
    finally:
        f.close(drain=False, timeout=2.0)


class _GatedLM(G.DemoLM):
    """``DemoLM`` whose one armed decode call keeps a copy of its inputs
    and its logits, and waits after its first layer until the test opens
    the gate, so that a swap can land in the middle of a tick. The gate
    is a class attribute, shared by every copy a fleet makes."""

    gate = None

    def decode_fn(self, state, tokens, kv, lengths):
        g = type(self).gate
        mine = g is not None and g["armed"]
        if mine:
            g["armed"] = False
            g["inputs"] = (tokens.clone(), {k: v.clone()
                                            for k, v in kv.items()},
                           lengths.clone())
            g["held"] = True
        logits, entry = super().decode_fn(state, tokens, kv, lengths)
        if mine:
            g["logits"] = logits.clone()
        return logits, entry

    def _mlp(self, state, x, layer):
        g = type(self).gate
        if g is not None and g.get("held") and layer == 0:
            g["held"] = False
            g["entered"].set()
            g["open"].wait(30.0)
        return super()._mlp(state, x, layer)


@pytest.mark.parametrize("probe", [False, True])
def test_decode_swap_whose_drain_times_out_leaves_the_running_tick_whole(
        model, probe):
    """A one-replica decode fleet whose tick is still running when the
    swap's drain times out: the swap goes on, as the reference's does,
    and the running step ends on the old weights, every layer of it (its
    logits equal the old weights' on its own inputs); the request then
    completes on the new weights."""
    gated = _GatedLM(device="cpu", **SMALL)
    gated.load_state_dict(model.state_dict())
    other = serving.demo_model(device="cpu", seed=2, **SMALL)
    gate = {"armed": False, "entered": threading.Event(),
            "open": threading.Event()}
    f = _fleet(gated, n=1, start=False)
    eng = f.engines[0]
    ticker = threading.Thread(target=eng.tick, daemon=True)
    try:
        fut = _submit(f, FLEET_JOBS[3])
        eng.tick()                          # seats it, one decode step
        old = {k: v.clone() for k, v in eng.model.state.items()}
        _GatedLM.gate = gate
        gate["armed"] = True
        ticker.start()
        assert gate["entered"].wait(30.0)
        assert f.swap_weights(other.state, drain_timeout_s=0.05,
                              probe=probe) == 1
        gate["open"].set()
        ticker.join(30.0)
        assert not ticker.is_alive()
        tokens, kv, lengths = gate["inputs"]
        with torch.no_grad():
            want, _ = G.DemoLM.decode_fn(gated, old, tokens, kv, lengths)
        torch.testing.assert_close(gate["logits"], want, rtol=0, atol=0)
        assert all(torch.equal(eng.model.state[k], v)
                   for k, v in other.state.items())
        got = _drive(eng, fut)[0]
        assert len(got) == FLEET_JOBS[3][1]
        assert eng.weights_version == 1
    finally:
        _GatedLM.gate = None
        gate["open"].set()
        if ticker.is_alive():
            ticker.join(30.0)
        f.close(drain=False, timeout=2.0)


def test_replicate_decode_copies_the_weights(model):
    reps = G.replicate_decode(model, ["cpu", "cpu", "cpu"])
    assert len(reps) == 3 and len({id(r) for r in reps}) == 3
    for r in reps:
        assert r.device.type == "cpu" and r is not model
        for k, v in model.state.items():
            assert (r.state[k] == v).all()
            assert r.state[k].data_ptr() != v.data_ptr()


# -- the engine's supervision surface -----------------------------------------------

def test_engine_heartbeat_probe_and_outcomes(model):
    calls = []
    eng = _engine(model, replica_id=3,
                  on_outcome=lambda ok, exc: calls.append((ok, exc)))
    assert eng.replica_id == 3 and eng._lane == "kv3"
    assert eng.probe() is None              # nothing met yet
    fut = _submit(eng, FLEET_JOBS[0])
    hb = eng.heartbeat()
    assert hb["queue_depth"] == 1 and hb["active"] == 0
    assert hb["inflight_age_s"] is None and hb["inflight_token"] is None
    eng.tick()
    assert eng.heartbeat()["active"] == 1
    assert calls[:2] == [(True, None), (True, None)]    # prefill, tick
    _drive(eng, fut)
    assert all(ok for ok, _ in calls)
    assert eng.probe(timeout_s=10.0) is True
    assert eng.heartbeat()["last_ok_age_s"] < 5.0
    eng.close(drain=False)
    spec = _engine(model, model)
    spec.warmup()
    assert spec.probe(timeout_s=10.0) is True   # a draft-then-verify step
    spec.close(drain=False)


def test_probe_leaves_a_wedged_engines_arena_alone(model):
    """A probe runs its step over zero arenas of its own, on a side
    thread, while the engine's tick is wedged."""
    eng = _engine(model, replica_id=0)
    eng.warmup()
    fut = _submit(eng, FLEET_JOBS[1])
    eng.tick()
    arena = {k: v.clone() for k, v in eng.pool.buffers.items()}
    faults.inject("replica_hang", replica=0, delay=1.0)
    t = threading.Thread(target=eng.tick, daemon=True)
    t.start()
    deadline = time.monotonic() + 5.0
    while eng.heartbeat()["inflight_age_s"] is None \
            and time.monotonic() < deadline:
        time.sleep(0.005)
    assert eng.heartbeat()["inflight_token"] is not None
    assert eng.probe(timeout_s=10.0) is True
    assert all((eng.pool.buffers[k] == v).all() for k, v in arena.items())
    t.join(10.0)
    assert not t.is_alive()
    _drive(eng, fut)
    eng.close(drain=False)


FAULT_SITES = ["prefill", "decode", "speculative", "import"]


@pytest.mark.parametrize("site", FAULT_SITES)
def test_fault_site_fails_its_requests_and_reports(model, site):
    """``replica_error`` fires at each of the reference's four sites: the
    request (or the tick's wave) fails with the transient error, and the
    engine reports ``(False, exc)`` to its breaker."""
    calls = []
    kw = dict(replica_id=0, on_outcome=lambda ok, exc: calls.append(ok))
    if site == "import":
        src = _engine(model)
        fut0 = _submit(src, FLEET_JOBS[2])
        src.tick()
        src.tick()
        moved = src.disown_inflight(export_kv=True)
        src.close(drain=False)
        eng = _engine(model, kv_import=True, **kw)
        faults.inject("replica_error", replica=0, times=1)
        eng.requeue(moved)
        fut = fut0
    else:
        eng = _engine(model, model if site == "speculative" else None, **kw)
        fut = _submit(eng, FLEET_JOBS[2])
        if site != "prefill":
            eng.tick()                      # seated: the next site is a tick
            assert calls == [True, True]
        faults.inject("replica_error", replica=0, times=1)
    eng.tick()
    with pytest.raises(retry.TransientError, match="replica_error"):
        fut.result(timeout=5)
    assert calls[-1] is False
    assert eng.stats()["failed"] == 1 and eng.pool.used_slots() == 0
    eng.close(drain=False)


def test_restart_rebuilds_the_replica_unwarmed_as_the_reference(
        model, ref_model):
    """A supervisor's restart gives the replica a fresh engine over a
    fresh copy of the weights, keeping its breaker; a decode fleet's
    ``warmup()`` takes no signatures, so the fresh engine is not warmed,
    in the reference too (ROADMAP.md Queue C), and meets its signatures
    under traffic."""
    import jax
    ref = ref_serving.MultiDecodeEngine(
        ref_model, devices=jax.local_devices()[:2], supervise=False,
        **ENGINE)
    f = _fleet(model)
    try:
        ref.warmup()
        got = {}
        for side, fleet in (("ref", ref), ("port", f)):
            rep = fleet._replicas[0]
            old, brk = rep.engine, rep.breaker
            brk.trip("hung")
            fleet._restart(rep)
            got[side] = (rep.engine is not old, rep.breaker is brk,
                         rep.restarts, rep.breaker.state,
                         [e.executables()[0] for e in fleet.engines])
        assert got["port"] == got["ref"] == (True, True, 1, "open",
                                             [0, 3])
        assert f._replicas[0].predictor is not model
        rep = f._replicas[0]
        rep.breaker.cooldown_s = 0.0
        assert rep.breaker.allow()          # half-open: one probe slot
        out = [int(t) for t in _submit(rep.engine, FLEET_JOBS[3])
               .result(timeout=60)]
        assert out == [int(t) for t in _submit(f._replicas[1].engine,
                                               FLEET_JOBS[3])
                       .result(timeout=60)]
        assert rep.engine.executables()[0] > 0      # met under traffic
    finally:
        ref.close(drain=False, timeout=2.0)
        f.close(drain=False, timeout=2.0)


def test_loadgen_fleet_runs_the_loadgens_streams(model):
    """``decode_loadgen``'s fleet run: the same traffic over 1 and 2
    replicas gives ``run_load``'s streams, with no signature met after
    warmup and each replica's ticks counted."""
    from paddle_tpu_torch.tools import decode_loadgen as LG
    wl = [(p, n) for p, n, _ in FLEET_JOBS]
    want = LG.run_load(model, "continuous", wl, 4, 32, (16,),
                       sampling=SAMPLED, seed_base=50)["outputs"]
    for n in (1, 2):
        r = LG.run_fleet(model, wl, n, 4, 32, (16,), sampling=SAMPLED,
                         seed_base=50, profile=n == 2)
        assert r["outputs"] == [np.asarray(o).tolist() for o in want]
        assert r["post_warmup_signatures"] == 0 and len(r["ticks"]) == n
        assert sum(r["routed"]) == len(wl) and len(r["prefills"]) == n
        assert r["launches"] == {}          # no kernel runs on the CPU
        assert r["tokens"] == sum(len(o) for o in want)
        assert r.get("profiled", False) == (n == 2)
