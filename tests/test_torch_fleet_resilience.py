"""The port's fault injection, preemption and circuit breaker
(``paddle_tpu_torch.resilience.faults``, ``resilience.preempt``,
``serving.breaker``) and the batcher's failover hooks, against the JAX
package's, on the CPU.

Rules, each with its reason:

* the breaker is pure host Python over an injectable clock: the same
  schedule of reads, routing calls and outcomes gives the same states,
  open counts and streaks in both packages, on one fake clock;
* a fault spec draws from its own ``random.Random(seed)``: the same specs
  and the same sequence of ``fire`` calls fire the same specs at the same
  calls in both packages;
* preemption is process-global state that exists once a package: each
  scenario runs on either package alone (parametrised), with its handlers
  and subscribers restored afterwards;
* the names and signatures of the ported surface are the reference's.

Isolation: every test clears both fault registries, restores both
packages' preemption subscribers and handler stacks and the signal
handlers it found, turns both monitors off, and runs with the
reference's flat-arena hook cleared (restored after); every wait on a
thread has its own timeout.
"""
import inspect
import os
import signal
import threading
import time

import numpy as np
import pytest

import paddle_tpu.tensor as ref_tensor
from paddle_tpu import monitor as ref_monitor
from paddle_tpu.resilience import faults as ref_faults
from paddle_tpu.resilience import preempt as ref_preempt
from paddle_tpu.resilience import retry as ref_retry
from paddle_tpu.serving import admission as ref_admission
from paddle_tpu.serving import batcher as ref_batcher
from paddle_tpu.serving import breaker as ref_breaker
from paddle_tpu.serving import engine as ref_engine
from paddle_tpu.serving import generate as ref_generate
from paddle_tpu.serving import multi as ref_multi
from paddle_tpu.serving import supervisor as ref_supervisor
from paddle_tpu_torch import monitor
from paddle_tpu_torch.resilience import faults, preempt, retry
from paddle_tpu_torch.serving import (admission, batcher, breaker, engine,
                                      generate, multi, supervisor)

SIGNALS = (signal.SIGTERM, signal.SIGINT, signal.SIGUSR1, signal.SIGUSR2)
PACKAGES = {"ref": (ref_preempt, ref_monitor), "port": (preempt, monitor)}


@pytest.fixture(autouse=True)
def _isolated():
    hook = ref_tensor._arena_hook
    ref_tensor._arena_hook = None
    handlers = {s: signal.getsignal(s) for s in SIGNALS}
    saved = [(m, list(m._subscribers), list(m._install_stack))
             for m in (ref_preempt, preempt)]
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
    for m, subs, stack in saved:
        m._subscribers[:] = subs
        m._install_stack[:] = stack
    for s, h in handlers.items():
        signal.signal(s, h)
    ref_tensor._arena_hook = hook


# -- the breaker: one schedule, both packages, one fake clock ----------------

# (op, arg): "t" sets the clock, "fail"/"ok"/"trip" are outcomes, "allow"
# routes one request, "state" reads the state (which promotes open to
# half_open once the cooldown has passed)
BREAKER_SCHEDULES = {
    # the reference's lifecycle test (tests/test_serving_resilience.py:53)
    "lifecycle": (dict(failure_threshold=2, cooldown_s=5.0,
                       half_open_probes=1, t0=100.0),
                  [("state",), ("allow",), ("fail", "boom"), ("state",),
                   ("fail", "boom"), ("state",), ("allow",),
                   ("t", 104.9), ("state",), ("t", 105.0), ("state",),
                   ("allow",), ("allow",), ("ok",), ("state",),
                   ("allow",)]),
    "success_resets_streak": (dict(failure_threshold=3),
                              [("fail",), ("fail",), ("ok",), ("fail",),
                               ("fail",), ("state",), ("fail",),
                               ("state",)]),
    "half_open_failure_reopens": (dict(failure_threshold=1, cooldown_s=1.0),
                                  [("fail",), ("t", 1.0), ("state",),
                                   ("fail", "probe"), ("state",),
                                   ("t", 1.5), ("state",), ("t", 2.0),
                                   ("state",)]),
    "trip_in_every_state": (dict(failure_threshold=5, cooldown_s=2.0),
                            [("trip", "hung"), ("state",), ("trip", "again"),
                             ("t", 2.0), ("state",), ("trip", "hung"),
                             ("state",), ("t", 4.5), ("allow",), ("ok",),
                             ("trip",), ("state",)]),
    "probe_budget_two": (dict(failure_threshold=1, cooldown_s=1.0,
                              half_open_probes=2),
                         [("fail",), ("t", 1.0), ("allow",), ("allow",),
                          ("allow",), ("ok",), ("state",), ("allow",)]),
    "flapping": (dict(failure_threshold=1, cooldown_s=0.5),
                 [("fail",), ("t", 0.5), ("allow",), ("fail",), ("t", 1.0),
                  ("allow",), ("fail",), ("t", 1.5), ("state",), ("ok",),
                  ("fail",), ("state",), ("t", 1.9), ("state",),
                  ("t", 2.0), ("state",)]),
}


def _run_schedule(cls, knobs, ops):
    clock = [knobs.pop("t0", 0.0)]
    b = cls("r0", clock=lambda: clock[0], **knobs)
    seen = []
    for op, *arg in ops:
        if op == "t":
            clock[0] = arg[0]
            continue
        if op == "state":
            out = b.state
        elif op == "allow":
            out = b.allow()
        elif op == "fail":
            out = b.record_failure(*arg)
        elif op == "ok":
            out = b.record_success()
        else:
            out = b.trip(*arg)
        seen.append((op, out, b._state, b.open_count, b._consecutive))
    return seen


@pytest.mark.parametrize("name", sorted(BREAKER_SCHEDULES))
def test_breaker_schedule_matches_the_reference(name):
    knobs, ops = BREAKER_SCHEDULES[name]
    want = _run_schedule(ref_breaker.CircuitBreaker, dict(knobs), ops)
    got = _run_schedule(breaker.CircuitBreaker, dict(knobs), ops)
    assert got == want
    if name == "lifecycle":
        # the reference test's own expectations, independent of it
        assert [s[1] for s in got if s[0] in ("state", "allow")] == [
            "closed", True, "closed", "open", False, "open", "half_open",
            True, False, "closed", True]


def test_breaker_threshold_validation():
    for cls in (ref_breaker.CircuitBreaker, breaker.CircuitBreaker):
        with pytest.raises(ValueError, match="failure_threshold"):
            cls(failure_threshold=0)


def test_breaker_transitions_record_the_same_series():
    """A trip, the cooldown's half-open and a probe's success set the same
    gauge and counters on both monitors."""
    got = {}
    for side, cls, mon in (("ref", ref_breaker.CircuitBreaker, ref_monitor),
                           ("port", breaker.CircuitBreaker, monitor)):
        mon.enable()
        t = [0.0]
        b = cls("rX", cooldown_s=1.0, clock=lambda: t[0])
        b.trip("hung")
        reg = mon.registry()
        after_trip = (reg.value("serving.breaker_state.rX"),
                      reg.value("serving.breaker_open", 0))
        t[0] = 1.0
        assert b.allow()
        b.record_success()
        got[side] = (after_trip, reg.value("serving.breaker_state.rX"),
                     reg.value("serving.breaker_closed", 0))
        mon.disable(flush_counters=False)
    assert got["port"] == got["ref"] == ((2, 1), 0, 1)


# -- the fault registry: one firing schedule, both packages ------------------

# specs as inject() keywords, and the (kind, step, replica, site) calls
FAULT_SCHEDULES = {
    "probability_0.3": ([dict(kind="replica_error", probability=0.3,
                              times=None, seed=1)],
                        [("replica_error", None, 0, None)] * 50),
    "probability_0.7_budget_5": ([dict(kind="replica_slow", probability=0.7,
                                       times=5, seed=5)],
                                 [("replica_slow", None, r % 3, None)
                                  for r in range(40)]),
    "replica_1_twice": ([dict(kind="replica_hang", replica=1, times=2)],
                        [("replica_hang", None, r % 4, None)
                         for r in range(12)]),
    "replica_list": ([dict(kind="replica_error", replica=[0, 2],
                           times=None)],
                     [("replica_error", None, r % 4, None)
                      for r in range(12)] + [("replica_error", None, None,
                                              None)]),
    "steps": ([dict(kind="slow_step", step=[3, 7], times=None)],
              [("slow_step", s, None, None) for s in range(10)]
              + [("slow_step", None, None, None)]),
    "site_prefill": ([dict(kind="replica_error", replica=0, site="prefill",
                           times=None)],
                     [("replica_error", None, 0, site) for site in
                      ("decode", "prefill", None, "prefill")]),
    "two_specs_in_order": ([dict(kind="replica_error", replica=0, times=1),
                            dict(kind="replica_error", probability=0.5,
                                 times=3, seed=9)],
                           [("replica_error", None, r % 2, None)
                            for r in range(30)]),
    "kinds_apart": ([dict(kind="preempt_replica", replica=2, times=1),
                     dict(kind="replica_slow", probability=0.4, times=None,
                          seed=3)],
                    [(k, None, r % 3, None) for r in range(20)
                     for k in ("preempt_replica", "replica_slow",
                               "replica_error")]),
}


def _fire_all(mod, specs, calls):
    mod.clear()
    made = [mod.inject(**dict(s)) for s in specs]
    fired = []
    for kind, step, replica, site in calls:
        spec = mod.fire(kind, step, replica=replica, site=site)
        fired.append(None if spec is None else made.index(spec))
    out = fired, [s.fired for s in made], mod.enabled()
    mod.clear()
    return out


@pytest.mark.parametrize("name", sorted(FAULT_SCHEDULES))
def test_fault_schedule_matches_the_reference(name):
    specs, calls = FAULT_SCHEDULES[name]
    want = _fire_all(ref_faults, specs, calls)
    got = _fire_all(faults, specs, calls)
    assert got == want
    assert any(i is not None for i in got[0])


def test_serving_fault_error_targets_one_replica():
    """``replica_error`` raises the package's TransientError at its
    replica only, within its budget; the engine's retry policy sees it as
    transient."""
    for mod, transient in ((ref_faults, ref_retry.TransientError),
                           (faults, retry.TransientError)):
        spec = mod.inject("replica_error", replica=1, times=1)
        mod.maybe_serving_fault(0)
        assert spec.fired == 0
        with pytest.raises(transient) as ei:
            mod.maybe_serving_fault(1)
        assert "replica_error" in str(ei.value)
        mod.maybe_serving_fault(1)          # budget spent
        assert spec.fired == 1
    assert retry.is_transient(ei.value)


@pytest.mark.parametrize("kind", ["replica_slow", "replica_hang"])
def test_serving_fault_sleeps_its_delay(kind):
    """``replica_slow`` sleeps its delay; ``replica_hang`` honours an
    explicit delay (its 30 s default leaves the hang to supervision)."""
    faults.inject(kind, replica=0, delay=0.05)
    t0 = time.monotonic()
    faults.maybe_serving_fault(0)
    assert 0.04 <= time.monotonic() - t0 < 5.0
    t0 = time.monotonic()
    faults.maybe_serving_fault(0)           # budget spent: no sleep
    assert time.monotonic() - t0 < 0.04


def test_maybe_raise_sleep_and_host_loss_match_the_reference():
    got = {}
    for side, mod in (("ref", ref_faults), ("port", faults)):
        spec = mod.inject("host_loss", step=4, lost=3)
        mod.maybe_raise("host_loss", step=3)
        with pytest.raises(mod.HostLossError) as ei:
            mod.maybe_raise("host_loss", step=4)
        mod.inject("slow_step", delay=0.01, times=1)
        slept = (mod.maybe_sleep("slow_step"), mod.maybe_sleep("slow_step"))
        mod.inject("loader", exc=ValueError, times=1)
        with pytest.raises(ValueError, match="injected loader fault"):
            mod.maybe_raise("loader")
        got[side] = (ei.value.lost, str(ei.value), spec.fired, slept)
        mod.clear()
    assert got["port"] == got["ref"]
    assert got["port"][0] == 3 and got["port"][3] == (True, False)


@pytest.mark.parametrize("size,nbytes,seed", [(64, 16, 0), (5, 16, 3),
                                              (0, 4, 1)])
def test_garble_file_matches_the_reference(tmp_path, size, nbytes, seed):
    data = bytes(np.random.RandomState(seed).randint(0, 256, size)
                 .astype(np.uint8))
    out = {}
    for side, mod in (("ref", ref_faults), ("port", faults)):
        path = tmp_path / side
        path.write_bytes(data)
        mod.garble_file(str(path), nbytes=nbytes, seed=seed)
        out[side] = path.read_bytes()
    assert out["port"] == out["ref"]
    assert out["port"] != data
    assert len(out["port"]) == max(size, 1)


def test_load_env_reads_only_the_ports_variable(monkeypatch):
    """The port loads ``PADDLE_TPU_TORCH_FAULTS`` into the same specs the
    reference loads from ``PADDLE_TPU_FAULTS``; the reference's variable
    never touches the port."""
    raw = ('[{"kind": "replica_error", "replica": [0, 1], "times": 2}, '
           '{"kind": "replica_slow", "probability": 0.5, "delay": 0.1}]')
    monkeypatch.setenv("PADDLE_TPU_FAULTS", raw)
    assert faults.load_env() == []
    assert not faults.enabled()
    monkeypatch.setenv("PADDLE_TPU_TORCH_FAULTS", raw)
    want = ref_faults.load_env()
    got = faults.load_env()
    fields = ("kind", "replicas", "times", "probability", "delay", "steps")
    assert [[getattr(s, f) for f in fields] for s in got] == \
        [[getattr(s, f) for f in fields] for s in want]
    assert faults.enabled()


# -- preemption: each scenario on either package ------------------------------

def _scenario_subscribe_notify(pre, mon):
    mon.enable()
    got = []
    cb1 = pre.subscribe(lambda sig: got.append(("a", sig)))
    cb2 = pre.subscribe(lambda sig: got.append(("b", sig)))
    pre.notify(signal.SIGTERM)
    assert got == [("a", signal.SIGTERM), ("b", signal.SIGTERM)]
    assert mon.registry().value("resilience.preempt.notice", 0) == 1
    pre.unsubscribe(cb1)
    pre.unsubscribe(cb1)                    # idempotent
    pre.notify(None)
    assert got[-1] == ("b", None) and len(got) == 3
    pre.unsubscribe(cb2)


def _scenario_broken_subscriber(pre, mon):
    got = []

    def boom(sig):
        raise RuntimeError("subscriber bug")

    cb1 = pre.subscribe(boom)
    cb2 = pre.subscribe(got.append)
    with pytest.warns(UserWarning, match="subscriber"):
        pre.notify(signal.SIGTERM)
    assert got == [signal.SIGTERM]
    pre.unsubscribe(cb1)
    pre.unsubscribe(cb2)


def _scenario_request_broadcasts_once(pre, mon):
    mon.enable()
    got = []
    cb = pre.subscribe(got.append)
    h = pre.PreemptionHandler(signals=(), on_preempt=got.append)
    h.request(signal.SIGTERM)
    assert got == [signal.SIGTERM, signal.SIGTERM] and h.triggered
    h.request(signal.SIGTERM)               # latched: one broadcast
    assert len(got) == 2
    assert mon.registry().value("resilience.preempt_signal", 0) == 1
    pre.unsubscribe(cb)


def _scenario_attach_accumulates(pre, mon):
    h = pre.PreemptionHandler(signals=())
    calls = []

    def save_a(step):
        calls.append(("a", step))

    def broken(step):
        raise OSError("disk full")

    h.attach(save_fn=save_a)
    h.attach(save_fn=save_a)                # registered once
    h.attach(save_fn=lambda step: calls.append(("b", step)))
    h.attach(save_fn=broken)
    h.notify_step(7)
    with pytest.warns(UserWarning, match="final save"):
        h.request(signal.SIGTERM)
    assert calls == [("a", 7), ("b", 7)] and h.flushed_step == 7
    h.detach(save_fn=save_a)
    assert len(h._save_fns) == 2
    h.detach()
    assert h._save_fns == []


def _scenario_stacked_uninstall_lifo_safe(pre, mon):
    """Two handlers chain on one signal; removing the first splices it out
    of the chain instead of clobbering the second's registration."""
    h1 = pre.PreemptionHandler(signals=(signal.SIGUSR2,)).install()
    h2 = pre.PreemptionHandler(signals=(signal.SIGUSR2,)).install()
    try:
        h1.uninstall()                      # out of order: splice
        os.kill(os.getpid(), signal.SIGUSR2)
        deadline = time.monotonic() + 5.0
        while not h2.triggered and time.monotonic() < deadline:
            time.sleep(0.01)
        assert h2.triggered and not h1.triggered
    finally:
        h2.uninstall()


def _scenario_chains_and_restores(pre, mon):
    seen = []
    signal.signal(signal.SIGUSR1, lambda s, f: seen.append(s))
    h = pre.PreemptionHandler(signals=(signal.SIGUSR1,)).install()
    signal.raise_signal(signal.SIGUSR1)
    assert h.triggered
    assert seen == [signal.SIGUSR1]         # the previous handler ran
    h.uninstall()
    signal.raise_signal(signal.SIGUSR1)
    assert seen == [signal.SIGUSR1, signal.SIGUSR1]
    assert not h._installed and h._previous == {}


def _scenario_request_without_signal(pre, mon):
    h = pre.PreemptionHandler()
    assert not h.triggered
    with h:                                 # context-manager install
        h.request()
        assert h.triggered
    assert h.flushed_step is None           # no signal: no flush
    off_thread = pre.PreemptionHandler(signals=(signal.SIGUSR2,))
    t = threading.Thread(target=off_thread.install)
    t.start()
    t.join(5.0)
    assert not t.is_alive()
    assert not off_thread._installed        # not the main thread: a no-op


PREEMPT_SCENARIOS = {f.__name__[len("_scenario_"):]: f for f in (
    _scenario_subscribe_notify, _scenario_broken_subscriber,
    _scenario_request_broadcasts_once, _scenario_attach_accumulates,
    _scenario_stacked_uninstall_lifo_safe, _scenario_chains_and_restores,
    _scenario_request_without_signal)}


@pytest.mark.parametrize("side", sorted(PACKAGES))
@pytest.mark.parametrize("name", sorted(PREEMPT_SCENARIOS))
def test_preempt_scenario(name, side):
    PREEMPT_SCENARIOS[name](*PACKAGES[side])


def test_notify_reaches_only_its_own_package():
    """Each package keeps its own subscribers: a notice in one never
    reaches the other's fleets."""
    got = []
    preempt.subscribe(lambda sig: got.append("port"))
    ref_preempt.subscribe(lambda sig: got.append("ref"))
    preempt.notify(None)
    ref_preempt.notify(None)
    assert got == ["port", "ref"]


# -- the batcher's failover hooks ---------------------------------------------

BATCHERS = {"ref": (ref_batcher, ref_admission), "port": (batcher, admission)}


def _req(bmod, n=1):
    return bmod.Request((np.zeros((n, 4), "f4"),), n, "s")


def _dispatched(b, timeout=5.0):
    deadline = time.monotonic() + timeout
    while b.inflight_token() is None and time.monotonic() < deadline:
        time.sleep(0.005)
    return b.inflight_token() is not None


@pytest.mark.parametrize("side", sorted(BATCHERS))
def test_close_nodrain_resolves_the_dispatched_future(side):
    bmod, amod = BATCHERS[side]
    release = threading.Event()

    def process(group):
        release.wait(10.0)                  # a hung replica
        for r in group:
            r.resolve_result(None)

    b = bmod.DynamicBatcher(process, amod.AdmissionController(),
                            max_batch=4, timeout_ms=1.0)
    b.start()
    r = _req(bmod)
    b.submit(r)
    try:
        assert _dispatched(b)
        assert b.inflight_age() >= 0.0
        b.close(drain=False, timeout=0.2)   # bounded join: wedged thread
        assert r.future.done()
        with pytest.raises(RuntimeError, match="still dispatched"):
            r.future.result()
    finally:
        release.set()


@pytest.mark.parametrize("side", sorted(BATCHERS))
def test_close_nodrain_leaves_disowned_inflight_alone(side):
    bmod, amod = BATCHERS[side]
    release = threading.Event()
    b = bmod.DynamicBatcher(lambda group: release.wait(10.0),
                            amod.AdmissionController(), max_batch=4,
                            timeout_ms=1.0)
    b.start()
    r = _req(bmod)
    b.submit(r)
    try:
        assert _dispatched(b)
        assert b.disown_inflight() == [r]   # failover took ownership
        b.close(drain=False, timeout=0.2)
        assert not r.future.done()          # the new owner resolves it
        r.resolve_result("rescued")
        assert r.future.result(timeout=5) == "rescued"
    finally:
        release.set()


@pytest.mark.parametrize("side", sorted(BATCHERS))
def test_steal_and_requeue_keep_order_without_readmission(side):
    """Stolen requests leave the queue in order; requeued ones go to its
    front in order, past a full admission bound (they were admitted
    where they came from), and fail on a closed batcher."""
    bmod, amod = BATCHERS[side]
    b = bmod.DynamicBatcher(lambda group: None,
                            amod.AdmissionController(max_queue_depth=2),
                            max_batch=4, timeout_ms=1.0)
    first = [_req(bmod) for _ in range(2)]
    for r in first:
        b.submit(r)
    assert b.steal_pending() == first and b.depth() == 0
    b.submit(_req(bmod))
    b.submit(tail := _req(bmod))
    b.requeue(first)
    assert b.depth() == 4
    assert b.steal_pending()[:2] == first
    assert b.last_progress_age() >= 0.0 and b.inflight_age() is None
    b.close(drain=False)
    late = _req(bmod)
    b.requeue([late])
    with pytest.raises(RuntimeError, match="closed"):
        late.future.result(timeout=1)
    assert not tail.future.done()


# -- names and signatures -----------------------------------------------------

def _public(obj):
    if inspect.isclass(obj):
        return ["__init__"] + sorted(
            n for n, v in vars(obj).items()
            if not n.startswith("_") and callable(v))
    return [None]


SURFACE = [
    (ref_breaker.CircuitBreaker, breaker.CircuitBreaker),
    (ref_faults.FaultSpec, faults.FaultSpec),
    (ref_faults.HostLossError, faults.HostLossError),
    (ref_preempt.PreemptionHandler, preempt.PreemptionHandler),
    (ref_multi.MultiDeviceEngine, multi.MultiDeviceEngine),
    (ref_supervisor.ServingSupervisor, supervisor.ServingSupervisor),
    (ref_generate.MultiDecodeEngine, generate.MultiDecodeEngine),
    (ref_engine.ServingEngine, engine.ServingEngine),
    (ref_generate.GenerateEngine, generate.GenerateEngine),
    (ref_batcher.DynamicBatcher, batcher.DynamicBatcher),
] + [(getattr(ref_faults, n), getattr(faults, n)) for n in (
    "inject", "clear", "enabled", "fire", "maybe_raise", "maybe_sleep",
    "maybe_serving_fault", "garble_file")] + [
    (getattr(ref_preempt, n), getattr(preempt, n))
    for n in ("subscribe", "unsubscribe", "notify")] + [
    (ref_multi.replicate, multi.replicate),
    (ref_generate.replicate_decode, generate.replicate_decode),
    (ref_multi.health, multi.health),
    (ref_multi.publish_gauges, multi.publish_gauges),
    (ref_multi.last_lifecycle, multi.last_lifecycle),
    (ref_supervisor.last_decision, supervisor.last_decision)]


@pytest.mark.parametrize("ref_obj,obj", SURFACE,
                         ids=[f"{o.__module__.split('.')[-1]}."
                              f"{o.__qualname__}" for _, o in SURFACE])
def test_surface_has_the_references_names_and_signatures(ref_obj, obj):
    """Every public method (or the function) exists in the port with the
    reference's parameter names, order and defaults (a thread's name
    carries its package's). The port's classes may have more."""
    assert obj.__name__ == ref_obj.__name__
    for name in _public(ref_obj):
        r = ref_obj if name is None else getattr(ref_obj, name)
        p = obj if name is None else getattr(obj, name, None)
        assert p is not None, f"{obj.__qualname__}.{name} is missing"
        rs, ps = inspect.signature(r), inspect.signature(p)
        assert list(ps.parameters) == list(rs.parameters), name
        for q in rs.parameters.values():
            want = q.default
            if isinstance(want, str):       # thread names carry the package
                want = want.replace("paddle_tpu-", "paddle_tpu_torch-")
            assert ps.parameters[q.name].default == want, (name, q.name)
