"""The port's multi-replica serving (``paddle_tpu_torch.serving.multi``:
``replicate``, ``MultiDeviceEngine``; ``serving.supervisor``:
``ServingSupervisor``; ``ServingEngine``'s supervision surface) against
the JAX package's, on the CPU.

The reference's fleet spans two of the CPU mesh's devices
(``jax.local_devices()[:2]``); the port's spans ``["cpu", "cpu"]``, two
replicas on one device, each with its own copy of the weights, as the
replicas of a fleet on one card have. Weights cross with
``convert.load_jax_state``.

Rules, each with its reason:

* outputs: within 1e-5 of the reference's (float32 products summed in
  another order, through another batch composition);
* routing, drains, swaps and their refusals: the same observable sequence
  (which replica took how many requests, breaker and routing states,
  versions, lifecycle events) as the reference's on the same calls, made
  one blocking call at a time so that the sequence is deterministic;
* the supervisor's verdicts: both packages' supervisors tick over one
  scripted fleet (heartbeats, probe results and SLO windows set by the
  test, breakers on one fake clock) and must take the same decisions;
* hangs: driven by the fault's explicit ``delay`` and a short
  ``inflight_timeout_ms``, every wait with its own timeout; the hang must
  be resolved by failover, well before the sleep ends.

Isolation: as in ``test_torch_fleet_resilience.py`` (both fault
registries, both packages' preemption state, signal handlers, monitors,
and the reference's flat-arena hook); every fleet is closed.
"""
import signal
import threading
import time

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.tensor as ref_tensor
from paddle_tpu import inference as ref_inference
from paddle_tpu import monitor as ref_monitor
from paddle_tpu import nn as ref_nn
from paddle_tpu.models.bert import Bert as RefBert
from paddle_tpu.models.bert import BertConfig as RefBertConfig
from paddle_tpu.resilience import faults as ref_faults
from paddle_tpu.resilience import preempt as ref_preempt
from paddle_tpu.serving import breaker as ref_breaker
from paddle_tpu.serving import metrics as ref_metrics
from paddle_tpu.serving import multi as ref_multi
from paddle_tpu.serving import supervisor as ref_supervisor
from paddle_tpu_torch import convert, inference, monitor, nn, serving
from paddle_tpu_torch.models import Bert, BertConfig
from paddle_tpu_torch.resilience import faults, preempt, retry
from paddle_tpu_torch.serving import breaker, metrics, multi, supervisor
from paddle_tpu_torch.serving.engine import ServingEngine

TOL = dict(atol=1e-5, rtol=1e-5)
SIG = [((16,), "float32")]


@pytest.fixture(autouse=True)
def _isolated():
    hook = ref_tensor._arena_hook
    ref_tensor._arena_hook = None
    handlers = {s: signal.getsignal(s) for s in (signal.SIGTERM,
                                                 signal.SIGINT)}
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
    for m, subs in saved:
        m._subscribers[:] = subs
    for s, h in handlers.items():
        signal.signal(s, h)
    ref_tensor._arena_hook = hook


def _ref_mlp(seed=0):
    pt.seed(seed)
    return ref_nn.Sequential(ref_nn.Linear(16, 32), ref_nn.ReLU(),
                             ref_nn.Linear(32, 4))


def _arrays(ref_layer):
    return {k: np.asarray(v.numpy())
            for k, v in ref_layer.state_dict().items()}


def _port_mlp(ref_layer):
    m = nn.Sequential(nn.Linear(16, 32), nn.ReLU(), nn.Linear(32, 4))
    return convert.load_jax_state(m, _arrays(ref_layer))


def _fleets(n=2, seed=0, **kw):
    """(reference fleet, port fleet) over one MLP's weights."""
    kw.setdefault("max_batch", 8)
    kw.setdefault("timeout_ms", 1.0)
    kw.setdefault("supervise", False)
    kw.setdefault("hedge_ms", 0)
    ref = _ref_mlp(seed)
    rf = ref_multi.MultiDeviceEngine(ref_inference.Predictor(ref),
                                     devices=jax.local_devices()[:n], **kw)
    pf = multi.MultiDeviceEngine(
        inference.Predictor(_port_mlp(ref), device="cpu"),
        devices=["cpu"] * n, **kw)
    for f in (rf, pf):
        f.warmup(SIG)
    return rf, pf


def _close(*fleets):
    for f in fleets:
        f.close(drain=False, timeout=2.0)


def _x(seed, rows=2):
    return np.random.RandomState(seed).rand(rows, 16).astype("f4")


def _submitted(fleet):
    return [r.engine.stats()["submitted"] for r in fleet._replicas]


# -- replicate -----------------------------------------------------------------

def test_replicate_gives_each_replica_its_own_weights():
    ref = _ref_mlp()
    pred = inference.Predictor(_port_mlp(ref), device="cpu")
    reps = multi.replicate(pred, ["cpu", "cpu"])
    assert [r.device for r in reps] == [torch.device("cpu")] * 2
    for r in reps:
        assert r._compiled == {} and r.model is not pred.model
        for (name, a), b in zip(r.state.items(), pred.state.values()):
            assert torch.equal(a, b) and a.data_ptr() != b.data_ptr(), name
    with torch.no_grad():
        next(iter(reps[0].state.values())).add_(1.0)
    first = [next(iter(p.state.values())) for p in (reps[1], pred)]
    assert torch.equal(*first)              # only replica 0 moved
    if torch.cuda.is_available():
        assert multi.fleet_devices()[0].type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            multi.replicate(pred)           # no card: no CPU fallback
    with pytest.raises(ValueError, match="no devices"):
        multi.replicate(pred, [])


# -- routing -------------------------------------------------------------------

def test_round_robin_outputs_match_the_reference():
    rf, pf = _fleets()
    try:
        xs = [_x(i, rows) for i, rows in enumerate((2, 3, 1, 4))]
        want = [rf.run(x, timeout=30) for x in xs]
        got = [pf.run(x, timeout=30) for x in xs]
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, np.asarray(w), **TOL)
        assert _submitted(pf) == _submitted(rf) == [2, 2]
        st = pf.stats()
        assert st["completed"] == 4 and len(st["replicas"]) == 2
        assert st["devices"] == ["cpu", "cpu"]
    finally:
        _close(rf, pf)


def test_routes_around_an_open_breaker():
    rf, pf = _fleets()
    try:
        seen = {}
        for side, f, err in (("ref", rf, ref_multi.NoHealthyReplicaError),
                             ("port", pf, multi.NoHealthyReplicaError)):
            f._replicas[0].breaker.trip("test")
            for i in range(6):
                f.run(_x(i), timeout=30)
            routed = _submitted(f)
            states = f.stats()["breakers"]
            f._replicas[1].breaker.trip("test")
            with pytest.raises(err) as ei:
                f.submit(_x(0))
            seen[side] = (routed, states, f.health()["all_open"],
                          ei.value.retry_after_ms, ei.value.level)
        assert seen["port"] == seen["ref"]
        assert seen["port"][0] == [0, 6]
        assert seen["port"][3] > 0 and retry.is_transient(ei.value)
        assert seen["port"][2] is True
    finally:
        _close(rf, pf)


def test_replica_errors_open_its_breaker_through_on_outcome():
    """``replica_error`` on replica 0, within the retry policy's budget:
    every request succeeds, and replica 0's three failed attempts open
    its breaker (the engine's ``on_outcome``), so traffic moves to
    replica 1 — in both packages."""
    from paddle_tpu.resilience.retry import RetryPolicy as RefRetryPolicy
    seen = {}
    for side, mod, fmod, policy in (
            ("ref", ref_multi, ref_faults, RefRetryPolicy),
            ("port", multi, faults, retry.RetryPolicy)):
        ref = _ref_mlp()
        pred = (ref_inference.Predictor(ref) if side == "ref" else
                inference.Predictor(_port_mlp(ref), device="cpu"))
        f = mod.MultiDeviceEngine(
            pred, devices=(jax.local_devices()[:2] if side == "ref"
                           else ["cpu", "cpu"]),
            max_batch=8, timeout_ms=1.0, supervise=False, hedge_ms=0,
            breaker_cooldown_s=600.0,
            retry_policy=policy(max_attempts=4, base_delay=0.001,
                                max_delay=0.001, jitter=0.0))
        try:
            spec = fmod.inject("replica_error", replica=0, times=3)
            outs = [np.asarray(f.run(_x(i), timeout=30)) for i in range(6)]
            st = f.stats()
            seen[side] = (spec.fired, st["breakers"], _submitted(f),
                          st["retries"], st["failed"], outs)
        finally:
            _close(f)
    assert seen["port"][:5] == seen["ref"][:5]
    assert seen["port"][:5] == (3, {0: "open", 1: "closed"}, [1, 5], 3, 0)
    for g, w in zip(seen["port"][5], seen["ref"][5]):
        np.testing.assert_allclose(g, w, **TOL)


def test_engine_supervision_surface():
    """``ServingEngine``'s heartbeat, probe (None before traffic or warmup;
    a failing replica fails it) and failover hand-offs."""
    ref = _ref_mlp()
    calls = []
    eng = ServingEngine(inference.Predictor(_port_mlp(ref), device="cpu"),
                        max_batch=8, timeout_ms=1.0, start=False,
                        replica_id=3,
                        on_outcome=lambda ok, exc: calls.append(ok))
    try:
        assert eng.replica_id == 3 and eng.probe() is None
        hb = eng.heartbeat()
        assert hb["inflight_age_s"] is None and hb["active"] == 0
        futs = [eng.submit(_x(i)) for i in range(3)]
        assert eng.heartbeat()["queue_depth"] == 3
        stolen = eng.steal_pending()
        assert [r.future for r in stolen] == futs
        assert eng.disown_inflight() == []
        eng.requeue(stolen)
        eng.start()
        for f in futs:
            f.result(timeout=30)
        assert calls and all(calls)
        assert eng.probe(timeout_s=10.0) is True
        faults.inject("replica_error", replica=3, times=1)
        assert eng.probe(timeout_s=10.0) is False
        faults.inject("replica_error", replica=4, times=1)
        assert eng.probe(timeout_s=10.0) is True    # another replica's
    finally:
        eng.close()
    fresh = ServingEngine(inference.Predictor(_port_mlp(ref), device="cpu"),
                          max_batch=8, start=False)
    fresh.warmup(SIG)
    assert fresh.probe(timeout_s=10.0) is True      # warmup's template
    fresh.close()


# -- lifecycle: drains and preemption --------------------------------------------

def test_drain_replica_migrates_refuses_then_readmits():
    rf, pf = _fleets()
    try:
        seen = {}
        for side, f in (("ref", rf), ("port", pf)):
            futs = [f.submit(_x(i)) for i in range(4)]
            f.drain_replica(0, reason="test")
            for fut in futs:
                fut.result(timeout=30)      # no loss through the drain
            draining = (f._replicas[0].state, f._replicas[0].breaker.state)
            before = _submitted(f)
            for i in range(4):
                f.run(_x(i), timeout=30)
            after = _submitted(f)
            again = f.drain_replica(0)      # already draining: a no-op
            f.undrain_replica(0, reason="test")
            f.run(_x(9), timeout=30)
            seen[side] = (draining, after[0] - before[0],
                          f.stats()["draining_replicas"], again,
                          f._lifecycle["event"])
        assert seen["port"] == seen["ref"]
        assert seen["port"] == (("draining", "closed"), 0, 0, 0, "undrain")
    finally:
        _close(rf, pf)


def test_drain_fleet_finishes_inflight_then_sheds():
    rf, pf = _fleets()
    try:
        for f, err in ((rf, ref_multi.NoHealthyReplicaError),
                       (pf, multi.NoHealthyReplicaError)):
            futs = [f.submit(_x(i)) for i in range(6)]
            assert f.drain_fleet(reason="test") == 2
            for fut in futs:
                fut.result(timeout=30)
            assert f.drain_wait(timeout_s=10.0) and f.drained()
            with pytest.raises(err):
                f.submit(_x(0))
            assert f.health()["all_open"]
    finally:
        _close(rf, pf)


def test_notify_drains_every_live_fleet_and_close_unsubscribes():
    """A preemption notice drains every live fleet of its own package
    only; a closed fleet is unsubscribed."""
    rf, pf = _fleets()
    rf2, pf2 = _fleets()
    try:
        pf2.close(drain=False, timeout=2.0)
        preempt.PreemptionHandler(signals=()).request(signal.SIGTERM)
        assert all(r.draining for r in pf._replicas)
        assert pf._lifecycle["event"] == "drain_fleet"
        assert "preempt" in pf._lifecycle["reason"]
        assert pf2._lifecycle is None       # closed: not notified
        assert not any(r.draining for r in rf._replicas)
        assert multi.last_lifecycle()["event"] == "drain_fleet"
    finally:
        # the second reference fleet too: left open, its engines' batchers
        # would go on writing the reference's monitor in later files
        _close(rf, pf, rf2)
    n = len(preempt._subscribers)
    preempt.notify(None)                    # dead fleets: no error
    assert len(preempt._subscribers) == n


def test_supervisor_preempt_fault_drains_a_replica():
    ref = _ref_mlp()
    f = multi.MultiDeviceEngine(
        inference.Predictor(_port_mlp(ref), device="cpu"),
        devices=["cpu"] * 3, max_batch=8, timeout_ms=1.0, hedge_ms=0,
        supervise=True, supervisor_interval_s=0.02)
    try:
        f.warmup(SIG)
        faults.inject("preempt_replica", replica=1, times=1)
        deadline = time.monotonic() + 10.0
        while not f._replicas[1].draining and time.monotonic() < deadline:
            time.sleep(0.01)
        assert f._replicas[1].draining
        assert "drain" in [d["decision"] for d in f.supervisor.decisions]
        assert supervisor.last_decision()["decision"] in ("drain",)
        np.testing.assert_allclose(
            f.run(_x(5), timeout=30),
            ref_inference.Predictor(ref).run(_x(5)), **TOL)
        h = f.health()
        assert h["replicas"][1]["state"] == "draining"
        assert h["all_open"] is False and h["supervisor"] is not None
    finally:
        _close(f)


# -- hang failover and hedging ---------------------------------------------------

HANG_S = 3.0


def test_hang_fails_over_before_the_hang_ends():
    """Replica 0 hangs inside its first batch: the supervisor's verdict
    trips its breaker and moves the batch to replica 1, which serves it
    with the reference's outputs long before the hang would end."""
    ref = _ref_mlp()
    f = multi.MultiDeviceEngine(
        inference.Predictor(_port_mlp(ref), device="cpu"),
        devices=["cpu", "cpu"], max_batch=8, timeout_ms=1.0, hedge_ms=0,
        supervise=True, supervisor_interval_s=0.02, inflight_timeout_ms=200,
        restart_after_s=60.0, breaker_cooldown_s=600.0)
    try:
        f.warmup(SIG)
        spec = faults.inject("replica_hang", replica=0, delay=HANG_S)
        t0 = time.monotonic()
        futs = [f.submit(_x(i)) for i in range(4)]
        outs = [fut.result(timeout=20) for fut in futs]
        took = time.monotonic() - t0
        assert spec.fired == 1 and took < HANG_S - 1.0
        want = ref_inference.Predictor(ref)
        for i, o in enumerate(outs):
            np.testing.assert_allclose(o, want.run(_x(i)), **TOL)
        decisions = [d["decision"] for d in f.supervisor.decisions]
        assert decisions.count("failover") == 1
        st = f.stats()
        assert st["failovers"] == 1 and st["breakers"][0] == "open"
    finally:
        wedged = f._replicas[0].engine._batcher._thread
        _close(f)
        wedged.join(HANG_S + 10.0)          # the hung batch wakes and ends
        assert not wedged.is_alive()


def test_hedge_on_a_straggler_takes_the_first_result():
    ref = _ref_mlp()
    f = multi.MultiDeviceEngine(
        inference.Predictor(_port_mlp(ref), device="cpu"),
        devices=["cpu", "cpu"], max_batch=8, timeout_ms=1.0, hedge_ms=30,
        hedge_budget=1.0, supervise=False)
    try:
        f.warmup(SIG)
        faults.inject("replica_slow", replica=0, delay=2.0)
        t0 = time.monotonic()
        out = f.run(_x(1), timeout=20)      # round robin: replica 0 first
        assert time.monotonic() - t0 < 1.5
        np.testing.assert_allclose(out, ref_inference.Predictor(ref).run(
            _x(1)), **TOL)
        st = f.stats()
        assert st["hedged"] == 1 and st["hedge_wins"] == 1
    finally:
        _close(f)


def test_restart_rebuilds_a_warmed_replica_on_the_swapped_weights():
    """A restart gives the replica a fresh engine over a fresh copy of the
    weights, warmed with the fleet's remembered signatures, keeping its
    breaker (and its flap history); after a swap the copy carries the
    swapped-in weights, not the template's."""
    ref = _ref_mlp()
    pred = inference.Predictor(_port_mlp(ref), device="cpu")
    f = multi.MultiDeviceEngine(pred, devices=["cpu", "cpu"], max_batch=8,
                                timeout_ms=1.0, supervise=False, hedge_ms=0)
    try:
        f.warmup(SIG)
        new = _port_mlp(_ref_mlp(seed=7))
        f.swap_weights(new.state_dict())
        rep = f._replicas[1]
        old, brk = rep.engine, rep.breaker
        brk.trip("hung")
        f._restart(rep)
        assert rep.engine is not old and rep.breaker is brk
        assert rep.restarts == 1 and brk.state == "open"
        assert rep.engine.stats()["compiles"] == len(rep.engine.buckets)
        assert rep.engine.weights_version == 1
        want = inference.Predictor(new, device="cpu").run(_x(6))
        np.testing.assert_allclose(rep.engine.run(_x(6), timeout=30), want,
                                   **TOL)
        assert rep.engine.probe(timeout_s=10.0) is True
        # the caller's template was never written
        np.testing.assert_allclose(pred.run(_x(6)),
                                   ref_inference.Predictor(ref).run(_x(6)),
                                   **TOL)
    finally:
        _close(f)


# -- live weight swaps ------------------------------------------------------------

def test_live_swap_serves_the_references_new_outputs():
    rf, pf = _fleets()
    try:
        x = _x(2)
        new = _ref_mlp(seed=7)
        met = [len(r.predictor._compiled) for r in pf._replicas]
        v = (rf.swap_weights(ref_inference.Predictor(new).state),
             pf.swap_weights(inference.Predictor(_port_mlp(new),
                                                 device="cpu").state))
        assert v == (1, 1)
        got, want = pf.run(x, timeout=30), rf.run(x, timeout=30)
        np.testing.assert_allclose(got, np.asarray(want), **TOL)
        np.testing.assert_allclose(got, ref_inference.Predictor(new).run(x),
                                   **TOL)
        for f in (rf, pf):
            assert [e.weights_version for e in f.engines] == [1, 1]
            assert f.stats()["weights_version"] == 1
            assert f.health()["weights_version"] == 1
            assert not any(r.draining for r in f._replicas)
            assert f._lifecycle["event"] == "swap"
        # the swap met no new signature
        assert [len(r.predictor._compiled) for r in pf._replicas] == met
    finally:
        _close(rf, pf)


def test_swap_rolls_one_replica_at_a_time_without_loss():
    """While one replica takes its new weights the other serves on the
    old; no request is lost, and after the roll every replica serves the
    new weights."""
    ref = _ref_mlp()
    f = multi.MultiDeviceEngine(
        inference.Predictor(_port_mlp(ref), device="cpu"),
        devices=["cpu", "cpu"], max_batch=8, timeout_ms=1.0, hedge_ms=0,
        supervise=False)
    try:
        f.warmup(SIG)
        new = _port_mlp(_ref_mlp(seed=7))
        seen = []
        orig = multi._fresh_copy

        def spy(module, tree):
            seen.append([torch.equal(next(iter(r.predictor.state
                                                .values())),
                                     next(iter(new.state_dict().values())))
                         for r in f._replicas])
            return orig(module, tree)

        multi._fresh_copy = spy
        try:
            futs = [f.submit(_x(i)) for i in range(8)]
            f.swap_weights(new.state_dict())
            futs += [f.submit(_x(i)) for i in range(8)]
        finally:
            multi._fresh_copy = orig
        for fut in futs:
            fut.result(timeout=30)
        assert seen == [[False, False], [True, False]]
        want = inference.Predictor(new, device="cpu").run(_x(3))
        for _ in range(2):
            np.testing.assert_allclose(f.run(_x(3), timeout=30), want,
                                       **TOL)
    finally:
        _close(f)


class _GatedMLP(torch.nn.Module):
    """Two layers with a gate between them: the one call that finds the
    gate armed waits there until the test opens it, so that a swap can
    land in the middle of a batch. The gate is a class attribute, shared
    by every copy a fleet makes."""

    gate = None

    def __init__(self, seed):
        super().__init__()
        torch.manual_seed(seed)
        self.l1 = torch.nn.Linear(16, 32)
        self.l2 = torch.nn.Linear(32, 4)

    def forward(self, x):
        h = torch.relu(self.l1(x))
        g = type(self).gate
        if g is not None and g["armed"]:
            g["armed"] = False
            g["entered"].set()
            g["open"].wait(30.0)
        return self.l2(h)


@pytest.mark.parametrize("probe", [False, True])
def test_swap_whose_drain_times_out_leaves_the_running_batch_whole(probe):
    """A one-replica fleet (no peer to take its work) whose batch is still
    running when the swap's drain times out: the swap goes on, as the
    reference's does, and the running batch ends on the old weights,
    every layer of it; the next batch serves the new weights."""
    old, new = _GatedMLP(0).eval(), _GatedMLP(1).eval()
    x = _x(5)
    with torch.no_grad():
        want_old = old(torch.from_numpy(x)).numpy()
        want_new = new(torch.from_numpy(x)).numpy()
        mixed = new.l2(torch.relu(old.l1(torch.from_numpy(x)))).numpy()
    assert np.abs(want_old - mixed).max() > 1e-2
    gate = {"armed": False, "entered": threading.Event(),
            "open": threading.Event()}
    f = multi.MultiDeviceEngine(inference.Predictor(old, device="cpu"),
                                devices=["cpu"], max_batch=8,
                                timeout_ms=1.0, hedge_ms=0, supervise=False)
    try:
        f.warmup(SIG)
        pred = f._replicas[0].predictor
        captured = pred.captures
        _GatedMLP.gate = gate
        gate["armed"] = True
        fut = f.submit(x)
        assert gate["entered"].wait(30.0)
        assert f.swap_weights(new.state_dict(), drain_timeout_s=0.05,
                              probe=probe) == 1
        assert not fut.done()
        # the swap captured the warm signatures over the fresh module while
        # the old module's entry was still replaying
        assert pred.captures == captured + len(pred._compiled)
        gate["open"].set()
        np.testing.assert_allclose(fut.result(timeout=30), want_old, **TOL)
        np.testing.assert_allclose(f.run(x, timeout=30), want_new, **TOL)
        assert f.engines[0].weights_version == 1
        # no call after the swap captured, and every signature has an
        # entry of the new module (bound, or prepared for its first call)
        assert pred.captures == captured + len(pred._compiled)
        ready = {sig for entries in (pred._compiled, pred._prepared)
                 for sig, e in entries.items() if e.module is pred.model}
        assert ready == set(pred._compiled)
    finally:
        _GatedMLP.gate = None
        gate["open"].set()
        _close(f)


def test_swap_shape_mismatch_is_refused():
    rf, pf = _fleets()
    try:
        pt.seed(9)
        other = ref_nn.Sequential(ref_nn.Linear(16, 64), ref_nn.ReLU(),
                                  ref_nn.Linear(64, 4))
        port_other = convert.load_jax_state(
            nn.Sequential(nn.Linear(16, 64), nn.ReLU(), nn.Linear(64, 4)),
            _arrays(other))
        with pytest.raises(ValueError, match="shape"):
            rf.swap_weights(ref_inference.Predictor(other).state)
        with pytest.raises(ValueError, match="shape"):
            pf.swap_weights(port_other.state_dict())
        with pytest.raises(ValueError, match="structure"):
            pf.swap_weights({"w": np.zeros(3)})
        for f in (rf, pf):
            assert f.weights_version == 0
            assert f._lifecycle["event"] == "swap_refused"
    finally:
        _close(rf, pf)


def test_failed_probe_unwinds_the_whole_roll(monkeypatch):
    """Replica 0 swaps clean, replica 1's probe rejects the new weights:
    the roll unwinds replica 0 too, and both fleets serve their old
    outputs."""
    rf, pf = _fleets()
    try:
        x = _x(4)
        y0 = np.asarray(pf.run(x, timeout=30))
        new = _ref_mlp(seed=7)
        for f, state, err in (
                (rf, ref_inference.Predictor(new).state, RuntimeError),
                (pf, _port_mlp(new).state_dict(), RuntimeError)):
            monkeypatch.setattr(f.engines[1], "probe",
                                lambda timeout_s=None: False)
            with pytest.raises(err, match="unwound"):
                f.swap_weights(state)
            assert f.weights_version == 0
            assert [e.weights_version for e in f.engines] == [0, 0]
            assert f._lifecycle["event"] == "swap_failed"
            assert f._lifecycle["rolled_back"] == [0]
        for _ in range(2):
            np.testing.assert_allclose(pf.run(x, timeout=30), y0, rtol=0,
                                       atol=0)
        np.testing.assert_allclose(y0, np.asarray(rf.run(x, timeout=30)),
                                   **TOL)
    finally:
        _close(rf, pf)


def test_swap_from_a_checkpoint_names_item_19(tmp_path):
    rf, pf = _fleets()

    class Manager:
        def _sharded_path(self, step):
            return str(tmp_path / f"step-{step}")

    try:
        for source in (str(tmp_path), tmp_path, Manager()):
            with pytest.raises(NotImplementedError, match="item 19"):
                pf.swap_weights(source, step=1)
        assert pf.weights_version == 0
    finally:
        # the reference fleet too: left open, it writes the reference's
        # monitor in later files
        _close(rf, pf)


# -- the module surface -------------------------------------------------------------

def test_module_health_and_gauges_cover_live_fleets():
    rf, pf = _fleets()
    try:
        monitor.enable()
        pf._replicas[1].breaker.trip("test")
        assert pf in multi._ACTIVE
        blocks = multi.health()
        mine = [b for b in blocks if b["replicas"][1]["breaker"] == "open"]
        assert mine and mine[0]["active_replicas"] == 2
        multi.publish_gauges()
        reg = monitor.registry()
        assert reg.value("serving.breaker_state.1") == 2
        assert reg.value("serving.active_replicas") == 2
    finally:
        # the reference fleet too: left open, it writes the reference's
        # monitor in later files
        _close(rf, pf)
    assert pf not in multi._ACTIVE


# -- a two-layer BERT fleet ------------------------------------------------------

def test_bert_fleet_matches_the_reference():
    pt.seed(0)
    jm = RefBert(RefBertConfig.tiny())
    jm.eval()
    m = Bert(BertConfig.tiny()).eval()
    convert.load_jax_state(m, _arrays(jm))
    rng = np.random.RandomState(0)
    reqs = []
    for rows in (1, 3, 2, 4):
        ids = rng.randint(0, 1024, (rows, 16)).astype("int32")
        tt = (rng.rand(rows, 16) < 0.5).astype("int32")
        lens = rng.randint(2, 17, rows)
        mask = (np.arange(16)[None, :] < lens[:, None]).astype("int32")
        reqs.append((ids, tt, mask))
    kw = dict(buckets=[4, 8], max_batch=8, timeout_ms=1.0, supervise=False,
              hedge_ms=0)
    rf = ref_multi.MultiDeviceEngine(ref_inference.Predictor(jm),
                                     devices=jax.local_devices()[:2], **kw)
    pf = multi.MultiDeviceEngine(inference.Predictor(m, device="cpu"),
                                 devices=["cpu", "cpu"], **kw)
    try:
        pf.warmup([((16,), "int32")] * 3)
        for r in reqs:
            want = rf.run(*r, timeout=60)
            got = pf.run(*r, timeout=60)
            for g, w in zip(got, want):
                np.testing.assert_allclose(g, np.asarray(w), atol=2e-5,
                                           rtol=2e-5)
        assert _submitted(pf) == [2, 2]
    finally:
        _close(rf, pf)


# -- the supervisor's verdicts over one scripted fleet ---------------------------

class _Engine:
    def __init__(self):
        self.hb = {"queue_depth": 0, "inflight_age_s": None,
                   "inflight_token": None, "last_progress_age_s": 0.0,
                   "last_ok_age_s": 0.0, "active": 0}
        self.probe_result = None
        self.probes = 0

    def heartbeat(self, now=None):
        return dict(self.hb)

    def probe(self, timeout_s=1.0):
        self.probes += 1
        return self.probe_result

    def depth(self):
        return self.hb["queue_depth"]


class _Rep:
    def __init__(self, index, brk, active=True):
        self.index, self.engine, self.breaker = index, _Engine(), brk
        self.active, self.draining = active, False
        self.handled_token = self.restart_token = None
        self.restarts = 0


class _Owner:
    """What the supervisor reads and calls on a fleet, with the calls
    recorded."""

    def __init__(self, brk_cls, clock, n=3, active=3):
        self.inflight_timeout_s = 1.0
        self._replicas = [_Rep(i, brk_cls(str(i), failure_threshold=1,
                                          cooldown_s=2.0, clock=clock),
                               active=i < active) for i in range(n)]
        self.calls = []

    def _refresh_hedge_delay(self, p99_ms):
        self.calls.append(("hedge_delay", p99_ms))

    def _failover(self, replica, reason=""):
        self.calls.append(("failover", replica.index, reason))
        return 2

    def _restart(self, replica):
        replica.restarts += 1
        replica.restart_token = None
        self.calls.append(("restart", replica.index))

    def drain_replica(self, replica, reason="preempt"):
        replica.draining = True
        self.calls.append(("drain", replica.index, reason))
        return 1

    def _active_count(self):
        return sum(r.active for r in self._replicas)

    def _activate_one(self):
        for r in self._replicas:
            if not r.active:
                r.active = True
                return r
        return None

    def _deactivate_one(self):
        if self._active_count() <= 1:
            return None
        for r in reversed(self._replicas):
            if r.active:
                r.active = False
                return r
        return None


def _hang(owner, t, now):
    owner._replicas[0].engine.hb.update(inflight_age_s=now - t,
                                        inflight_token=t)


# each step: ("tick", now), ("hang", t0, now), ("idle",), ("probe", value),
# ("clock", t), ("rollup", slo_dict, decode_dict), ("fault", kind, replica)
SUPERVISOR_SCRIPTS = {
    "one_failover_a_dispatch": [
        ("hang", 10.0, 11.5), ("tick", 11.5), ("hang", 10.0, 11.8),
        ("tick", 11.8), ("hang", 20.0, 21.2), ("tick", 21.2)],
    "restart_past_the_grace": [
        ("hang", 10.0, 11.5), ("tick", 11.5), ("hang", 10.0, 12.5),
        ("tick", 12.5), ("hang", 10.0, 13.5), ("tick", 13.5),
        ("hang", 10.0, 14.0), ("tick", 14.0)],
    "probe_recloses_or_reopens": [
        ("hang", 10.0, 11.5), ("tick", 11.5), ("idle",), ("clock", 3.0),
        ("probe", False), ("tick", 12.0), ("clock", 5.0), ("probe", True),
        ("tick", 13.0), ("tick", 14.0)],
    "preempt_notice_drains": [
        ("fault", "preempt_replica", 2), ("tick", 1.0),
        ("hang", 0.0, 5.0), ("tick", 5.0)],
    "goodput_and_idle_scaling": [
        ("rollup", {"goodput": 0.5, "submitted": 40, "p99_ms": 12.0,
                    "ttft_p99_ms": 30.0}, None), ("tick", 1.0),
        ("rollup", {"goodput": 1.0, "submitted": 0}, None), ("tick", 2.0),
        ("tick", 3.0), ("tick", 4.0)],
    "tokens_floor_scaling": [
        ("rollup", {"submitted": 5}, {"tokens_per_s": 80.0,
                                      "accept_rate": 0.5}), ("tick", 1.0),
        ("rollup", {"submitted": 5}, {"tokens_per_s": 300.0}),
        ("tick", 2.0)],
}


def _supervise(side, script, monkeypatch):
    brk_cls, sup_mod, met, fmod = (
        (ref_breaker.CircuitBreaker, ref_supervisor, ref_metrics,
         ref_faults) if side == "ref" else
        (breaker.CircuitBreaker, supervisor, metrics, faults))
    clock = [0.0]
    rollups = [{}, None]
    monkeypatch.setattr(met, "slo_rollup", lambda now=None: rollups[0])
    monkeypatch.setattr(met, "decode_rollup", lambda now=None: rollups[1])
    owner = _Owner(brk_cls, lambda: clock[0], active=2)
    sup = sup_mod.ServingSupervisor(owner, start=False, idle_ticks_down=2,
                                    tokens_floor=100.0)
    for op, *args in script:
        if op == "tick":
            sup.tick(owner, now=args[0])
        elif op == "hang":
            _hang(owner, *args)
        elif op == "idle":
            owner._replicas[0].engine.hb.update(inflight_age_s=None,
                                                inflight_token=None)
        elif op == "probe":
            owner._replicas[0].engine.probe_result = args[0]
        elif op == "clock":
            clock[0] = args[0]
        elif op == "rollup":
            rollups[:] = args
        else:
            fmod.inject(args[0], replica=args[1], times=1)
    decisions = [{k: v for k, v in d.items() if k != "t"}
                 for d in sup.decisions]
    return (decisions, owner.calls,
            [(r.breaker.state, r.active, r.draining, r.restarts)
             for r in owner._replicas])


@pytest.mark.parametrize("name", sorted(SUPERVISOR_SCRIPTS))
def test_supervisor_decisions_match_the_reference(name, monkeypatch):
    script = SUPERVISOR_SCRIPTS[name]
    want = _supervise("ref", script, monkeypatch)
    got = _supervise("port", script, monkeypatch)
    assert got == want
    assert got[0], "the script took no decision"


def test_concurrent_submits_and_hedges_lose_no_update():
    """Many client threads submit to a fleet whose hedger fires on every
    request, under a shortened thread switch interval: every future
    resolves to the right output, and the fleet's counts agree with its
    replicas' (a lost update under a lock-free read-modify-write would
    break them)."""
    import sys
    import threading
    ref = _ref_mlp()
    f = multi.MultiDeviceEngine(
        inference.Predictor(_port_mlp(ref), device="cpu"),
        devices=["cpu"] * 3, max_batch=8, timeout_ms=1.0, hedge_ms=1,
        hedge_budget=1.0, supervise=False)
    want = ref_inference.Predictor(ref)
    errors, n_threads, n_each = [], 16, 10
    interval = sys.getswitchinterval()

    def client(k):
        try:
            for i in range(n_each):
                x = _x(k * n_each + i, rows=1 + i % 3)
                np.testing.assert_allclose(f.run(x, timeout=30),
                                           want.run(x), **TOL)
        except Exception as e:   # noqa: BLE001 - asserted below
            errors.append(repr(e))

    try:
        f.warmup(SIG)
        sys.setswitchinterval(1e-6)
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60.0)
        assert not any(t.is_alive() for t in threads)
        # every request is back: the hedger's remaining timers drop, and
        # a close that drains finishes any shadow still queued
        deadline = time.monotonic() + 10.0
        while f._hedger._heap and time.monotonic() < deadline:
            time.sleep(0.01)
        assert not f._hedger._heap
    finally:
        sys.setswitchinterval(interval)
        f.close()
    assert not errors, errors[:3]
    st = f.stats()
    assert f._submitted == n_threads * n_each
    assert st["submitted"] == f._submitted + st["hedged"]
    assert st["completed"] == st["submitted"]
    assert 0 <= st["hedge_wins"] <= st["hedged"] <= f._submitted
