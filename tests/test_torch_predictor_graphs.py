"""The port's Predictor executables (one graph entry per input signature,
``paddle_tpu_torch.graphs``) and a serving fleet's weight swaps over them,
against the JAX package's, on the CPU.

On the card an entry is a CUDA graph over the module it captured; on the
CPU it re-runs that module over its static buffers. The keys, the
compile accounting (``warmup``, ``ServingEngine.warmup``, the monitor's
``inference.*`` counters) and the rule that a rebound module never
replays an entry of the old one are held here; the reference's fleet
spans two of the CPU mesh's devices, the port's ``["cpu", "cpu"]``.

Tolerance: outputs within 1e-5 of the reference's (float32 products
summed in another order).

Isolation: as in ``test_torch_multi.py`` (both fault registries, both
packages' preemption subscribers, the signal handlers, both monitors,
and the reference's flat-arena hook); every engine is closed.
"""
import signal

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.tensor as ref_tensor
from paddle_tpu import inference as ref_inference
from paddle_tpu import monitor as ref_monitor
from paddle_tpu import nn as ref_nn
from paddle_tpu.resilience import faults as ref_faults
from paddle_tpu.resilience import preempt as ref_preempt
from paddle_tpu.serving import multi as ref_multi
from paddle_tpu.serving.engine import ServingEngine as RefServingEngine
from paddle_tpu_torch import convert, graphs, inference, monitor, nn
from paddle_tpu_torch.resilience import faults, preempt
from paddle_tpu_torch.serving import multi
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


def _port_mlp(ref_layer):
    m = nn.Sequential(nn.Linear(16, 32), nn.ReLU(), nn.Linear(32, 4))
    return convert.load_jax_state(m, {k: np.asarray(v.numpy()) for k, v in
                                      ref_layer.state_dict().items()})


def _x(seed, rows=2):
    return np.random.RandomState(seed).rand(rows, 16).astype("f4")


def test_warmup_keys_and_engine_fresh_counts_equal_the_references():
    ref = _ref_mlp()
    jp = ref_inference.Predictor(ref)
    p = inference.Predictor(_port_mlp(ref), device="cpu")
    sigs = ([((8, 16), "float32")], [((4, 16), "float32")],
            [((8, 16), "float32")])
    keys = p.warmup(*sigs)
    assert keys == jp.warmup(*sigs)
    assert set(p._compiled) == set(jp._compiled) and len(p._compiled) == 2
    assert p.captures == 2
    engines = (RefServingEngine(ref_inference.Predictor(ref), buckets=[4, 8],
                                max_batch=8, timeout_ms=1.0),
               ServingEngine(inference.Predictor(_port_mlp(ref),
                                                 device="cpu"),
                             buckets=[4, 8], max_batch=8, timeout_ms=1.0))
    try:
        assert [e.warmup(SIG) for e in engines] == [2, 2]
        assert [e.warmup(SIG, SIG) for e in engines] == [0, 0]
        for rows in (1, 3, 5, 8):
            x = _x(rows, rows)
            want, got = (e.run(x, timeout=30) for e in engines)
            np.testing.assert_allclose(got, np.asarray(want), **TOL)
        assert [e.stats()["compiles"] for e in engines] == [2, 2]
    finally:
        for e in engines:
            e.close(drain=False, timeout=2.0)


def test_predictor_counters_and_executables_equal_the_references():
    """The monitor's ``inference.compile``, ``cache_hit``, ``aot_warmup``
    and ``bucket_pad`` over one call sequence, in both packages, and the
    port's ``inference.executables`` gauge (the reference publishes the
    same count through its sampler, which the port has not ported)."""
    ref = _ref_mlp()
    jp = ref_inference.Predictor(ref)
    p = inference.Predictor(_port_mlp(ref), device="cpu")
    for mon in (ref_monitor, monitor):
        mon.enable()
    names = ("inference.compile", "inference.cache_hit",
             "inference.aot_warmup", "inference.bucket_pad")
    for pred in (jp, p):
        pred.warmup([((8, 16), "float32")])
    for rows, buckets in ((8, None), (3, [8]), (5, None), (5, None),
                          (2, None)):
        x = _x(rows, rows)
        want = jp.run(x, buckets=buckets)
        np.testing.assert_allclose(p.run(x, buckets=buckets), want, **TOL)
        assert [monitor.registry().value(n, 0) for n in names] == \
            [ref_monitor.registry().value(n, 0) for n in names], rows
    assert [monitor.registry().value(n, 0) for n in names] == [2, 3, 1, 1]
    assert monitor.registry().value("inference.executables", 0) == \
        len(p._compiled) == len(jp._compiled) == 3


def test_swap_captures_the_new_module_first_and_never_replays_the_old(
        monkeypatch):
    """Each replica captures its warm signatures over the fresh module
    before it binds it; after the swap every replay is an entry of the
    module the replica serves, no call captures, no signature is new, and
    the outputs follow the new weights, as the reference's do."""
    ref = _ref_mlp()
    rf = ref_multi.MultiDeviceEngine(ref_inference.Predictor(ref),
                                     devices=jax.local_devices()[:2],
                                     max_batch=8, timeout_ms=1.0,
                                     supervise=False, hedge_ms=0)
    pf = multi.MultiDeviceEngine(
        inference.Predictor(_port_mlp(ref), device="cpu"),
        devices=["cpu", "cpu"], max_batch=8, timeout_ms=1.0,
        supervise=False, hedge_ms=0)
    replayed = []
    orig = graphs.GraphEntry.replay

    def spy(entry, args):
        replayed.append(entry)
        return orig(entry, args)

    monkeypatch.setattr(graphs.GraphEntry, "replay", spy)
    try:
        for f in (rf, pf):
            f.warmup(SIG)
        x = _x(2)
        pf.run(x, timeout=30)
        warm = [len(r.predictor._compiled) for r in pf._replicas]
        captures = [r.predictor.captures for r in pf._replicas]
        old = [r.predictor.model for r in pf._replicas]
        new = _ref_mlp(seed=7)
        assert rf.swap_weights(ref_inference.Predictor(new).state) == 1
        assert pf.swap_weights(_port_mlp(new).state_dict()) == 1
        assert [r.predictor.captures for r in pf._replicas] == \
            [c + w for c, w in zip(captures, warm)]
        del replayed[:]
        for i in range(6):
            got, want = pf.run(_x(i), timeout=30), rf.run(_x(i), timeout=30)
            np.testing.assert_allclose(got, np.asarray(want), **TOL)
        np.testing.assert_allclose(pf.run(x, timeout=30),
                                   ref_inference.Predictor(new).run(x),
                                   **TOL)
        assert replayed and not any(e.module in old for e in replayed)
        served = {id(r.predictor.model) for r in pf._replicas}
        assert {id(e.module) for e in replayed} <= served
        assert [len(r.predictor._compiled) for r in pf._replicas] == warm
        assert [r.predictor.captures for r in pf._replicas] == \
            [c + w for c, w in zip(captures, warm)]
        assert pf.stats()["compiles"] == rf.stats()["compiles"]
    finally:
        for f in (rf, pf):
            f.close(drain=False, timeout=2.0)
