"""The port's BERT serving slice against the JAX package, on the CPU.

A tiny BERT (``BertConfig.tiny()``) is built in the JAX package, its
weights are carried into the port with ``convert.load_jax_state``, and the
same inputs (made with numpy from a seed) go through both. On the CPU the
port's kernel wrappers compute their plain versions. Float32 tolerance for
whole-model outputs: atol and rtol 2e-5 (two encoder layers of float32
matmuls summed in another order; the measured gap is about 2e-6).
"""
import concurrent.futures
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu.tensor as ref_tensor
import paddle_tpu as pt
from paddle_tpu import inference as jinference
from paddle_tpu.io import bucketing as jbucketing
from paddle_tpu.models.bert import Bert as JBert
from paddle_tpu.models.bert import BertConfig as JBertConfig
from paddle_tpu.models.bert import BertForPretraining as JBertForPretraining
from paddle_tpu.resilience import deadline as jdeadline
from paddle_tpu.resilience import retry as jretry

from paddle_tpu_torch import inference, nn
from paddle_tpu_torch.convert import load_jax_state
from paddle_tpu_torch.io import bucketing
from paddle_tpu_torch.models import Bert, BertConfig, BertForPretraining
from paddle_tpu_torch.resilience import deadline, retry
from paddle_tpu_torch.serving import (DeadlineExpired, QueueFullError,
                                      ServingEngine)


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


TOL = dict(atol=2e-5, rtol=2e-5)
SEQ = 16


def _jax_state(model):
    return {k: np.asarray(v.numpy()) for k, v in model.state_dict().items()}


def _pair(kind="Bert", **knobs):
    """(JAX model, port model on the CPU) with the same weights and the
    same config ``knobs`` on both sides."""
    pt.seed(0)
    jcls, cls = ((JBert, Bert) if kind == "Bert"
                 else (JBertForPretraining, BertForPretraining))
    jm = jcls(JBertConfig.tiny(**knobs))
    jm.eval()
    m = cls(BertConfig.tiny(**knobs)).eval()
    load_jax_state(m, _jax_state(jm))
    return jm, m


def _inputs(rows, seed=0, seq=SEQ):
    """int32 ids, token types, and a padding mask with real lengths."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 1024, (rows, seq)).astype("int32")
    tt = (rng.rand(rows, seq) < 0.5).astype("int32")
    lens = rng.randint(2, seq + 1, rows)
    mask = (np.arange(seq)[None, :] < lens[:, None]).astype("int32")
    return ids, tt, mask


def _assert_outputs_close(got, ref, **tol):
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        a = a.detach().numpy() if isinstance(a, torch.Tensor) else a
        b = b.numpy() if hasattr(b, "numpy") else np.asarray(b)
        assert a.shape == b.shape and a.dtype == np.float32
        np.testing.assert_allclose(a, b, **(tol or TOL))


# -- the model -----------------------------------------------------------------

@pytest.mark.parametrize("kind", ["Bert", "BertForPretraining"])
def test_model_forward_matches_jax(kind):
    jm, m = _pair(kind)
    ids, tt, mask = _inputs(3)
    ref = jm(pt.to_tensor(ids), pt.to_tensor(tt), pt.to_tensor(mask))
    with torch.inference_mode():
        got = m(torch.from_numpy(ids), torch.from_numpy(tt),
                torch.from_numpy(mask))
    _assert_outputs_close(got, ref)


def test_model_matches_jax_with_pallas_kernels_forced():
    """The JAX side with its Pallas layer-norm and flash-attention kernels
    forced on (interpret mode): the counterparts of the port's kernels."""
    from paddle_tpu.ops import pallas as P
    jm, m = _pair()
    ids, tt, mask = _inputs(2, seed=4)
    P.configure(layer_norm=True, flash_attention=True, flash_min_seq=0)
    try:
        ref = jm(pt.to_tensor(ids), pt.to_tensor(tt), pt.to_tensor(mask))
    finally:
        P.configure(layer_norm=None, flash_attention=None,
                    flash_min_seq=None)
    with torch.inference_mode():
        got = m(torch.from_numpy(ids), torch.from_numpy(tt),
                torch.from_numpy(mask))
    _assert_outputs_close(got, ref)


@pytest.mark.parametrize("kind", ["Bert", "BertForPretraining"])
def test_model_without_flash_attention_matches_jax(kind):
    """``use_flash_attention=False``: plain attention on both sides (the
    port runs it on the CPU only)."""
    jm, m = _pair(kind, use_flash_attention=False)
    ids, tt, mask = _inputs(3, seed=5)
    ref = jm(pt.to_tensor(ids), pt.to_tensor(tt), pt.to_tensor(mask))
    with torch.inference_mode():
        got = m(torch.from_numpy(ids), torch.from_numpy(tt),
                torch.from_numpy(mask))
    _assert_outputs_close(got, ref)


def test_state_dict_names_and_layouts_match_jax():
    jm, m = _pair("BertForPretraining")
    ours = {k: tuple(v.shape) for k, v in m.state_dict().items()}
    theirs = {k: tuple(v.shape) for k, v in _jax_state(jm).items()}
    assert ours == theirs
    # Linear weights are [in, out], as in the JAX package
    assert ours["bert.encoder.0.ffn1.weight"] == (128, 512)


@pytest.mark.parametrize("fault", ["missing", "unexpected", "shape"])
def test_load_jax_state_rejects(fault):
    jm, m = _pair()
    arrays = _jax_state(jm)
    before = m.state_dict()["pooler.bias"].clone()
    if fault == "missing":
        arrays.pop("pooler.bias")
        err = KeyError
    elif fault == "unexpected":
        arrays["pooler.extra"] = np.zeros(3, "f4")
        err = KeyError
    else:
        arrays["pooler.bias"] = np.zeros(7, "f4")
        err = ValueError
    arrays["pooler.weight"] = arrays["pooler.weight"] + 1.0
    with pytest.raises(err):
        load_jax_state(m, arrays)
    # nothing was copied before the check failed
    assert torch.equal(m.state_dict()["pooler.bias"], before)


@pytest.mark.parametrize("knob", [dict(moe_num_experts=4),
                                  dict(use_recompute=True)])
def test_unported_config_knobs_raise(knob):
    with pytest.raises(NotImplementedError):
        Bert(BertConfig.tiny(**knob))


# -- Predictor -----------------------------------------------------------------

def test_predictor_run_matches_jax():
    jm, m = _pair()
    ids, tt, mask = _inputs(5, seed=1)
    ref = jinference.Predictor(jm).run(ids, tt, mask)
    pred = inference.Predictor(m, device="cpu")
    got = pred.run(ids, tt, mask)
    _assert_outputs_close(got, ref)
    # a bucket-padded run gives the same rows back
    _assert_outputs_close(pred.run(ids, tt, mask, buckets=[8]), ref)


def test_predictor_warmup_counts_signatures():
    _, m = _pair()
    pred = inference.Predictor(m, device="cpu")
    keys = pred.warmup([((4, SEQ), "int32")] * 3)
    assert len(keys) == 1 and keys[0] in pred._compiled
    pred.run(*_inputs(4))
    assert len(pred._compiled) == 1       # the warmed signature, no new one
    pred.run(*_inputs(2))
    assert len(pred._compiled) == 2


def test_predictor_bf16_returns_float32_close_to_f32():
    _, m = _pair()
    ids, tt, mask = _inputs(3, seed=2)
    ref = inference.Predictor(m, device="cpu").run(ids, tt, mask)
    pred = inference.Predictor(m, inference.Config().enable_bf16(),
                               device="cpu")
    got = pred.run(ids, tt, mask)
    assert next(m.parameters()).dtype == torch.float32   # caller's model
    assert next(pred.model.parameters()).dtype == torch.bfloat16
    for a, b in zip(got, ref):
        assert a.dtype == np.float32
        rel = np.linalg.norm(a - b) / np.linalg.norm(b)
        assert rel < 5e-2, rel


def test_predictor_runs_in_inference_mode_on_any_thread():
    _, m = _pair()
    pred = inference.Predictor(m, device="cpu")
    out = []
    t = threading.Thread(target=lambda: out.append(
        pred.run_device(*_inputs(1))))
    t.start()
    t.join()
    assert not out[0][0].requires_grad


# -- ServingEngine ------------------------------------------------------------

def test_engine_ragged_concurrent_requests_match_lone_run():
    jm, m = _pair()
    pred = inference.Predictor(m, device="cpu")
    lone = inference.Predictor(m, device="cpu")
    jpred = jinference.Predictor(jm)
    eng = ServingEngine(pred, buckets=[4, 8], max_batch=8, timeout_ms=20)
    assert eng.warmup([((SEQ,), "int32")] * 3) == 2
    sizes = [1, 3, 2, 5, 1, 2, 3, 1, 5, 2, 1, 3]
    reqs = [_inputs(n, seed=10 + i) for i, n in enumerate(sizes)]

    def client(part):
        return [(i, eng.submit(*reqs[i])) for i in part]

    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        parts = [range(c, len(reqs), 4) for c in range(4)]
        futs = [f for fs in pool.map(client, parts) for f in fs]
    for i, f in futs:
        got = f.result(30)
        assert got[0].shape == (sizes[i], SEQ, 128)
        # batched under another row mix, then sliced back: within
        # tolerance of the lone run (not bit for bit, as under XLA)
        _assert_outputs_close(got, lone.run(*reqs[i]))
        _assert_outputs_close(got, jpred.run(*reqs[i]))
    eng.close()
    st = eng.stats()
    assert st["completed"] == len(reqs) and st["failed"] == 0
    assert st["compiles"] == 2            # only the warmed bucket shapes
    assert st["coalesced_rows"] == sum(sizes)


def _linear_engine(**kw):
    lin = nn.Sequential(nn.Linear(16, 4))
    return ServingEngine(inference.Predictor(lin, device="cpu"), **kw)


def _rows(n, seed=0):
    return np.random.RandomState(seed).rand(n, 16).astype("f4")


def test_engine_queue_full_fast_rejects():
    eng = _linear_engine(max_batch=8, timeout_ms=5.0, queue_depth=3,
                         start=False)
    futs = [eng.submit(_rows(1, i)) for i in range(3)]
    t0 = time.perf_counter()
    with pytest.raises(QueueFullError):
        eng.submit(_rows(1))
    assert time.perf_counter() - t0 < 0.05  # synchronous, no future made
    assert eng.stats()["rejected"] == 1
    eng.start()
    for f in futs:
        assert f.result(5).shape == (1, 4)
    eng.close()


def test_engine_expired_deadline_never_occupies_batch_slot():
    eng = _linear_engine(max_batch=32, timeout_ms=5.0, start=False)
    dead = eng.submit(_rows(7), deadline_ms=0)      # born expired
    live = eng.submit(_rows(3, 9))
    time.sleep(0.01)
    eng.start()
    with pytest.raises(DeadlineExpired):
        dead.result(5)
    assert live.result(5).shape == (3, 4)
    st = eng.stats()
    assert st["coalesced_rows"] == 3
    assert st["expired"] == 1 and st["completed"] == 1
    eng.close()


def test_engine_poisoned_request_fails_only_its_own_future():
    eng = _linear_engine(max_batch=32, timeout_ms=10.0, start=False)
    real = eng.predictor.run_device

    def guarded(*arrays, **k):
        if any(np.isnan(np.asarray(a)).any() for a in arrays):
            raise ValueError("poisoned feed")
        return real(*arrays, **k)

    eng.predictor.run_device = guarded
    good = _rows(2, 3)
    f1, fp = eng.submit(good), eng.submit(np.full((1, 16), np.nan, "f4"))
    eng.start()
    np.testing.assert_allclose(f1.result(5),
                               eng.predictor.run(good), **TOL)
    with pytest.raises(ValueError, match="poisoned"):
        fp.result(5)
    st = eng.stats()
    assert st["failed"] == 1 and st["completed"] == 1
    assert st["isolated"] == 2
    eng.close()


def test_engine_transient_failure_retries():
    eng = _linear_engine(max_batch=8, timeout_ms=10.0, start=False)
    real = eng.predictor.run_device
    calls = {"n": 0}

    def flaky(*a, **k):
        calls["n"] += 1
        if calls["n"] == 1:
            raise retry.TransientError("injected hiccup")
        return real(*a, **k)

    eng.predictor.run_device = flaky
    futs = [eng.submit(_rows(n, n)) for n in (2, 3)]
    eng.start()
    for f in futs:
        assert f.result(5).shape[1] == 4
    assert eng.stats()["retries"] == 1
    eng.close()


# -- the JAX-free copies: bucketing, deadline, retry ---------------------------

@pytest.mark.parametrize("kind", ["numpy", "torch"])
@pytest.mark.parametrize("mode,axis", [("repeat", 0), ("zeros", 0),
                                       ("repeat", 1)])
def test_bucketing_matches_jax(kind, mode, axis):
    a = np.arange(30, dtype="f4").reshape(3, 5, 2)
    x = torch.from_numpy(a) if kind == "torch" else a
    for n in (0, 1, 3, 5, 9, 40):
        assert bucketing.next_bucket(n) == jbucketing.next_bucket(n)
        assert (bucketing.next_bucket(n, [4, 8, 32]) ==
                jbucketing.next_bucket(n, [4, 8, 32]))
    target = 8
    got = bucketing.pad_to_bucket(x, target, axis=axis, mode=mode)
    ref = jbucketing.pad_to_bucket(a, target, axis=axis, mode=mode)
    assert isinstance(got, type(x))
    np.testing.assert_array_equal(np.asarray(got), ref)
    np.testing.assert_array_equal(
        np.asarray(bucketing.unpad(got, a.shape[axis], axis=axis)),
        jbucketing.unpad(ref, a.shape[axis], axis=axis))
    for g, r in zip(bucketing.split_rows(got, [1, 2], axis=axis),
                    jbucketing.split_rows(ref, [1, 2], axis=axis)):
        np.testing.assert_array_equal(np.asarray(g), r)
    with pytest.raises(ValueError):
        bucketing.split_rows(x, [8, 8])


def test_deadline_and_retry_schedule_match_jax():
    t = [100.0]
    for mod in (deadline, jdeadline):
        d = mod.Deadline(0.5, clock=lambda: t[0])
        assert not d.expired()
    t[0] = 100.6
    assert deadline.Deadline.after_ms(0, clock=lambda: t[0]).expired()
    p, jp = retry.RetryPolicy(seed=3), jretry.RetryPolicy(seed=3)
    assert [p.delay(i) for i in range(6)] == [jp.delay(i) for i in range(6)]
    for e in (retry.TransientError("x"), OSError(), ValueError(),
              KeyboardInterrupt()):
        assert retry.is_transient(e) == jretry.is_transient(e)
