"""The port's BERT pretraining slice against the JAX package, on the CPU.

A tiny ``BertForPretraining`` is built in the JAX package, its weights are
carried into the port with ``convert.load_jax_state``, and the same
inputs (made with numpy from a seed) go through both: the pretraining
loss, every gradient by name, and every parameter after three AdamW
steps, in float32 and under ``amp.auto_cast(dtype="bfloat16")``; in
float32 also with the loss and multi-tensor Adam kernels switched on in
both packages (``configure(softmax_xent=True, fused_adam_multi=True)``).
On the CPU the port's kernel wrappers and autograd Functions run their
plain forward and backward versions. The loss, the optimizers, amp, the
generators, ``jit.to_static`` and ``tools.bench_bert`` are checked on
their own too.

Tolerances, each with its reason:

* loss ops and optimizer steps on the same float32 inputs: atol and
  rtol 1e-6 (elementwise float32 in the same order; logsumexp may sum in
  another order);
* the whole model in float32: loss 1e-5; gradients atol 1e-5 and rtol
  1e-3 (two encoder layers of float32 matmuls summed in another order;
  measured about 1e-6 relative);
* the whole model under bf16 amp: loss within 2e-2; each gradient within
  5e-2 relative L2 (measured at most 1.2e-2) — both frameworks round the
  same products to bf16, but at other places (XLA and PyTorch CPU
  matmuls round their f32 sums once, each its own way);
* parameters after three AdamW steps: Adam divides by sqrt(v), so an
  element whose gradient is at the level of rounding noise moves by
  about lr in a direction the noise picks (the key third of ``qkv.bias``
  has zero gradient in exact arithmetic: softmax ignores a shift common
  to all keys). So every element is held to the Adam bound
  ``|delta| <= 2 * lr * steps``, and the updates of the whole model,
  concatenated, to a relative L2 gap of 1e-2 in float32 (measured
  3.2e-3) and 1e-1 under bf16 amp (measured 5.9e-2).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu.tensor as ref_tensor
import paddle_tpu as pt
from paddle_tpu import amp as jamp
from paddle_tpu import jit as jjit
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.models.bert import BertConfig as JBertConfig
from paddle_tpu.models.bert import BertForPretraining as JBertForPretraining
from paddle_tpu.ops import loss as jloss
from paddle_tpu.ops import pallas as P

from paddle_tpu_torch import amp, jit, nn, optimizer, random
from paddle_tpu_torch.convert import export_state, load_jax_state
from paddle_tpu_torch.models import BertConfig, BertForPretraining
from paddle_tpu_torch.ops import kernels, loss
from paddle_tpu_torch.ops import nn_ops as F
from paddle_tpu_torch.regularizer import L2Decay
from paddle_tpu_torch.tools import bench_bert


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


OP_TOL = dict(atol=1e-6, rtol=1e-6)
SEQ = 16
LR = 1e-3


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t.numpy() if hasattr(t, "numpy") else t,
                      dtype=np.float32)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


# -- cross entropy -----------------------------------------------------------

def _ce_inputs(shape=(2, 5, 11)):
    rng = np.random.RandomState(0)
    x = (rng.randn(*shape) * 3).astype("f4")
    lbl = rng.randint(0, shape[-1], shape[:-1]).astype("i4")
    flat = lbl.reshape(-1)
    flat[::3] = -1                  # ignored
    flat[1] = shape[-1] + 4         # out of range: clamped, not ignored
    flat[4] = -7                    # out of range below
    return x, lbl


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_cross_entropy_matches_jax_with_ignore_and_out_of_range(reduction):
    x, lbl = _ce_inputs()
    jx = pt.to_tensor(x, stop_gradient=False)
    ref = jloss.cross_entropy(jx, pt.to_tensor(lbl), ignore_index=-1,
                              reduction=reduction)
    ref.sum().backward()
    tx = torch.from_numpy(x).requires_grad_()
    got = loss.cross_entropy(tx, torch.from_numpy(lbl), ignore_index=-1,
                             reduction=reduction)
    assert got.shape == tuple(ref.shape)
    np.testing.assert_allclose(_np(got), _np(ref), **OP_TOL)
    got.sum().backward()
    np.testing.assert_allclose(_np(tx.grad), np.asarray(jx.grad), **OP_TOL)


def test_cross_entropy_label_column_and_all_ignored():
    x, lbl = _ce_inputs((6, 4))
    # labels as an (N, 1) column, the reference's other hard-label form
    ref = jloss.cross_entropy(pt.to_tensor(x), pt.to_tensor(lbl[:, None]))
    got = loss.cross_entropy(torch.from_numpy(x),
                             torch.from_numpy(lbl[:, None]))
    np.testing.assert_allclose(_np(got), _np(ref), **OP_TOL)
    # every position ignored: 0, not NaN (the 1e-12 floor)
    none = np.full_like(lbl, -1)
    assert loss.cross_entropy(torch.from_numpy(x), torch.from_numpy(none),
                              ignore_index=-1).item() == 0.0


def test_softmax_with_cross_entropy_matches_jax():
    x, lbl = _ce_inputs()
    ref, sm = jloss.softmax_with_cross_entropy(
        pt.to_tensor(x), pt.to_tensor(lbl[..., None]), ignore_index=-1,
        return_softmax=True)
    got, gsm = loss.softmax_with_cross_entropy(
        torch.from_numpy(x), torch.from_numpy(lbl[..., None]),
        ignore_index=-1, return_softmax=True)
    np.testing.assert_allclose(_np(got), _np(ref), **OP_TOL)
    np.testing.assert_allclose(_np(gsm), _np(sm), **OP_TOL)


def test_cross_entropy_unported_branches_raise():
    x, lbl = torch.zeros(2, 3), torch.zeros(2, dtype=torch.int64)
    for kw in (dict(soft_label=True), dict(weight=torch.ones(3))):
        with pytest.raises(NotImplementedError, match="not ported"):
            loss.cross_entropy(x, lbl, **kw)


# -- optimizers ----------------------------------------------------------------

def _toy_pair(seed):
    """A JAX Linear and a port Linear with the same weights."""
    pt.seed(seed)
    jl = jnn.Linear(5, 3)
    tl = nn.Linear(5, 3)
    load_jax_state(tl, {k: np.asarray(v.numpy())
                        for k, v in jl.state_dict().items()})
    return jl, tl


def _set_grads(jl, tl, rng):
    for (_, jp), (_, tp) in zip(jl.named_parameters(),
                                tl.named_parameters()):
        g = rng.randn(*jp.shape).astype("f4")
        jp._grad = jnp.asarray(g)
        tp.grad = torch.from_numpy(g)


@pytest.mark.parametrize("kind,steps", [("Adam", 1), ("AdamW", 3)])
def test_adam_and_adamw_steps_match_jax(kind, steps):
    jl, tl = _toy_pair(3)
    kw = dict(learning_rate=0.05, epsilon=1e-6)
    if kind == "AdamW":
        kw["weight_decay"] = 0.1
    jo = getattr(jopt, kind)(parameters=jl.parameters(), **kw)
    to = getattr(optimizer, kind)(parameters=list(tl.parameters()), **kw)
    rng = np.random.RandomState(1)
    for _ in range(steps):
        _set_grads(jl, tl, rng)
        jo.step()
        to.step()
        jo.clear_grad()
        to.clear_grad()
    for (name, jp), (_, tp) in zip(jl.named_parameters(),
                                   tl.named_parameters()):
        np.testing.assert_allclose(_np(tp), np.asarray(jp.numpy()),
                                   err_msg=name, **OP_TOL)
        assert tp.grad is None
        jslots = jo._accumulators[id(jp)]
        tslots = to._accumulators[id(tp)]
        assert set(jslots) == set(tslots)
        for s in jslots:
            np.testing.assert_allclose(_np(tslots[s]),
                                       np.asarray(jslots[s].data),
                                       err_msg=f"{name}@{s}", **OP_TOL)
        assert tslots["beta1_pow"].dtype == torch.float32
        assert tslots["beta1_pow"].shape == ()


def test_adam_l2_regularization_and_lr_match_jax():
    jl, tl = _toy_pair(4)
    jo = jopt.Adam(learning_rate=0.01, parameters=jl.parameters(),
                   weight_decay=0.3)
    to = optimizer.Adam(learning_rate=0.01, parameters=tl.parameters(),
                        weight_decay=L2Decay(0.3))
    jo.set_lr(0.02)
    to.set_lr(0.02)
    assert to.get_lr() == pytest.approx(jo.get_lr())
    _set_grads(jl, tl, np.random.RandomState(2))
    jo.step()
    to.step()
    for jp, tp in zip(jl.parameters(), tl.parameters()):
        np.testing.assert_allclose(_np(tp), np.asarray(jp.numpy()),
                                   **OP_TOL)


# use_fused, use_multi_tensor and flat_arena are held against the JAX
# package in test_torch_xent_adam.py
@pytest.mark.parametrize("kw", [dict(grad_sync="exact")])
def test_unported_optimizer_options_raise(kw):
    with pytest.raises(NotImplementedError, match="item 19"):
        optimizer.AdamW(parameters=[torch.nn.Parameter(torch.zeros(2))],
                        **kw)


# -- the slice: BERT pretraining ---------------------------------------------

def _bert_inputs(rows=3, seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 1024, (rows, SEQ)).astype("int32")
    tt = (rng.rand(rows, SEQ) < 0.5).astype("int32")
    lens = rng.randint(4, SEQ + 1, rows)
    mask = (np.arange(SEQ)[None, :] < lens[:, None]).astype("int32")
    mlm = np.where(rng.rand(rows, SEQ) < 0.3,
                   rng.randint(0, 1024, (rows, SEQ)), -1).astype("int32")
    nsp = rng.randint(0, 2, rows).astype("int32")
    return ids, tt, mask, mlm, nsp


def _bert_pair():
    knobs = dict(num_attention_heads=2, hidden_size=128,
                 hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    pt.seed(0)
    jm = JBertForPretraining(JBertConfig.tiny(**knobs))
    jm.train()
    m = BertForPretraining(BertConfig.tiny(**knobs)).train()
    load_jax_state(m, {k: np.asarray(v.numpy())
                       for k, v in jm.state_dict().items()})
    return jm, m


def _jax_steps(jm, batches, use_amp, steps):
    o = jopt.AdamW(learning_rate=LR, parameters=jm.parameters())
    losses, grads = [], None
    for i in range(steps):
        ids, tt, mask, mlm, nsp = batches[i % len(batches)]
        with jamp.auto_cast(enable=use_amp, dtype="bfloat16"):
            logits, nsp_logits = jm(pt.to_tensor(ids), pt.to_tensor(tt),
                                    pt.to_tensor(mask))
        lo = jm.loss(logits.astype("float32"), nsp_logits.astype("float32"),
                     pt.to_tensor(mlm), pt.to_tensor(nsp))
        lo.backward()
        if grads is None:
            grads = {n: np.asarray(p._grad, np.float32)
                     for n, p in jm.named_parameters()}
        losses.append(float(lo.numpy()))
        o.step()
        o.clear_grad()
    params = {n: np.asarray(p.numpy(), np.float32)
              for n, p in jm.named_parameters()}
    return losses, grads, params


def _port_steps(m, batches, use_amp, steps):
    o = optimizer.AdamW(learning_rate=LR, parameters=m.parameters())
    losses, grads = [], None
    for i in range(steps):
        ids, tt, mask, mlm, nsp = (torch.from_numpy(a)
                                   for a in batches[i % len(batches)])
        with amp.auto_cast(enable=use_amp, dtype="bfloat16"):
            logits, nsp_logits = m(ids, tt, mask)
        lo = m.loss(logits.float(), nsp_logits.float(), mlm, nsp)
        lo.backward()
        if grads is None:
            grads = {n: _np(p.grad) for n, p in m.named_parameters()}
        losses.append(lo.item())
        o.step()
        o.clear_grad()
    return losses, grads, export_state(m)


@pytest.fixture
def pallas_config():
    """Restores both packages' kernel configuration afterwards, every
    name either switch knows, so that later tests on the worker run with
    the defaults."""
    yield P.configure
    reset = dict(layer_norm=None, flash_attention=None, flash_min_seq=None,
                 softmax_xent=None, fused_adam=None, fused_adam_multi=None,
                 batch_norm=None)
    P.configure(**reset)
    kernels.configure(**reset)


@pytest.mark.parametrize("jax_path", ["default", "pallas_kernels",
                                      "loss_and_adam_kernels"])
def test_bert_pretraining_steps_match_jax_f32(jax_path, pallas_config):
    if jax_path == "pallas_kernels":
        # the JAX side through its Pallas layer-norm and flash-attention
        # kernels (interpret mode): the counterparts of the port's
        pallas_config(layer_norm=True, flash_attention=True, flash_min_seq=0)
    elif jax_path == "loss_and_adam_kernels":
        # both sides through the fused loss and multi-tensor AdamW (the
        # JAX side's Pallas kernels in interpret mode, the port's plain
        # versions of its kernels)
        on = dict(softmax_xent=True, fused_adam_multi=True)
        pallas_config(**on)
        kernels.configure(**on)
    jm, m = _bert_pair()
    p0 = export_state(m)
    batches = [_bert_inputs(seed=s) for s in (0, 1)]
    jl, jg, jp = _jax_steps(jm, batches, False, 3)
    tl, tg, tp = _port_steps(m, batches, False, 3)
    np.testing.assert_allclose(tl, jl, atol=1e-5, rtol=1e-5)
    assert set(tg) == set(jg)
    for name in jg:
        np.testing.assert_allclose(tg[name], jg[name], atol=1e-5, rtol=1e-3,
                                   err_msg=name)
    _check_params(p0, tp, jp, jg, 1e-2)


def _check_params(p0, tp, jp, jg, update_tol, steps=3):
    """Every parameter moved where it had a gradient, no element is
    further from the reference than two Adam steps a step, and the
    whole model's update is within ``update_tol`` relative L2."""
    for name in jp:
        assert not np.array_equal(tp[name], p0[name]) or \
            not np.any(jg[name]), name
        assert np.abs(tp[name] - jp[name]).max() <= 2 * LR * steps, name
    upd_t = np.concatenate([(tp[n] - p0[n]).ravel() for n in jp])
    upd_j = np.concatenate([(jp[n] - p0[n]).ravel() for n in jp])
    assert _rel_l2(upd_t, upd_j) < update_tol


def test_bert_pretraining_steps_match_jax_under_bf16_amp():
    jm, m = _bert_pair()
    p0 = export_state(m)
    batches = [_bert_inputs(seed=s) for s in (0, 1)]
    jl, jg, jp = _jax_steps(jm, batches, True, 3)
    tl, tg, tp = _port_steps(m, batches, True, 3)
    np.testing.assert_allclose(tl, jl, rtol=2e-2)
    for name in jg:
        if np.any(jg[name]):
            assert _rel_l2(tg[name], jg[name]) < 5e-2, name
    _check_params(p0, tp, jp, jg, 1e-1)


def test_amp_casts_only_linear_and_matmul():
    """Under auto_cast the projections compute in bf16 while the residual
    stream stays f32: every LayerNorm but the MLM head's sees f32 input,
    as in the reference."""
    _, m = _bert_pair()
    seen = []
    for mod in m.modules():
        if isinstance(mod, nn.LayerNorm):
            mod.register_forward_pre_hook(
                lambda mod, args: seen.append(args[0].dtype))
    ids, tt, mask, _, _ = (torch.from_numpy(a) for a in _bert_inputs())
    with amp.auto_cast(dtype="bfloat16"):
        logits, nsp_logits = m(ids, tt, mask)
        assert F.linear(torch.ones(2, 3), torch.ones(3, 4)).dtype == \
            torch.bfloat16
    assert seen == [torch.float32] * 5 + [torch.bfloat16]
    assert logits.dtype == torch.float32         # bf16 matmul + f32 bias
    assert nsp_logits.dtype == torch.bfloat16
    assert not amp.is_enabled()
    assert F.linear(torch.ones(2, 3), torch.ones(3, 4)).dtype == \
        torch.float32


def test_every_parameter_gets_a_gradient_through_the_functions():
    """The regression test for autograd through the kernels: LayerNorm and
    attention outputs carry the port's Functions (default dropouts on),
    and every parameter gets a finite gradient."""
    m = BertForPretraining(BertConfig.tiny()).train()
    fns = []
    for mod in m.modules():
        if isinstance(mod, nn.LayerNorm):
            mod.register_forward_hook(
                lambda mod, a, out: fns.append(type(out.grad_fn).__name__))
    ids, tt, mask, mlm, nsp = (torch.from_numpy(a) for a in _bert_inputs())
    logits, nsp_logits = m(ids, tt, mask)
    assert fns == ["LayerNormFunctionBackward"] * 6
    m.loss(logits, nsp_logits, mlm, nsp).backward()
    for name, p in m.named_parameters():
        assert p.grad is not None and bool(torch.isfinite(p.grad).all()), \
            name
    m.clear_gradients()
    assert all(p.grad is None for p in m.parameters())


def test_parameters_come_in_the_reference_order():
    jm, m = _bert_pair()
    assert [n for n, _ in m.named_parameters()] == \
        [n for n, _ in jm.named_parameters()]


def test_export_state_round_trips():
    jm, m = _bert_pair()
    state = export_state(m)
    ref = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    assert set(state) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(state[k], ref[k])


# -- jit, random, the bench -----------------------------------------------------

def test_to_static_puts_models_in_train_mode_and_runs_eagerly():
    m = nn.Linear(2, 2).eval()
    step = jit.to_static(lambda x: m(x) * 2, models=[m])
    assert m.training
    assert step(torch.ones(1, 2)).shape == (1, 2)

    @jit.to_static
    def double(x):
        return 2 * x
    assert double(3) == 6
    # bucketing is ported: a batch of 3 pads to the bucket of 4, and the
    # output is sliced back to 3 rows
    padded = jit.to_static(lambda x: 2 * x, bucket=True, buckets=[4])
    assert torch.equal(padded(torch.ones(3, 2)), torch.full((3, 2), 2.0))
    # the reference's signature, for the names the port takes
    assert jjit.to_static.__code__.co_varnames[:4] == \
        jit.to_static.__code__.co_varnames[:4]


def test_generators_per_device_and_seed_pairs():
    random.seed(5)
    a = random.next_seed_pair()
    b = random.next_seed_pair()
    assert a != b
    assert all(-2 ** 31 <= w < 2 ** 31 for w in a + b)
    random.seed(5)
    assert random.next_seed_pair() == a
    # dropout draws on the tensor's device, from that device's generator
    x = torch.ones(1000)
    random.seed(1)
    y1 = F.dropout(x, 0.5)
    random.seed(1)
    y2 = F.dropout(x, 0.5)
    assert torch.equal(y1, y2) and y1.device == x.device
    assert 0.4 < (y1 == 0).float().mean().item() < 0.6
    assert random.generator("cpu") is random.generator()


def test_bench_bert_runs_on_the_cpu_when_asked_and_raises_without_a_card(
        monkeypatch):
    small = dict(num_hidden_layers=1, hidden_size=64, num_attention_heads=2,
                 intermediate_size=128)
    kernels.reset_launches()
    tok_s, last = bench_bert.bench_bert(batch=2, seq=16, steps=2, inner=1,
                                        device="cpu", **small)
    assert tok_s > 0 and np.isfinite(last)
    assert sum(kernels.launches.values()) == 0
    ids, mlm, nsp = bench_bert.make_data(30522, 2, 16, 3)
    assert ids.shape == mlm.shape == (3, 2, 16) and nsp.shape == (3, 2)
    assert ids.dtype == np.int32 and set(np.unique(nsp)) <= {0, 1}
    assert 0.05 < (mlm >= 0).mean() < 0.3 and set(mlm[mlm < 0]) == {-1}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_bert.bench_bert(batch=2, seq=16, steps=1, inner=1, **small)
