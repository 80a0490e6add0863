"""The port's ``jit.to_static`` (``StaticFunction``, ``TracedLayer``)
against the JAX package's, on the CPU.

On the card a compiled entry is a CUDA graph; on the CPU the same entry
re-runs the step over its static buffers, so the caching, keying,
bucketing, copy-in and copy-out, and in-place state that the graphs rest
on are held here against the reference (weights carried across with
``convert.load_jax_state``, inputs made with numpy from a seed).

Tolerances, each with its reason:

* a 2-layer BERT pretraining step with AdamW, three compiled calls at
  dropout 0: losses within 1e-5 (float32 matmuls summed in another
  order), every parameter element within the Adam bound of
  ``2 * lr * steps`` of the reference's and the whole update within 1e-2
  relative L2 (an element whose gradient is rounding noise moves by about
  lr in a direction the noise picks; ``test_torch_training.py`` measured
  3.2e-3 for the same step taken eagerly);
* small MLPs: 1e-6 (one or two float32 products);
* the port against itself (a compiled step against the same step taken
  eagerly, on the CPU): bit for bit, since the same operations run.

Isolation: every test clears the reference's flat-arena hook and turns
both packages' monitors off and resets them, before and after; no test
builds a JAX ``ParamArena``, whose tensor hook would break later JAX
forwards on the worker (ROADMAP.md Queue C).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.tensor as ref_tensor
from paddle_tpu import jit as jjit
from paddle_tpu import monitor as ref_monitor
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.models.bert import BertConfig as JBertConfig
from paddle_tpu.models.bert import BertForPretraining as JBertForPretraining

from paddle_tpu_torch import jit, monitor, nn, optimizer
from paddle_tpu_torch import seed as port_seed
from paddle_tpu_torch.convert import export_state, load_jax_state
from paddle_tpu_torch.models import BertConfig, BertForPretraining

SEQ = 16
LR = 1e-3
TOL = dict(atol=1e-6, rtol=1e-6)


@pytest.fixture(autouse=True)
def _isolated():
    hook = ref_tensor._arena_hook
    ref_tensor._arena_hook = None
    for mon in (ref_monitor, monitor):
        mon.disable(flush_counters=False)
        mon.reset()
    yield
    for mon in (ref_monitor, monitor):
        mon.disable(flush_counters=False)
        mon.reset()
    ref_tensor._arena_hook = hook


def _arrays(layer):
    return {k: np.asarray(v.numpy()) for k, v in layer.state_dict().items()}


def _mlp_pair(seed=0):
    pt.seed(seed)
    ref = jnn.Sequential(jnn.Linear(4, 8), jnn.ReLU(), jnn.Linear(8, 2))
    port = load_jax_state(
        nn.Sequential(nn.Linear(4, 8), nn.ReLU(), nn.Linear(8, 2)),
        _arrays(ref))
    return ref, port


def _x(rows, seed=0):
    return np.random.RandomState(seed).randn(rows, 4).astype("f4")


# -- (a) a compiled BERT pretraining step -------------------------------------

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


def test_bert_step_under_to_static_matches_the_references():
    knobs = dict(num_attention_heads=2, hidden_size=128,
                 hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    pt.seed(0)
    jm = JBertForPretraining(JBertConfig.tiny(**knobs))
    jm.train()
    m = BertForPretraining(BertConfig.tiny(**knobs)).train()
    load_jax_state(m, _arrays(jm))
    assert len(m.bert.encoder) == 2
    p0 = export_state(m)
    jo = jopt.AdamW(learning_rate=LR, parameters=jm.parameters())
    o = optimizer.AdamW(learning_rate=LR, parameters=m.parameters())

    def jstep(ids, tt, mask, mlm, nsp):
        logits, nsp_logits = jm(ids, tt, mask)
        loss = jm.loss(logits, nsp_logits, mlm, nsp)
        loss.backward()
        jo.step()
        jo.clear_grad()
        return loss

    def step(ids, tt, mask, mlm, nsp):
        logits, nsp_logits = m(ids, tt, mask)
        loss = m.loss(logits, nsp_logits, mlm, nsp)
        loss.backward()
        o.step()
        o.clear_grad()
        return loss

    jf = jjit.to_static(jstep, models=[jm], optimizers=[jo])
    f = jit.to_static(step, models=[m], optimizers=[o])
    batches = [_bert_inputs(seed=s) for s in (0, 1, 0)]
    want = [float(jf(*[pt.to_tensor(a) for a in b]).numpy())
            for b in batches]
    got = [float(f(*[torch.from_numpy(a) for a in b])) for b in batches]
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    assert len(f._cache) == 1
    (entry,) = f._cache.values()
    assert entry.replays == 2 and not entry.card
    tp = export_state(m)
    jp = {n: np.asarray(p.numpy(), np.float32)
          for n, p in jm.named_parameters()}
    for name in jp:
        assert np.abs(tp[name] - jp[name]).max() <= 2 * LR * 3, name
    upd_t = np.concatenate([(tp[n] - p0[n]).ravel() for n in jp])
    upd_j = np.concatenate([(jp[n] - p0[n]).ravel() for n in jp])
    rel = np.linalg.norm(upd_t - upd_j) / np.linalg.norm(upd_j)
    assert rel < 1e-2, rel
    # the host step counts advanced once a step
    assert set(o._steps.values()) == {3}


# -- (b) the monitor's compile accounting -------------------------------------

def _counters(mon):
    reg = mon.registry()
    return {k: reg.value(k, 0) for k in ("jit.compile", "jit.cache_hit",
                                         "jit.recompile", "jit.bucket_pad")}


def test_monitor_counts_compiles_hits_recompiles_and_pads_as_the_reference():
    """A new shape, a repeat, a second shape, a train/eval flip and a
    padded batch: the same counts in both packages, after each call."""
    ref, port = _mlp_pair()
    jo = jopt.Adam(learning_rate=0.01, parameters=ref.parameters())
    o = optimizer.Adam(learning_rate=0.01, parameters=port.parameters())

    def make(model, opt):
        def step(x):
            loss = model(x).mean()
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss
        return step

    jf = jjit.to_static(make(ref, jo), models=[ref], optimizers=[jo],
                        bucket=True, buckets=[4, 8])
    f = jit.to_static(make(port, o), models=[port], optimizers=[o],
                      bucket=True, buckets=[4, 8])
    ref.train()
    ref_monitor.enable()
    monitor.enable()
    script = [("call", 8), ("call", 8), ("call", 4), ("eval", None),
              ("call", 8), ("train", None), ("call", 3)]
    for i, (what, rows) in enumerate(script):
        if what == "call":
            x = _x(rows, seed=i)
            a = float(jf(pt.to_tensor(x)).numpy())
            b = float(f(torch.from_numpy(x)))
            np.testing.assert_allclose(b, a, **TOL)
        else:
            for model in (ref, port):
                getattr(model, what)()
        assert _counters(monitor) == _counters(ref_monitor), (i, what)
    assert _counters(monitor) == {"jit.compile": 3, "jit.cache_hit": 2,
                                  "jit.recompile": 1, "jit.bucket_pad": 1}
    assert monitor.registry().value("jit.compile_s", 0) > 0


# -- (c) bucketing ------------------------------------------------------------

@pytest.mark.parametrize("pad_mode", ["repeat", "zeros"])
def test_bucketed_outputs_are_sliced_back_as_the_references(pad_mode):
    """A batch of 3 padded to the bucket of 4: the per-row output comes
    back with 3 rows, and the scalar takes the padded row in, as the
    reference's does."""
    ref, port = _mlp_pair()
    jf = jjit.to_static(lambda x: (ref(x), ref(x).sum()), models=[ref],
                        optimizers=[], bucket=True, buckets=[4],
                        pad_mode=pad_mode)
    f = jit.to_static(lambda x: (port(x), port(x).sum()), models=[port],
                      optimizers=[], bucket=True, buckets=[4],
                      pad_mode=pad_mode)
    for seed in (0, 1):
        x = _x(3, seed)
        jrows, jsum = jf(pt.to_tensor(x))
        rows, total = f(torch.from_numpy(x))
        assert tuple(rows.shape) == (3, 2)
        np.testing.assert_allclose(rows.detach().numpy(),
                                   np.asarray(jrows.numpy()), **TOL)
        np.testing.assert_allclose(float(total), float(jsum.numpy()), **TOL)
    assert len(f._cache) == 1


# -- (d) storage stays put ----------------------------------------------------

def _bn_model():
    port_seed(0)
    return nn.Sequential(nn.Linear(4, 8), nn.BatchNorm1D(8), nn.ReLU(),
                         nn.Linear(8, 2))


OPTIMIZERS = {
    "Adam": lambda ps: optimizer.Adam(learning_rate=0.01, parameters=ps),
    "AdamW": lambda ps: optimizer.AdamW(learning_rate=0.01, parameters=ps),
    "Momentum": lambda ps: optimizer.Momentum(learning_rate=0.01,
                                              momentum=0.9, parameters=ps),
    "flat_arena": lambda ps: optimizer.AdamW(learning_rate=0.01,
                                             parameters=ps, flat_arena=True),
}


@pytest.mark.parametrize("kind", list(OPTIMIZERS))
def test_state_storage_stays_put_across_compiled_steps(kind):
    """The precondition of capture: the address of every parameter, slot,
    pow, learning rate, running statistic and arena buffer is the same
    after every compiled step; and the compiled steps give the eager
    steps' parameters and statistics bit for bit."""
    models = [_bn_model(), _bn_model()]
    opts = [OPTIMIZERS[kind](list(m.parameters())) for m in models]

    def make(m, o):
        def step(x):
            loss = m(x).square().mean()
            loss.backward()
            o.step()
            o.clear_grad()
            return loss
        return step

    eager = make(models[0], opts[0])
    f = jit.to_static(make(models[1], opts[1]), models=[models[1]],
                      optimizers=[opts[1]])
    addresses = []
    for i in range(4):
        x = torch.from_numpy(_x(6, seed=i))
        torch.testing.assert_close(f(x), eager(x).detach(), rtol=0, atol=0)
        state = jit._collect_state([models[1]], [opts[1]])
        addresses.append({n: t.data_ptr() for n, t in state.items()})
        if kind == "flat_arena":
            assert opts[1]._arena.matches(
                [p for p in models[1].parameters()])
    assert all(a == addresses[0] for a in addresses[1:])
    names = set(addresses[0])
    assert any(".lr." in n for n in names)
    assert any("_mean" in n for n in names)
    if kind == "flat_arena":
        assert {n.split(".", 2)[-1] for n in names if "arena" in n} >= {
            "flat", "moment1", "moment2", "beta1_pow", "beta2_pow"}
    elif kind != "Momentum":
        assert any(n.endswith("beta1_pow") for n in names)
    for a, b in zip(models[1].state_dict().values(),
                    models[0].state_dict().values()):
        assert torch.equal(a, b)
    assert opts[1]._steps == {id(p): 4 for p in models[1].parameters()} \
        or kind == "flat_arena"


# -- (e) returned tensors are the caller's ------------------------------------

def test_a_later_call_never_overwrites_an_earlier_result():
    _, port = _mlp_pair()
    f = jit.to_static(lambda x: port(x) * 2, models=[port], optimizers=[])
    x1, x2 = (torch.from_numpy(_x(5, seed=s)) for s in (0, 1))
    a = f(x1)
    kept = a.clone()
    b = f(x2)
    c = f(x2)
    assert not torch.equal(a, b) and torch.equal(b, c)
    assert torch.equal(a, kept)
    assert b.data_ptr() != c.data_ptr()
    torch.testing.assert_close(f(x1), kept, rtol=0, atol=0)


# -- (f) TracedLayer ----------------------------------------------------------

def test_traced_layer_matches_the_references():
    ref, port = _mlp_pair(seed=3)
    x = _x(5)
    jout, jtl = jjit.TracedLayer.trace(ref, [pt.to_tensor(x)])
    out, tl = jit.TracedLayer.trace(port, [torch.from_numpy(x)])
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout.numpy()),
                               **TOL)
    x2 = _x(5, seed=9)
    np.testing.assert_allclose(tl(torch.from_numpy(x2)).numpy(),
                               np.asarray(jtl(pt.to_tensor(x2)).numpy()),
                               **TOL)


# -- (g) the options left out -------------------------------------------------

@pytest.mark.parametrize("kw,item", [(dict(plan=object()), "item 19"),
                                     (dict(remat="full"), "items 8 and 20"),
                                     (dict(scalers=[object()]), "item 6")])
def test_unported_options_raise_naming_their_items(kw, item):
    with pytest.raises(NotImplementedError, match=item):
        jit.to_static(lambda x: x, **kw)
    # input_spec and donate_state are taken and change nothing
    f = jit.to_static(lambda x: x + 1, input_spec=[None],
                      donate_state=False)
    assert torch.equal(f(torch.zeros(2)), torch.ones(2))
