"""The port's training loop as users write it — ``amp.auto_cast`` at O2
and with custom op lists, ``amp.decorate``, ``amp.GradScaler`` and
``jit.to_static`` carrying the scaler — against the JAX package, on the
CPU (inputs numpy from a seed, weights carried with
``convert.load_jax_state``).

Tolerances, each with its reason:

* float32 parameters (master weights, O1) under a scaler, an MLP over 6
  steps: 1e-6 (one or two float32 products summed in another order); a
  float32 2-layer BERT (hidden 64) with the whole recipe (schedule,
  global-norm clip, scaler) over 4 compiled steps: losses within 1e-5,
  each element
  within the Adam bound ``2 * peak_lr * steps`` and the update within
  1e-2 relative L2, as ``test_torch_jit.py``'s BERT step;
* bfloat16 parameters (O2) under SGD and Momentum: 2e-2 relative and
  1e-3 absolute after 6 steps (each step rounds the parameter to bf16,
  a relative step of 2^-8; the reference holds its SGD and Momentum
  parameters in float32 after the first step, where its float32 rate
  promotes them);
* the skipped step, the scaler's scale and counts, the dtypes and the
  port against itself (a compiled step against the eager one): exact.

Adam under O2 is held to its closed form, not to the reference: the
reference keeps the beta pows in the parameter's dtype, and a bfloat16
``beta2_pow`` is 0.999 rounded to 1.0, so its first step divides by zero
and leaves the parameters as they were (ROADMAP.md Queue C). The port's
pows are float32.

Isolation: each test clears the reference's flat-arena hook and restores
it after (the ``_no_arena_hook`` pattern); no test builds a JAX
``ParamArena``; amp's global state is the context manager's.
"""
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as pt
import paddle_tpu.tensor as ref_tensor
from paddle_tpu import amp as jamp
from paddle_tpu import jit as jjit
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.models.bert import BertConfig as JBertConfig
from paddle_tpu.models.bert import BertForPretraining as JBertForPretraining
from paddle_tpu.optimizer import lr as jlr

from paddle_tpu_torch import amp, clip, jit, nn, optimizer
from paddle_tpu_torch.convert import export_state, load_jax_state
from paddle_tpu_torch.models import BertConfig, BertForPretraining
from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.optimizer import lr
from paddle_tpu_torch.tools import bench_bert

# the reference's root rebinds `clip` to the clip op; the module is here
jclip = importlib.import_module("paddle_tpu.clip")


@pytest.fixture(autouse=True)
def _no_arena_hook():
    hook = ref_tensor._arena_hook
    ref_tensor._arena_hook = None
    yield
    ref_tensor._arena_hook = hook


def _arrays(layer):
    return {k: np.asarray(v.numpy()) for k, v in layer.state_dict().items()}


def _mlp_pair(seed=0):
    pt.seed(seed)
    ref = jnn.Sequential(jnn.Linear(6, 16), jnn.ReLU(), jnn.Linear(16, 3))
    port = load_jax_state(
        nn.Sequential(nn.Linear(6, 16), nn.ReLU(), nn.Linear(16, 3)),
        _arrays(ref))
    return ref, port


def _batches(n=6, seed=7):
    rng = np.random.RandomState(seed)
    return [(rng.randn(5, 6).astype("f4"), rng.randn(5, 3).astype("f4"))
            for _ in range(n)]


# -- auto_cast and decorate ----------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(level="O2"), dict(level="O1", custom_white_list={"softmax"}),
    dict(custom_black_list=["matmul"]),
    dict(level="O2", custom_white_list=["gelu"], custom_black_list=["exp"])],
    ids=["o2", "white", "black", "o2_lists"])
def test_auto_cast_takes_o2_and_lists_as_the_reference(kw):
    """Accepted, with the reference's effect: the white-listed linear
    computes in bf16, the flag and dtype read as the reference's."""
    ref, port = _mlp_pair()
    x = _batches(1)[0][0]
    with jamp.auto_cast(**kw):
        want = ref(pt.to_tensor(x))
        jstate = (jamp.is_enabled(), str(jamp.compute_dtype().__name__))
    with amp.auto_cast(**kw):
        got = port(torch.from_numpy(np.array(x)))
        state = (amp.is_enabled(), str(amp.compute_dtype()).split(".")[-1])
    assert state == jstate and not amp.is_enabled()
    assert got.dtype == torch.bfloat16 and str(want.dtype) == "bfloat16"
    np.testing.assert_allclose(got.float().detach().numpy(),
                               np.asarray(want.numpy(), np.float32),
                               rtol=2e-2, atol=2e-2)


def _bert_pair(**kw):
    knobs = dict(num_attention_heads=2, hidden_size=64,
                 intermediate_size=128, hidden_dropout_prob=0.0,
                 attention_probs_dropout_prob=0.0)
    knobs.update(kw)
    pt.seed(0)
    jm = JBertForPretraining(JBertConfig.tiny(**knobs))
    jm.train()
    m = BertForPretraining(BertConfig.tiny(**knobs)).train()
    load_jax_state(m, _arrays(jm))
    return jm, m


def _dtypes(named):
    return {n: str(t.dtype).split(".")[-1] for n, t in named}


@pytest.mark.parametrize("level", ["O1", "O2"])
@pytest.mark.parametrize("net", ["mlp", "bert", "conv_bn"])
def test_decorate_gives_the_references_dtypes(net, level):
    if net == "mlp":
        jm, m = _mlp_pair()
    elif net == "bert":
        jm, m = _bert_pair()
    else:       # a batch norm's statistics are floating buffers
        pt.seed(0)
        jm = jnn.Sequential(jnn.Conv2D(3, 4, 3), jnn.BatchNorm2D(4))
        m = nn.Sequential(nn.Conv2D(3, 4, 3), nn.BatchNorm2D(4))
    jo = jopt.AdamW(parameters=jm.parameters())
    o = optimizer.AdamW(parameters=m.parameters())
    ids = [id(p) for p in m.parameters()]
    assert jamp.decorate(jm, jo, level=level) == (jm, jo)
    assert amp.decorate(m, o, level=level) == (m, o)
    assert amp.decorate(m, level="O1") is m
    want = _dtypes((n, p.data) for n, p in jm.named_parameters())
    got = _dtypes(m.named_parameters())
    assert got == want
    assert set(want.values()) == {"bfloat16" if level == "O2"
                                  else "float32"}
    jb = _dtypes((n, b.data) for n, b in jm.named_buffers()
                 if jnp.issubdtype(b.data.dtype, jnp.floating))
    pb = {n: d for n, d in _dtypes(m.named_buffers()).items()
          if n in jb}
    assert pb == jb
    # the optimizer keeps the same parameter objects
    assert [id(p) for p in o._params()] == ids


# -- GradScaler ------------------------------------------------------------------

def _scaled_steps(model, opt, scaler, batches, fwd, overflow_at, ref):
    """Steps under the scaler; at ``overflow_at`` the scale is set near the
    float32 maximum first, and put back to 2^11 after that step. Returns
    each step's (state, scaler state)."""
    out = []
    for i, (x, y) in enumerate(batches):
        if i == overflow_at:
            scaler.set_state_dict({"scale": 3.4e38, "good": 1, "bad": 0})
        elif i == overflow_at + 1:
            scaler.set_state_dict({"scale": 2.0 ** 11, "good": 0, "bad": 0})
        d = fwd(model, x) - (pt.to_tensor(y) if ref else torch.from_numpy(
            np.array(y)))
        loss = (d * d).mean() * 100.0
        scaled = scaler.scale(loss)
        scaled.backward()
        scaler.minimize(opt, scaled)
        opt.clear_grad()
        state = _arrays(model) if ref else _state(model)
        out.append((state, scaler.state_dict()))
    return out


def _state(model):
    return {k: v.detach().float().numpy().copy()
            for k, v in model.state_dict().items()}


def _ref_fwd(model, x):
    return model(pt.to_tensor(x)).astype("float32")


def _port_fwd(model, x):
    return model(torch.from_numpy(np.array(x))).float()


ROUTES = {"plain": dict(use_multi_tensor=False),
          "use_fused": dict(use_fused=True, use_multi_tensor=False),
          "multi": dict(use_multi_tensor=True)}


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("cls", ["Adam", "AdamW"])
def test_grad_scaler_o1_six_steps_with_an_overflow(cls, route):
    """Six steps of float32 master weights under the scaler (incr every 2
    good steps), the fourth forced to overflow: parameters within 1e-6 of
    the reference's, the skipped step bit-equal to the one before, and
    the scale and counts equal after every step."""
    ref, port = _mlp_pair(1)
    jo = getattr(jopt, cls)(learning_rate=0.01, parameters=ref.parameters())
    o = getattr(optimizer, cls)(learning_rate=0.01,
                                parameters=port.parameters(), **ROUTES[route])
    kw = dict(init_loss_scaling=2.0 ** 10, incr_every_n_steps=2)
    want = _scaled_steps(ref, jo, jamp.GradScaler(**kw), _batches(), _ref_fwd,
                         3, True)
    got = _scaled_steps(port, o, amp.GradScaler(**kw), _batches(), _port_fwd,
                        3, False)
    for i, ((gs, gsc), (ws, wsc)) in enumerate(zip(got, want)):
        assert gsc == wsc, i
        for k in ws:
            np.testing.assert_allclose(gs[k], ws[k], rtol=1e-6, atol=1e-6,
                                       err_msg=f"{k} step {i}")
    assert got[3][1] == {"scale": float(np.float32(3.4e38) * 0.5),
                         "good": 0, "bad": 0}
    for k in got[2][0]:
        assert np.array_equal(got[3][0][k], got[2][0][k]), k


@pytest.mark.parametrize("route", ["arena", "arena_kernel"])
def test_grad_scaler_arena_equals_the_plain_route(route):
    """The flat arena (its plain rule, and its kernel's plain version
    under ``fused_adam_multi``) under the scaler and a global-norm clip,
    against the per-parameter route of the same port: the same values
    within 1e-6, the skipped step bit-equal."""
    _, a = _mlp_pair(2)
    _, b = _mlp_pair(2)
    kernels.configure(fused_adam_multi=route == "arena_kernel")
    try:
        oa = optimizer.AdamW(learning_rate=0.01, parameters=a.parameters(),
                             flat_arena=True,
                             grad_clip=clip.ClipGradByGlobalNorm(0.5))
        ob = optimizer.AdamW(learning_rate=0.01, parameters=b.parameters(),
                             use_multi_tensor=False,
                             grad_clip=clip.ClipGradByGlobalNorm(0.5))
        kw = dict(init_loss_scaling=2.0 ** 10, incr_every_n_steps=2)
        ga = _scaled_steps(a, oa, amp.GradScaler(**kw), _batches(),
                           _port_fwd, 2, False)
        gb = _scaled_steps(b, ob, amp.GradScaler(**kw), _batches(),
                           _port_fwd, 2, False)
    finally:
        kernels.configure(fused_adam_multi=None)
    for (sa, ca), (sb, cb) in zip(ga, gb):
        assert ca == cb
        for k in sb:
            np.testing.assert_allclose(sa[k], sb[k], rtol=1e-6, atol=1e-6)
    for k in ga[1][0]:
        assert np.array_equal(ga[2][0][k], ga[1][0][k])


@pytest.mark.parametrize("cls", ["SGD", "Momentum"])
def test_grad_scaler_o2_sgd_and_momentum(cls):
    """Pure bf16 parameters (decorate O2) under the scaler: within the
    bf16 tolerance of the reference's after six steps with one skipped."""
    ref, port = _mlp_pair(3)
    args = (1e-3, 0.9) if cls == "Momentum" else (1e-3,)
    jo = getattr(jopt, cls)(*args, parameters=ref.parameters())
    o = getattr(optimizer, cls)(*args, parameters=port.parameters())
    jamp.decorate(ref, jo, level="O2")
    amp.decorate(port, o, level="O2")
    kw = dict(init_loss_scaling=2.0 ** 8, incr_every_n_steps=2)
    want = _scaled_steps(ref, jo, jamp.GradScaler(**kw), _batches(), _ref_fwd,
                         4, True)
    got = _scaled_steps(port, o, amp.GradScaler(**kw), _batches(), _port_fwd,
                        4, False)
    assert [p.dtype for p in port.parameters()] == [torch.bfloat16] * 4
    for (gs, gsc), (ws, wsc) in zip(got, want):
        assert gsc == wsc
        for k in ws:
            np.testing.assert_allclose(gs[k], np.asarray(ws[k], np.float32),
                                       rtol=2e-2, atol=1e-3, err_msg=k)
    for k in got[3][0]:
        assert np.array_equal(got[4][0][k], got[3][0][k])


@pytest.mark.parametrize("route", ["plain", "use_fused", "multi", "arena"])
def test_o2_adamw_first_step_is_the_closed_form(route):
    """Bias-corrected Adam's first step moves each element by
    ``lr * g / (|g| + eps)``, about ``lr``, less the decay: the port's bf16
    parameters do (float32 pows), within one bf16 step of the closed
    form; the reference's stay where they were (its bf16 ``beta2_pow`` is
    1.0)."""
    ref, port = _mlp_pair(4)
    kw = dict(ROUTES, arena=dict(flat_arena=True))[route]
    jo = jopt.AdamW(learning_rate=0.01, parameters=ref.parameters())
    o = optimizer.AdamW(learning_rate=0.01, parameters=port.parameters(),
                        **kw)
    jamp.decorate(ref, jo, level="O2")
    amp.decorate(port, o, level="O2")
    p0 = _state(port)
    x, y = _batches(1)[0]
    d = _port_fwd(port, x) - torch.from_numpy(np.array(y))
    (d * d).mean().backward()
    g = {n: p.grad.float().numpy() for n, p in port.named_parameters()}
    o.step()
    dj = _ref_fwd(ref, x) - pt.to_tensor(y)
    (dj * dj).mean().backward()
    jo.step()
    got = _state(port)
    for n in g:
        step = 0.01 * g[n] / (np.abs(g[n]) + 1e-8)
        want = p0[n] - step - 0.01 * 0.01 * p0[n]
        np.testing.assert_allclose(got[n], want, rtol=2 ** -7, atol=2e-4,
                                   err_msg=n)
        # the reference's: as they were, or NaN where g is 0 (v is 0 and
        # its bias correction divides by 1 - 1)
        r = np.asarray(_arrays(ref)[n], np.float32)
        assert np.all((r == p0[n]) | (np.isnan(r) & (g[n] == 0))), n
    if route == "arena":
        (grp,) = o._arena.groups
        assert grp.dtype == torch.bfloat16
        assert grp.slots["moment1"].dtype == torch.bfloat16
        assert all(t.dtype == torch.float32 for t in grp.pows.values())
    else:
        want_m = torch.float32 if route != "plain" else torch.bfloat16
        assert {s["moment1"].dtype for s in o._accumulators.values()} == \
            {want_m}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_arena_members_start_aligned_and_gaps_stay_zero(dtype):
    """Each arena member starts at a multiple of ``MEMBER_ALIGN``
    elements (cuBLAS reads a bf16 weight in place only at full speed when
    it is 16-byte aligned); the packed gradient and the update keep the
    gaps between members at zero."""
    from paddle_tpu_torch.optimizer import arena as port_arena
    _, m = _bert_pair()
    m.to(dtype=dtype)
    o = optimizer.AdamW(learning_rate=0.01, parameters=m.parameters(),
                        flat_arena=True)
    o._ensure_all_slots()
    (grp,) = o._arena.groups
    assert all(off % port_arena.MEMBER_ALIGN == 0
               for _, off, _, _ in grp.entries)
    base = grp.flat.data_ptr()
    assert all((p.data_ptr() - base) % (port_arena.MEMBER_ALIGN *
                                        grp.flat.element_size()) == 0
               for p in m.parameters())
    gaps = torch.ones(grp.total, dtype=torch.bool)
    for _, off, n, _ in grp.entries:
        gaps[off:off + n] = False
    assert gaps.any()
    for p in m.parameters():
        p.grad = torch.ones_like(p)
    ((_, flat_g, mask),) = o._arena.pack_grads(
        [(p, p.grad) for p in m.parameters()])
    assert mask is None and not flat_g[gaps].any() and flat_g[~gaps].all()
    o.step()
    for t in [grp.flat] + list(grp.slots.values()):
        assert not t[gaps].any()


def test_grad_scaler_disabled_passes_through():
    _, port = _mlp_pair()
    o = optimizer.SGD(0.1, parameters=port.parameters())
    s = amp.GradScaler(enable=False)
    loss = port(torch.ones(2, 6)).sum()
    assert s.scale(loss) is loss
    w0 = port[0].weight.detach().clone()
    s.minimize(o, loss)
    assert not torch.equal(port[0].weight, w0)


def test_grad_scaler_state_dict_round_trip():
    s = amp.GradScaler(init_loss_scaling=128.0, incr_every_n_steps=3)
    ptrs = [t.data_ptr() for t in (s._scale, s._good, s._bad)]
    s.set_state_dict({"scale": 2.0 ** 20, "good": 2, "bad": 1})
    assert s.state_dict() == {"scale": 2.0 ** 20, "good": 2, "bad": 1}
    assert [t.data_ptr() for t in (s._scale, s._good, s._bad)] == ptrs
    j = jamp.GradScaler(init_loss_scaling=128.0)
    j.set_state_dict(s.state_dict())
    assert j.state_dict() == s.state_dict()


# -- unported options ------------------------------------------------------------

def test_unported_options_raise_naming_their_item():
    w = torch.nn.Parameter(torch.zeros(2))
    with pytest.raises(NotImplementedError, match="item 19"):
        optimizer.AdamW(parameters=[w], grad_sync="exact")
    s = amp.GradScaler()
    meta = torch.ones((), dtype=torch.float16, device="meta")
    with pytest.raises(NotImplementedError, match="item 24"):
        s.scale(meta)
    wm = torch.nn.Parameter(torch.zeros(2, dtype=torch.float16,
                                        device="meta"))
    wm.grad = torch.zeros(2, dtype=torch.float16, device="meta")
    with pytest.raises(NotImplementedError, match="item 24"):
        s.unscale_(optimizer.SGD(parameters=[wm]))
    with pytest.raises(NotImplementedError, match="item 19"):
        jit.to_static(lambda: None, plan=object())
    # float16 on the CPU is the caller asking for it: it runs
    x = torch.ones((), dtype=torch.float16)
    assert s.scale(x).dtype == torch.float32


# -- to_static with a scaler, a scheduler and a clip ----------------------------

def _recipe(seed, route):
    _, port = _mlp_pair(seed)
    sched = lr.LinearWarmup(lr.PolynomialDecay(0.01, decay_steps=20),
                            warmup_steps=2, start_lr=0.0, end_lr=0.01)
    o = optimizer.AdamW(learning_rate=sched, parameters=port.parameters(),
                        grad_clip=clip.ClipGradByGlobalNorm(1.0), **route)
    amp.decorate(port, o, level="O2")
    scaler = amp.GradScaler(init_loss_scaling=2.0 ** 12,
                            incr_every_n_steps=2)

    def step(x, y):
        with amp.auto_cast(level="O2"):
            d = port(x).float() - y
        loss = (d * d).mean()
        scaler.scale(loss).backward()
        scaler.step(o)
        o.clear_grad()
        return loss.detach()

    return port, o, sched, scaler, step


@pytest.mark.parametrize("route", ["plain", "multi", "arena"])
def test_to_static_carries_the_scaler_rate_and_scale(route):
    """The compiled step (on the CPU, a re-run over its static buffers)
    against the same recipe stepped eagerly: equal bit for bit over 6
    calls with the scheduler stepped and, before the fifth, the rate and
    the scale changed from the host; one entry, never recaptured; the
    scaler's tensors are state under the reference's names."""
    kw = {"plain": dict(use_multi_tensor=False),
          "multi": dict(use_multi_tensor=True),
          "arena": dict(flat_arena=True)}[route]
    arms = [_recipe(5, kw) for _ in range(2)]
    f = jit.to_static(arms[0][4])
    batches = [tuple(torch.from_numpy(a) for a in b) for b in _batches()]
    for i, (x, y) in enumerate(batches):
        if i == 4:
            for port, o, sched, scaler, _ in arms:
                o.set_lr(0.02)
                scaler.set_state_dict({"scale": 3.4e38, "good": 0,
                                       "bad": 0})
        got = f(x, y)
        want = arms[1][4](x, y)
        assert torch.equal(got, want), i
        for a, b in zip(arms[0][0].parameters(), arms[1][0].parameters()):
            assert torch.equal(a, b), i
        assert arms[0][3].state_dict() == arms[1][3].state_dict(), i
        for _, _, sched, _, _ in arms:
            sched.step()
    assert len(f._cache) == 1
    (entry,) = f._cache.values()
    assert entry.replays == len(batches) - 1
    assert f._scalers == [arms[0][3]]
    names = jit._collect_state(*f._resolve_objects())
    assert {"s0.scale", "s0.good", "s0.bad"} <= set(names)
    assert arms[0][3].state_dict()["bad"] == 0
    assert arms[0][3].state_dict()["scale"] < 3.4e38 * 0.5


def test_to_static_finds_the_scaler_beside_given_models():
    _, port = _mlp_pair()
    o = optimizer.SGD(0.1, parameters=port.parameters())
    s = amp.GradScaler()

    def step(x):
        s.scale(port(x).sum()).backward()
        s.step(o)
        o.clear_grad()

    f = jit.to_static(step, models=[port], optimizers=[o])
    f(torch.ones(2, 6))
    assert f._scalers == [s] and f._models == [port]


def test_bert_recipe_under_to_static_matches_the_references():
    """The slice whole in float32 (where the reference's Adam is sound;
    bf16 matmuls would part the two forwards by about 1e-3), a 2-layer
    BERT of hidden 64: AdamW over the warm-up and decay schedule,
    ClipGradByGlobalNorm(1.0) and the scaler, four steps through each
    package's ``to_static`` with ``scheduler.step()`` between."""
    jm, m = _bert_pair()
    p0 = export_state(m)
    rng = np.random.RandomState(0)
    batches = []
    for _ in range(4):
        ids = rng.randint(0, 1024, (3, 16)).astype("i4")
        mlm = np.where(rng.rand(3, 16) < 0.3, rng.randint(0, 1024, (3, 16)),
                       -1).astype("i4")
        batches.append((ids, mlm, rng.randint(0, 2, 3).astype("i4")))

    def sched(m_):
        return m_.LinearWarmup(m_.PolynomialDecay(1e-3, decay_steps=20),
                               warmup_steps=2, start_lr=0.0, end_lr=1e-3)

    js, s = sched(jlr), sched(lr)
    jo = jopt.AdamW(learning_rate=js, parameters=jm.parameters(),
                    grad_clip=jclip.ClipGradByGlobalNorm(1.0))
    o = optimizer.AdamW(learning_rate=s, parameters=m.parameters(),
                        grad_clip=clip.ClipGradByGlobalNorm(1.0))
    jsc = jamp.GradScaler(init_loss_scaling=2.0 ** 10, incr_every_n_steps=2)
    sc = amp.GradScaler(init_loss_scaling=2.0 ** 10, incr_every_n_steps=2)

    def jstep(ids, mlm, nsp):
        logits, nsp_logits = jm(ids)
        loss = jm.loss(logits, nsp_logits, mlm, nsp)
        jsc.scale(loss).backward()
        jsc.step(jo)
        jo.clear_grad()
        return loss

    def step(ids, mlm, nsp):
        logits, nsp_logits = m(ids)
        loss = m.loss(logits, nsp_logits, mlm, nsp)
        sc.scale(loss).backward()
        sc.step(o)
        o.clear_grad()
        return loss.detach()

    jf, f = jjit.to_static(jstep), jit.to_static(step)
    want, got = [], []
    for b in batches:
        want.append(float(jf(*[pt.to_tensor(a) for a in b]).numpy()))
        got.append(float(f(*[torch.from_numpy(a) for a in b])))
        js.step()
        s.step()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    assert sc.state_dict() == jsc.state_dict() == {
        "scale": 2.0 ** 12, "good": 0, "bad": 0}
    assert f._scalers == [sc] and len(f._cache) == 1
    tp = export_state(m)
    jp = {n: np.asarray(p.numpy(), np.float32)
          for n, p in jm.named_parameters()}
    for name in jp:
        assert np.abs(tp[name] - jp[name]).max() <= 2 * 1e-3 * 4, name
    upd_t = np.concatenate([(tp[n] - p0[n]).ravel() for n in jp])
    upd_j = np.concatenate([(jp[n] - p0[n]).ravel() for n in jp])
    assert np.linalg.norm(upd_t - upd_j) / np.linalg.norm(upd_j) < 1e-2


@pytest.mark.parametrize("opt_kw", [dict(use_multi_tensor=False),
                                    dict(flat_arena=True)])
def test_bench_bert_recipe_runs_on_the_cpu(opt_kw):
    """``bench_bert``'s recipe on a 2-layer BERT of hidden 64 at O2: bf16
    parameters, the device rate equal to the scheduler's each call, the
    scale doubled after 4 good steps, finite losses, one entry replayed."""
    tr = bench_bert.Trainer(2, 16, 1, device="cpu", opt_kw=opt_kw,
                            token_types=True, recipe=True,
                            num_hidden_layers=2, hidden_size=64,
                            num_attention_heads=2, intermediate_size=128,
                            vocab_size=512, max_position_embeddings=64)
    assert {p.dtype for p in tr.model.parameters()} == {torch.bfloat16}
    tr.opt._ensure_all_slots()
    for _ in range(5):
        rate = next(iter(tr.opt._lr.values()))
        assert rate.item() == float(np.float32(tr.sched.last_lr))
        losses = tr.call(graph=True)
        assert torch.isfinite(losses).all()
    assert tr.scaler.state_dict() == {"scale": 2.0 ** 16, "good": 1,
                                      "bad": 0}
    (entry,) = tr.step._cache.values()
    assert entry.replays == 4
    with pytest.raises(ValueError, match="inner=1"):
        bench_bert.Trainer(2, 16, 2, device="cpu", recipe=True)
