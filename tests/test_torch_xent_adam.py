"""The port's loss and optimizer kernels' modules against the JAX package.

On the CPU each wrapper computes its kernel's plain PyTorch version; they
are held here against the Pallas ``softmax_xent`` and ``fused_adam``
kernels run in interpret mode, on the same inputs made with numpy from a
seed. The routes that reach them (``cross_entropy``'s fused branch, Adam's
per-tensor, multi-tensor and flat-arena updates) are held against the JAX
package's, with both packages' kernel switches set alike, and the tiny
BERT pretraining slice runs through the fused route in
``test_torch_training.py``.

Tolerances, each with its reason:

* softmax cross entropy, loss and dx: float32 atol and rtol 1e-5 (the
  row sums are taken in another order, exp rounds its own way);
* Adam updates: float32 atol 1e-6 and rtol 1e-5 (the same elementwise
  float32 operations; XLA may fuse a multiply and an add into one FMA
  where PyTorch rounds twice); a bfloat16 parameter within one bfloat16
  step (rtol 2^-7) of the reference, since a last-bit float32 difference
  can round either way;
* the port's flat arena against the port's per-parameter AdamW on the
  CPU: identical bits (the same PyTorch operations in the same order).

No JAX ``ParamArena`` is built here: building one installs the JAX
package's process-wide tensor hook, which breaks later JAX forwards on
the same worker (ROADMAP.md Queue C). The port's arena is held against
``adam_step_flat`` and against the JAX per-parameter optimizers instead.

The CUDA kernels themselves are held against their plain versions on the
card in ``test_torch_cuda.py``.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.ops import loss as jloss
from paddle_tpu.ops import pallas as P
from paddle_tpu.ops.pallas import fused_adam as jfa
from paddle_tpu.ops.pallas.softmax_xent import _run_fwd, _softmax_xent2

from paddle_tpu_torch import nn, optimizer
from paddle_tpu_torch.convert import load_jax_state
from paddle_tpu_torch.ops import kernels, loss
from paddle_tpu_torch.ops.kernels import fused_adam as FA
from paddle_tpu_torch.ops.kernels import softmax_xent as SX
from paddle_tpu_torch.optimizer import arena as port_arena
from paddle_tpu_torch.tools import bench_bert

XENT_TOL = dict(atol=1e-5, rtol=1e-5)
ADAM_TOL = dict(atol=1e-6, rtol=1e-5)
BF16_TOL = dict(atol=1e-6, rtol=2 ** -7)
# every kernel name either package's switch knows
_RESET = dict(layer_norm=None, flash_attention=None, flash_min_seq=None,
              softmax_xent=None, fused_adam=None, fused_adam_multi=None,
              batch_norm=None)


@pytest.fixture
def configure():
    """Sets both packages' kernel switches alike; restores every name
    afterwards, so that later tests on the worker run with the defaults."""
    def both(**kw):
        P.configure(**kw)
        kernels.configure(**kw)
    yield both
    P.configure(**_RESET)
    kernels.configure(**_RESET)


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t, dtype=np.float32)


# -- softmax cross entropy ---------------------------------------------------

def _xent_inputs(n, v, seed=0):
    rng = np.random.RandomState(seed + n + v)
    x = (rng.randn(n, v) * 3).astype("f4")
    lbl = rng.randint(0, v, (n, 1)).astype("i4")
    lbl[::4] = -1               # ignored by the caller, no column here
    lbl[1::5] = v + 3           # out of range above
    lbl[2::7] = -7              # out of range below
    g = rng.randn(n, 1).astype("f4")
    return x, lbl, g


@pytest.mark.parametrize("eps", [0.0, 0.1])
@pytest.mark.parametrize("n,v", [(37, 2500), (5, 2)])
def test_softmax_xent_matches_pallas_loss_lse_and_dx(n, v, eps):
    """(37, 2500) crosses the Pallas backward's 2048-wide vocab tile."""
    x, lbl, g = _xent_inputs(n, v)
    ref, vjp = jax.vjp(lambda a: _softmax_xent2(a, jnp.asarray(lbl), eps),
                       jnp.asarray(x))
    (dx_ref,) = vjp(jnp.asarray(g))
    _, lse_ref = _run_fwd(jnp.asarray(x), jnp.asarray(lbl), eps)
    kernels.reset_launches()
    tx = _t(x).requires_grad_()
    got = SX.SoftmaxXentFunction.apply(tx, _t(lbl), eps)
    got.backward(_t(g))
    np.testing.assert_allclose(_np(got), np.asarray(ref), **XENT_TOL)
    np.testing.assert_allclose(_np(tx.grad), np.asarray(dx_ref), **XENT_TOL)
    _, lse = SX.softmax_xent_fwd(_t(x), _t(lbl), eps)
    np.testing.assert_allclose(_np(lse), np.asarray(lse_ref), **XENT_TOL)
    # a label with no column scores lse (less the smoothing term)
    row = 1
    want = lse[row, 0] - (eps / v) * _t(x)[row].sum() if eps else \
        lse[row, 0]
    assert got[row, 0].item() == pytest.approx(want.item(), rel=1e-6)
    # the plain versions on CPU tensors are not launches
    assert sum(kernels.launches.values()) == 0


def test_softmax_cross_entropy_shapes_and_bf16():
    x, lbl, _ = _xent_inputs(12, 30)
    x3 = x.reshape(3, 4, 30)
    ref = P.softmax_cross_entropy(pt.to_tensor(x3),
                                  pt.to_tensor(lbl.reshape(3, 4)), 0.1)
    got = SX.softmax_cross_entropy(_t(x3), _t(lbl.reshape(3, 4)), 0.1)
    assert got.shape == (3, 4, 1) == tuple(ref.shape)
    np.testing.assert_allclose(_np(got), np.asarray(ref.numpy()),
                               **XENT_TOL)
    # bf16 logits: the loss in f32, dx in bf16
    xb = _t(x).to(torch.bfloat16).requires_grad_()
    lo = SX.SoftmaxXentFunction.apply(xb, _t(lbl), 0.0)
    lo.sum().backward()
    assert lo.dtype == torch.float32 and xb.grad.dtype == torch.bfloat16


def _ce_inputs(shape=(2, 5, 11)):
    rng = np.random.RandomState(0)
    x = (rng.randn(*shape) * 3).astype("f4")
    lbl = rng.randint(0, shape[-1], shape[:-1]).astype("i4")
    flat = lbl.reshape(-1)
    flat[::3] = -1                  # ignored
    flat[1] = shape[-1] + 4         # out of range, not ignored
    flat[4] = -7                    # out of range below
    return x, lbl


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_cross_entropy_fused_branch_matches_jax(reduction, configure):
    """Both packages through their fused branch. An out-of-range label
    that is not ignored scores lse there, where the plain branch clamps it
    to a class (ROADMAP.md Queue C): the per-row losses show it."""
    configure(softmax_xent=True)
    x, lbl = _ce_inputs()
    jx = pt.to_tensor(x, stop_gradient=False)
    ref = jloss.cross_entropy(jx, pt.to_tensor(lbl), ignore_index=-1,
                              reduction=reduction)
    ref.sum().backward()
    tx = _t(x).requires_grad_()
    got = loss.cross_entropy(tx, _t(lbl), ignore_index=-1,
                             reduction=reduction)
    assert got.shape == tuple(ref.shape)
    np.testing.assert_allclose(_np(got), _np(ref.numpy()), **XENT_TOL)
    got.sum().backward()
    np.testing.assert_allclose(_np(tx.grad), np.asarray(jx.grad),
                               **XENT_TOL)
    if reduction == "none":
        fused_rows = got.detach().reshape(-1)
        kernels.configure(softmax_xent=False)
        plain_rows = loss.cross_entropy(_t(x), _t(lbl), ignore_index=-1,
                                        reduction="none").reshape(-1)
        lse = torch.logsumexp(_t(x).reshape(-1, 11), dim=1)
        assert fused_rows[1].item() == pytest.approx(lse[1].item())
        assert fused_rows[4].item() == pytest.approx(lse[4].item())
        assert plain_rows[1].item() != pytest.approx(lse[1].item())
        keep = [i for i in range(10) if i not in (1, 4)]
        np.testing.assert_allclose(_np(fused_rows[keep]),
                                   _np(plain_rows[keep]), **XENT_TOL)


def test_softmax_with_cross_entropy_fused_branch_matches_jax(configure):
    configure(softmax_xent=True)
    x, lbl = _ce_inputs()
    ref = jloss.softmax_with_cross_entropy(
        pt.to_tensor(x), pt.to_tensor(lbl[..., None]), ignore_index=-1)
    got = loss.softmax_with_cross_entropy(_t(x), _t(lbl[..., None]),
                                          ignore_index=-1)
    assert got.shape == tuple(ref.shape)
    np.testing.assert_allclose(_np(got), _np(ref.numpy()), **XENT_TOL)
    # the softmax is not the kernel's: that call takes the plain branch
    got2, sm = loss.softmax_with_cross_entropy(
        _t(x), _t(lbl[..., None]), ignore_index=-1, return_softmax=True)
    assert sm.shape == x.shape


# -- the Adam functions ------------------------------------------------------

def _adam_state(shape, seed, p_dtype="f4"):
    rng = np.random.RandomState(seed)
    p = rng.randn(*shape).astype("f4")
    g = rng.randn(*shape).astype("f4")
    m = (rng.randn(*shape) * 0.1).astype("f4")
    v = (rng.rand(*shape) * 0.01).astype("f4")
    if p_dtype == "bf16":
        p = np.asarray(jnp.asarray(p, jnp.bfloat16).astype(jnp.float32))
    return p, g, m, v


LR, B1P, B2P = 1e-3, 0.9 ** 3, 0.999 ** 3


@pytest.mark.parametrize("shape,p_dtype", [
    ((1024 * 128 * 2 + 77,), "f4"),   # > 1024 Pallas rows, ragged tail
    ((33, 7), "bf16")])
def test_fused_adam_update_matches_pallas(shape, p_dtype):
    p, g, m, v = _adam_state(shape, 1, p_dtype)
    jdt = jnp.bfloat16 if p_dtype == "bf16" else jnp.float32
    ref = jfa.fused_adam_update(jnp.asarray(p, jdt), jnp.asarray(g),
                                jnp.asarray(m), jnp.asarray(v), LR, B1P, B2P)
    tdt = torch.bfloat16 if p_dtype == "bf16" else torch.float32
    tp, tm, tv = _t(p).to(tdt), _t(m), _t(v)
    out = FA.fused_adam_update(tp, _t(g), tm, tv, LR, B1P, B2P)
    assert out[0] is tp and out[1] is tm and out[2] is tv   # in place
    assert tp.dtype == tdt
    np.testing.assert_allclose(_np(tp), _np(ref[0].astype(jnp.float32)),
                               **(BF16_TOL if p_dtype == "bf16" else
                                  ADAM_TOL))
    np.testing.assert_allclose(_np(tm), np.asarray(ref[1]), **ADAM_TOL)
    np.testing.assert_allclose(_np(tv), np.asarray(ref[2]), **ADAM_TOL)


def test_fused_adam_update_multi_matches_pallas():
    shapes = [(300, 1000), (77,), (3, 5), (1,)]
    states = [_adam_state(s, i) for i, s in enumerate(shapes)]
    ps, gs, ms, vs = (list(x) for x in zip(*states))
    ref = jfa.fused_adam_update_multi(
        [jnp.asarray(a) for a in ps], [jnp.asarray(a) for a in gs],
        [jnp.asarray(a) for a in ms], [jnp.asarray(a) for a in vs],
        LR, B1P, B2P, weight_decay=0.01)
    tps, tms, tvs = ([_t(a) for a in xs] for xs in (ps, ms, vs))
    FA.fused_adam_update_multi(tps, [_t(a) for a in gs], tms, tvs, LR, B1P,
                               B2P, weight_decay=0.01)
    for got, want in zip(tps + tms + tvs, ref[0] + ref[1] + ref[2]):
        np.testing.assert_allclose(_np(got), np.asarray(want), **ADAM_TOL)


@pytest.mark.parametrize("use_fused", [False, True])
def test_adam_step_matches_jax(use_fused):
    p, g, m, v = _adam_state((40, 9), 2)
    ref = jfa.adam_step(jnp.asarray(p), jnp.asarray(g), jnp.asarray(m),
                        jnp.asarray(v), LR, B1P, B2P, use_fused=use_fused)
    got = FA.adam_step(_t(p), _t(g), _t(m), _t(v), torch.tensor(LR),
                       torch.tensor(B1P), torch.tensor(B2P),
                       use_fused=use_fused)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(_np(a), np.asarray(b), **ADAM_TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_adam_step_flat_matches_jax(masked):
    """Without a mask the fused path (the flat kernel's plain version
    here, the Pallas kernel there); with one, both packages' plain
    path."""
    n = 1024 * 129
    p, g, m, v = _adam_state((n,), 3)
    mask = None
    if masked:
        mask = np.ones(n, bool)
        mask[1000:5000] = False
    ref = jfa.adam_step_flat(
        jnp.asarray(p), jnp.asarray(g), jnp.asarray(m), jnp.asarray(v), LR,
        B1P, B2P, weight_decay=0.01, use_fused=True,
        mask=None if mask is None else jnp.asarray(mask))
    got = FA.adam_step_flat(
        _t(p), _t(g), _t(m), _t(v), torch.tensor(LR), torch.tensor(B1P),
        torch.tensor(B2P), weight_decay=0.01, use_fused=True,
        mask=None if mask is None else _t(mask))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(_np(a), np.asarray(b), **ADAM_TOL)
    if masked:
        assert np.array_equal(_np(got[0])[1000:5000], p[1000:5000])


def test_adam_wrappers_reject_bad_inputs():
    p, g, m, v = (torch.zeros(2048) for _ in range(4))
    with pytest.raises(ValueError, match="multiple of 1024"):
        FA.fused_adam_update_flat(p[:1000], g[:1000], m[:1000], v[:1000],
                                  LR, B1P, B2P)
    with pytest.raises(TypeError, match="float32"):
        FA.fused_adam_update_flat(p, g, m.bfloat16(), v, LR, B1P, B2P)
    with pytest.raises(TypeError):
        FA.fused_adam_update(p.half(), g, m, v, LR, B1P, B2P)
    with pytest.raises(ValueError, match="shapes"):
        FA.fused_adam_update(p, g[:10], m, v, LR, B1P, B2P)
    with pytest.raises(ValueError):
        FA.fused_adam_update_multi([p], [g, g], [m], [v], LR, B1P, B2P)
    x = torch.zeros(4, 6)
    with pytest.raises(ValueError):
        SX.softmax_xent_fwd(x[None], torch.zeros(4, 1, dtype=torch.int32))
    with pytest.raises(ValueError):
        SX.softmax_xent_fwd(x, torch.zeros(4, dtype=torch.int32))
    with pytest.raises(TypeError):
        SX.softmax_xent_fwd(x.half(), torch.zeros(4, 1, dtype=torch.int32))


# -- the optimizer routes ----------------------------------------------------

def _toy_pair(seed):
    """A JAX Linear and a port Linear with the same weights."""
    pt.seed(seed)
    jl = jnn.Linear(5, 3)
    tl = nn.Linear(5, 3)
    load_jax_state(tl, {k: np.asarray(v.numpy())
                        for k, v in jl.state_dict().items()})
    return jl, tl


def _set_grads(jl, tl, rng, skip=()):
    for (name, jp), (_, tp) in zip(jl.named_parameters(),
                                   tl.named_parameters()):
        g = rng.randn(*jp.shape).astype("f4")
        live = name not in skip
        jp._grad = jnp.asarray(g) if live else None
        tp.grad = torch.from_numpy(g) if live else None


def _check_same(jl, tl, jo, to):
    for (name, jp), (_, tp) in zip(jl.named_parameters(),
                                   tl.named_parameters()):
        np.testing.assert_allclose(_np(tp), np.asarray(jp.numpy()),
                                   err_msg=name, **ADAM_TOL)
        jslots, tslots = jo._accumulators[id(jp)], to._accumulators[id(tp)]
        assert set(jslots) == set(tslots)
        for s in jslots:
            np.testing.assert_allclose(_np(tslots[s]),
                                       np.asarray(jslots[s].data),
                                       err_msg=f"{name}@{s}", **ADAM_TOL)


ROUTES = {
    # name: (optimizer options, kernels turned on)
    "use_fused": (dict(use_fused=True), {}),
    "use_multi_tensor": (dict(use_multi_tensor=True), {}),
    "configure_fused_adam": ({}, dict(fused_adam=True)),
    "configure_fused_adam_multi": ({}, dict(fused_adam_multi=True)),
}


@pytest.mark.parametrize("kind", ["Adam", "AdamW"])
@pytest.mark.parametrize("route", list(ROUTES))
def test_optimizer_routes_match_jax(route, kind, configure):
    opt_kw, on = ROUTES[route]
    configure(**on)
    jl, tl = _toy_pair(3)
    kw = dict(learning_rate=0.05, epsilon=1e-6, **opt_kw)
    if kind == "AdamW":
        kw["weight_decay"] = 0.1
    jo = getattr(jopt, kind)(parameters=jl.parameters(), **kw)
    to = getattr(optimizer, kind)(parameters=list(tl.parameters()), **kw)
    rng = np.random.RandomState(1)
    kernels.reset_launches()
    for _ in range(3):
        _set_grads(jl, tl, rng)
        jo.step()
        to.step()
        jo.clear_grad()
        to.clear_grad()
    _check_same(jl, tl, jo, to)
    assert sum(kernels.launches.values()) == 0     # CPU: plain versions


def test_multi_tensor_falls_back_on_unequal_pows_like_jax(monkeypatch):
    """A parameter without a gradient in one step falls out of lockstep:
    both packages warn once and take the per-parameter loop."""
    monkeypatch.setattr(jopt.Adam, "_warned_unequal_beta_pow", False)
    monkeypatch.setattr(optimizer.Adam, "_warned_unequal_beta_pow", False)
    jl, tl = _toy_pair(5)
    kw = dict(learning_rate=0.05, use_multi_tensor=True)
    jo = jopt.AdamW(parameters=jl.parameters(), **kw)
    to = optimizer.AdamW(parameters=list(tl.parameters()), **kw)
    rng = np.random.RandomState(2)
    _set_grads(jl, tl, rng, skip=("bias",))
    jo.step()
    to.step()
    _set_grads(jl, tl, rng)
    for who in (jo, to):
        with pytest.warns(RuntimeWarning, match="multi-tensor Adam"):
            who.step()
    _check_same(jl, tl, jo, to)
    assert to._steps[id(tl.weight)] == 2 and to._steps[id(tl.bias)] == 1
    with warnings.catch_warnings():
        warnings.simplefilter("error")      # warned once already
        _set_grads(jl, tl, rng)
        to.step()


# -- the flat arena ------------------------------------------------------------

def _arena_model(seed=0):
    import paddle_tpu_torch as ptt
    ptt.seed(seed)
    return nn.Sequential(nn.Linear(5, 4), nn.Linear(4, 3), nn.Linear(3, 2))


def _train(model, opt, steps=3):
    for i in range(steps):
        x = torch.linspace(-1, 1, 10).reshape(2, 5) * (i + 1)
        h = model[1](model[0](x))           # model[2] gets no gradient
        (h * h).sum().backward()
        opt.step()
        opt.clear_grad()


@pytest.mark.parametrize("on", [{}, dict(fused_adam_multi=True)])
def test_arena_equals_per_parameter_adamw_bit_for_bit(on, configure):
    configure(**on)
    ref_model, model = _arena_model(), _arena_model()
    ref = optimizer.AdamW(learning_rate=0.01,
                          parameters=list(ref_model.parameters()))
    opt = optimizer.AdamW(learning_rate=0.01, flat_arena=True,
                          parameters=list(model.parameters()))
    _train(ref_model, ref)
    _train(model, opt)
    for a, b in zip(model.parameters(), ref_model.parameters()):
        assert torch.equal(a, b)
    # the members are views of one padded f32 buffer, in parameter order
    (grp,) = opt._arena.groups
    assert grp.total % port_arena.ALIGN == 0
    offs = [off for _, off, _, _ in grp.entries]
    assert offs == sorted(offs)
    for p, off, n, _ in grp.entries:
        assert p.data_ptr() == grp.flat.data_ptr() + 4 * off
    # the member without a gradient kept its weights and zero moments
    _, off, n, _ = grp.entries[-1]
    assert not grp.slots["moment1"][off:off + n].any()
    # its mask is built once per pattern of live members
    assert len(grp.masks) == 1


def test_arena_without_a_masked_member_is_the_flat_kernel_route(configure):
    """Every member with a gradient: under fused_adam_multi the arena
    takes adam_step_flat's kernel route (its plain version on the CPU),
    still the per-parameter result bit for bit."""
    configure(fused_adam_multi=True)
    ref_model, model = _arena_model(1), _arena_model(1)
    ref = optimizer.AdamW(learning_rate=0.01,
                          parameters=list(ref_model.parameters())[:4])
    opt = optimizer.AdamW(learning_rate=0.01, flat_arena=True,
                          parameters=list(model.parameters())[:4])
    _train(ref_model, ref)
    _train(model, opt)
    assert not opt._arena.groups[0].masks
    for a, b in zip(model.parameters(), ref_model.parameters()):
        assert torch.equal(a, b)


def test_arena_parts_not_ported_raise():
    model = _arena_model()
    opt = optimizer.AdamW(parameters=list(model.parameters()),
                          flat_arena=True)
    _train(model, opt, steps=1)
    arena = opt._arena
    for call in (lambda: arena.bucket_bounds(),
                 lambda: arena.per_leaf_state([]),
                 lambda: arena.load_leaf_state(None, {}),
                 arena.dissolve,
                 lambda: port_arena.static_apply(opt, [], {}, {}, None),
                 lambda: opt.set_flat_arena(False)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            call()
    # a member whose data no longer lives in the arena
    model[0].weight.data = model[0].weight.data.clone()
    with pytest.raises(NotImplementedError, match="rebuilding"):
        _train(model, opt, steps=1)
    with pytest.raises(ValueError, match="Adam or AdamW"):
        optimizer.Optimizer(parameters=[], flat_arena=True)


# -- the bench's options -----------------------------------------------------

def test_bench_bert_takes_the_fused_route_on_the_cpu(configure):
    configure(softmax_xent=True, fused_adam_multi=True)
    small = dict(num_hidden_layers=1, hidden_size=64, num_attention_heads=2,
                 intermediate_size=128)
    kernels.reset_launches()
    for opt_kw in (dict(flat_arena=True), dict(use_fused=True)):
        tok_s, last = bench_bert.bench_bert(batch=2, seq=16, steps=1,
                                            inner=1, device="cpu",
                                            opt_kw=opt_kw, **small)
        assert tok_s > 0 and np.isfinite(last)
    assert sum(kernels.launches.values()) == 0
    tr = bench_bert.Trainer(2, 16, 1, "cpu", dict(flat_arena=True), **small)
    assert tr.opt._flat_arena
