"""The port's gradient clipping (``paddle_tpu_torch.clip`` and the
optimizer's clip step) against the JAX package's, on the CPU.

The same gradients (numpy, from a seed) go through each clip of both
packages: float32 results within 1e-6 relative (the norms are sums in
another order: the port's ``torch._foreach_norm`` in float32, the
reference's ``jnp.sum`` of squares), bfloat16 gradients within one bf16
step (the port sums their squares in float32, the reference in bf16).
Then optimizers with a clip step an MLP in both packages on each of the
port's routes (the per-parameter rule, ``use_fused``, the multi-tensor
update, the flat arena, which clips its packed flat gradients): the
parameters within 1e-6 after three steps. (Momentum under a
``PiecewiseDecay`` with ``ClipGradByNorm`` on a narrow ResNet is in
``test_torch_lr.py``.)

No clip reads the card from the host: each runs here with ``item``,
``__float__``, ``__bool__``, ``tolist`` and ``numpy`` made to raise.

Isolation: each test clears the reference's flat-arena hook and restores
it after; no test builds a JAX ``ParamArena`` (ROADMAP.md Queue C); the
global clip of both packages is reset after each test.
"""
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as pt
import paddle_tpu.tensor as ref_tensor
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.optimizer import lr as jlr

import paddle_tpu_torch as ptt
from paddle_tpu_torch import clip, nn, optimizer
from paddle_tpu_torch.convert import export_state, load_jax_state
from paddle_tpu_torch.optimizer import lr

# the reference's root rebinds `clip` to the clip op; the module is here
jclip = importlib.import_module("paddle_tpu.clip")


@pytest.fixture(autouse=True)
def _isolated():
    hook = ref_tensor._arena_hook
    ref_tensor._arena_hook = None
    yield
    ref_tensor._arena_hook = hook
    jclip.set_gradient_clip(None)
    clip.set_gradient_clip(None)


SHAPES = [(33, 17), (17,), (5, 4, 3), (1,), (64,)]


def _grads(seed=0, scale=1.0, none_at=()):
    rng = np.random.RandomState(seed)
    return [None if i in none_at else
            (rng.randn(*s) * scale * (i + 1)).astype("f4")
            for i, s in enumerate(SHAPES)]


def _ref_clip(c, grads):
    out = c([(None, None if g is None else jnp.asarray(g)) for g in grads])
    return [None if g is None else np.asarray(g, np.float32)
            for _, g in out]


def _port_clip(c, grads, dtype=torch.float32):
    out = c([(None, None if g is None else torch.from_numpy(
        np.array(g)).to(dtype)) for g in grads])
    return [None if g is None else g.float().numpy() for _, g in out]


CLIPS = {
    "value": lambda m: m.ClipGradByValue(0.7),
    "value_min": lambda m: m.ClipGradByValue(1.5, min=-0.25),
    "norm_small": lambda m: m.ClipGradByNorm(0.5),
    "norm_large": lambda m: m.ClipGradByNorm(1e3),
    "global_small": lambda m: m.ClipGradByGlobalNorm(1.0),
    "global_large": lambda m: m.ClipGradByGlobalNorm(1e4),
    "fluid_value": lambda m: m.GradientClipByValue(0.3),
    "fluid_norm": lambda m: m.GradientClipByNorm(2.0),
    "fluid_global": lambda m: m.GradientClipByGlobalNorm(3.0),
}


@pytest.mark.parametrize("none_at", [(), (1, 3)], ids=["all", "some_none"])
@pytest.mark.parametrize("case", sorted(CLIPS))
def test_clip_equals_the_references_f32(case, none_at):
    grads = _grads(none_at=none_at)
    want = _ref_clip(CLIPS[case](jclip), grads)
    got = _port_clip(CLIPS[case](clip), grads)
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("case", ["value", "norm_small", "global_small"])
def test_clip_keeps_bf16_gradients_within_a_bf16_step(case):
    grads = [np.asarray(jnp.asarray(g).astype(jnp.bfloat16)
                        .astype(jnp.float32)) for g in _grads(1)]
    want = _ref_clip(CLIPS[case](jclip),
                     [jnp.asarray(g).astype(jnp.bfloat16) for g in grads])
    c = CLIPS[case](clip)
    out = c([(None, torch.from_numpy(np.array(g)).bfloat16())
             for g in grads])
    for (_, a), b in zip(out, want):
        assert a.dtype == torch.bfloat16
        np.testing.assert_allclose(a.float().numpy(), b, rtol=2 ** -7,
                                   atol=1e-6)


def test_an_unclipped_gradient_is_left_bit_equal():
    """Below the global norm the scale is clip_norm / clip_norm, exactly
    1 (one rounded division, not a reciprocal times)."""
    grads = _grads(2, scale=1e-3)
    for c in (clip.ClipGradByGlobalNorm(0.3), clip.ClipGradByNorm(0.3)):
        out = _port_clip(c, grads)
        for a, b in zip(out, grads):
            assert np.array_equal(a, b)


@pytest.fixture
def no_host_reads(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a clip read a tensor on the host")
    for name in ("item", "__float__", "__bool__", "__int__", "tolist",
                 "numpy"):
        monkeypatch.setattr(torch.Tensor, name, refuse)


@pytest.mark.parametrize("case", sorted(CLIPS))
def test_clip_never_reads_the_host(case, no_host_reads):
    grads = [torch.ones(s) * 3 for s in SHAPES]
    out = CLIPS[case](clip)([(None, g) for g in grads])
    assert len(out) == len(grads)
    flats = CLIPS[case](clip)._clip_flat([torch.cat(
        [g.reshape(-1) for g in grads])])
    assert len(flats) == 1


def test_flat_clip_equals_the_per_tensor_clip():
    """The arena's packed gradient (members in order, zero padding) takes
    the value and global-norm clips to the same values as the tensors
    one by one."""
    grads = [torch.from_numpy(g) for g in _grads(4)]
    flat = torch.cat([g.reshape(-1) for g in grads] + [torch.zeros(7)])
    for c in (clip.ClipGradByValue(0.5), clip.ClipGradByGlobalNorm(2.0)):
        assert c._flat
        (got,) = c._clip_flat([flat])
        want = torch.cat([g.reshape(-1) for _, g in
                          c([(None, g) for g in grads])])
        torch.testing.assert_close(got[:want.numel()], want, rtol=1e-6,
                                   atol=0.0)
        assert torch.equal(got[want.numel():], torch.zeros(7))
    assert not clip.ClipGradByNorm(1.0)._flat


def test_clip_grad_norm_equals_the_references():
    grads = _grads(5)
    jps = [pt.to_tensor(np.zeros_like(g)) for g in grads]
    for p, g in zip(jps, grads):
        p._grad = jnp.asarray(g)
    jclip.clip_grad_norm_(jps, 1.5)
    ps = [torch.nn.Parameter(torch.zeros(g.shape)) for g in grads]
    for p, g in zip(ps, grads):
        p.grad = torch.from_numpy(np.array(g))
    clip.clip_grad_norm_(ps, 1.5)
    for p, jp in zip(ps, jps):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jp._grad),
                                   rtol=1e-6)


def test_error_clip_as_a_hook_equals_the_references_call():
    g = _grads(6)[0]
    want = np.asarray(jclip.ErrorClipByValue(0.4)(jnp.asarray(g)))
    x = torch.zeros(g.shape, requires_grad=True)
    x.register_hook(clip.ErrorClipByValue(0.4))
    (x * torch.from_numpy(np.array(g))).sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), want)


def test_global_clip_and_exports():
    c = clip.ClipGradByGlobalNorm(1.0)
    assert clip.set_gradient_clip(c) is c and clip.get_gradient_clip() is c
    assert ptt.ClipGradByGlobalNorm is clip.ClipGradByGlobalNorm
    assert ptt.ClipGradByNorm is clip.ClipGradByNorm
    assert ptt.ClipGradByValue is clip.ClipGradByValue
    assert ptt.clip is clip
    public = {n for n in dir(jclip) if not n.startswith("_")
              and n not in ("annotations", "jnp")}
    assert public <= set(dir(clip)), public - set(dir(clip))


# -- the optimizer's clip step -------------------------------------------------

def _mlp_pair(seed=0):
    pt.seed(seed)
    ref = jnn.Sequential(jnn.Linear(6, 16), jnn.ReLU(), jnn.Linear(16, 3))
    port = load_jax_state(
        nn.Sequential(nn.Linear(6, 16), nn.ReLU(), nn.Linear(16, 3)),
        {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()})
    return ref, port


def _batches(n=3):
    rng = np.random.RandomState(7)
    return [(rng.randn(5, 6).astype("f4") * 4,
             rng.randn(5, 3).astype("f4")) for _ in range(n)]


def _train_ref(ref, o, batches, sched=None):
    for x, y in batches:
        d = ref(pt.to_tensor(x)) - pt.to_tensor(y)
        (d * d).mean().backward()
        o.step()
        o.clear_grad()
        if sched is not None:
            sched.step()
    return {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()}


def _train_port(port, o, batches, sched=None):
    for x, y in batches:
        d = port(torch.from_numpy(np.array(x))) - torch.from_numpy(
            np.array(y))
        (d * d).mean().backward()
        o.step()
        o.clear_grad()
        if sched is not None:
            sched.step()
    return export_state(port)


ROUTES = {"plain": dict(use_multi_tensor=False),
          "use_fused": dict(use_fused=True, use_multi_tensor=False),
          "multi": dict(use_multi_tensor=True),
          "arena": dict(flat_arena=True)}


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("case", ["value", "norm_small", "global_small"])
def test_adamw_with_grad_clip_equals_the_references(case, route):
    ref, port = _mlp_pair()
    jo = jopt.AdamW(learning_rate=0.01, parameters=ref.parameters(),
                    grad_clip=CLIPS[case](jclip))
    o = optimizer.AdamW(learning_rate=0.01, parameters=port.parameters(),
                        grad_clip=CLIPS[case](clip), **ROUTES[route])
    want = _train_ref(ref, jo, _batches())
    got = _train_port(port, o, _batches())
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("route", ["plain", "arena"])
def test_global_clip_applies_without_grad_clip(route):
    ref, port = _mlp_pair(1)
    jclip.set_gradient_clip(jclip.ClipGradByGlobalNorm(0.5))
    clip.set_gradient_clip(clip.ClipGradByGlobalNorm(0.5))
    jo = jopt.Adam(learning_rate=0.01, parameters=ref.parameters())
    o = optimizer.Adam(learning_rate=0.01, parameters=port.parameters(),
                       **ROUTES[route])
    want = _train_ref(ref, jo, _batches())
    got = _train_port(port, o, _batches())
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6)


def test_a_parameters_own_clip_goes_first_then_l2_decay():
    """The reference's order: a parameter's own clip (set_gradient_clip
    with param_list), then the optimizer's clip, then the L2 term."""
    ref, port = _mlp_pair(2)
    jps, ps = list(ref.parameters()), list(port.parameters())
    jclip.set_gradient_clip(jclip.ClipGradByValue(0.05), param_list=jps[:2])
    clip.set_gradient_clip(clip.ClipGradByValue(0.05), param_list=ps[:2])
    jo = jopt.Momentum(0.05, 0.9, parameters=jps, weight_decay=0.1,
                       grad_clip=jclip.ClipGradByGlobalNorm(0.8))
    o = optimizer.Momentum(0.05, 0.9, parameters=ps, weight_decay=0.1,
                           grad_clip=clip.ClipGradByGlobalNorm(0.8))
    want = _train_ref(ref, jo, _batches())
    got = _train_port(port, o, _batches())
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6)


def test_sgd_with_value_clip_and_a_schedule():
    ref, port = _mlp_pair(3)
    js = jlr.StepDecay(0.1, 1, gamma=0.5)
    s = lr.StepDecay(0.1, 1, gamma=0.5)
    jo = jopt.SGD(learning_rate=js, parameters=ref.parameters(),
                  grad_clip=jclip.ClipGradByValue(0.2))
    o = optimizer.SGD(learning_rate=s, parameters=port.parameters(),
                      grad_clip=clip.ClipGradByValue(0.2))
    want = _train_ref(ref, jo, _batches(), js)
    got = _train_port(port, o, _batches(), s)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-7)
