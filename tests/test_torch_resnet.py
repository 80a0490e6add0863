"""The port's ResNet training slice against the JAX package, on the CPU.

A small ResNet is built in the JAX package, its weights and running
statistics are carried into the port with ``convert.load_jax_state``, and
the same images and labels (numpy, from a seed) go through both: the
logits, the loss, every gradient by name, and every parameter and running
statistic after three ``Momentum`` steps. Two networks, ``ResNet(
BottleneckBlock, [1, 1, 1, 1])`` and ``resnet18``, 10 classes, batch 8 at
64x64 (so the last stage's batch norm still sees 32 rows), on two routes:

* the default route: NCHW, the plain batch norm in both packages;
* the kernel route: NHWC under ``configure(batch_norm=True)`` in both
  packages; the reference runs its Pallas kernels in interpret mode, the
  port the plain versions of its CUDA kernels (what its wrappers compute
  on a CPU tensor).

Tolerances, each with its reason:

* float32 logits and loss: 1e-4 absolute. Ten to twenty convolutions
  summed in another order by XLA and by PyTorch's CPU kernels; each batch
  norm divides by a standard deviation, which carries the noise forward
  at its own size;
* float32 gradients: 2e-3 of each gradient's largest element. The batch
  norms' backward subtracts two sums over the batch from g, so rounding
  noise does not shrink with the gradient's own size;
* parameters and running statistics after three steps at lr 0.02: 2e-4
  absolute and 2e-3 relative;
* under bf16 amp: loss within 5e-2 (measured 1.2e-2), each gradient
  within 0.35 relative L2 (measured at most 0.24, at the stem's batch
  norm: both frameworks round the same products to bf16, but XLA fuses
  other roundings away than PyTorch's CPU kernels, and 17 batch norms
  over a batch of 8 carry each rounding on at its own size), parameters
  within 5e-3.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import amp as jamp
from paddle_tpu import jit as jjit
from paddle_tpu import optimizer as jopt
from paddle_tpu.models import resnet as jresnet
from paddle_tpu.ops import loss as jloss
from paddle_tpu.ops import pallas as P

from paddle_tpu_torch import amp, optimizer
from paddle_tpu_torch.convert import export_state, load_jax_state
from paddle_tpu_torch.inference import Predictor
from paddle_tpu_torch.models import resnet
from paddle_tpu_torch.ops import kernels, loss
from paddle_tpu_torch.tools import bench_resnet

LR, STEPS = 0.002, 3
BATCH, SIZE, CLASSES = 8, 64, 10
NETS = {
    "bottleneck_1111": lambda mod, **kw: mod.ResNet(
        mod.BottleneckBlock, [1, 1, 1, 1], num_classes=CLASSES, **kw),
    "resnet18": lambda mod, **kw: mod.resnet18(num_classes=CLASSES, **kw),
}


@pytest.fixture(autouse=True)
def no_onednn_convolutions():
    """PyTorch's CPU convolutions through oneDNN (``mkldnn``) have crashed
    or miscomputed a row of the backward of a strided 1x1 convolution on a
    channels-last view, one run in four, once XLA's CPU runtime has run in
    the same process; alone neither does. These files run both, so the
    port's CPU convolutions take PyTorch's native kernels here."""
    with torch.backends.mkldnn.flags(enabled=False):
        yield


@pytest.fixture
def bn_switch():
    def on(value=True):
        P.configure(batch_norm=value)
        kernels.configure(batch_norm=value)
    yield on
    P.configure(batch_norm=None)
    kernels.configure(batch_norm=None)


def _t(a):
    """A tensor over its own copy of ``a``: the JAX package may hold the
    numpy array's memory without a copy, and the two runtimes sharing one
    buffer has crashed test workers."""
    return torch.from_numpy(np.array(a))


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t.numpy() if hasattr(t, "numpy") else t,
                      dtype=np.float32)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _batches(fmt, n=2):
    rng = np.random.RandomState(0)
    out = []
    for _ in range(n):
        x = rng.randn(BATCH, 3, SIZE, SIZE).astype("f4")
        if fmt == "NHWC":
            x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
        out.append((x, rng.randint(0, CLASSES, BATCH).astype("i4")))
    return out


def _pair(net, fmt):
    pt.seed(0)
    jm = NETS[net](jresnet, data_format=fmt)
    jm.train()
    m = NETS[net](resnet, data_format=fmt).train()
    load_jax_state(m, {k: np.asarray(v.numpy())
                       for k, v in jm.state_dict().items()})
    return jm, m


def _jax_steps(jm, batches, use_amp):
    """The reference's steps, compiled once with its ``jit.to_static``
    (eager JAX compiles every op of every shape on its own, ten times as
    long); the step hands back the logits and the gradients it saw."""
    o = jopt.Momentum(learning_rate=LR, momentum=0.9,
                      parameters=jm.parameters())
    names = [n for n, _ in jm.named_parameters()]

    def step(x, y):
        with jamp.auto_cast(enable=use_amp, dtype="bfloat16"):
            logits = jm(x)
        lo = jloss.cross_entropy(logits.astype("float32"), y)
        lo.backward()
        gs = [p.grad for p in jm.parameters()]
        o.step()
        o.clear_grad()
        return lo, logits, gs

    fn = jjit.to_static(step, models=[jm], optimizers=[o])
    logits0, losses, grads = None, [], None
    for i in range(STEPS):
        x, y = batches[i % len(batches)]
        lo, logits, gs = fn(pt.to_tensor(x), pt.to_tensor(y))
        if grads is None:
            logits0 = _np(logits)
            grads = {n: _np(g) for n, g in zip(names, gs)}
        losses.append(float(lo.numpy()))
    state = {k: np.asarray(v.numpy(), np.float32)
             for k, v in jm.state_dict().items()}
    return logits0, losses, grads, state


def _port_steps(m, batches, use_amp):
    o = optimizer.Momentum(learning_rate=LR, momentum=0.9,
                           parameters=m.parameters())
    logits0, losses, grads = None, [], None
    for i in range(STEPS):
        x, y = (_t(a) for a in batches[i % len(batches)])
        with amp.auto_cast(enable=use_amp, dtype="bfloat16"):
            logits = m(x)
        lo = loss.cross_entropy(logits.float(), y)
        lo.backward()
        if grads is None:
            logits0 = _np(logits)
            grads = {n: _np(p.grad) for n, p in m.named_parameters()}
        losses.append(lo.item())
        o.step()
        o.clear_grad()
    return logits0, losses, grads, export_state(m)


@pytest.mark.parametrize("route", ["default", "kernels"])
@pytest.mark.parametrize("net", sorted(NETS))
def test_resnet_training_steps_match_jax_f32(net, route, bn_switch):
    fmt = "NCHW" if route == "default" else "NHWC"
    if route == "kernels":
        bn_switch(True)
    jm, m = _pair(net, fmt)
    s0 = export_state(m)
    assert [n for n, _ in m.named_parameters()] == \
        [n for n, _ in jm.named_parameters()]
    assert set(s0) == set(jm.state_dict()) and any(
        k.endswith("._variance") for k in s0)
    batches = _batches(fmt)
    jlog, jl, jg, js = _jax_steps(jm, batches, False)
    if route == "kernels":
        # the port's batch norms went through BatchNormFunction
        seen = []
        hook = m.stem[1].register_forward_hook(
            lambda mod, a, out: seen.append(type(out.grad_fn).__name__))
    tlog, tl, tg, ts = _port_steps(m, batches, False)
    if route == "kernels":
        hook.remove()
        assert seen == ["ViewBackward0"] * STEPS
    np.testing.assert_allclose(tlog, jlog, atol=1e-4)
    np.testing.assert_allclose(tl, jl, atol=1e-4)
    assert set(tg) == set(jg)
    for name in jg:
        if name.startswith("fc."):
            assert np.abs(tg[name] - jg[name]).max() <= \
                1e-4 * np.abs(jg[name]).max(), name
        assert _rel_l2(tg[name], jg[name]) < 3e-2, name
    assert set(ts) == set(js)
    for name in js:
        np.testing.assert_allclose(ts[name], js[name], atol=2e-4, rtol=2e-3,
                                   err_msg=name)
        assert not np.array_equal(ts[name], s0[name]), name


def test_resnet_training_steps_match_jax_under_bf16_amp(bn_switch):
    """The kernel route under amp: convolutions in bf16, the batch norms'
    input bf16 and their parameters and statistics float32."""
    bn_switch(True)
    jm, m = _pair("bottleneck_1111", "NHWC")
    dtypes = []
    hook = m.stem[1].register_forward_hook(
        lambda mod, a, out: dtypes.append((a[0].dtype, out.dtype)))
    batches = _batches("NHWC")
    jlog, jl, jg, js = _jax_steps(jm, batches, True)
    tlog, tl, tg, ts = _port_steps(m, batches, True)
    hook.remove()
    assert dtypes == [(torch.bfloat16, torch.bfloat16)] * STEPS
    np.testing.assert_allclose(tl, jl, atol=5e-2)
    for name in jg:
        assert _rel_l2(tg[name], jg[name]) < 0.35, name
    for name in js:
        np.testing.assert_allclose(ts[name], js[name], atol=5e-3, rtol=5e-2,
                                   err_msg=name)


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_predictor_serves_eval_mode_logits(fmt, bn_switch):
    """Eval mode normalises with the running statistics and never takes
    the kernels, whatever the switch says."""
    bn_switch(True)
    jm, m = _pair("bottleneck_1111", fmt)
    rng = np.random.RandomState(3)
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    for k in state:        # statistics a trained network would carry
        if k.endswith("._mean"):
            state[k] = rng.randn(*state[k].shape).astype("f4") * 0.1
        elif k.endswith("._variance"):
            state[k] = (rng.rand(*state[k].shape) + 0.5).astype("f4")
    jm.set_state_dict(state)
    load_jax_state(m, state)
    jm.eval()
    x = _batches(fmt, 1)[0][0]
    ref = _np(jm(pt.to_tensor(x)))
    pred = Predictor(m.eval(), device="cpu")
    kernels.reset_launches()
    got = pred.run(x)
    assert got.shape == (BATCH, CLASSES)
    np.testing.assert_allclose(got, ref, atol=1e-4)
    np.testing.assert_array_equal(export_state(m)["stem.1._mean"],
                                  state["stem.1._mean"])


def test_load_jax_state_checks_buffers_and_conv_weights_before_copying():
    jm, m = _pair("resnet18", "NHWC")
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    assert state["stem.0.weight"].shape == (64, 3, 7, 7)      # OIHW
    before = export_state(m)
    missing = {k: v for k, v in state.items() if k != "stem.1._mean"}
    with pytest.raises(KeyError, match="stem.1._mean"):
        load_jax_state(m, missing)
    bad = dict(state)
    bad["stem.0.weight"] = state["stem.0.weight"].transpose(2, 3, 1, 0)
    bad["stem.1._variance"] = state["stem.1._variance"] + 5.0
    with pytest.raises(ValueError, match="stem.0.weight"):
        load_jax_state(m, bad)
    after = export_state(m)
    for k in before:       # nothing was copied
        np.testing.assert_array_equal(after[k], before[k])


def test_resnet50_has_53_batch_norms_and_the_reference_names():
    m = resnet.resnet50(data_format="NHWC")
    from paddle_tpu_torch import nn
    bns = [mod for mod in m.modules() if isinstance(mod, nn.BatchNorm)]
    assert len(bns) == 53
    assert all(b._data_format == "NHWC" for b in bns)
    assert sum(p.numel() for p in m.parameters()) == 25_557_032
    pt.seed(0)
    jm = jresnet.resnet50(data_format="NHWC")
    assert list(m.state_dict()) and set(m.state_dict()) == \
        set(jm.state_dict())


@pytest.mark.parametrize("fmt,on", [("NCHW", None), ("NHWC", None),
                                    ("NHWC", True)])
def test_bench_resnet_runs_on_the_cpu_when_asked(fmt, on, bn_switch,
                                                 monkeypatch):
    bn_switch(on)
    small = dict(model_fn=lambda **kw: resnet.ResNet(
        resnet.BottleneckBlock, [1, 1, 1, 1], num_classes=10, **kw))
    kernels.reset_launches()
    img_s, last = bench_resnet.bench_resnet(
        batch=4, steps=2, inner=1, data_format=fmt, device="cpu", size=32,
        **small)
    assert img_s > 0 and np.isfinite(last)
    assert sum(kernels.launches.values()) == 0
    x, y = bench_resnet.make_data(4, 3, fmt, size=32)
    assert x.dtype == np.uint8 and y.shape == (3, 4) and y.dtype == np.int32
    assert x.shape == ((3, 4, 3, 32, 32) if fmt == "NCHW"
                       else (3, 4, 32, 32, 3))
    z = bench_resnet.normalize_u8(_t(x[0]))
    assert z.dtype == torch.float32
    np.testing.assert_allclose(z.numpy(), (x[0].astype("f4") / 255.0 - 0.45)
                               / 0.22, atol=1e-6)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_resnet.bench_resnet(batch=4, steps=1, inner=1,
                                  data_format=fmt, size=32, **small)
