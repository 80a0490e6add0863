"""The port's quantization (``paddle_tpu_torch.quantization``) against the
JAX package's, on the CPU: the cases of ``tests/test_quantization.py``,
each run through both packages in one process on the same seeded numpy
inputs, with the weights carried across by ``convert.load_jax_state``.

On the CPU the int8 kernels' wrappers compute their plain versions
(``ops/kernels/int8_gemm.py``), whose int32 sums are exact; the card's
kernels are held to those in ``tests/test_torch_cuda.py``.

Tolerances, each with its reason:

* ``qweight``, ``wscale``, the quantized activations and the int32
  accumulators: equal (the same float32 operations, IEEE division and
  round half to even on both sides);
* fake-quant values, the straight-through gradient and float outputs of
  a single layer: 1e-6 relative (the same float32 operations; a product
  summed in another order);
* QAT losses over five SGD steps: 1e-5 relative (float32 products summed
  in another order, compounded over the steps);
* the 2-layer BERT-base-width int8 Predictor holding the reference's
  calibrated state against the reference's: 1e-5 (float32 products summed
  in another order); each calibrated by its own package: mean |diff|
  within 1e-2 of mean |ref| (the act_scales land an ulp or two apart, and
  the quantizer then flips levels near their rounding boundaries).

Isolation: every test clears the reference's flat-arena hook and turns
both monitors off (ROADMAP.md ground rules).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.tensor as ref_tensor
from paddle_tpu import jit as jjit
from paddle_tpu import monitor as ref_monitor
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu import quantization as JQ
from paddle_tpu.inference import Config as JConfig
from paddle_tpu.inference import Predictor as JPredictor
from paddle_tpu.models.bert import Bert as JBert
from paddle_tpu.models.bert import BertConfig as JBertConfig
from paddle_tpu.ops.nn_ops import (_conv_dimension_numbers, _norm_padding,
                                   _pair)

from paddle_tpu_torch import jit, monitor, nn, optimizer
from paddle_tpu_torch import quantization as Q
from paddle_tpu_torch.convert import load_jax_state
from paddle_tpu_torch.inference import Config, Predictor
from paddle_tpu_torch.models import Bert, BertConfig
from paddle_tpu_torch.ops import kernels

REL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(autouse=True)
def _no_arena_hook():
    hook = ref_tensor._arena_hook
    ref_tensor._arena_hook = None
    for mon in (ref_monitor, monitor):
        mon.disable(flush_counters=False)
    yield
    for mon in (ref_monitor, monitor):
        mon.disable(flush_counters=False)
    ref_tensor._arena_hook = hook


def _arrays(layer):
    return {k: np.asarray(v.numpy()) for k, v in layer.state_dict().items()}


def _t(a):
    return torch.from_numpy(np.array(a))


def _pair_of(build, seed):
    """``build(nn_module)`` in both packages, the port's holding the
    reference's weights."""
    pt.seed(seed)
    ref = build(jnn)
    return ref, load_jax_state(build(nn), _arrays(ref))


def _mlp(mod, sizes=(8, 16, 1)):
    return mod.Sequential(mod.Linear(sizes[0], sizes[1]), mod.ReLU(),
                          mod.Linear(sizes[1], sizes[2]))


def _frozen_pairs(ref, port):
    """The frozen layers of two converted models, in order."""
    rs = [m for m in ref.sublayers() if isinstance(
        m, (JQ.QuantizedLinear, JQ.QuantizedConv2D))]
    ps = [m for m in port.modules() if isinstance(
        m, (Q.QuantizedLinear, Q.QuantizedConv2D))]
    assert len(rs) == len(ps) > 0
    return list(zip(rs, ps))


def _assert_frozen_equal(ref, port):
    for r, p in _frozen_pairs(ref, port):
        np.testing.assert_array_equal(p.qweight.numpy(), r.qweight.numpy())
        np.testing.assert_array_equal(p.wscale.numpy(), r.wscale.numpy())
        np.testing.assert_allclose(p.act_scale.numpy(), r.act_scale.numpy(),
                                   **REL)
        assert p._int8_compute == r._int8_compute


# -- fake quant and the straight-through estimator -----------------------------

@pytest.mark.parametrize("scale,bits", [(1.0, 8), (0.5, 8), (1.0, 4)])
def test_fake_quant_levels_and_ste(scale, bits):
    a = np.linspace(-0.95, 0.95, 64).astype("f4")
    jx = pt.to_tensor(a)
    jx.stop_gradient = False
    jout = JQ.fake_quant(jx, scale, bits=bits)
    jout.sum().backward()
    x = _t(a).requires_grad_(True)
    out = Q.fake_quant(x, scale, bits=bits)
    out.sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), jout.numpy(), **REL)
    # at scale 0.5 the clip binds, and jnp.clip's gradient at its bound is
    # split (lax.max/min at a tie): the port's must be the same
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jx.grad), **REL)
    qmax = 2 ** (bits - 1) - 1
    levels = np.unique(np.round(out.detach().numpy() / scale * qmax))
    assert levels.min() >= -qmax and levels.max() <= qmax
    if scale == 1.0 and bits == 8:
        assert np.abs(out.detach().numpy() - a).max() <= (1 / 127) / 2 + 1e-6
        np.testing.assert_allclose(x.grad.numpy(), 1.0, atol=1e-6)
    if bits == 4:
        assert len(np.unique(out.detach().numpy())) <= 15


# -- quantization-aware training -----------------------------------------------

def _qat_steps(ref, port, compiled, steps=5, lr=0.05):
    rng = np.random.RandomState(4)
    x = rng.rand(32, 8).astype("f4")
    y = (rng.rand(32, 1) * 2).astype("f4")
    jo = jopt.SGD(learning_rate=lr, parameters=ref.parameters())
    o = optimizer.SGD(learning_rate=lr, parameters=port.parameters())

    def jstep(xb, yb):
        loss = ((ref(xb) - yb) ** 2).mean()
        loss.backward()
        jo.step()
        jo.clear_grad()
        return loss

    def step(xb, yb):
        loss = ((port(xb) - yb) ** 2).mean()
        loss.backward()
        o.step()
        o.clear_grad()
        return loss

    if compiled:
        jstep = jjit.to_static(jstep, models=[ref], optimizers=[jo])
        step = jit.to_static(step, models=[port], optimizers=[o])
    want = [float(jstep(pt.to_tensor(x), pt.to_tensor(y)).numpy())
            for _ in range(steps)]
    got = [float(step(_t(x), _t(y))) for _ in range(steps)]
    return want, got


@pytest.mark.parametrize("compiled", [False, True],
                         ids=["eager", "to_static"])
def test_quant_aware_trains_like_the_reference(compiled):
    """Five SGD steps of a quant_aware MLP, eager and under
    ``jit.to_static`` (the reference's ``test_quant_aware_trains_under_
    jit``: the observer advances as state, written in place)."""
    ref, port = _pair_of(_mlp, seed=4)
    ref, port = JQ.quant_aware(ref), Q.quant_aware(port)
    kinds = [type(m).__name__ for m in port.modules()]
    assert kinds.count("QuantedLinear") == 2
    ref.train(), port.train()
    scale_buf = port[0].act_scale
    want, got = _qat_steps(ref, port, compiled)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert port[0].act_scale is scale_buf        # advanced in place
    for r, p in zip([m for m in ref.sublayers()
                     if isinstance(m, JQ.QuantedLinear)],
                    [m for m in port.modules()
                     if isinstance(m, Q.QuantedLinear)]):
        assert float(p.act_scale) > 0
        np.testing.assert_allclose(p.act_scale.numpy(), r.act_scale.numpy(),
                                   rtol=1e-5)


def test_quant_aware_wraps_and_trains():
    """The reference's own case on the port alone: 30 Adam steps halve the
    loss and the observers hold a scale."""
    torch.manual_seed(0)
    model = Q.quant_aware(_mlp(nn))
    o = optimizer.Adam(learning_rate=0.01, parameters=model.parameters())
    rng = np.random.RandomState(0)
    x = _t(rng.rand(32, 8).astype("f4"))
    y = _t((rng.rand(32, 1) * 2).astype("f4"))
    losses = []
    for _ in range(30):
        loss = ((model(x) - y) ** 2).mean()
        loss.backward()
        o.step()
        o.clear_grad()
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.5
    assert all(float(m.act_scale) > 0 for m in model.modules()
               if isinstance(m, Q.QuantedLinear))


# -- freezing ------------------------------------------------------------------

def test_convert_int8_storage_and_accuracy():
    ref, port = _pair_of(lambda m: _mlp(m, (16, 32, 4)), seed=1)
    x = np.random.RandomState(1).rand(8, 16).astype("f4")
    ref.eval(), port.eval()
    f32 = ref(pt.to_tensor(x)).numpy()
    ref, port = JQ.convert(ref), Q.convert(port)
    kinds = [type(m).__name__ for m in port.modules()]
    assert kinds.count("QuantizedLinear") == 2
    _assert_frozen_equal(ref, port)
    assert port[0].qweight.dtype == torch.int8
    assert not port[0]._int8_compute           # uncalibrated: dequant path
    got = port(_t(x)).detach().numpy()
    np.testing.assert_allclose(got, ref(pt.to_tensor(x)).numpy(), **REL)
    denom = np.maximum(np.abs(f32), 1e-2)
    assert np.median(np.abs(got - f32) / denom) < 0.05


def test_quant_post_static_calibrates():
    ref, port = _pair_of(lambda m: _mlp(m, (8, 8, 2)), seed=2)
    rng = np.random.RandomState(2)
    batches = [rng.rand(16, 8).astype("f4") for _ in range(4)]
    f32 = port(_t(batches[0])).detach().numpy()
    ref = JQ.quant_post_static(ref, [pt.to_tensor(b) for b in batches])
    port = Q.quant_post_static(port, batches)       # numpy batches taken
    _assert_frozen_equal(ref, port)
    assert port[0]._int8_compute
    got = port(_t(batches[0])).detach().numpy()
    np.testing.assert_allclose(got, ref(pt.to_tensor(batches[0])).numpy(),
                               **REL)
    assert np.abs(got - f32).max() < 0.2


def test_freeze_weight_is_the_references():
    """``_freeze_weight`` bit for bit on both layouts, weights drawn wide
    enough that many channels meet rounding ties' neighbourhoods."""
    rng = np.random.RandomState(7)
    for shape, axis in (((64, 48), 1), ((16, 8, 3, 3), 0)):
        w = (rng.randn(*shape) * rng.rand(*shape) * 3).astype("f4")
        jq, js = JQ._freeze_weight(jnp.asarray(w), axis, 8)
        q, s = Q._freeze_weight(_t(w), axis, 8)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def _ref_linear_acc(ql, x):
    step = jnp.maximum(ql.act_scale.data, 1e-8) / 127.0
    xq = jnp.clip(jnp.round(jnp.asarray(x) / step), -127.0, 127.0).astype(
        jnp.int8)
    acc = jax.lax.dot_general(xq, ql.qweight.data, (((1,), (0,)), ((), ())),
                              preferred_element_type=jnp.int32)
    return np.asarray(xq), np.asarray(acc)


def _unit_epilogue(n):
    """An epilogue under which the GEMM writes its int32 sums as floats:
    scales of 1 (act_scale 127 makes the step 1), no bias."""
    return torch.ones(n), torch.tensor(127.0), None


def test_quantized_linear_int8_compute_parity():
    ref, port = _pair_of(lambda m: m.Sequential(m.Linear(16, 8)), seed=0)
    x = np.random.RandomState(0).randn(4, 16).astype("f4")
    f32 = port(_t(x)).detach().numpy()
    ref = JQ.quant_post_static(ref, [pt.to_tensor(x)])
    port = Q.quant_post_static(port, [_t(x)])
    _assert_frozen_equal(ref, port)
    ql = port[0]
    assert isinstance(ql, Q.QuantizedLinear) and ql._int8_compute
    jxq, jacc = _ref_linear_acc(ref[0], x)
    xq = kernels.int8_gemm.int8_quantize(_t(x), ql.act_scale)
    np.testing.assert_array_equal(xq.numpy(), jxq)
    acc = ql._int8_forward(_t(x), epilogue=_unit_epilogue(8))
    np.testing.assert_array_equal(acc.numpy(), jacc.astype("f4"))
    got = port(_t(x)).detach().numpy()
    np.testing.assert_allclose(got, ref(pt.to_tensor(x)).numpy(), **REL)
    tol = 3.0 * float(np.abs(f32).max()) / 127.0
    np.testing.assert_allclose(got, f32, atol=tol)
    assert got.dtype == np.float32
    # uncalibrated convert stays on the dequant float path
    assert not Q.convert(nn.Sequential(nn.Linear(16, 8)))[0]._int8_compute


CONVS = {
    "nchw_pad1": dict(cin=3, cout=6, k=3, padding=1),
    "nhwc_pad1": dict(cin=3, cout=6, k=3, padding=1, data_format="NHWC"),
    "stride2_groups2": dict(cin=4, cout=6, k=3, padding=1, stride=2,
                            groups=2),
    "dilation2": dict(cin=3, cout=5, k=3, padding=2, dilation=2),
    "pointwise_nobias": dict(cin=8, cout=4, k=1, bias_attr=False),
}


@pytest.mark.parametrize("case", sorted(CONVS))
def test_quantized_conv_int8_compute_parity(case):
    kw = dict(CONVS[case])
    cin, cout, k = kw.pop("cin"), kw.pop("cout"), kw.pop("k")
    fmt = kw.get("data_format", "NCHW")
    ref, port = _pair_of(lambda m: m.Sequential(m.Conv2D(cin, cout, k, **kw)),
                         seed=1)
    shape = (2, 8, 8, cin) if fmt == "NHWC" else (2, cin, 8, 8)
    x = np.random.RandomState(1).randn(*shape).astype("f4")
    f32 = port(_t(x)).detach().numpy()
    ref = JQ.quant_post_static(ref, [pt.to_tensor(x)])
    port = Q.quant_post_static(port, [_t(x)])
    _assert_frozen_equal(ref, port)
    qc, rc = port[0], ref[0]
    assert isinstance(qc, Q.QuantizedConv2D) and qc._int8_compute
    # the reference's int32 sums: its quantizer, then conv_general_dilated
    at = rc._conv_attrs
    step = jnp.maximum(rc.act_scale.data, 1e-8) / 127.0
    xq = jnp.clip(jnp.round(jnp.asarray(x) / step), -127.0, 127.0).astype(
        jnp.int8)
    jacc = jax.lax.conv_general_dilated(
        xq, rc.qweight.data, window_strides=_pair(at.get("stride", 1), 2),
        padding=_norm_padding(at.get("padding", 0), 2),
        rhs_dilation=_pair(at.get("dilation", 1), 2),
        feature_group_count=at.get("groups", 1),
        dimension_numbers=_conv_dimension_numbers(4, fmt),
        preferred_element_type=jnp.int32)
    acc = qc._int8_forward(_t(x), epilogue=_unit_epilogue(cout))
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc).astype("f4"))
    got = port(_t(x)).detach().numpy()
    np.testing.assert_allclose(got, ref(pt.to_tensor(x)).numpy(), **REL)
    tol = 3.0 * float(np.abs(f32).max()) / 127.0
    np.testing.assert_allclose(got, f32, atol=tol)


def test_quanted_conv2d():
    """QAT and the uncalibrated freeze of a convolution against the
    reference (the reference's ``test_quanted_conv2d``)."""
    ref, port = _pair_of(lambda m: m.Sequential(m.Conv2D(3, 8, 3, padding=1),
                                                m.ReLU()), seed=3)
    ref, port = JQ.quant_aware(ref), Q.quant_aware(port)
    assert any(isinstance(s, Q.QuantedConv2D) for s in port.modules())
    x = np.random.RandomState(3).rand(2, 3, 8, 8).astype("f4")
    out = port(_t(x))
    assert tuple(out.shape) == (2, 8, 8, 8)
    np.testing.assert_allclose(out.detach().numpy(),
                               ref(pt.to_tensor(x)).numpy(), **REL)
    ref, port = JQ.convert(ref), Q.convert(port)
    _assert_frozen_equal(ref, port)
    out2 = port(_t(x))
    assert tuple(out2.shape) == (2, 8, 8, 8)
    np.testing.assert_allclose(out2.detach().numpy(),
                               ref(pt.to_tensor(x)).numpy(), **REL)


def test_quantized_conv_rejects_unported_padding():
    qc = Q.QuantizedConv2D(nn.Conv2D(3, 4, 3, padding="SAME"),
                           act_scale=torch.tensor(1.0))
    assert qc._int8_compute
    with pytest.raises(NotImplementedError, match="item 14"):
        qc(torch.rand(1, 3, 8, 8))


def test_int8_path_multiplies_int8():
    """The reference checks its lowered dot for ``preferred_element_type=
    int32``; the port's traced forward must hold the int8 ops, fed int8
    operands, with float32 at the edge."""
    pt.seed(2)
    port = Q.quant_post_static(nn.Sequential(nn.Linear(8, 4)),
                               [torch.randn(2, 8)])
    x = torch.randn(2, 8)
    with torch.no_grad():
        program = torch.export.export(port, (x,), strict=False)
    ops = {n.target: n for n in program.graph.nodes
           if n.op == "call_function"}
    gemm = torch.ops.paddle_tpu_torch.int8_gemm.default
    assert torch.ops.paddle_tpu_torch.int8_quantize.default in ops
    assert gemm in ops
    a, b = ops[gemm].args[:2]
    assert a.meta["val"].dtype == b.meta["val"].dtype == torch.int8
    assert port(x).dtype == torch.float32


def test_int8_gate_follows_loaded_state_dict():
    ref, port = _pair_of(lambda m: m.Sequential(m.Linear(8, 4)), seed=5)
    x = np.random.RandomState(5).randn(3, 8).astype("f4")
    ref = JQ.quant_post_static(ref, [pt.to_tensor(x)])
    calibrated = Q.quant_post_static(port, [_t(x)])
    state = calibrated.state_dict()
    fresh = Q.convert(nn.Sequential(nn.Linear(8, 4)))
    assert not fresh[0]._int8_compute
    fresh.set_state_dict(state)
    assert fresh[0]._int8_compute               # flipped by the load
    out = fresh(_t(x)).detach().numpy()
    np.testing.assert_allclose(out, calibrated(_t(x)).detach().numpy(),
                               atol=1e-6)
    np.testing.assert_allclose(out, ref(pt.to_tensor(x)).numpy(), **REL)
    # the reference's own state dict, as numpy, flips it too
    other = Q.convert(nn.Sequential(nn.Linear(8, 4)))
    other.set_state_dict(_arrays(ref))
    assert other[0]._int8_compute
    np.testing.assert_allclose(other(_t(x)).detach().numpy(),
                               ref(pt.to_tensor(x)).numpy(), **REL)
    # a zeroed scale: back to the float path, sane output
    with torch.no_grad():
        fresh[0].act_scale.zero_()
    out2 = fresh(_t(x))
    assert not fresh[0]._int8_compute
    assert float(out2.abs().max()) < 1e3


def test_load_jax_state_carries_the_frozen_buffers():
    """A reference-quantized model's ``qweight``, ``wscale`` and
    ``act_scale`` loaded into the port's converted model: the same
    outputs, the GEMM's weight copy rebuilt."""
    ref, port = _pair_of(lambda m: _mlp(m, (8, 12, 3)), seed=8)
    x = np.random.RandomState(8).randn(5, 8).astype("f4")
    ref = JQ.quant_post_static(ref, [pt.to_tensor(x)])
    fresh = Q.convert(_mlp(nn, (8, 12, 3)))
    load_jax_state(fresh, _arrays(ref))
    assert fresh[0]._int8_compute
    np.testing.assert_array_equal(fresh[0].qweight_t.numpy(),
                                  fresh[0].qweight.numpy().T)
    np.testing.assert_allclose(fresh(_t(x)).detach().numpy(),
                               ref(pt.to_tensor(x)).numpy(), **REL)


# -- the int8 Predictor -------------------------------------------------------

def test_predictor_int8_path():
    ref, port = _pair_of(lambda m: _mlp(m, (8, 16, 4)), seed=0)
    x = np.random.RandomState(0).randn(4, 8).astype("f4")
    f32 = Predictor(port, device="cpu").run(x)
    jout = JPredictor(ref, JConfig().enable_int8(calibration_data=[x])).run(x)
    out = Predictor(port, Config().enable_int8(calibration_data=[x]),
                    device="cpu").run(x)
    np.testing.assert_allclose(out, jout, **REL)
    assert np.mean(np.abs(out - f32)) < 0.15 * np.mean(np.abs(f32)) + 1e-3


def test_predictor_int8_does_not_mutate_callers_model():
    torch.manual_seed(6)
    m = nn.Sequential(nn.Linear(8, 4))
    x = np.random.RandomState(6).randn(3, 8).astype("f4")
    ref = Predictor(m, Config(), device="cpu").run(x)
    before = {k: v.clone() for k, v in m.state_dict().items()}
    Predictor(m, Config().enable_int8([_t(x)]), device="cpu")
    assert isinstance(m[0], nn.Linear)          # the caller's layer untouched
    for k, v in m.state_dict().items():
        assert torch.equal(v, before[k])
    np.testing.assert_array_equal(Predictor(m, Config(), device="cpu").run(x),
                                  ref)


def test_predictor_run_device_chain():
    torch.manual_seed(0)
    m = nn.Sequential(nn.Linear(8, 8), nn.ReLU())
    x = (np.random.RandomState(0).randn(2, 8) * 0.1).astype("f4")
    p = Predictor(m, Config().enable_int8([x]), device="cpu")
    y = p.run_device(x)
    assert isinstance(y, torch.Tensor) and y.dtype == torch.float32
    y2 = p.run_device(y)
    assert torch.isfinite(y2).all()
    assert isinstance(p.run(x), np.ndarray)


def test_bert_base_width_int8_predictor_matches_the_reference():
    """Two layers of BERT-base width (768, 12 heads, 3072): the port's
    int8 Predictor within the reference's bound of its f32 one
    (``tests/test_quantization.py``'s ``0.15 * mean |ref| + 1e-3``), and,
    holding the reference int8 Predictor's calibrated state, within 1e-5
    of it. Each package's own calibration gives act_scales an ulp or two
    apart (activations summed in another order), which moves the
    quantizer's steps and flips levels near their boundaries: that gap is
    measured and held to 1e-2 of the mean output."""
    kw = dict(num_hidden_layers=2, hidden_dropout_prob=0.0,
              attention_probs_dropout_prob=0.0)
    pt.seed(11)
    jm = JBert(JBertConfig.base(**kw))
    jm.eval()
    m = load_jax_state(Bert(BertConfig.base(**kw)), _arrays(jm)).eval()
    rng = np.random.RandomState(11)

    def batch():
        ids = rng.randint(0, 30522, (2, 16)).astype("int32")
        lens = rng.randint(6, 17, 2)
        mask = (np.arange(16)[None] < lens[:, None]).astype("int32")
        return ids, np.zeros_like(ids), mask

    cal = [batch() for _ in range(2)]
    x = batch()
    f32 = Predictor(m, device="cpu").run(*x)
    own = Predictor(m, Config().enable_int8(cal), device="cpu")
    got_own = own.run(*x)
    jcal = [tuple(pt.to_tensor(a) for a in b) for b in cal]
    jpred = JPredictor(jm, JConfig().enable_int8(jcal))
    want = jpred.run(*x)
    held = Predictor(m, Config().enable_int8(cal), device="cpu")
    missing, unexpected = held.model.set_state_dict(_arrays(jpred.model))
    assert not missing and not unexpected
    got = held.run(*x)
    for g, o, r, w in zip(got, got_own, f32, want):
        assert np.mean(np.abs(o - r)) < 0.15 * np.mean(np.abs(r)) + 1e-3
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
        assert np.mean(np.abs(o - w)) <= 1e-2 * np.mean(np.abs(w))
