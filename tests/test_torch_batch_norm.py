"""The port's batch norm against the JAX package, on the CPU.

The same inputs (numpy, from a seed) go through the reference's Pallas
batch-norm kernels in interpret mode (``_batch_norm2``,
``bn_channels_last``) and through the plain versions of the port's CUDA
kernels, which is what the port's wrappers compute on a CPU tensor; then
through ``ops.nn_ops.batch_norm`` and the ``BatchNorm`` layers on both of
their branches; then through the image ops around them (``conv2d``,
``max_pool2d``, ``adaptive_avg_pool2d``) and the ``SGD`` and ``Momentum``
optimizers.

Tolerances, each with its reason:

* kernels, float32: atol 3e-4, the reference's own test's
  (``tests/test_pallas.py``): sums over 200 rows in another order;
* kernels, bf16 input: 2e-2 (the float32 result rounded to bf16 once;
  the statistics stay float32 and keep 3e-4);
* ``nn_ops.batch_norm``, layers, image ops in float32: atol 1e-4 (the
  same arithmetic; convolution sums in another order);
* optimizers: 1e-6 (elementwise float32 in the same order).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu.tensor as ref_tensor
import paddle_tpu as pt
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.ops import nn_ops as JF
from paddle_tpu.ops import pallas as P
from paddle_tpu.ops.pallas.batch_norm import _batch_norm2
from paddle_tpu.ops.pallas.batch_norm import bn_channels_last as j_bn_cl

from paddle_tpu_torch import nn, optimizer
from paddle_tpu_torch.convert import load_jax_state
from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.ops import nn_ops as F
from paddle_tpu_torch.ops.kernels import batch_norm as BN


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


F32_TOL = 3e-4
BF16_TOL = 2e-2
EPS = 1e-5


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
    """Turns the batch-norm kernels on in both packages; restores both
    afterwards so later tests on the worker run with the defaults."""
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


def _kernel_inputs(m=200, c=24, seed=0, mean=3.0, scale=2.0):
    rng = np.random.RandomState(seed)
    return dict(x=(rng.randn(m, c) * scale + mean).astype("f4"),
                w=(rng.rand(c) + 0.5).astype("f4"),
                b=rng.randn(c).astype("f4"),
                g=rng.randn(m, c).astype("f4"),
                gm=rng.randn(c).astype("f4"), gv=rng.randn(c).astype("f4"))


# -- the kernels' plain versions against the Pallas kernels ---------------------

@pytest.mark.parametrize("dtype,tol", [("float32", F32_TOL),
                                       ("bfloat16", BF16_TOL)])
def test_forward_matches_pallas_interpret(dtype, tol):
    d = _kernel_inputs()
    jx = jnp.asarray(d["x"]).astype(dtype)
    out, mean, var = _batch_norm2(jx, jnp.asarray(d["w"]),
                                  jnp.asarray(d["b"]), EPS)
    tx = _t(d["x"]).to(getattr(torch, dtype))
    got, gmean, gvar = BN.batch_norm2(tx, _t(d["w"]),
                                      _t(d["b"]), EPS)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    assert gmean.dtype == gvar.dtype == torch.float32
    assert gmean.shape == gvar.shape == (1, 24)
    np.testing.assert_allclose(_np(got), np.asarray(out, np.float32),
                               atol=tol)
    np.testing.assert_allclose(_np(gmean), np.asarray(mean), atol=F32_TOL)
    np.testing.assert_allclose(_np(gvar), np.asarray(var), atol=F32_TOL)


def _torch_grads(d, dtype, through):
    x = _t(d["x"]).to(getattr(torch, dtype)).requires_grad_()
    w = _t(d["w"]).requires_grad_()
    b = _t(d["b"]).requires_grad_()
    out, mean, var = BN.batch_norm2(x, w, b, EPS)
    assert type(out.grad_fn).__name__ == "BatchNormFunctionBackward"
    if through == "out":
        (out.float() * _t(d["g"])).sum().backward()
    else:
        ((mean * _t(d["gm"])).sum() +
         (var * _t(d["gv"])).sum()).backward()
    return x.grad, w.grad, b.grad


@pytest.mark.parametrize("dtype,tol", [("float32", F32_TOL),
                                       ("bfloat16", BF16_TOL)])
def test_gradients_through_out_match_pallas_interpret(dtype, tol):
    d = _kernel_inputs()
    g = jnp.asarray(d["g"])

    def f(x, w, b):
        return jnp.sum(_batch_norm2(x, w, b, EPS)[0].astype(jnp.float32) * g)

    ref = jax.grad(f, argnums=(0, 1, 2))(
        jnp.asarray(d["x"]).astype(dtype), jnp.asarray(d["w"]),
        jnp.asarray(d["b"]))
    got = _torch_grads(d, dtype, "out")
    assert got[0].dtype == getattr(torch, dtype)
    assert got[1].dtype == got[2].dtype == torch.float32
    np.testing.assert_allclose(_np(got[0]), np.asarray(ref[0], np.float32),
                               atol=tol)
    # dw and db sum 200 rows of bf16-rounded x: their own scale
    for a, r in zip(got[1:], ref[1:]):
        np.testing.assert_allclose(_np(a), np.asarray(r), atol=tol,
                                   rtol=tol)


def test_gradients_through_mean_and_var_match_pallas_interpret():
    """A loss that consumes the batch statistics directly; ``out`` is
    unused, so autograd hands the backward ``None`` for it."""
    d = _kernel_inputs()
    gm, gv = jnp.asarray(d["gm"]), jnp.asarray(d["gv"])
    w, b = jnp.asarray(d["w"]), jnp.asarray(d["b"])

    def f(x):
        _, mean, var = _batch_norm2(x, w, b, EPS)
        return jnp.sum(mean * gm) + jnp.sum(var * gv)

    ref = jax.grad(f)(jnp.asarray(d["x"]))
    dx, dw, db = _torch_grads(d, "float32", "stats")
    np.testing.assert_allclose(_np(dx), np.asarray(ref), atol=F32_TOL)
    # the analytic gradient too: d mean / dx = 1/M, d var / dx = 2(x-mean)/M
    x = d["x"].astype("f8")
    want = d["gm"] / 200 + 2 * (x - x.mean(0)) * d["gv"] / 200
    np.testing.assert_allclose(_np(dx), want, atol=F32_TOL)
    assert not dw.any() and not db.any()


def test_large_mean_keeps_the_variance():
    """At mean 1000 the raw sum of squares loses the variance entirely;
    the shifted sums keep it, as the reference's do."""
    d = _kernel_inputs(mean=1000.0, scale=1.0, seed=3)
    w, b = _t(d["w"]), _t(d["b"])
    out, _, var = BN.batch_norm2(_t(d["x"]), w, b, EPS)
    j_out, _, j_var = _batch_norm2(jnp.asarray(d["x"]), jnp.asarray(d["w"]),
                                   jnp.asarray(d["b"]), EPS)
    np.testing.assert_allclose(_np(var).ravel(), d["x"].var(0), rtol=0.05)
    np.testing.assert_allclose(_np(var), np.asarray(j_var), rtol=1e-3)
    np.testing.assert_allclose(_np(out), np.asarray(j_out), atol=2e-3)
    z = (_np(out) - d["b"]) / d["w"]
    assert abs(z.mean()) < 0.1 and 0.8 < z.std() < 1.2


def test_bn_channels_last_takes_any_rank_and_refuses_a_copy():
    rng = np.random.RandomState(5)
    x = rng.randn(2, 5, 7, 12).astype("f4")
    w, b = (rng.rand(12) + 0.5).astype("f4"), rng.randn(12).astype("f4")
    ref = j_bn_cl(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), EPS)
    got = BN.bn_channels_last(_t(x), _t(w),
                              _t(b), EPS)
    assert got[0].shape == x.shape and got[1].shape == got[2].shape == (12,)
    for a, r in zip(got, ref):
        np.testing.assert_allclose(_np(a), np.asarray(r), atol=F32_TOL)
    # an NCHW tensor seen as NHWC is not contiguous: its rows need a copy
    nchw_view = _t(x).permute(0, 3, 1, 2).contiguous() \
        .permute(0, 2, 3, 1)
    with pytest.raises(ValueError, match="copy"):
        BN.bn_channels_last(nchw_view, _t(w),
                            _t(b), EPS)


def test_each_plain_kernel_version_against_the_pallas_kernel():
    """Kernel by kernel: the stats, normalize, backward-reduce and dx
    kernels of the reference (interpret mode) against the port's plain
    versions, on the same operands."""
    from paddle_tpu.ops.pallas import batch_norm as JBN
    d = _kernel_inputs(m=70, c=12, seed=7)
    jx, jg = jnp.asarray(d["x"]), jnp.asarray(d["g"])
    tx, tg = _t(d["x"]), _t(d["g"])
    j_mean, j_var = JBN._stats(jx)
    mean, var = BN.bn_stats(tx)
    np.testing.assert_allclose(_np(mean), np.asarray(j_mean), atol=F32_TOL)
    np.testing.assert_allclose(_np(var), np.asarray(j_var), atol=F32_TOL)
    # with the affine operands the same kernel also folds them, as the
    # reference's _bn_fwd_res does after its stats
    w, b = _t(d["w"]), _t(d["b"])
    mean5, var5, rstd, scale, shift = BN.bn_stats(tx, w, b, EPS)
    assert torch.equal(mean5, mean) and torch.equal(var5, var)
    j_rstd = jax.lax.rsqrt(j_var + EPS)
    j_scale = j_rstd * d["w"].reshape(1, -1)
    j_shift = d["b"].reshape(1, -1) - j_mean * j_scale
    for a, r in ((rstd, j_rstd), (scale, j_scale), (shift, j_shift)):
        assert a.shape == (1, 12)
        np.testing.assert_allclose(_np(a), np.asarray(r), atol=F32_TOL)
    np.testing.assert_allclose(
        _np(BN.bn_normalize(tx, scale, shift)),
        np.asarray(JBN._normalize(jx, j_scale, j_shift)), atol=F32_TOL)
    # the backward pair against the reference's _bn_bwd, with and without
    # cotangents for the statistics
    for gm, gv in ((d["gm"], d["gv"]), (None, None)):
        zeros = np.zeros(12, "f4")
        j_dx, j_dw, j_db = JBN._bn_bwd(
            EPS, (jx, jnp.asarray(d["w"]), j_mean, j_rstd),
            (jg, jnp.asarray(zeros if gm is None else gm),
             jnp.asarray(zeros if gv is None else gv)))
        dg, db = BN.bn_bwd_reduce(tx, tg, mean, rstd)
        np.testing.assert_allclose(_np(dg).ravel(), np.asarray(j_dw),
                                   atol=F32_TOL)
        np.testing.assert_allclose(_np(db).ravel(), np.asarray(j_db),
                                   atol=F32_TOL)
        dx = BN.bn_bwd_dx(tx, tg, mean, rstd, w, dg, db,
                          None if gm is None else _t(gm),
                          None if gv is None else _t(gv))
        np.testing.assert_allclose(_np(dx), np.asarray(j_dx), atol=F32_TOL)
        dx2, dw2, db2 = BN.bn_backward(
            tx, w, mean, rstd, tg,
            None if gm is None else _t(gm),
            None if gv is None else _t(gv))
        assert torch.equal(dx2, dx) and torch.equal(dw2, dg[0])


def test_wrappers_check_their_operands():
    x = torch.zeros(4, 6)
    with pytest.raises(ValueError, match=r"\(M, C\)"):
        BN.bn_stats(torch.zeros(4))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        BN.bn_stats(x.double())
    with pytest.raises(ValueError, match="scale"):
        BN.bn_normalize(x, torch.zeros(5), torch.zeros(1, 6))
    with pytest.raises(ValueError, match="g must have"):
        BN.bn_bwd_reduce(x, torch.zeros(4, 5), torch.zeros(1, 6),
                         torch.zeros(1, 6))
    with pytest.raises(ValueError, match="weight"):
        BN.batch_norm2(x, torch.zeros(5), torch.zeros(6), EPS)
    with pytest.raises(ValueError, match="come together"):
        BN.bn_stats(x, torch.ones(6))
    with pytest.raises(ValueError, match="g_var"):
        BN.bn_bwd_dx(x, x, *[torch.zeros(1, 6)] * 2, torch.ones(6),
                     *[torch.zeros(1, 6)] * 2, None, torch.zeros(2, 6))
    # under no_grad the forward alone runs: no graph
    out, _, _ = BN.batch_norm2(x.requires_grad_(), torch.ones(6),
                               torch.zeros(6), EPS)
    assert out.grad_fn is not None
    with torch.no_grad():
        out, _, _ = BN.batch_norm2(x, torch.ones(6), torch.zeros(6), EPS)
    assert out.grad_fn is None
    assert set(BN._ARGTYPES) == {n for n in kernels.SOURCES
                                 if n.startswith("batch_norm")}
    assert kernels.launches[BN.STATS] == 0      # the CPU launches nothing


# -- ops.nn_ops.batch_norm --------------------------------------------------------

BN_CASES = {
    # name: (shape, data_format)
    "nchw": ((4, 6, 5, 5), "NCHW"),
    "nhwc": ((4, 5, 5, 6), "NHWC"),
    "ncl": ((4, 6, 9), "NCL"),
    "nlc": ((4, 9, 6), "NLC"),
    "nc": ((16, 6), "NCHW"),
}


@pytest.mark.parametrize("affine", ["both", "weight_only", "bias_only",
                                    "none"])
@pytest.mark.parametrize("case", sorted(BN_CASES))
@pytest.mark.parametrize("switch", [False, True])
def test_batch_norm_op_matches_jax(case, affine, switch, bn_switch):
    """Training (out, both running statistics, dx, dw) and eval, on the
    plain branch and with the kernel switch on in both packages (the
    kernel branch is taken by the channels-last affine cases only)."""
    bn_switch(switch)
    shape, fmt = BN_CASES[case]
    rng = np.random.RandomState(len(case) + len(affine))
    x = (rng.randn(*shape) * 2 + 1).astype("f4")
    w = (rng.rand(6) + 0.5).astype("f4") if affine in ("both",
                                                        "weight_only") \
        else None
    b = rng.randn(6).astype("f4") if affine in ("both", "bias_only") else None
    rm, rv = rng.randn(6).astype("f4"), (rng.rand(6) + 0.5).astype("f4")
    g = rng.randn(*shape).astype("f4")

    def jt(a, grad=False):
        return None if a is None else pt.to_tensor(a, stop_gradient=not grad)

    def tt(a, grad=False):
        return None if a is None else \
            _t(a).requires_grad_(grad)

    jx, jw, jb = jt(x, True), jt(w, True), jt(b, True)
    tx, tw, tb = tt(x, True), tt(w, True), tt(b, True)
    ref = JF.batch_norm(jx, jt(rm), jt(rv), jw, jb, training=True,
                        momentum=0.8, epsilon=EPS, data_format=fmt)
    got = F.batch_norm(tx, tt(rm), tt(rv), tw, tb, training=True,
                       momentum=0.8, epsilon=EPS, data_format=fmt)
    chan_last = case in ("nhwc", "nlc", "nc")
    took_kernel = switch and chan_last and affine != "none"
    # the kernel branch ends in bn_channels_last's view of the rows
    assert (type(got[0].grad_fn).__name__ == "ViewBackward0") == took_kernel
    tol = F32_TOL if took_kernel else 1e-4
    for a, r in zip(got, ref):
        np.testing.assert_allclose(_np(a), _np(r), atol=tol)
    assert not got[1].requires_grad and not got[2].requires_grad
    (ref[0] * pt.to_tensor(g)).sum().backward()
    (got[0] * _t(g)).sum().backward()
    np.testing.assert_allclose(_np(tx.grad), np.asarray(jx.grad), atol=tol)
    for tp, jp in ((tw, jw), (tb, jb)):
        if tp is not None:
            np.testing.assert_allclose(_np(tp.grad), np.asarray(jp.grad),
                                       atol=tol, rtol=1e-4)
    # eval: the running statistics normalise, and come back unchanged
    ref = JF.batch_norm(jt(x), jt(rm), jt(rv), jt(w), jt(b), training=False,
                        epsilon=EPS, data_format=fmt)
    trm = tt(rm)
    got = F.batch_norm(tt(x), trm, tt(rv), tt(w), tt(b), training=False,
                       epsilon=EPS, data_format=fmt)
    np.testing.assert_allclose(_np(got[0]), _np(ref[0]), atol=1e-4)
    assert got[1] is trm


@pytest.mark.parametrize("switch", [False, True])
@pytest.mark.parametrize("kind,fmt,shape", [
    ("BatchNorm1D", "NLC", (32, 12)), ("BatchNorm1D", "NCL", (8, 12, 5)),
    ("BatchNorm2D", "NHWC", (4, 6, 6, 12)),
    ("BatchNorm2D", "NCHW", (4, 12, 6, 6))])
def test_batch_norm_layers_match_jax_over_two_calls(kind, fmt, shape, switch,
                                                    bn_switch):
    """The layer in training mode twice (the running statistics carry),
    with the switch off and on in both packages, then in eval mode; the
    weight's gradient of ``mean(out ** 2)``."""
    bn_switch(switch)
    rng = np.random.RandomState(1)
    jbn = getattr(jnn, kind)(12, data_format=fmt)
    bn = getattr(nn, kind)(12, data_format=fmt)
    w = (rng.rand(12) + 0.5).astype("f4")
    jbn.weight.set_value(w)
    load_jax_state(bn, {k: np.asarray(v.numpy())
                        for k, v in jbn.state_dict().items()})
    assert set(bn.state_dict()) == {"weight", "bias", "_mean", "_variance"}
    jbn.train()
    bn.train()
    for i in range(2):
        x = (rng.randn(*shape) + i).astype("f4")
        jout = jbn(pt.to_tensor(x))
        out = bn(_t(x))
        np.testing.assert_allclose(_np(out), _np(jout), atol=F32_TOL)
    for name in ("_mean", "_variance"):
        np.testing.assert_allclose(_np(getattr(bn, name)),
                                   _np(getattr(jbn, name)), atol=F32_TOL)
        assert not getattr(bn, name).requires_grad
    (jout ** 2).mean().backward()
    (out ** 2).mean().backward()
    np.testing.assert_allclose(_np(bn.weight.grad),
                               np.asarray(jbn.weight.grad), atol=F32_TOL)
    jbn.eval()
    bn.eval()
    before = _np(bn._mean).copy()
    np.testing.assert_allclose(_np(bn(_t(x))),
                               _np(jbn(pt.to_tensor(x))), atol=F32_TOL)
    np.testing.assert_array_equal(_np(bn._mean), before)


def test_batch_norm_under_amp_keeps_bf16_input_and_f32_statistics(bn_switch):
    """Batch norm is not on the amp white list: a bf16 input comes out
    bf16 on both branches, the statistics are float32, and the two
    branches (scale and shift folded in bf16, or kept float32 by the
    kernels) agree within bf16's step."""
    from paddle_tpu_torch import amp
    rng = np.random.RandomState(2)
    x = _t(rng.randn(4, 5, 5, 8).astype("f4")).bfloat16()
    bn = nn.BatchNorm2D(8, data_format="NHWC").train()
    with amp.auto_cast(dtype="bfloat16"):
        plain = bn(x)
        bn_switch(True)
        fused = bn(x)
    assert plain.dtype == fused.dtype == torch.bfloat16
    assert bn._mean.dtype == torch.float32
    np.testing.assert_allclose(_np(fused), _np(plain), atol=4e-2)


# -- the image ops ------------------------------------------------------------------

def _nhwc(a):
    return np.ascontiguousarray(a.transpose(0, 2, 3, 1))


CONVS = {
    # ResNet's: name: (cin, cout, kernel, stride, padding, bias)
    "stem_7x7_s2_p3": (3, 8, 7, 2, 3, False),
    "1x1": (8, 16, 1, 1, 0, False),
    "3x3_p1": (8, 8, 3, 1, 1, False),
    "3x3_s2_p1": (8, 8, 3, 2, 1, False),
    "1x1_s2_downsample": (8, 16, 1, 2, 0, False),
    "3x3_bias": (4, 6, 3, 1, (1, 0), True),
}


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
@pytest.mark.parametrize("name", sorted(CONVS))
def test_conv2d_matches_jax(name, fmt):
    cin, cout, k, s, p, bias = CONVS[name]
    rng = np.random.RandomState(len(name))
    x = rng.randn(2, cin, 14, 14).astype("f4")
    x = x if fmt == "NCHW" else _nhwc(x)
    w = (rng.randn(cout, cin, k, k) * 0.2).astype("f4")
    b = rng.randn(cout).astype("f4") if bias else None
    # the reference first, to its end (numpy on the host), then the port:
    # the two runtimes computing at once have crashed test workers
    jx = pt.to_tensor(x, stop_gradient=False)
    jw = pt.to_tensor(w, stop_gradient=False)
    ref = JF.conv2d(jx, jw, None if b is None else pt.to_tensor(b), stride=s,
                    padding=p, data_format=fmt)
    (ref ** 2).sum().backward()
    ref, ref_dx, ref_dw = _np(ref), np.asarray(jx.grad), np.asarray(jw.grad)
    tx = _t(x).requires_grad_()
    tw = _t(w).requires_grad_()
    got = F.conv2d(tx, tw, None if b is None else _t(b),
                   stride=s, padding=p, data_format=fmt)
    assert got.shape == ref.shape and got.is_contiguous()
    np.testing.assert_allclose(_np(got), ref, atol=1e-4)
    (got ** 2).sum().backward()
    np.testing.assert_allclose(_np(tx.grad), ref_dx, atol=1e-3, rtol=1e-4)
    np.testing.assert_allclose(_np(tw.grad), ref_dw, atol=1e-3, rtol=1e-4)


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_pooling_flatten_and_relu_match_jax(fmt):
    rng = np.random.RandomState(4)
    # all negative: a zero-padded max would come out 0, -inf padding not
    x = -np.abs(rng.randn(2, 6, 9, 9)).astype("f4") - 0.5
    x = x if fmt == "NCHW" else _nhwc(x)
    got = F.max_pool2d(_t(x), 3, 2, padding=1, data_format=fmt)
    ref = JF.max_pool2d(pt.to_tensor(x), 3, 2, padding=1, data_format=fmt)
    assert got.shape == tuple(ref.shape) and got.is_contiguous()
    np.testing.assert_array_equal(_np(got), _np(ref))
    assert (_np(got) < 0).all()
    for size, out in ((9, 1), (8, 2), (9, 2)):      # divisible or not
        xs = x[:, :, :size, :size] if fmt == "NCHW" else x[:, :size, :size]
        xs = np.ascontiguousarray(xs)
        got = F.adaptive_avg_pool2d(_t(xs), out,
                                    data_format=fmt)
        ref = JF.adaptive_avg_pool2d(pt.to_tensor(xs), out, data_format=fmt)
        assert got.shape == tuple(ref.shape)
        np.testing.assert_allclose(_np(got), _np(ref), atol=1e-6)
    flat = nn.Flatten(1)(_t(x))
    assert flat.shape == (2, 6 * 9 * 9)
    np.testing.assert_array_equal(_np(flat),
                                  _np(jnn.Flatten(1)(pt.to_tensor(x))))
    np.testing.assert_array_equal(_np(nn.ReLU()(_t(x + 1))),
                                  _np(JF.relu(pt.to_tensor(x + 1))))


def test_unported_image_options_raise():
    x = torch.zeros(1, 2, 4, 4)
    with pytest.raises(NotImplementedError, match="ceil_mode"):
        F.max_pool2d(x, 2, ceil_mode=True)
    with pytest.raises(NotImplementedError, match="padding"):
        F.conv2d(x, torch.zeros(2, 2, 3, 3), padding="SAME")
    with pytest.raises(ValueError, match="data_format"):
        F.conv2d(x, torch.zeros(2, 2, 3, 3), data_format="NCDHW")
    for name in ("SyncBatchNorm", "BatchNorm3D", "Conv2DTranspose", "Conv3D",
                 "AvgPool2D", "Pool2D"):
        assert not hasattr(nn, name), name


def test_conv2d_initialises_he_normal_and_omits_the_bias():
    import paddle_tpu_torch as ptt
    ptt.seed(0)
    conv = nn.Conv2D(16, 32, 3, bias_attr=False, data_format="NHWC")
    assert conv.bias is None and conv.weight.shape == (32, 16, 3, 3)
    assert [n for n, _ in conv.named_parameters()] == ["weight"]
    std = conv.weight.std().item()
    assert abs(std - np.sqrt(2.0 / (16 * 9))) < 0.01
    assert nn.Conv2D(2, 2, 1).bias.shape == (2,)


# -- SGD and Momentum ---------------------------------------------------------------

@pytest.mark.parametrize("kind,kw", [
    ("SGD", {}), ("Momentum", dict(momentum=0.9)),
    ("Momentum", dict(momentum=0.8, use_nesterov=True))])
def test_sgd_and_momentum_steps_match_jax(kind, kw):
    pt.seed(3)
    jl, tl = jnn.Linear(5, 3), nn.Linear(5, 3)
    load_jax_state(tl, {k: np.asarray(v.numpy())
                        for k, v in jl.state_dict().items()})
    jo = getattr(jopt, kind)(learning_rate=0.1, parameters=jl.parameters(),
                             **kw)
    to = getattr(optimizer, kind)(learning_rate=0.1,
                                  parameters=list(tl.parameters()), **kw)
    rng = np.random.RandomState(1)
    for _ in range(3):
        for jp, tp in zip(jl.parameters(), tl.parameters()):
            g = rng.randn(*jp.shape).astype("f4")
            jp._grad = jnp.asarray(g)
            tp.grad = _t(g)
        jo.step()
        to.step()
        jo.clear_grad()
        to.clear_grad()
    for jp, tp in zip(jl.parameters(), tl.parameters()):
        np.testing.assert_allclose(_np(tp), np.asarray(jp.numpy()),
                                   atol=1e-6, rtol=1e-6)
        if kind == "Momentum":
            v = to._accumulators[id(tp)]["velocity"]
            assert v.dtype == tp.dtype
            np.testing.assert_allclose(
                _np(v), np.asarray(jo._accumulators[id(jp)]["velocity"].data),
                atol=1e-6, rtol=1e-6)
        else:
            assert id(tp) not in to._accumulators
