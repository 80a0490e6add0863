"""paddle_tpu_torch.quantization — QAT fake-quant and post-training int8.

Counterpart of ``paddle_tpu/quantization.py``, under its names:

* :func:`quant_aware` wraps every Linear / Conv2D in a fake-quant layer
  (:class:`QuantedLinear`, :class:`QuantedConv2D`): weights quantize
  per-channel abs-max each step, activations through a moving-average
  abs-max observer whose scale is the persistable buffer ``act_scale``,
  written in place (``copy_``), so that a ``jit.to_static`` step captured
  as a CUDA graph advances the same buffer at every replay. The rounding
  passes its gradient straight through (:class:`_SteRound`); the clip's
  gradient at its bounds is split as ``jnp.clip``'s is (``torch.maximum``
  and ``torch.minimum`` split ties as ``lax.max`` and ``lax.min`` do).
* :func:`convert` freezes a model: :class:`QuantizedLinear` and
  :class:`QuantizedConv2D` hold ``qweight`` (int8) and ``wscale``
  (per-channel steps) as the reference lays them out (``[in, out]`` and
  ``(1, out)`` for a Linear, OIHW and ``(out, 1, 1, 1)`` for a
  convolution). With a calibrated ``act_scale`` the product is int8 x
  int8 -> int32 through the port's kernels ``int8_quantize`` and
  ``int8_gemm`` (:mod:`paddle_tpu_torch.ops.kernels.int8_gemm`); a
  convolution runs as an im2col of its quantized input and one GEMM per
  group. Uncalibrated layers keep the reference's dequantize path (plain
  PyTorch).
* :func:`quant_post_static` runs calibration batches through the
  observers, then converts (PTQ).

The int8 gate (``_int8_compute``, the reference's ``_refresh_int8_gate``)
is decided on the host from ``act_scale``. An eager call refreshes it, as
the reference does on a call that is not traced; inside a CUDA graph's
capture, or while a call is traced or counted
(:func:`paddle_tpu_torch.ops.kernels.traced`), the last host value holds,
as the reference keeps it under a tracer. A loaded state dict refreshes
it (and the GEMM's transposed copy of ``qweight``) at once.
"""
from __future__ import annotations

import numpy as np
import torch

from . import nn
from .nn.layer import Layer
from .ops import nn_ops as F
from .ops.kernels import traced
from .ops.kernels.int8_gemm import int8_gemm, int8_quantize, true_div

__all__ = ["fake_quant", "QuantConfig", "quant_aware", "convert",
           "quant_post_static", "QuantedLinear", "QuantedConv2D",
           "QuantizedLinear", "QuantizedConv2D"]


class _SteRound(torch.autograd.Function):
    """``round`` (half to even) whose gradient is the identity."""

    @staticmethod
    def forward(ctx, x):
        return torch.round(x)

    @staticmethod
    def backward(ctx, g):
        return g


def _ste_round(x):
    return _SteRound.apply(x)


def _as_scale(scale, like):
    if isinstance(scale, torch.Tensor):
        return scale.to(like.device)
    return torch.tensor(scale, dtype=torch.float32, device=like.device)


def _qdq(x, scale, bits):
    """Quantize-dequantize with a straight-through rounding; ``scale``
    broadcasts against ``x``."""
    qmax = float(2 ** (bits - 1) - 1)
    s = scale.clamp_min(1e-8)
    # the bound as a tensor made on the device (no host copy, so a CUDA
    # graph captures it): maximum/minimum split a tie's gradient as
    # jnp.clip does
    bound = torch.full((), qmax, dtype=s.dtype, device=s.device)
    q = torch.minimum(torch.maximum(_ste_round(x / s * qmax), -bound), bound)
    return q * s / bound


def fake_quant(x, scale, bits=8, name=None):
    """Fake quantization (the reference's ``fake_quant``): ``x`` rounded
    onto ``2^(bits-1) - 1`` levels a side of ``scale``, gradient straight
    through inside the range."""
    return _qdq(x, _as_scale(scale, x), bits)


class QuantConfig:
    def __init__(self, weight_bits=8, activation_bits=8,
                 moving_rate=0.9, weight_quantize_type="channel_wise_abs_max",
                 activation_quantize_type="moving_average_abs_max"):
        self.weight_bits = weight_bits
        self.activation_bits = activation_bits
        self.moving_rate = moving_rate
        self.weight_quantize_type = weight_quantize_type
        self.activation_quantize_type = activation_quantize_type


def _to_model_device(batch, model):
    """A calibration batch's arrays as tensors on ``model``'s device."""
    dev = next((t.device for t in model.parameters()), torch.device("cpu"))
    out = []
    for b in batch:
        if isinstance(b, torch.Tensor):
            out.append(b.to(dev))
        else:
            a = np.asarray(b)
            if a.dtype == np.float64:
                a = a.astype(np.float32)
            elif a.dtype == np.int64:
                a = a.astype(np.int32)
            out.append(torch.from_numpy(np.ascontiguousarray(a)).to(dev))
    return out


class _QuantedBase(Layer):
    """Shared QAT machinery: the activation observer and the weight's
    fake quantization."""

    def __init__(self, inner, config, ch_axis):
        super().__init__()
        self.inner = inner
        self._cfg = config
        self._ch_axis = ch_axis  # the weight's output-channel axis
        self.register_buffer(
            "act_scale",
            torch.zeros((), dtype=torch.float32,
                        device=inner.weight.device), persistable=True)
        self._calibrating = False

    def _observe(self, x):
        """Moving-average abs-max observer, then fake-quant of ``x``. In
        training or calibration the new scale is written into
        ``act_scale`` in place; in eval before any calibration the batch's
        own abs-max is used."""
        cur = x.detach().abs().amax().float()
        r = self._cfg.moving_rate
        old = self.act_scale
        if self.training or self._calibrating:
            new = torch.where(old > 0.0, r * old + (1 - r) * cur, cur)
            with torch.no_grad():
                old.copy_(new)
            scale = new
        else:
            scale = torch.where(old > 0.0, old, cur)
        return fake_quant(x, scale, self._cfg.activation_bits)

    def _wq(self, w):
        if self._cfg.weight_quantize_type == "channel_wise_abs_max":
            axes = tuple(i for i in range(w.dim()) if i != self._ch_axis)
            scale = w.detach().abs().amax(dim=axes, keepdim=True)
        else:
            scale = w.detach().abs().amax()
        return fake_quant(w, scale, self._cfg.weight_bits)


class QuantedLinear(_QuantedBase):
    """Fake-quant Linear (the reference's QuantizationTransformPass on
    mul/matmul)."""

    def __init__(self, inner, config):
        super().__init__(inner, config, ch_axis=1)  # (in, out)

    def forward(self, x):
        x = self._observe(x)
        w = self._wq(self.inner.weight)
        out = torch.matmul(x, w)
        if self.inner.bias is not None:
            out = out + self.inner.bias
        return out


class QuantedConv2D(_QuantedBase):
    """Fake-quant Conv2D (the reference's QuantizationTransformPass on
    conv2d)."""

    def __init__(self, inner, config):
        super().__init__(inner, config, ch_axis=0)  # (out, in, kh, kw)

    def forward(self, x):
        x = self._observe(x)
        w = self._wq(self.inner.weight)
        return F.conv2d(x, w, self.inner.bias, **self.inner._attrs)


def _wrap(layer, config):
    for name, child in list(layer.named_children()):
        if isinstance(child, nn.Linear):
            layer.add_module(name, QuantedLinear(child, config))
        elif isinstance(child, nn.Conv2D):
            layer.add_module(name, QuantedConv2D(child, config))
        else:
            _wrap(child, config)
    return layer


def quant_aware(model, config=None):
    """Insert fake-quant wrappers on every Linear / Conv2D, in place (the
    reference's QuantizationTransformPass.apply). Train as usual
    afterwards."""
    return _wrap(model, config or QuantConfig())


# ---------------------------------------------------------------------------
# frozen int8 inference layers

def _freeze_weight(w, ch_axis, bits):
    """``(q, step)``: ``w`` quantized per channel along ``ch_axis`` to
    int8, ``round(w / scale * qmax)`` with ``scale = max(|w|, 1e-8)`` per
    channel, and the channels' steps ``scale / qmax`` (float32), both
    keeping every axis as the reference does."""
    qmax = 2 ** (bits - 1) - 1
    w = w.detach()
    axes = tuple(i for i in range(w.dim()) if i != ch_axis)
    scale = torch.clamp_min(w.abs().amax(dim=axes, keepdim=True), 1e-8)
    q = torch.clamp(torch.round(w / scale * qmax), -qmax, qmax)
    return q.to(torch.int8), true_div(scale, float(qmax)).float()


def _scale_value(act_scale):
    if act_scale is None:
        return 0.0
    if isinstance(act_scale, torch.Tensor):
        return float(act_scale.detach().float().cpu())
    return float(np.asarray(act_scale))


class _Frozen(Layer):
    """What the two frozen int8 layers share: the buffers, the int8 gate
    and its refresh, and the refresh on a loaded state dict."""

    def _freeze(self, inner, ch_axis, bits, act_scale, act_bits,
                int8_compute):
        q, scale = _freeze_weight(inner.weight, ch_axis, bits)
        a = _scale_value(act_scale)
        dev = inner.weight.device
        self.register_buffer("qweight", q, persistable=True)
        self.register_buffer("wscale", scale, persistable=True)
        self.register_buffer("act_scale", torch.tensor(
            a, dtype=torch.float32, device=dev), persistable=True)
        self._act_bits = act_bits
        self._int8_opt_in = bool(int8_compute)
        self._int8_compute = self._int8_opt_in and a > 0.0
        self.bias = inner.bias

    @property
    def _act_qmax(self):
        return 2 ** (self._act_bits - 1) - 1

    def _refresh_int8_gate(self):
        """Re-decide int8 against dequant from ``act_scale`` where it can
        be read on the host: not inside a CUDA graph's capture, and not
        while the call is traced or counted (the last host value holds
        there, as the reference keeps it under a tracer)."""
        a = self.act_scale
        if a.device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            return
        if traced(a):
            return
        self._int8_compute = self._int8_opt_in and float(a) > 0.0

    def _state_loaded(self):
        """After new buffer values arrived (a loaded state dict, or
        ``convert.load_jax_state``): the gate and the derived layout."""
        self._refresh_int8_gate()

    def _load_from_state_dict(self, *args, **kwargs):
        super()._load_from_state_dict(*args, **kwargs)
        self._state_loaded()

    def _dequant_input(self, x):
        a = self.act_scale
        return torch.where(a > 0.0, _qdq(x, a, self._act_bits), x)


class QuantizedLinear(_Frozen):
    """Frozen int8 Linear (the reference's QuantizationFreezePass
    output): ``qweight`` int8 ``[in, out]`` and ``wscale`` ``(1, out)``.
    With a calibrated ``act_scale`` the input is quantized once
    (``int8_quantize``) and multiplied in int8 with int32 sums
    (``int8_gemm``, from the non-persistent ``(out, in)`` copy
    ``qweight_t``, rebuilt whenever ``qweight`` is loaded); otherwise the
    weight dequantizes into a float product, as in the reference."""

    def __init__(self, inner, bits=8, act_scale=None, act_bits=8,
                 int8_compute=True):
        super().__init__()
        self._freeze(inner, 1, bits, act_scale, act_bits, int8_compute)
        self.register_buffer("qweight_t", self.qweight.t().contiguous(),
                             persistable=False)

    def _state_loaded(self):
        with torch.no_grad():
            self.qweight_t.copy_(self.qweight.t())
        super()._state_loaded()

    def forward(self, x):
        self._refresh_int8_gate()
        if not self._int8_compute:
            x = self._dequant_input(x)
            w = self.qweight.to(x.dtype) * self.wscale.to(x.dtype)
            out = torch.matmul(x, w)
            return out if self.bias is None else out + self.bias
        return self._int8_forward(x)

    def _int8_forward(self, x, epilogue=None):
        """The int8 product. ``epilogue`` replaces the GEMM's ``(wscale,
        act_scale, bias)`` (the tests read the int32 sums through unit
        scales)."""
        ws, ascale, bias = epilogue or (self.wscale, self.act_scale,
                                        self.bias)
        xq = int8_quantize(x.reshape(-1, x.shape[-1]), self.act_scale,
                           self._act_qmax)
        out = int8_gemm(xq, self.qweight_t, ws, ascale, bias,
                        self._act_qmax, out_dtype=x.dtype)
        return out.reshape(*x.shape[:-1], out.shape[-1])


def _quantize_nd(x, ascale, qmax):
    """An image tensor quantized elementwise in its own memory order (the
    quantizer takes rows, and any dense order is rows), returned with its
    shape and that order."""
    if x.is_contiguous():
        q = int8_quantize(x.reshape(-1, x.shape[-1]), ascale, qmax)
        return q.reshape(x.shape)
    if x.is_contiguous(memory_format=torch.channels_last):
        nhwc = x.permute(0, 2, 3, 1)
        q = int8_quantize(nhwc.reshape(-1, nhwc.shape[-1]), ascale, qmax)
        return q.reshape(nhwc.shape).permute(0, 3, 1, 2)
    return _quantize_nd(x.contiguous(), ascale, qmax)


def _im2col(xq, kh, kw, stride, padding, dilation):
    """(N*Ho*Wo, C*kh*kw) patches of the int8 NHWC tensor ``xq``, each
    row in the weight's (c, i, j) order, the padding zeros (q(0) = 0, so
    this equals padding the float input, then quantizing it)."""
    n, h, w, c = xq.shape
    (sh, sw), (ph, pw), (dh, dw) = stride, padding, dilation
    if ph or pw:
        xp = xq.new_zeros((n, h + 2 * ph, w + 2 * pw, c))
        xp[:, ph:ph + h, pw:pw + w] = xq
    else:
        xp = xq
    eh, ew = dh * (kh - 1) + 1, dw * (kw - 1) + 1
    win = xp.unfold(1, eh, sh).unfold(2, ew, sw)   # N, Ho, Wo, C, eh, ew
    win = win[..., ::dh, ::dw]
    ho, wo = win.shape[1], win.shape[2]
    return win.reshape(n * ho * wo, c * kh * kw), (n, ho, wo)


class QuantizedConv2D(_Frozen):
    """Frozen int8 convolution, the same design as
    :class:`QuantizedLinear`: ``qweight`` int8 OIHW and ``wscale``
    ``(out, 1, 1, 1)``. Calibrated, the input is quantized once, cut into
    im2col patches and multiplied by ``int8_gemm`` against the weight's
    ``(out, in*kh*kw)`` rows (a view of ``qweight``), one GEMM per group;
    NCHW or NHWC. A padding the port's ``conv2d`` does not take raises
    as it does there."""

    def __init__(self, inner, bits=8, act_scale=None, act_bits=8,
                 int8_compute=True):
        super().__init__()
        self._freeze(inner, 0, bits, act_scale, act_bits, int8_compute)
        self._conv_attrs = dict(inner._attrs)

    def forward(self, x):
        self._refresh_int8_gate()
        at = self._conv_attrs
        if not self._int8_compute:
            x = self._dequant_input(x)
            w = self.qweight.float() * self.wscale
            return F.conv2d(x, w, self.bias, **at)
        return self._int8_forward(x)

    def _int8_forward(self, x, epilogue=None):
        """The int8 convolution: quantize, im2col, a GEMM per group.
        ``epilogue`` replaces the GEMMs' ``(wscale, act_scale, bias)``,
        as in :meth:`QuantizedLinear._int8_forward`."""
        at = self._conv_attrs
        ws, ascale, bias = epilogue or (self.wscale, self.act_scale,
                                        self.bias)
        chan_last = F._image_format("conv2d", x,
                                    at.get("data_format", "NCHW"))
        padding = F._symmetric_padding("conv2d", at.get("padding", 0))
        stride = F._pair(at.get("stride", 1))
        dilation = F._pair(at.get("dilation", 1))
        groups = at.get("groups", 1)
        qmax = self._act_qmax
        xq = _quantize_nd(x, self.act_scale, qmax)
        if not chan_last:
            xq = xq.permute(0, 2, 3, 1)
        o, cg, kh, kw = self.qweight.shape
        cols, (n, ho, wo) = _im2col(xq, kh, kw, stride, padding, dilation)
        wrows = self.qweight.reshape(o, cg * kh * kw)
        ws = ws.reshape(o)
        og, kg = o // groups, cg * kh * kw
        outs = [int8_gemm(cols[:, g * kg:(g + 1) * kg],
                          wrows[g * og:(g + 1) * og],
                          ws[g * og:(g + 1) * og], ascale,
                          None if bias is None
                          else bias[g * og:(g + 1) * og],
                          qmax, out_dtype=x.dtype)
                for g in range(groups)]
        out = outs[0] if groups == 1 else torch.cat(outs, dim=1)
        out = out.reshape(n, ho, wo, o)
        return out if chan_last else out.permute(0, 3, 1, 2)


def convert(model, bits=8):
    """Freeze a quant_aware (or plain) model for int8 inference, in place
    (the reference's QuantizationFreezePass + convert). Calibrated
    observer scales carry into the frozen layers' ``act_scale``."""
    def _conv(layer):
        for name, child in list(layer.named_children()):
            if isinstance(child, QuantedLinear):
                layer.add_module(name, QuantizedLinear(
                    child.inner, bits, act_scale=child.act_scale,
                    act_bits=child._cfg.activation_bits))
            elif isinstance(child, QuantedConv2D):
                layer.add_module(name, QuantizedConv2D(
                    child.inner, bits, act_scale=child.act_scale,
                    act_bits=child._cfg.activation_bits))
            elif isinstance(child, nn.Linear):
                layer.add_module(name, QuantizedLinear(child, bits))
            elif isinstance(child, nn.Conv2D):
                layer.add_module(name, QuantizedConv2D(child, bits))
            else:
                _conv(child)
        return layer

    model = _conv(model)
    model.eval()
    return model


def quant_post_static(model, sample_batches, config=None, bits=8):
    """Post-training quantization (the reference's
    post_training_quantization.py): wrap, run the calibration batches
    (tensors or numpy arrays, one input or a tuple of inputs each) through
    the observers without gradients, then freeze."""
    config = config or QuantConfig()
    model = quant_aware(model, config)
    observers = [m for m in model.modules() if isinstance(m, _QuantedBase)]
    for m in observers:
        m._calibrating = True
    model.eval()
    try:
        with torch.no_grad():
            for batch in sample_batches:
                args = batch if isinstance(batch, (tuple, list)) \
                    else (batch,)
                model(*_to_model_device(args, model))
    finally:
        for m in observers:
            m._calibrating = False
    return convert(model, bits)
