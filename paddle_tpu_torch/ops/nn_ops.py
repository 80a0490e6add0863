"""paddle_tpu_torch.ops.nn_ops — the neural-net functional ops BERT and
ResNet need.

Counterpart of ``paddle_tpu/ops/nn_ops.py``, limited to ``linear``,
``gelu``, ``relu``, ``embedding``, ``layer_norm``, ``dropout``,
``scaled_dot_product_attention``, ``conv2d``, ``max_pool2d``,
``adaptive_avg_pool2d``, ``batch_norm`` and ``flatten`` (the reference
keeps that one in ``ops/manip.py``). Plain functions on ``torch.Tensor``;
the hand-written kernels live in :mod:`paddle_tpu_torch.ops.kernels`.

Image ops take the reference's two layouts. An ``"NHWC"`` tensor has the
logical shape (N, H, W, C) and is contiguous; PyTorch's convolution and
pooling want a logical NCHW, so it is handed to them as
``x.permute(0, 3, 1, 2)``, a channels-last view that costs no copy, and
their channels-last result permuted back is a contiguous NHWC tensor
again. Convolution and pooling are PyTorch's own (they are outside any
kernel of the reference); batch norm is the port's.
"""
from __future__ import annotations

import math

import torch

from .. import amp
from .. import random as prandom
from . import kernels


def linear(x, weight, bias=None):
    """``x @ W + b`` with W laid out ``[in, out]`` as in the JAX package.
    AMP white-listed: under :func:`paddle_tpu_torch.amp.auto_cast` x, W
    and b are cast to the compute dtype, as the reference casts all
    three. Mixed float dtypes promote as ``jnp.matmul`` promotes them (a
    float32 input to bf16 weights, as a bf16 Predictor is fed, multiplies
    in float32)."""
    x, weight, bias = amp.maybe_cast(x, weight, bias)
    if x.dtype != weight.dtype:
        dt = torch.promote_types(x.dtype, weight.dtype)
        x, weight = x.to(dt), weight.to(dt)
    out = torch.matmul(x, weight)
    return out if bias is None else out + bias


def gelu(x, approximate=False):
    """GELU; exact (erf) by default, as ``jax.nn.gelu(approximate=False)``."""
    if approximate:
        c = math.sqrt(2.0 / math.pi)
        return 0.5 * x * (1.0 + torch.tanh(c * (x + 0.044715 * x.pow(3))))
    return 0.5 * x * (1.0 + torch.erf(x * (1.0 / math.sqrt(2.0))))


def relu(x):
    return torch.relu(x)


def flatten(x, start_axis=0, stop_axis=-1):
    """Merge the axes ``start_axis..stop_axis`` into one."""
    nd = x.dim()
    sa, so = start_axis % nd, stop_axis % nd
    return x.reshape(*x.shape[:sa], -1, *x.shape[so + 1:])


def embedding(x, weight, padding_idx=None):
    """Row gather; rows at ``padding_idx`` come out as zeros."""
    out = weight.index_select(0, x.reshape(-1)).reshape(*x.shape, -1)
    if padding_idx is not None:
        out = torch.where((x == padding_idx).unsqueeze(-1), 0.0, out)
    return out


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5):
    """Plain layer norm over the trailing ``normalized_shape`` axes, in
    x's dtype (the JAX op's arithmetic; ``nn.LayerNorm`` with an affine
    weight and bias takes the kernel instead)."""
    ns = (normalized_shape,) if isinstance(normalized_shape, int) \
        else tuple(normalized_shape)
    dims = tuple(range(x.dim() - len(ns), x.dim()))
    mean = x.mean(dim=dims, keepdim=True)
    var = (x - mean).square().mean(dim=dims, keepdim=True)
    out = (x - mean) * torch.rsqrt(var + epsilon)
    if weight is not None:
        out = out * weight + bias
    return out


def dropout(x, p=0.5, training=True, mode="upscale_in_train", axis=None,
            generator=None):
    """Dropout with the keep-mask drawn on x's device from ``generator``
    (default: the port's generator of that device,
    :func:`paddle_tpu_torch.random.generator`): no host draw and no copy.
    Serving runs in eval mode and never draws."""
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return x * (1 - p)
        return x
    shape = tuple(x.shape)
    if axis is not None:
        axes = (axis,) if isinstance(axis, int) else tuple(axis)
        shape = tuple(s if i in axes else 1 for i, s in enumerate(x.shape))
    g = generator if generator is not None else prandom.generator(x.device)
    keep = torch.rand(shape, device=x.device, generator=g) >= p
    if mode == "upscale_in_train":
        return torch.where(keep, x / (1.0 - p), 0.0)
    return torch.where(keep, x, 0.0)


def scaled_dot_product_attention(q, k, v, attn_mask=None, dropout_p=0.0,
                                 is_causal=False, training=True, scale=None,
                                 generator=None):
    """Plain attention over (B, H, S, D) with the JAX op's semantics: a
    bool mask and the causal mask fill with ``-1e9`` (so a fully masked
    row averages uniformly), an additive mask adds. Dropout applies to
    the attention probabilities."""
    d = q.shape[-1]
    s = scale if scale is not None else 1.0 / math.sqrt(d)
    logits = torch.matmul(q, k.transpose(-1, -2)) * s
    if attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            logits = torch.where(attn_mask, logits, -1e9)
        else:
            logits = logits + attn_mask
    if is_causal:
        sq, sk = logits.shape[-2:]
        causal = torch.ones(sq, sk, dtype=torch.bool,
                            device=logits.device).tril()
        logits = torch.where(causal, logits, -1e9)
    probs = torch.softmax(logits, dim=-1)
    p_drop = float(dropout_p) if training else 0.0
    if p_drop > 0.0:
        probs = dropout(probs, p_drop, training=True, generator=generator)
    return torch.matmul(probs, v)


# -- convolution and pooling ---------------------------------------------------

def _pair(v, n=2):
    if isinstance(v, (list, tuple)):
        return tuple(v)
    return (v,) * n


def _image_format(name, x, data_format):
    if data_format not in ("NCHW", "NHWC"):
        raise ValueError(f"{name}: data_format must be 'NCHW' or 'NHWC', "
                         f"got {data_format!r}")
    if x.dim() != 4:
        raise ValueError(f"{name} wants a 4-D {data_format} input, got "
                         f"shape {tuple(x.shape)}")
    return data_format == "NHWC"


def _to_nchw(x, chan_last):
    return x.permute(0, 3, 1, 2) if chan_last else x


def _from_nchw(out, chan_last):
    """Back to the caller's layout. A channels-last result comes back as a
    contiguous NHWC tensor with no copy; where a backend returned another
    memory order, this is the one copy that restores the contract."""
    if not chan_last:
        return out
    out = out.permute(0, 2, 3, 1)
    return out if out.is_contiguous() else out.contiguous()


def _symmetric_padding(name, padding):
    """Paddle's int or per-axis pair; strings and unequal begin/end pads
    are not ported."""
    if isinstance(padding, int):
        return (padding, padding)
    padding = tuple(padding) if isinstance(padding, (list, tuple)) else None
    if padding and len(padding) == 2 and all(isinstance(p, int)
                                             for p in padding):
        return padding
    raise NotImplementedError(
        f"{name}: only an int or a (ph, pw) padding is ported; 'SAME', "
        f"'VALID' and begin/end pairs are not (ROADMAP.md Queue A item "
        f"14)")


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW"):
    """2-D convolution; the weight is always OIHW, whatever the
    activations' layout, so state dicts do not depend on it. AMP
    white-listed: x, the weight and the bias are cast to the compute
    dtype."""
    chan_last = _image_format("conv2d", x, data_format)
    x, weight, bias = amp.maybe_cast(x, weight, bias)
    out = torch.nn.functional.conv2d(
        _to_nchw(x, chan_last), weight, bias, stride=_pair(stride),
        padding=_symmetric_padding("conv2d", padding),
        dilation=_pair(dilation), groups=groups)
    return _from_nchw(out, chan_last)


def max_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               data_format="NCHW"):
    """Max over windows, the padding counting as -inf."""
    if ceil_mode:
        raise NotImplementedError(
            "max_pool2d(ceil_mode=True): the reference accepts the flag "
            "and rounds down all the same; the port takes False only "
            "(ROADMAP.md Queue A item 14)")
    chan_last = _image_format("max_pool2d", x, data_format)
    kernel = _pair(kernel_size)
    out = torch.nn.functional.max_pool2d(
        _to_nchw(x, chan_last), kernel,
        stride=_pair(stride if stride is not None else kernel),
        padding=_symmetric_padding("max_pool2d", padding))
    return _from_nchw(out, chan_last)


def adaptive_avg_pool2d(x, output_size, data_format="NCHW"):
    """Mean over paddle's adaptive windows ``[floor(i h / o), ceil((i + 1)
    h / o))``, which are PyTorch's too."""
    chan_last = _image_format("adaptive_avg_pool2d", x, data_format)
    out = torch.nn.functional.adaptive_avg_pool2d(_to_nchw(x, chan_last),
                                                  _pair(output_size))
    return _from_nchw(out, chan_last)


# -- batch norm ------------------------------------------------------------------

def _one_pass_moments(x, axes):
    """``(mean, var)`` over ``axes`` in float32 from one read of x: the
    sums of ``x - c`` and its square, ``c`` a sample of x per channel
    (variance does not depend on a shift, and at a large mean the raw sum
    of squares would lose it), the biased variance clamped at 0."""
    xf = x.float()
    n = math.prod(x.shape[a] for a in axes)
    c = xf[tuple(slice(0, 1) if a in axes else slice(None)
                 for a in range(x.dim()))].detach()
    xs = xf - c
    m_s = xs.sum(dim=axes) / n
    mean = m_s + c.squeeze(axes)
    var = (xs.square().sum(dim=axes) / n - m_s.square()).clamp_min(0.0)
    return mean, var


def _fold_scale_shift(x, mean, var, w, b, epsilon, shape):
    """(mean, var, w, b) folded into one per-channel scale and shift,
    applied in x's dtype: under amp the chain stays bf16, as in the
    reference's plain path. ``w`` and ``b`` may both be None."""
    inv = torch.rsqrt(var.float() + epsilon)
    scale, shift = inv, -mean.float() * inv
    if w is not None:
        scale = inv * w.float()
        shift = b.float() - mean.float() * scale
    return x * scale.to(x.dtype).reshape(shape) + \
        shift.to(x.dtype).reshape(shape)


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5,
               data_format="NCHW"):
    """Returns ``(out, new_running_mean, new_running_var)``; the Layer
    writes the running statistics back. In training the batch statistics
    are float32 and the running ones move by ``momentum * old + (1 -
    momentum) * batch`` with the biased batch variance (the reference's
    convention, not ``torch.nn``'s), outside the autograd graph.

    A training-mode, affine, channels-last call goes through the
    batch-norm kernels when ``kernels.configure(batch_norm=True)`` is set
    (:func:`paddle_tpu_torch.ops.kernels.batch_norm.bn_channels_last`);
    everything else, and every NCHW input, takes the plain path below."""
    chan_first = data_format in ("NCHW", "NCL", "NCDHW") and x.dim() > 2
    if chan_first:
        axes = (0,) + tuple(range(2, x.dim()))
        shape = (1, -1) + (1,) * (x.dim() - 2)
    else:
        axes = tuple(range(x.dim() - 1))
        shape = (1,) * (x.dim() - 1) + (-1,)
    if weight is not None and bias is None:
        bias = torch.zeros_like(weight)     # bias_attr=False layers
    elif weight is None and bias is not None:
        weight = torch.ones_like(bias)      # weight_attr=False layers
    if not training:
        out = _fold_scale_shift(x, running_mean, running_var, weight, bias,
                                epsilon, shape)
        return out, running_mean, running_var
    if weight is not None and not chan_first and kernels.enabled(
            "batch_norm"):
        out, mean, var = kernels.batch_norm.bn_channels_last(
            x, weight, bias, epsilon)
    else:
        mean, var = _one_pass_moments(x, axes)
        out = _fold_scale_shift(x, mean, var, weight, bias, epsilon, shape)
    with torch.no_grad():
        # momentum * old + (1 - momentum) * batch, as one kernel each
        new_rm = torch.lerp(mean.to(running_mean.dtype), running_mean,
                            momentum)
        new_rv = torch.lerp(var.to(running_var.dtype), running_var, momentum)
    return out, new_rm, new_rv
