"""paddle_tpu_torch.ops.nn_ops — the neural-net functional ops BERT needs.

Counterpart of ``paddle_tpu/ops/nn_ops.py``, limited to ``linear``,
``gelu``, ``embedding``, ``layer_norm``, ``dropout`` and
``scaled_dot_product_attention``. Plain functions on ``torch.Tensor``;
the hand-written kernels live in :mod:`paddle_tpu_torch.ops.kernels`.
"""
from __future__ import annotations

import math

import torch

from .. import amp
from .. import random as prandom


def linear(x, weight, bias=None):
    """``x @ W + b`` with W laid out ``[in, out]`` as in the JAX package.
    AMP white-listed: under :func:`paddle_tpu_torch.amp.auto_cast` x, W
    and b are cast to the compute dtype, as the reference casts all
    three."""
    x, weight, bias = amp.maybe_cast(x, weight, bias)
    out = torch.matmul(x, weight)
    return out if bias is None else out + bias


def gelu(x, approximate=False):
    """GELU; exact (erf) by default, as ``jax.nn.gelu(approximate=False)``."""
    if approximate:
        c = math.sqrt(2.0 / math.pi)
        return 0.5 * x * (1.0 + torch.tanh(c * (x + 0.044715 * x.pow(3))))
    return 0.5 * x * (1.0 + torch.erf(x * (1.0 / math.sqrt(2.0))))


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
