"""Layer norm: the forward kernel ``csrc/layer_norm.cu``, the backward
kernel ``csrc/layer_norm_bwd.cu``, their plain PyTorch versions, and the
``torch.autograd.Function`` that joins them.

Counterpart of ``paddle_tpu/ops/pallas/layer_norm.py``: ``_run_fwd`` (its
``_fwd_kernel``), ``_ln_bwd`` (its ``_bwd_kernel``) and the custom-vjp
``_layer_norm2``. :func:`layer_norm` is differentiable: where a gradient
is wanted it runs :class:`LayerNormFunction`, whose forward saves the
rows' ``mu`` and ``rstd`` and whose backward launches the backward kernel
(or, on a CPU tensor, computes :func:`layer_norm_bwd_plain`: the CPU takes
the same path, with an explicit plain backward rather than autograd of the
plain forward). Under ``torch.inference_mode`` or ``no_grad`` it calls the
forward wrapper alone and builds no graph.
"""
from __future__ import annotations

import ctypes

import torch

from . import check, count_launch, device_index, function, stream_of

NAME = "layer_norm_fwd"
BWD_NAME = "layer_norm_bwd"
#: the partial rows of dw and db the backward kernel may write (at most
#: one a block; ``MAX_PARTS`` in ``csrc/layer_norm_bwd.cu``)
BWD_MAX_PARTS = 1024

_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 6 + [
    ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 9 + [
    ctypes.c_int] * 5 + [ctypes.c_void_p]
_DTYPES = (torch.float32, torch.bfloat16)


def vector_width(x2, *others):
    """The elements a lane moves in one access in the kernels' instance for
    rows ``x2`` (N, D) and the ``others`` they read or write beside it:
    ``16 // x2.element_size()`` (one 16-byte access: 4 float32 or 8 bf16)
    where D is a multiple of that and every tensor's pointer is 16-byte
    aligned, else 1. A contiguous view at an offset (a slice, or
    ``reshape`` of one) keeps its offset, so it can take the scalar
    instance."""
    v = 16 // x2.element_size()
    if x2.shape[-1] % v == 0 and all(t.data_ptr() % 16 == 0
                                     for t in (x2, *others)):
        return v
    return 1


def layer_norm_fwd_plain(x2, w, b, eps):
    """Plain PyTorch version of the kernel, on any device: statistics in
    f32, two-pass variance. Returns ``(y, mu, rstd)`` with ``y`` in
    ``x2``'s dtype and ``mu``, ``rstd`` f32 of shape ``(N, 1)``."""
    x = x2.float()
    mu = x.mean(dim=1, keepdim=True)
    var = (x - mu).square().mean(dim=1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    y = (x - mu) * rstd * w.float() + b.float()
    return y.to(x2.dtype), mu, rstd


def _check_inputs(x2, w, b):
    if x2.dim() != 2:
        raise ValueError(f"layer_norm_fwd wants x of shape (N, D), got "
                         f"{tuple(x2.shape)}")
    d = x2.shape[1]
    if w.shape != (d,) or b.shape != (d,):
        raise ValueError(f"layer_norm_fwd: weight {tuple(w.shape)} and bias "
                         f"{tuple(b.shape)} must be ({d},)")
    for name, t in (("x", x2), ("weight", w), ("bias", b)):
        if t.dtype not in _DTYPES:
            raise TypeError(f"layer_norm_fwd: {name} must be float32 or "
                            f"bfloat16, got {t.dtype}")


def layer_norm_fwd(x2, w, b, eps):
    """Layer norm over the last axis of ``x2`` (N, D). On a CUDA tensor it
    launches the kernel; on a CPU tensor it computes
    :func:`layer_norm_fwd_plain`. Returns ``(y, mu, rstd)`` as the
    plain version does."""
    _check_inputs(x2, w, b)
    if x2.device.type == "cpu":
        return layer_norm_fwd_plain(x2, w, b, eps)
    if x2.device.type != "cuda" or w.device != x2.device \
            or b.device != x2.device:
        raise ValueError(f"layer_norm_fwd: x, weight and bias must share "
                         f"one CUDA device, got {x2.device}, {w.device}, "
                         f"{b.device}")
    if x2.stride(1) != 1:
        raise ValueError("layer_norm_fwd: x's last dim must be contiguous")
    if w.dtype != b.dtype:
        raise TypeError("layer_norm_fwd: weight and bias must share a dtype")
    x2 = x2.contiguous()            # rows packed: a view of (.., D) rows
    w, b = w.contiguous(), b.contiguous()
    n, d = x2.shape
    y = torch.empty_like(x2)
    mu = torch.empty((n, 1), dtype=torch.float32, device=x2.device)
    rstd = torch.empty((n, 1), dtype=torch.float32, device=x2.device)
    if n == 0 or d == 0:
        return y, mu, rstd
    fn = function(NAME, _ARGTYPES)
    code = fn(device_index(x2), x2.data_ptr(), w.data_ptr(), b.data_ptr(),
              y.data_ptr(), mu.data_ptr(), rstd.data_ptr(), n, d,
              float(eps), int(x2.dtype == torch.bfloat16),
              int(w.dtype == torch.bfloat16), vector_width(x2, w, b, y),
              stream_of(x2))
    check(NAME, fn, code)
    count_launch(NAME)
    return y, mu, rstd


def layer_norm_bwd_plain(x2, w, mu, rstd, g):
    """Plain PyTorch version of the backward kernel, on any device: the
    Pallas ``_bwd_kernel``'s arithmetic in f32. Returns ``(dx, dw, db)``
    with ``dx`` in ``x2``'s dtype and ``dw``, ``db`` in ``w``'s."""
    x, g, wf = x2.float(), g.float(), w.float()
    xhat = (x - mu) * rstd
    dxhat = g * wf
    m1 = dxhat.mean(dim=1, keepdim=True)
    m2 = (dxhat * xhat).mean(dim=1, keepdim=True)
    dx = rstd * (dxhat - m1 - xhat * m2)
    dw = (g * xhat).sum(dim=0)
    db = g.sum(dim=0)
    return dx.to(x2.dtype), dw.to(w.dtype), db.to(w.dtype)


def layer_norm_bwd(x2, w, mu, rstd, g):
    """Layer norm's gradients for ``x2`` (N, D), weight ``w`` (D,), the
    forward's ``mu`` and ``rstd`` (N, 1) f32, and the output gradient
    ``g`` (N, D). On a CUDA tensor it launches the backward kernel (f32 or
    bf16, any D): ``dx`` per row, then ``dw`` and ``db`` summed over
    per-block partials in a fixed order (deterministic). On a CPU
    tensor it computes :func:`layer_norm_bwd_plain`. Returns ``(dx, dw,
    db)`` as the plain version does."""
    if x2.dim() != 2 or g.shape != x2.shape:
        raise ValueError(f"layer_norm_bwd: x {tuple(x2.shape)} and g "
                         f"{tuple(g.shape)} must be one (N, D) shape")
    n, d = x2.shape
    if w.shape != (d,) or mu.shape != (n, 1) or rstd.shape != (n, 1):
        raise ValueError(f"layer_norm_bwd: weight {tuple(w.shape)}, mu "
                         f"{tuple(mu.shape)}, rstd {tuple(rstd.shape)} do "
                         f"not fit x {(n, d)}")
    if x2.device.type == "cpu":
        return layer_norm_bwd_plain(x2, w, mu, rstd, g)
    if x2.device.type != "cuda" or any(t.device != x2.device
                                       for t in (w, mu, rstd, g)):
        raise ValueError("layer_norm_bwd: x, weight, mu, rstd and g must "
                         "share one CUDA device")
    for name, t in (("x", x2), ("weight", w)):
        if t.dtype not in _DTYPES:
            raise TypeError(f"layer_norm_bwd: {name} must be float32 or "
                            f"bfloat16, got {t.dtype}")
    if g.dtype != x2.dtype or mu.dtype != torch.float32 \
            or rstd.dtype != torch.float32:
        raise TypeError("layer_norm_bwd: g must have x's dtype, mu and rstd "
                        "float32")
    x2, w, g = x2.contiguous(), w.contiguous(), g.contiguous()
    mu, rstd = mu.contiguous(), rstd.contiguous()
    dx = torch.empty_like(x2)
    dw = torch.empty_like(w)
    db = torch.empty_like(w)
    if n == 0 or d == 0:
        return dx, dw.zero_(), db.zero_()
    part = torch.empty((min(n, BWD_MAX_PARTS), 2, d), dtype=torch.float32,
                       device=x2.device)
    fn = function(BWD_NAME, _BWD_ARGTYPES)
    code = fn(device_index(x2), x2.data_ptr(), w.data_ptr(), mu.data_ptr(),
              rstd.data_ptr(), g.data_ptr(), dx.data_ptr(), dw.data_ptr(),
              db.data_ptr(), part.data_ptr(), n, d,
              int(x2.dtype == torch.bfloat16),
              int(w.dtype == torch.bfloat16),
              vector_width(x2, w, g, dx, part), stream_of(x2))
    check(BWD_NAME, fn, code)
    count_launch(BWD_NAME)
    return dx, dw, db


class LayerNormFunction(torch.autograd.Function):
    """Layer norm over the last axis of ``x`` (any leading shape) with
    autograd: the counterpart of the Pallas module's ``_layer_norm2``
    custom vjp. The forward saves the rows of ``x``, the weight and the
    rows' ``mu`` and ``rstd``; the backward runs :func:`layer_norm_bwd`.
    ``db`` takes the bias's dtype, which the forward requires to be the
    weight's."""

    @staticmethod
    def forward(ctx, x, w, b, eps):
        x2 = x.reshape(-1, x.shape[-1])
        y, mu, rstd = layer_norm_fwd(x2, w, b, eps)
        ctx.save_for_backward(x2, w, mu, rstd)
        return y.reshape(x.shape)

    @staticmethod
    def backward(ctx, g):
        x2, w, mu, rstd = ctx.saved_tensors
        dx, dw, db = layer_norm_bwd(x2, w, mu, rstd,
                                    g.reshape(x2.shape).contiguous())
        return dx.reshape(g.shape), dw, db, None


def layer_norm(x, weight, bias, epsilon=1e-5):
    """Layer norm over the LAST axis of ``x`` (any leading shape): the
    port's counterpart of ``paddle_tpu.ops.pallas.layer_norm``. Where
    autograd records (grad mode on and an input requires grad) it runs
    :class:`LayerNormFunction`; otherwise :func:`layer_norm_fwd` alone."""
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        return LayerNormFunction.apply(x, weight, bias, epsilon)
    y, _, _ = layer_norm_fwd(x.reshape(-1, x.shape[-1]), weight, bias,
                             epsilon)
    return y.reshape(x.shape)
