"""Fused softmax cross entropy: the forward and backward kernels
``csrc/softmax_xent.cu``, their plain PyTorch versions, and the
``torch.autograd.Function`` that joins them.

Counterpart of ``paddle_tpu/ops/pallas/softmax_xent.py``: ``_run_fwd``
(its ``_fwd_kernel``), ``_run_bwd`` (its ``_bwd_kernel``), the custom-vjp
``_softmax_xent2`` and ``softmax_cross_entropy``. Per row of logits
``(N, V)`` with a hard label and a smoothing ``eps``, the forward gives
``loss = lse - (1 - eps) x[label] - (eps / V) sum(x)`` and ``lse``; a
label outside ``[0, V)`` matches no column (``loss = lse`` when eps is 0),
and the caller masks ignored rows (``ops/loss.py``). The backward is
elementwise given the saved ``lse``: ``dx = (exp(x - lse) - target) g``.
The plain versions are the Pallas bodies' arithmetic in float32.
"""
from __future__ import annotations

import ctypes

import torch

from . import check, count_launch, device_index, function, stream_of

FWD_NAME = "softmax_xent_fwd"
BWD_NAME = "softmax_xent_bwd"

_FWD_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [
    ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_float,
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 5 + [
    ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_float,
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_DTYPES = (torch.float32, torch.bfloat16)


def _check_inputs(name, logits2, labels2, *rows):
    if logits2.dim() != 2 or logits2.shape[1] == 0:
        raise ValueError(f"{name} wants logits of shape (N, V) with V > 0, "
                         f"got {tuple(logits2.shape)}")
    n = logits2.shape[0]
    for t in (labels2,) + rows:
        if tuple(t.shape) != (n, 1):
            raise ValueError(f"{name}: labels, lse and g must be ({n}, 1), "
                             f"got {tuple(t.shape)}")
    if logits2.dtype not in _DTYPES:
        raise TypeError(f"{name}: logits must be float32 or bfloat16, got "
                        f"{logits2.dtype}")


def _check_cuda(name, logits2, labels2, *f32_rows):
    if logits2.device.type != "cuda" or any(
            t.device != logits2.device for t in (labels2,) + f32_rows):
        raise ValueError(f"{name}: logits, labels, lse and g must share one "
                         f"CUDA device")
    if labels2.dtype != torch.int32:
        raise TypeError(f"{name}: labels must be int32, got {labels2.dtype}")
    if any(t.dtype != torch.float32 for t in f32_rows):
        raise TypeError(f"{name}: lse and g must be float32")


def softmax_xent_fwd_plain(logits2, labels2, eps=0.0):
    """Plain PyTorch version of the forward kernel, on any device.
    Returns ``(loss, lse)``, each ``(N, 1)`` float32."""
    x = logits2.float()
    v = x.shape[1]
    m = x.amax(dim=1, keepdim=True)
    lse = torch.log(torch.exp(x - m).sum(dim=1, keepdim=True)) + m
    lab = labels2.long()
    inside = (lab >= 0) & (lab < v)
    picked = torch.where(inside, x.gather(1, lab.clamp(0, v - 1)), 0.0)
    if eps:
        return (lse - (1.0 - eps) * picked -
                (eps / v) * x.sum(dim=1, keepdim=True)), lse
    return lse - picked, lse


def softmax_xent_fwd(logits2, labels2, eps=0.0):
    """Per-row loss and ``lse`` of ``logits2`` (N, V) f32 or bf16 at
    ``labels2`` (N, 1). On a CUDA tensor it launches the forward kernel
    (labels int32); on a CPU tensor it computes
    :func:`softmax_xent_fwd_plain`."""
    _check_inputs(FWD_NAME, logits2, labels2)
    if logits2.device.type == "cpu":
        return softmax_xent_fwd_plain(logits2, labels2, eps)
    _check_cuda(FWD_NAME, logits2, labels2)
    x, lab = logits2.contiguous(), labels2.contiguous()
    n, v = x.shape
    loss = torch.empty((n, 1), dtype=torch.float32, device=x.device)
    lse = torch.empty((n, 1), dtype=torch.float32, device=x.device)
    if n == 0:
        return loss, lse
    fn = function(FWD_NAME, _FWD_ARGTYPES)
    code = fn(device_index(x), x.data_ptr(), lab.data_ptr(), loss.data_ptr(),
              lse.data_ptr(), n, v, 1.0 - eps, eps / v, int(eps != 0),
              int(x.dtype == torch.bfloat16), stream_of(x))
    check(FWD_NAME, fn, code)
    count_launch(FWD_NAME)
    return loss, lse


def softmax_xent_bwd_plain(logits2, labels2, lse, g, eps=0.0):
    """Plain PyTorch version of the backward kernel, on any device:
    ``dx`` (N, V) in the logits' dtype."""
    x = logits2.float()
    v = x.shape[1]
    p = torch.exp(x - lse)
    onehot = (torch.arange(v, device=x.device)[None, :] ==
              labels2.long()).float()
    target = (1.0 - eps) * onehot + (eps / v) if eps else onehot
    return ((p - target) * g).to(logits2.dtype)


def softmax_xent_bwd(logits2, labels2, lse, g, eps=0.0):
    """The logits' gradient from the forward's ``lse`` (N, 1) f32 and the
    loss gradient ``g`` (N, 1) f32. On a CUDA tensor it launches the
    backward kernel; on a CPU tensor it computes
    :func:`softmax_xent_bwd_plain`."""
    _check_inputs(BWD_NAME, logits2, labels2, lse, g)
    if logits2.device.type == "cpu":
        return softmax_xent_bwd_plain(logits2, labels2, lse, g, eps)
    _check_cuda(BWD_NAME, logits2, labels2, lse, g)
    x, lab = logits2.contiguous(), labels2.contiguous()
    lse, g = lse.contiguous(), g.contiguous()
    n, v = x.shape
    dx = torch.empty_like(x)
    if n == 0:
        return dx
    fn = function(BWD_NAME, _BWD_ARGTYPES)
    code = fn(device_index(x), x.data_ptr(), lab.data_ptr(), lse.data_ptr(),
              g.data_ptr(), dx.data_ptr(), n, v, 1.0 - eps, eps / v,
              int(eps != 0), int(x.dtype == torch.bfloat16), stream_of(x))
    check(BWD_NAME, fn, code)
    count_launch(BWD_NAME)
    return dx


class SoftmaxXentFunction(torch.autograd.Function):
    """Per-row softmax cross entropy of ``logits2`` (N, V) at ``labels2``
    (N, 1) int32 with autograd: the counterpart of the Pallas module's
    ``_softmax_xent2`` custom vjp. The forward saves the logits, labels
    and ``lse``; the backward casts the loss gradient to float32 and runs
    :func:`softmax_xent_bwd`."""

    @staticmethod
    def forward(ctx, logits2, labels2, eps):
        loss, lse = softmax_xent_fwd(logits2, labels2, eps)
        ctx.save_for_backward(logits2, labels2, lse)
        ctx.eps = eps
        return loss

    @staticmethod
    def backward(ctx, g):
        logits2, labels2, lse = ctx.saved_tensors
        dx = softmax_xent_bwd(logits2, labels2, lse, g.float(), ctx.eps)
        return dx, None, None


def softmax_cross_entropy(logits, label, smooth_eps=0.0):
    """Fused per-position softmax cross entropy with hard labels over the
    last axis; returns the loss with shape ``logits.shape[:-1] + (1,)``.
    ``smooth_eps > 0`` folds uniform label smoothing into both kernels."""
    v = logits.shape[-1]
    loss = SoftmaxXentFunction.apply(
        logits.reshape(-1, v), label.reshape(-1, 1).to(torch.int32),
        float(smooth_eps))
    return loss.reshape(*logits.shape[:-1], 1)
