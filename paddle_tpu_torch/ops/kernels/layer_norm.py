"""Forward layer norm: the CUDA kernel ``csrc/layer_norm.cu`` and its plain
PyTorch version.

Counterpart of ``paddle_tpu/ops/pallas/layer_norm.py`` (``_run_fwd`` and
its ``_fwd_kernel``). The backward kernel (``_ln_bwd``) belongs to the
training slice; these functions run without autograd.
"""
from __future__ import annotations

import ctypes

import torch

from . import check, count_launch, device_index, function, stream_of

NAME = "layer_norm_fwd"

_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 6 + [
    ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p]
_DTYPES = (torch.float32, torch.bfloat16)


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
              int(w.dtype == torch.bfloat16), stream_of(x2))
    check(NAME, fn, code)
    count_launch(NAME)
    return y, mu, rstd


def layer_norm(x, weight, bias, epsilon=1e-5):
    """Layer norm over the LAST axis of ``x`` (any leading shape) through
    :func:`layer_norm_fwd`: the port's counterpart of
    ``paddle_tpu.ops.pallas.layer_norm``."""
    d = x.shape[-1]
    y, _, _ = layer_norm_fwd(x.reshape(-1, d), weight, bias, epsilon)
    return y.reshape(x.shape)
