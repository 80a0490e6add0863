"""Fused Adam: the kernels of ``csrc/fused_adam.cu`` (one tensor, many
tensors, an arena-flat buffer), their plain PyTorch versions, and the
update rules that dispatch to them.

Counterpart of ``paddle_tpu/ops/pallas/fused_adam.py``:
``fused_adam_update`` (its ``_adam_kernel``), ``fused_adam_update_multi``
and ``fused_adam_update_flat`` (its ``_adam_multi_kernel``), and the rules
``adam_step`` and ``adam_step_flat``. The kernels update ``p``, ``m`` and
``v`` in place, where the Pallas calls alias them
(``input_output_aliases``), and the wrappers return the updated tensors.
The scalars ``[lr, beta1_pow, beta2_pow(, wd)]`` (the pows already
advanced for this step) reach a kernel as one float32 tensor on the card,
the Pallas kernels' SMEM scalars, so a step never waits on the host.

The plain versions are the Pallas bodies' arithmetic in float32, and the
kernels compute it operation for operation with no FMA, so the two agree
to the bit where PyTorch's ops round alike (the card test allows one
float32 step in the parameter).
"""
from __future__ import annotations

import ctypes

import torch

from . import check, count_launch, device_index, enabled, function, stream_of

NAME = "fused_adam"
MULTI_NAME = "fused_adam_multi"
FLAT_NAME = "fused_adam_flat"
#: tensors one many-tensor launch takes (the kernel's parameter table)
MULTI_MAX_TENSORS = 256
#: the arena pads each group to a multiple of this (``optimizer/arena.py``)
FLAT_ALIGN = 1024

_HYPER = [ctypes.c_float] * 5
_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [
    ctypes.c_longlong, ctypes.c_void_p] + _HYPER + [ctypes.c_int,
                                                    ctypes.c_void_p]
# device, count; arrays of p, g, m, v pointers and of sizes; scal
_MULTI_ARGTYPES = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 6 + \
    _HYPER + [ctypes.c_void_p]
_FLAT_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [
    ctypes.c_longlong, ctypes.c_void_p] + _HYPER + [ctypes.c_void_p]


def scalars(device, *values):
    """``values`` (0-d tensors or Python floats) as one float32 tensor on
    ``device``, built on the device: no host-to-device copy, no sync."""
    parts = [v.to(device=device, dtype=torch.float32).reshape(())
             if torch.is_tensor(v) else
             torch.full((), float(v), dtype=torch.float32, device=device)
             for v in values]
    return torch.stack(parts)


def _hyper(beta1, beta2, eps):
    # 1 - beta rounded from the double, as the reference's weak-typed
    # Python floats are
    return (beta1, 1.0 - beta1, beta2, 1.0 - beta2, eps)


def adam_plain(p, g, m, v, scal, beta1=0.9, beta2=0.999, eps=1e-8,
               decay=False):
    """Plain PyTorch version of the kernels, on any device: the Pallas
    ``_adam_kernel`` (``decay=False``) or ``_adam_multi_kernel`` body.
    ``scal`` is ``[lr, beta1_pow, beta2_pow(, wd)]``. Returns new ``(p, m,
    v)``: p in its dtype, m and v float32."""
    lr, b1p, b2p = scal[0], scal[1], scal[2]
    g = g.float()
    m = beta1 * m.float() + (1 - beta1) * g
    v = beta2 * v.float() + (1 - beta2) * g * g
    mhat = m / (1 - b1p)
    vhat = v / (1 - b2p)
    pf = p.float()
    new_p = pf - lr * mhat / (torch.sqrt(vhat) + eps)
    if decay:
        new_p = new_p - (lr * scal[3]) * pf
    return new_p.to(p.dtype), m, v


def _write_back(p, m, v, new):
    p.copy_(new[0])
    m.copy_(new[1])
    v.copy_(new[2])


def _same_cuda_device(name, tensors):
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: every tensor must be on one CUDA device")


def _check_state(name, p, g, m, v, p_dtypes=(torch.float32,)):
    if not (p.shape == g.shape == m.shape == v.shape):
        raise ValueError(f"{name}: p, g, m, v shapes differ: {tuple(p.shape)}"
                         f", {tuple(g.shape)}, {tuple(m.shape)}, "
                         f"{tuple(v.shape)}")
    if p.dtype not in p_dtypes:
        raise TypeError(f"{name}: p must be one of {p_dtypes}, got "
                        f"{p.dtype}")
    if any(t.dtype != torch.float32 for t in (g, m, v)):
        raise TypeError(f"{name}: g, m and v must be float32")
    if any(not t.is_contiguous() for t in (p, g, m, v)):
        raise ValueError(f"{name}: p, g, m and v must be contiguous")


def fused_adam_update(p, g, m, v, lr, beta1_pow, beta2_pow, beta1=0.9,
                      beta2=0.999, eps=1e-8):
    """One tensor's Adam update (no decay), in place: p in float32 or
    bfloat16, g cast to float32, m and v float32. ``lr`` and the pows are
    0-d tensors or floats. On a CUDA tensor it launches the kernel; on a
    CPU tensor it writes :func:`adam_plain`'s result. Returns ``(p, m,
    v)``."""
    g = g.float()
    _check_state(NAME, p, g, m, v, (torch.float32, torch.bfloat16))
    scal = scalars(p.device, lr, beta1_pow, beta2_pow)
    if p.device.type == "cpu":
        _write_back(p, m, v, adam_plain(p, g, m, v, scal, beta1, beta2, eps))
        return p, m, v
    _same_cuda_device(NAME, (p, g, m, v))
    if p.numel():
        fn = function(NAME, _ARGTYPES)
        code = fn(device_index(p), p.data_ptr(), g.data_ptr(), m.data_ptr(),
                  v.data_ptr(), p.numel(), scal.data_ptr(),
                  *_hyper(beta1, beta2, eps), int(p.dtype == torch.bfloat16),
                  stream_of(p))
        check(NAME, fn, code)
        count_launch(NAME)
    return p, m, v


def fused_adam_update_multi(ps, gs, ms, vs, lr, beta1_pow, beta2_pow,
                            beta1=0.9, beta2=0.999, eps=1e-8,
                            weight_decay=0.0):
    """Every tensor's AdamW update through the many-tensor kernel, the
    decay folded in and the pows shared, in place: one launch per 256
    tensors. As in the reference, the update is float32: a parameter of
    another dtype is updated in a float32 copy and written back, and
    gradients and moments are cast to float32 (a cast moment is a new
    tensor, returned in its place). Returns ``(ps, ms, vs)``."""
    if not (len(ps) == len(gs) == len(ms) == len(vs)):
        raise ValueError(f"{MULTI_NAME}: {len(ps)} p, {len(gs)} g, "
                         f"{len(ms)} m and {len(vs)} v")
    if not ps:
        return list(ps), list(ms), list(vs)
    stage = [p.float() for p in ps]
    gs, ms, vs = ([t.float() for t in ts] for ts in (gs, ms, vs))
    for p, g, m, v in zip(stage, gs, ms, vs):
        _check_state(MULTI_NAME, p, g, m, v)
    dev = stage[0].device
    scal = scalars(dev, lr, beta1_pow, beta2_pow, weight_decay)
    if dev.type == "cpu":
        for p, g, m, v in zip(stage, gs, ms, vs):
            _write_back(p, m, v, adam_plain(p, g, m, v, scal, beta1, beta2,
                                            eps, decay=True))
    else:
        _same_cuda_device(MULTI_NAME, stage + gs + ms + vs + [scal])
        fn = function(MULTI_NAME, _MULTI_ARGTYPES)
        for at in range(0, len(stage), MULTI_MAX_TENSORS):
            part = slice(at, at + MULTI_MAX_TENSORS)
            k = len(stage[part])
            ptrs = [(ctypes.c_void_p * k)(*[t.data_ptr() for t in ts[part]])
                    for ts in (stage, gs, ms, vs)]
            sizes = (ctypes.c_longlong * k)(*[t.numel() for t in stage[part]])
            code = fn(device_index(stage[0]), k, *ptrs, sizes,
                      scal.data_ptr(), *_hyper(beta1, beta2, eps),
                      stream_of(stage[0]))
            check(MULTI_NAME, fn, code)
            count_launch(MULTI_NAME)
    for p, s in zip(ps, stage):
        if s is not p:
            p.copy_(s)
    return list(ps), ms, vs


def adam_step(p, g, m, v, lr, beta1_pow, beta2_pow, *, beta1=0.9,
              beta2=0.999, eps=1e-8, use_fused=None, inplace=False):
    """THE Adam rule of the per-parameter optimizer: the ``fused_adam``
    kernel (in place, m and v float32) where ``enabled("fused_adam")`` or
    ``use_fused`` forces it, else the same arithmetic in PyTorch ops, new
    tensors in the slots' dtypes (with ``inplace``, the moments written
    into ``m`` and ``v``, rounded as the new tensors are), p cast back to
    its dtype. Returns ``(new_p, new_m, new_v)``."""
    if use_fused is None:
        use_fused = enabled("fused_adam")
    if use_fused:
        return fused_adam_update(p, g, m.float(), v.float(), lr, beta1_pow,
                                 beta2_pow, beta1=beta1, beta2=beta2,
                                 eps=eps)
    if inplace:
        new_m = m.mul_(beta1).add_((1 - beta1) * g)
        new_v = v.mul_(beta2).add_((1 - beta2) * g * g)
    else:
        new_m = beta1 * m + (1 - beta1) * g
        new_v = beta2 * v + (1 - beta2) * g * g
    mhat = new_m / (1 - beta1_pow)
    vhat = new_v / (1 - beta2_pow)
    new_p = (p - lr * mhat / (torch.sqrt(vhat) + eps)).to(p.dtype)
    return new_p, new_m, new_v


def fused_adam_update_flat(p, g, m, v, lr, beta1_pow, beta2_pow, beta1=0.9,
                           beta2=0.999, eps=1e-8, weight_decay=0.0):
    """The many-tensor kernel's update over one arena-flat float32 buffer
    whose length is a multiple of 1024, in place. Returns ``(p, m, v)``."""
    _check_state(FLAT_NAME, p, g, m, v)
    if p.dim() != 1 or p.numel() % FLAT_ALIGN:
        raise ValueError(f"{FLAT_NAME}: wants 1-D buffers of a multiple of "
                         f"{FLAT_ALIGN} elements, got {tuple(p.shape)}")
    scal = scalars(p.device, lr, beta1_pow, beta2_pow, weight_decay)
    if p.device.type == "cpu":
        _write_back(p, m, v, adam_plain(p, g, m, v, scal, beta1, beta2, eps,
                                        decay=True))
        return p, m, v
    _same_cuda_device(FLAT_NAME, (p, g, m, v))
    if p.numel():
        fn = function(FLAT_NAME, _FLAT_ARGTYPES)
        code = fn(device_index(p), p.data_ptr(), g.data_ptr(), m.data_ptr(),
                  v.data_ptr(), p.numel(), scal.data_ptr(),
                  *_hyper(beta1, beta2, eps), stream_of(p))
        check(FLAT_NAME, fn, code)
        count_launch(FLAT_NAME)
    return p, m, v


def adam_step_flat(p, g, m, v, lr, beta1_pow, beta2_pow, *, beta1=0.9,
                   beta2=0.999, eps=1e-8, weight_decay=0.0, mask=None,
                   use_fused=None):
    """The Adam/AdamW rule over arena-flat buffers: the ``fused_adam_flat``
    kernel (in place) where ``enabled("fused_adam_multi")`` or
    ``use_fused`` forces it, the group is float32 and no member lacks a
    gradient (``mask is None``); else the per-parameter rule's arithmetic
    and casts, decay after the Adam term, with ``mask`` (bool, per
    element) keeping p, m and v where a member had no gradient. The plain
    path returns new tensors. Returns ``(new_p, new_m, new_v)``."""
    if use_fused is None:
        use_fused = enabled("fused_adam_multi")
    if use_fused and mask is None and p.dtype == torch.float32:
        return fused_adam_update_flat(p, g, m, v, lr, beta1_pow, beta2_pow,
                                      beta1=beta1, beta2=beta2, eps=eps,
                                      weight_decay=weight_decay)
    new_m = beta1 * m + (1 - beta1) * g
    new_v = beta2 * v + (1 - beta2) * g * g
    mhat = new_m / (1 - beta1_pow)
    vhat = new_v / (1 - beta2_pow)
    new_p = (p - lr * mhat / (torch.sqrt(vhat) + eps)).to(p.dtype)
    if weight_decay:
        new_p = (new_p - lr * weight_decay * p).to(p.dtype)
    if mask is not None:
        new_p = torch.where(mask, new_p, p)
        new_m = torch.where(mask, new_m, m)
        new_v = torch.where(mask, new_v, v)
    return new_p, new_m, new_v
