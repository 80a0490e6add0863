"""Fused Adam: the kernels of ``csrc/fused_adam.cu`` (one tensor, many
tensors, an arena-flat buffer), their plain PyTorch versions, and the
update rules that dispatch to them.

Counterpart of ``paddle_tpu/ops/pallas/fused_adam.py``:
``fused_adam_update`` (its ``_adam_kernel``), ``fused_adam_update_multi``
and ``fused_adam_update_flat`` (its ``_adam_multi_kernel``), and the rules
``adam_step`` and ``adam_step_flat``. The kernels update ``p``, ``m`` and
``v`` in place, where the Pallas calls alias them
(``input_output_aliases``), and the wrappers return the updated tensors.
The scalars ``[lr, beta1_pow, beta2_pow, wd, skip]`` (the pows already
advanced for this step) reach a kernel as one float32 tensor on the card,
the Pallas kernels' SMEM scalars, so a step never waits on the host; a
set ``skip`` (the loss scaler's found-inf flag) makes a kernel write
nothing. Parameters and gradients may be bfloat16 (and a bfloat16 arena
group's moments): the kernels widen them on load and round once on
store, where the reference's wrappers cast whole tensors to float32 and
back.

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
# device, p, g, m, v, n, scal, hyper, p_bf16, g_bf16, stream
_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [
    ctypes.c_longlong, ctypes.c_void_p] + _HYPER + [ctypes.c_int] * 2 + [
    ctypes.c_void_p]
# device, count; arrays of p, g, m, v pointers, of sizes and of dtype
# codes; scal, hyper, stream
_MULTI_ARGTYPES = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 7 + \
    _HYPER + [ctypes.c_void_p]
# device, p, g, m, v, n, scal, hyper, bf16, stream
_FLAT_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [
    ctypes.c_longlong, ctypes.c_void_p] + _HYPER + [ctypes.c_int,
                                                    ctypes.c_void_p]
#: the dtypes the kernels take for p and g (m and v: float32, or the
#: group's dtype in the arena kernel)
DTYPES = (torch.float32, torch.bfloat16)


def scalars(device, *values):
    """``values`` (0-d tensors or Python floats) as one float32 tensor on
    ``device``, built on the device: no host-to-device copy, no sync. A
    tensor is read at each run (a CUDA graph replays the read), a float
    is a constant."""
    parts = [v.to(device=device, dtype=torch.float32).reshape(())
             if torch.is_tensor(v) else
             torch.full((), float(v), dtype=torch.float32, device=device)
             for v in values]
    return torch.stack(parts)


def _scal(device, lr, beta1_pow, beta2_pow, weight_decay, skip):
    """The kernels' scalars ``[lr, beta1_pow, beta2_pow, wd, skip]``;
    ``skip`` (None, or a device bool or float: the loss scaler's found-inf
    flag) set makes the kernels write nothing."""
    return scalars(device, lr, beta1_pow, beta2_pow, weight_decay,
                   0.0 if skip is None else skip)


def _hyper(beta1, beta2, eps):
    # 1 - beta rounded from the double, as the reference's weak-typed
    # Python floats are
    return (beta1, 1.0 - beta1, beta2, 1.0 - beta2, eps)


def adam_plain(p, g, m, v, scal, beta1=0.9, beta2=0.999, eps=1e-8,
               decay=False):
    """Plain PyTorch version of the kernels, on any device: the Pallas
    ``_adam_kernel`` (``decay=False``) or ``_adam_multi_kernel`` body, in
    float32 whatever the inputs' dtypes. ``scal`` is ``[lr, beta1_pow,
    beta2_pow(, wd(, skip))]``. Returns new ``(p, m, v)``: p in its dtype,
    m and v float32; with ``skip`` set, the inputs' values (p in its
    dtype, m and v as float32)."""
    lr, b1p, b2p = scal[0], scal[1], scal[2]
    g = g.float()
    m0, v0 = m.float(), v.float()
    m = beta1 * m0 + (1 - beta1) * g
    v = beta2 * v0 + (1 - beta2) * g * g
    mhat = m / (1 - b1p)
    vhat = v / (1 - b2p)
    pf = p.float()
    new_p = pf - lr * mhat / (torch.sqrt(vhat) + eps)
    if decay:
        new_p = new_p - (lr * scal[3]) * pf
    new_p = new_p.to(p.dtype)
    if scal.numel() > 4:
        skip = scal[4] != 0
        new_p = torch.where(skip, p, new_p)
        m = torch.where(skip, m0, m)
        v = torch.where(skip, v0, v)
    return new_p, m, v


def _write_back(p, m, v, new):
    p.copy_(new[0])
    m.copy_(new[1])
    v.copy_(new[2])


def _same_cuda_device(name, tensors):
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: every tensor must be on one CUDA device")


def _check_state(name, p, g, m, v, m_dtypes=(torch.float32,)):
    if not (p.shape == g.shape == m.shape == v.shape):
        raise ValueError(f"{name}: p, g, m, v shapes differ: {tuple(p.shape)}"
                         f", {tuple(g.shape)}, {tuple(m.shape)}, "
                         f"{tuple(v.shape)}")
    if p.dtype not in DTYPES or g.dtype not in DTYPES:
        raise TypeError(f"{name}: p and g must be float32 or bfloat16, got "
                        f"{p.dtype} and {g.dtype}")
    if m.dtype not in m_dtypes or v.dtype != m.dtype:
        raise TypeError(f"{name}: m and v must be one of {m_dtypes}, got "
                        f"{m.dtype} and {v.dtype}")
    if any(not t.is_contiguous() for t in (p, g, m, v)):
        raise ValueError(f"{name}: p, g, m and v must be contiguous")


def _bf16(t):
    return int(t.dtype == torch.bfloat16)


def fused_adam_update(p, g, m, v, lr, beta1_pow, beta2_pow, beta1=0.9,
                      beta2=0.999, eps=1e-8, skip=None):
    """One tensor's Adam update (no decay), in place: p and g in float32
    or bfloat16 (each read as it is), m and v float32. ``lr`` and the
    pows are 0-d tensors or floats; ``skip`` set (a device flag) leaves
    everything as it was. On a CUDA tensor it launches the kernel; on a
    CPU tensor it writes :func:`adam_plain`'s result. Returns ``(p, m,
    v)``."""
    _check_state(NAME, p, g, m, v)
    scal = _scal(p.device, lr, beta1_pow, beta2_pow, 0.0, skip)
    if p.device.type == "cpu":
        _write_back(p, m, v, adam_plain(p, g, m, v, scal, beta1, beta2, eps))
        return p, m, v
    _same_cuda_device(NAME, (p, g, m, v))
    if p.numel():
        fn = function(NAME, _ARGTYPES)
        code = fn(device_index(p), p.data_ptr(), g.data_ptr(), m.data_ptr(),
                  v.data_ptr(), p.numel(), scal.data_ptr(),
                  *_hyper(beta1, beta2, eps), _bf16(p), _bf16(g),
                  stream_of(p))
        check(NAME, fn, code)
        count_launch(NAME)
    return p, m, v


def fused_adam_update_multi(ps, gs, ms, vs, lr, beta1_pow, beta2_pow,
                            beta1=0.9, beta2=0.999, eps=1e-8,
                            weight_decay=0.0, skip=None):
    """Every tensor's AdamW update through the many-tensor kernel, the
    decay folded in and the pows shared, in place: one launch per 256
    tensors. Each p and g is float32 or bfloat16, read and written in its
    own dtype with float32 arithmetic between (the reference's wrapper
    casts them to float32 and back); moments that are not float32 are
    cast once (the reference's returned moments are float32), each a new
    tensor returned in its place. ``skip`` set leaves everything as it
    was. Returns ``(ps, ms, vs)``."""
    if not (len(ps) == len(gs) == len(ms) == len(vs)):
        raise ValueError(f"{MULTI_NAME}: {len(ps)} p, {len(gs)} g, "
                         f"{len(ms)} m and {len(vs)} v")
    if not ps:
        return list(ps), list(ms), list(vs)
    ms, vs = [m.float() for m in ms], [v.float() for v in vs]
    for p, g, m, v in zip(ps, gs, ms, vs):
        _check_state(MULTI_NAME, p, g, m, v)
    dev = ps[0].device
    scal = _scal(dev, lr, beta1_pow, beta2_pow, weight_decay, skip)
    if dev.type == "cpu":
        for p, g, m, v in zip(ps, gs, ms, vs):
            _write_back(p, m, v, adam_plain(p, g, m, v, scal, beta1, beta2,
                                            eps, decay=True))
        return list(ps), ms, vs
    _same_cuda_device(MULTI_NAME, list(ps) + list(gs) + ms + vs + [scal])
    fn = function(MULTI_NAME, _MULTI_ARGTYPES)
    for at in range(0, len(ps), MULTI_MAX_TENSORS):
        part = slice(at, at + MULTI_MAX_TENSORS)
        k = len(ps[part])
        ptrs = [(ctypes.c_void_p * k)(*[t.data_ptr() for t in ts[part]])
                for ts in (ps, gs, ms, vs)]
        sizes = (ctypes.c_longlong * k)(*[t.numel() for t in ps[part]])
        dts = (ctypes.c_ubyte * k)(*[_bf16(p) | 2 * _bf16(g) for p, g in
                                     zip(ps[part], gs[part])])
        code = fn(device_index(ps[0]), k, *ptrs, sizes, dts,
                  scal.data_ptr(), *_hyper(beta1, beta2, eps),
                  stream_of(ps[0]))
        check(MULTI_NAME, fn, code)
        count_launch(MULTI_NAME)
    return list(ps), ms, vs


def adam_step(p, g, m, v, lr, beta1_pow, beta2_pow, *, beta1=0.9,
              beta2=0.999, eps=1e-8, use_fused=None, inplace=False,
              skip=None):
    """THE Adam rule of the per-parameter optimizer: the ``fused_adam``
    kernel (in place, m and v float32: a moment of another dtype is cast
    once and returned in its place) where ``enabled("fused_adam")`` or
    ``use_fused`` forces it, else the same arithmetic in PyTorch ops. The
    plain rule computes the moments in their own and the gradient's dtype,
    as the reference does (a bfloat16 moment of a bfloat16 gradient in
    bfloat16), and the bias correction and update in float32, as the
    reference's float32 learning rate and pows promote them, with one
    rounding into p's dtype. With ``inplace`` it writes the moments into
    ``m`` and ``v`` where their dtype holds the result, rounded as the new
    tensors are. ``skip`` (the loss scaler's device flag, or None) reaches
    the kernel only, which writes nothing where it is set; the plain
    arithmetic returns its new tensors for the optimizer to select
    (``Optimizer._select``). Returns ``(new_p, new_m, new_v)``."""
    if use_fused is None:
        use_fused = enabled("fused_adam")
    if use_fused:
        return fused_adam_update(p, g, m.float(), v.float(), lr, beta1_pow,
                                 beta2_pow, beta1=beta1, beta2=beta2,
                                 eps=eps, skip=skip)
    keep = inplace and m.dtype == torch.result_type(m, g)
    if keep:
        new_m = m.mul_(beta1).add_((1 - beta1) * g)
        new_v = v.mul_(beta2).add_((1 - beta2) * g * g)
    else:
        new_m = beta1 * m + (1 - beta1) * g
        new_v = beta2 * v + (1 - beta2) * g * g
    mhat = new_m.float() / (1 - beta1_pow)
    vhat = new_v.float() / (1 - beta2_pow)
    new_p = (p.float() - lr * mhat / (torch.sqrt(vhat) + eps)).to(p.dtype)
    return new_p, new_m, new_v


def fused_adam_update_flat(p, g, m, v, lr, beta1_pow, beta2_pow, beta1=0.9,
                           beta2=0.999, eps=1e-8, weight_decay=0.0,
                           skip=None):
    """The many-tensor kernel's update over one arena-flat group whose
    length is a multiple of 1024, in place: p, g, m and v all float32 or
    all bfloat16 (the arena keeps a bfloat16 group's moments in
    bfloat16), float32 arithmetic, one rounding on store. ``skip`` set
    leaves everything as it was. Returns ``(p, m, v)``."""
    _check_state(FLAT_NAME, p, g, m, v, m_dtypes=(p.dtype,))
    if g.dtype != p.dtype:
        raise TypeError(f"{FLAT_NAME}: g must have the group's dtype "
                        f"{p.dtype}, got {g.dtype}")
    if p.dim() != 1 or p.numel() % FLAT_ALIGN:
        raise ValueError(f"{FLAT_NAME}: wants 1-D buffers of a multiple of "
                         f"{FLAT_ALIGN} elements, got {tuple(p.shape)}")
    scal = _scal(p.device, lr, beta1_pow, beta2_pow, weight_decay, skip)
    if p.device.type == "cpu":
        _write_back(p, m, v, adam_plain(p, g, m, v, scal, beta1, beta2, eps,
                                        decay=True))
        return p, m, v
    _same_cuda_device(FLAT_NAME, (p, g, m, v))
    if p.numel():
        fn = function(FLAT_NAME, _FLAT_ARGTYPES)
        code = fn(device_index(p), p.data_ptr(), g.data_ptr(), m.data_ptr(),
                  v.data_ptr(), p.numel(), scal.data_ptr(),
                  *_hyper(beta1, beta2, eps), _bf16(p), stream_of(p))
        check(FLAT_NAME, fn, code)
        count_launch(FLAT_NAME)
    return p, m, v


def adam_step_flat(p, g, m, v, lr, beta1_pow, beta2_pow, *, beta1=0.9,
                   beta2=0.999, eps=1e-8, weight_decay=0.0, mask=None,
                   use_fused=None, skip=None):
    """The Adam/AdamW rule over arena-flat buffers: the ``fused_adam_flat``
    kernel (in place) where ``enabled("fused_adam_multi")`` or
    ``use_fused`` forces it and no member lacks a gradient (``mask is
    None``), for a float32 or a bfloat16 group; else :func:`adam_step`'s
    plain arithmetic and casts, decay after the Adam term, with ``mask``
    (bool, per element) keeping p, m and v where a member had no gradient.
    ``skip`` reaches the kernel only, as in :func:`adam_step`; the plain
    path returns new tensors. Returns ``(new_p, new_m, new_v)``."""
    if use_fused is None:
        use_fused = enabled("fused_adam_multi")
    if use_fused and mask is None:
        return fused_adam_update_flat(p, g, m, v, lr, beta1_pow, beta2_pow,
                                      beta1=beta1, beta2=beta2, eps=eps,
                                      weight_decay=weight_decay, skip=skip)
    new_p, new_m, new_v = adam_step(p, g, m, v, lr, beta1_pow, beta2_pow,
                                    beta1=beta1, beta2=beta2, eps=eps,
                                    use_fused=False)
    if weight_decay:
        new_p = (new_p - lr * weight_decay * p.float()).to(p.dtype)
    if mask is not None:
        new_p = torch.where(mask, new_p, p)
        new_m = torch.where(mask, new_m, m)
        new_v = torch.where(mask, new_v, v)
    return new_p, new_m, new_v
