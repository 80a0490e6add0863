"""Training-mode batch norm over channels-last rows: the four kernels of
``csrc/batch_norm.cu``, their plain PyTorch versions, and the
``torch.autograd.Function`` that joins them.

Counterpart of ``paddle_tpu/ops/pallas/batch_norm.py``: ``_stats``,
``_normalize``, the two kernels of ``_bn_bwd``, the custom-vjp
``_batch_norm2`` and ``bn_channels_last``. ``x`` is viewed as ``(M, C)``
rows with the channel last, which for an NHWC activation is free; an NCHW
caller keeps the plain path of ``ops.nn_ops.batch_norm`` (a transpose
around the kernels would cost the pass they save).

Each wrapper launches its kernel on a CUDA tensor, or raises, and computes
its plain version on a CPU tensor. The per-channel arithmetic that the
reference does in jnp lines around its Pallas calls is done by the
kernels: the stats kernel's finishing pass also gives ``rstd``, ``scale``
and ``shift`` when it is handed the weight and bias, and the dx kernel
takes the weight, the two sums and the cotangents of ``mean`` and ``var``
as they are. A layer's forward is three launches and its backward three,
with no PyTorch operation between them: as a dozen small operations a
layer they cost a ResNet-50 step more host time than the kernels cost the
card.

The forward saves ``x``, the weight, ``mean`` and ``rstd`` only, never
``xhat``. All three outputs ``(out, mean, var)`` are differentiable: a
loss may consume the batch statistics directly.
"""
from __future__ import annotations

import ctypes

import torch

from . import check, count_launch, device_index, function, stream_of

STATS = "batch_norm_stats"
NORMALIZE = "batch_norm_normalize"
BWD_REDUCE = "batch_norm_bwd_reduce"
BWD_DX = "batch_norm_bwd_dx"
#: the reductions' row chunks: one workspace row of partial sums each
MAX_CHUNKS = 1024
MIN_ROWS_PER_CHUNK = 64

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    STATS: [_I] + [_P] * 3 + [ctypes.c_float] + [_P] * 6 + [_I] * 4 + [_P],
    NORMALIZE: [_I] + [_P] * 4 + [_I] * 3 + [_P],
    BWD_REDUCE: [_I] + [_P] * 7 + [_I] * 4 + [_P],
    BWD_DX: [_I] + [_P] * 10 + [_I] * 3 + [_P],
}
_DTYPES = (torch.float32, torch.bfloat16)


# -- plain versions ------------------------------------------------------------

def bn_stats_plain(x2, w=None, b=None, eps=None):
    """Per-channel ``(mean, var)`` of ``x2`` (M, C), each (1, C) float32:
    one pass of f32 sums of ``x - c`` and its square, ``c`` the first row
    (at a mean of 1000 the raw sum of squares loses the variance), the
    biased variance clamped at 0. With the affine ``w`` and ``b`` (C,)
    and ``eps`` also ``rstd = rsqrt(var + eps)``, ``scale = rstd w`` and
    ``shift = b - mean scale``: ``(mean, var, rstd, scale, shift)``."""
    m = x2.shape[0]
    xf = x2.float()
    c = xf[0:1].detach()
    xs = xf - c
    m_s = xs.sum(dim=0, keepdim=True) / m
    mean = m_s + c
    var = (xs.square().sum(dim=0, keepdim=True) / m - m_s.square()) \
        .clamp_min(0.0)
    if w is None:
        return mean, var
    rstd = torch.rsqrt(var + eps)
    scale = rstd * w.float().reshape(1, -1)
    shift = b.float().reshape(1, -1) - mean * scale
    return mean, var, rstd, scale, shift


def bn_normalize_plain(x2, scale, shift):
    """``x2 * scale + shift`` in float32, stored in ``x2``'s dtype."""
    return (x2.float() * scale + shift).to(x2.dtype)


def bn_bwd_reduce_plain(x2, g, mean, rstd):
    """``(dgamma, dbeta)``, each (1, C) float32: the sums over the rows of
    ``g * xhat`` and of ``g``."""
    gf = g.float()
    xhat = (x2.float() - mean) * rstd
    return ((gf * xhat).sum(dim=0, keepdim=True),
            gf.sum(dim=0, keepdim=True))


def bn_bwd_dx_plain(x2, g, mean, rstd, w, dgamma, dbeta, g_mean=None,
                    g_var=None):
    """``w rstd (g - dbeta / M - xhat dgamma / M) + g_mean / M + (2 / M)
    (x - mean) g_var`` in float32, stored in ``x2``'s dtype: the
    reference's ``_bn_bwd`` after its reduction. ``w`` is the affine
    weight (C,); ``dgamma`` and ``dbeta`` the (1, C) sums of
    :func:`bn_bwd_reduce_plain`; ``g_mean`` and ``g_var`` the cotangents of
    the mean and variance outputs, ``None`` for zeros."""
    m = x2.shape[0]
    xc = x2.float() - mean
    xhat = xc * rstd
    wr = w.float().reshape(1, -1) * rstd
    dx = wr * (g.float() - dbeta / m - xhat * (dgamma / m))
    if g_mean is not None:
        dx = dx + g_mean.float().reshape(1, -1) / m
    if g_var is not None:
        dx = dx + xc * (2.0 * g_var.float().reshape(1, -1) / m)
    return dx.to(x2.dtype)


# -- wrappers --------------------------------------------------------------------

def _rows(name, x2, **same_shape):
    """Checks shared by the four wrappers: ``x2`` is (M, C), f32 or bf16,
    with at least one row; the named tensors have its shape, dtype and
    device. True where the tensors lie on the CPU; on a CUDA device every
    one must be contiguous (the kernels read packed rows; a copy here
    would cost the pass they save)."""
    if x2.dim() != 2 or x2.shape[0] == 0 or x2.shape[1] == 0:
        raise ValueError(f"{name} wants x of shape (M, C) with M, C > 0, got "
                         f"{tuple(x2.shape)}")
    if x2.dtype not in _DTYPES:
        raise TypeError(f"{name}: x must be float32 or bfloat16, got "
                        f"{x2.dtype}")
    for k, t in same_shape.items():
        if t.shape != x2.shape or t.dtype != x2.dtype \
                or t.device != x2.device:
            raise ValueError(f"{name}: {k} must have x's shape, dtype and "
                             f"device, got {tuple(t.shape)} {t.dtype} "
                             f"{t.device}")
    if x2.device.type == "cpu":
        return True
    if x2.device.type != "cuda":
        raise ValueError(f"{name}: x must lie on a CUDA device or the CPU, "
                         f"got {x2.device}")
    for k, t in dict(same_shape, x=x2).items():
        if not t.is_contiguous():
            raise ValueError(f"{name}: {k} must be contiguous (M, C) rows; "
                             f"its strides are {t.stride()}")
    return False


def _channel(name, x2, **operands):
    """Each named per-channel operand as a contiguous float32 tensor of C
    elements, shaped (C,) or (1, C), on ``x2``'s device, or a raise;
    ``None`` passes."""
    c = x2.shape[1]
    out = []
    for k, t in operands.items():
        if t is None:
            out.append(None)
            continue
        if tuple(t.shape) not in ((c,), (1, c)) or \
                t.dtype != torch.float32 or t.device != x2.device:
            raise ValueError(f"{name}: {k} must be ({c},) or (1, {c}) "
                             f"float32 on {x2.device}, got {tuple(t.shape)} "
                             f"{t.dtype} {t.device}")
        out.append(t.contiguous())
    return out


def _ptr(t):
    return None if t is None else t.data_ptr()


def _chunks(m):
    return max(1, min(MAX_CHUNKS, -(-m // MIN_ROWS_PER_CHUNK)))


def _launch(name, x2, *args):
    fn = function(name, _ARGTYPES[name])
    code = fn(device_index(x2), *args, int(x2.dtype == torch.bfloat16),
              stream_of(x2))
    check(name, fn, code)
    count_launch(name)


def bn_stats(x2, w=None, b=None, eps=None):
    """Per-channel ``(mean, var)`` of ``x2`` (M, C), each (1, C) float32,
    or with the affine ``w`` and ``b`` (C,) float32 and ``eps``, ``(mean,
    var, rstd, scale, shift)``, as :func:`bn_stats_plain`: the stats
    kernel on a CUDA tensor (row chunks summed into an f32 workspace, then
    joined in a fixed order by the pass that also does the per-channel
    arithmetic: deterministic)."""
    cpu = _rows(STATS, x2)
    if (w is None) != (b is None) or (w is not None and eps is None):
        raise ValueError(f"{STATS}: w, b and eps come together or not at "
                         f"all")
    w, b = _channel(STATS, x2, w=w, b=b)
    if cpu:
        return bn_stats_plain(x2, w, b, eps)
    m, c = x2.shape
    outs = [torch.empty((1, c), dtype=torch.float32, device=x2.device)
            for _ in range(2 if w is None else 5)]
    chunks = _chunks(m)
    part = torch.empty((chunks, 2, c), dtype=torch.float32, device=x2.device)
    _launch(STATS, x2, x2.data_ptr(), _ptr(w), _ptr(b),
            0.0 if eps is None else float(eps),
            *map(_ptr, outs + [None] * (5 - len(outs))), part.data_ptr(),
            chunks, m, c)
    return tuple(outs)


def bn_normalize(x2, scale, shift):
    """``x2 * scale + shift`` with (1, C) or (C,) float32 ``scale`` and
    ``shift``, in ``x2``'s dtype, as :func:`bn_normalize_plain`."""
    cpu = _rows(NORMALIZE, x2)
    scale, shift = _channel(NORMALIZE, x2, scale=scale, shift=shift)
    if cpu:
        return bn_normalize_plain(x2, scale, shift)
    m, c = x2.shape
    y = torch.empty_like(x2)
    _launch(NORMALIZE, x2, x2.data_ptr(), scale.data_ptr(), shift.data_ptr(),
            y.data_ptr(), m, c)
    return y


def bn_bwd_reduce(x2, g, mean, rstd):
    """``(dgamma, dbeta)``, each (1, C) float32, as
    :func:`bn_bwd_reduce_plain`; deterministic like :func:`bn_stats`."""
    cpu = _rows(BWD_REDUCE, x2, g=g)
    mean, rstd = _channel(BWD_REDUCE, x2, mean=mean, rstd=rstd)
    if cpu:
        return bn_bwd_reduce_plain(x2, g, mean, rstd)
    m, c = x2.shape
    dg = torch.empty((1, c), dtype=torch.float32, device=x2.device)
    db = torch.empty_like(dg)
    chunks = _chunks(m)
    part = torch.empty((chunks, 2, c), dtype=torch.float32, device=x2.device)
    _launch(BWD_REDUCE, x2, x2.data_ptr(), g.data_ptr(), mean.data_ptr(),
            rstd.data_ptr(), dg.data_ptr(), db.data_ptr(), part.data_ptr(),
            chunks, m, c)
    return dg, db


def bn_bwd_dx(x2, g, mean, rstd, w, dgamma, dbeta, g_mean=None, g_var=None):
    """The input gradient, in ``x2``'s dtype, as :func:`bn_bwd_dx_plain`."""
    cpu = _rows(BWD_DX, x2, g=g)
    ops = _channel(BWD_DX, x2, mean=mean, rstd=rstd, w=w, dgamma=dgamma,
                   dbeta=dbeta, g_mean=g_mean, g_var=g_var)
    if cpu:
        return bn_bwd_dx_plain(x2, g, *(None if t is None else
                                       t.reshape(1, -1) for t in ops))
    m, c = x2.shape
    dx = torch.empty_like(x2)
    _launch(BWD_DX, x2, x2.data_ptr(), g.data_ptr(), *map(_ptr, ops),
            dx.data_ptr(), m, c)
    return dx


# -- forward, backward, autograd -------------------------------------------------

def _check_affine(x2, w, b):
    c = x2.shape[-1]
    for k, t in (("weight", w), ("bias", b)):
        if t.shape != (c,) or t.device != x2.device:
            raise ValueError(f"batch_norm: {k} must be ({c},) on {x2.device},"
                             f" got {tuple(t.shape)} on {t.device}")


def _f32(t):
    return t if t.dtype == torch.float32 else t.float()


def bn_forward(x2, w, b, eps):
    """``(out, mean, var, rstd)`` of training-mode batch norm over the rows
    of ``x2`` (the reference's ``_bn_fwd_res``): the stats kernel with its
    per-channel fold, then the normalize kernel."""
    _check_affine(x2, w, b)
    mean, var, rstd, scale, shift = bn_stats(x2, _f32(w), _f32(b), eps)
    return bn_normalize(x2, scale, shift), mean, var, rstd


def bn_backward(x2, w, mean, rstd, g, g_mean=None, g_var=None):
    """``(dx, dw, db)`` from the cotangents of all three outputs, ``None``
    standing for zeros (the reference's ``_bn_bwd``): the reduce kernel,
    then the dx kernel. ``dw`` and ``db`` take the weight's dtype."""
    dg, db = bn_bwd_reduce(x2, g, mean, rstd)
    dx = bn_bwd_dx(x2, g, mean, rstd, _f32(w), dg, db,
                   None if g_mean is None else _f32(g_mean),
                   None if g_var is None else _f32(g_var))
    return dx, dg[0].to(w.dtype), db[0].to(w.dtype)


class BatchNormFunction(torch.autograd.Function):
    """``(out, mean, var)`` of training-mode batch norm over the rows of
    ``x2`` (M, C), with autograd through all three: the counterpart of the
    Pallas module's ``_batch_norm2`` custom vjp. An output nobody used
    hands the backward ``None``, which stands for zeros."""

    @staticmethod
    def forward(ctx, x2, w, b, eps):
        out, mean, var, rstd = bn_forward(x2, w, b, eps)
        ctx.save_for_backward(x2, w, mean, rstd)
        ctx.set_materialize_grads(False)
        return out, mean, var

    @staticmethod
    def backward(ctx, g, g_mean, g_var):
        x2, w, mean, rstd = ctx.saved_tensors
        g = torch.zeros_like(x2) if g is None else g.contiguous()
        dx, dw, db = bn_backward(x2, w, mean, rstd, g, g_mean, g_var)
        return dx, dw, db, None


def batch_norm2(x2, w, b, eps):
    """``(out, mean, var)`` over the rows of ``x2`` (M, C); ``mean`` and
    ``var`` are (1, C) float32. Where autograd records it runs
    :class:`BatchNormFunction`, otherwise the forward alone."""
    if torch.is_grad_enabled() and (x2.requires_grad or w.requires_grad
                                    or b.requires_grad):
        return BatchNormFunction.apply(x2, w, b, eps)
    return bn_forward(x2, w, b, eps)[:3]


def bn_channels_last(x, w, b, epsilon):
    """Training-mode batch norm over the LAST axis of any-rank ``x``:
    ``(out, mean (C,), var (C,))``. ``x`` must be contiguous, so that its
    (M, C) view is free; a layout that would need a copy raises."""
    if not x.is_contiguous():
        raise ValueError(
            f"bn_channels_last: x of shape {tuple(x.shape)} and strides "
            f"{x.stride()} is not contiguous with the channel last; its "
            f"(M, C) view would need a copy")
    c = x.shape[-1]
    out, mean, var = batch_norm2(x.view(-1, c), w, b, epsilon)
    return out.view(x.shape), mean.reshape(c), var.reshape(c)
