"""Flash attention: the forward kernel ``csrc/flash_attention.cu``, the
backward kernels ``csrc/flash_attention_bwd.cu`` (dQ, and dK with dV),
their plain PyTorch versions, and the ``torch.autograd.Function`` that
joins them.

Counterpart of ``paddle_tpu/ops/pallas/flash_attention.py``
(``flash_attention``, ``_flash_fwd_res`` with its ``_fwd_kernel``,
``_flash_bwd`` with ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel``, and the
custom-vjp ``_flash``). The semantics are the Pallas kernels', not plain
sdpa's: a bool mask becomes an additive ``-1e30`` bias, and a query row
whose every key is masked that way gets probability 0 everywhere and
output 0 (plain sdpa's ``-1e9`` would give a uniform average instead).

Attention dropout is drawn inside the kernels. The TPU's random bits
cannot be reproduced, so the keep decision is a counter hash of ``(seed0,
seed1, batch*head, row, col)`` (``csrc/common.cuh``), which the forward
and both backward kernels regenerate, and which
:func:`dropout_keep_mask` computes bit for bit with int64 tensor
arithmetic. As in the Pallas kernels, dropout applies to the
probabilities in the ``p @ v`` product and to ``dp`` in the backward; the
normalizer ``l`` stays undropped. The plain versions also take an explicit
``keep`` mask, so that the tests can hand them the JAX package's own.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ... import random as prandom
from . import check, count_launch, device_index, function, stream_of

NAME = "flash_attention_fwd"
BWD_DQ = "flash_attention_bwd_dq"
BWD_DKV = "flash_attention_bwd_dkv"
NEG_INF = -1e30
HEAD_DIMS = (64, 128)

_DROPOUT_ARGTYPES = [ctypes.c_int, ctypes.c_uint, ctypes.c_uint,
                     ctypes.c_uint, ctypes.c_float]
_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 +
             [ctypes.c_longlong] * 12 +
             [ctypes.c_int] * 3 + [ctypes.c_float] + [ctypes.c_int] * 2 +
             _DROPOUT_ARGTYPES + [ctypes.c_void_p])
_BWD_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 11 +
                 [ctypes.c_int] * 5 + [ctypes.c_void_p] +
                 [ctypes.c_int] * 3 + [ctypes.c_float] + [ctypes.c_int] * 2 +
                 _DROPOUT_ARGTYPES + [ctypes.c_void_p])
_MODES = {None: 0, "key": 1, "full": 2}
_M32 = 0xFFFFFFFF


# -- dropout -----------------------------------------------------------------

def dropout_threshold(dropout_p):
    """The 32-bit threshold below which an element is dropped, as the
    Pallas wrapper computes it: ``min(int(p * 2^32), 2^32 - 1)``."""
    return min(int(dropout_p * 4294967296.0), 4294967295)


def _mul32(a, c):
    """``a * c mod 2^32`` for int64 ``a`` in [0, 2^32) and a constant ``c``
    below 2^32, without overflowing int64: split ``a`` into 16-bit
    halves."""
    return ((a & 0xFFFF) * c + ((((a >> 16) * c) & 0xFFFF) << 16)) & _M32


def _absorb(h, v):
    h = _mul32(h ^ v, 0x9E3779B9)
    h = h ^ (h >> 15)
    h = _mul32(h, 0xB40E609F)
    return h ^ (h >> 13)


def dropout_keep_mask(seed, bh, sq, sk, dropout_p, device="cpu"):
    """The keep mask the kernels draw, as a bool tensor (bh, sq, sk): the
    counter hash of ``csrc/common.cuh`` at every (batch*head, row, col),
    in int64 arithmetic masked to 32 bits."""
    s0, s1 = (int(s) & _M32 for s in seed)
    ar = lambda n: torch.arange(n, dtype=torch.int64, device=device)
    # seed1 stays a Python int until the first xor: no host-to-device copy
    h = _absorb(s1, ar(bh).view(-1, 1, 1))
    h = _absorb(h, ar(sq).view(1, -1, 1))
    h = _absorb(h, ar(sk).view(1, 1, -1)) ^ s0
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return h >= dropout_threshold(dropout_p)


# -- shapes and masks ----------------------------------------------------------

def _canon_mask(attn_mask, b, h, sq, sk):
    """The additive f32 bias as ``(mask3, mode, mb, mh)``: ``mask3`` is
    contiguous ``(mb*mh, 1 or Sq, Sk)``; ``mode`` is None, "key" (one
    row broadcast over queries) or "full". Shapes that do not broadcast
    to ``(B, H, Sq, Sk)`` that way raise."""
    if attn_mask is None:
        return None, None, 1, 1
    m = attn_mask.detach()
    if m.dtype == torch.bool:
        m = torch.where(m, 0.0, NEG_INF)
    m = m.to(torch.float32)
    if m.dim() > 4:
        raise ValueError(f"flash_attention: mask of rank {m.dim()}")
    while m.dim() < 4:
        m = m.unsqueeze(0)
    mb, mh, msq, msk = m.shape
    if msk != sk or mb not in (1, b) or mh not in (1, h) or \
            msq not in (1, sq):
        raise ValueError(
            f"flash_attention: mask shape {tuple(attn_mask.shape)} does not "
            f"broadcast as a key or full mask to {(b, h, sq, sk)}")
    mode = "key" if msq == 1 else "full"
    return m.reshape(mb * mh, msq, sk).contiguous(), mode, mb, mh


def _check(q, k, v):
    if q.dim() != 4:
        raise ValueError(f"flash_attention wants (B, H, S, D), got "
                         f"{tuple(q.shape)}")
    b, h, _, d = q.shape
    sk = k.shape[2]
    if k.shape != (b, h, sk, d) or v.shape != (b, h, sk, d):
        raise ValueError(f"flash_attention: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if sk == 0:
        raise ValueError("flash_attention: no keys")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("flash_attention: q, k and v must share a dtype")


def _check_cuda(q, k, v, cm, *others):
    if q.device.type != "cuda" or any(t.device != q.device
                                      for t in (k, v) + others):
        raise ValueError(f"flash_attention: q, k, v and the saved tensors "
                         f"must share one CUDA device, got {q.device}, "
                         f"{k.device}, {v.device}")
    if q.shape[3] not in HEAD_DIMS:
        raise ValueError(f"flash_attention: the kernel takes head dim "
                         f"{HEAD_DIMS}, got {q.shape[3]}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_attention: q, k, v must be float32 or "
                        f"bfloat16, got {q.dtype}")
    if cm[0] is not None and cm[0].device != q.device:
        raise ValueError("flash_attention: mask on another device than q")


def _scale(scale, d):
    return scale if scale is not None else 1.0 / math.sqrt(d)


def _strides(t):
    return t.stride(0), t.stride(1), t.stride(2)


def _dropout_args(dropout_p, seed):
    if dropout_p <= 0.0:
        return 0, 0, 0, 0, 1.0
    return (1, dropout_threshold(dropout_p), int(seed[0]) & _M32,
            int(seed[1]) & _M32, 1.0 - dropout_p)


def _plain_keep(keep, seed, b, h, sq, sk, dropout_p, device):
    """The keep mask as (B, H, Sq, Sk) bool: the caller's explicit ``keep``
    (B*H, Sq, Sk) float 0/1, else the kernels' hash."""
    if keep is None:
        keep = dropout_keep_mask(seed, b * h, sq, sk, dropout_p, device)
    elif tuple(keep.shape) != (b * h, sq, sk):
        raise ValueError(f"flash_attention: keep must be {(b * h, sq, sk)}, "
                         f"got {tuple(keep.shape)}")
    keep = keep.reshape(b, h, sq, sk).to(device=device)
    return keep if keep.dtype == torch.bool else keep > 0.5


def _plain_scores(q, k, cm, causal, scale):
    """(s, valid): the scaled, masked scores in f32 with -1e30 where the
    causal mask forbids, and the positions it allows (None: all)."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    mask3, mode, mb, mh = cm
    s = torch.matmul(q.float() * _scale(scale, d),
                     k.float().transpose(-1, -2))
    if mode is not None:
        s = s + mask3.reshape(mb, mh, mask3.shape[1], sk)
    valid = None
    if causal:
        valid = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril()
        s = torch.where(valid, s, NEG_INF)
    return s, valid


# -- forward -------------------------------------------------------------------

def _fwd_plain(q, k, v, cm, causal, scale, dropout_p, seed, keep):
    b, h, sq, d = q.shape
    sk = k.shape[2]
    s, _ = _plain_scores(q, k, cm, causal, scale)
    m = s.amax(dim=-1, keepdim=True)
    m_safe = torch.where(m <= NEG_INF, 0.0, m)
    p = torch.where(s <= NEG_INF, 0.0, torch.exp(s - m_safe))
    l = p.sum(dim=-1, keepdim=True)
    if dropout_p > 0.0:
        kp = _plain_keep(keep, seed, b, h, sq, sk, dropout_p, q.device)
        p = torch.where(kp, p / (1.0 - dropout_p), 0.0)
    out = torch.matmul(p, v.float()) / l.clamp_min(1e-20)
    return (out.to(q.dtype), m_safe.reshape(b * h, sq),
            l.reshape(b * h, sq))


def _fwd(q, k, v, cm, causal, scale, dropout_p, seed):
    """The forward on canonical mask ``cm``: the kernel on a CUDA tensor,
    the plain version on a CPU one."""
    if q.device.type == "cpu":
        return _fwd_plain(q, k, v, cm, causal, scale, dropout_p, seed, None)
    _check_cuda(q, k, v, cm)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    mask3, mode, mb, mh = cm
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    out = torch.empty((b, sq, h, d), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    m = torch.empty((b * h, sq), dtype=torch.float32, device=q.device)
    l = torch.empty((b * h, sq), dtype=torch.float32, device=q.device)
    if b * h * sq == 0:
        return out, m, l
    fn = function(NAME, _ARGTYPES)
    code = fn(device_index(q), q.data_ptr(), k.data_ptr(), v.data_ptr(),
              None if mask3 is None else mask3.data_ptr(), out.data_ptr(),
              m.data_ptr(), l.data_ptr(), b, h, sq, sk, d,
              *_strides(q), *_strides(k), *_strides(v), *_strides(out),
              _MODES[mode], mb, mh, float(_scale(scale, d)),
              int(bool(causal)), int(q.dtype == torch.bfloat16),
              *_dropout_args(dropout_p, seed), stream_of(q))
    check(NAME, fn, code)
    count_launch(NAME)
    return out, m, l


def flash_attention_fwd_plain(q, k, v, attn_mask=None, causal=False,
                              scale=None, dropout_p=0.0, seed=(0, 0),
                              keep=None):
    """Plain PyTorch version of the forward kernel, on any device and any
    head dim. Returns ``(out, m, l)``: ``out`` (B, H, Sq, D) in q's
    dtype, ``m`` and ``l`` (B*H, Sq) f32 — the row max (0 where every key
    is masked) and the undropped softmax normalizer under that max. With
    ``dropout_p > 0`` the probabilities in ``p @ v`` are dropped by the
    kernels' hash mask at ``seed``, or by ``keep`` ((B*H, Sq, Sk) float
    0/1) where it is given."""
    _check(q, k, v)
    b, h, sq, _ = q.shape
    cm = _canon_mask(attn_mask, b, h, sq, k.shape[2])
    return _fwd_plain(q, k, v, cm, causal, scale, dropout_p, seed, keep)


def flash_attention_fwd(q, k, v, attn_mask=None, causal=False, scale=None,
                        dropout_p=0.0, seed=(0, 0)):
    """Flash attention forward over (B, H, S, D). On a CUDA tensor it
    launches the kernel (head dim 64 or 128, f32 or bf16 q/k/v, any
    strides with a contiguous head dim, an f32 mask, dropout at rate
    ``dropout_p`` from the two 32-bit words of ``seed``); on a CPU tensor
    it computes :func:`flash_attention_fwd_plain`. Returns ``(out, m,
    l)`` as the plain version does; the kernel's ``out`` is laid out as
    (B, Sq, H, D) in memory, so merging the heads back is a view."""
    _check(q, k, v)
    b, h, sq, _ = q.shape
    cm = _canon_mask(attn_mask, b, h, sq, k.shape[2])
    return _fwd(q, k, v, cm, causal, scale, dropout_p, seed)


# -- backward ------------------------------------------------------------------

def _bwd_plain(q, k, v, cm, out, m, l, g, causal, scale, dropout_p, seed,
               keep):
    b, h, sq, d = q.shape
    sk = k.shape[2]
    s_ = _scale(scale, d)
    s, valid = _plain_scores(q, k, cm, causal, scale)
    linv = 1.0 / l.reshape(b, h, sq, 1).clamp_min(1e-20)
    p = torch.exp(s - m.reshape(b, h, sq, 1)) * linv
    if valid is not None:
        p = torch.where(valid, p, 0.0)
    do = g.float()
    delta = (do * out.float()).sum(dim=-1, keepdim=True)
    dp = torch.matmul(do, v.float().transpose(-1, -2))
    pd = p
    if dropout_p > 0.0:
        kp = _plain_keep(keep, seed, b, h, sq, sk, dropout_p, q.device)
        pd = torch.where(kp, p / (1.0 - dropout_p), 0.0)
        dp = torch.where(kp, dp / (1.0 - dropout_p), 0.0)
    ds = p * (dp - delta)
    dq = torch.matmul(ds, k.float()) * s_
    dk = torch.matmul(ds.transpose(-1, -2), q.float() * s_)
    dv = torch.matmul(pd.transpose(-1, -2), do)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _bwd_setup(q, k, v, cm, out, m, l, g, causal, scale, dropout_p, seed):
    """The CUDA backward up to its launches: checks, ``delta = rowsum(g *
    out)`` (one reduction before the kernels, as the Pallas module
    computes it outside its kernels), the gradients' storage and the C
    arguments. Returns ``(dq, dk, dv, launch)``; ``launch(name)`` launches
    the kernel ``BWD_DQ`` (fills dq) or ``BWD_DKV`` (fills dk and dv) and
    counts it."""
    _check_cuda(q, k, v, cm, out, m, l, g)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    mask3, mode, mb, mh = cm
    q, k, v, g = (t if t.stride(-1) == 1 else t.contiguous()
                  for t in (q, k, v, g))
    g = g.to(q.dtype)
    delta = (g.float() * out.float()).sum(dim=-1).reshape(b * h, sq)
    m, l = m.contiguous(), l.contiguous()
    dq = torch.empty((b, h, sq, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, h, sk, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, h, sk, d), dtype=v.dtype, device=q.device)
    strides = (ctypes.c_longlong * 21)(
        *_strides(q), *_strides(k), *_strides(v), *_strides(g),
        *_strides(dq), *_strides(dk), *_strides(dv))
    dims = (b, h, sq, sk, d, strides, _MODES[mode], mb, mh,
            float(_scale(scale, d)), int(bool(causal)),
            int(q.dtype == torch.bfloat16), *_dropout_args(dropout_p, seed))

    def launch(name):
        # pointers and the stream are read at launch time from tensors this
        # closure holds, so a launch never writes into freed storage and a
        # CUDA graph being captured on the current stream records it
        if b * h * sq == 0:
            return
        outs = ((dq.data_ptr(), None, None) if name == BWD_DQ
                else (None, dk.data_ptr(), dv.data_ptr()))
        fn = function(name, _BWD_ARGTYPES)
        code = fn(device_index(q), q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  None if mask3 is None else mask3.data_ptr(), m.data_ptr(),
                  l.data_ptr(), delta.data_ptr(), g.data_ptr(), *outs, *dims,
                  stream_of(q))
        check(name, fn, code)
        count_launch(name)

    return dq, dk, dv, launch


def _bwd(q, k, v, cm, out, m, l, g, causal, scale, dropout_p, seed):
    """The backward on canonical mask ``cm``: the dQ and dK/dV kernels on a
    CUDA tensor, the plain version on a CPU one."""
    if q.device.type == "cpu":
        return _bwd_plain(q, k, v, cm, out, m, l, g, causal, scale,
                          dropout_p, seed, None)
    dq, dk, dv, launch = _bwd_setup(q, k, v, cm, out, m, l, g, causal,
                                    scale, dropout_p, seed)
    if q.shape[0] * q.shape[1] * q.shape[2] == 0:
        return dq, dk.zero_(), dv.zero_()
    launch(BWD_DQ)
    launch(BWD_DKV)
    return dq, dk, dv


def flash_attention_bwd_plain(q, k, v, attn_mask, out, m, l, g,
                              causal=False, scale=None, dropout_p=0.0,
                              seed=(0, 0), keep=None):
    """Plain PyTorch version of the two backward kernels, on any device:
    the gradients ``(dq, dk, dv)`` in the inputs' dtypes, from the
    forward's ``out``, ``m``, ``l`` and the output gradient ``g``. ``p`` is
    recomputed as ``exp(s - m) / l`` (never with a folded log-sum-exp);
    ``seed`` and ``keep`` as in :func:`flash_attention_fwd_plain`."""
    _check(q, k, v)
    b, h, sq, _ = q.shape
    cm = _canon_mask(attn_mask, b, h, sq, k.shape[2])
    return _bwd_plain(q, k, v, cm, out, m, l, g, causal, scale, dropout_p,
                      seed, keep)


def flash_attention_bwd(q, k, v, attn_mask, out, m, l, g, causal=False,
                        scale=None, dropout_p=0.0, seed=(0, 0)):
    """Flash attention's gradients ``(dq, dk, dv)``. On a CUDA tensor it
    computes ``delta = rowsum(g * out)`` and launches the dQ kernel and the
    dK/dV kernel (what the forward kernel takes, plus ``g`` in any strides
    with a contiguous head dim); on a CPU tensor it computes
    :func:`flash_attention_bwd_plain`. The mask gets no gradient."""
    _check(q, k, v)
    b, h, sq, _ = q.shape
    cm = _canon_mask(attn_mask, b, h, sq, k.shape[2])
    return _bwd(q, k, v, cm, out, m, l, g, causal, scale, dropout_p, seed)


class FlashAttentionFunction(torch.autograd.Function):
    """Flash attention with autograd: the counterpart of the Pallas
    module's ``_flash`` custom vjp. The forward saves q, k, v, the
    canonical mask, ``out``, the row statistics ``m`` and ``l`` and the
    dropout seed; the backward runs the dQ and dK/dV kernels (the plain
    backward on a CPU tensor). The mask, an input-derived bias, gets no
    gradient, as in the reference."""

    @staticmethod
    def forward(ctx, q, k, v, mask3, mode, mb, mh, causal, scale, dropout_p,
                seed0, seed1):
        cm = (mask3, mode, mb, mh)
        seed = (seed0, seed1)
        out, m, l = _fwd(q, k, v, cm, causal, scale, dropout_p, seed)
        ctx.save_for_backward(q, k, v, mask3, out, m, l)
        ctx.args = (mode, mb, mh, causal, scale, dropout_p, seed)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, mask3, out, m, l = ctx.saved_tensors
        mode, mb, mh, causal, scale, dropout_p, seed = ctx.args
        dq, dk, dv = _bwd(q, k, v, (mask3, mode, mb, mh), out, m, l, g,
                          causal, scale, dropout_p, seed)
        return (dq, dk, dv) + (None,) * 9


def flash_attention(q, k, v, attn_mask=None, causal=False, scale=None,
                    dropout_p=0.0, training=False):
    """The port's counterpart of ``paddle_tpu.ops.pallas.flash_attention``:
    returns the attention output. With ``training=True`` and
    ``dropout_p > 0`` the probabilities are dropped inside the kernels,
    from a fresh seed pair (:func:`paddle_tpu_torch.random.next_seed_pair`)
    per call. Where autograd records (grad mode on and q, k or v requires
    grad) it runs :class:`FlashAttentionFunction`; otherwise the forward
    alone, with no graph."""
    _check(q, k, v)
    b, h, sq, _ = q.shape
    p_drop = float(dropout_p) if training else 0.0
    if not 0.0 <= p_drop < 1.0:
        raise ValueError(f"flash_attention: dropout_p must be in [0, 1), "
                         f"got {dropout_p}")
    seed = prandom.next_seed_pair() if p_drop > 0.0 else (0, 0)
    cm = _canon_mask(attn_mask, b, h, sq, k.shape[2])
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFunction.apply(q, k, v, *cm, causal, scale,
                                            p_drop, *seed)
    out, _, _ = _fwd(q, k, v, cm, causal, scale, p_drop, seed)
    return out
