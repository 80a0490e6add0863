"""Forward flash attention: the CUDA kernel ``csrc/flash_attention.cu`` and
its plain PyTorch version.

Counterpart of ``paddle_tpu/ops/pallas/flash_attention.py``
(``flash_attention``, ``_flash_fwd_res`` and its ``_fwd_kernel``), for
inference: no in-kernel dropout and no backward, which belong to the
training slice. The semantics are the Pallas kernel's, not plain sdpa's:
a bool mask becomes an additive ``-1e30`` bias, and a query row whose
every key is masked that way gets probability 0 everywhere and output 0
(plain sdpa's ``-1e9`` would give a uniform average instead).
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import check, count_launch, device_index, function, stream_of

NAME = "flash_attention_fwd"
NEG_INF = -1e30
HEAD_DIMS = (64, 128)

_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 +
             [ctypes.c_longlong] * 12 +
             [ctypes.c_int] * 3 + [ctypes.c_float] + [ctypes.c_int] * 2 +
             [ctypes.c_void_p])
_MODES = {None: 0, "key": 1, "full": 2}


def _canon_mask(attn_mask, b, h, sq, sk):
    """The additive f32 bias as ``(mask3, mode, mb, mh)``: ``mask3`` is
    contiguous ``(mb*mh, 1 or Sq, Sk)``; ``mode`` is None, "key" (one
    row broadcast over queries) or "full". Shapes that do not broadcast
    to ``(B, H, Sq, Sk)`` that way raise."""
    if attn_mask is None:
        return None, None, 1, 1
    m = attn_mask
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


def flash_attention_fwd_plain(q, k, v, attn_mask=None, causal=False,
                              scale=None):
    """Plain PyTorch version of the kernel, on any device and any head
    dim. Returns ``(out, m, l)``: ``out`` (B, H, Sq, D) in q's dtype,
    ``m`` and ``l`` (B*H, Sq) f32 — the row max (0 where every key is
    masked) and the softmax normalizer under that max."""
    _check(q, k, v)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    mask3, mode, mb, mh = _canon_mask(attn_mask, b, h, sq, sk)
    s_ = scale if scale is not None else 1.0 / math.sqrt(d)
    s = torch.matmul(q.float() * s_, k.float().transpose(-1, -2))
    if mode is not None:
        s = s + mask3.reshape(mb, mh, mask3.shape[1], sk)
    if causal:
        keep = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril()
        s = torch.where(keep, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    m_safe = torch.where(m <= NEG_INF, 0.0, m)
    p = torch.where(s <= NEG_INF, 0.0, torch.exp(s - m_safe))
    l = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p, v.float()) / l.clamp_min(1e-20)
    return (out.to(q.dtype), m_safe.reshape(b * h, sq),
            l.reshape(b * h, sq))


def _strides(t):
    return t.stride(0), t.stride(1), t.stride(2)


def flash_attention_fwd(q, k, v, attn_mask=None, causal=False, scale=None):
    """Flash attention forward over (B, H, S, D). On a CUDA tensor it
    launches the kernel (head dim 64 or 128, f32 or bf16 q/k/v, any
    strides with a contiguous head dim, an f32 mask); on a CPU tensor it
    computes :func:`flash_attention_fwd_plain`. Returns ``(out, m, l)``
    as the plain version does; the kernel's ``out`` is laid out as
    (B, Sq, H, D) in memory, so merging the heads back is a view."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, attn_mask, causal, scale)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if q.device.type != "cuda" or k.device != q.device \
            or v.device != q.device:
        raise ValueError(f"flash_attention: q, k and v must share one CUDA "
                         f"device, got {q.device}, {k.device}, {v.device}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: the kernel takes head dim "
                         f"{HEAD_DIMS}, got {d}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_attention: q, k, v must be float32 or "
                        f"bfloat16, got {q.dtype}")
    mask3, mode, mb, mh = _canon_mask(attn_mask, b, h, sq, sk)
    if mask3 is not None and mask3.device != q.device:
        raise ValueError("flash_attention: mask on another device than q")
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    out = torch.empty((b, sq, h, d), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    m = torch.empty((b * h, sq), dtype=torch.float32, device=q.device)
    l = torch.empty((b * h, sq), dtype=torch.float32, device=q.device)
    if b * h * sq == 0:
        return out, m, l
    s_ = scale if scale is not None else 1.0 / math.sqrt(d)
    fn = function(NAME, _ARGTYPES)
    code = fn(device_index(q), q.data_ptr(), k.data_ptr(), v.data_ptr(),
              None if mask3 is None else mask3.data_ptr(), out.data_ptr(),
              m.data_ptr(), l.data_ptr(), b, h, sq, sk, d,
              *_strides(q), *_strides(k), *_strides(v), *_strides(out),
              _MODES[mode], mb, mh, float(s_), int(bool(causal)),
              int(q.dtype == torch.bfloat16), stream_of(q))
    check(NAME, fn, code)
    count_launch(NAME)
    return out, m, l


def flash_attention(q, k, v, attn_mask=None, causal=False, scale=None,
                    dropout_p=0.0, training=False):
    """The port's counterpart of ``paddle_tpu.ops.pallas.flash_attention``
    for inference: returns the attention output only. Attention dropout
    (``training=True`` with ``dropout_p > 0``) needs the training slice's
    in-kernel dropout and raises ``NotImplementedError``."""
    if training and dropout_p > 0.0:
        raise NotImplementedError(
            "flash_attention: attention dropout in training comes with the "
            "training slice (backward kernels and in-kernel dropout); run "
            "the model in eval() or with attention_probs_dropout_prob=0")
    out, _, _ = flash_attention_fwd(q, k, v, attn_mask, causal, scale)
    return out
