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
A mask the Pallas module hands to plain sdpa because it cannot tile it
(key dim 1 where Sk > 1) gets sdpa's semantics on the kernel path: an
additive one is expanded over the keys, and a bool one, which masks whole
query rows, zeroes those rows of q (see :func:`_masked_rows`). Under
``causal`` such a mask takes sdpa's causal edge too: ``-1e9`` folded into
a full bias (:func:`_kernel_mask`), so a row masked everywhere averages
all Sk keys as sdpa's does.

The kernels run their products on the tensor cores
(``csrc/tensor_core.cuh``): bf16 on ``mma.sync`` m16n8k16, float32 on
m16n8k8 in split TF32, which keeps float32's accuracy (the forward, dQ
and dK/dV in both). The dQ kernel also computes ``delta = rowsum(dO *
O)``, which dK/dV reads. They are built for head dims 64 and 128 and for
float32 and bf16: any other head dim up to 128 is zero-padded to the next
of the two, and any other float dtype computed in float32 and returned in
its own, as the reference casts to float32 (:func:`_padded_fwd`,
:func:`_padded_bwd`). Head dims above 128 raise.

Attention dropout is drawn inside the kernels. The TPU's random bits
cannot be reproduced, so the keep decision is a counter hash of ``(seed0,
seed1, batch*head, row, col)`` (``csrc/common.cuh``), which the forward
and both backward kernels regenerate, and which
:func:`dropout_keep_mask` computes bit for bit with int64 tensor
arithmetic. The two words reach the kernels as a (2,) int32 tensor on
the card (:func:`paddle_tpu_torch.random.next_seed_words`), read through
a pointer when the kernel runs, never as launch arguments: a CUDA graph
that captured the draw and the launches draws fresh words at each replay.
The forward saves that tensor for the backward, whose kernels read the
same words. As in the Pallas kernels, dropout applies to the
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
SDPA_NEG = -1e9        # what sdpa writes over masked and forbidden scores
HEAD_DIMS = (64, 128)  # the kernels' instantiated head dims
# ``causal`` inside this module: 0 none; 1 the kernels' -1e30 edge; 2 the
# edge folded into a full bias by :func:`_kernel_mask`, where the backward
# zeroes ds above the diagonal (sdpa's ``where`` passes no gradient there)
CAUSAL_IN_BIAS = 2

# dropout on, threshold, the seed words' pointer, 1 - rate
_DROPOUT_ARGTYPES = [ctypes.c_int, ctypes.c_uint, ctypes.c_void_p,
                     ctypes.c_float]
_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 +
             [ctypes.c_longlong] * 12 +
             [ctypes.c_int] * 3 + [ctypes.c_float] + [ctypes.c_int] * 2 +
             _DROPOUT_ARGTYPES + [ctypes.c_void_p])
_BWD_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 12 +
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


def seed_words(seed, device):
    """``seed`` as the kernels read it: a contiguous (2,) int32 tensor on
    ``device``. A tensor of the two words (what
    :func:`paddle_tpu_torch.random.next_seed_words` draws) is used as it
    is; a pair of ints, each taken modulo 2^32, is copied there."""
    if torch.is_tensor(seed):
        if seed.shape != (2,) or seed.dtype != torch.int32 or \
                seed.device != torch.device(device) or \
                not seed.is_contiguous():
            raise ValueError(f"flash_attention: the seed words must be a "
                             f"contiguous (2,) int32 tensor on {device}, got "
                             f"{tuple(seed.shape)} {seed.dtype} on "
                             f"{seed.device}")
        return seed
    words = [((int(w) & _M32) ^ 0x80000000) - 0x80000000 for w in seed]
    return torch.tensor(words, dtype=torch.int32, device=device)


def dropout_keep_mask(seed, bh, sq, sk, dropout_p, device="cpu"):
    """The keep mask the kernels draw, as a bool tensor (bh, sq, sk): the
    counter hash of ``csrc/common.cuh`` at every (batch*head, row, col),
    in int64 arithmetic masked to 32 bits. ``seed`` is the two words, as
    a pair of ints or as the (2,) int32 tensor the kernels read; the same
    words give the same mask either way."""
    if torch.is_tensor(seed):
        s0, s1 = seed.to(device=device, dtype=torch.int64) & _M32
    else:
        # Python ints until the first xor: no host-to-device copy
        s0, s1 = (int(s) & _M32 for s in seed)
    ar = lambda n: torch.arange(n, dtype=torch.int64, device=device)
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

def _mask_dims(attn_mask, b, h, sq, sk):
    """The mask's shape padded to rank 4, and whether it is one that the
    Pallas module's ``_mask_mode`` sends to plain sdpa (``"fallback"``)
    although it broadcasts to ``(B, H, Sq, Sk)``: a key dim of 1 where
    ``Sk > 1``. A mask of rank above 4, or one that does not broadcast,
    raises."""
    if attn_mask.dim() > 4:
        raise ValueError(f"flash_attention: mask of rank {attn_mask.dim()}")
    mb, mh, msq, msk = (1,) * (4 - attn_mask.dim()) + tuple(attn_mask.shape)
    if mb not in (1, b) or mh not in (1, h) or msq not in (1, sq) or \
            msk not in (1, sk):
        raise ValueError(
            f"flash_attention: mask shape {tuple(attn_mask.shape)} does not "
            f"broadcast to {(b, h, sq, sk)}")
    return (mb, mh, msq, msk), msk != sk


def _canon_mask(attn_mask, b, h, sq, sk):
    """The additive f32 bias as ``(mask3, mode, mb, mh)``: ``mask3`` is
    contiguous ``(mb*mh, 1 or Sq, Sk)``; ``mode`` is None, "key" (one
    row broadcast over queries) or "full". A bool mask that tiles becomes
    the kernels' ``-1e30``. A mask the reference hands to plain sdpa
    (key dim 1, see :func:`_mask_dims`) is expanded over the keys if it
    is additive, and is no bias at all if it is bool: such a mask masks
    whole query rows, which :func:`_masked_rows` takes care of."""
    if attn_mask is None:
        return None, None, 1, 1
    (mb, mh, msq, _), sdpa_only = _mask_dims(attn_mask, b, h, sq, sk)
    m = attn_mask.detach().reshape(mb, mh, msq, -1)
    if m.dtype == torch.bool:
        if sdpa_only:
            return None, None, 1, 1
        m = torch.where(m, 0.0, NEG_INF)
    m = m.to(torch.float32).expand(mb, mh, msq, sk)
    mode = "key" if msq == 1 else "full"
    return m.reshape(mb * mh, msq, sk).contiguous(), mode, mb, mh


def _masked_rows(attn_mask, b, h, sq, sk):
    """For a bool mask that the reference hands to plain sdpa (key dim 1),
    the rows it keeps as a bool ``(mb, mh, 1 or Sq, 1)``; else None.

    sdpa writes ``-1e9`` over every score of a masked row
    (``paddle_tpu/ops/nn_ops.py``, ``scaled_dot_product_attention``), so
    the row's probabilities are uniform and ``where`` passes no gradient
    from it to q or k. A zero row of q gives the same: its scores are all
    0, a constant, and its gradient is cut where q is zeroed. The kernels
    then run on that q with no bias (under ``causal``, with the bias of
    :func:`_kernel_mask`)."""
    if attn_mask is None or attn_mask.dtype != torch.bool:
        return None
    dims, sdpa_only = _mask_dims(attn_mask, b, h, sq, sk)
    return attn_mask.reshape(dims) if sdpa_only else None


def _zero_rows(x, rows):
    """``x`` with the rows that ``rows`` does not keep set to 0 (as a
    differentiable ``where``, so their gradient is 0 too)."""
    if rows is None:
        return x
    return torch.where(rows.to(x.device), x, x.new_zeros(()))


def _kernel_mask(attn_mask, b, h, sq, sk, causal):
    """``(cm, rows, causal)`` as the kernels and plain versions take
    ``attn_mask`` under ``causal``: the canonical mask
    (:func:`_canon_mask`), the rows to zero (:func:`_masked_rows`) and
    this module's ``causal`` (0, 1 or :data:`CAUSAL_IN_BIAS`).

    A mask the reference hands to sdpa (key dim 1) meets sdpa's causal
    edge there: ``-1e9`` written over the forbidden keys by ``where``
    (``paddle_tpu/ops/nn_ops.py``, ``scaled_dot_product_attention``), so
    a row masked everywhere averages all Sk keys. Here that edge is folded
    into a full ``(mb*mh, Sq, Sk)`` bias, ``where(allowed, m, -1e9)`` for
    an additive mask ``m`` and ``where(allowed & row kept, 0, -1e9)`` for
    a bool one, and the kernels run without their ``-1e30`` edge; in a row
    that is not masked a forbidden key gets ``exp(-1e9 - m) = 0``. The
    backward zeroes ds above the diagonal, where sdpa's ``where`` passes
    no gradient. Masks that tile keep the kernels' edge."""
    cm = _canon_mask(attn_mask, b, h, sq, sk)
    rows = _masked_rows(attn_mask, b, h, sq, sk)
    if not causal or attn_mask is None:
        return cm, rows, int(bool(causal))
    (mb, mh, msq, _), sdpa_only = _mask_dims(attn_mask, b, h, sq, sk)
    if not sdpa_only:
        return cm, rows, 1
    m = attn_mask.detach().reshape(mb, mh, msq, 1)
    allowed = torch.ones(sq, sk, dtype=torch.bool, device=m.device).tril()
    if m.dtype == torch.bool:
        bias = torch.where(allowed & m, 0.0, SDPA_NEG)
    else:
        bias = torch.where(allowed, m.to(torch.float32), SDPA_NEG)
    bias = bias.expand(mb, mh, sq, sk).reshape(mb * mh, sq, sk).contiguous()
    return (bias, "full", mb, mh), rows, CAUSAL_IN_BIAS


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
    if cm[0] is not None and cm[0].device != q.device:
        raise ValueError("flash_attention: mask on another device than q")


def _kernel_head_dim(d):
    """The instantiated head dim a head dim ``d`` runs at: the least of
    :data:`HEAD_DIMS` that is not below it. Above 128 it raises: a stated
    restriction (no model of the repository uses one)."""
    for w in HEAD_DIMS:
        if d <= w:
            return w
    raise ValueError(f"flash_attention: the kernels take head dims up to "
                     f"{HEAD_DIMS[-1]}, got {d}")


def _kernel_dtype(dtype):
    """float32 and bf16 run as they are; any other float dtype runs in
    float32, as the reference casts every operand to float32."""
    if dtype in (torch.float32, torch.bfloat16):
        return dtype
    if not dtype.is_floating_point:
        raise TypeError(f"flash_attention: q, k, v must be a float dtype, "
                        f"got {dtype}")
    return torch.float32


def _to_kernel(t, width, dtype):
    """``t`` in the kernels' dtype, its head dim zero-padded to ``width``.
    Zero columns add nothing to q kᵀ, leave O's extra columns 0 and delta
    as it was, and the dropout hash depends on (bh, row, col) alone: the
    padded result, sliced back, is the unpadded one."""
    d = t.shape[-1]
    if d == width:
        return t.to(dtype)
    out = t.new_zeros(t.shape[:-1] + (width,), dtype=dtype)
    out[..., :d] = t
    return out


def _from_kernel(t, d, dtype):
    return t[..., :d].to(dtype)


def _padded_fwd(fwd, q, k, v, cm, causal, scale, dropout_p, seed):
    """``fwd`` (a forward on kernel widths: the kernel's launcher, or in
    the tests a plain version) run on q, k, v padded to the kernels' head
    dim and cast to their dtype, with the scale of the true head dim;
    returns ``(out, m, l)``, ``out`` sliced back in q's dtype."""
    d, dtype = q.shape[3], q.dtype
    w, kdt = _kernel_head_dim(d), _kernel_dtype(dtype)
    out, m, l = fwd(*(_to_kernel(t, w, kdt) for t in (q, k, v)), cm, causal,
                    _scale(scale, d), dropout_p, seed)
    return _from_kernel(out, d, dtype), m, l


def _padded_bwd(bwd, q, k, v, cm, out, m, l, g, causal, scale, dropout_p,
                seed):
    """The backward's counterpart of :func:`_padded_fwd`: q, k, v, ``out``
    and ``g`` padded and cast, the gradients sliced back, each in its
    input's dtype."""
    d = q.shape[3]
    w, kdt = _kernel_head_dim(d), _kernel_dtype(q.dtype)
    q_, k_, v_, out_, g_ = (_to_kernel(t, w, kdt) for t in (q, k, v, out, g))
    grads = bwd(q_, k_, v_, cm, out_, m, l, g_, causal, _scale(scale, d),
                dropout_p, seed)
    return tuple(_from_kernel(t, d, x.dtype)
                 for t, x in zip(grads, (q, k, v)))


def _scale(scale, d):
    return scale if scale is not None else 1.0 / math.sqrt(d)


def _strides(t):
    return t.stride(0), t.stride(1), t.stride(2)


def _aligned16(t):
    """Whether 16-byte copies can read ``t``'s head-dim rows: the pointer
    and every stride of a dimension longer than 1 a multiple of 16
    bytes."""
    es = t.element_size()
    return t.data_ptr() % 16 == 0 and all(
        (st * es) % 16 == 0 for st, n in zip(t.stride()[:3], t.shape[:3])
        if n > 1)


def _kernel_operand(t):
    """``t`` as the kernels read it: the head dim contiguous, and its rows
    on 16-byte boundaries (the kernels copy q, k, v, dO and O 16 bytes at
    a time). Anything else is copied, never routed to the plain
    version."""
    if t.stride(-1) != 1:
        return t.contiguous()
    if not _aligned16(t):
        return t.clone(memory_format=torch.contiguous_format)
    return t


def _dropout_args(dropout_p, seed):
    """The kernels' dropout arguments; ``seed`` is :func:`seed_words`'
    tensor, which the caller keeps alive until the launch has run."""
    if dropout_p <= 0.0:
        return 0, 0, None, 1.0
    return (1, dropout_threshold(dropout_p), seed.data_ptr(),
            1.0 - dropout_p)


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
    kernels' causal edge (``causal`` 1) forbids, and the positions it
    allows (None: all)."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    mask3, mode, mb, mh = cm
    s = torch.matmul(q.float() * _scale(scale, d),
                     k.float().transpose(-1, -2))
    if mode is not None:
        s = s + mask3.reshape(mb, mh, mask3.shape[1], sk)
    valid = None
    if causal == 1:
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


def _fwd_kernel(q, k, v, cm, causal, scale, dropout_p, seed):
    """The forward kernel's launch on q, k, v of an instantiated head dim
    and dtype; ``scale`` given."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    mask3, mode, mb, mh = cm
    q, k, v = (_kernel_operand(t) for t in (q, k, v))
    seed = seed_words(seed, q.device) if dropout_p > 0.0 else None
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
              _MODES[mode], mb, mh, float(scale), int(causal == 1),
              int(q.dtype == torch.bfloat16),
              *_dropout_args(dropout_p, seed), stream_of(q))
    check(NAME, fn, code)
    count_launch(NAME)
    return out, m, l


def _fwd(q, k, v, cm, causal, scale, dropout_p, seed):
    """The forward on canonical mask ``cm``: the kernel on a CUDA tensor
    (through :func:`_padded_fwd`), the plain version on a CPU one."""
    if q.device.type == "cpu":
        return _fwd_plain(q, k, v, cm, causal, scale, dropout_p, seed, None)
    _check_cuda(q, k, v, cm)
    return _padded_fwd(_fwd_kernel, q, k, v, cm, causal, scale, dropout_p,
                       seed)


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
    cm, rows, causal = _kernel_mask(attn_mask, b, h, sq, k.shape[2], causal)
    return _fwd_plain(_zero_rows(q, rows), k, v, cm, causal, scale,
                      dropout_p, seed, keep)


def flash_attention_fwd(q, k, v, attn_mask=None, causal=False, scale=None,
                        dropout_p=0.0, seed=(0, 0)):
    """Flash attention forward over (B, H, S, D). On a CUDA tensor it
    launches the kernel (any head dim up to 128 and any float dtype, as
    :func:`_padded_fwd` takes them, any strides with a contiguous head
    dim, copied first where a row is off a 16-byte boundary, an f32 mask,
    dropout at rate ``dropout_p`` from the two 32-bit words of ``seed``);
    on a CPU tensor it computes :func:`flash_attention_fwd_plain`. Returns
    ``(out, m, l)`` as the plain version does; the kernel's ``out`` is
    laid out as (B, Sq, H, D) in memory, so merging the heads back is a
    view."""
    _check(q, k, v)
    b, h, sq, _ = q.shape
    cm, rows, causal = _kernel_mask(attn_mask, b, h, sq, k.shape[2], causal)
    return _fwd(_zero_rows(q, rows), k, v, cm, causal, scale, dropout_p,
                seed)


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
    if causal == CAUSAL_IN_BIAS:
        ds = ds.tril()
    dq = torch.matmul(ds, k.float()) * s_
    dk = torch.matmul(ds.transpose(-1, -2), q.float() * s_)
    dv = torch.matmul(pd.transpose(-1, -2), do)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _bwd_setup(q, k, v, cm, out, m, l, g, causal, scale, dropout_p, seed):
    """The CUDA backward up to its launches, on q, k, v of an instantiated
    head dim and dtype (``causal`` 0, 1 or :data:`CAUSAL_IN_BIAS`):
    checks, the gradients' and delta's storage and the C arguments.
    Returns ``(dq, dk, dv, launch)``; ``launch(name)`` launches the kernel
    ``BWD_DQ`` (fills dq, and ``delta = rowsum(g * out)`` for its rows,
    which the Pallas module computes outside its kernels) or ``BWD_DKV``
    (fills dk and dv from that delta, so it runs after ``BWD_DQ``) and
    counts it."""
    _check_cuda(q, k, v, cm, out, m, l, g)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    mask3, mode, mb, mh = cm
    q, k, v, g, out = (_kernel_operand(t.to(q.dtype))
                       for t in (q, k, v, g, out))
    causal = int(causal)
    seed = seed_words(seed, q.device) if dropout_p > 0.0 else None
    delta = torch.empty((b * h, sq), dtype=torch.float32, device=q.device)
    m, l = m.contiguous(), l.contiguous()
    dq = torch.empty((b, h, sq, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, h, sk, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, h, sk, d), dtype=v.dtype, device=q.device)
    strides = (ctypes.c_longlong * 24)(
        *_strides(q), *_strides(k), *_strides(v), *_strides(g),
        *_strides(dq), *_strides(dk), *_strides(dv), *_strides(out))
    dims = (b, h, sq, sk, d, strides, _MODES[mode], mb, mh,
            float(_scale(scale, d)), causal,
            int(q.dtype == torch.bfloat16), *_dropout_args(dropout_p, seed))

    def launch(name):
        # pointers and the stream are read at launch time from tensors this
        # closure holds (the seed words too, through ``dims``' pointer), so
        # a launch never touches freed storage and a CUDA graph being
        # captured on the current stream records it
        if b * h * sq == 0:
            return
        outs = ((dq.data_ptr(), None, None) if name == BWD_DQ
                else (None, dk.data_ptr(), dv.data_ptr()))
        fn = function(name, _BWD_ARGTYPES)
        code = fn(device_index(q), q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  None if mask3 is None else mask3.data_ptr(), m.data_ptr(),
                  l.data_ptr(), delta.data_ptr(), g.data_ptr(),
                  out.data_ptr(), *outs, *dims, stream_of(q))
        check(name, fn, code)
        count_launch(name)

    return dq, dk, dv, launch


def _bwd_kernels(q, k, v, cm, out, m, l, g, causal, scale, dropout_p,
                 seed):
    """The dQ and dK/dV launches on tensors of an instantiated head dim
    and dtype."""
    dq, dk, dv, launch = _bwd_setup(q, k, v, cm, out, m, l, g, causal,
                                    scale, dropout_p, seed)
    if q.shape[0] * q.shape[1] * q.shape[2] == 0:
        return dq, dk.zero_(), dv.zero_()
    launch(BWD_DQ)
    launch(BWD_DKV)
    return dq, dk, dv


def _bwd(q, k, v, cm, out, m, l, g, causal, scale, dropout_p, seed):
    """The backward on canonical mask ``cm``: the dQ and dK/dV kernels on a
    CUDA tensor (through :func:`_padded_bwd`), the plain version on a CPU
    one."""
    if q.device.type == "cpu":
        return _bwd_plain(q, k, v, cm, out, m, l, g, causal, scale,
                          dropout_p, seed, None)
    return _padded_bwd(_bwd_kernels, q, k, v, cm, out, m, l, g, causal,
                       scale, dropout_p, seed)


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
    cm, rows, causal = _kernel_mask(attn_mask, b, h, sq, k.shape[2], causal)
    dq, dk, dv = _bwd_plain(_zero_rows(q, rows), k, v, cm, out, m, l, g,
                            causal, scale, dropout_p, seed, keep)
    return _zero_rows(dq, rows), dk, dv


def flash_attention_bwd(q, k, v, attn_mask, out, m, l, g, causal=False,
                        scale=None, dropout_p=0.0, seed=(0, 0)):
    """Flash attention's gradients ``(dq, dk, dv)``. On a CUDA tensor it
    launches the dQ kernel, which also computes ``delta = rowsum(g *
    out)``, then the dK/dV kernel (what the forward kernel takes, plus
    ``g`` and ``out`` in any strides with a contiguous head dim); on a CPU
    tensor it computes :func:`flash_attention_bwd_plain`. The mask gets
    no gradient."""
    _check(q, k, v)
    b, h, sq, _ = q.shape
    cm, rows, causal = _kernel_mask(attn_mask, b, h, sq, k.shape[2], causal)
    dq, dk, dv = _bwd(_zero_rows(q, rows), k, v, cm, out, m, l, g, causal,
                      scale, dropout_p, seed)
    return _zero_rows(dq, rows), dk, dv


class FlashAttentionFunction(torch.autograd.Function):
    """Flash attention with autograd: the counterpart of the Pallas
    module's ``_flash`` custom vjp. The forward saves q, k, v, the
    canonical mask, ``out``, the row statistics ``m`` and ``l`` and the
    dropout seed words' tensor, so that the backward kernels read the
    words the forward read (also under a CUDA graph's replay); the
    backward runs the dQ and dK/dV kernels (the plain
    backward on a CPU tensor). The mask, an input-derived bias, gets no
    gradient, as in the reference."""

    @staticmethod
    def forward(ctx, q, k, v, mask3, mode, mb, mh, causal, scale, dropout_p,
                seed, seed1=None):
        # ``seed``: the words' tensor, or (with ``seed1``) the first of two
        # int words, held as a tensor from here on
        cm = (mask3, mode, mb, mh)
        if dropout_p > 0.0:
            seed = seed_words(seed if seed1 is None else (seed, seed1),
                              q.device)
        out, m, l = _fwd(q, k, v, cm, causal, scale, dropout_p, seed)
        ctx.save_for_backward(q, k, v, mask3, out, m, l, seed)
        ctx.args = (mode, mb, mh, causal, scale, dropout_p)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, mask3, out, m, l, seed = ctx.saved_tensors
        mode, mb, mh, causal, scale, dropout_p = ctx.args
        dq, dk, dv = _bwd(q, k, v, (mask3, mode, mb, mh), out, m, l, g,
                          causal, scale, dropout_p, seed)
        return (dq, dk, dv) + (None,) * 9


def flash_attention(q, k, v, attn_mask=None, causal=False, scale=None,
                    dropout_p=0.0, training=False):
    """The port's counterpart of ``paddle_tpu.ops.pallas.flash_attention``:
    returns the attention output. With ``training=True`` and
    ``dropout_p > 0`` the probabilities are dropped inside the kernels,
    from two fresh seed words per call, drawn on q's device
    (:func:`paddle_tpu_torch.random.next_seed_words`). Where autograd
    records (grad mode on and q, k or v requires grad) it runs
    :class:`FlashAttentionFunction`; otherwise the forward alone, with no
    graph."""
    _check(q, k, v)
    b, h, sq, _ = q.shape
    p_drop = float(dropout_p) if training else 0.0
    if not 0.0 <= p_drop < 1.0:
        raise ValueError(f"flash_attention: dropout_p must be in [0, 1), "
                         f"got {dropout_p}")
    seed = prandom.next_seed_words(q.device) if p_drop > 0.0 else None
    cm, rows, causal = _kernel_mask(attn_mask, b, h, sq, k.shape[2], causal)
    q = _zero_rows(q, rows)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFunction.apply(q, k, v, *cm, causal, scale,
                                            p_drop, seed)
    out, _, _ = _fwd(q, k, v, cm, causal, scale, p_drop, seed)
    return out
