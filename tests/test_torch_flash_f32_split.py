"""Why the float32 flash kernels run split TF32 products on the tensor
cores, and not plain TF32 ones.

The card's TF32 products keep 10 of float32's 23 mantissa bits in each
operand. The float32 kernels (``csrc/flash_attention.cu``,
``flash_fwd_tf32``; ``csrc/flash_attention_bwd.cu``, ``flash_bwd_dq_tf32``
and ``flash_bwd_dkv_tf32``) split each operand into ``hi = tf32(x)`` and
``lo = tf32(x - hi)`` and form each product as ``lo·hi + hi·lo + hi·hi``
with float32 sums ("3xTF32"): the forward's ``q kᵀ`` and ``p v``, the
backward's ``q kᵀ``, ``dO vᵀ``, ``ds k``, ``pdᵀ dO`` and ``dsᵀ q``. Their
``tf32`` cuts the 13 bits below TF32's mantissa (``tc::tf32_split`` in
``csrc/tensor_core.cuh``); rounding to nearest instead is emulated too.

Here that arithmetic is emulated in torch on the CPU at (2, 4, 384, 64),
with a ``-1e9`` padding mask and causal: the forward through the plain
forward's softmax against the plain forward, the backward from the
reference's own forward output and row statistics against ``jax.vjp`` of
the reference (the Pallas rules in interpret mode). The split form stays
within 1e-5 of float32 (the port's float32 kernel tolerance is 1e-4), and
one TF32 product a term does not stay within 1e-4.
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas.flash_attention import _bwd as _flash_bwd_rule
from paddle_tpu.ops.pallas.flash_attention import _fwd as _flash_fwd_rule
from paddle_tpu.ops.pallas.flash_attention import _canon_mask, _mask_mode

from paddle_tpu_torch.ops.kernels import flash_attention as FA

B, H, S, D = 2, 4, 384, 64
SPLIT_TOL = 1e-5


def tf32_nearest(x):
    """``x`` rounded to the nearest TF32 value (ties away from zero): half
    a TF32 step added to the float32 bits, the 13 bits below cut."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_cut(x):
    """``x`` cut to TF32 (toward zero), as the kernel's split does."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


ROUNDINGS = {"nearest": tf32_nearest, "cut": tf32_cut}


def split_product(tf32):
    def product(a, b):
        """``a @ b`` from TF32 pieces: lo·hi + hi·lo + hi·hi, f32 sums."""
        ah, bh = tf32(a), tf32(b)
        al, bl = tf32(a - ah), tf32(b - bh)
        return al @ bh + ah @ bl + ah @ bh
    return product


def one_product(tf32):
    return lambda a, b: tf32(a) @ tf32(b)


def forward(q, k, v, mask, causal, product):
    """The plain forward's arithmetic with ``product`` for both matrix
    products: scores of the pre-scaled q, the mask, -1e30 above the
    diagonal, p = exp(s - m) unnormalised, O = (p v) / l."""
    s = product(q * (1.0 / math.sqrt(D)), k.transpose(-1, -2))
    if mask is not None:
        s = s + mask
    if causal:
        s = torch.where(torch.ones(S, S, dtype=torch.bool).tril(), s,
                        FA.NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(m <= FA.NEG_INF, 0.0, m)
    p = torch.where(s <= FA.NEG_INF, 0.0, torch.exp(s - m))
    return product(p, v) / p.sum(dim=-1, keepdim=True).clamp_min(1e-20)


def _inputs(kind, seed):
    rng = np.random.RandomState(seed)
    q, k, v = (torch.from_numpy(rng.randn(B, H, S, D).astype("f4"))
               for _ in range(3))
    mask = None
    if kind == "padding":
        lens = rng.randint(16, S + 1, size=B)
        keep = np.arange(S)[None, :] < lens[:, None]
        mask = torch.from_numpy(
            np.where(keep, 0.0, -1e9).astype("f4")[:, None, None, :])
    return q, k, v, mask


CASES = {"padding": ("padding", False), "causal": (None, True),
         "padding_causal": ("padding", True)}


@pytest.mark.parametrize("rounding", list(ROUNDINGS))
@pytest.mark.parametrize("case", list(CASES))
def test_split_tf32_stays_within_1e5_of_float32(case, rounding):
    kind, causal = CASES[case]
    q, k, v, mask = _inputs(kind, sorted(CASES).index(case))
    want = FA.flash_attention_fwd_plain(q, k, v, mask, causal=causal)[0]
    # the emulation is the plain forward's arithmetic: exact products
    # through it give the plain forward
    torch.testing.assert_close(
        forward(q, k, v, mask, causal, torch.matmul), want, rtol=0,
        atol=1e-6)
    got = forward(q, k, v, mask, causal,
                  split_product(ROUNDINGS[rounding]))
    assert (got - want).abs().max().item() <= SPLIT_TOL


@pytest.mark.parametrize("rounding", list(ROUNDINGS))
@pytest.mark.parametrize("case", list(CASES))
def test_one_tf32_product_misses_float32(case, rounding):
    kind, causal = CASES[case]
    q, k, v, mask = _inputs(kind, sorted(CASES).index(case))
    want = FA.flash_attention_fwd_plain(q, k, v, mask, causal=causal)[0]
    got = forward(q, k, v, mask, causal, one_product(ROUNDINGS[rounding]))
    # it misses the split form's bound, and the kernel tolerance too
    assert (got - want).abs().max().item() > 1e-4


def test_tf32_roundings_keep_ten_mantissa_bits():
    step = 2.0 ** -10                     # the TF32 step above 1
    x = torch.tensor([1.0, 1.0 + step / 2, 1.0 + step / 4,
                      1.0 + step * 1.25, -(1.0 + step / 2), 3.0e-3,
                      -7.5e5])
    near, cut = tf32_nearest(x), tf32_cut(x)
    # halfway rounds away from zero, a quarter step down, 1.25 steps to 1
    assert near[:5].tolist() == [1.0, 1.0 + step, 1.0, 1.0 + step,
                                 -(1.0 + step)]
    assert cut[:5].tolist() == [1.0, 1.0, 1.0, 1.0 + step, -1.0]
    for got, most in ((near, 2.0 ** -11), (cut, 2.0 ** -10)):
        assert not (got.view(torch.int32) & 0x1FFF).any()
        assert ((got - x).abs() <= x.abs() * most).all()


# -- the backward --------------------------------------------------------------

def backward(q, k, v, mask, causal, out, m, l, g, product):
    """The backward kernels' arithmetic with ``product`` for all five
    matrix products: the scale on the f32 scores and once on dq and dk,
    p = exp(s - m) / l, ds = p (dp - delta)."""
    scale = 1.0 / math.sqrt(D)
    s = product(q, k.transpose(-1, -2)) * scale
    if mask is not None:
        s = s + mask
    valid = torch.ones(S, S, dtype=torch.bool)
    if causal:
        valid = valid.tril()
    p = torch.where(valid, torch.exp(s - m) / l.clamp_min(1e-20), 0.0)
    delta = (g * out).sum(dim=-1, keepdim=True)
    ds = p * (product(g, v.transpose(-1, -2)) - delta)
    return (product(ds, k) * scale,
            product(ds.transpose(-1, -2), q) * scale,
            product(p.transpose(-1, -2), g))


@functools.lru_cache(maxsize=None)
def _reference_bwd(case):
    """The inputs and g, the reference's forward output and row statistics
    (B, H, S, 1), and its dq, dk, dv from ``jax.vjp``'s rules, in
    interpret mode with blocks of 64."""
    kind, causal = CASES[case]
    q, k, v, mask = _inputs(kind, sorted(CASES).index(case))
    g = torch.from_numpy(np.random.RandomState(9).randn(B, H, S, D)
                         .astype("f4"))
    cm = None if mask is None else _canon_mask(jnp.asarray(mask.numpy()))
    mode = _mask_mode(None if mask is None else mask.shape, B, H, S, S)

    @jax.jit
    def run(q, k, v, g, cm):
        out, res = _flash_fwd_rule(q, k, v, cm, mode,
                                   jnp.zeros((2,), jnp.int32), causal, None,
                                   64, 64, 0.0)
        return (out, res[6][..., :1], res[7][..., :1]) + _flash_bwd_rule(
            mode, causal, None, 64, 64, 0.0, res, g)[:3]

    got = run(*(jnp.asarray(t.numpy()) for t in (q, k, v, g)), cm)
    out, m, l, *grads = (torch.from_numpy(np.array(a)) for a in got)
    return (q, k, v, mask, causal, out, m.reshape(B, H, S, 1),
            l.reshape(B, H, S, 1), g), grads


@pytest.mark.parametrize("rounding", list(ROUNDINGS))
@pytest.mark.parametrize("case", list(CASES))
def test_split_tf32_backward_stays_within_1e5_of_the_reference(case,
                                                               rounding):
    args, want = _reference_bwd(case)
    # the emulation is the backward's arithmetic: exact products through
    # it give the reference's gradients (float32 in another order: atol
    # and rtol 2e-5, as the port's CPU parity tests)
    for a, r in zip(backward(*args, torch.matmul), want):
        torch.testing.assert_close(a, r, rtol=2e-5, atol=2e-5)
    got = backward(*args, split_product(ROUNDINGS[rounding]))
    for name, a, r in zip(("dq", "dk", "dv"), got, want):
        assert (a - r).abs().max().item() <= SPLIT_TOL, name


@pytest.mark.parametrize("rounding", list(ROUNDINGS))
@pytest.mark.parametrize("case", list(CASES))
def test_one_tf32_product_backward_misses_float32(case, rounding):
    args, want = _reference_bwd(case)
    got = backward(*args, one_product(ROUNDINGS[rounding]))
    assert max((a - r).abs().max().item()
               for a, r in zip(got, want)) > 1e-4
