"""Why the float32 flash forward runs split TF32 products on the tensor
cores, and not plain TF32 ones.

The card's TF32 products keep 10 of float32's 23 mantissa bits in each
operand. The float32 forward kernel (``csrc/flash_attention.cu``,
``flash_fwd_tf32``) splits each operand into ``hi = tf32(x)`` and ``lo =
tf32(x - hi)`` and forms each product as ``lo·hi + hi·lo + hi·hi`` with
float32 sums ("3xTF32"), for both ``q kᵀ`` and ``p v``. Its ``tf32`` cuts
the 13 bits below TF32's mantissa (``tc::tf32_split`` in
``csrc/tensor_core.cuh``); rounding to nearest instead is emulated too.

Here that arithmetic is emulated in torch on the CPU at (2, 4, 384, 64)
and run through the plain forward's softmax, with a ``-1e9`` padding mask
and causal: the split form stays within 1e-5 of float32 (the port's
float32 kernel tolerance is 1e-4), and one TF32 product a term does not.
"""
import math

import numpy as np
import pytest
import torch

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
