"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU each wrapper computes its kernel's plain PyTorch version; those
are held here against the Pallas kernels run in interpret mode, on the
same inputs made with numpy from a seed. Tolerance: float32 atol and rtol
1e-5 (both sides compute in float32; only the summation order differs).

The CUDA kernels themselves are held against their plain versions on the
card in ``test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as pt
from paddle_tpu.ops.pallas import flash_attention as jax_flash
from paddle_tpu.ops.pallas.flash_attention import (_canon_mask,
                                                   _flash_fwd_res,
                                                   _mask_mode)
from paddle_tpu.ops.pallas.layer_norm import _layer_norm2, _run_fwd

from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.ops.kernels import flash_attention as FA
from paddle_tpu_torch.ops.kernels import layer_norm as LN

TOL = dict(atol=1e-5, rtol=1e-5)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# -- layer_norm --------------------------------------------------------------

@pytest.mark.parametrize("eps", [1e-5, 1e-12])
@pytest.mark.parametrize("n,d", [(37, 96), (64, 768)])
def test_layer_norm_plain_matches_pallas(n, d, eps):
    rng = np.random.RandomState(n + d)
    x = (rng.randn(n, d) * 3 + 1).astype("f4")
    w = (rng.rand(d) + 0.5).astype("f4")
    b = rng.randn(d).astype("f4")
    y_ref, mu_ref, rstd_ref = _run_fwd(jnp.asarray(x), jnp.asarray(w),
                                       jnp.asarray(b), eps)
    y, mu, rstd = LN.layer_norm_fwd(_t(x), _t(w), _t(b), eps)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), **TOL)
    np.testing.assert_allclose(mu.numpy(), np.asarray(mu_ref), **TOL)
    np.testing.assert_allclose(rstd.numpy(), np.asarray(rstd_ref), **TOL)
    # the custom-vjp entry the JAX layer calls gives the same y
    np.testing.assert_allclose(
        y.numpy(), np.asarray(_layer_norm2(jnp.asarray(x), jnp.asarray(w),
                                           jnp.asarray(b), eps)), **TOL)


def test_layer_norm_leading_dims_and_no_count_on_cpu():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 5, 32).astype("f4")
    w, b = rng.randn(32).astype("f4"), rng.randn(32).astype("f4")
    kernels.reset_launches()
    y = LN.layer_norm(_t(x), _t(w), _t(b), 1e-5)
    assert y.shape == (2, 5, 32)
    ref = pt.ops.pallas.layer_norm(pt.to_tensor(x), pt.to_tensor(w),
                                   pt.to_tensor(b), 1e-5).numpy()
    np.testing.assert_allclose(y.numpy(), ref, **TOL)
    # the plain version on a CPU tensor is not a launch
    assert kernels.launches["layer_norm_fwd"] == 0


@pytest.mark.parametrize("bad", ["dtype", "rank", "weight"])
def test_layer_norm_wrapper_rejects(bad):
    x = torch.zeros(4, 8)
    w, b = torch.ones(8), torch.zeros(8)
    if bad == "dtype":
        x = x.half()
        with pytest.raises(TypeError):
            LN.layer_norm_fwd(x, w, b, 1e-5)
    elif bad == "rank":
        with pytest.raises(ValueError):
            LN.layer_norm_fwd(x[None], w, b, 1e-5)
    else:
        with pytest.raises(ValueError):
            LN.layer_norm_fwd(x, torch.ones(7), b, 1e-5)


# -- flash_attention ---------------------------------------------------------

def _flash_case(case):
    """(q, k, v, mask, causal, block) as numpy, for one named case."""
    rng = np.random.RandomState(CASES.index(case))
    b, h, s, d = 2, 2, 32, 16
    mask, causal, block = None, False, 16
    if case == "unaligned":
        s = 40
    q = rng.randn(b, h, s, d).astype("f4")
    k = rng.randn(b, h, s, d).astype("f4")
    v = rng.randn(b, h, s, d).astype("f4")
    if case == "key_1e9":
        mask = np.where(rng.rand(b, 1, 1, s) < 0.3, -1e9, 0.0).astype("f4")
    elif case == "bool_fully_masked_row":
        mask = rng.rand(b, 1, s, s) > 0.3
        mask[0, 0, 5, :] = False          # query row 5 sees no key
    elif case == "full":
        mask = (rng.randn(1, h, s, s) * 2).astype("f4")
    elif case == "causal":
        causal = True
    return q, k, v, mask, causal, block


CASES = ["none", "key_1e9", "bool_fully_masked_row", "full", "causal",
         "unaligned"]


@pytest.mark.parametrize("case", CASES)
def test_flash_attention_plain_matches_pallas(case):
    q, k, v, mask, causal, block = _flash_case(case)
    b, h, s, d = q.shape
    jm = None if mask is None else pt.to_tensor(mask)
    out_ref = jax_flash(pt.to_tensor(q), pt.to_tensor(k), pt.to_tensor(v),
                        attn_mask=jm, causal=causal, block_q=block,
                        block_k=block, force=True).numpy()
    # the forward's row statistics, from the function the kernel runs in
    cm = None if mask is None else _canon_mask(jnp.asarray(mask))
    mode = _mask_mode(None if mask is None else mask.shape, b, h, s, s)
    _, m_ref, l_ref = _flash_fwd_res(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), cm, mode,
        jnp.zeros((2,), jnp.int32), causal, None, block, block, 0.0)

    out, m, l = FA.flash_attention_fwd(
        _t(q), _t(k), _t(v), None if mask is None else _t(mask),
        causal=causal)
    np.testing.assert_allclose(out.numpy(), out_ref, **TOL)
    np.testing.assert_allclose(m.numpy(), np.asarray(m_ref)[..., 0], **TOL)
    np.testing.assert_allclose(l.numpy(), np.asarray(l_ref)[..., 0], **TOL)
    if case == "bool_fully_masked_row":
        # the kernel's semantics, not sdpa's uniform average
        assert np.all(out.numpy()[0, :, 5] == 0.0)
        assert np.all(m.numpy().reshape(b, h, s)[0, :, 5] == 0.0)


def test_flash_attention_strided_views_match_contiguous():
    """BERT hands the kernel head-split views of the fused QKV output."""
    rng = np.random.RandomState(7)
    b, s, h, d = 2, 24, 3, 16
    qkv = _t(rng.randn(b, s, 3, h, d).astype("f4")).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    assert not q.is_contiguous()
    mask = _t(np.where(rng.rand(b, 1, 1, s) < 0.3, -1e9, 0.0).astype("f4"))
    out = FA.flash_attention(q, k, v, attn_mask=mask)
    ref = FA.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                             attn_mask=mask)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), **TOL)


def test_flash_attention_training_dropout_raises():
    """Attention dropout in training now runs (in the kernels, or their
    plain versions on the CPU); only a rate outside [0, 1) raises."""
    rng = np.random.RandomState(3)
    q = _t(rng.randn(1, 2, 8, 64).astype("f4"))
    with pytest.raises(ValueError, match="dropout_p"):
        FA.flash_attention(q, q, q, dropout_p=1.0, training=True)
    # eval (or p == 0) is the inference path
    ref = FA.flash_attention(q, q, q, dropout_p=0.1)
    assert ref.shape == q.shape
    out = FA.flash_attention(q, q, q, dropout_p=0.1, training=True)
    assert out.shape == q.shape and not torch.allclose(out, ref)


def test_flash_attention_rejects_unbroadcastable_mask():
    q = torch.zeros(2, 2, 8, 16)
    with pytest.raises(ValueError):
        FA.flash_attention(q, q, q, attn_mask=torch.zeros(3, 1, 1, 8))
