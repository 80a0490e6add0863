"""The port's backward kernel modules against the JAX package's Pallas
backward kernels, and its attention-dropout hash.

On the CPU each wrapper computes its kernel's plain PyTorch version, and
each autograd ``Function`` runs that plain forward and backward; both are
held here against ``jax.vjp`` of the Pallas custom-vjp functions run in
interpret mode (``_layer_norm2`` and ``_flash``), on the same inputs made
with numpy from a seed.

Tolerances: layer norm, float32 atol and rtol 1e-5 (both sides compute in
float32; only the summation order differs). Flash attention, float32 atol
and rtol 2e-5: the gradients sum products over keys and queries in another
order and reach a few units in size. With dropout, the port's plain
versions are given the reference's own interpret-mode keep mask
(``_host_keep_mask``), so the comparison is as exact as without.

The CUDA kernels themselves are held against their plain versions on the
card in ``test_torch_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas.flash_attention import (_canon_mask, _flash,
                                                   _host_keep_mask,
                                                   _mask_mode)
from paddle_tpu.ops.pallas.layer_norm import _layer_norm2

from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.ops.kernels import flash_attention as FA
from paddle_tpu_torch.ops.kernels import layer_norm as LN

LN_TOL = dict(atol=1e-5, rtol=1e-5)
FLASH_TOL = dict(atol=2e-5, rtol=2e-5)


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


# -- layer_norm ----------------------------------------------------------------

@pytest.mark.parametrize("n,d", [(37, 96), (64, 768)])
def test_layer_norm_bwd_matches_pallas_vjp(n, d):
    rng = np.random.RandomState(n + d)
    x = (rng.randn(n, d) * 3 + 1).astype("f4")
    w = (rng.rand(d) + 0.5).astype("f4")
    b = rng.randn(d).astype("f4")
    g = rng.randn(n, d).astype("f4")
    eps = 1e-12
    y_ref, vjp = jax.vjp(lambda x, w, b: _layer_norm2(x, w, b, eps),
                         jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    dx_ref, dw_ref, db_ref = (np.asarray(a) for a in vjp(jnp.asarray(g)))

    # the plain backward, from the forward's saved statistics
    _, mu, rstd = LN.layer_norm_fwd(_t(x), _t(w), _t(b), eps)
    dx, dw, db = LN.layer_norm_bwd(_t(x), _t(w), mu, rstd, _t(g))
    for got, ref in ((dx, dx_ref), (dw, dw_ref), (db, db_ref)):
        np.testing.assert_allclose(got.numpy(), ref, **LN_TOL)

    # the Function: the same plumbing the card uses
    xt, wt, bt = (_t(a).requires_grad_() for a in (x, w, b))
    kernels.reset_launches()
    y = LN.layer_norm(xt, wt, bt, eps)
    assert type(y.grad_fn).__name__ == "LayerNormFunctionBackward"
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref),
                               **LN_TOL)
    y.backward(_t(g))
    for got, ref in ((xt.grad, dx_ref), (wt.grad, dw_ref), (bt.grad, db_ref)):
        np.testing.assert_allclose(got.numpy(), ref, **LN_TOL)
    # the plain versions on a CPU tensor are not launches
    assert sum(kernels.launches.values()) == 0


def test_layer_norm_function_keeps_leading_dims_and_builds_no_graph_in_eval():
    rng = np.random.RandomState(5)
    x = _t(rng.randn(2, 3, 16).astype("f4")).requires_grad_()
    w = _t(rng.rand(16).astype("f4") + 0.5).requires_grad_()
    b = _t(rng.randn(16).astype("f4")).requires_grad_()
    y = LN.layer_norm(x, w, b)
    assert y.shape == (2, 3, 16)
    y.square().sum().backward()
    assert x.grad.shape == x.shape and w.grad.shape == (16,)
    with torch.inference_mode():
        assert LN.layer_norm(x, w, b).grad_fn is None


def test_layer_norm_bwd_rejects_mismatched_shapes():
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError):
        LN.layer_norm_bwd(x, torch.ones(8), torch.zeros(4, 1),
                          torch.ones(4, 1), torch.zeros(4, 7))
    with pytest.raises(ValueError):
        LN.layer_norm_bwd(x, torch.ones(8), torch.zeros(3, 1),
                          torch.ones(4, 1), x)


# -- flash_attention ------------------------------------------------------------

CASES = {
    # name: (B, H, S, D, mask kind, causal)
    "key_1e9": (2, 2, 32, 16, "key", False),
    "full": (2, 2, 32, 16, "full", False),
    "causal": (1, 2, 48, 16, None, True),
    "unaligned_s200": (1, 2, 200, 16, "key", False),
    "bool_fully_masked_row": (2, 1, 32, 16, "bool", False),
}
BLOCK = 16


def _case(name):
    b, h, s, d, kind, causal = CASES[name]
    rng = np.random.RandomState(sorted(CASES).index(name))
    q, k, v, g = (rng.randn(b, h, s, d).astype("f4") for _ in range(4))
    mask = None
    if kind == "key":
        mask = np.where(rng.rand(b, 1, 1, s) < 0.3, -1e9, 0.0).astype("f4")
    elif kind == "full":
        mask = (rng.randn(1, h, s, s) * 2).astype("f4")
    elif kind == "bool":
        mask = rng.rand(b, 1, s, s) > 0.3
        mask[0, 0, 5, :] = False
    return q, k, v, g, mask, causal


def _jax_vjp(q, k, v, g, mask, causal, dropout_p, seed):
    """out, dq, dk, dv of the Pallas ``_flash`` in interpret mode."""
    b, h, s, _ = q.shape
    cm = None if mask is None else _canon_mask(jnp.asarray(mask))
    mode = _mask_mode(None if mask is None else mask.shape, b, h, s, s)
    seed2 = jnp.asarray(seed, jnp.int32)
    out, vjp = jax.vjp(
        lambda q, k, v: _flash(q, k, v, cm, mode, seed2, causal, None,
                               BLOCK, BLOCK, dropout_p),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(out)] + [np.asarray(a) for a in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("case", list(CASES))
def test_flash_function_bwd_matches_pallas_vjp(case):
    q, k, v, g, mask, causal = _case(case)
    ref = _jax_vjp(q, k, v, g, mask, causal, 0.0, (0, 0))
    qt, kt, vt = (_t(a).requires_grad_() for a in (q, k, v))
    out = FA.flash_attention(qt, kt, vt,
                             attn_mask=None if mask is None else _t(mask),
                             causal=causal)
    assert type(out.grad_fn).__name__ == "FlashAttentionFunctionBackward"
    out.backward(_t(g))
    got = [out.detach(), qt.grad, kt.grad, vt.grad]
    for name, a, r in zip(("out", "dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(a.numpy(), r, err_msg=name, **FLASH_TOL)
    if case == "bool_fully_masked_row":
        # no key to attend: no output and no gradient for that query
        assert np.all(qt.grad.numpy()[0, :, 5] == 0.0)


@pytest.mark.parametrize("case", ["key_1e9", "causal", "unaligned_s200"])
def test_flash_dropout_plain_matches_pallas_with_its_keep_mask(case):
    """With dropout 0.1, the plain forward and backward given the
    reference's own interpret-mode keep mask agree with its kernels."""
    q, k, v, g, mask, causal = _case(case)
    b, h, s, d = q.shape
    seed = (1234, -5678)
    ref = _jax_vjp(q, k, v, g, mask, causal, 0.1, seed)
    pad = -(-s // BLOCK) * BLOCK
    keep = np.asarray(_host_keep_mask(jnp.asarray(seed, jnp.int32), b * h,
                                      pad, pad, 0.1))[:, :s, :s]
    tm = None if mask is None else _t(mask)
    out, m, l = FA.flash_attention_fwd_plain(_t(q), _t(k), _t(v), tm,
                                             causal=causal, dropout_p=0.1,
                                             keep=_t(keep))
    grads = FA.flash_attention_bwd_plain(_t(q), _t(k), _t(v), tm, out, m, l,
                                         _t(g), causal=causal, dropout_p=0.1,
                                         keep=_t(keep))
    for name, a, r in zip(("out", "dq", "dk", "dv"), (out,) + grads, ref):
        np.testing.assert_allclose(a.numpy(), r, err_msg=name, **FLASH_TOL)
    # dropout really dropped: the output differs from the undropped one
    assert not np.allclose(ref[0], _jax_vjp(q, k, v, g, mask, causal, 0.0,
                                            seed)[0])


def test_flash_function_with_dropout_uses_the_hash_mask():
    """On the CPU the Function's dropout is the kernels' hash mask at its
    seed: the plain versions given that mask agree exactly."""
    q, k, v, g, mask, causal = _case("key_1e9")
    b, h, s, _ = q.shape
    seed = (7, 2 ** 31 - 1)
    qt, kt, vt = (_t(a).requires_grad_() for a in (q, k, v))
    cm = FA._canon_mask(_t(mask), b, h, s, s)
    out = FA.FlashAttentionFunction.apply(qt, kt, vt, *cm, causal, None, 0.1,
                                          *seed)
    out.backward(_t(g))
    keep = FA.dropout_keep_mask(seed, b * h, s, s, 0.1).float()
    o2, m2, l2 = FA.flash_attention_fwd_plain(_t(q), _t(k), _t(v), _t(mask),
                                              dropout_p=0.1, keep=keep)
    ref = FA.flash_attention_bwd_plain(_t(q), _t(k), _t(v), _t(mask), o2, m2,
                                       l2, _t(g), dropout_p=0.1, keep=keep)
    torch.testing.assert_close(out.detach(), o2, rtol=0, atol=0)
    for a, r in zip((qt.grad, kt.grad, vt.grad), ref):
        torch.testing.assert_close(a, r, rtol=0, atol=0)


def test_flash_attention_fresh_seed_per_call_and_no_graph_in_eval():
    rng = np.random.RandomState(9)
    q = _t(rng.randn(1, 2, 16, 8).astype("f4")).requires_grad_()
    a = FA.flash_attention(q, q, q, dropout_p=0.5, training=True)
    b_ = FA.flash_attention(q, q, q, dropout_p=0.5, training=True)
    assert not torch.allclose(a, b_)
    with torch.no_grad():
        assert FA.flash_attention(q, q, q).grad_fn is None


# -- the dropout hash ------------------------------------------------------------

_M = 0xFFFFFFFF


def _absorb_py(h, v):
    h = ((h ^ v) * 0x9E3779B9) & _M
    h ^= h >> 15
    h = (h * 0xB40E609F) & _M
    return h ^ (h >> 13)


def _bits_py(seed, bh, row, col):
    """The hash of csrc/common.cuh in Python integers."""
    h = _absorb_py(_absorb_py(_absorb_py(seed[1] & _M, bh), row), col)
    h ^= seed[0] & _M
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & _M
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & _M
    return h ^ (h >> 16)


@pytest.mark.parametrize("seed", [(0, 0), (-1, -2 ** 31), (2 ** 31 - 1, 17)])
def test_dropout_keep_mask_is_the_32_bit_hash(seed):
    """The int64 tensor arithmetic wraps exactly as 32-bit unsigned."""
    bh, sq, sk, p = 3, 5, 7, 0.3
    keep = FA.dropout_keep_mask(seed, bh, sq, sk, p).numpy()
    thr = FA.dropout_threshold(p)
    want = np.array([[[_bits_py(seed, i, r, c) >= thr for c in range(sk)]
                      for r in range(sq)] for i in range(bh)])
    np.testing.assert_array_equal(keep, want)


def test_dropout_hash_folds_coordinates_as_the_pallas_kernel():
    """The absorb step is the one ``_dropout_keep`` applies to (bh, q block,
    k block) with int32 XLA arithmetic."""
    def absorb_jnp(mixed, v):
        mixed = (mixed ^ v) * jnp.int32(-1640531527)
        mixed = mixed ^ ((mixed >> 15) & jnp.int32(0x1FFFF))
        mixed = mixed * jnp.int32(-1274126177)
        return mixed ^ ((mixed >> 13) & jnp.int32(0x7FFFF))
    for s1, v in ((5, 3), (-7, 2 ** 30), (2 ** 31 - 1, 123457)):
        ref = int(np.asarray(absorb_jnp(jnp.int32(s1), jnp.int32(v)))) & _M
        got = FA._absorb(torch.tensor(s1 & _M), v).item()
        assert got == ref == _absorb_py(s1 & _M, v)


def test_dropout_keep_fraction_and_threshold():
    keep = FA.dropout_keep_mask((11, 22), 64, 128, 128, 0.1)
    assert abs(keep.float().mean().item() - 0.9) < 0.003
    assert FA.dropout_threshold(0.0) == 0
    assert FA.dropout_threshold(0.1) == int(0.1 * 2 ** 32)
    assert FA.dropout_threshold(1.0) == 2 ** 32 - 1
