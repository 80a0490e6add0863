"""Masks that plain sdpa broadcasts but the flash kernels cannot tile.

The JAX package's ``flash_attention`` (``paddle_tpu/ops/pallas``) sends a
mask whose key dim is 1 where Sk > 1 — ``(B, 1, Sq, 1)``, ``(B, H, Sq,
1)``, ``(1, 1, 1, 1)`` — to its plain sdpa (``_mask_mode`` says
``"fallback"``), where a bool mask writes ``-1e9`` over the masked scores
and an additive one is added. The port runs its kernel path on them: an
additive mask is expanded over the keys, and a bool one, which masks
whole query rows, zeroes those rows of q (a constant row of scores, so a
uniform average, and no gradient through it, as sdpa's ``where``).

Each case holds the port's autograd ``flash_attention`` and its explicit
forward and backward pair (both the plain versions on the CPU) against
``jax.vjp`` of the reference on the same numpy inputs from a seed.
Tolerance: float32 atol and rtol 2e-5, as in ``test_torch_kernels_bwd.py``
(products summed in another order). Dropout is 0.

Under ``causal`` a row masked everywhere (a bool row, or ``-1e9`` added
over it) averages all Sk keys in sdpa, which writes ``-1e9`` over the
causally forbidden keys too; the port folds that edge into a full bias
for these masks and zeroes ds above the diagonal, and a test holds every
row of it to the reference.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas.flash_attention import (
    _mask_mode, flash_attention as ref_flash_attention)

from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.ops.kernels import flash_attention as FA

TOL = dict(atol=2e-5, rtol=2e-5)
B, H, S, D = 2, 3, 24, 16
MASKED_ROW = (1, 3)          # (batch, query row) masked everywhere


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def _mask(kind, rng):
    if kind == "b1q1_bool_row":
        m = np.ones((B, 1, S, 1), bool)
        m[MASKED_ROW[0], 0, MASKED_ROW[1], 0] = False
    elif kind.startswith("bhq1_additive"):
        m = (rng.randn(B, H, S, 1) * 2).astype("f4")
        if kind.endswith("_row"):
            m[MASKED_ROW[0], :, MASKED_ROW[1], 0] = -1e9
    elif kind == "1111_additive":
        m = np.full((1, 1, 1, 1), -0.5, "f4")
    elif kind == "1111_bool_false":
        m = np.zeros((1, 1, 1, 1), bool)
    return m


def _inputs(kind):
    rng = np.random.RandomState(sorted(MASKS).index(kind))
    q, k, v, g = (rng.randn(B, H, S, D).astype("f4") for _ in range(4))
    return q, k, v, g, _mask(kind, rng)


def _reference(q, k, v, g, mask, causal):
    """out, dq, dk, dv of the JAX package's flash_attention (its sdpa path
    on these masks)."""
    assert _mask_mode(mask.shape, B, H, S, S) == "fallback"
    out, vjp = jax.vjp(
        lambda q, k, v: ref_flash_attention(
            q, k, v, attn_mask=jnp.asarray(mask), causal=causal,
            force=True).data,
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(out)] + [np.asarray(a) for a in vjp(jnp.asarray(g))]


def _port_autograd(q, k, v, g, mask, causal):
    qt, kt, vt = (_t(a).requires_grad_() for a in (q, k, v))
    out = FA.flash_attention(qt, kt, vt, attn_mask=_t(mask), causal=causal)
    out.backward(_t(g))
    return [out.detach().numpy()] + [t.grad.numpy() for t in (qt, kt, vt)]


def _port_explicit(q, k, v, g, mask, causal):
    qt, kt, vt, gt, mt = (_t(a) for a in (q, k, v, g, mask))
    out, m, l = FA.flash_attention_fwd(qt, kt, vt, mt, causal=causal)
    grads = FA.flash_attention_bwd(qt, kt, vt, mt, out, m, l, gt,
                                   causal=causal)
    return [out.numpy()] + [a.numpy() for a in grads]


MASKS = ("b1q1_bool_row", "bhq1_additive", "bhq1_additive_row",
         "1111_additive", "1111_bool_false")
# masks with a row masked everywhere (a bool row, or -1e9 added over it)
ROW_MASKED = ("b1q1_bool_row", "bhq1_additive_row", "1111_bool_false")
# under causal those are the case apart (see the module doc)
CASES = [(kind, causal) for kind in MASKS for causal in (False, True)
         if not (causal and kind in ROW_MASKED)]


@pytest.mark.parametrize("route", ["autograd", "explicit"])
@pytest.mark.parametrize("kind,causal", CASES)
def test_sdpa_only_mask_matches_reference(kind, causal, route):
    q, k, v, g, mask = _inputs(kind)
    want = _reference(q, k, v, g, mask, causal)
    run = _port_autograd if route == "autograd" else _port_explicit
    kernels.reset_launches()
    got = run(q, k, v, g, mask, causal)
    assert sum(kernels.launches.values()) == 0   # the plain versions
    for name, a, r in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, r, err_msg=name, **TOL)
    if kind in ROW_MASKED:
        # sdpa's uniform average over the keys
        b, i = MASKED_ROW if kind != "1111_bool_false" else (0, 0)
        np.testing.assert_allclose(got[0][b, :, i], v[b].mean(axis=1),
                                   **TOL)
    if "bool" in kind:
        # and no gradient to q from a row that `where` masked
        assert not got[1][b, :, i].any()


@pytest.mark.parametrize("kind", ["b1q1_bool_row", "bhq1_additive_row"])
def test_masked_row_under_causal_matches_reference(kind):
    """Under causal, a row masked everywhere is sdpa's average over all Sk
    keys, in the port as in the reference, by both routes; every row,
    output and gradient agrees."""
    q, k, v, g, mask = _inputs(kind)
    want = _reference(q, k, v, g, mask, True)
    b, i = MASKED_ROW
    np.testing.assert_allclose(want[0][b, :, i], v[b].mean(axis=1), **TOL)
    for run in (_port_autograd, _port_explicit):
        kernels.reset_launches()
        got = run(q, k, v, g, mask, True)
        assert sum(kernels.launches.values()) == 0   # the plain versions
        for name, a, r in zip(("out", "dq", "dk", "dv"), got, want):
            np.testing.assert_allclose(a, r, err_msg=name, **TOL)
        if "bool" in kind:
            assert not got[1][b, :, i].any()


@pytest.mark.parametrize("shape", [(3, 1, 1, 1), (2, 1, 5, 1),
                                   (2, 4, 24, 1), (1, 1, 1, 1, 1)])
def test_masks_that_do_not_broadcast_still_raise(shape):
    q = torch.zeros(B, H, S, D)
    with pytest.raises(ValueError):
        FA.flash_attention(q, q, q, attn_mask=torch.zeros(shape))
    with pytest.raises(ValueError):
        FA.flash_attention_fwd(q, q, q, torch.ones(shape, dtype=torch.bool))
