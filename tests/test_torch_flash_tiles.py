"""Flash attention's plain versions against the JAX package's Pallas
kernels at the shapes the bf16 tensor-core kernels tile: head dims 64 and
128, float32 and bf16 inputs, query and key lengths that are 1, one past a
16- or 64-row tile (17, 65), ragged (200) or unequal (77 over 200, 200
over 77), every mask kind, causal (top-left, also where Sq != Sk), and
dropout.

On the CPU the forward wrapper computes its plain version and
``FlashAttentionFunction`` runs the plain forward and backward. The plain
forward is held against the Pallas forward (``_flash_fwd_res``, through
the forward rule of ``_flash``'s custom vjp), and the plain backward, from
the reference's own forward output, against its backward rule (``_bwd``:
what ``jax.vjp`` of ``_flash`` runs), both in interpret mode (blocks of
16, or 64 for the long cases), on the same inputs made with numpy from a
seed; the Function's gradients must equal the plain backward's from its
own forward. With dropout the port's plain versions are
given the reference's own interpret-mode keep mask.

Tolerances. float32, and the f32 row statistics m and l: atol and rtol
2e-5, as in ``test_torch_kernels_bwd.py`` (both sides compute in float32;
only the summation order differs). bf16 inputs: both sides compute in
float32 from the same bf16 values and round the result to bf16 once, so
an output may differ by one bf16 step of its own size (2^-8 relative at
most), plus the float32 tolerance where the two float32 results straddle
a step or the result is small.

The CUDA kernels at the same grid are held against these plain versions on
the card in ``test_torch_cuda.py``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas.flash_attention import _bwd as _flash_bwd_rule
from paddle_tpu.ops.pallas.flash_attention import _fwd as _flash_fwd_rule
from paddle_tpu.ops.pallas.flash_attention import (_canon_mask,
                                                   _host_keep_mask,
                                                   _mask_mode)

from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.ops.kernels import flash_attention as FA

from flash_grid import DROPOUT_P, GRID

F32_TOL = dict(atol=2e-5, rtol=2e-5)
SEED = (1234, -5678)

B, H = 2, 2


def _block(sq, sk):
    return 16 if max(sq, sk) <= 65 else 64


def _case(name):
    """numpy f32 q, k, v, g (bf16 cases: values already rounded to bf16,
    so both packages see the same numbers), the mask, and the case."""
    d, dtype, sq, sk, kind, causal, p_drop = GRID[name]
    rng = np.random.RandomState(sorted(GRID).index(name))
    q, g = (rng.randn(B, H, sq, d).astype("f4") for _ in range(2))
    k, v = (rng.randn(B, H, sk, d).astype("f4") for _ in range(2))
    if dtype == "bfloat16":
        q, k, v, g = (torch.from_numpy(a).bfloat16().float().numpy()
                      for a in (q, k, v, g))
    mask = None
    if kind == "key":
        mask = np.where(rng.rand(B, 1, 1, sk) < 0.3, -1e9, 0.0).astype("f4")
    elif kind == "full":
        mask = (rng.randn(1, H, sq, sk) * 2).astype("f4")
    elif kind == "bool":
        mask = rng.rand(B, 1, sq, sk) > 0.3
        mask[0, 0, 5, :] = False          # query row 5 sees no key
    return q, k, v, g, mask, causal, p_drop, dtype


def _to_jax(a, dtype):
    return jnp.asarray(a).astype(getattr(jnp, dtype))


def _to_torch(a, dtype):
    return torch.from_numpy(np.array(a)).to(getattr(torch, dtype))


def _np(a):
    """numpy f32 of a JAX or torch array, bf16 included."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _assert_close(got, ref, dtype, what):
    got, ref = _np(got), _np(ref)
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, err_msg=what, **F32_TOL)
        return
    # one bf16 step at the larger of the two, plus the float32 tolerance
    big = np.maximum(np.abs(got), np.abs(ref))
    step = 2.0 ** (np.floor(np.log2(np.maximum(big, 2.0 ** -126))) - 7)
    err = np.abs(got - ref)
    lim = step + F32_TOL["atol"] + F32_TOL["rtol"] * np.abs(ref)
    assert np.all(err <= lim), (
        f"{what}: max error {err.max()} over the limit at "
        f"{np.unravel_index(np.argmax(err - lim), err.shape)}")


def _jax_mask(mask, sq, sk):
    cm = None if mask is None else _canon_mask(jnp.asarray(mask))
    return cm, _mask_mode(None if mask is None else mask.shape, B, H, sq, sk)


def _keep(seed, sq, sk, block):
    """The reference's interpret-mode keep mask, cut to (B*H, Sq, Sk): it
    is drawn at the padded shape its wrapper pads to."""
    bq, bk = min(block, max(sq, 8)), min(block, sk)
    sq_pad, sk_pad = -(-sq // bq) * bq, -(-sk // bk) * bk
    keep = _host_keep_mask(jnp.asarray(seed, jnp.int32), B * H, sq_pad,
                           sk_pad, DROPOUT_P)
    return torch.from_numpy(np.array(keep[:, :sq, :sk]))


@functools.lru_cache(maxsize=None)
def _reference(case):
    """The reference on one case, once per process: out, m, l, dq, dk, dv
    as numpy f32, from the rules of ``_flash``'s custom vjp (what
    ``jax.vjp`` runs; its residuals hold the forward's m and l) under one
    ``jax.jit``, which compiles the case once rather than op by op."""
    q, k, v, g, mask, causal, p_drop, dtype = _case(case)
    sq, sk = q.shape[2], k.shape[2]
    block = _block(sq, sk)
    cm, mode = _jax_mask(mask, sq, sk)

    @jax.jit
    def run(q, k, v, g, cm, seed):
        out, res = _flash_fwd_rule(q, k, v, cm, mode, seed, causal, None,
                                   block, block, p_drop)
        grads = _flash_bwd_rule(mode, causal, None, block, block, p_drop,
                                res, g)[:3]
        return (out, res[6], res[7]) + grads

    got = run(_to_jax(q, dtype), _to_jax(k, dtype), _to_jax(v, dtype),
              _to_jax(g, dtype), cm, jnp.asarray(SEED, jnp.int32))
    out, m, l, dq, dk, dv = (np.array(_np(a)) for a in got)
    return (out, m[..., 0].reshape(B * H, sq), l[..., 0].reshape(B * H, sq),
            dq, dk, dv)


@pytest.mark.parametrize("case", list(GRID))
def test_flash_fwd_plain_matches_pallas_at_tile_edges(case):
    q, k, v, g, mask, causal, p_drop, dtype = _case(case)
    sq, sk = q.shape[2], k.shape[2]
    out_ref, m_ref, l_ref = _reference(case)[:3]
    keep = _keep(SEED, sq, sk, _block(sq, sk)) if p_drop else None
    tm = None if mask is None else torch.from_numpy(np.array(mask))
    kernels.reset_launches()
    out, m, l = FA.flash_attention_fwd_plain(
        _to_torch(q, dtype), _to_torch(k, dtype), _to_torch(v, dtype), tm,
        causal=causal, dropout_p=p_drop, keep=keep)
    if not p_drop:
        # the wrapper on a CPU tensor is the plain version, not a launch
        out_w, _, _ = FA.flash_attention_fwd(
            _to_torch(q, dtype), _to_torch(k, dtype), _to_torch(v, dtype),
            tm, causal=causal)
        assert torch.equal(out_w, out)
    assert sum(kernels.launches.values()) == 0
    assert out.dtype == getattr(torch, dtype)
    _assert_close(out, out_ref, dtype, "out")
    _assert_close(m, m_ref, "float32", "m")
    _assert_close(l, l_ref, "float32", "l")
    if GRID[case][4] == "bool":
        # the kernels' semantics: a row with no key gives 0, and m = 0
        assert np.all(_np(out)[0, :, 5] == 0.0)
        assert np.all(_np(m).reshape(B, H, sq)[0, :, 5] == 0.0)


@pytest.mark.parametrize("case", list(GRID))
def test_flash_bwd_plain_matches_pallas_vjp_at_tile_edges(case):
    q, k, v, g, mask, causal, p_drop, dtype = _case(case)
    sq, sk = q.shape[2], k.shape[2]
    out_ref, m_ref, l_ref, *ref = _reference(case)
    tm = None if mask is None else torch.from_numpy(np.array(mask))
    qt, kt, vt, gt = (_to_torch(a, dtype) for a in (q, k, v, g))
    keep = _keep(SEED, sq, sk, _block(sq, sk)) if p_drop else None
    # the plain backward from the reference's own forward: both sides
    # start from the same bf16 output, so the tolerance above holds (from
    # two bf16 outputs a step apart, delta = rowsum(dO * O) and the
    # gradients it enters differ by more)
    got = FA.flash_attention_bwd_plain(
        qt, kt, vt, tm, _to_torch(out_ref, dtype), torch.from_numpy(m_ref),
        torch.from_numpy(l_ref), gt, causal=causal, dropout_p=p_drop,
        keep=keep)
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        assert a.dtype == getattr(torch, dtype) and a.shape == r.shape
        _assert_close(a, r, dtype, name)
    if GRID[case][4] == "bool":
        # no key to attend: no gradient for that query
        assert np.all(_np(got[0])[0, :, 5] == 0.0)
    if p_drop:
        return
    # the Function: the same plumbing the card uses, its forward within
    # the tolerance of the reference's and its backward the plain one's
    qg, kg, vg = (t.clone().requires_grad_() for t in (qt, kt, vt))
    out = FA.flash_attention(qg, kg, vg, attn_mask=tm, causal=causal)
    assert type(out.grad_fn).__name__ == "FlashAttentionFunctionBackward"
    out.backward(gt)
    _assert_close(out, out_ref, dtype, "out")
    o2, m2, l2 = FA.flash_attention_fwd_plain(qt, kt, vt, tm, causal=causal)
    want = FA.flash_attention_bwd_plain(qt, kt, vt, tm, o2, m2, l2, gt,
                                        causal=causal)
    for a, w in zip((qg.grad, kg.grad, vg.grad), want):
        torch.testing.assert_close(a, w, rtol=0, atol=0)
