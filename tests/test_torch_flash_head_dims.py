"""Flash attention at head dims other than 64 and 128, and in float16.

The flash kernels are built for head dims 64 and 128 and for float32 and
bf16. On the card the wrapper zero-pads any other head dim up to 128 to
the next of the two and computes any other float dtype in float32
(``_padded_fwd`` and ``_padded_bwd`` in
``paddle_tpu_torch/ops/kernels/flash_attention.py``), as the reference's
kernel casts every operand to float32
(``paddle_tpu/ops/pallas/flash_attention.py``). The CPU runs the plain
versions, so here:

* the pad-and-slice helpers are run around the plain versions, which
  must then give what the plain versions give unpadded, forward and
  backward, with and without dropout (tolerance: float32's 1e-6 relative
  and 1e-5 absolute, ``torch.testing``'s default, for the zero columns
  move the summation order of the products);
* the port's ``flash_attention`` (its autograd Function) is held against
  the reference's Pallas forward and backward rules in interpret mode at
  head dims 8, 16, 32 and 96, and in float16 (float32: atol and rtol
  2e-5, as in ``test_torch_flash_tiles.py``; float16: both round a
  float32 result to float16 once, so one float16 step, 2^-10 relative,
  plus that);
* a head dim above 128 raises, a stated restriction.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas.flash_attention import _bwd as _flash_bwd_rule
from paddle_tpu.ops.pallas.flash_attention import _fwd as _flash_fwd_rule
from paddle_tpu.ops.pallas.flash_attention import _canon_mask, _mask_mode

from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.ops.kernels import flash_attention as FA

B, H, S = 2, 3, 40
F32_TOL = dict(atol=2e-5, rtol=2e-5)
HEAD_DIMS = (8, 16, 32, 96)


def _inputs(d, seed):
    rng = np.random.RandomState(seed)
    q, k, v, g = (rng.randn(B, H, S, d).astype("f4") for _ in range(4))
    mask = np.where(rng.rand(B, 1, 1, S) < 0.3, -1e9, 0.0).astype("f4")
    return q, k, v, g, mask


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("dropout_p", [0.0, 0.1])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_padded_path_equals_unpadded_through_the_plain_versions(d,
                                                                dropout_p):
    q, k, v, g, mask = (_t(a) for a in _inputs(d, d))
    cm = FA._canon_mask(mask, B, H, S, S)
    seed = (d, 7)
    widths = []

    def fwd(q, k, v, cm, causal, scale, p, seed):
        widths.append(q.shape[3])
        return FA._fwd_plain(q, k, v, cm, causal, scale, p, seed, None)

    def bwd(q, k, v, cm, out, m, l, g, causal, scale, p, seed):
        widths.append(out.shape[3])
        return FA._bwd_plain(q, k, v, cm, out, m, l, g, causal, scale, p,
                             seed, None)

    out, m, l = FA._padded_fwd(fwd, q, k, v, cm, 1, None, dropout_p, seed)
    want = FA._fwd_plain(q, k, v, cm, 1, None, dropout_p, seed, None)
    for got, ref in zip((out, m, l), want):
        assert got.shape == ref.shape
        torch.testing.assert_close(got, ref)
    grads = FA._padded_bwd(bwd, q, k, v, cm, out, m, l, g, 1, None,
                           dropout_p, seed)
    want = FA._bwd_plain(q, k, v, cm, out, m, l, g, 1, None, dropout_p,
                         seed, None)
    for got, ref in zip(grads, want):
        assert got.shape == ref.shape
        torch.testing.assert_close(got, ref)
    assert widths == [FA._kernel_head_dim(d)] * 2 == [64 if d <= 64
                                                      else 128] * 2


def test_padded_path_computes_float16_in_float32():
    q, k, v, g, mask = (_t(a) for a in _inputs(64, 3))
    q16, k16, v16, g16 = (t.half() for t in (q, k, v, g))
    cm = FA._canon_mask(mask, B, H, S, S)
    seen = []

    def fwd(q, k, v, *rest):
        seen.append(q.dtype)
        return FA._fwd_plain(q, k, v, *rest, None)

    out, m, l = FA._padded_fwd(fwd, q16, k16, v16, cm, 0, None, 0.0, (0, 0))
    assert seen == [torch.float32] and out.dtype == torch.float16
    ref = FA._fwd_plain(q16.float(), k16.float(), v16.float(), cm, 0, None,
                        0.0, (0, 0), None)[0]
    assert torch.equal(out, ref.half())
    grads = FA._padded_bwd(
        lambda *a: FA._bwd_plain(*a, None), q16, k16, v16, cm, out, m, l,
        g16, 0, None, 0.0, (0, 0))
    assert all(t.dtype == torch.float16 for t in grads)


@pytest.mark.parametrize("d", [129, 192, 256])
def test_head_dims_above_128_raise(d):
    with pytest.raises(ValueError, match="head dims up to 128"):
        FA._kernel_head_dim(d)
    q = torch.zeros(1, 1, 4, d)
    with pytest.raises(ValueError, match="head dims up to 128"):
        FA._padded_fwd(None, q, q, q, (None, None, 1, 1), 0, None, 0.0,
                       (0, 0))


def test_integer_inputs_raise():
    with pytest.raises(TypeError, match="float dtype"):
        FA._kernel_dtype(torch.int32)


def _reference(q, k, v, g, mask, causal, dtype):
    """out, dq, dk, dv of the reference's ``_flash`` rules (what
    ``jax.vjp`` runs) in interpret mode, as numpy f32."""
    cm = _canon_mask(jnp.asarray(mask))
    mode = _mask_mode(mask.shape, B, H, S, S)
    jd = getattr(jnp, dtype)

    @jax.jit
    def run(q, k, v, g, cm):
        out, res = _flash_fwd_rule(q, k, v, cm, mode,
                                   jnp.zeros((2,), jnp.int32), causal, None,
                                   16, 16, 0.0)
        return (out,) + _flash_bwd_rule(mode, causal, None, 16, 16, 0.0,
                                        res, g)[:3]

    got = run(*(jnp.asarray(a).astype(jd) for a in (q, k, v, g)), cm)
    return [np.asarray(a.astype(jnp.float32)) for a in got]


def _port(q, k, v, g, mask, causal, dtype):
    qt, kt, vt = (_t(a).to(getattr(torch, dtype)).requires_grad_()
                  for a in (q, k, v))
    kernels.reset_launches()
    out = FA.flash_attention(qt, kt, vt, attn_mask=_t(mask), causal=causal)
    assert type(out.grad_fn).__name__ == "FlashAttentionFunctionBackward"
    out.backward(_t(g).to(out.dtype))
    assert sum(kernels.launches.values()) == 0   # the plain versions
    got = [out] + [t.grad for t in (qt, kt, vt)]
    assert all(t.dtype == getattr(torch, dtype) for t in got)
    return [t.detach().float().numpy() for t in got]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_port_matches_reference_at_other_head_dims(d, causal):
    q, k, v, g, mask = _inputs(d, 100 + d)
    want = _reference(q, k, v, g, mask, causal, "float32")
    got = _port(q, k, v, g, mask, causal, "float32")
    for name, a, r in zip(("out", "dq", "dk", "dv"), got, want):
        assert a.shape == (B, H, S, d)
        np.testing.assert_allclose(a, r, err_msg=name, **F32_TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [16, 64])
def test_port_matches_reference_in_float16(d, causal):
    q, k, v, g, mask = _inputs(d, 200 + d)
    # values float16 holds, so that both packages see the same numbers
    q, k, v, g = (a.astype(np.float16).astype("f4") for a in (q, k, v, g))
    want = _reference(q, k, v, g, mask, causal, "float16")
    got = _port(q, k, v, g, mask, causal, "float16")
    for name, a, r in zip(("out", "dq", "dk", "dv"), got, want):
        big = np.maximum(np.abs(a), np.abs(r))
        step = 2.0 ** (np.floor(np.log2(np.maximum(big, 2.0 ** -24))) - 10)
        lim = step + F32_TOL["atol"] + F32_TOL["rtol"] * np.abs(r)
        err = np.abs(a - r)
        assert np.all(err <= lim), f"{name}: max error {err.max()}"
