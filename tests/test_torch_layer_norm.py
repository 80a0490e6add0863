"""The port's layer norm against the JAX package's Pallas kernels, where the
training step runs it with mixed dtypes or wide rows, and the layer-norm
kernels' choice of instance.

On the CPU, :func:`layer_norm` runs its ``Function`` on the kernels' plain
versions; it is held against ``jax.vjp`` of the Pallas custom-vjp
``_layer_norm2`` run in interpret mode, on the same inputs made with numpy
from a seed.

Tolerances. float32: atol and rtol 1e-5 (both sides compute in float32;
only the summation order differs). bf16 outputs (y and dx, with bf16 x):
rtol 2^-7, one bf16 rounding step: the two float32 results agree to
about 1e-7 but may round to neighbouring bf16 values; atol 1e-5 for the
elements near 0. The float32 weight's gradients of bf16 rows: float32,
atol and rtol 1e-5.

The CUDA kernels themselves are held against their plain versions on the
card in ``test_torch_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas.layer_norm import _layer_norm2

from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.ops.kernels import layer_norm as LN

F32_TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = dict(atol=1e-5, rtol=2.0 ** -7)


def _inputs(n, d, seed):
    rng = np.random.RandomState(seed)
    return ((rng.randn(n, d) * 3 + 1).astype("f4"),
            (rng.rand(d) + 0.5).astype("f4"), rng.randn(d).astype("f4"),
            rng.randn(n, d).astype("f4"))


def _reference(x, w, b, g, eps):
    """y and (dx, dw, db) of the Pallas ``_layer_norm2``, as float32."""
    y, vjp = jax.vjp(lambda x, w, b: _layer_norm2(x, w, b, eps), x, w, b)
    return [np.asarray(a.astype(jnp.float32)) for a in (y, *vjp(g))]


def _port(x, w, b, g, eps):
    """y and (dx, dw, db) of the port's ``layer_norm`` with autograd."""
    x, w, b = (t.detach().requires_grad_() for t in (x, w, b))
    kernels.reset_launches()
    y = LN.layer_norm(x, w, b, eps)
    assert type(y.grad_fn).__name__ == "LayerNormFunctionBackward"
    y.backward(g)
    # the plain versions on a CPU tensor are not launches
    assert sum(kernels.launches.values()) == 0
    return y.detach(), x.grad, w.grad, b.grad


def test_bf16_rows_with_f32_weight_match_pallas_vjp():
    """The masked-LM head's norm on the amp step: bf16 rows, float32
    weight and bias; y and dx in bf16, dw and db in float32."""
    x, w, b, g = _inputs(64, 768, 3)
    eps = 1e-12
    xt = torch.from_numpy(x).to(torch.bfloat16)
    gt = torch.from_numpy(g).to(torch.bfloat16)
    # the same bf16 values on both sides
    xj = jnp.asarray(xt.float().numpy(), dtype=jnp.bfloat16)
    gj = jnp.asarray(gt.float().numpy(), dtype=jnp.bfloat16)
    ref = _reference(xj, jnp.asarray(w), jnp.asarray(b), gj, eps)
    got = _port(xt, torch.from_numpy(w), torch.from_numpy(b), gt, eps)
    assert [t.dtype for t in got] == [torch.bfloat16, torch.bfloat16,
                                      torch.float32, torch.float32]
    for a, r, tol in zip(got, ref, (BF16_TOL, BF16_TOL, F32_TOL, F32_TOL)):
        np.testing.assert_allclose(a.float().numpy(), r, **tol)


@pytest.mark.parametrize("n,d", [(6, 9000), (3, 16384)])
def test_wide_rows_match_pallas_vjp(n, d):
    """Rows wider than a warp holds (the backward took at most 8192)."""
    x, w, b, g = _inputs(n, d, n + d)
    eps = 1e-5
    ref = _reference(*(jnp.asarray(a) for a in (x, w, b, g)), eps)
    got = _port(*(torch.from_numpy(a) for a in (x, w, b, g)), eps)
    for a, r in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), r, **F32_TOL)


@pytest.mark.parametrize("dtype,width", [(torch.float32, 4),
                                         (torch.bfloat16, 8)])
@pytest.mark.parametrize("d", [768, 770, 772, 776, 37, 8])
def test_vector_width_needs_a_multiple_of_16_bytes(dtype, width, d):
    """16-byte accesses only where D holds whole 16-byte chunks."""
    x = torch.zeros(5, d, dtype=dtype)
    w = torch.ones(d)
    want = width if d % width == 0 else 1
    assert LN.vector_width(x, w, w) == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vector_width_takes_the_scalar_instance_for_offset_views(dtype):
    n, d = 6, 768
    flat = torch.zeros(n * d + 1, dtype=dtype)
    # a view one element into its buffer: packed rows, pointer off 16 bytes
    x = flat[1:].view(n, d)
    assert x.is_contiguous() and x.contiguous().data_ptr() == x.data_ptr()
    assert LN.vector_width(x) == 1
    assert LN.vector_width(flat[:-1].view(n, d)) == 16 // x.element_size()
    # whole rows sliced off keep 16-byte alignment; a slice along D is not
    # packed, and the wrappers' .contiguous() copies it into fresh rows
    rows = torch.zeros(4, 10, d, dtype=dtype)[1:].reshape(-1, d)
    assert rows.data_ptr() % 16 == 0 and LN.vector_width(rows) > 1
    cols = torch.zeros(4, 10, d + 1, dtype=dtype)[..., 1:].reshape(-1, d)
    assert not cols.is_contiguous()
    assert LN.vector_width(cols.contiguous()) > 1
    # a weight off 16 bytes takes the scalar instance too
    w = torch.ones(d + 1)[1:]
    assert LN.vector_width(flat[:-1].view(n, d), w) == 1
