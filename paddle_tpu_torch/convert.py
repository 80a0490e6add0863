"""paddle_tpu_torch.convert — carry the JAX package's weights into the port.

The port keeps the JAX package's parameter and buffer names and layouts
(Linear weights ``[in, out]``, convolution weights OIHW, batch norm's
running statistics ``_mean`` and ``_variance``), so a JAX
``Layer.state_dict()`` taken as numpy (``state_dict(keep_vars=False)``)
loads into the port's model of the same configuration key for key, and
:func:`export_state` takes the port's back out the same way, so that two
models can be compared key for key after training steps. A frozen int8
model's ``qweight``, ``wscale`` and ``act_scale`` carry across like any
other buffer, and each frozen layer then refreshes its int8 gate and its
GEMM's copy of the weight (``_state_loaded``), so a reference-quantized
model and the port compute the same thing.

:func:`to_numpy` and :func:`from_numpy` move one tensor between the two
worlds in its own dtype: bf16, which numpy lacks, as ``ml_dtypes``'
``bfloat16`` (what the JAX package's arrays give), through an int16 view.
"""
from __future__ import annotations

import numpy as np
import torch


def to_numpy(t):
    """A copy of tensor ``t`` on the host as a numpy array of its dtype
    (bf16 as ``ml_dtypes.bfloat16``)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return np.array(t.cpu().view(torch.int16).numpy(),
                        copy=True).view(ml_dtypes.bfloat16)
    return np.array(t.cpu().numpy(), copy=True)


def from_numpy(a):
    """A CPU tensor holding a copy of array ``a`` in its dtype (an
    ``ml_dtypes.bfloat16`` array as bf16)."""
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def refresh_loaded(model):
    """Tell each layer of ``model`` that keeps state derived from its
    buffers (the frozen int8 layers) that new values arrived."""
    for m in model.modules():
        hook = getattr(m, "_state_loaded", None)
        if hook is not None:
            hook()


def load_jax_state(model, arrays):
    """Copy ``arrays`` (``{name: np.ndarray}``) into ``model``'s parameters
    and buffers, in place, cast to each one's dtype on its device. Raises
    ``KeyError`` on a missing or unexpected key and ``ValueError`` on a
    shape mismatch, before anything is copied. Returns ``model``."""
    own = model.state_dict()
    missing = sorted(set(own) - set(arrays))
    unexpected = sorted(set(arrays) - set(own))
    if missing or unexpected:
        raise KeyError(f"load_jax_state: missing {missing}, unexpected "
                       f"{unexpected}")
    for name, t in own.items():
        shape = tuple(np.shape(arrays[name]))
        if shape != tuple(t.shape):
            raise ValueError(f"load_jax_state: {name} has shape {shape}, "
                             f"the model wants {tuple(t.shape)}")
    with torch.no_grad():
        for name, t in own.items():
            t.copy_(from_numpy(arrays[name]).to(dtype=t.dtype))
    refresh_loaded(model)
    return model


def export_state(model):
    """``model``'s parameters and buffers as ``{name: np.ndarray}`` on the
    host, keyed as :func:`load_jax_state` takes them: copies, never views
    of a CPU model's storage (bf16, which numpy lacks, comes back as
    float32)."""
    out = {}
    for name, t in model.state_dict().items():
        t = t.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        out[name] = np.array(t.cpu().numpy(), copy=True)
    return out
