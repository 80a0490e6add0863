"""paddle_tpu_torch.convert — carry the JAX package's weights into the port.

The port keeps the JAX package's parameter and buffer names and layouts
(Linear weights ``[in, out]``, convolution weights OIHW, batch norm's
running statistics ``_mean`` and ``_variance``), so a JAX
``Layer.state_dict()`` taken as numpy (``state_dict(keep_vars=False)``)
loads into the port's model of the same configuration key for key, and
:func:`export_state` takes the port's back out the same way, so that two
models can be compared key for key after training steps.
"""
from __future__ import annotations

import numpy as np
import torch


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
            src = torch.from_numpy(np.array(arrays[name], copy=True))
            t.copy_(src.to(dtype=t.dtype))
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
