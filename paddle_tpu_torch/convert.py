"""paddle_tpu_torch.convert — carry the JAX package's weights into the port.

The port keeps the JAX package's parameter names and layouts, so a JAX
``Layer.state_dict()`` taken as numpy (``state_dict(keep_vars=False)``)
loads into the port's model of the same configuration key for key.
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
