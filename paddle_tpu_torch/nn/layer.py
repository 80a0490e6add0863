"""paddle_tpu_torch.nn.layer — the Layer base class.

Counterpart of ``paddle_tpu/nn/layer.py``: a ``torch.nn.Module`` with
paddle's ``create_parameter``, ``register_buffer``, ``set_state_dict``
and ``clear_gradients``. Parameter and buffer names and layouts are the JAX
package's (Linear weights ``[in, out]``, convolution weights OIHW), so
``state_dict()`` keys and shapes match the JAX ``Layer.state_dict()`` one
to one. ``eval()``/``train()`` and traversal are torch's own; torch's
``parameters()`` order (a layer's own parameters, then each sublayer's in
the order they were set, tied ones once) is the JAX ``Layer``'s, so an
optimizer sees the parameters in the reference's order.
"""
from __future__ import annotations

import torch
from torch import nn

from .. import initializer as I


class Layer(nn.Module):
    """Base network building block."""

    def __init__(self, dtype=torch.float32):
        super().__init__()
        self._dtype = dtype

    def create_parameter(self, shape, dtype=None, attr=None,
                         default_initializer=None, is_bias=False,
                         generator=None):
        """A new ``nn.Parameter`` of ``shape``, drawn on the CPU by
        ``default_initializer`` (else zeros for a bias, Xavier-uniform
        otherwise) from ``generator`` (default: the global one). ``attr``
        may be ``None`` or ``False`` (no parameter: returns ``None``)."""
        if attr is False:
            return None
        if attr is not None:
            raise TypeError(f"create_parameter: unsupported attr {attr!r} "
                            f"(the port takes None or False)")
        init = default_initializer or (
            I.Constant(0.0) if is_bias else I.XavierUniform())
        data = init(shape, dtype or self._dtype, generator=generator)
        return nn.Parameter(data)

    def register_buffer(self, name, tensor, persistable=True):
        """Non-trainable state (running statistics), under the
        reference's signature; a persistable buffer is part of
        ``state_dict()`` under the reference's key."""
        super().register_buffer(name, tensor, persistent=persistable)
        return tensor

    def set_state_dict(self, state_dict, use_structured_name=True):
        """Copy ``state_dict`` (``{name: tensor or numpy array}``, bf16 as
        ``ml_dtypes.bfloat16`` as the JAX package saves it) into this
        layer's parameters and buffers in place, each cast to its dtype on
        its device, as the reference's ``set_state_dict`` does: keys it
        does not know and keys it lacks are returned as ``(missing,
        unexpected)``, not raised. Layers whose state derives from their
        buffers (the frozen int8 layers) refresh it."""
        from ..convert import from_numpy
        own = self.state_dict()
        tensors = {}
        for name, value in state_dict.items():
            if name in own:
                if not isinstance(value, torch.Tensor):
                    value = from_numpy(value)
                target = own[name]
                if tuple(value.shape) != tuple(target.shape):
                    raise ValueError(
                        f"set_state_dict: {name} has shape "
                        f"{tuple(value.shape)}, the layer wants "
                        f"{tuple(target.shape)}")
                tensors[name] = value.to(dtype=target.dtype)
        result = self.load_state_dict(tensors, strict=False)
        unexpected = [k for k in state_dict if k not in own]
        return list(result.missing_keys), unexpected

    set_dict = set_state_dict
    load_dict = set_state_dict

    def clear_gradients(self):
        """Drop every parameter's gradient (``Layer.clear_gradients``)."""
        for p in self.parameters():
            p.grad = None
