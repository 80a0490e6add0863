"""paddle_tpu_torch.nn.layers — Linear, LayerNorm, Embedding, Dropout.

Counterpart of the same four classes in ``paddle_tpu/nn/layers.py``, with
the same parameter names, layouts and default initialisers.
"""
from __future__ import annotations

import math

from .. import initializer as I
from ..ops import nn_ops as F
from ..ops.kernels import layer_norm as K
from .layer import Layer


class Linear(Layer):
    """``y = x @ weight + bias`` with ``weight`` of shape ``[in, out]``."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight = self.create_parameter(
            (in_features, out_features), attr=weight_attr,
            default_initializer=I.XavierUniform())
        self.bias = self.create_parameter((out_features,), attr=bias_attr,
                                          is_bias=True)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return (f"in={self.in_features}, out={self.out_features}, "
                f"bias={self.bias is not None}")


class LayerNorm(Layer):
    """Layer norm over the trailing ``normalized_shape`` axes. With one
    normalized axis and an affine weight and bias it goes through the
    port's kernel wrapper (the kernel on a CUDA tensor, its plain version
    on a CPU one), mirroring the JAX layer's Pallas branch; otherwise the
    plain ``F.layer_norm``."""

    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self._normalized_shape = tuple(normalized_shape)
        self._epsilon = epsilon
        self.weight = self.create_parameter(
            self._normalized_shape, attr=weight_attr,
            default_initializer=I.Constant(1.0))
        self.bias = self.create_parameter(self._normalized_shape,
                                          attr=bias_attr, is_bias=True)

    def forward(self, x):
        if len(self._normalized_shape) == 1 and self.weight is not None \
                and self.bias is not None:
            return K.layer_norm(x, self.weight, self.bias, self._epsilon)
        return F.layer_norm(x, self._normalized_shape, self.weight,
                            self.bias, self._epsilon)


class Embedding(Layer):
    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 weight_attr=None):
        super().__init__()
        self._padding_idx = padding_idx
        self.weight = self.create_parameter(
            (num_embeddings, embedding_dim), attr=weight_attr,
            default_initializer=I.Normal(0.0, 1.0 / math.sqrt(embedding_dim)))

    def forward(self, x):
        return F.embedding(x, self.weight, padding_idx=self._padding_idx)


class Dropout(Layer):
    def __init__(self, p=0.5, axis=None, mode="upscale_in_train"):
        super().__init__()
        self._a = dict(p=p, axis=axis, mode=mode)

    def forward(self, x):
        return F.dropout(x, training=self.training, **self._a)
