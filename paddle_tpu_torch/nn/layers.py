"""paddle_tpu_torch.nn.layers — the Layers BERT and ResNet are built of.

Counterpart of the same classes in ``paddle_tpu/nn/layers.py`` (``ReLU``
lives in the reference's ``nn/activation.py``): ``Linear``, ``LayerNorm``,
``Embedding``, ``Dropout``, ``Conv2D``, ``BatchNorm`` / ``BatchNorm1D`` /
``BatchNorm2D``, ``ReLU``, ``MaxPool2D``, ``AdaptiveAvgPool2D`` and
``Flatten``, with the same parameter and buffer names, layouts and
default initialisers.
"""
from __future__ import annotations

import math

import torch

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
    port's kernels (forward and backward under one autograd ``Function``
    on a CUDA tensor, their plain versions on a CPU one), mirroring the
    JAX layer's Pallas branch; otherwise the plain ``F.layer_norm``."""

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
    """Dropout in training mode, its mask drawn on the input's device."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train"):
        super().__init__()
        self._a = dict(p=p, axis=axis, mode=mode)

    def forward(self, x):
        return F.dropout(x, training=self.training, **self._a)


class Conv2D(Layer):
    """2-D convolution; the weight is OIHW for either ``data_format``,
    He-normal by default; ``bias_attr=False`` leaves the bias out."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, weight_attr=None,
                 bias_attr=None, data_format="NCHW"):
        super().__init__()
        ks = F._pair(kernel_size)
        self._attrs = dict(stride=stride, padding=padding, dilation=dilation,
                           groups=groups, data_format=data_format)
        fan_in = in_channels * ks[0] * ks[1] // groups
        self.weight = self.create_parameter(
            (out_channels, in_channels // groups, ks[0], ks[1]),
            attr=weight_attr,
            default_initializer=I.Normal(0.0, math.sqrt(2.0 / fan_in)))
        self.bias = self.create_parameter((out_channels,), attr=bias_attr,
                                          is_bias=True)

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, **self._attrs)


class BatchNorm(Layer):
    """Batch norm with running statistics in the buffers ``_mean`` and
    ``_variance``, written back (in place, outside the autograd graph)
    only in training mode. A channels-last ``data_format`` (``"NHWC"``,
    ``"NLC"``, or a 2-D input) goes through the port's batch-norm kernels
    under ``kernels.configure(batch_norm=True)``; see
    :func:`paddle_tpu_torch.ops.nn_ops.batch_norm`."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 dtype=None):
        super().__init__(dtype or torch.float32)
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self.weight = self.create_parameter(
            (num_features,), attr=weight_attr,
            default_initializer=I.Constant(1.0))
        self.bias = self.create_parameter((num_features,), attr=bias_attr,
                                          is_bias=True)
        self.register_buffer("_mean",
                             torch.zeros(num_features, dtype=self._dtype))
        self.register_buffer("_variance",
                             torch.ones(num_features, dtype=self._dtype))

    def forward(self, x):
        out, new_mean, new_var = F.batch_norm(
            x, self._mean, self._variance, self.weight, self.bias,
            training=self.training, momentum=self._momentum,
            epsilon=self._epsilon, data_format=self._data_format)
        if self.training:
            with torch.no_grad():
                self._mean.copy_(new_mean)
                self._variance.copy_(new_var)
        return out


class BatchNorm1D(BatchNorm):
    def __init__(self, num_features, **kw):
        kw.setdefault("data_format", "NCL")
        super().__init__(num_features, **kw)


class BatchNorm2D(BatchNorm):
    pass


class ReLU(Layer):
    def forward(self, x):
        return F.relu(x)


class MaxPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 data_format="NCHW"):
        super().__init__()
        self._a = dict(kernel_size=kernel_size, stride=stride,
                       padding=padding, ceil_mode=ceil_mode,
                       data_format=data_format)

    def forward(self, x):
        return F.max_pool2d(x, **self._a)


class AdaptiveAvgPool2D(Layer):
    def __init__(self, output_size, data_format="NCHW"):
        super().__init__()
        self._a = dict(output_size=output_size, data_format=data_format)

    def forward(self, x):
        return F.adaptive_avg_pool2d(x, **self._a)


class Flatten(Layer):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self._start, self._stop = start_axis, stop_axis

    def forward(self, x):
        return F.flatten(x, self._start, self._stop)
