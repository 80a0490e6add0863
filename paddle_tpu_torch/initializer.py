"""paddle_tpu_torch.initializer — the parameter initialisers BERT uses.

Counterpart of ``paddle_tpu/initializer.py``, limited to ``Constant``,
``Normal`` and ``XavierUniform``. Each draws on the CPU from an explicit
``torch.Generator`` (default: :func:`paddle_tpu_torch.random.generator`).
"""
from __future__ import annotations

import math

import torch

from . import random as prandom


class Initializer:
    def __call__(self, shape, dtype=torch.float32, generator=None):
        g = generator if generator is not None else prandom.generator()
        return self._init(tuple(int(s) for s in shape), dtype, g)

    def _init(self, shape, dtype, generator):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def _init(self, shape, dtype, generator):
        return torch.full(shape, self.value, dtype=dtype)


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def _init(self, shape, dtype, generator):
        t = torch.randn(shape, generator=generator, dtype=torch.float32)
        return (t * self.std + self.mean).to(dtype)


def _fans(shape):
    if len(shape) == 2:
        return shape[0], shape[1]
    if len(shape) >= 3:
        receptive = math.prod(shape[2:])
        return shape[1] * receptive, shape[0] * receptive
    n = math.prod(shape)
    return n, n


class XavierUniform(Initializer):
    """Glorot uniform over the ``[in, out]`` fans."""

    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def _init(self, shape, dtype, generator):
        fi, fo = _fans(shape)
        fi = self.fan_in or fi
        fo = self.fan_out or fo
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        t = torch.empty(shape, dtype=torch.float32)
        return t.uniform_(-limit, limit, generator=generator).to(dtype)
