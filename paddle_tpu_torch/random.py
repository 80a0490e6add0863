"""paddle_tpu_torch.random — the seed and the generator behind parameter
initialisation.

Counterpart of ``paddle_tpu/random.py``. The JAX package threads one
global ``jax.random`` key; the port keeps one global CPU
``torch.Generator`` instead, which initialisers and dropout draw from
unless the caller passes its own. The two streams cannot match, so
parity tests carry weights across (:mod:`paddle_tpu_torch.convert`)
rather than re-drawing them. Nothing on the serving path draws: dropout
is off in eval mode.
"""
from __future__ import annotations

import torch

_generator = torch.Generator().manual_seed(0)


def seed(value):
    """Reseed the global generator (``paddle.seed``)."""
    _generator.manual_seed(int(value))
    return int(value)


def generator():
    """The global CPU generator initialisers and dropout draw from."""
    return _generator
