"""paddle_tpu_torch.random — the seed and the generators behind parameter
initialisation, dropout and the attention kernels' dropout seeds.

Counterpart of ``paddle_tpu/random.py``. The JAX package threads one
global ``jax.random`` key; the port keeps one ``torch.Generator`` per
device instead, all seeded by :func:`seed`: the CPU one, which
initialisers draw from, and one for each CUDA card, created when a tensor
on it first draws, so that dropout draws its mask on the tensor's own
device with no copy from the host. :func:`next_seed_pair` gives the
attention kernels two 32-bit words from the CPU generator (the counterpart
of ``next_key_graph``), without touching the card. The JAX and PyTorch
streams cannot match, so parity tests carry weights across
(:mod:`paddle_tpu_torch.convert`) and run dropout at 0 or hand both sides
the same mask.
"""
from __future__ import annotations

import torch

_seed_value = 0
_generators = {"cpu": torch.Generator().manual_seed(0)}


def _key(device):
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return str(dev)


def seed(value):
    """Reseed every device's generator (``paddle.seed``)."""
    global _seed_value
    _seed_value = int(value)
    for g in _generators.values():
        g.manual_seed(_seed_value)
    return _seed_value


def generator(device="cpu"):
    """The generator of ``device`` (default: the CPU one initialisers draw
    from), created and seeded with the current seed on first use."""
    key = _key(device)
    g = _generators.get(key)
    if g is None:
        g = torch.Generator(device=key).manual_seed(_seed_value)
        _generators[key] = g
    return g


def next_seed_pair():
    """Two int32 words for a kernel's counter-based dropout, drawn from
    the CPU generator: no device work and no sync."""
    lo, hi = torch.randint(-2 ** 31, 2 ** 31, (2,), dtype=torch.int64,
                           generator=_generators["cpu"]).tolist()
    return lo, hi
