"""paddle_tpu_torch.random — the seed and the generators behind parameter
initialisation, dropout and the attention kernels' dropout seeds.

Counterpart of ``paddle_tpu/random.py``. The JAX package threads one
global ``jax.random`` key; the port keeps one ``torch.Generator`` per
device instead, all seeded by :func:`seed`: the CPU one, which
initialisers draw from, and one for each CUDA card, created when a tensor
on it first draws, so that dropout draws its mask on the tensor's own
device with no copy from the host. :func:`next_seed_words` gives the
attention kernels their two 32-bit dropout words as a tensor drawn on the
tensor's own device from that device's generator (the counterpart of
``next_key_graph``): a kernel reads them through a pointer, so a CUDA
graph that captured the draw draws fresh words at every replay, since
the capture registers the card's generator
(:mod:`paddle_tpu_torch.graphs`). The JAX and PyTorch
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


def next_seed_words(device="cpu"):
    """Two int32 words for a kernel's counter-based dropout, as a
    contiguous (2,) int32 tensor drawn on ``device`` from its generator:
    on a card, no host work, no copy and no sync, and a draw that a CUDA
    graph replays afresh."""
    return torch.randint(-2 ** 31, 2 ** 31, (2,), dtype=torch.int32,
                         device=torch.device(_key(device)),
                         generator=generator(device))


def next_seed_pair():
    """:func:`next_seed_words` on the CPU, as two Python ints."""
    lo, hi = next_seed_words("cpu").tolist()
    return lo, hi

