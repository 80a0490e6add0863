"""paddle_tpu_torch.device — which device the port's entry points use.

Counterpart of ``paddle_tpu/device.py``. The default is the CUDA card:
an entry point runs on the CPU only when the caller asks for it
(``set_device("cpu")`` or ``device="cpu"``), and asking for the card on a
machine without one raises instead of carrying on on the CPU.
"""
from __future__ import annotations

import numpy as np
import torch

_current = None


def _canon(device):
    name = str(device)
    kind, _, idx = name.partition(":")
    if kind in ("gpu", "cuda"):
        return f"cuda:{idx}" if idx else "cuda"
    if kind == "cpu":
        return "cpu"
    raise ValueError(f"unknown device {device!r}; use 'cuda', 'cuda:N', "
                     f"'gpu' or 'cpu'")


def set_device(device):
    """``paddle.set_device('gpu' | 'gpu:N' | 'cuda' | 'cpu')``."""
    global _current
    _current = _canon(device)
    return _current


def get_device():
    """The device entry points use when given none: ``"cuda"`` unless
    :func:`set_device` chose another."""
    return _current or "cuda"


def resolve(device=None):
    """``device`` (default :func:`get_device`) as a ``torch.device``;
    raises ``RuntimeError`` when it names CUDA and there is no card."""
    dev = torch.device(_canon(device if device is not None
                              else get_device()))
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch runs on a CUDA card by default and none is "
            "available; pass device='cpu' to run on the CPU")
    return dev


def to_device(array, device, dtype=None):
    """A host array as a tensor on ``device`` (in ``dtype`` where given).
    To a CUDA card the copy leaves from pinned memory without blocking, so
    the host does not wait for the work queued before it, as a copy from
    pageable memory would make it wait; on the CPU the tensor shares the
    array's memory."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if dtype is not None:
        t = t.to(dtype)
    device = torch.device(device)
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def host_tensor(array, device):
    """A host array as a CPU tensor to copy onto ``device``: in pinned
    memory where ``device`` is a CUDA card (a copy from it leaves without
    blocking, and the caching host allocator keeps the block until the
    copy is done), else sharing the array's memory."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    return t.pin_memory() if torch.device(device).type == "cuda" else t
