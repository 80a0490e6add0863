"""paddle_tpu_torch.ops.math — the math ops the BERT training path needs.

Counterpart of ``paddle_tpu/ops/math.py``, limited to ``matmul``.
"""
from __future__ import annotations

import torch

from .. import amp


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0):
    """Batched matmul with optional transposes of the last two axes; AMP
    white-listed (both inputs cast to the compute dtype under
    :func:`paddle_tpu_torch.amp.auto_cast`)."""
    x, y = amp.maybe_cast(x, y)
    if transpose_x and x.dim() > 1:
        x = x.transpose(-1, -2)
    if transpose_y and y.dim() > 1:
        y = y.transpose(-1, -2)
    out = torch.matmul(x, y)
    return out * alpha if alpha != 1.0 else out
