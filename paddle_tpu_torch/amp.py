"""paddle_tpu_torch.amp — automatic mixed precision.

Counterpart of ``paddle_tpu/amp.py`` (``auto_cast``, ``is_enabled``,
``compute_dtype``, ``maybe_cast``), with the reference's policy rather than
``torch.autocast``'s: :func:`auto_cast` sets a global flag, and only the
white-listed ops — :func:`paddle_tpu_torch.ops.nn_ops.linear`,
:func:`paddle_tpu_torch.ops.nn_ops.conv2d` and
:func:`paddle_tpu_torch.ops.math.matmul` — cast their floating inputs to
the compute dtype. Batch norm is not on the list: under amp its input is
the convolution's bf16 output while its weight, bias and statistics stay
float32. Parameters stay float32 (master weights), and every
other op keeps the dtypes it is given, so a residual sum of an f32 stream
and a bf16 projection stays f32 by PyTorch's type promotion, as it does in
the JAX package. ``GradScaler`` and ``decorate`` are not ported yet.
"""
from __future__ import annotations

import contextlib

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16}
_state = {"enabled": False, "dtype": torch.bfloat16}


def is_enabled():
    return _state["enabled"]


def compute_dtype():
    return _state["dtype"]


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16"):
    """Within the block, the white-listed ops compute in ``dtype``
    (``"bfloat16"`` or ``"float16"``). Only the reference's default O1
    policy is ported: custom lists and ``level="O2"`` raise."""
    if custom_white_list or custom_black_list or level != "O1":
        raise NotImplementedError(
            "amp.auto_cast: custom op lists and level O2 are not ported "
            "yet; the port casts linear, conv2d and matmul (the O1 white "
            "list)")
    if dtype not in _DTYPES:
        raise ValueError(f"amp.auto_cast: dtype must be one of "
                         f"{sorted(_DTYPES)}, got {dtype!r}")
    prev = dict(_state)
    _state["enabled"] = bool(enable)
    _state["dtype"] = _DTYPES[dtype]
    try:
        yield
    finally:
        _state.update(prev)


def maybe_cast(*tensors):
    """The inputs cast to the compute dtype when auto_cast is on (floating
    tensors of another dtype only; None and integer tensors pass as they
    are); the inputs unchanged otherwise. Returns a tuple."""
    if not _state["enabled"]:
        return tensors
    dt = _state["dtype"]
    return tuple(t.to(dt) if t is not None and t.is_floating_point()
                 and t.dtype != dt else t for t in tensors)
