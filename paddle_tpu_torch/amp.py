"""paddle_tpu_torch.amp — automatic mixed precision.

Counterpart of ``paddle_tpu/amp.py`` (``auto_cast``, ``is_enabled``,
``compute_dtype``, ``maybe_cast``, ``GradScaler``, ``decorate``), with the reference's policy rather than
``torch.autocast``'s: :func:`auto_cast` sets a global flag, and only the
white-listed ops — :func:`paddle_tpu_torch.ops.nn_ops.linear`,
:func:`paddle_tpu_torch.ops.nn_ops.conv2d` and
:func:`paddle_tpu_torch.ops.math.matmul` — cast their floating inputs to
the compute dtype. Batch norm is not on the list: under amp its input is
the convolution's bf16 output while its weight, bias and statistics stay
float32. Under O1 parameters stay float32 (master weights), and every
other op keeps the dtypes it is given, so a residual sum of an f32 stream
and a bf16 projection stays f32 by PyTorch's type promotion, as it does in
the JAX package. ``level="O2"`` and custom white and black lists are
accepted and change nothing, as in the reference: O2 is
:func:`decorate`'s, which casts the models' parameters and buffers to the
compute dtype (pure bf16).

:class:`GradScaler` is the reference's dynamic loss scaler, on the device:
the scale (float32), the good and bad counts (int32) and the found-inf
flag are device scalars, found-inf is one multi-tensor norm over every
gradient, a skipped step leaves the parameters, slots and pows bit-equal
(the optimizer's ``_skip``), and the scale's bookkeeping is device
arithmetic, so a step that ``jit.to_static`` captured runs whole inside
its CUDA graph and replays on the scaler's live state. Two departures:
the unscaled gradients keep their dtype (PyTorch holds a gradient in its
parameter's dtype; the reference's bfloat16 gradient times the float32
inverse scale is float32, the same value whenever the scale is a power of
two, as its ratios keep it), and a skipped step costs no copy of the
parameters and slots (the reference snapshots them and selects them
back). Float16 with a scaler on the card is not ported (ROADMAP.md
Queue A item 24): :meth:`GradScaler.scale` and :meth:`GradScaler.unscale_`
raise there.
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


def _dtype(dtype):
    if dtype not in _DTYPES:
        raise ValueError(f"amp: dtype must be one of {sorted(_DTYPES)}, got "
                         f"{dtype!r}")
    return _DTYPES[dtype]


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16"):
    """Within the block, the white-listed ops compute in ``dtype``
    (``"bfloat16"`` or ``"float16"``). ``level`` and the custom lists are
    taken and, as in the reference, change nothing: the O2 recipe casts
    the parameters with :func:`decorate`."""
    dt = _dtype(dtype)
    prev = dict(_state)
    _state["enabled"] = bool(enable)
    _state["dtype"] = dt
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


def decorate(models=None, optimizers=None, level="O1", dtype="bfloat16"):
    """``paddle.amp.decorate``: under ``level="O2"`` every floating
    parameter and buffer of the models is cast to ``dtype`` in place (the
    parameters stay the same objects, so an optimizer built over them
    keeps them); under O1 nothing changes. Returns the models, or
    ``(models, optimizers)`` when optimizers are given."""
    if level == "O2" and models is not None:
        dt = _dtype(dtype)
        for m in models if isinstance(models, (list, tuple)) else [models]:
            m.to(dtype=dt)
    if optimizers is None:
        return models
    return models, optimizers


def _no_float16_on_card(t):
    if t.dtype == torch.float16 and t.device.type != "cpu":
        raise NotImplementedError(
            "amp.GradScaler with float16 on the card is not ported yet "
            "(ROADMAP.md Queue A item 24); train in bfloat16")


class GradScaler:
    """Dynamic loss scaling: ``scale(loss)``, then ``backward()``, then
    ``step(optimizer)`` (or ``minimize``), which unscales the gradients,
    skips the update where any is not finite, and doubles the scale after
    ``incr_every_n_steps`` good steps in a row or halves it after
    ``decr_every_n_nan_or_inf`` bad ones."""

    def __init__(self, enable=True, init_loss_scaling=2.0 ** 15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=1):
        self._enable = enable
        self._scale = torch.tensor(float(init_loss_scaling),
                                   dtype=torch.float32)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._good = torch.zeros((), dtype=torch.int32)
        self._bad = torch.zeros((), dtype=torch.int32)
        self._found_inf = None

    def _to(self, device):
        """The scaler's state moved to ``device`` once, at the first step
        there; in place afterwards."""
        if self._scale.device != device:
            self._scale = self._scale.to(device)
            self._good = self._good.to(device)
            self._bad = self._bad.to(device)

    def scale(self, loss):
        """``loss`` times the scale (a lower-precision loss in float32, as
        the reference's float32 scale promotes it)."""
        if not self._enable:
            return loss
        _no_float16_on_card(loss)
        self._to(loss.device)
        if loss.dtype in (torch.float16, torch.bfloat16):
            loss = loss.float()
        return loss * self._scale

    def unscale_(self, optimizer):
        """Every gradient multiplied by the inverse scale, in place, and
        the found-inf flag set where any of them is not finite, with no
        host read: one multi-tensor float32 norm and one multi-tensor
        multiply over the gradients (``torch._foreach_*``, per dtype and
        device). A norm is finite exactly when its gradient is, except
        that a finite element above about 1.8e19, whose square overflows
        float32, also counts as an overflow."""
        if not self._enable:
            return
        grads = [p.grad for p in optimizer._params() if p.grad is not None]
        if not grads:
            return
        for g in grads:
            _no_float16_on_card(g)
        self._to(grads[0].device)
        inv = torch.reciprocal(self._scale)
        norms = torch._foreach_norm(grads, 2, dtype=torch.float32)
        self._found_inf = ~torch.isfinite(torch.stack(norms)).all()
        groups = {}
        for g in grads:
            groups.setdefault((g.dtype, g.device), []).append(g)
        for gs in groups.values():
            torch._foreach_mul_(gs, inv)

    def step(self, optimizer):
        """Unscale (unless :meth:`unscale_` ran), step the optimizer with
        the found-inf flag as its skip, and update the scale."""
        if not self._enable:
            optimizer.step()
            return
        if self._found_inf is None:
            self.unscale_(optimizer)
        found = self._found_inf
        if found is None:   # no gradient at all
            optimizer.step()
            return
        optimizer._ensure_all_slots()
        optimizer._skip = found
        try:
            optimizer.step()
        finally:
            optimizer._skip = None
        self._update_scale(found)
        self._found_inf = None

    @torch.no_grad()
    def _update_scale(self, found):
        zero = torch.zeros_like(self._good)
        good = torch.where(found, zero, self._good + 1)
        bad = torch.where(found, self._bad + 1, zero)
        up = good >= self._incr_every
        down = bad >= self._decr_every
        self._scale.copy_(torch.where(
            down, self._scale * self._decr_ratio,
            torch.where(up, self._scale * self._incr_ratio, self._scale)))
        self._good.copy_(torch.where(up, zero, good))
        self._bad.copy_(torch.where(down, zero, bad))

    def minimize(self, optimizer, scaled_loss):
        """``scaled_loss.backward()`` where no trainable parameter has a
        gradient yet, then :meth:`step`."""
        if scaled_loss is not None and scaled_loss.requires_grad and all(
                p.grad is None for p in optimizer._params()
                if p.requires_grad):
            scaled_loss.backward()
        self.step(optimizer)

    def update(self):
        pass

    def state_dict(self):
        """Host values (a read of the card)."""
        return {"scale": float(self._scale), "good": int(self._good),
                "bad": int(self._bad)}

    def set_state_dict(self, s):
        """Fill the scale and counts in place: a captured step replays on
        the new values."""
        self._scale.fill_(float(s["scale"]))
        self._good.fill_(int(s["good"]))
        self._bad.fill_(int(s["bad"]))


__all__ = ["auto_cast", "is_enabled", "compute_dtype", "maybe_cast",
           "decorate", "GradScaler"]
