"""paddle_tpu_torch.clip — gradient clipping.

Counterpart of ``paddle_tpu/clip.py``: ``ClipGradByValue``,
``ClipGradByNorm``, ``ClipGradByGlobalNorm`` (and their fluid names),
``clip_grad_norm_``, ``ErrorClipByValue``, ``set_gradient_clip`` and
``get_gradient_clip``. A clip maps ``[(param, grad), ...]`` to the same
list with the gradients clipped; the optimizer applies a parameter's own
``grad_clip`` first, then its ``grad_clip=`` or the global one
(``optimizer/__init__.py``).

Every clip is device arithmetic with no host read: it runs inside a step
that ``jit.to_static`` captures into a CUDA graph. The norms are summed
in float32 whatever the gradients' dtype (the reference sums a bfloat16
gradient's squares in bfloat16), with one
``torch._foreach_norm`` over a list of gradients, and each gradient is
multiplied by its float32 scale and stays in its dtype. Under the flat
parameter arena the optimizer hands the value and global-norm clips its
packed flat gradients (``_clip_flat``): the global norm is then one
reduction over each dtype group's buffer, whose padding and missing
members are zeros.
"""
from __future__ import annotations

import torch


def _norms(grads):
    """Each gradient's L2 norm, float32, in one multi-tensor call."""
    return torch._foreach_norm(grads, 2, dtype=torch.float32)


def _over(c, t):
    """``c / t`` for a float ``c`` and a device scalar ``t``, one rounded
    division (``c / t`` in PyTorch multiplies by ``t``'s reciprocal, so
    ``c / c`` need not be 1)."""
    return torch.full_like(t, c).div_(t)


class ClipGradBase:
    #: whether the optimizer may hand this clip the arena's flat gradients
    _flat = False

    def __call__(self, params_grads):
        raise NotImplementedError

    def _clip_flat(self, flats):
        return [g for _, g in self([(None, f) for f in flats])]


class ClipGradByValue(ClipGradBase):
    """Each gradient element clamped to ``[min, max]`` (``min`` defaults
    to ``-max``)."""

    _flat = True

    def __init__(self, max, min=None):
        self.max = max
        self.min = -max if min is None else min

    def __call__(self, params_grads):
        return [(p, None if g is None else g.clamp(self.min, self.max))
                for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    """Each gradient scaled by ``min(clip_norm / max(||g||, 1e-12), 1)``,
    its own L2 norm."""

    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def __call__(self, params_grads):
        live = [g for _, g in params_grads if g is not None]
        if not live:
            return list(params_grads)
        scales = iter([_over(self.clip_norm, n.clamp(min=1e-12)).clamp(
            max=1.0) for n in _norms(live)])
        return [(p, None if g is None else g * next(scales))
                for p, g in params_grads]


class ClipGradByGlobalNorm(ClipGradBase):
    """Every gradient scaled by ``clip_norm / max(global, clip_norm)``,
    ``global`` the L2 norm of all the gradients together."""

    _flat = True

    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def scale(self, grads):
        """The float32 device scalar every gradient is multiplied by."""
        norms = _norms(grads)
        gnorm = torch.sqrt(torch.stack(norms).square().sum())
        return _over(self.clip_norm, gnorm.clamp(min=self.clip_norm))

    def __call__(self, params_grads):
        live = [g for _, g in params_grads if g is not None]
        if not live:
            return list(params_grads)
        s = self.scale(live)
        return [(p, None if g is None else g * s) for p, g in params_grads]

    def _clip_flat(self, flats):
        s = self.scale(flats)
        return [g * s for g in flats]


# fluid names
GradientClipByValue = ClipGradByValue
GradientClipByNorm = ClipGradByNorm
GradientClipByGlobalNorm = ClipGradByGlobalNorm


def clip_grad_norm_(parameters, max_norm):
    """The parameters' gradients clipped to global norm ``max_norm``, in
    place of their ``.grad``."""
    params = [p for p in parameters if p.grad is not None]
    clipped = ClipGradByGlobalNorm(max_norm)([(p, p.grad) for p in params])
    for p, (_, g) in zip(params, clipped):
        p.grad = g


class ErrorClipByValue:
    """Clamps one tensor's incoming gradient to ``[min, max]``. The
    reference's tape applies ``var.error_clip``; in the port attach it as
    a hook, ``tensor.register_hook(ErrorClipByValue(max))``."""

    def __init__(self, max, min=None):
        self.max = max
        self.min = -max if min is None else min

    def __call__(self, grad):
        return grad.clamp(self.min, self.max)


_global_grad_clip = None


def set_gradient_clip(clip, param_list=None, program=None):
    """With ``param_list``, ``clip`` becomes those parameters' own
    ``grad_clip`` (applied before the optimizer's); otherwise the global
    clip every optimizer without a ``grad_clip=`` uses."""
    if param_list:
        for p in param_list:
            p.grad_clip = clip
        return clip
    global _global_grad_clip
    _global_grad_clip = clip
    return clip


def get_gradient_clip():
    return _global_grad_clip


__all__ = ["ClipGradBase", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm", "GradientClipByValue",
           "GradientClipByNorm", "GradientClipByGlobalNorm",
           "clip_grad_norm_", "ErrorClipByValue", "set_gradient_clip",
           "get_gradient_clip"]
