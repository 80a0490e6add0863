"""paddle_tpu_torch.ops.loss — cross entropy with hard labels.

Counterpart of ``cross_entropy`` and ``softmax_with_cross_entropy`` in
``paddle_tpu/ops/loss.py``, with both of its branches for hard labels
over the last axis:

* the fused branch, taken where ``kernels.enabled("softmax_xent")`` (off
  by default, as in the reference): the ``softmax_xent`` kernels score
  every row; a label equal to ``ignore_index`` or outside ``[0, C)``
  matches no column there (``loss = lse``), and the rows whose label is
  ``ignore_index`` are masked to 0 after, which also zeroes their
  gradient into the backward kernel. An out-of-range label that is not
  ``ignore_index`` thus scores ``lse``;
* the plain (``logsumexp``) branch: a label equal to ``ignore_index``
  (any value, negatives included) scores 0; other labels are clamped into
  ``[0, C)`` before the gather, so an out-of-range label scores the
  nearest end class and raises nothing.

The two branches disagree only on out-of-range labels that are not
ignored, as the reference's do. ``reduction="mean"`` divides the summed
loss by the number of valid positions, floored at 1e-12 (all ignored: 0,
not NaN). Soft labels and a per-class ``weight`` raise
``NotImplementedError`` (ROADMAP.md Queue A).
"""
from __future__ import annotations

import torch

from . import kernels
from .kernels.softmax_xent import softmax_cross_entropy

_NEXT = "is not ported yet (ROADMAP.md Queue A)"


def _hard_label(x, label, ax):
    lbl = label
    if lbl.dim() == x.dim() and lbl.shape[ax] == 1:
        lbl = lbl.squeeze(ax)
    return lbl


def _picked_loss(x, label, ax, ignore_index):
    """Per-position loss ``-log softmax(x)[label]`` (0 where the label is
    ``ignore_index``) with the class axis kept as size 1, and the valid
    mask. ``lse - x[label]`` is the reference's ``-(x - lse)[label]`` with
    the same rounding, without the full log-softmax."""
    lbl = _hard_label(x, label, ax)
    valid = lbl != ignore_index
    safe = lbl.clamp(0, x.shape[ax] - 1).long().unsqueeze(ax)
    loss = torch.logsumexp(x, dim=ax, keepdim=True) - torch.gather(x, ax,
                                                                   safe)
    return torch.where(valid.unsqueeze(ax), loss, 0.0), valid


def _fused_softmax_xent(x, label, ignore_index):
    """Per-position loss through the ``softmax_xent`` kernels when they are
    enabled, else None: ``(loss[lead + (1,)] in x's dtype, valid[lead])``,
    the reference's ``_fused_softmax_xent``."""
    if not kernels.enabled("softmax_xent"):
        return None
    lbl = _hard_label(x, label, -1)
    valid = lbl != ignore_index
    loss = softmax_cross_entropy(x, lbl).to(x.dtype)
    return torch.where(valid[..., None], loss, 0.0), valid


def _refuse(soft_label, weight=None):
    if soft_label:
        raise NotImplementedError(f"cross entropy with soft_label {_NEXT}")
    if weight is not None:
        raise NotImplementedError(f"cross entropy with a per-class weight "
                                  f"{_NEXT}")


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, axis=-1,
                               return_softmax=False):
    """Per-position ``-log softmax(logits)[label]``, the class axis kept as
    size 1 (``return_softmax=True`` also returns the softmax)."""
    _refuse(soft_label)
    ax = axis % logits.dim()
    if not return_softmax and ax == logits.dim() - 1:
        fused = _fused_softmax_xent(logits, label, ignore_index)
        if fused is not None:
            return fused[0]
    loss, _ = _picked_loss(logits, label, ax, ignore_index)
    if return_softmax:
        return loss, torch.softmax(logits, dim=ax)
    return loss


def cross_entropy(input, label, soft_label=False, ignore_index=-100,
                  reduction="mean", axis=-1, weight=None):
    """``paddle.nn.functional.cross_entropy`` with hard labels over
    logits. ``reduction`` is ``"mean"`` (over valid positions), ``"sum"``
    or ``"none"`` (per position, class axis kept as size 1)."""
    _refuse(soft_label, weight)
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"cross_entropy: unknown reduction {reduction!r}")
    ax = axis % input.dim()
    fused = None
    if ax == input.dim() - 1:
        fused = _fused_softmax_xent(input, label, ignore_index)
    if fused is not None:
        loss, valid = fused
    else:
        loss, valid = _picked_loss(input, label, ax, ignore_index)
    if reduction == "none":
        return loss
    if reduction == "sum":
        return loss.sum()
    count = valid.sum().to(loss.dtype)
    return loss.sum() / count.clamp_min(1e-12)
