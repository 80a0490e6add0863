"""paddle_tpu_torch.ops.loss — cross entropy with hard labels.

Counterpart of ``cross_entropy`` and ``softmax_with_cross_entropy`` in
``paddle_tpu/ops/loss.py``, on their plain (``logsumexp``) branch, which
is the one BERT pretraining takes there (the fused ``softmax_xent``
Pallas kernel is off by default). Semantics are the reference's:

* a label equal to ``ignore_index`` (any value, negatives included)
  scores 0; other labels are clamped into ``[0, C)`` before the gather,
  so an out-of-range label cannot alias a real class and raises nothing;
* ``reduction="mean"`` divides the summed loss by the number of valid
  positions, floored at 1e-12 (all ignored: 0, not NaN).

Soft labels, per-class ``weight`` and the fused-kernel branch raise
``NotImplementedError``: they come with the slice that ports the loss
kernels.
"""
from __future__ import annotations

import torch

_NEXT = ("comes with the loss-and-optimizer-kernels slice (ROADMAP.md "
         "Queue B #6, #7)")


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


def _refuse(soft_label, weight=None, use_fused=None):
    if soft_label:
        raise NotImplementedError(f"cross entropy with soft_label {_NEXT}")
    if weight is not None:
        raise NotImplementedError(f"cross entropy with a per-class weight "
                                  f"{_NEXT}")
    if use_fused:
        raise NotImplementedError(f"the fused softmax_xent kernel {_NEXT}")


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, axis=-1,
                               return_softmax=False, use_fused=None):
    """Per-position ``-log softmax(logits)[label]``, the class axis kept as
    size 1 (``return_softmax=True`` also returns the softmax)."""
    _refuse(soft_label, use_fused=use_fused)
    ax = axis % logits.dim()
    loss, _ = _picked_loss(logits, label, ax, ignore_index)
    if return_softmax:
        return loss, torch.softmax(logits, dim=ax)
    return loss


def cross_entropy(input, label, soft_label=False, ignore_index=-100,
                  reduction="mean", axis=-1, weight=None, use_fused=None):
    """``paddle.nn.functional.cross_entropy`` with hard labels over
    logits. ``reduction`` is ``"mean"`` (over valid positions), ``"sum"``
    or ``"none"`` (per position, class axis kept as size 1)."""
    _refuse(soft_label, weight, use_fused)
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"cross_entropy: unknown reduction {reduction!r}")
    ax = axis % input.dim()
    loss, valid = _picked_loss(input, label, ax, ignore_index)
    if reduction == "none":
        return loss
    if reduction == "sum":
        return loss.sum()
    count = valid.sum().to(loss.dtype)
    return loss.sum() / count.clamp_min(1e-12)
