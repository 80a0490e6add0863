"""paddle_tpu_torch.regularizer — weight decay regularizers.

Counterpart of ``paddle_tpu/regularizer.py``: a regularizer adds its
penalty's gradient to a parameter's gradient inside the optimizer step
(after clipping, before the update), as ``Optimizer`` reads it.
"""
from __future__ import annotations


class WeightDecayRegularizer:
    def grad_term(self, param):
        raise NotImplementedError


class L2Decay(WeightDecayRegularizer):
    """``grad += coeff * param``."""

    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)

    def grad_term(self, param):
        return self.coeff * param

