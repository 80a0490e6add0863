"""paddle_tpu_torch.optimizer — Optimizer, Adam and AdamW.

Counterpart of the same classes in ``paddle_tpu/optimizer/__init__.py``,
with the reference's step order and update arithmetic rather than
``torch.optim``'s (whose AdamW places eps and the decay elsewhere):

* ``step()`` takes each parameter's ``.grad``, clips (not ported yet),
  then adds a ``WeightDecayRegularizer``'s gradient term, then applies the
  per-parameter rule;
* Adam's rule is the reference's plain ``adam_step``
  (``paddle_tpu/ops/pallas/fused_adam.py``): ``m = b1 m + (1 - b1) g``,
  ``v = b2 v + (1 - b2) g g``, ``p -= lr (m / (1 - b1^t)) / (sqrt(v /
  (1 - b2^t)) + eps)``, cast back to the parameter's dtype;
* AdamW then applies its decoupled decay with the parameter as it was
  before the step, ``p_new - lr * wd * p_old``, cast per term;
* each parameter carries its own ``beta1_pow`` and ``beta2_pow`` slots,
  f32 scalars on its device, and the learning rate is an f32 scalar on
  each device that holds parameters, so a step never syncs with the host.

Slots are created on each parameter's device at its first step. The
fused kernels (``use_fused``, ``use_multi_tensor``), the flat parameter
arena, gradient clipping, learning-rate schedulers and ``grad_sync`` are
not ported yet and raise ``NotImplementedError``.
"""
from __future__ import annotations

import torch

from ..regularizer import L2Decay, WeightDecayRegularizer

_KERNEL_SLICE = ("comes with the loss-and-optimizer-kernels slice "
                 "(ROADMAP.md Queue B #8-#10)")


class Optimizer:
    """Base optimizer: parameters, learning rate, slots, ``step``."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 regularization=None, grad_sync=None, flat_arena=False):
        if flat_arena:
            raise NotImplementedError(f"flat_arena=True {_KERNEL_SLICE}")
        if grad_sync is not None:
            raise NotImplementedError(
                "grad_sync comes with the multi-card slice (ROADMAP.md)")
        if grad_clip is not None:
            raise NotImplementedError(
                "grad_clip is not ported yet (ROADMAP.md Queue A)")
        if not isinstance(learning_rate, (int, float)):
            raise NotImplementedError(
                "learning-rate schedulers are not ported yet; pass a float "
                "(ROADMAP.md Queue A)")
        self._parameter_list = list(parameters) if parameters is not None \
            else None
        wd = weight_decay if weight_decay is not None else regularization
        if isinstance(wd, (int, float)):
            wd = L2Decay(float(wd))
        self._regularization = wd
        self._lr_value = float(learning_rate)
        self._lr = {}            # device -> f32 scalar tensor
        self._accumulators = {}  # id(param) -> {slot name: tensor}

    # -- learning rate -------------------------------------------------------
    def _lr_on(self, device):
        t = self._lr.get(device)
        if t is None:
            t = torch.tensor(self._lr_value, dtype=torch.float32,
                             device=device)
            self._lr[device] = t
        return t

    def set_lr(self, value):
        self._lr_value = float(value)
        for t in self._lr.values():
            t.fill_(self._lr_value)

    def get_lr(self):
        return self._lr_value

    # -- slots ---------------------------------------------------------------
    def _slot(self, param, name, init=None, shape=None, dtype=None):
        slots = self._accumulators.setdefault(id(param), {})
        if name not in slots:
            shape = tuple(param.shape) if shape is None else shape
            dtype = dtype or param.dtype
            slots[name] = torch.full(shape, 0.0 if init is None else init,
                                     dtype=dtype, device=param.device)
        return slots[name]

    def _pre_param(self, p):
        pass

    def _rule(self, p, g, slots, lr):
        raise NotImplementedError

    def _params(self):
        if self._parameter_list is None:
            raise ValueError(
                "optimizer constructed without `parameters`; pass "
                "parameters=model.parameters()")
        return self._parameter_list

    # -- apply ---------------------------------------------------------------
    @torch.no_grad()
    def step(self):
        """One update from each parameter's ``.grad``: regularize, then the
        rule (the reference's ``_step_body`` without clip, which is not
        ported)."""
        for p in self._params():
            g = p.grad
            if g is None or not p.requires_grad:
                continue
            reg = getattr(p, "regularizer", None) or self._regularization
            if isinstance(reg, WeightDecayRegularizer):
                g = g + reg.grad_term(p)
            self._pre_param(p)
            slots = self._accumulators.get(id(p), {})
            new_p, new_slots = self._rule(p, g, slots,
                                          self._lr_on(p.device))
            p.copy_(new_p)
            for name, value in new_slots.items():
                slots[name] = value

    def clear_grad(self):
        for p in self._params():
            p.grad = None


class Adam(Optimizer):
    """Adam with per-parameter ``beta1_pow`` / ``beta2_pow`` slots."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, lazy_mode=False,
                 use_fused=None, use_multi_tensor=None, **kw):
        if use_fused:
            raise NotImplementedError(f"Adam(use_fused=True) {_KERNEL_SLICE}")
        if use_multi_tensor:
            raise NotImplementedError(
                f"Adam(use_multi_tensor=True) {_KERNEL_SLICE}")
        super().__init__(learning_rate, parameters, **kw)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon

    def _pre_param(self, p):
        self._slot(p, "moment1")
        self._slot(p, "moment2")
        self._slot(p, "beta1_pow", init=1.0, shape=(), dtype=torch.float32)
        self._slot(p, "beta2_pow", init=1.0, shape=(), dtype=torch.float32)

    def _rule(self, p, g, slots, lr):
        b1, b2, eps = self._beta1, self._beta2, self._eps
        b1p = slots["beta1_pow"] * b1
        b2p = slots["beta2_pow"] * b2
        m = b1 * slots["moment1"] + (1 - b1) * g
        v = b2 * slots["moment2"] + (1 - b2) * g * g
        mhat = m / (1 - b1p)
        vhat = v / (1 - b2p)
        new_p = (p - lr * mhat / (torch.sqrt(vhat) + eps)).to(p.dtype)
        return new_p, {"moment1": m, "moment2": v, "beta1_pow": b1p,
                       "beta2_pow": b2p}


class AdamW(Adam):
    """Adam with decoupled weight decay, applied after the Adam update
    with the pre-step parameter; never added to the gradient."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01, **kw):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         **kw)
        self._wd = weight_decay.coeff if isinstance(
            weight_decay, WeightDecayRegularizer) else float(weight_decay)
        self._regularization = None

    def _rule(self, p, g, slots, lr):
        new_p, new_slots = super()._rule(p, g, slots, lr)
        # per term, in the parameter's dtype, as the reference casts
        return (new_p - lr * self._wd * p).to(p.dtype), new_slots


__all__ = ["Optimizer", "Adam", "AdamW"]
