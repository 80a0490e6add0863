"""paddle_tpu_torch.optimizer.lr — learning-rate schedulers.

Counterpart of ``paddle_tpu/optimizer/lr.py``: the same thirteen classes,
``LRScheduler`` through ``ReduceOnPlateau``, and the fluid functional
aliases, computing the same host floats in the same order (Python
arithmetic in doubles; nothing here touches a tensor).

A scheduler passed to an optimizer as its ``learning_rate`` becomes the
optimizer's ``_owner``d schedule: each :meth:`LRScheduler.step` hands the
new rate to :meth:`Optimizer.set_lr`, which fills the optimizer's float32
learning-rate tensor on each device in place. A step that
``jit.to_static`` captured into a CUDA graph reads that tensor at every
replay, so a rate changed between replays takes effect with no new
capture. One departure: :meth:`LRScheduler.set_state_dict` also hands the
restored rate to its optimizer (the reference's leaves the device rate as
it was until the next ``step``).
"""
from __future__ import annotations

import math


class LRScheduler:
    """Base class: ``get_lr`` is the rate at ``last_epoch``; ``step``
    advances the epoch, records ``last_lr`` and hands it to the owning
    optimizer. Construction takes one step, so ``last_epoch`` starts at
    0."""

    def __init__(self, learning_rate=0.1, last_epoch=-1, verbose=False):
        self.base_lr = learning_rate
        self.last_epoch = last_epoch
        self.verbose = verbose
        self._owner = None  # set by Optimizer
        self.step()

    def get_lr(self):
        raise NotImplementedError

    def _publish(self):
        if self._owner is not None:
            self._owner.set_lr(self.last_lr)

    def step(self, epoch=None):
        if epoch is None:
            self.last_epoch += 1
        else:
            self.last_epoch = epoch
        self.last_lr = self.get_lr()
        self._publish()
        return self.last_lr

    def state_dict(self):
        return {"last_epoch": self.last_epoch, "last_lr": self.last_lr}

    def set_state_dict(self, state):
        self.last_epoch = state["last_epoch"]
        self.last_lr = state["last_lr"]
        self._publish()

    def __call__(self):
        return self.last_lr


class NoamDecay(LRScheduler):
    """``lr = base * d_model^-0.5 * min(n^-0.5, n * warmup^-1.5)``."""

    def __init__(self, d_model, warmup_steps, learning_rate=1.0,
                 last_epoch=-1, verbose=False):
        self.d_model = d_model
        self.warmup_steps = warmup_steps
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        n = max(self.last_epoch, 1)
        return (self.base_lr * self.d_model ** -0.5 *
                min(n ** -0.5, n * self.warmup_steps ** -1.5))


class ExponentialDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * self.gamma ** self.last_epoch


class NaturalExpDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * math.exp(-self.gamma * self.last_epoch)


class InverseTimeDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr / (1 + self.gamma * self.last_epoch)


class PolynomialDecay(LRScheduler):
    def __init__(self, learning_rate, decay_steps, end_lr=0.0001, power=1.0,
                 cycle=False, last_epoch=-1, verbose=False):
        self.decay_steps = decay_steps
        self.end_lr = end_lr
        self.power = power
        self.cycle = cycle
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        step = self.last_epoch
        decay_steps = self.decay_steps
        if self.cycle and step > 0:
            decay_steps = decay_steps * math.ceil(step / decay_steps)
        step = min(step, decay_steps)
        frac = (1 - step / decay_steps) ** self.power
        return (self.base_lr - self.end_lr) * frac + self.end_lr


class PiecewiseDecay(LRScheduler):
    def __init__(self, boundaries, values, last_epoch=-1, verbose=False):
        self.boundaries = list(boundaries)
        self.values = list(values)
        super().__init__(values[0], last_epoch, verbose)

    def get_lr(self):
        for b, v in zip(self.boundaries, self.values):
            if self.last_epoch < b:
                return v
        return self.values[len(self.boundaries)]


class CosineAnnealingDecay(LRScheduler):
    def __init__(self, learning_rate, T_max, eta_min=0.0, last_epoch=-1,
                 verbose=False):
        self.T_max = T_max
        self.eta_min = eta_min
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return (self.eta_min + (self.base_lr - self.eta_min) *
                (1 + math.cos(math.pi * self.last_epoch / self.T_max)) / 2)


class LinearWarmup(LRScheduler):
    """A linear ramp from ``start_lr`` to ``end_lr`` over
    ``warmup_steps``, then ``learning_rate`` (a float, or a scheduler
    whose epoch counts from the end of the warm-up)."""

    def __init__(self, learning_rate, warmup_steps, start_lr, end_lr,
                 last_epoch=-1, verbose=False):
        self.lr = learning_rate
        self.warmup_steps = warmup_steps
        self.start_lr = start_lr
        self.end_lr = end_lr
        base = learning_rate.base_lr if isinstance(
            learning_rate, LRScheduler) else learning_rate
        super().__init__(base, last_epoch, verbose)

    def get_lr(self):
        if self.last_epoch < self.warmup_steps:
            return (self.start_lr + (self.end_lr - self.start_lr) *
                    self.last_epoch / self.warmup_steps)
        if isinstance(self.lr, LRScheduler):
            self.lr.last_epoch = self.last_epoch - self.warmup_steps
            return self.lr.get_lr()
        return self.lr


class StepDecay(LRScheduler):
    def __init__(self, learning_rate, step_size, gamma=0.1, last_epoch=-1,
                 verbose=False):
        self.step_size = step_size
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * self.gamma ** (self.last_epoch //
                                             self.step_size)


class MultiStepDecay(LRScheduler):
    def __init__(self, learning_rate, milestones, gamma=0.1, last_epoch=-1,
                 verbose=False):
        self.milestones = list(milestones)
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        n = sum(1 for m in self.milestones if self.last_epoch >= m)
        return self.base_lr * self.gamma ** n


class LambdaDecay(LRScheduler):
    def __init__(self, learning_rate, lr_lambda, last_epoch=-1,
                 verbose=False):
        self.lr_lambda = lr_lambda
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * self.lr_lambda(self.last_epoch)


class ReduceOnPlateau(LRScheduler):
    """Multiplies the rate by ``factor`` (not below ``min_lr``) once the
    metric passed to :meth:`step` has not improved by ``threshold`` for
    more than ``patience`` steps, then waits ``cooldown`` steps."""

    def __init__(self, learning_rate, mode="min", factor=0.1, patience=10,
                 threshold=1e-4, cooldown=0, min_lr=0, verbose=False):
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.best = None
        self.num_bad = 0
        self.cooldown_counter = 0
        self._current = learning_rate
        super().__init__(learning_rate, -1, verbose)

    def get_lr(self):
        return self._current

    def step(self, metrics=None, epoch=None):
        if metrics is None:
            self.last_lr = self._current
            self._publish()
            return self.last_lr
        value = float(metrics)
        better = (self.best is None or
                  (value < self.best - self.threshold if self.mode == "min"
                   else value > self.best + self.threshold))
        if better:
            self.best = value
            self.num_bad = 0
        elif self.cooldown_counter > 0:
            self.cooldown_counter -= 1
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self._current = max(self._current * self.factor,
                                    self.min_lr)
                self.cooldown_counter = self.cooldown
                self.num_bad = 0
        self.last_lr = self._current
        self._publish()
        return self.last_lr


# the fluid functional aliases (layers/learning_rate_scheduler.py)
def noam_decay(d_model, warmup_steps, learning_rate=1.0):
    return NoamDecay(d_model, warmup_steps, learning_rate)


def exponential_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    class _Exp(LRScheduler):
        def get_lr(self):
            p = self.last_epoch / decay_steps
            if staircase:
                p = math.floor(p)
            return learning_rate * decay_rate ** p
    return _Exp(learning_rate)


def piecewise_decay(boundaries, values):
    return PiecewiseDecay(boundaries, values)


def cosine_decay(learning_rate, step_each_epoch, epochs):
    return CosineAnnealingDecay(learning_rate,
                                T_max=step_each_epoch * epochs)


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=0.0001,
                     power=1.0, cycle=False):
    return PolynomialDecay(learning_rate, decay_steps, end_learning_rate,
                           power, cycle)


def linear_lr_warmup(learning_rate, warmup_steps, start_lr, end_lr):
    return LinearWarmup(learning_rate, warmup_steps, start_lr, end_lr)


__all__ = ["LRScheduler", "NoamDecay", "ExponentialDecay",
           "NaturalExpDecay", "InverseTimeDecay", "PolynomialDecay",
           "PiecewiseDecay", "CosineAnnealingDecay", "LinearWarmup",
           "StepDecay", "MultiStepDecay", "LambdaDecay", "ReduceOnPlateau",
           "noam_decay", "exponential_decay", "piecewise_decay",
           "cosine_decay", "polynomial_decay", "linear_lr_warmup"]
