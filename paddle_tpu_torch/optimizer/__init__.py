"""paddle_tpu_torch.optimizer — Optimizer, SGD, Momentum, Adam and AdamW.

Counterpart of the same classes in ``paddle_tpu/optimizer/__init__.py``,
with the reference's step order, routes and update arithmetic rather than
``torch.optim``'s (whose AdamW places eps and the decay elsewhere):

* ``step()`` takes each parameter's ``.grad``, clips (not ported yet),
  then adds a ``WeightDecayRegularizer``'s gradient term, then applies the
  update by the first route that takes it, in the reference's order
  (``_apply_update``): the flat parameter arena (``flat_arena=True``,
  ``optimizer/arena.py``), the batched multi-tensor update
  (``use_multi_tensor``, or ``kernels.configure(fused_adam_multi=True)``),
  the per-parameter rule;
* Adam's rule is ``ops/kernels/fused_adam.adam_step``: the ``fused_adam``
  kernel with ``use_fused=True`` (or ``configure(fused_adam=True)``), else
  the reference's plain arithmetic ``m = b1 m + (1 - b1) g``, ``v = b2 v +
  (1 - b2) g g``, ``p -= lr (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) +
  eps)``, cast back to the parameter's dtype;
* AdamW then applies its decoupled decay with the parameter as it was
  before the step, ``p_new - lr * wd * p_old``, cast per term; the
  multi-tensor and arena kernels fold the same decay in;
* SGD is ``p - lr g``; Momentum keeps a ``velocity`` slot in the
  parameter's dtype, ``v = momentum v + g``, and steps by ``lr v`` or,
  with ``use_nesterov``, by ``lr (g + momentum v)``;
* each parameter carries its own ``beta1_pow`` and ``beta2_pow`` slots,
  f32 scalars on its device, and the learning rate is an f32 scalar on
  each device that holds parameters, so a step never syncs with the host.
  The multi-tensor update shares one pair of pows; it runs only while the
  live parameters have stepped equally often, which a host-side step
  count per parameter tells without reading the pows from the card.

Every update writes into the storage it updates: parameters, slots,
pows, the learning rate (``set_lr`` fills it) and the arena's buffers
keep their addresses from one step to the next, so that a CUDA graph
that captured a step (``jit.to_static``) replays it on the live state
(the reference passes that state through its executable instead). A
moment that a first step casts to float32 (a bf16 parameter's, on a
kernel route) replaces its slot once. The host-side step counts are the
one part a replay does not advance: ``jit.to_static`` advances them for
it.

Slots are created on each parameter's device at its first step, or all
at once by :meth:`Optimizer._ensure_all_slots`, which ``jit.to_static``
calls before it keys a step, as the reference's does. Gradient
clipping, learning-rate schedulers and ``grad_sync`` are not ported yet
and raise ``NotImplementedError``.
"""
from __future__ import annotations

import warnings

import torch

from ..ops import kernels
from ..ops.kernels.fused_adam import (adam_step, adam_step_flat,
                                      fused_adam_update_multi)
from ..regularizer import L2Decay, WeightDecayRegularizer
from .arena import ParamArena


class Optimizer:
    """Base optimizer: parameters, learning rate, slots, ``step``."""

    # flat-arena capability: the per-element slots an arena mirrors, None
    # where the class has no arena update (flat_arena=True raises)
    _arena_slots = None
    _arena_pows = ()

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 regularization=None, grad_sync=None, flat_arena=False):
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
        self._steps = {}         # id(param) -> updates applied (host int)
        self._arena = None
        self._flat_arena = False
        if flat_arena:
            self.set_flat_arena(True)

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

    def _ensure_all_slots(self):
        """Create every slot (or the flat arena) and the learning rate on
        every device that holds a trainable parameter, as a first step
        would: ``jit.to_static`` keys and captures a step on state that no
        longer grows."""
        trainables = [p for p in self._params() if p.requires_grad]
        if self._flat_arena:
            if trainables:
                self._lr_on(self._ensure_arena().device)
            return
        for p in trainables:
            self._pre_param(p)
            self._lr_on(p.device)

    def _rule(self, p, g, slots, lr):
        raise NotImplementedError

    def _params(self):
        if self._parameter_list is None:
            raise ValueError(
                "optimizer constructed without `parameters`; pass "
                "parameters=model.parameters()")
        return self._parameter_list

    # -- the flat parameter arena --------------------------------------------
    def set_flat_arena(self, enable=True):
        """Turn the flat parameter arena on (Adam and AdamW only); it is
        built at the next step. Dissolving a built arena back into
        per-parameter slots is not ported."""
        enable = bool(enable)
        if enable and self._arena_slots is None:
            raise ValueError(f"flat_arena is not supported by "
                             f"{type(self).__name__}; use Adam or AdamW")
        if not enable and self._arena is not None:
            raise NotImplementedError(
                "turning a built flat arena off (dissolving it into "
                "per-parameter slots mid-training) is not ported "
                "(ROADMAP.md Queue A)")
        self._flat_arena = enable
        return self

    def _ensure_arena(self):
        """The arena over the trainable parameters, built at the first
        step (after the model has moved to its device)."""
        trainables = [p for p in self._params() if p.requires_grad]
        if self._arena is None:
            self._arena = ParamArena(trainables, self._arena_slots,
                                     self._arena_pows)
        elif not self._arena.matches(trainables):
            raise NotImplementedError(
                "the flat arena's parameters changed (members, dtypes, "
                "shapes or storage); rebuilding it is not ported "
                "(ROADMAP.md Queue A)")
        return self._arena

    # -- apply ---------------------------------------------------------------
    @torch.no_grad()
    def step(self):
        """One update from each parameter's ``.grad``: regularize, then
        :meth:`_apply_update` (the reference's ``_step_body`` without clip,
        which is not ported)."""
        params_grads = []
        for p in self._params():
            g = p.grad
            if g is None or not p.requires_grad:
                continue
            reg = getattr(p, "regularizer", None) or self._regularization
            if isinstance(reg, WeightDecayRegularizer):
                g = g + reg.grad_term(p)
            params_grads.append((p, g))
        self._apply_update(params_grads)

    def _apply_update(self, params_grads):
        """The first route that takes the update: the flat arena, the
        batched multi-tensor update, the per-parameter rule."""
        if self._flat_arena:
            arena = self._ensure_arena()
            packed = arena.pack_grads(params_grads)
            if packed is not None:
                self._arena_apply(arena, packed, self._lr_on(arena.device))
            return
        if params_grads and self._batched_update(
                params_grads, self._lr_on(params_grads[0][0].device)):
            return
        for p, g in params_grads:
            self._pre_param(p)
            slots = self._accumulators.get(id(p), {})
            new_p, new_slots = self._rule(p, g, slots,
                                          self._lr_on(p.device))
            if new_p is not p:
                p.copy_(new_p)
            _store(slots, new_slots)
            self._steps[id(p)] = self._steps.get(id(p), 0) + 1

    def _batched_update(self, params_grads, lr):
        """Hook: every update in one batched call; True if it did them.
        The base class has none."""
        return False

    def clear_grad(self):
        for p in self._params():
            p.grad = None


def _store(slots, new):
    """Write each new slot value into its slot's own storage. A value of
    another dtype or shape (a moment a first step cast to float32) takes
    the slot's place instead."""
    for name, v in new.items():
        t = slots.get(name)
        if t is None or t.dtype != v.dtype or t.shape != v.shape:
            slots[name] = v
        elif t is not v:
            t.copy_(v)


class SGD(Optimizer):
    def _rule(self, p, g, slots, lr):
        return p - lr * g, {}


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, **kw):
        super().__init__(learning_rate, parameters, **kw)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _pre_param(self, p):
        self._slot(p, "velocity")

    def _rule(self, p, g, slots, lr):
        # momentum * v + g, rounded as the out-of-place form, in place
        v = slots["velocity"].mul_(self._momentum).add_(g)
        if self._nesterov:
            new_p = p - lr * (g + self._momentum * v)
        else:
            new_p = p - lr * v
        return new_p, {"velocity": v}


class Adam(Optimizer):
    """Adam with per-parameter ``beta1_pow`` / ``beta2_pow`` slots.
    ``use_fused=True`` runs the per-parameter rule through the
    ``fused_adam`` kernel, ``use_multi_tensor=True`` the whole update
    through ``fused_adam_multi``; ``None`` leaves each to
    ``kernels.enabled``."""

    _arena_slots = ("moment1", "moment2")
    _arena_pows = ("beta1_pow", "beta2_pow")
    _warned_unequal_beta_pow = False

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, lazy_mode=False,
                 use_fused=None, use_multi_tensor=None, **kw):
        super().__init__(learning_rate, parameters, **kw)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        self._use_fused = use_fused
        self._use_multi_tensor = use_multi_tensor

    def _pre_param(self, p):
        self._slot(p, "moment1")
        self._slot(p, "moment2")
        self._slot(p, "beta1_pow", init=1.0, shape=(), dtype=torch.float32)
        self._slot(p, "beta2_pow", init=1.0, shape=(), dtype=torch.float32)

    def _rule(self, p, g, slots, lr):
        b1, b2 = self._beta1, self._beta2
        # the pows advance in their slots: pow * beta, as before, in place
        b1p = slots["beta1_pow"].mul_(b1)
        b2p = slots["beta2_pow"].mul_(b2)
        new_p, m, v = adam_step(p, g, slots["moment1"], slots["moment2"],
                                lr, b1p, b2p, beta1=b1, beta2=b2,
                                eps=self._eps, use_fused=self._use_fused,
                                inplace=True)
        return new_p, {"moment1": m, "moment2": v}

    def _batched_update(self, params_grads, lr):
        """The multi-tensor route: one ``fused_adam_multi`` call updates
        every parameter with a gradient, bias-corrected by the first
        one's pows. Parameters that have stepped unequally often (one
        that had no gradient in some step) warn once and fall back to the
        exact per-parameter loop."""
        use = self._use_multi_tensor
        if use is None:
            use = kernels.enabled("fused_adam_multi")
        if not use or len(params_grads) < 2:
            return False
        if len({self._steps.get(id(p), 0) for p, _ in params_grads}) > 1:
            if not Adam._warned_unequal_beta_pow:
                warnings.warn(
                    "multi-tensor Adam: live params' beta1_pow/beta2_pow "
                    "slots are not all equal (params stepped out of "
                    "lockstep); falling back to the exact per-tensor "
                    "update loop", RuntimeWarning)
                Adam._warned_unequal_beta_pow = True
            return False
        for p, _ in params_grads:
            self._pre_param(p)
        slots = [self._accumulators[id(p)] for p, _ in params_grads]
        # every live pow is equal (lockstep): each advances in its slot, in
        # one batched multiply a pow
        for name, beta in (("beta1_pow", self._beta1),
                           ("beta2_pow", self._beta2)):
            torch._foreach_mul_(list({id(t): t for t in (
                s[name] for s in slots)}.values()), beta)
        b1p, b2p = slots[0]["beta1_pow"], slots[0]["beta2_pow"]
        _, ms, vs = fused_adam_update_multi(
            [p for p, _ in params_grads], [g for _, g in params_grads],
            [s["moment1"] for s in slots], [s["moment2"] for s in slots],
            lr, b1p, b2p, beta1=self._beta1, beta2=self._beta2,
            eps=self._eps, weight_decay=getattr(self, "_wd", 0.0))
        for (p, _), s, m, v in zip(params_grads, slots, ms, vs):
            _store(s, {"moment1": m, "moment2": v})
            self._steps[id(p)] = self._steps.get(id(p), 0) + 1
        return True

    def _arena_apply(self, arena, packed, lr):
        """One ``adam_step_flat`` per dtype group, in place on the arena's
        buffers (the members' data are views of them), with the group's
        shared pows, which advance in place."""
        for grp, flat_g, mask in packed:
            m, v = grp.slots["moment1"], grp.slots["moment2"]
            b1p = grp.pows["beta1_pow"].mul_(self._beta1)
            b2p = grp.pows["beta2_pow"].mul_(self._beta2)
            new = adam_step_flat(
                grp.flat, flat_g, m, v, lr, b1p, b2p, beta1=self._beta1,
                beta2=self._beta2, eps=self._eps,
                weight_decay=getattr(self, "_wd", 0.0), mask=mask,
                use_fused=self._use_fused)
            for buf, value in zip((grp.flat, m, v), new):
                if value is not buf:
                    buf.copy_(value)


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
        # the decay term first: the fused rule updates p in place
        decay = lr * self._wd * p
        new_p, new_slots = super()._rule(p, g, slots, lr)
        # per term, in the parameter's dtype, as the reference casts
        return (new_p - decay).to(p.dtype), new_slots


__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "ParamArena"]
