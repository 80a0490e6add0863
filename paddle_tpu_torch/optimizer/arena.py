"""paddle_tpu_torch.optimizer.arena — the flat parameter arena.

Counterpart of ``paddle_tpu/optimizer/arena.py``'s ``ParamArena``,
reduced to what the update needs. One contiguous 1-D buffer per dtype
holds every trainable parameter in parameter order, padded to a multiple
of ``ALIGN``, with the optimizer's per-element slots (Adam's moments) as
equally flat buffers in the same layout and one shared scalar per group
for each pow. Each member's ``.data`` becomes a view of its slice of the
flat buffer, so an in-place update of the buffer (the ``fused_adam_flat``
kernel) is the parameters' update; the reference's coherence machinery
for immutable arrays (``bind_views``, ``sync_leaves``, the tensor read
hook, the stale and dirty sets) has nothing to do here.

A step packs the gradients with one ordered concatenation per group;
members without a gradient contribute zeros and a ``False`` mask span, and
the update keeps their parameters and moments (``adam_step_flat``).

Not ported, each raising ``NotImplementedError`` (ROADMAP.md Queue A):
grad-sync buckets (``bucket_bounds``), checkpoint interop
(``per_leaf_state``, ``load_leaf_state``), dissolving the arena into
per-parameter slots (``dissolve``, a mid-training toggle), the static
Executor's ``static_apply``, and the host offload of the moments, which
the reference attaches through ``memory_plan`` (not ported).
"""
from __future__ import annotations

import torch

# each dtype group is padded to a multiple of ALIGN elements, the lengths
# the fused_adam_flat kernel takes
from ..ops.kernels.fused_adam import FLAT_ALIGN as ALIGN


def _not_ported(what):
    return NotImplementedError(f"flat arena: {what} is not ported "
                               f"(ROADMAP.md Queue A)")


class _Group:
    """One dtype's region: entries are (param, offset, size, shape) in
    parameter order; ``total`` includes the padding."""
    __slots__ = ("dtype", "entries", "total", "flat", "slots", "pows",
                 "masks")

    def __init__(self, dtype):
        self.dtype = dtype
        self.entries = []
        self.total = 0
        self.flat = None
        self.slots = {}
        self.pows = {}
        self.masks = {}   # live flags -> bool mask on the device


class ParamArena:
    """``params``: the ordered trainable parameters, on one device.
    ``slot_names``: the per-element slot buffers to mirror (zeros).
    ``pow_names``: the shared per-group scalars, starting at 1."""

    def __init__(self, params, slot_names=(), pow_names=()):
        devices = {p.device for p in params}
        if len(devices) > 1:
            raise ValueError(f"flat arena: the parameters must share one "
                             f"device, got {sorted(map(str, devices))}")
        self.device = next(iter(devices), None)
        self.groups = []
        by_dtype = {}
        for p in params:
            grp = by_dtype.get(p.dtype)
            if grp is None:
                grp = by_dtype[p.dtype] = _Group(p.dtype)
                self.groups.append(grp)
            grp.entries.append((p, grp.total, p.numel(), tuple(p.shape)))
            grp.total += p.numel()
        self._pids = {id(p) for p in params}
        with torch.no_grad():
            for grp in self.groups:
                grp.total += (-grp.total) % ALIGN
                grp.flat = torch.zeros(grp.total, dtype=grp.dtype,
                                       device=self.device)
                for p, off, n, shape in grp.entries:
                    view = grp.flat[off:off + n]
                    view.copy_(p.detach().reshape(-1))
                    p.data = view.view(shape)
                grp.slots = {s: torch.zeros_like(grp.flat)
                             for s in slot_names}
                grp.pows = {s: torch.ones((), dtype=grp.dtype,
                                          device=self.device)
                            for s in pow_names}

    def matches(self, params):
        """True while ``params`` are exactly the members and each member's
        data is still its view of the flat buffer."""
        if {id(p) for p in params} != self._pids or \
                len(params) != len(self._pids):
            return False
        for grp in self.groups:
            base, size = grp.flat.data_ptr(), grp.flat.element_size()
            for p, off, _, shape in grp.entries:
                if p.dtype != grp.dtype or tuple(p.shape) != shape or \
                        p.data_ptr() != base + off * size:
                    return False
        return True

    def pack_grads(self, params_grads):
        """One ordered concatenation per dtype group of the step's
        gradients. Returns ``[(group, flat_grad, mask or None), ...]`` for
        the groups with a gradient, or None when no member has one; the
        mask (bool, per element) is None when every member has one."""
        by_pid = {id(p): g for p, g in params_grads if g is not None}
        if not by_pid:
            return None
        packed = []
        for grp in self.groups:
            segs, flags = [], []
            for p, off, n, _ in grp.entries:
                g = by_pid.get(id(p))
                flags.append(g is not None)
                segs.append(grp.flat.new_zeros(n) if g is None
                            else g.reshape(-1).to(grp.dtype))
            if not any(flags):
                continue
            _, off, n, _ = grp.entries[-1]
            if grp.total > off + n:
                segs.append(grp.flat.new_zeros(grp.total - off - n))
            mask = None if all(flags) else self._mask(grp, tuple(flags))
            packed.append((grp, torch.cat(segs), mask))
        return packed or None

    @staticmethod
    def _mask(grp, flags):
        """The element mask of one pattern of live members, built on the
        host once and kept on the device."""
        mask = grp.masks.get(flags)
        if mask is None:
            host = torch.zeros(grp.total, dtype=torch.bool)
            for (_, off, n, _), live in zip(grp.entries, flags):
                host[off:off + n] = live
            mask = grp.masks[flags] = host.to(grp.flat.device)
        return mask

    def bucket_bounds(self, bucket_bytes=None, plan=None):
        raise _not_ported("bucket_bounds (grad-sync buckets)")

    def per_leaf_state(self, named_params):
        raise _not_ported("per_leaf_state (checkpoint interop)")

    def load_leaf_state(self, p, slot_values):
        raise _not_ported("load_leaf_state (checkpoint interop)")

    def dissolve(self):
        raise _not_ported("dissolve (a mid-training toggle)")


def static_apply(opt, params_grads, param_vals, slot_vals, lr):
    raise _not_ported("static_apply (the static Executor)")


__all__ = ["ParamArena", "ALIGN", "static_apply"]
