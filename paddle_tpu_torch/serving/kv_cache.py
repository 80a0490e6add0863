"""paddle_tpu_torch.serving.kv_cache — the fixed-slot KV-cache pool behind
continuous-batching decode.

Counterpart of ``paddle_tpu/serving/kv_cache.py``. Every active sequence
keeps its attention history on the device, histories grow a token a
step, and sequences of different lengths share one decode step:

* **Fixed slot count.** The decode batch is ``slots`` wide, always. A
  sequence holds one slot from its prefill to its end; freeing a slot is
  host bookkeeping, so the next tick can refill it.
* **Capacity on a closed family.** Each spec leaf is one tensor
  ``[slots, capacity, *tail]`` on the pool's device, and ``capacity``
  moves only along :func:`~paddle_tpu_torch.io.bucketing.grow_buckets`
  (the page schedule): when a sequence outgrows it, the whole arena steps
  to the next bucket by one copy. Every shape the arena can take is known
  up front, so an engine can meet each once at warmup.
* **Budgeted, not discovered.** ``bytes()`` is exact arithmetic over the
  spec (``slots x capacity x`` bytes a token). A pool on the card checks
  its worst case (``max_bytes()``) against the card's memory
  (``torch.cuda.mem_get_info``) when it is built; ``fits_budget``/
  ``plan_slots`` size a pool beforehand.
* **Addresses that never move.** Each leaf's storage is one flat buffer
  of the worst case, allocated when the pool is built, and the arena at
  every capacity is a contiguous view at its head (:meth:`arena`). A step
  captured over a capacity's arena (a CUDA graph, which reads and writes
  the addresses it saw) stays valid through every grow, so an engine
  captures each capacity's steps once, at warmup. The price: the card
  holds ``max_bytes()`` from the start, where the reference's arena
  holds ``bytes()`` and steps up (old and new for the length of a grow's
  copy).

The pool owns the buffers and the slot ledger; the decode engine
(``serving/generate.py``) owns the prefill, decode, insert and grow steps
that read and write them. :meth:`KVCachePool.export_slot` and
:meth:`KVCachePool.import_slot` carry one slot's history off the arena
and onto another as a host *segment*, in the reference's format (a dict
from one package imports into the other's pool). The pool publishes its
footprint, growth and rollbacks through ``serving/metrics.py``, from its
byte arithmetic: no record reads the card.
"""
from __future__ import annotations

import math
import threading

import numpy as np
import torch

from .. import device as _device
from ..io.bucketing import grow_buckets, next_bucket
from . import metrics


def _dtype(d):
    """A spec dtype (``"float32"``, a numpy or torch dtype) as a torch
    dtype."""
    if isinstance(d, torch.dtype):
        return d
    return getattr(torch, np.dtype(d).name)


def _leaves(spec):
    """A kv spec (leaf name -> (tail_shape, dtype)) as a sorted list of
    (name, tail_shape, torch dtype)."""
    return [(name, tuple(int(d) for d in spec[name][0]),
             _dtype(spec[name][1])) for name in sorted(spec)]


def bytes_per_token(spec):
    """Exact per-token KV footprint of one sequence: the sum over spec
    leaves of ``prod(tail) * itemsize``. A list of specs (a target and a
    draft arena) adds up."""
    if isinstance(spec, (list, tuple)):
        return sum(bytes_per_token(s) for s in spec)
    return sum(math.prod(tail) * torch.empty((), dtype=dt).element_size()
               for _, tail, dt in _leaves(spec))


def device_memory_limit(device=None):
    """The card's memory in bytes (``torch.cuda.mem_get_info``'s total) for
    a CUDA ``device``, the default card where ``device`` is None and there
    is one; None on the CPU, which has no budget to give a verdict on."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda")
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return int(torch.cuda.mem_get_info(device)[1])


def to_host(tensors):
    """``tensors`` (on one device) as numpy arrays on the host. From a CUDA
    card every tensor leaves by one non-blocking copy into one pinned host
    buffer (each at a 16-byte aligned offset) and the caller's stream is
    waited for once, after the last; on the CPU each is a clone."""
    if not tensors or tensors[0].device.type != "cuda":
        return [t.clone().numpy() for t in tensors]
    offsets, total = [], 0
    for t in tensors:
        offsets.append(total)
        total += -(-t.numel() * t.element_size() // 16) * 16
    host = torch.empty((total,), dtype=torch.uint8, pin_memory=True)
    views = []
    for t, off in zip(tensors, offsets):
        nb = t.numel() * t.element_size()
        views.append(host[off:off + nb].view(t.dtype).view(t.shape))
        views[-1].copy_(t, non_blocking=True)
    torch.cuda.current_stream(tensors[0].device).synchronize()
    return [v.numpy() for v in views]


class KVCachePool:
    """Fixed-slot KV arena with geometric capacity growth.

    Parameters
    ----------
    spec : leaf name -> (tail_shape, dtype), the per-token KV layout
        (``model.kv_spec()``).
    slots : decode batch width, concurrent sequences.
    page : smallest capacity bucket (tokens); capacity starts here.
    factor / max_len : the page schedule ``grow_buckets(page, factor,
        max_len)``; ``max_len`` caps prompt + generated tokens.
    device : where the buffers live (default: the port's device, the
        card; ``"cpu"`` on the CPU).
    label : the metrics namespace of a second arena (``"draft"``: the
        speculative draft's, published as ``serving.decode.draft_cache_*``).
    """

    def __init__(self, spec, slots, page=128, factor=2.0, max_len=1024,
                 device=None, label=None):
        self.spec = dict(spec)
        self.slots = int(slots)
        if self.slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        self.device = _device.resolve(device)
        self.label = label
        self.seq_buckets = grow_buckets(page, factor, max_len)
        self.max_len = int(self.seq_buckets[-1])
        self.capacity = int(self.seq_buckets[0])
        self._leaf_list = _leaves(self.spec)
        # the card's memory, read once: a metric never asks the card
        self._limit = limit = device_memory_limit(self.device)
        if limit is not None and self.max_bytes() > limit:
            raise ValueError(
                f"the arena at max_len={self.max_len} takes "
                f"{self.max_bytes()} bytes, more than the device's {limit}: "
                f"fewer slots (plan_slots) or a shorter max_len")
        self._flat = {name: torch.zeros(
            (self.slots * self.max_len * math.prod(tail),), dtype=dt,
            device=self.device) for name, tail, dt in self._leaf_list}
        self._arenas = {}
        self.buffers = self.arena(self.capacity)
        self._lock = threading.Lock()
        self._free = list(range(self.slots))[::-1]   # pop() -> slot 0 first
        # per-slot live length: how many leading arena positions hold
        # accepted history; readers mask by it
        self._lengths = [0] * self.slots
        self._grows = 0
        self._rollbacks = 0
        self._rollback_tokens = 0
        self._publish()

    def zeros(self, capacity, rows=None):
        """A fresh zero arena ``{leaf: [rows or slots, capacity, *tail]}``
        on the pool's device."""
        n = self.slots if rows is None else int(rows)
        return {name: torch.zeros((n, int(capacity)) + tail, dtype=dt,
                                  device=self.device)
                for name, tail, dt in self._leaf_list}

    def arena(self, capacity):
        """The arena at ``capacity``, ``{leaf: [slots, capacity, *tail]}``:
        contiguous views at the head of the pool's flat storage, the same
        tensors at every call (so the same addresses at every capacity).
        The arenas of two capacities overlap: only the current one
        (``buffers``) holds the slots' rows."""
        cap = int(capacity)
        if cap not in self._arenas:
            if cap > self.max_len:
                raise ValueError(f"capacity {cap} exceeds the pool's "
                                 f"max_len={self.max_len}")
            self._arenas[cap] = {
                name: self._flat[name][:self.slots * cap * math.prod(tail)]
                .view((self.slots, cap) + tail)
                for name, tail, _dt in self._leaf_list}
        return self._arenas[cap]

    def reserved_bytes(self):
        """What the pool's storage occupies: ``max_bytes()``, whatever the
        capacity."""
        return sum(f.numel() * f.element_size() for f in self._flat.values())

    # -- slot bookkeeping --------------------------------------------------

    def alloc(self):
        """Claim a free slot index, or None when the batch is full."""
        with self._lock:
            if not self._free:
                return None
            s = self._free.pop()
            self._lengths[s] = 0
            return s

    def free(self, slot):
        """Return a slot to the pool. Its stale rows stay: every reader
        masks by live length, and the next prefill overwrites them."""
        with self._lock:
            if slot in self._free:
                raise ValueError(f"slot {slot} double-freed")
            self._free.append(int(slot))
            self._lengths[int(slot)] = 0

    def length(self, slot):
        """Live (accepted) length of one slot's history."""
        with self._lock:
            return self._lengths[int(slot)]

    def note_length(self, slot, new_len):
        """Record that arena positions ``[0, new_len)`` of ``slot`` hold
        written history."""
        new_len = int(new_len)
        if new_len < 0 or new_len > self.capacity:
            raise ValueError(
                f"length {new_len} outside [0, capacity={self.capacity}]")
        with self._lock:
            self._lengths[int(slot)] = new_len

    def rollback(self, slot, new_len):
        """Truncate one slot's live length to ``new_len`` without moving
        data (the speculative verify-reject path); growing a length is
        :meth:`note_length`'s job, and this refuses it. Returns the
        tokens dropped."""
        new_len = int(new_len)
        with self._lock:
            cur = self._lengths[int(slot)]
            if new_len > cur:
                raise ValueError(
                    f"rollback to {new_len} would GROW slot {slot} "
                    f"(live length {cur}) — use note_length for writes")
            if new_len < 0:
                raise ValueError(f"rollback length {new_len} < 0")
            dropped = cur - new_len
            self._lengths[int(slot)] = new_len
            self._rollbacks += 1
            self._rollback_tokens += dropped
        if dropped:
            metrics.record_rollback(dropped, label=self.label)
        return dropped

    def free_slots(self):
        with self._lock:
            return len(self._free)

    def used_slots(self):
        with self._lock:
            return self.slots - len(self._free)

    # -- slot transport (hand-off between engines) -------------------------

    def _check_bytes(self, seg_bytes, pad, what):
        expected = bytes_per_token(self.spec) * pad
        if seg_bytes != expected:
            raise AssertionError(
                f"{what} byte accounting drifted: segment holds {seg_bytes} "
                f"bytes, spec arithmetic says {expected} ({pad} positions x "
                f"{bytes_per_token(self.spec)} B/tok)")

    def export_slot(self, slot, pad_to=None):
        """Copy one slot's resident history off the arena as a host
        *segment*, padded to ``pad_to`` positions (default: its live
        length; a capacity bucket lands on a warmed insert signature).
        Returns ``{"length", "pad", "bytes", "leaves"}``, ``leaves[name]``
        a ``[pad, *tail]`` numpy array: the reference's format. The byte
        count must equal ``bytes_per_token(spec) x pad`` to the byte
        (AssertionError otherwise). On the card every leaf leaves by one
        non-blocking copy into one pinned host buffer, and the export
        waits for the card once, after the last."""
        slot = int(slot)
        with self._lock:
            length = self._lengths[slot]
        pad = int(pad_to) if pad_to is not None else length
        if pad < length:
            raise ValueError(
                f"export pad {pad} < live length {length} of slot {slot}")
        if pad > self.capacity:
            raise ValueError(
                f"export pad {pad} exceeds arena capacity {self.capacity}")
        names = [name for name, _tail, _dt in self._leaf_list]
        leaves = dict(zip(names, to_host(
            [self.buffers[name][slot, :pad] for name in names])))
        seg_bytes = sum(int(a.nbytes) for a in leaves.values())
        self._check_bytes(seg_bytes, pad, "export_slot")
        return {"length": length, "pad": pad, "bytes": seg_bytes,
                "leaves": leaves}

    def import_slot(self, slot, segment, insert_fn=None):
        """Land an exported segment (from either package) in ``slot``:
        its leaves at arena positions ``[0, pad)``, its live length
        through :meth:`note_length`, so that a moved stream continues at
        the same generation index. ``insert_fn(buffers, chunk, slot)``
        is the engine's insert step (its signature noted, as a prefill's
        insert is); without it each leaf lands by a slice ``copy_``. The
        leaves reach the card by one pinned, non-blocking copy each: an
        import never waits for the card. Checks the pad against the
        capacity and the leaf names (ValueError), the bytes against the
        spec's arithmetic and the arena's footprint before and after
        (AssertionError). Returns the segment's bytes."""
        slot = int(slot)
        pad = int(segment["pad"])
        length = int(segment["length"])
        if pad > self.capacity:
            raise ValueError(
                f"segment pad {pad} exceeds arena capacity {self.capacity} "
                f"— grow first")
        leaves = segment["leaves"]
        names = {name for name, _t, _d in self._leaf_list}
        if set(leaves) != names:
            raise ValueError(
                f"segment leaves {sorted(leaves)} != spec leaves "
                f"{sorted(names)}")
        seg_bytes = sum(int(np.asarray(a).nbytes) for a in leaves.values())
        self._check_bytes(seg_bytes, pad, "import_slot")
        before = self.allocated_bytes()
        chunk = {}
        for name, _tail, dt in self._leaf_list:
            a = np.asarray(leaves[name])
            # a read-only array (the reference's segments) is copied: a
            # tensor must not alias memory it may not write
            a = a if a.flags.writeable else a.copy()
            chunk[name] = _device.to_device(a[None], self.device, dt)
        if insert_fn is not None:
            insert_fn(self.buffers, chunk, slot)
        else:
            for name, buf in self.buffers.items():
                buf[slot, :pad].copy_(chunk[name][0])
        after = self.allocated_bytes()
        if after != before:
            raise AssertionError(
                f"import_slot changed the arena footprint: {before} -> "
                f"{after} bytes")
        self.note_length(slot, length)
        return seg_bytes

    # -- capacity schedule -------------------------------------------------

    def capacity_for(self, needed_len):
        """The family bucket a sequence of ``needed_len`` tokens needs
        (raises past ``max_len``: admission should have rejected it)."""
        needed = int(needed_len)
        if needed > self.max_len:
            raise ValueError(
                f"sequence of {needed} tokens exceeds the pool's "
                f"max_len={self.max_len} (family {self.seq_buckets})")
        return next_bucket(needed, self.seq_buckets)

    def needs_growth(self, needed_len):
        return self.capacity_for(needed_len) > self.capacity

    def grow_to(self, new_capacity, grow_fn):
        """Step the arena to ``new_capacity`` (a family member) with
        ``grow_fn(buffers, old_cap, new_cap) -> buffers``, which the
        engine supplies. The arena never shrinks."""
        new_capacity = int(new_capacity)
        if new_capacity not in self.seq_buckets:
            raise ValueError(
                f"capacity {new_capacity} is not in the bucket family "
                f"{self.seq_buckets}")
        if new_capacity <= self.capacity:
            return
        self.buffers = grow_fn(self.buffers, self.capacity, new_capacity)
        self.capacity = new_capacity
        self._grows += 1
        metrics.record_cache_grow(new_capacity)
        self._publish()

    # -- budget ------------------------------------------------------------

    def bytes(self, capacity=None):
        """Exact arena footprint at ``capacity`` (default: current):
        ``slots x capacity x bytes_per_token(spec)``."""
        cap = self.capacity if capacity is None else int(capacity)
        return self.slots * cap * bytes_per_token(self.spec)

    def max_bytes(self):
        """The worst case, every slot at ``max_len``: the number to check
        against the device's memory before serving."""
        return self.bytes(self.max_len)

    def allocated_bytes(self):
        """What the live buffers occupy (equals :meth:`bytes`)."""
        return sum(b.numel() * b.element_size()
                   for b in self.buffers.values())

    def headroom(self, limit_bytes=None):
        """``(limit - max_bytes, limit)`` against the card's memory
        (``limit_bytes`` overrides it); ``(None, None)`` on the CPU."""
        if limit_bytes is None:
            limit_bytes = self._limit
        if limit_bytes is None:
            return None, None
        return int(limit_bytes) - self.max_bytes(), int(limit_bytes)

    def _publish(self):
        headroom, limit = self.headroom()
        metrics.record_cache(self.bytes(), self.capacity,
                             headroom_bytes=headroom, limit_bytes=limit,
                             label=self.label)

    def stats(self):
        return {
            "slots": self.slots,
            "used_slots": self.used_slots(),
            "capacity": self.capacity,
            "max_len": self.max_len,
            "seq_buckets": list(self.seq_buckets),
            "cache_bytes": self.bytes(),
            "cache_max_bytes": self.max_bytes(),
            "grows": self._grows,
            "rollbacks": self._rollbacks,
            "rollback_tokens": self._rollback_tokens,
        }


def fits_budget(spec, slots, max_len, limit_bytes=None, reserve_frac=0.0):
    """Pre-flight: does a pool of ``slots x max_len`` fit in the device's
    memory with ``reserve_frac`` held back for weights and activations?
    Returns ``(fits, needed_bytes, limit)``; ``fits`` and ``limit`` are
    None where no budget is known (no card). A list ``spec`` prices a
    target and a draft arena together."""
    needed = int(slots) * int(max_len) * bytes_per_token(spec)
    if limit_bytes is None:
        limit_bytes = device_memory_limit()
    if limit_bytes is None:
        return None, needed, None
    usable = int(limit_bytes) * (1.0 - float(reserve_frac))
    return needed <= usable, needed, int(limit_bytes)


def plan_slots(spec, max_len, limit_bytes=None, reserve_frac=0.5,
               max_slots=256):
    """The largest slot count whose worst-case pool fits in ``(1 -
    reserve_frac)`` of the budget, at most ``max_slots``; None where no
    budget is known."""
    if limit_bytes is None:
        limit_bytes = device_memory_limit()
    if limit_bytes is None:
        return None
    per_slot = int(max_len) * bytes_per_token(spec)
    usable = int(limit_bytes) * (1.0 - float(reserve_frac))
    return max(0, min(int(max_slots), int(math.floor(usable / per_slot))))
