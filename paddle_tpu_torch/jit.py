"""paddle_tpu_torch.jit — ``to_static``, ``StaticFunction`` and
``TracedLayer``.

Counterpart of ``paddle_tpu/jit.py``, which traces a dygraph step
(forward, backward and the optimizer update) into one donated-buffer XLA
executable per input signature. The port's executable is a CUDA graph
(:class:`paddle_tpu_torch.graphs.GraphEntry`):

* **state** is found as the reference finds it: from ``models=`` and
  ``optimizers=`` or the step's closure. It is not passed through the
  graph, as the reference passes its state, but read and written in place
  at addresses the graph captured (the optimizers update in place), so
  the key also holds those addresses: state that moved is captured anew
  (the ``jit.recapture`` counter, which the reference has no reason to
  keep);
* **the cache key** is the reference's: the arguments' tree structure,
  the positions of their arrays (tensors, or numpy arrays, which become
  tensors on the step's device), the other leaves, the models' train
  flags and the state's names (every slot created first, as the
  reference's ``_ensure_all_slots``), plus the arrays' shapes and dtypes;
* **bucketing** (``bucket``, ``buckets``, ``pad_mode``) pads the arrays'
  common leading dim up to a bucket, and outputs at the bucket size are
  sliced back, over :mod:`paddle_tpu_torch.io.bucketing`;
* **the monitor** counts ``jit.compile``, ``jit.cache_hit``,
  ``jit.recompile``, ``jit.bucket_pad`` and ``jit.compile_s`` and traces
  the spans ``jit.compile.<fn>`` and ``jit.<fn>``, as the reference's;
* **a new key's first call** runs the step eagerly on a side stream (that
  is the call's result, and it builds the kernels and any lazy state),
  then captures it into a pool the function's entries share. The
  capture's Python run changes no host state: the kernels' launch counts
  and the optimizers' host step counts it advanced are taken back, and
  each replay adds them;
* **each later call** copies its arrays into the entry's static buffers,
  replays, and returns clones of the static outputs.

On the CPU (a step whose tensors, or whose models, live there) each
later call re-runs the step over the entry's static buffers instead of a
replay. On the card nothing falls back to eager: a step that cannot be
captured raises :class:`~paddle_tpu_torch.graphs.CaptureError`.

``input_spec`` and ``donate_state`` are taken and change nothing (the
state is updated in place already). ``plan`` (ROADMAP.md Queue A item
19), ``remat`` (items 8 and 20) and ``scalers`` (item 6) raise
``NotImplementedError``; so does the reference's AST pass, which the port
does not have (item 18).
"""
from __future__ import annotations

import functools
import inspect
import threading
import time

import numpy as np
import torch
from torch.utils import _pytree as pytree

from . import monitor as _monitor
from .graphs import GraphEntry, eager_on_side_stream
from .optimizer import Optimizer

# numpy dtypes JAX canonicalises to 32 bits, as ``jnp.asarray`` does
_CANON = {np.dtype("float64"): np.float32, np.dtype("int64"): np.int32,
          np.dtype("uint64"): np.uint32}


def _discover_state_objects(fn, models, optimizers):
    """The models and optimizers a step touches: those given, plus the
    Layers and Optimizers in ``fn``'s closure and a bound method's
    object (the reference's discovery; loss scalers are not ported)."""
    models = list(models) if models else []
    optimizers = list(optimizers) if optimizers else []
    seen = {id(o) for o in models + optimizers}

    def visit(obj):
        if id(obj) in seen:
            return
        if isinstance(obj, torch.nn.Module):
            seen.add(id(obj))
            models.append(obj)
        elif isinstance(obj, Optimizer):
            seen.add(id(obj))
            optimizers.append(obj)

    target = fn
    while hasattr(target, "__wrapped__"):
        target = target.__wrapped__
    if inspect.ismethod(target):
        visit(target.__self__)
        target = target.__func__
    for cell in getattr(target, "__closure__", None) or ():
        try:
            visit(cell.cell_contents)
        except ValueError:      # an empty cell
            pass
    return models, optimizers


def _collect_state(models, optimizers):
    """Name -> tensor for everything the step may read or write: each
    optimizer's learning rates, slots and arena buffers (every slot
    created first), then each model's parameters (those an arena does not
    hold) and buffers, under the reference's names."""
    holders = {}
    covered = set()
    for oi, o in enumerate(optimizers):
        if o._parameter_list is not None:
            o._ensure_all_slots()
        for dev, t in o._lr.items():
            holders[f"o{oi}.lr.{dev}"] = t
        for pid, slots in o._accumulators.items():
            for sname, t in slots.items():
                holders[f"o{oi}.{pid}.{sname}"] = t
        arena = o._arena
        if arena is not None:
            covered |= arena._pids
            for gi, grp in enumerate(arena.groups):
                holders[f"o{oi}.arena{gi}.flat"] = grp.flat
                for sname, t in list(grp.slots.items()) + \
                        list(grp.pows.items()):
                    holders[f"o{oi}.arena{gi}.{sname}"] = t
    for mi, m in enumerate(models):
        for name, p in m.named_parameters():
            if id(p) not in covered:
                holders[f"m{mi}.{name}"] = p
        for name, b in m.named_buffers():
            holders[f"m{mi}.buf.{name}"] = b
    return holders


def _as_tensor(a, device):
    """An array argument as a tensor on ``device``: a numpy array with its
    64-bit dtypes canonicalised to 32 bits, as the reference's
    ``jnp.asarray``; a tensor as it is."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    if a.dtype in _CANON:
        a = a.astype(_CANON[a.dtype])
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _detached(leaves):
    return [o.detach() if isinstance(o, torch.Tensor) else o
            for o in leaves]


class StaticFunction:
    """The compiled callable that :func:`to_static` returns."""

    def __init__(self, fn, models=None, optimizers=None, bucket=False,
                 buckets=None, pad_mode="repeat"):
        functools.update_wrapper(self, fn, assigned=("__name__", "__doc__"),
                                 updated=())
        self._fn = fn
        self._models = models
        self._optimizers = optimizers
        self._bucket = bucket
        self._buckets = buckets
        self._pad_mode = pad_mode
        self._cache = {}
        self._seen_base = set()   # recompile (vs first compile) accounting
        # one call at a time: the entries share their static buffers' pool
        self._lock = threading.Lock()
        self._pools = {}          # device -> the entries' graph pool
        self._streams = {}        # device -> the side stream

    def _resolve_objects(self):
        if self._models is None or self._optimizers is None:
            self._models, self._optimizers = _discover_state_objects(
                self._fn, self._models, self._optimizers)
        return self._models, self._optimizers

    @staticmethod
    def _device(models, arrays):
        for m in models:
            for t in m.parameters():
                return t.device
        for a in arrays:
            if isinstance(a, torch.Tensor):
                return a.device
        return torch.device("cpu")

    def _side(self, device):
        if device not in self._streams:
            self._streams[device] = torch.cuda.Stream(device)
            self._pools[device] = torch.cuda.graph_pool_handle()
        return self._streams[device], self._pools[device]

    def __call__(self, *args, **kwargs):
        with self._lock:
            return self._call(args, kwargs)

    def _call(self, args, kwargs):
        models, optimizers = self._resolve_objects()
        holders = _collect_state(models, optimizers)
        state_names = sorted(holders)
        addresses = tuple(holders[n].data_ptr() for n in state_names)

        leaves, spec = pytree.tree_flatten((args, kwargs))
        arr_idx, arrays, statics = [], [], []
        for i, a in enumerate(leaves):
            if isinstance(a, (torch.Tensor, np.ndarray)):
                arr_idx.append(i)
                arrays.append(a)
            else:
                statics.append((i, a))
        device = self._device(models, arrays)
        arrays = [_as_tensor(a, device) for a in arrays]

        pad_info = None
        if self._bucket and arrays and arrays[0].ndim >= 1:
            from .io.bucketing import next_bucket, pad_to_bucket
            lead = arrays[0].shape[0]
            target = next_bucket(lead, self._buckets)
            if target != lead:
                arrays = [pad_to_bucket(a, target, mode=self._pad_mode)
                          if a.ndim >= 1 and a.shape[0] == lead else a
                          for a in arrays]
                pad_info = (lead, target)
                if _monitor.enabled():
                    _monitor.counter("jit.bucket_pad").inc()

        train_flags = tuple(m.training for m in models)
        # which parameters train is part of the reference's validity key:
        # a graph captured their updates
        trainable = tuple(p.requires_grad for m in models
                          for p in m.parameters())
        base = (spec, tuple(arr_idx),
                tuple((i, repr(s)) for i, s in statics), train_flags,
                tuple(state_names), trainable)
        key = base + (tuple((tuple(a.shape), str(a.dtype), str(a.device))
                            for a in arrays),)
        label = getattr(self, "__name__", "fn")
        entry = self._cache.get(key)
        is_new = entry is None
        if _monitor.enabled():
            if not is_new:
                _monitor.counter("jit.cache_hit").inc()
            else:
                _monitor.counter("jit.compile").inc()
                if base in self._seen_base:
                    _monitor.counter("jit.recompile").inc()
        if not is_new and entry.addresses != addresses:
            # state moved (a model re-placed, a tensor rebound): the graph
            # would read the old storage, so capture anew under this key
            if _monitor.enabled():
                _monitor.counter("jit.recapture").inc()
            is_new = True
        if is_new:
            self._seen_base.add(base)
            t0 = time.perf_counter()
            with _monitor.trace.span(f"jit.compile.{label}"):
                out_leaves, entry = self._compile(
                    spec, leaves, arr_idx, arrays, device, optimizers,
                    models, label)
            # the addresses the graph captured: a first step may still
            # have replaced a slot (a moment cast to float32)
            holders = _collect_state(models, optimizers)
            entry.addresses = tuple(holders[n].data_ptr() if n in holders
                                    else None for n in state_names)
            self._cache[key] = entry
            if _monitor.enabled():
                _monitor.counter("jit.compile_s").inc(
                    time.perf_counter() - t0)
        else:
            with _monitor.trace.span(f"jit.{label}"):
                out_leaves = entry.replay(arrays)
            if entry.card:
                for o, delta in zip(optimizers, entry.host_steps):
                    for pid, n in delta.items():
                        o._steps[pid] = o._steps.get(pid, 0) + n
        for m in models:
            for p in m.parameters():
                p.grad = None

        if pad_info is not None:
            lead, target = pad_info
            out_leaves = [o[:lead] if isinstance(o, torch.Tensor) and
                          o.ndim >= 1 and o.shape[0] == target else o
                          for o in out_leaves]
        return pytree.tree_unflatten(out_leaves, entry.out_spec)

    def _compile(self, spec, leaves, arr_idx, arrays, device, optimizers,
                 models, label):
        """A new entry for this key: the step's first run (eager, on a side
        stream on the card), then its capture. Returns the first run's
        output leaves and the entry."""
        fn = self._fn
        template = list(leaves)

        def run(*tensors):
            flat = list(template)
            for i, t in zip(arr_idx, tensors):
                flat[i] = t
            a, kw = pytree.tree_unflatten(flat, spec)
            out_leaves, entry.out_spec = pytree.tree_flatten(fn(*a, **kw))
            return out_leaves

        entry = GraphEntry(run, arrays, device, label=f"to_static({label})")
        entry.host_steps = [{} for _ in optimizers]
        if not entry.card:
            return _detached(run(*arrays)), entry
        stream, pool = self._side(device)
        first = _detached(eager_on_side_stream(run, arrays, stream))
        for m in models:
            for p in m.parameters():
                p.grad = None
        with torch.no_grad():
            for buf, a in zip(entry.inputs, arrays):
                buf.copy_(a)
        steps = [dict(o._steps) for o in optimizers]
        try:
            entry.capture(pool=pool, stream=stream)
        finally:
            # the capture's run advanced the host step counts, which the
            # card's work did not: take them back; each replay adds them
            for i, (o, before) in enumerate(zip(optimizers, steps)):
                after, o._steps = o._steps, before
                entry.host_steps[i] = {
                    pid: n - before.get(pid, 0) for pid, n in after.items()
                    if n != before.get(pid, 0)}
        return first, entry


def to_static(function=None, input_spec=None, models=None, optimizers=None,
              donate_state=True, scalers=None, bucket=False, buckets=None,
              pad_mode="repeat", plan=None, remat=None, **kwargs):
    """Decorator/wrapper: compile a step into one CUDA graph per input
    signature (a re-run over static buffers on the CPU); see the module
    docstring. The ``models`` are put in train mode when the wrapper is
    built. ``bucket=True`` (with ``buckets=[...]``) pads the arrays'
    common leading dim up to a bucket (``pad_mode="repeat"`` repeats the
    last real row, ``"zeros"`` zero-fills) and slices outputs at the
    bucket size back; padded rows take part in reductions, as in the
    reference."""
    for name, value, item in (("plan", plan, "item 19"),
                              ("remat", remat, "items 8 and 20"),
                              ("scalers", scalers, "item 6")):
        if value is not None:
            raise NotImplementedError(
                f"jit.to_static({name}=...) is not ported yet (ROADMAP.md "
                f"Queue A {item})")
    if kwargs:
        raise TypeError(f"jit.to_static: unexpected arguments "
                        f"{sorted(kwargs)}")

    def wrap(fn):
        for m in models or ():
            m.train()
        return StaticFunction(fn, models=models, optimizers=optimizers,
                              bucket=bucket, buckets=buckets,
                              pad_mode=pad_mode)

    return wrap if function is None else wrap(function)


class TracedLayer:
    """The reference's ``fluid.dygraph.TracedLayer``: ``layer`` compiled
    for inference through a :class:`StaticFunction` (its mode left as it
    is)."""

    def __init__(self, layer, example_inputs):
        self._layer = layer
        self._static = StaticFunction(lambda *xs: layer(*xs),
                                      models=[layer], optimizers=[])
        self._example = example_inputs

    @staticmethod
    def trace(layer, inputs):
        tl = TracedLayer(layer, inputs)
        out = tl(*inputs)
        return out, tl

    def __call__(self, *args):
        return self._static(*args)


__all__ = ["to_static", "StaticFunction", "TracedLayer"]
