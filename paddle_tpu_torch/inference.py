"""paddle_tpu_torch.inference — Config and Predictor.

Counterpart of ``paddle_tpu/inference.py``. The reference compiles one
executable per input signature (``_compiled``, ``warmup``'s
``lower().compile()``); the port's executable is a CUDA graph
(:class:`paddle_tpu_torch.graphs.GraphEntry`): ``_compiled`` maps each
signature to its entry, with static inputs, static outputs and a graph
pool. A signature's first call runs the forward eagerly on a side stream
(that call's result) and captures it; :meth:`Predictor.warmup` captures
from zeros ahead of traffic, and every later call copies its inputs in,
replays and returns clones of the outputs. On the CPU an entry re-runs
the forward over its static buffers instead of a replay.

An entry belongs to the module it captured: its graph reads that
module's weights. A call reads ``model`` once as it begins, and a call
that finds the served module rebound replays no entry of the old one. A
serving fleet captures the new module's signatures before it binds it
(:meth:`Predictor.prepare`), so no call under traffic captures.

The int8 path, ``export`` and ``compile_report`` are not ported yet.
"""
from __future__ import annotations

import copy
import threading

import numpy as np
import torch
from torch.utils import _pytree as pytree

from . import device as _device
from . import monitor as _monitor
from .graphs import GraphEntry, eager_on_side_stream

# numpy dtypes the reference's ``jnp.asarray`` canonicalises to 32 bits
_CANON = {np.dtype("float64"): np.float32, np.dtype("int64"): np.int32,
          np.dtype("uint64"): np.uint32}


def to_host(t):
    """A device output as a host numpy array. bf16, which numpy lacks,
    comes back as float32."""
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


class Config:
    """Precision knob: float32, or bf16 via :meth:`enable_bf16`."""

    def __init__(self, model_path=None):
        self.model_path = model_path
        self.precision = "float32"

    def enable_bf16(self):
        self.precision = "bfloat16"
        return self


class Predictor:
    """Wraps an eval-mode Layer on one device.

    ``Predictor(model, config=None, device=None)`` moves ``model`` to
    ``device`` (default :func:`paddle_tpu_torch.device.get_device`, the
    CUDA card) and raises ``RuntimeError`` when that is CUDA and no card
    is present. With ``Config().enable_bf16()`` it serves a bf16 copy of
    the model (floating parameters cast; the caller's model is left as
    it was); outputs still reach the host as float32. ``captures`` counts
    the graphs captured, which ``_compiled``'s size does not when a
    rebound module's signatures are captured again.
    """

    def __init__(self, model, config=None, device=None):
        if isinstance(model, Config):
            raise NotImplementedError(
                "Predictor(Config(model_path)): loading a saved model is "
                "not ported yet; pass the model")
        self.config = config or Config()
        self.device = _device.resolve(device)
        if self.config.precision == "bfloat16":
            model = copy.deepcopy(model).to(self.device,
                                            dtype=torch.bfloat16)
        elif self.config.precision == "float32":
            model = model.to(self.device)
        else:
            raise NotImplementedError(
                f"Predictor: precision {self.config.precision!r} is not "
                f"ported yet")
        self.model = model.eval()
        self._fresh_executables()

    def _fresh_executables(self):
        """No executable yet: a new Predictor, or a fleet's replica copied
        from one (each owns its entries, lock and stream)."""
        self._compiled = {}   # signature -> entry of the served module
        self._prepared = {}   # signature -> entry of a module not bound yet
        self._build_lock = threading.Lock()
        self._stream = None
        self.captures = 0

    @property
    def state(self):
        """The served model's weights as ``{name: tensor}``, views of its
        own (what a serving fleet's ``swap_weights`` takes, and copies
        into each replica's model)."""
        return dict(self.model.state_dict())

    @staticmethod
    def _signature(arrays):
        """The reference's cache key: each input's shape and dtype name."""
        return tuple((tuple(a.shape), str(a.dtype).replace("torch.", ""))
                     for a in arrays)

    def _to_device(self, x):
        if isinstance(x, torch.Tensor):
            return x.to(self.device)
        x = np.asarray(x)
        if x.dtype in _CANON:
            x = x.astype(_CANON[x.dtype])
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    def run(self, *inputs, buckets=None):
        """Run inference; inputs are numpy arrays or tensors. Returns
        numpy outputs (a list when the model returns several). With
        ``buckets`` (True for powers of two, or a size list) the batch
        dim is padded up to the next bucket and outputs sliced back."""
        out = self.run_device(*inputs, buckets=buckets)
        if isinstance(out, (tuple, list)):
            return [to_host(o) for o in out]
        return to_host(out)

    def run_device(self, *inputs, buckets=None):
        """Like :meth:`run` but returns the outputs as tensors on the
        Predictor's device, without the copy to the host."""
        arrays = [self._to_device(x) for x in inputs]
        real_n = None
        if buckets and arrays and arrays[0].ndim >= 1:
            from .io.bucketing import next_bucket, pad_to_bucket
            n = arrays[0].shape[0]
            target = next_bucket(n, None if buckets is True else buckets)
            if target != n:
                real_n = n
                arrays = [pad_to_bucket(a, target)
                          if a.ndim >= 1 and a.shape[0] == n else a
                          for a in arrays]
                if _monitor.enabled():
                    _monitor.counter("inference.bucket_pad").inc()
        out = self._run(arrays)
        if real_n is not None:
            from .io.bucketing import unpad
            if isinstance(out, (tuple, list)):
                out = tuple(unpad(o, real_n) for o in out)
            else:
                out = unpad(out, real_n)
        return out

    def _run(self, arrays):
        """The served module's entry for this signature, replayed; a new
        one (or one for a rebound module) built first."""
        model = self.model      # read once: a rebinding serves the next call
        sig = self._signature(arrays)
        entry = self._compiled.get(sig)
        if entry is None or entry.module is not model:
            first, entry = self._entry(model, sig, arrays, "compile")
            if first is not None:
                return pytree.tree_unflatten(first, entry.out_spec)
        elif _monitor.enabled():
            _monitor.counter("inference.cache_hit").inc()
        return pytree.tree_unflatten(entry.replay(arrays), entry.out_spec)

    def _entry(self, model, sig, arrays, why):
        """Under the build lock: the entry of ``model`` for ``sig`` —
        ``_compiled``'s, a prepared one, or a capture over ``arrays``
        (whose eager outputs are returned first, else None). A signature
        new to ``_compiled`` counts as ``inference.compile`` (or
        ``inference.aot_warmup`` from :meth:`warmup`)."""
        with self._build_lock:
            entry = self._compiled.get(sig)
            if entry is not None and entry.module is model:
                return None, entry
            fresh = entry is None
            entry = self._prepared.pop(sig, None)
            first = None
            if entry is None or entry.module is not model:
                span = "inference.warmup" if why == "aot_warmup" \
                    else "inference.compile"
                with _monitor.trace.span(span, model=type(model).__name__):
                    first, entry = self._capture(model, arrays)
            self._compiled[sig] = entry
            if fresh and _monitor.enabled():
                _monitor.counter(f"inference.{why}").inc()
                _monitor.gauge("inference.executables").set(
                    len(self._compiled))
            return first, entry

    def _capture(self, model, arrays):
        """A new entry of ``model`` over ``arrays``' signature: the forward
        run once eagerly (its outputs are returned with the entry), then
        captured. Entries of one module share a graph pool and a lock,
        which serialises their replays: they share the pool's memory."""
        def run(*xs):
            # grad mode is thread-local: the serving batcher calls this
            # from its own thread, so the no-grad context is entered here
            with torch.inference_mode():
                leaves, entry.out_spec = pytree.tree_flatten(model(*xs))
            return leaves

        peer = next((e for e in list(self._compiled.values()) +
                     list(self._prepared.values()) if e.module is model),
                    None)
        entry = GraphEntry(run, arrays, self.device,
                           label=f"Predictor({type(model).__name__})",
                           lock=peer.lock if peer else threading.Lock())
        entry.module = model
        self.captures += 1
        if not entry.card:
            return run(*arrays), entry
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        entry.pool = peer.pool if peer else torch.cuda.graph_pool_handle()
        first = eager_on_side_stream(run, arrays, self._stream)
        with torch.no_grad():
            for buf, a in zip(entry.inputs, arrays):
                buf.copy_(a)
        # thread-local: another replica on this card keeps serving while
        # this one captures
        entry.capture(pool=entry.pool, stream=self._stream,
                      mode="thread_local")
        return first, entry

    def prepare(self, module):
        """Capture every signature this Predictor serves over ``module``
        (from zeros) ahead of binding it as ``model``, so that no call
        after the rebinding captures. Returns the number captured."""
        with self._build_lock:
            self._prepared = {}    # its entries share one pool as they come
            for sig in list(self._compiled):
                arrays = [torch.zeros(shape, dtype=getattr(torch, dtype),
                                      device=self.device)
                          for shape, dtype in sig]
                _, self._prepared[sig] = self._capture(module, arrays)
            n = len(self._prepared)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return n

    def warmup(self, *signatures):
        """Capture each signature ahead of traffic, from zeros: each is a
        list with one ``(shape, dtype)`` pair (or template array) per
        model input. Returns the signature keys, as :meth:`run` computes
        them."""
        keys = []
        model = self.model
        for sig in signatures:
            arrays = []
            for item in sig:
                if hasattr(item, "shape") and hasattr(item, "dtype"):
                    shape, dtype = item.shape, item.dtype
                else:
                    shape, dtype = item
                dt = np.dtype(dtype)
                arrays.append(self._to_device(np.zeros(
                    tuple(int(s) for s in shape), dtype=dt)))
            key = self._signature(arrays)
            entry = self._compiled.get(key)
            if entry is None or entry.module is not model:
                self._entry(model, key, arrays, "aot_warmup")
            keys.append(key)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return keys
