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

The deployment path (``paddle_tpu/inference.py``'s other half):

* ``Predictor(Config(model_path))`` and :func:`create_predictor` serve a
  model saved by :func:`paddle_tpu_torch.io.save_inference_model`; the
  loaded model is the Predictor's own.
* ``Config().enable_int8(calibration_data)`` serves a calibrated int8 copy
  (:func:`paddle_tpu_torch.quantization.quant_post_static`; without data,
  :func:`~paddle_tpu_torch.quantization.convert`): its Linear and Conv2D
  layers multiply in int8 through the port's ``int8_quantize`` and
  ``int8_gemm`` kernels, captured into the signature's graph like any
  other forward; outputs stay float32 at the edges. A model the caller
  passed is copied first, never rewritten.
* :meth:`Predictor.export` writes a ``torch.export`` program with the
  weights in it (``torch.export.save``), the counterpart of the
  reference's StableHLO artifact; :func:`load_exported` runs it with no
  model class. The served kernels are custom ops (``paddle_tpu_torch::``
  ``layer_norm_fwd``, ``flash_attention_fwd``, ``int8_quantize``,
  ``int8_gemm``), so the program calls the same kernels on the card.
* :meth:`Predictor.compile_report` gives the reference's keys
  (``flops``, ``bytes_accessed``, ``peak_memory``) through
  :mod:`paddle_tpu_torch.monitor.xla`: flops from PyTorch's flop counter
  over one forward (a formula for each custom op), bytes from a dispatch
  mode summing each operation's operand and result bytes, and on the card
  the allocator's peak over the signature's first run and capture.
"""
from __future__ import annotations

import copy
import threading
import weakref

import numpy as np
import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

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
    """The reference's AnalysisConfig: the saved model's path prefix
    (``Predictor(Config(path))``) and the precision, float32, bf16
    (:meth:`enable_bf16`) or int8 (:meth:`enable_int8`)."""

    def __init__(self, model_path=None):
        self.model_path = model_path
        self.precision = "float32"

    def enable_bf16(self):
        self.precision = "bfloat16"
        return self

    def enable_int8(self, calibration_data=None):
        """Serve int8: with ``calibration_data`` (an iterable of input
        batches: arrays or tensors, or tuples of them for a model of
        several inputs) the activation scales are calibrated and every
        Linear and Conv2D multiplies int8 x int8 -> int32 through the
        port's kernels, float only at the edges; without it the weights
        are stored int8 and dequantize into a float product."""
        self.precision = "int8"
        self.calibration_data = calibration_data
        return self


class Predictor:
    """Wraps an eval-mode Layer on one device.

    ``Predictor(model, config=None, device=None)`` moves ``model`` to
    ``device`` (default :func:`paddle_tpu_torch.device.get_device`, the
    CUDA card) and raises ``RuntimeError`` when that is CUDA and no card
    is present; ``Predictor(Config(path))`` loads the model saved under
    ``path`` instead. With ``Config().enable_bf16()`` it serves a bf16
    copy of the model (floating parameters cast); with
    ``enable_int8(...)`` an int8 one (see :meth:`Config.enable_int8`).
    Either way a model the caller passed is left as it was; a path-loaded
    one is the Predictor's own and is changed in place. Outputs reach the
    host as float32. ``captures`` counts the graphs captured, which
    ``_compiled``'s size does not when a rebound module's signatures are
    captured again.
    """

    def __init__(self, model, config=None, device=None):
        caller_owns_model = True
        if isinstance(model, Config):
            config = model
            if config.model_path is None:
                raise ValueError("Predictor(Config()): the config names no "
                                 "model_path")
            from . import io as pio
            model = pio.load_inference_model(config.model_path)
            caller_owns_model = False
        self.config = config or Config()
        self.device = _device.resolve(device)
        precision = self.config.precision
        if precision not in ("float32", "bfloat16", "int8"):
            raise NotImplementedError(
                f"Predictor: precision {precision!r} is not ported")
        if precision != "float32" and caller_owns_model:
            model = copy.deepcopy(model)
        if precision == "bfloat16":
            model = model.to(self.device, dtype=torch.bfloat16)
        else:
            model = model.to(self.device)
        if precision == "int8":
            from .quantization import convert, quant_post_static
            cal = getattr(self.config, "calibration_data", None)
            model = quant_post_static(model, cal) if cal is not None \
                else convert(model)
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
        entry.peak_memory = None
        self.captures += 1
        if not entry.card:
            return run(*arrays), entry
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        entry.pool = peer.pool if peer else torch.cuda.graph_pool_handle()
        # the allocator's peak over the first run and the capture is the
        # signature's peak memory (compile_report)
        torch.cuda.reset_peak_memory_stats(self.device)
        first = eager_on_side_stream(run, arrays, self._stream)
        with torch.no_grad():
            for buf, a in zip(entry.inputs, arrays):
                buf.copy_(a)
        # thread-local: another replica on this card keeps serving while
        # this one captures
        entry.capture(pool=entry.pool, stream=self._stream,
                      mode="thread_local")
        entry.peak_memory = torch.cuda.max_memory_allocated(self.device)
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

    def export(self, path, *example_inputs):
        """Write the served model as a ``torch.export`` program at
        ``example_inputs``' shapes, its weights in the file
        (``torch.export.save``): the counterpart of the reference's
        StableHLO artifact, which :func:`load_exported` runs with no model
        class. Traced without gradients; the kernels on the path appear as
        the port's custom ops, so the program calls the same kernels on
        the card. A forward that branches on a tensor's value cannot be
        traced: ``RuntimeError`` names the model and the line. Returns
        ``path``."""
        arrays = [self._to_device(x) for x in example_inputs]
        try:
            with torch.no_grad():
                program = torch.export.export(self.model, tuple(arrays),
                                              strict=False)
        except Exception as exc:  # noqa: BLE001 - re-raised, named
            from .graphs import _culprit
            raise RuntimeError(
                f"Predictor.export: torch.export cannot trace "
                f"{type(self.model).__name__} ({type(exc).__name__}); a "
                f"branch on a tensor's value must depend on shapes only. "
                f"The operation: {_culprit(exc)}") from exc
        torch.export.save(program, path)
        return path

    def compile_report(self, *inputs):
        """The cost of the executable for ``inputs``' signature (captured
        first if it is new): ``flops`` (PyTorch's flop counter over one
        forward: matrix products, convolutions and the custom ops'
        formulas, 2 M K N for ``int8_gemm`` and 4 B H Sq Sk D for
        attention), ``bytes_accessed`` (each operation's operand and
        result bytes, summed) and ``peak_memory`` (on the card the
        allocator's peak over the first run and capture; on the CPU the
        state, inputs and the most bytes the forward held at once). Stored
        and reported through :mod:`paddle_tpu_torch.monitor.xla` under
        ``predictor.<model class>``."""
        from torch.utils.flop_counter import FlopCounterMode
        from .monitor import xla as _xla
        arrays = [self._to_device(x) for x in inputs]
        model = self.model
        sig = self._signature(arrays)
        entry = self._compiled.get(sig)
        if entry is None or entry.module is not model:
            self._run(arrays)
            entry = self._compiled[sig]
        counter = _ByteCounter()
        with torch.inference_mode(), FlopCounterMode(display=False) as fc, \
                counter:
            model(*arrays)
        peak = entry.peak_memory
        if peak is None:
            held = sum(t.numel() * t.element_size()
                       for t in list(model.parameters()) +
                       list(model.buffers()) + arrays)
            peak = held + counter.peak
        cost = _Cost(flops=fc.get_total_flops(), nbytes=counter.bytes,
                     peak=peak)
        return _xla.capture(f"predictor.{type(model).__name__}", cost)


class _Cost:
    """A capture for :func:`paddle_tpu_torch.monitor.xla.capture`: the
    reference's ``cost_analysis()`` and ``memory_analysis()`` keys."""

    def __init__(self, flops, nbytes, peak):
        self._cost = {"flops": flops, "bytes accessed": nbytes}
        self._memory = {"peak_memory": peak}

    def cost_analysis(self):
        return self._cost

    def memory_analysis(self):
        return self._memory


def _nbytes(t):
    return t.numel() * t.element_size()


class _ByteCounter(TorchDispatchMode):
    """Sums each operation's operand and result bytes (a view moves none
    and is skipped), and follows the bytes the operations' new results
    hold at once (``peak``), each released when its tensor is."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peak = 0

    def _release(self, n):
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.is_view:
            return out
        ins = [t for t in pytree.tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in pytree.tree_leaves(out)
                if isinstance(t, torch.Tensor)]
        self.bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        if not func._schema.is_mutable:
            for t in outs:
                n = _nbytes(t)
                self.live += n
                weakref.finalize(t, self._release, n)
            self.peak = max(self.peak, self.live)
        return out


def load_exported(path):
    """Load a :meth:`Predictor.export` program: returns a callable taking
    numpy arrays or tensors and returning numpy outputs (a list where
    there are several), run where the program was exported (its inputs
    are moved there). It needs no model class: importing
    :mod:`paddle_tpu_torch.ops.kernels` registers the custom ops the
    program calls."""
    from .ops import kernels  # noqa: F401  (registers the custom ops)
    program = torch.export.load(path)
    vals = [n.meta.get("val") for n in program.graph.nodes
            if n.op == "placeholder"]
    dev = next((v.device for v in vals if isinstance(v, torch.Tensor)),
               torch.device("cpu"))
    module = program.module()

    def run(*inputs):
        xs = []
        for x in inputs:
            if not isinstance(x, torch.Tensor):
                x = np.asarray(x)
                if x.dtype in _CANON:
                    x = x.astype(_CANON[x.dtype])
                x = torch.from_numpy(np.ascontiguousarray(x))
            xs.append(x.to(dev))
        with torch.no_grad():
            out = module(*xs)
        if isinstance(out, (tuple, list)):
            return [to_host(o) for o in out]
        return to_host(out)

    return run


def create_predictor(config):
    """The reference's ``paddle_infer.create_predictor``: a
    :class:`Predictor` of ``config``'s saved model."""
    return Predictor(config)
