"""paddle_tpu_torch.graphs — the compiled entries behind ``jit.to_static``
and ``inference.Predictor``: one CUDA graph per input signature.

The JAX package compiles a step or a forward into one XLA executable per
input signature. The port's counterpart is a :class:`GraphEntry`: static
input buffers, the step captured once into a ``torch.cuda.CUDAGraph``
over them, and the static outputs it writes. A call copies its inputs
into the static buffers, replays the graph and returns clones of the
static outputs, so a returned tensor is never overwritten by a later
call. The capture records every launch of the step (the port's kernels
#1-#14 among them, through their pointers) and replays them with no
Python, no allocation and no launch cost between them.

On a CPU tensor, which is the caller asking for the CPU, the same entry
re-runs the function over its static buffers in place of a replay: the
copy-in, copy-out and keying discipline is the card's, so the CPU tests
hold it against the reference.

What capture demands of the step, and what this module does about it:

* Storage stays put. A graph reads and writes the addresses it saw, so
  the optimizers update their state in place (``optimizer/``), and the
  first call of a key runs the step eagerly before capture: it builds the
  kernels, creates lazy state and sets up cuBLAS off the capture.
* Random draws advance. The card's generator of the port
  (:func:`paddle_tpu_torch.random.generator`) is registered with each
  capture (``register_generator_state``), so dropout and the flash
  kernels' seed words are drawn afresh at every replay.
* Host state is not double counted. The capture's Python run counts
  kernel launches that the card does not run: the entry takes them back
  (:func:`paddle_tpu_torch.ops.kernels.add_launches`) and adds them at
  each replay. Callers undo their own host counters the same way.
* No fallback. A step that cannot be captured (a sync, ``.item()``, a
  copy from pageable host memory) raises :class:`CaptureError`, naming
  the line of the step where capture broke.

One capture runs at a time in the process (PyTorch's rule for graphs),
under :data:`_CAPTURE_LOCK`; with ``capture_error_mode="thread_local"``
other threads keep launching and replaying meanwhile. The cyclic garbage
collector is held off during a capture: run in the capturing thread, it
could free an object that holds another graph (an engine no longer
used), whose executable's destruction CUDA refuses while the stream
captures, and the capture would fail.
"""
from __future__ import annotations

import contextlib
import gc
import os
import threading
import traceback

import torch
from torch.utils import _pytree as pytree

from . import random as prandom
from .ops import kernels

_CAPTURE_LOCK = threading.Lock()
_TORCH_DIR = os.path.dirname(torch.__file__)


class CaptureError(RuntimeError):
    """A step or forward that a CUDA graph cannot capture."""


def _culprit(exc):
    """The innermost frame outside PyTorch of ``exc`` (or of the error it
    was raised from), as ``file:line: source``: the operation that broke
    the capture."""
    seen = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        frames = [f for f in traceback.extract_tb(exc.__traceback__)
                  if not f.filename.startswith(_TORCH_DIR)
                  and f.filename != __file__]
        if frames:
            f = frames[-1]
            return f"{f.filename}:{f.lineno}: {f.line}"
        exc = exc.__context__ or exc.__cause__
    return "an unknown operation"


@contextlib.contextmanager
def _collector_off():
    """The cyclic garbage collector disabled for the block (as it was
    after)."""
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()


def _resolve(device):
    """``device`` with a CUDA card's index filled in."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def static_like(t):
    """A contiguous buffer of ``t``'s shape, dtype and device."""
    return torch.empty(t.shape, dtype=t.dtype, device=t.device)


def pool_bytes(pool):
    """The bytes the caching allocator holds for the graph pool ``pool``
    (a ``torch.cuda.graph_pool_handle()``): the segments of its memory
    snapshot that belong to that pool, whatever the other pools hold or
    have freed. None without a pool (on the CPU)."""
    if pool is None:
        return None
    want = tuple(pool)
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == want)


def eager_on_side_stream(fn, args, stream):
    """``fn(*args)`` on ``stream``, a side stream that waits for the
    current one and is waited for by it; the result's tensors are recorded
    on the current stream, which reads them next (so the allocator never
    hands their memory to ``stream`` while the current stream reads
    them)."""
    cur = torch.cuda.current_stream(stream.device)
    stream.wait_stream(cur)
    with torch.cuda.stream(stream):
        out = fn(*args)
    cur.wait_stream(stream)
    for t in pytree.tree_leaves(out):
        if isinstance(t, torch.Tensor) and t.device.type == "cuda":
            t.record_stream(cur)
    return out


class GraphEntry:
    """One compiled executable: ``fn`` over static input buffers.

    ``fn(*inputs)`` returns a flat list of leaves (tensors, or values that
    are not tensors and are frozen at capture). ``example`` gives each
    input's shape and dtype; every input lives on ``device``, whose kind
    says whether the entry is a graph (``cuda``) or a re-run (``cpu``).
    :meth:`capture` records ``fn`` into a graph (on the card) or does
    nothing (on the CPU); :meth:`replay` copies a call's inputs in,
    replays or re-runs, and returns the leaves, tensors cloned. ``lock``
    serialises copy-in, replay and copy-out: the static buffers are shared
    by every call (entries that share a graph pool share a lock too).
    """

    def __init__(self, fn, example, device, label="", lock=None):
        self.fn = fn
        self.label = label
        self.device = _resolve(device)
        if any(_resolve(t.device) != self.device for t in example):
            raise ValueError(f"{label or 'step'}: every input must live on "
                             f"{self.device}, got "
                             f"{sorted({str(t.device) for t in example})}")
        self.inputs = [static_like(t) for t in example]
        self.card = self.device.type == "cuda"
        self.outputs = None
        self.graph = None
        self.launches = {}
        self.routes = {}
        self.lock = lock if lock is not None else threading.Lock()
        self.replays = 0

    def capture(self, pool=None, stream=None, mode="global"):
        """Record ``fn`` over the static inputs (their values are the
        caller's to set). On the card: one ``CUDAGraph`` in ``pool``,
        captured on ``stream``, with the card's generator registered; the
        launches the capture counted are taken back and kept for the
        replays. Raises :class:`CaptureError` naming the operation that
        broke the capture."""
        if not self.card:
            return self
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(prandom.generator(self.device))
        before = dict(kernels.launches)
        before_routes = dict(kernels.route_launches)
        try:
            with _CAPTURE_LOCK, _collector_off():
                with torch.cuda.graph(graph, pool=pool, stream=stream,
                                      capture_error_mode=mode):
                    outputs = self.fn(*self.inputs)
        except Exception as exc:  # noqa: BLE001 - re-raised, named
            raise CaptureError(
                f"{self.label or 'step'}: a CUDA graph cannot capture it "
                f"({type(exc).__name__}: {exc}); the operation that broke "
                f"the capture: {_culprit(exc)}") from exc
        finally:
            self.launches = {k: n - before[k]
                             for k, n in kernels.launches.items()
                             if n != before[k]}
            self.routes = {k: n - before_routes.get(k, 0)
                           for k, n in kernels.route_launches.items()
                           if n != before_routes.get(k, 0)}
            kernels.add_launches(self.launches, -1, self.routes)
        self.graph, self.outputs = graph, outputs
        return self

    def replay(self, args, clone=True):
        """Copy ``args`` into the static inputs, replay (on the card) or
        re-run ``fn`` (on the CPU), and return the output leaves with
        every tensor cloned. ``clone=False`` returns the static outputs
        themselves, for a caller that is the entry's only user and reads
        them (or queues their copies) before the next replay of any entry
        in the graph pool: another graph of the pool may use their memory
        as scratch."""
        with self.lock:
            with torch.no_grad():
                for buf, a in zip(self.inputs, args):
                    buf.copy_(a, non_blocking=True)
            if self.card:
                self.graph.replay()
                kernels.add_launches(self.launches, routes=self.routes)
            else:
                self.outputs = self.fn(*self.inputs)
            self.replays += 1
            if not clone:
                return list(self.outputs)
            return [o.detach().clone() if isinstance(o, torch.Tensor)
                    else o for o in self.outputs]


__all__ = ["GraphEntry", "CaptureError", "static_like",
           "eager_on_side_stream"]
