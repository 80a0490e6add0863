"""paddle_tpu_torch.io.prefetch — batches copied to the card while the step
before them runs.

Counterpart of ``paddle_tpu/io/prefetch.py``. A compiled step fed numpy
arrays pays a blocking host-to-device copy at the top of every call: the
card idles while the host copies, then the host idles while the card
computes. :func:`prefetch_to_device` overlaps the two: a background thread
moves the next ``size`` batches to the card while step *i* runs, so that
batch *i + 1* is on the card when the loop asks for it.

On the card each batch's arrays are copied with ``non_blocking=True`` on a
dedicated copy stream, from page-locked memory: from the native batcher's
slot itself where the batch is a :class:`~paddle_tpu_torch.io.native.
SlotBatch` (the slot goes back to the batcher once the copy has
completed), else from a ``pin_memory()`` copy of the array. An event is
recorded after the batch's copies; when the batch is handed over, the
consumer's current stream waits on that event and every tensor is
recorded on that stream (``record_stream``), so the caching allocator
cannot give its memory to another tensor while the step still reads it.
64-bit dtypes become 32-bit (float64, int64, uint64), as the reference's
``jax.device_put`` makes them and as ``jit``'s numpy arguments become, so
that a prefetched batch and a host batch meet one ``to_static`` key. The
producer does its CUDA work under the graphs' capture lock: no capture
runs while it copies, and none of its calls lands inside one.

On the CPU (``device="cpu"``) batches become CPU tensors (their own
copies) and no stream is used.

Monitor series (when ``paddle_tpu_torch.monitor`` is on), as the
reference's:

* ``prefetch.batches``       — batches handed to the consumer
* ``prefetch.stall_seconds`` — seconds the consumer waited on the queue;
                               near 0 means the pipeline keeps up
* ``prefetch.drops``         — batches dropped after the transient retry
                               budget ran out
* ``prefetch.queue_depth``   — a gauge the sampler publishes
                               (:mod:`paddle_tpu_torch.monitor.sampler`)

and the spans ``prefetch.produce`` (the producer thread) and
``prefetch.wait`` (the consumer).

The producer survives transient source errors: an error classified
transient is retried under a backoff budget, and when the budget is spent
the batch is dropped (counted, never silently) and the stream goes on, up
to ``max_drops`` drops; terminal errors reach the consumer at its next
``next()``. ``mesh``, ``axis_name`` and ``sharding`` need more than one
card and raise ``NotImplementedError`` (ROADMAP.md Queue A item 19).
"""
from __future__ import annotations

import queue as _queue
import threading
import time

import numpy as np
import torch

from .. import device as _device
from .. import monitor as _monitor
from ..resilience import faults as _faults
from ..resilience import retry as _retry
from ..resilience._common import record as _record
from .native import SlotBatch

_SENTINEL = object()
# what jax.device_put makes of 64-bit host arrays (x64 off)
_CANON = {torch.float64: torch.float32, torch.int64: torch.int32,
          torch.uint64: torch.uint32}


class _PrefetchError:
    def __init__(self, exc):
        self.exc = exc


def _guarded_put(q, item, stop):
    """A bounded put that the consumer's shutdown can always interrupt."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.2)
            return True
        except _queue.Full:
            continue
    return False


def _host_leaf(a):
    """A leaf as a CPU tensor over its array (or the tensor itself)."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    return torch.from_numpy(a if a.flags.c_contiguous else a.copy())


def _map(batch, fn):
    if isinstance(batch, dict):
        return {k: fn(v) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(fn(v) for v in batch)
    return fn(batch)


def _to_cpu(batch):
    """The batch as CPU tensors of its own (a slot's bytes copied out)."""
    def leaf(a):
        t = a.clone() if isinstance(a, torch.Tensor) else \
            torch.from_numpy(np.array(a))
        return t.to(_CANON.get(t.dtype, t.dtype))

    if isinstance(batch, SlotBatch):
        try:
            return tuple(leaf(a) for a in batch)
        finally:
            batch.release()
    return _map(batch, leaf)


def _to_card(batch, device, stream):
    """Copy ``batch`` to ``device`` on ``stream`` from page-locked memory;
    a slot's batch is handed back once its copies completed. Returns the
    batch on the card and the event recorded after its copies."""
    from ..graphs import _CAPTURE_LOCK

    def leaf(src):
        t = src if src.is_pinned() else src.pin_memory()
        d = t.to(device, non_blocking=True)
        return d.to(_CANON[d.dtype]) if d.dtype in _CANON else d

    with _CAPTURE_LOCK, torch.cuda.stream(stream):
        if isinstance(batch, SlotBatch):
            try:
                out = tuple(leaf(t) for t in batch.pinned)
                event = torch.cuda.Event()
                event.record(stream)
                # the slot is refilled after release: only once the copy
                # that reads it is done
                event.synchronize()
            finally:
                batch.release()
        else:
            out = _map(batch, lambda a: leaf(_host_leaf(a)))
            event = torch.cuda.Event()
            event.record(stream)
    return out, event


def _hand_over(item, device):
    """The consumer's side: its stream waits for the copies, and each
    tensor is recorded on it."""
    batch, event = item
    cur = torch.cuda.current_stream(device)
    cur.wait_event(event)

    def mark(t):
        t.record_stream(cur)
        return t
    _map(batch, mark)
    return batch


def prefetch_to_device(iterator, size=2, mesh=None, axis_name="dp",
                       sharding=None, device=None, retry=None,
                       max_drops=16):
    """Wrap a batch iterator so that the next ``size`` batches are copied
    to ``device`` (default :func:`paddle_tpu_torch.device.get_device`, the
    card) by a background thread while the current step computes.

    Batches may be arrays, tuples or lists of them, or name-to-array
    dicts; every leaf becomes a tensor on ``device``. ``retry`` (a
    ``resilience.RetryPolicy``; default 3 attempts with short backoff)
    bounds transient-error recovery per batch; past the budget the batch
    is dropped (``prefetch.drops``) and the stream goes on, up to
    ``max_drops`` drops before the error is raised as terminal. Terminal
    errors propagate at once. Raises ``RuntimeError`` when ``device``
    names the card and there is none.

    The wrapper is a generator: closing it (``break``, ``close()``,
    garbage collection) stops and joins the producer thread."""
    for name, value in (("mesh", mesh), ("sharding", sharding)):
        if value is not None:
            raise NotImplementedError(
                f"prefetch_to_device({name}=...): batches sharded over "
                f"several cards are not ported yet (ROADMAP.md Queue A "
                f"item 19)")
    dev = _device.resolve(device)
    return _prefetch(iter(iterator), size, dev, retry, max_drops)


def _prefetch(it, size, dev, retry, max_drops):
    card = dev.type == "cuda"
    stream = torch.cuda.Stream(dev) if card else None
    q = _queue.Queue(maxsize=max(1, int(size)))
    stop = threading.Event()
    policy = retry or _retry.default_policy()

    def place(batch):
        if card:
            return _to_card(batch, dev, stream)
        return _to_cpu(batch)

    def produce():
        drops = 0
        i = 0  # slot index: advances per delivered-or-dropped batch
        while not stop.is_set():
            attempts = 0
            placed = None
            delivered = False
            while True:  # per-batch transient-retry loop
                try:
                    if _faults.enabled():
                        _faults.maybe_raise("loader", step=i)
                    # the producer-thread span: its track overlapping the
                    # main thread's steps is the pipelining evidence
                    with _monitor.trace.span("prefetch.produce", batch=i):
                        batch = next(it)
                        placed = place(batch)
                    delivered = True
                    break
                except StopIteration:
                    _guarded_put(q, _SENTINEL, stop)
                    return
                except BaseException as e:
                    if not policy.is_transient(e):
                        _guarded_put(q, _PrefetchError(e), stop)
                        return
                    attempts += 1
                    if attempts >= policy.max_attempts:
                        drops += 1
                        if _monitor.enabled():
                            _monitor.counter("prefetch.drops").inc()
                        _record("drop", where="prefetch", step=i,
                                error=repr(e))
                        if drops > max_drops:
                            _guarded_put(q, _PrefetchError(RuntimeError(
                                f"prefetch: {drops} dropped batches "
                                f"(> max_drops={max_drops}); last "
                                f"transient error: {e!r}")), stop)
                            return
                        break  # drop this slot, move to the next batch
                    _record("retry", where="prefetch", step=i,
                            attempt=attempts, error=repr(e))
                    with _monitor.trace.span("resilience.backoff",
                                             where="prefetch",
                                             attempt=attempts):
                        if stop.wait(policy.delay(attempts - 1)):
                            return
            i += 1
            if delivered and not _guarded_put(q, placed, stop):
                return

    t = threading.Thread(target=produce, name="paddle_tpu_torch-prefetch",
                         daemon=True)
    t.start()
    # the live queue-depth gauge for the sampler (one dict write per
    # iterator; the provider goes with the generator)
    from ..monitor import sampler as _sampler
    provider = _sampler.register_provider(
        f"prefetch-{id(q)}", lambda: {"prefetch.queue_depth": q.qsize()})
    try:
        while True:
            t0 = time.perf_counter()
            with _monitor.trace.span("prefetch.wait"):
                item = q.get()
            if _monitor.enabled():
                _monitor.counter("prefetch.stall_seconds").inc(
                    time.perf_counter() - t0)
            if item is _SENTINEL:
                break
            if isinstance(item, _PrefetchError):
                raise item.exc
            if _monitor.enabled():
                _monitor.counter("prefetch.batches").inc()
            yield _hand_over(item, dev) if card else item
    finally:
        _sampler.unregister_provider(provider)
        stop.set()
        try:  # unblock a producer parked on a full queue
            while True:
                q.get_nowait()
        except _queue.Empty:
            pass
        t.join(timeout=5.0)
        if not t.is_alive() and hasattr(it, "close"):
            it.close()  # a native epoch's worker ends with its iterator
