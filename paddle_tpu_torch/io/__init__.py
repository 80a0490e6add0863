"""paddle_tpu_torch.io — save and load, the data loader, and shape
bucketing.

Counterpart of ``paddle_tpu/io/__init__.py``'s state-dict and
inference-model halves (``_to_numpy_tree``, ``save``, ``load``,
``save_dygraph`` / ``load_dygraph``, ``save_inference_model`` /
``load_inference_model``), of its data half (``Dataset``,
``IterableDataset``, ``TensorDataset``, ``BatchSampler``,
``default_collate_fn``, ``DataLoader``, ``batch_reader``,
``shuffle_reader``) and of its ``bucketing``, ``native`` and ``prefetch``.
A saved state dict is the reference's file: a pickle of numpy arrays,
each tensor copied to the host in its dtype (bf16 as
``ml_dtypes.bfloat16``, which is what the JAX package's bf16 arrays are),
so a file written by either package loads in the other with the same
arrays and dtypes. ``.pdmodel`` pickles the port's own layer (the
reference pickles its own): a CPU copy, so that a model saved from the
card loads on a machine without one.

The loader's host batches are numpy, as the reference's, in the same
order and with the same bits: the sampler's shuffle is the reference's
``np.random.default_rng(seed + epoch)``, and the native epoch is the
port's copy of the reference's C++ batcher (:mod:`.native`).
``DataLoader(prefetch_to_device=N)`` hands them to
:func:`~paddle_tpu_torch.io.prefetch.prefetch_to_device`, which copies
them to the card on a stream of its own; a native epoch's slots are then
page-locked and leave for the card from the slot itself.

Not ported: ``CheckpointManager`` and ``orbax_save`` / ``orbax_restore``
(ROADMAP.md Queue A item 19), and the static program's ``save_vars``
family (item 18).
"""
from __future__ import annotations

import copy
import os
import pickle
import queue as _queue
import threading
import time
import warnings

import numpy as np
import torch

from .. import monitor as _monitor
from . import bucketing
from .bucketing import (batch_mask, next_bucket, pad_to_bucket,  # noqa: F401
                        split_rows, unpad)
from .prefetch import _guarded_put, prefetch_to_device

__all__ = ["bucketing", "save", "load", "save_dygraph", "load_dygraph",
           "save_inference_model", "load_inference_model", "Dataset",
           "IterableDataset", "TensorDataset", "BatchSampler",
           "default_collate_fn", "DataLoader", "batch_reader",
           "shuffle_reader", "prefetch_to_device"]


def _to_numpy_tree(obj):
    """``obj`` with every tensor replaced by a host numpy copy of it."""
    from ..convert import to_numpy
    if isinstance(obj, torch.Tensor):
        return to_numpy(obj)
    if isinstance(obj, dict):
        return {k: _to_numpy_tree(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_numpy_tree(v) for v in obj)
    return obj


def save(obj, path, protocol=4):
    """``paddle.save``: pickle ``obj`` (a state dict, or any tree of dicts,
    lists and tensors) with its tensors as numpy arrays."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(_to_numpy_tree(obj), f, protocol=protocol)


def load(path):
    """What :func:`save` wrote (numpy arrays, as the reference returns
    them; :meth:`~paddle_tpu_torch.nn.Layer.set_state_dict` takes them)."""
    with open(path, "rb") as f:
        return pickle.load(f)


def save_dygraph(state_dict, model_path):
    """Model state to ``model_path + ".pdparams"``, optimizer state to
    ``".pdopt"``: an optimizer's dict is recognised, as the reference
    recognises it, by its slot keys (``"param@slot"``, ``"__aux__"``, a
    bare ``"lr"``)."""
    suffix = ".pdparams"
    keys = [k for k in state_dict if isinstance(k, str)]
    if keys and any("@" in k or k.startswith("__") or k == "lr"
                    for k in keys):
        suffix = ".pdopt"
    save(state_dict, model_path + suffix)


def load_dygraph(model_path):
    """``(param_dict, opt_dict)``, each None where its file is absent."""
    params = load(model_path + ".pdparams") if os.path.exists(
        model_path + ".pdparams") else None
    opt = load(model_path + ".pdopt") if os.path.exists(
        model_path + ".pdopt") else None
    return params, opt


def _cpu_copy(layer):
    """A copy of ``layer`` whose parameters and buffers live on the CPU,
    made without a second copy of them on their own device."""
    memo = {}
    for t in list(layer.parameters()) + list(layer.buffers()):
        if id(t) not in memo:
            cpu = t.detach().cpu()
            memo[id(t)] = torch.nn.Parameter(
                cpu, requires_grad=t.requires_grad) \
                if isinstance(t, torch.nn.Parameter) else cpu
    return copy.deepcopy(layer, memo)


def save_inference_model(path_prefix, layer, input_spec=None):
    """``path_prefix + ".pdmodel"``: the whole layer pickled (structure and
    weights; a CPU copy, in eval mode); ``".pdiparams"``: its state dict,
    as :func:`save` writes it. ``input_spec`` is taken and not used, as
    in the reference."""
    d = os.path.dirname(path_prefix)
    if d:
        os.makedirs(d, exist_ok=True)
    layer.eval()
    with open(path_prefix + ".pdmodel", "wb") as f:
        pickle.dump(_cpu_copy(layer), f, protocol=4)
    save(layer.state_dict(), path_prefix + ".pdiparams")


def load_inference_model(path_prefix):
    """The layer :func:`save_inference_model` wrote, on the CPU, its
    state set from ``.pdiparams``, in eval mode."""
    with open(path_prefix + ".pdmodel", "rb") as f:
        layer = pickle.load(f)
    layer.set_state_dict(load(path_prefix + ".pdiparams"))
    return layer.eval()


# ---------------------------------------------------------------------------
# Dataset / DataLoader (the reference's io/__init__.py:514-937)

class Dataset:
    """Map-style dataset."""

    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset:
    def __iter__(self):
        raise NotImplementedError


class TensorDataset(Dataset):
    """Rows of arrays (numpy, or tensors copied to the host)."""

    def __init__(self, *tensors):
        from ..convert import to_numpy
        self.arrays = [to_numpy(t) if isinstance(t, torch.Tensor)
                       else np.asarray(t) for t in tensors]

    def __getitem__(self, idx):
        return tuple(a[idx] for a in self.arrays)

    def __len__(self):
        return len(self.arrays[0])


class BatchSampler:
    """Index batches; shuffled by ``np.random.default_rng(seed + epoch)``,
    the reference's draw, so its orders are the reference's."""

    def __init__(self, dataset=None, shuffle=False, batch_size=1,
                 drop_last=False, seed=None):
        self.n = len(dataset) if dataset is not None else 0
        self.shuffle = shuffle
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.epoch = 0
        self.seed = seed

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __iter__(self):
        idx = np.arange(self.n)
        if self.shuffle:
            rng = np.random.default_rng(
                None if self.seed is None else self.seed + self.epoch)
            rng.shuffle(idx)
        self.epoch += 1
        bs = self.batch_size
        end = (self.n // bs) * bs if self.drop_last else self.n
        for i in range(0, end, bs):
            yield idx[i:i + bs].tolist()

    def __len__(self):
        if self.drop_last:
            return self.n // self.batch_size
        return (self.n + self.batch_size - 1) // self.batch_size


def default_collate_fn(batch):
    """Stack samples into numpy batches (tuple-of-fields layout)."""
    first = batch[0]
    if isinstance(first, (tuple, list)):
        return tuple(default_collate_fn([b[i] for b in batch])
                     for i in range(len(first)))
    if isinstance(first, dict):
        return {k: default_collate_fn([b[k] for b in batch]) for k in first}
    return np.stack([np.asarray(b) for b in batch])


def _mp_worker_loop(dataset, collate_fn, index_q, data_q):
    """A worker process's body: pull ``(batch_id, indices)``, push
    ``(batch_id, batch)``.

    Workers are forked (the dataset is inherited, not pickled) from a
    process that may hold torch's threads and a CUDA context: this loop
    must never touch CUDA, so a dataset or collate function run with
    ``num_workers > 0`` returns numpy (or CPU tensors), never card
    tensors."""
    # a forked child inherits the parent's numpy RNG state: reseed, or
    # every worker would draw the same augmentation streams
    np.random.seed((os.getpid() * 1000003 + int(
        time.time() * 1e6)) % (2 ** 32))
    while True:
        job = index_q.get()
        if job is None:
            break
        bid, idx = job
        try:
            data_q.put((bid, collate_fn([dataset[i] for i in idx])))
        except BaseException as e:  # surface to the consumer
            try:
                pickle.dumps(e)  # Queue.put pickles in a feeder thread,
                # where a pickling failure is silent: check it here
                data_q.put((bid, _WorkerError(e)))
            except Exception:
                import traceback
                data_q.put((bid, _WorkerError(RuntimeError(
                    "worker failed (original exception unpicklable):\n"
                    + traceback.format_exc()))))


class DataLoader:
    """Batches of a dataset, assembled off the consumer's thread.

    ``num_workers=0``: a background thread assembles batches; a
    ``TensorDataset`` with ``use_native=True`` (the default) and no
    ``collate_fn`` or ``batch_sampler`` is assembled whole by the C++
    batcher (``_native_epoch``, the path an epoch took), else rows are
    gathered by the C++ ``gather_rows`` (``_native``) or by
    ``collate_fn``. A native library that cannot be built raises; only
    ``use_native=False`` takes the Python path. ``num_workers > 0``: that
    many forked worker processes run ``dataset[i]`` and ``collate_fn``
    (order-preserving, ``num_workers * prefetch_factor`` batches ahead; a
    dead worker and a 120 s stall raise). A forked worker must not touch
    CUDA: its dataset and collate return host arrays.

    ``prefetch_to_device=N`` stages the next N batches on the device
    (:func:`paddle_tpu_torch.device.get_device`, the card unless set to
    the CPU; resolved here, so that a loader for a card raises where there
    is none) through :func:`~paddle_tpu_torch.io.prefetch.
    prefetch_to_device`; a native epoch bound for the card fills
    page-locked slots, which leave for the card with no host copy.
    ``retry`` (True: the default policy; a ``RetryPolicy``; False: none)
    retries a transient batch-assembly error. ``places``, ``return_list``
    and ``feed_list`` are taken at their defaults only; ``device_mesh``
    raises (ROADMAP.md Queue A item 19)."""

    def __init__(self, dataset, batch_size=1, shuffle=False, drop_last=False,
                 collate_fn=None, num_workers=0, prefetch_factor=2,
                 batch_sampler=None, return_list=True, feed_list=None,
                 places=None, use_native=True, seed=None,
                 prefetch_to_device=0, device_mesh=None, retry=True):
        for name, value, default, item in (
                ("places", places, None, "19"),
                ("device_mesh", device_mesh, None, "19"),
                ("feed_list", feed_list, None, "18"),
                ("return_list", return_list, True, "18")):
            if value != default:
                raise NotImplementedError(
                    f"DataLoader({name}=...) is not ported yet (ROADMAP.md "
                    f"Queue A item {item})")
        self.dataset = dataset
        if retry is True:
            from ..resilience.retry import default_policy
            self._retry_policy = default_policy()
        else:
            self._retry_policy = retry or None
        self._device_prefetch = int(prefetch_to_device or 0)
        self._device = None
        if self._device_prefetch > 0:
            from .. import device as _dev
            self._device = _dev.resolve(None)
        # stream-style datasets: no sampler or length; batches are cut
        # from the iterator in order
        self._iterable = isinstance(dataset, IterableDataset)
        self._native = None
        self._native_epoch = None
        self.collate_fn = collate_fn or default_collate_fn
        self.prefetch = max(1, prefetch_factor)
        if self._iterable:
            if batch_sampler is not None:
                raise ValueError(
                    "batch_sampler is incompatible with IterableDataset")
            if shuffle:
                raise ValueError(
                    "shuffle=True is incompatible with IterableDataset "
                    "(the stream defines its own order; shuffle inside "
                    "the dataset, e.g. via reader.shuffle)")
            if num_workers > 0:
                warnings.warn(
                    "num_workers is ignored for IterableDataset (process "
                    "workers would need per-worker stream sharding); "
                    "running single-stream with threaded prefetch")
            self._batch_size = batch_size
            self._drop_last = drop_last
            self.batch_sampler = None
            self.num_workers = 0
            return
        self.batch_sampler = batch_sampler or BatchSampler(
            dataset, shuffle=shuffle, batch_size=batch_size,
            drop_last=drop_last, seed=seed)
        self.num_workers = num_workers
        if use_native and isinstance(dataset, TensorDataset):
            from .native import NativeBatcher
            self._native = NativeBatcher(dataset.arrays)
            if collate_fn is None and batch_sampler is None:
                # the whole epoch in C++: shuffle and assembly
                self._native_epoch = NativeBatcher(
                    dataset.arrays, batch_size=batch_size, shuffle=shuffle,
                    drop_last=drop_last, seed=seed or 0,
                    pin_memory=self._to_card)

    @property
    def _to_card(self):
        return self._device is not None and self._device.type == "cuda"

    def __len__(self):
        if self._iterable:
            raise TypeError("IterableDataset loader has no length")
        return len(self.batch_sampler)

    def _iter_stream(self):
        buf = []
        for item in self.dataset:
            buf.append(item)
            if len(buf) == self._batch_size:
                yield self.collate_fn(buf)
                buf = []
        if buf and not self._drop_last:
            yield self.collate_fn(buf)

    def _assemble(self, idx, batch_index):
        """One batch, with the ``loader`` fault site and transient-error
        retry: an I/O hiccup in ``dataset[i]`` retries under the backoff
        budget; a spent budget and terminal errors propagate."""
        from ..resilience import faults as _faults
        from ..resilience import retry as _retry

        def attempt():
            if _faults.enabled():
                _faults.maybe_raise("loader", step=batch_index)
            if self._native is not None:
                return self._native.gather(idx)
            return self.collate_fn([self.dataset[i] for i in idx])

        with _monitor.trace.span("dataloader.assemble", batch=batch_index):
            if self._retry_policy is None:
                return attempt()
            return _retry.retry_call(attempt, policy=self._retry_policy,
                                     label="dataloader")

    def _produce(self, q, stop):
        try:
            for bi, idx in enumerate(self.batch_sampler):
                item = self._assemble(idx, bi)
                if not _guarded_put(q, item, stop):
                    return
            _guarded_put(q, _SENTINEL, stop)
        except BaseException as e:  # surface worker errors to the consumer
            _guarded_put(q, _WorkerError(e), stop)

    def _produce_stream(self, q, stop):
        try:
            for batch in self._iter_stream():
                if not _guarded_put(q, batch, stop):
                    return
            _guarded_put(q, _SENTINEL, stop)
        except BaseException as e:  # surface generator errors
            _guarded_put(q, _WorkerError(e), stop)

    def __iter__(self):
        if self._device_prefetch <= 0:
            return self._iter_host()
        return prefetch_to_device(self._iter_host(slots=self._to_card),
                                  size=self._device_prefetch,
                                  device=self._device)

    def _iter_host(self, slots=False):
        """Host batches; ``slots``: a native epoch's batches as views of
        its page-locked slots (``native.SlotBatch``), for the card."""
        if self._iterable:
            if self.prefetch <= 1:
                yield from self._iter_stream()
                return
            producer = self._produce_stream
        else:
            if self.num_workers > 0 and self._native_epoch is None:
                yield from self._iter_multiprocess()
                return
            from ..resilience import faults as _faults
            if self._native_epoch is not None and not _faults.enabled():
                # the all-in-memory C++ batcher has no I/O to fail; with
                # faults registered, take the _assemble path so that a
                # chaos run exercises injection and retry end to end
                yield from (self._native_epoch.slots() if slots
                            else self._native_epoch)
                return
            if self.num_workers == 0 and self.prefetch <= 1:
                for bi, idx in enumerate(self.batch_sampler):
                    yield self._assemble(idx, bi)
                return
            producer = self._produce
        q = _queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        t = threading.Thread(target=producer, args=(q, stop), daemon=True,
                             name="paddle_tpu_torch-loader")
        t.start()
        try:
            while True:
                item = q.get()
                if item is _SENTINEL:
                    break
                if isinstance(item, _WorkerError):
                    raise item.exc
                yield item
        finally:
            stop.set()
            try:  # drain so that a producer parked on put() sees the stop
                while True:
                    q.get_nowait()
            except _queue.Empty:
                pass
            t.join(timeout=5.0)

    def _iter_multiprocess(self):
        """Order-preserving multiprocess iteration: forked workers inherit
        the dataset without pickling; index batches go out
        ``num_workers * prefetch`` ahead and results are put back in
        order by batch id."""
        import multiprocessing as mp
        ctx = mp.get_context("fork")
        index_q = ctx.Queue()
        data_q = ctx.Queue()
        workers = [
            ctx.Process(target=_mp_worker_loop,
                        args=(self.dataset, self.collate_fn, index_q,
                              data_q), daemon=True)
            for _ in range(self.num_workers)
        ]
        for w in workers:
            w.start()
        batches = list(self.batch_sampler)
        ahead = max(1, self.num_workers * self.prefetch)
        sent = 0
        pending = {}
        try:
            while sent < min(ahead, len(batches)):
                index_q.put((sent, batches[sent]))
                sent += 1
            stall_limit = 120.0  # seconds without any batch arriving
            for want in range(len(batches)):
                waited = 0.0
                while want not in pending:
                    try:
                        bid, item = data_q.get(timeout=5.0)
                    except _queue.Empty:
                        dead = [w for w in workers
                                if not w.is_alive() and w.exitcode]
                        if dead:
                            raise RuntimeError(
                                f"DataLoader worker died (exitcode "
                                f"{dead[0].exitcode}) — batch {want} "
                                "will never arrive")
                        waited += 5.0
                        if waited >= stall_limit:
                            raise RuntimeError(
                                f"DataLoader stalled {stall_limit:.0f}s "
                                f"waiting for batch {want}: a worker's "
                                "batch likely failed to pickle (batches "
                                "must be host arrays, not card tensors) "
                                "or a transform is hung")
                        continue
                    waited = 0.0
                    if isinstance(item, _WorkerError):
                        raise item.exc
                    pending[bid] = item
                if sent < len(batches):
                    index_q.put((sent, batches[sent]))
                    sent += 1
                yield pending.pop(want)
        finally:
            for _ in workers:
                try:
                    index_q.put_nowait(None)
                except Exception:
                    pass
            for w in workers:
                w.join(timeout=1.0)
                if w.is_alive():
                    w.terminate()
                    w.join(timeout=5.0)


_SENTINEL = object()


class _WorkerError:
    def __init__(self, exc):
        self.exc = exc


# fluid-era reader decorators (the reference's batch_reader and
# shuffle_reader)
def batch_reader(reader, batch_size, drop_last=False):
    def _reader():
        batch = []
        for item in reader():
            batch.append(item)
            if len(batch) == batch_size:
                yield default_collate_fn(batch)
                batch = []
        if batch and not drop_last:
            yield default_collate_fn(batch)
    return _reader


def shuffle_reader(reader, buf_size, seed=None):
    def _reader():
        rng = np.random.default_rng(seed)
        buf = []
        for item in reader():
            buf.append(item)
            if len(buf) >= buf_size:
                rng.shuffle(buf)
                yield from buf
                buf = []
        rng.shuffle(buf)
        yield from buf
    return _reader
