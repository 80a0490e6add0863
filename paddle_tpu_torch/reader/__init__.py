"""paddle_tpu_torch.reader — the composable reader decorators.

Counterpart of ``paddle_tpu/reader/__init__.py`` (the fluid reader
decorators: ``cache``, ``map_readers``, ``shuffle``, ``chain``,
``compose`` / ``ComposeNotAligned``, ``buffered``, ``firstn``,
``xmap_readers``, ``multiprocess_reader`` and ``batch``), the same code
and the same samples in the same order.

A *reader creator* is a zero-argument callable returning a generator of
samples; a decorator wraps creators into a new creator. Host-side Python,
with threads for the buffered and parallel stages (as in the reference,
``xmap_readers`` and ``multiprocess_reader`` run threads, not processes:
numpy work releases the GIL, and a forked process must not touch the
card). The heavy lifting of a training feed is the C++ batcher
(:mod:`paddle_tpu_torch.io.native`).
"""
from __future__ import annotations

import itertools
import queue
import random as _pyrandom
import threading

# a bounded put that the consumer's shutdown interrupts: a thread of an
# abandoned reader must not park forever on a full queue
from ..io.prefetch import _guarded_put as _put

__all__ = ["cache", "map_readers", "shuffle", "chain", "compose",
           "ComposeNotAligned", "buffered", "firstn", "xmap_readers", "multiprocess_reader",
           "batch"]


def cache(reader):
    """Cache the first COMPLETE pass in memory; later passes replay it.
    A partially-consumed pass (early break) is discarded, not cached."""
    cached = []
    done = [False]

    def creator():
        if done[0]:
            yield from cached
            return
        this_pass = []
        for item in reader():
            this_pass.append(item)
            yield item
        cached[:] = this_pass  # only a finished pass becomes the cache
        done[0] = True

    return creator


def map_readers(func, *readers):
    """Zip several readers and map func over the tuples."""
    def creator():
        its = [r() for r in readers]
        for items in zip(*its):
            yield func(*items)

    return creator


def shuffle(reader, buf_size):
    """Pool-based shuffle with a bounded buffer."""
    def creator():
        buf = []
        for item in reader():
            buf.append(item)
            if len(buf) >= buf_size:
                _pyrandom.shuffle(buf)
                yield from buf
                buf = []
        if buf:
            _pyrandom.shuffle(buf)
            yield from buf

    return creator


def chain(*readers):
    """Concatenate readers end to end."""
    def creator():
        for r in readers:
            yield from r()

    return creator


class ComposeNotAligned(ValueError):
    """reference reader/decorator.py:ComposeNotAligned — raised when
    composed readers have different lengths."""


def compose(*readers, **kwargs):
    """Zip readers into flat tuples: (a, b), (c) -> (a, b, c).
    check_alignment=True raises ComposeNotAligned if lengths differ."""
    check_alignment = kwargs.pop("check_alignment", True)

    def _flatten(item):
        if isinstance(item, tuple):
            return item
        return (item,)

    def creator():
        its = [r() for r in readers]
        if check_alignment:
            for items in itertools.zip_longest(*its):
                if any(i is None for i in items):
                    raise ComposeNotAligned(
                        "compose: readers have different lengths")
                yield sum((_flatten(i) for i in items), ())
        else:
            for items in zip(*its):
                yield sum((_flatten(i) for i in items), ())

    return creator


def _get(q, stop):
    """A get that the consumer's shutdown interrupts (``_STOPPED``)."""
    while not stop.is_set():
        try:
            return q.get(timeout=0.1)
        except queue.Empty:
            continue
    return _STOPPED


_STOPPED = object()


def _shutdown(stop, threads):
    """Stop an iterator's threads and join them (bounded)."""
    stop.set()
    for t in threads:
        t.join(timeout=5.0)


def buffered(reader, size):
    """A producer thread fills a bounded queue that the consumer drains:
    host preprocessing overlaps the device's steps. Closing the consumer
    stops and joins the thread."""
    _end = object()

    def creator():
        q = queue.Queue(maxsize=size)
        stop = threading.Event()

        def produce():
            try:
                for item in reader():
                    if not _put(q, item, stop):
                        return
            finally:
                _put(q, _end, stop)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is _end:
                    break
                yield item
        finally:
            _shutdown(stop, [t])

    return creator


def firstn(reader, n):
    """Limit to the first n samples."""
    def creator():
        for i, item in enumerate(reader()):
            if i >= n:
                break
            yield item

    return creator


def xmap_readers(mapper, reader, process_num, buffer_size, order=False):
    """Parallel map over ``process_num`` threads (numpy preprocessing
    releases the GIL, and threads never fork a process that holds the
    card); ``order=True`` keeps the reader's order. Closing the consumer
    stops and joins the threads."""
    _end = object()

    class _Raised:
        def __init__(self, exc):
            self.exc = exc

    def creator():
        in_q = queue.Queue(buffer_size)
        out_q = queue.Queue(buffer_size)
        stop = threading.Event()

        def feed():
            # the sentinels go out whatever happens, so that a raising
            # reader cannot deadlock the consumer; the error is forwarded
            try:
                for i, item in enumerate(reader()):
                    if not _put(in_q, (i, item), stop):
                        return
            except Exception as e:  # noqa: BLE001
                _put(out_q, _Raised(e), stop)
            finally:
                for _ in range(process_num):
                    _put(in_q, _end, stop)

        def work():
            try:
                while True:
                    got = _get(in_q, stop)
                    if got is _end or got is _STOPPED:
                        break
                    i, item = got
                    if not _put(out_q, (i, mapper(item)), stop):
                        break
            except Exception as e:  # noqa: BLE001
                _put(out_q, _Raised(e), stop)
            finally:
                _put(out_q, _end, stop)

        threads = [threading.Thread(target=feed, daemon=True)] + [
            threading.Thread(target=work, daemon=True)
            for _ in range(process_num)]
        for t in threads:
            t.start()
        try:
            finished = 0
            if not order:
                while finished < process_num:
                    got = out_q.get()
                    if got is _end:
                        finished += 1
                        continue
                    if isinstance(got, _Raised):
                        raise got.exc
                    yield got[1]
            else:
                pending = {}
                nxt = 0
                while finished < process_num or pending:
                    if nxt in pending:
                        yield pending.pop(nxt)
                        nxt += 1
                        continue
                    if finished == process_num:
                        break  # workers gone but a hole remains
                    got = out_q.get()
                    if got is _end:
                        finished += 1
                        continue
                    if isinstance(got, _Raised):
                        raise got.exc
                    i, item = got
                    if i == nxt:
                        yield item
                        nxt += 1
                    else:
                        pending[i] = item
        finally:
            _shutdown(stop, threads)

    return creator


def multiprocess_reader(readers, use_pipe=True, queue_size=1000):
    """Run several readers at once, interleaving their output (threads;
    see :func:`xmap_readers`). Closing the consumer stops and joins
    them."""
    _end = object()

    def creator():
        q = queue.Queue(queue_size)
        stop = threading.Event()

        def run(r):
            try:
                for item in r():
                    if not _put(q, item, stop):
                        return
            finally:
                _put(q, _end, stop)

        threads = [threading.Thread(target=run, args=(r,), daemon=True)
                   for r in readers]
        for t in threads:
            t.start()
        try:
            finished = 0
            while finished < len(readers):
                item = q.get()
                if item is _end:
                    finished += 1
                    continue
                yield item
        finally:
            _shutdown(stop, threads)

    return creator


def batch(reader, batch_size, drop_last=False):
    """Group samples into lists of batch_size (fluid.io.batch /
    paddle.batch parity)."""
    def creator():
        buf = []
        for item in reader():
            buf.append(item)
            if len(buf) == batch_size:
                yield buf
                buf = []
        if buf and not drop_last:
            yield buf

    return creator
