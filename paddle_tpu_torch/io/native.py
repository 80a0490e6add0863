"""paddle_tpu_torch.io.native — ctypes bindings to the host runtime core.

Counterpart of ``paddle_tpu/io/native.py`` over the port's own copy of
the C++ core, ``paddle_tpu_torch/csrc/core.cpp`` (see that file for the
design): :func:`get_lib`, :class:`Arena`, :func:`gather_rows`,
:class:`NativeBatcher` and :func:`multislot_parse`, with the reference's
signatures and outputs.

The library is built with ``g++`` at its first use into
``paddle_tpu_torch/_build/`` (never into the source tree), named after a
hash of the source and the flags, under the kernels' build lock and a file
lock that other processes (test workers) share, and moved into place by
an atomic rename. A library that cannot be built or loaded raises with the
compiler's output: there is no quiet fallback to the Python path (a
``DataLoader`` takes that path only when asked, ``use_native=False``).

On the way to a CUDA card the batcher's slots are page-locked buffers that
Python owns (``NativeBatcher(..., pin_memory=True)``):
:meth:`NativeBatcher.slots` yields each batch as a :class:`SlotBatch`,
views of the slot with no host copy, and the consumer hands the slot back
(:meth:`SlotBatch.release`) once the copy that reads it has completed
(``io.prefetch``). Iterating the batcher itself copies every batch out of
its slot before the slot goes back, as the reference does.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess

import numpy as np

from ..ops import kernels as _kernels

SOURCE = _kernels.CSRC / "core.cpp"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared")
_lib = None


def library_path():
    """Where the core's library is (or will be) built."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return _kernels.BUILD_DIR / f"core-{h.hexdigest()[:16]}.so"


def _build(so):
    """Compile the core into ``so`` unless another process did."""
    _kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(_kernels.BUILD_DIR / "core.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if so.exists():
            return
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp")
        cxx = os.environ.get("CXX") or "g++"
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"{cxx} failed for {SOURCE.name}:\n"
                               f"{proc.stdout}")
        os.replace(tmp, so)  # atomic: a reader sees all or none


def get_lib():
    """The core's library, built at first use and then loaded once a
    process; raises ``RuntimeError`` with the compiler's output where it
    cannot be built, ``OSError`` where it cannot be loaded."""
    global _lib
    if _lib is not None:
        return _lib
    with _kernels._lock:
        if _lib is not None:
            return _lib
        so = library_path()
        if not so.exists():
            _build(so)
        lib = ctypes.CDLL(str(so))
        c = ctypes
        lib.ptc_arena_create.restype = c.c_void_p
        lib.ptc_arena_create.argtypes = [c.c_size_t]
        lib.ptc_arena_destroy.argtypes = [c.c_void_p]
        lib.ptc_arena_alloc.restype = c.c_void_p
        lib.ptc_arena_alloc.argtypes = [c.c_void_p, c.c_size_t, c.c_size_t]
        lib.ptc_arena_reset.argtypes = [c.c_void_p]
        for name in ("ptc_arena_used", "ptc_arena_peak"):
            getattr(lib, name).restype = c.c_size_t
            getattr(lib, name).argtypes = [c.c_void_p]
        lib.ptc_gather_rows.argtypes = [
            c.c_void_p, c.c_size_t, c.POINTER(c.c_int64), c.c_size_t,
            c.c_void_p, c.c_int]
        lib.ptc_batcher_create.restype = c.c_void_p
        lib.ptc_batcher_create.argtypes = [
            c.POINTER(c.c_void_p), c.POINTER(c.c_size_t), c.c_int,
            c.c_size_t, c.c_size_t, c.c_int, c.c_int, c.c_uint64, c.c_int,
            c.POINTER(c.c_void_p)]
        lib.ptc_batcher_next.restype = c.c_int
        lib.ptc_batcher_next.argtypes = [c.c_void_p, c.POINTER(c.c_void_p),
                                         c.POINTER(c.c_size_t)]
        lib.ptc_batcher_release.argtypes = [c.c_void_p, c.c_int]
        lib.ptc_batcher_running.restype = c.c_int
        for name in ("ptc_batcher_start", "ptc_batcher_running",
                     "ptc_batcher_new_epoch", "ptc_batcher_stop",
                     "ptc_batcher_destroy"):
            getattr(lib, name).argtypes = [c.c_void_p]
        lib.ptc_multislot_parse.restype = c.c_longlong
        lib.ptc_multislot_parse.argtypes = [
            c.c_char_p, c.c_size_t, c.c_int, c.POINTER(c.c_int),
            c.POINTER(c.c_double), c.POINTER(c.c_longlong), c.c_longlong,
            c.c_longlong, c.POINTER(c.c_longlong)]
        _lib = lib
    return lib


def multislot_parse(text, n_slots, slot_is_int):
    """Parse MultiSlot text in C: ``(counts [n_rec, n_slots] int64,
    values_lanes [n_vals])``. Float slots' lanes are doubles; int slots'
    lanes are int64 bit patterns (exact full-range ids). Raises
    ``ValueError`` on malformed input."""
    lib = get_lib()
    if isinstance(text, str):
        text = text.encode()
    # every value and count token is at least one character and a
    # separator, and a record carries at least n_slots count tokens
    max_vals = len(text) // 2 + 2
    max_recs = len(text) // (2 * max(n_slots, 1)) + 2
    vals = np.empty((max_vals,), np.float64)
    counts = np.empty((max_recs * n_slots,), np.int64)
    flags = (ctypes.c_int * n_slots)(*[int(b) for b in slot_is_int])
    n_vals = ctypes.c_longlong(0)
    rec = lib.ptc_multislot_parse(
        text, len(text), n_slots, flags,
        vals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        max_vals, max_recs, ctypes.byref(n_vals))
    if rec < 0:
        raise ValueError("malformed MultiSlot text (native parser)")
    return (counts[:rec * n_slots].reshape(rec, n_slots).copy(),
            vals[:n_vals.value].copy())


class Arena:
    """Host staging arena: a bump allocator with reset."""

    def __init__(self, capacity_bytes):
        self._lib = get_lib()
        self._handle = self._lib.ptc_arena_create(capacity_bytes)
        if not self._handle:
            raise MemoryError("arena allocation failed")
        self.capacity = capacity_bytes

    def alloc_array(self, shape, dtype, align=64):
        """A numpy view into the arena (no per-step malloc)."""
        dtype = np.dtype(dtype)
        nbytes = int(np.prod(shape)) * dtype.itemsize
        ptr = self._lib.ptc_arena_alloc(self._handle, nbytes, align)
        if not ptr:
            raise MemoryError(
                f"arena exhausted: {self.used}B used of {self.capacity}B")
        buf = (ctypes.c_char * nbytes).from_address(ptr)
        return np.frombuffer(buf, dtype=dtype).reshape(shape)

    @property
    def used(self):
        return self._lib.ptc_arena_used(self._handle)

    @property
    def peak(self):
        return self._lib.ptc_arena_peak(self._handle)

    def reset(self):
        self._lib.ptc_arena_reset(self._handle)

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.ptc_arena_destroy(self._handle)
            self._handle = None


def gather_rows(src, idx, out=None, n_threads=4):
    """Multithreaded ``dst[i] = src[idx[i]]`` for a C-contiguous table."""
    lib = get_lib()
    src = np.ascontiguousarray(src)
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    row_bytes = src.dtype.itemsize * int(np.prod(src.shape[1:]))
    if out is None:
        out = np.empty((len(idx),) + src.shape[1:], src.dtype)
    lib.ptc_gather_rows(
        src.ctypes.data_as(ctypes.c_void_p), row_bytes,
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(idx),
        out.ctypes.data_as(ctypes.c_void_p), n_threads)
    return out


class SlotBatch(tuple):
    """One batch as views of a batcher's slot: a tuple of numpy arrays
    (one per feature array) that stay valid until :meth:`release`.
    ``pinned`` holds the same bytes as CPU tensors in page-locked memory
    (the source of a copy to the card); ``release()`` hands the slot back
    to the batcher, once, and only after every copy reading it is done."""

    def __new__(cls, arrays, pinned, release):
        self = super().__new__(cls, arrays)
        self.pinned = pinned
        self._release = release
        return self

    def release(self):
        fn, self._release = self._release, None
        if fn is not None:
            fn()


class NativeBatcher:
    """Background-thread shuffling batcher over contiguous feature arrays.

    ``pin_memory=True`` (needs a CUDA card) makes every slot a page-locked
    buffer owned here, for :meth:`slots`; otherwise the C++ side allocates
    plain slots. ``running`` says whether the epoch's C++ worker is alive:
    it starts with an iteration and ends with it, also at a ``break``.
    ``batches`` counts the batches it has handed out."""

    def __init__(self, arrays, batch_size=None, shuffle=False,
                 drop_last=False, seed=0, prefetch_slots=3,
                 pin_memory=False):
        self._lib = get_lib()
        self.arrays = [np.ascontiguousarray(a) for a in arrays]
        self.n_rows = len(self.arrays[0])
        self.row_bytes = [a.dtype.itemsize * int(np.prod(a.shape[1:]))
                          for a in self.arrays]
        self.batch_size = batch_size
        self.pin_memory = bool(pin_memory)
        self._handle = None
        self._pinned = None
        self._mid_epoch = False
        self.batches = 0
        self._cfg = (shuffle, drop_last, seed, max(2, int(prefetch_slots)))
        if batch_size is not None:
            self._start()

    def _start(self):
        shuffle, drop_last, seed, slots = self._cfg
        n = len(self.arrays)
        ptrs = (ctypes.c_void_p * n)(
            *[a.ctypes.data_as(ctypes.c_void_p).value for a in self.arrays])
        rbs = (ctypes.c_size_t * n)(*self.row_bytes)
        bufs = None
        if self.pin_memory:
            if self._pinned is None:
                import torch
                self._pinned = [
                    [torch.empty(max(1, self.batch_size * rb),
                                 dtype=torch.uint8, pin_memory=True)
                     for rb in self.row_bytes] for _ in range(slots)]
            bufs = (ctypes.c_void_p * (slots * n))(
                *[t.data_ptr() for slot in self._pinned for t in slot])
        self._gen = getattr(self, "_gen", 0) + 1
        self._handle = self._lib.ptc_batcher_create(
            ptrs, rbs, n, self.n_rows, self.batch_size,
            1 if shuffle else 0, 1 if drop_last else 0, seed, slots, bufs)
        if not self._handle:
            raise MemoryError("batcher allocation failed")

    @property
    def running(self):
        return bool(self._handle) and bool(
            self._lib.ptc_batcher_running(self._handle))

    def gather(self, idx):
        """Index-batch fast path used by DataLoader samplers."""
        return tuple(gather_rows(a, idx) for a in self.arrays)

    def _begin(self):
        if self._handle is None and self.batch_size is None:
            raise RuntimeError("NativeBatcher built without batch_size")
        # an epoch abandoned mid-way (a `break` in the consumer) stopped
        # its worker: rebuild the C++ batcher for a clean epoch on the
        # next seed, as the reference does
        if self._mid_epoch:
            self._close()
            self._cfg = (self._cfg[0], self._cfg[1], self._cfg[2] + 1,
                         self._cfg[3])
            self._start()
        self._mid_epoch = True
        self._lib.ptc_batcher_start(self._handle)

    def _close(self):
        if self._handle:
            self._lib.ptc_batcher_destroy(self._handle)
            self._handle = None

    def _epoch(self):
        """``(slot, rows, [pointer per array])`` for each batch of one
        epoch; the caller releases each slot."""
        n = len(self.arrays)
        out_ptrs = (ctypes.c_void_p * n)()
        rows = ctypes.c_size_t()
        try:
            while True:
                slot = self._lib.ptc_batcher_next(self._handle, out_ptrs,
                                                  ctypes.byref(rows))
                if slot < 0:
                    if slot == -1:
                        self._lib.ptc_batcher_new_epoch(self._handle)
                        self._mid_epoch = False
                    return
                self.batches += 1
                yield slot, rows.value, list(out_ptrs)
        finally:
            if self._mid_epoch and self._handle:
                # abandoned: end the worker now, not at the next epoch
                self._lib.ptc_batcher_stop(self._handle)

    def _views(self, rows, ptrs):
        out = []
        for i, a in enumerate(self.arrays):
            nbytes = self.row_bytes[i] * rows
            buf = (ctypes.c_char * nbytes).from_address(ptrs[i])
            out.append(np.frombuffer(buf, dtype=a.dtype)
                       .reshape((rows,) + a.shape[1:]))
        return out

    def __iter__(self):
        self._begin()
        for slot, rows, ptrs in self._epoch():
            # copy out: the slot is refilled after release
            batch = tuple(v.copy() for v in self._views(rows, ptrs))
            self._lib.ptc_batcher_release(self._handle, slot)
            yield batch

    def slots(self):
        """One epoch as :class:`SlotBatch` es over the slots themselves
        (no host copy); each must be released before the batcher can
        refill its slot."""
        import torch
        self._begin()
        handle, gen = self._handle, self._gen

        def release(slot):
            # a slot of a batcher since rebuilt or destroyed has no owner
            if self._gen == gen and self._handle:
                self._lib.ptc_batcher_release(handle, slot)

        for slot, rows, ptrs in self._epoch():
            views = self._views(rows, ptrs)
            pinned = None
            if self._pinned is not None:
                pinned = [
                    t[:rows * rb].view(torch.from_numpy(v[:0]).dtype)
                    .view(v.shape)
                    for t, rb, v in zip(self._pinned[slot], self.row_bytes,
                                        views)]
            yield SlotBatch(views, pinned, lambda s=slot: release(s))

    def __del__(self):
        if getattr(self, "_handle", None):
            self._close()
