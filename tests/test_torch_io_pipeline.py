"""The port's input pipeline against the JAX package's, on the CPU.

``paddle_tpu_torch.io``'s data half (``BatchSampler``, ``DataLoader``,
its threaded, native, iterable and worker paths), ``io.native`` (the
port's own copy of the C++ core, built into ``paddle_tpu_torch/_build``),
``io.prefetch`` and ``monitor.sampler`` are held to ``paddle_tpu``'s on
the same inputs, made from a numpy seed. Tolerances: bit equality for
every batch, order, gathered row, parsed value and counter; the slice's
losses (a small ResNet trained 3 steps from the pipeline in both
packages) within 1e-4, the float32 tolerance of ``test_torch_resnet.py``.

Worker processes are forked only in a child interpreter that imports the
port and numpy alone (never from this process, which holds JAX's
threads). Every wait is bounded, and each test checks that it leaves no
thread behind.
"""
import os
import subprocess
import sys
import textwrap
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.tensor as ref_tensor
from paddle_tpu import io as jio
from paddle_tpu import jit as jjit
from paddle_tpu import monitor as jmonitor
from paddle_tpu import optimizer as jopt
from paddle_tpu.io import native as jnative
from paddle_tpu.io import prefetch as jprefetch
from paddle_tpu.models import resnet as jresnet
from paddle_tpu.ops import loss as jloss
from paddle_tpu.resilience import faults as jfaults
from paddle_tpu.resilience import retry as jretry

from paddle_tpu_torch import device, io, jit, monitor, optimizer
from paddle_tpu_torch.convert import load_jax_state
from paddle_tpu_torch.io import native
from paddle_tpu_torch.models import resnet
from paddle_tpu_torch.monitor import sampler
from paddle_tpu_torch.ops import loss
from paddle_tpu_torch.resilience import faults
from paddle_tpu_torch.resilience import retry
from paddle_tpu_torch.tools import bench_resnet

ROOT = Path(__file__).resolve().parents[1]
PORT_THREADS = ("paddle_tpu_torch-prefetch", "paddle_tpu_torch-loader",
                "paddle_tpu_torch-sampler")


@pytest.fixture(autouse=True)
def _no_arena_hook():
    """The reference's flat-arena hook cleared for each test and restored
    after (ROADMAP.md Queue C): an earlier file on the worker may leave it
    set, and the reference's layers then fail."""
    hook = ref_tensor._arena_hook
    ref_tensor._arena_hook = None
    yield
    ref_tensor._arena_hook = hook


@pytest.fixture(autouse=True)
def _clean():
    """Both monitors off and reset, both fault registries empty, and no
    thread of the pipeline left when the test ends."""
    for mon in (jmonitor, monitor):
        mon.disable(flush_counters=False)
        mon.reset()
    yield
    jfaults.clear()
    faults.clear()
    for mon in (jmonitor, monitor):
        mon.disable(flush_counters=False)
        mon.reset()
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline:
        left = [t.name for t in threading.enumerate()
                if t.name in PORT_THREADS]
        if not left:
            break
        time.sleep(0.05)
    assert not left, f"threads left running: {left}"


@pytest.fixture
def on_cpu():
    """The port's default device set to the CPU for the test."""
    prev = device._current
    device.set_device("cpu")
    yield
    device._current = prev


def _images(n=50, shape=(3, 8, 8), classes=10, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randint(0, 256, (n,) + shape).astype("u1")
    y = rng.randint(0, classes, (n,)).astype("i8")
    return x, y


def _equal_batches(a, b):
    assert len(a) == len(b)
    for ba, bb in zip(a, b):
        assert len(ba) == len(bb)
        for u, v in zip(ba, bb):
            u = u.numpy() if isinstance(u, torch.Tensor) else np.asarray(u)
            v = v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            assert u.dtype == v.dtype and u.shape == v.shape
            np.testing.assert_array_equal(u, v)


# -- the sampler and the loader, against the reference -----------------------

@pytest.mark.parametrize("n,bs,shuffle,drop_last,seed", [
    (10, 3, False, False, None), (10, 3, False, True, None),
    (37, 5, True, False, 7), (37, 5, True, True, 0), (64, 8, True, True, 3),
    (5, 8, True, False, 1)])
def test_batch_sampler_orders_equal_the_reference(n, bs, shuffle, drop_last,
                                                  seed):
    ds = np.arange(n)
    a = jio.BatchSampler(ds, shuffle=shuffle, batch_size=bs,
                         drop_last=drop_last, seed=seed)
    b = io.BatchSampler(ds, shuffle=shuffle, batch_size=bs,
                        drop_last=drop_last, seed=seed)
    assert len(a) == len(b)
    for _ in range(3):
        assert [list(x) for x in a] == [list(x) for x in b]
    a.set_epoch(1)
    b.set_epoch(1)
    assert [list(x) for x in a] == [list(x) for x in b]


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (True, False),
                                               (False, False)])
def test_dataloader_batches_equal_the_reference(use_native, shuffle,
                                                drop_last):
    """uint8 images and int64 labels over three epochs, each followed by
    an epoch cut short by a ``break`` (the native batcher then restarts on
    the next seed, as the reference's does): every batch bit-equal, and
    the same path taken (``_native_epoch``)."""
    x, y = _images()
    kw = dict(batch_size=8, shuffle=shuffle, drop_last=drop_last, seed=3,
              use_native=use_native)
    a = jio.DataLoader(jio.TensorDataset(x, y), **kw)
    b = io.DataLoader(io.TensorDataset(x, y), **kw)
    assert (a._native_epoch is None) == (b._native_epoch is None) == (
        not use_native)
    assert len(a) == len(b)
    for _ in range(3):
        _equal_batches(list(a), list(b))
        for loader in (a, b):
            for i, _ in enumerate(loader):
                if i == 2:
                    break
    if use_native:
        assert not b._native_epoch.running


def test_dataloader_collate_and_sampler_paths_equal_the_reference():
    """A custom collate (the native gather path is then off) and a given
    batch sampler (rows gathered by the C++ ``gather_rows``)."""
    x, y = _images(40)

    def collate(samples):
        return tuple(np.stack(f) for f in zip(*samples))

    for kw in (dict(collate_fn=collate),
               dict(batch_sampler=[[3, 1, 4], [1, 5, 9, 2], [6]]),
               dict(prefetch_factor=1)):
        a = jio.DataLoader(jio.TensorDataset(x, y), batch_size=6,
                           shuffle=True, seed=5, **kw)
        b = io.DataLoader(io.TensorDataset(x, y), batch_size=6,
                          shuffle=True, seed=5, **kw)
        assert (a._native is None) == (b._native is None)
        _equal_batches(list(a), list(b))


def test_tensor_dataset_takes_port_tensors():
    x, y = _images(12)
    ds = io.TensorDataset(torch.from_numpy(x), torch.from_numpy(y).float())
    assert ds.arrays[0].dtype == np.uint8 and ds.arrays[1].dtype == \
        np.float32
    np.testing.assert_array_equal(ds[3][0], x[3])
    assert len(ds) == 12


@pytest.mark.parametrize("prefetch_factor,drop_last", [(1, False), (2, False),
                                                       (2, True)])
def test_iterable_dataset_equals_the_reference(prefetch_factor, drop_last):
    def make(mod):
        class Gen(mod.IterableDataset):
            def __iter__(self):
                rng = np.random.RandomState(1)
                for i in range(11):
                    yield rng.rand(3).astype("f4"), np.int64(i)
        return Gen()

    a = jio.DataLoader(make(jio), batch_size=4, drop_last=drop_last,
                       prefetch_factor=prefetch_factor)
    b = io.DataLoader(make(io), batch_size=4, drop_last=drop_last,
                      prefetch_factor=prefetch_factor)
    _equal_batches(list(a), list(b))
    for mod, gen in ((jio, make(jio)), (io, make(io))):
        with pytest.raises(ValueError):
            mod.DataLoader(gen, batch_size=2, shuffle=True)
        with pytest.raises(TypeError):
            len(mod.DataLoader(gen, batch_size=2))


@pytest.mark.parametrize("iterable", [False, True])
def test_errors_reach_the_consumer_as_in_the_reference(iterable):
    """A dataset raising at item 5 (a ``_WorkerError`` through the
    producer thread): the same exception type in both packages, after
    the same batches."""
    def make(mod):
        if iterable:
            class Bad(mod.IterableDataset):
                def __iter__(self):
                    for i in range(8):
                        if i == 5:
                            raise KeyError("bad item 5")
                        yield np.full(2, i, "f4")
        else:
            class Bad(mod.Dataset):
                def __len__(self):
                    return 8

                def __getitem__(self, i):
                    if i == 5:
                        raise KeyError("bad item 5")
                    return np.full(2, i, "f4")
        return Bad()

    got = {}
    for name, mod in (("ref", jio), ("port", io)):
        seen = []
        with pytest.raises(KeyError, match="bad item 5"):
            for xb in mod.DataLoader(make(mod), batch_size=2, retry=False,
                                     use_native=False):
                seen.append(xb)
        got[name] = seen
    _equal_batches([(b,) for b in got["ref"]], [(b,) for b in got["port"]])
    assert isinstance(io._WorkerError(ValueError()).exc, ValueError)


def test_assemble_retries_a_transient_loader_fault_as_the_reference():
    """With a ``loader`` fault registered the native epoch steps aside and
    each batch goes through ``_assemble``'s fault site and retry: one
    transient firing is retried and the epoch is the sampler's, in both
    packages; a terminal one propagates."""
    x, y = _images(30)
    got = {}
    for name, mod, fmod in (("ref", jio, jfaults), ("port", io, faults)):
        spec = fmod.inject("loader", step=2, times=1)
        loader = mod.DataLoader(mod.TensorDataset(x, y), batch_size=4,
                                shuffle=True, seed=2)
        got[name] = list(loader)
        assert spec.fired == 1
        fmod.clear()
        fmod.inject("loader", step=1, exc=ValueError("terminal"))
        with pytest.raises(ValueError, match="terminal"):
            list(mod.DataLoader(mod.TensorDataset(x, y), batch_size=4))
        fmod.clear()
    _equal_batches(got["ref"], got["port"])
    plain = list(io.DataLoader(io.TensorDataset(x, y), batch_size=4,
                               shuffle=True, seed=2, use_native=False))
    _equal_batches(got["port"], plain)


def test_unported_loader_arguments_raise_naming_their_item():
    x, y = _images(8)
    ds = io.TensorDataset(x, y)
    for kw, item in ((dict(places=["cuda:0", "cuda:1"]), "item 19"),
                     (dict(device_mesh=object()), "item 19"),
                     (dict(feed_list=["x"]), "item 18"),
                     (dict(return_list=False), "item 18")):
        with pytest.raises(NotImplementedError, match=item):
            io.DataLoader(ds, batch_size=2, **kw)


def test_loader_for_the_card_raises_without_one(monkeypatch):
    x, y = _images(8)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prev = device._current
    device._current = None
    try:
        with pytest.raises(RuntimeError, match="CUDA"):
            io.DataLoader(io.TensorDataset(x, y), batch_size=2,
                          prefetch_to_device=2)
        with pytest.raises(RuntimeError, match="CUDA"):
            io.prefetch_to_device(iter([x]))
    finally:
        device._current = prev
    for kw in (dict(mesh=object()), dict(sharding=object())):
        with pytest.raises(NotImplementedError, match="item 19"):
            io.prefetch_to_device(iter([x]), device="cpu", **kw)


def test_reader_decorators_of_io_equal_the_reference():
    def reader():
        rng = np.random.RandomState(4)
        for i in range(23):
            yield rng.rand(3).astype("f4"), np.int64(i)

    for a, b in ((jio.batch_reader(reader, 5), io.batch_reader(reader, 5)),
                 (jio.batch_reader(reader, 5, drop_last=True),
                  io.batch_reader(reader, 5, drop_last=True))):
        _equal_batches(list(a()), list(b()))
    a = list(jio.shuffle_reader(reader, 7, seed=3)())
    b = list(io.shuffle_reader(reader, 7, seed=3)())
    _equal_batches(a, b)


# -- the native core ----------------------------------------------------------

@pytest.mark.parametrize("shuffle,drop_last,slots", [
    (True, False, 3), (True, True, 2), (False, True, 4), (False, False, 2)])
def test_native_batcher_equals_the_reference(shuffle, drop_last, slots):
    rng = np.random.RandomState(1)
    arrs = [rng.rand(37, 3, 5).astype("f4"),
            rng.randint(0, 256, (37, 7)).astype("u1"),
            np.arange(37, dtype="i4")]
    a = jnative.NativeBatcher(arrs, batch_size=6, shuffle=shuffle,
                              drop_last=drop_last, seed=11,
                              prefetch_slots=slots)
    b = native.NativeBatcher(arrs, batch_size=6, shuffle=shuffle,
                             drop_last=drop_last, seed=11,
                             prefetch_slots=slots)
    for _ in range(3):
        _equal_batches(list(a), list(b))
    assert not b.running
    g = [3, 1, 3, 36]
    _equal_batches([jnative.NativeBatcher(arrs).gather(g)],
                   [native.NativeBatcher(arrs).gather(g)])


def test_native_slots_are_views_released_by_the_consumer():
    """``slots()`` hands out views of the slots (no copy) that the
    consumer releases; the bytes are the copying iterator's, and an epoch
    cut short stops the worker at once."""
    x, y = _images(40, shape=(16,))
    kw = dict(batch_size=8, shuffle=True, drop_last=False, seed=4,
              prefetch_slots=2)
    b = native.NativeBatcher([x, y], **kw)
    want = list(native.NativeBatcher([x, y], **kw))
    got = []
    for sb in b.slots():
        assert isinstance(sb, native.SlotBatch) and sb.pinned is None
        assert not sb[0].flags.owndata
        got.append(tuple(a.copy() for a in sb))
        sb.release()
        sb.release()   # a second release is a no-op
    _equal_batches(got, want)
    assert b.batches == len(want) and not b.running
    it = b.slots()
    first = next(it)
    assert b.running
    first.release()
    it.close()
    assert not b.running
    # the abandoned epoch restarts on the next seed, as the reference's
    want = list(native.NativeBatcher([x, y], **dict(kw, seed=5)))
    _equal_batches(list(b), want)


@pytest.mark.parametrize("n,row", [(7, (3,)), (1500, (4,)), (64, (64, 128))])
def test_gather_rows_equals_the_reference(n, row):
    """Below and above the threaded split, by rows (1,500) and by bytes
    (64 rows of 32 KiB)."""
    rng = np.random.RandomState(n)
    src = rng.rand(200, *row).astype("f4")
    idx = rng.randint(0, 200, n)
    want = jnative.gather_rows(src, idx)
    got = native.gather_rows(src, idx)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, src[idx])
    out = np.empty_like(want)
    assert native.gather_rows(src, idx, out=out, n_threads=1) is out
    np.testing.assert_array_equal(out, want)


def test_arena_equals_the_reference():
    for mod in (jnative, native):
        a = mod.Arena(1 << 16)
        x = a.alloc_array((10, 3), "f4")
        y = a.alloc_array((5,), "i8", align=256)
        x[:] = 1.5
        y[:] = 7
        assert x.ctypes.data % 64 == 0 and y.ctypes.data % 256 == 0
        used, peak = a.used, a.peak
        a.reset()
        assert a.used == 0 and a.peak == peak
        with pytest.raises(MemoryError):
            a.alloc_array((1 << 16,), "f4")
        if mod is jnative:
            ref = (used, peak)
        else:
            assert (used, peak) == ref


@pytest.mark.parametrize("text,n_slots,ints", [
    ("2 1.5 2.5 1 7\n1 -3 2 9 10\n", 2, (0, 1)),
    ("1 9223372036854775807 0\n2 -1 4 1 3.25\n", 2, (1, 0)),
    ("3 1 2 3", 1, (1,)),
    ("", 2, (0, 0)),
    ("2 1.5", 1, (0,)),          # truncated record
    ("1.5 2", 1, (0,)),          # a count that is not an integer
    ("1 2x", 1, (1,))])          # a token that does not end at a space
def test_multislot_parse_equals_the_reference(text, n_slots, ints):
    try:
        want = jnative.multislot_parse(text, n_slots, ints)
    except ValueError:
        with pytest.raises(ValueError):
            native.multislot_parse(text, n_slots, ints)
        return
    got = native.multislot_parse(text, n_slots, ints)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g.view("u8"), w.view("u8"))


def test_native_library_is_built_outside_the_source_tree():
    so = native.library_path()
    native.get_lib()
    assert so.exists() and so.parent == ROOT / "paddle_tpu_torch" / "_build"
    assert not list((ROOT / "paddle_tpu_torch" / "csrc").glob("*.so"))


def test_a_failed_build_raises_with_the_compilers_output(tmp_path,
                                                         monkeypatch):
    """No quiet fallback: a core that does not compile raises, also from
    a ``DataLoader`` asked for the native path."""
    bad = tmp_path / "core.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native._kernels, "BUILD_DIR", tmp_path / "build")
    x, y = _images(8)
    with pytest.raises(RuntimeError, match="core.cpp"):
        native.get_lib()
    with pytest.raises(RuntimeError, match="core.cpp"):
        io.DataLoader(io.TensorDataset(x, y), batch_size=2)
    # the Python path is there only when asked for
    assert len(list(io.DataLoader(io.TensorDataset(x, y), batch_size=2,
                                  use_native=False))) == 4


def test_concurrent_builds_share_one_library(tmp_path):
    """Four interpreters building the core at once into an empty build
    directory (the test workers' case): each loads it and one library is
    left, with no temporary file."""
    code = textwrap.dedent(f"""
        import sys
        from pathlib import Path
        sys.path.insert(0, {str(ROOT)!r})
        from paddle_tpu_torch.ops import kernels
        kernels.BUILD_DIR = Path({str(tmp_path)!r})
        from paddle_tpu_torch.io import native
        import numpy as np
        x = np.arange(12, dtype="f4").reshape(6, 2)
        assert (native.gather_rows(x, [5, 0]) == x[[5, 0]]).all()
        print("ok")
    """)
    procs = [subprocess.Popen([sys.executable, "-c", code],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for _ in range(4)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=120)[0])
        finally:
            p.kill()
    assert all(p.returncode == 0 and "ok" in o for p, o in zip(procs, outs)), \
        outs
    assert [f.suffix for f in tmp_path.iterdir()
            if f.name != "core.lock"] == [".so"]


# -- worker processes, in a child interpreter ---------------------------------

_WORKER_SCRIPT = """
import sys
sys.path.insert(0, {root!r})
import numpy as np
from paddle_tpu_torch import io


class Transform(io.Dataset):
    def __len__(self):
        return 23

    def __getitem__(self, i):
        rng = np.random.RandomState(i)
        return rng.rand(16).astype("f4"), np.int64(i)


class Bad(io.Dataset):
    def __len__(self):
        return 8

    def __getitem__(self, i):
        if i == 5:
            raise ValueError("boom at 5")
        return np.zeros(3, "f4")


out = {{}}
for workers in (1, 3):
    batches = list(io.DataLoader(Transform(), batch_size=4, shuffle=True,
                                 seed=2, num_workers=workers,
                                 use_native=False))
    out[f"x{{workers}}"] = np.stack([b[0] for b in batches[:-1]])
    out[f"i{{workers}}"] = np.concatenate([b[1] for b in batches])
try:
    list(io.DataLoader(Bad(), batch_size=2, num_workers=2,
                       use_native=False))
    out["error"] = np.array("none")
except ValueError as e:
    out["error"] = np.array(str(e))
import multiprocessing
out["left"] = np.array(len(multiprocessing.active_children()))
np.savez({path!r}, **out)
"""


def test_worker_processes_in_a_child_interpreter(tmp_path):
    """``num_workers`` of 1 and 3 forked from an interpreter that imports
    only the port and numpy: the batches, in order, equal the threaded
    path's (held above to the reference's), a worker's error reaches the
    consumer, and no worker is left."""
    path = tmp_path / "workers.npz"
    script = tmp_path / "workers.py"
    script.write_text(_WORKER_SCRIPT.format(root=str(ROOT), path=str(path)))
    r = subprocess.run([sys.executable, str(script)], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    got = np.load(path)

    class Transform(io.Dataset):
        def __len__(self):
            return 23

        def __getitem__(self, i):
            rng = np.random.RandomState(i)
            return rng.rand(16).astype("f4"), np.int64(i)

    threaded = list(io.DataLoader(Transform(), batch_size=4, shuffle=True,
                                  seed=2, use_native=False))
    want_x = np.stack([b[0] for b in threaded[:-1]])
    want_i = np.concatenate([b[1] for b in threaded])
    for w in (1, 3):
        np.testing.assert_array_equal(got[f"x{w}"], want_x)
        np.testing.assert_array_equal(got[f"i{w}"], want_i)
    assert str(got["error"]) == "boom at 5"
    assert int(got["left"]) == 0


# -- prefetch ------------------------------------------------------------------

def test_prefetch_on_the_cpu_keeps_order_and_canonicalises_dtypes():
    rng = np.random.RandomState(0)
    batches = [(rng.rand(4, 3), rng.randint(0, 9, (4,)),
                rng.randint(0, 255, (4, 2)).astype("u1"))
               for _ in range(6)]
    got = list(io.prefetch_to_device(iter(batches), size=2, device="cpu"))
    assert len(got) == 6
    for g, b in zip(got, batches):
        assert [t.dtype for t in g] == [torch.float32, torch.int32,
                                        torch.uint8]
        # the reference's jax.device_put makes the same 32-bit values
        ref = [np.asarray(a) for a in jprefetch._place(b, None, "dp", None,
                                                       None)]
        for t, r in zip(g, ref):
            assert str(t.numpy().dtype) == str(r.dtype)
            np.testing.assert_array_equal(t.numpy(), r)
    dicts = [{"x": np.full((2,), i, "f8"), "n": np.int64(i)}
             for i in range(3)]
    got = list(io.prefetch_to_device(dicts, device="cpu"))
    assert [int(d["n"]) for d in got] == [0, 1, 2]
    assert got[2]["x"].dtype == torch.float32 and got[2]["n"].ndim == 0


def test_prefetch_copies_are_the_consumers_own():
    a = np.zeros((3, 2), "f4")
    out = next(io.prefetch_to_device(iter([(a,)]), device="cpu"))
    a += 1
    assert float(out[0].sum()) == 0.0


def _counts(mon, names):
    return {k: mon.registry().value(k, 0) for k in names}


def test_prefetch_retry_and_drop_counters_equal_the_reference():
    """A transient ``loader`` fault at batch 1 is retried; three at batch
    3 spend the budget and drop that slot; the counters and the delivered
    batches are the reference's."""
    batches = [np.full((2,), i, "f4") for i in range(6)]
    names = ("prefetch.batches", "prefetch.drops", "resilience.retry",
             "resilience.drop", "resilience.fault_injected")
    got = {}
    for name, mon, fmod, pf, rmod in (
            ("ref", jmonitor, jfaults, jprefetch.prefetch_to_device, jretry),
            ("port", monitor, faults, io.prefetch_to_device, retry)):
        mon.enable()
        fmod.inject("loader", step=1, times=1)
        fmod.inject("loader", step=3, times=3)
        pol = rmod.RetryPolicy(max_attempts=3, base_delay=0.001)
        kw = {} if mon is jmonitor else dict(device="cpu")
        out = [np.asarray(b) for b in pf(iter(batches), retry=pol, **kw)]
        got[name] = (out, _counts(mon, names))
        mon.disable(flush_counters=False)
        fmod.clear()
    (ref_out, ref_counts), (out, counts) = got["ref"], got["port"]
    _equal_batches([(b,) for b in ref_out], [(b,) for b in out])
    assert counts == ref_counts
    assert counts["prefetch.drops"] == 1 and counts["resilience.retry"] == 3
    assert monitor.registry().value("prefetch.stall_seconds", 0) >= 0


def test_prefetch_max_drops_is_terminal_and_errors_propagate():
    faults.inject("loader", times=None)    # every attempt of every batch
    pol = retry.RetryPolicy(max_attempts=1, base_delay=0.0)
    with pytest.raises(RuntimeError, match="max_drops=2"):
        list(io.prefetch_to_device(iter(range(10)), device="cpu",
                                   retry=pol, max_drops=2))
    faults.clear()

    def bad():
        yield np.zeros(2)
        raise ValueError("terminal source error")

    it = io.prefetch_to_device(bad(), device="cpu")
    assert next(it).shape == (2,)
    with pytest.raises(ValueError, match="terminal source error"):
        next(it)


def test_closing_prefetch_joins_its_thread_and_the_batcher():
    x, y = _images(400, shape=(8,))
    b = native.NativeBatcher([x, y], batch_size=4, shuffle=True, seed=1,
                             prefetch_slots=2)
    it = io.prefetch_to_device(b.slots(), size=2, device="cpu")
    next(it)
    assert any(t.name == "paddle_tpu_torch-prefetch"
               for t in threading.enumerate())
    it.close()
    assert not any(t.name == "paddle_tpu_torch-prefetch"
                   for t in threading.enumerate())
    assert not b.running


def test_queue_depth_reaches_the_sampler():
    gen = io.prefetch_to_device(iter([np.zeros(2)] * 4), size=3,
                                device="cpu")
    next(gen)
    time.sleep(0.2)
    sampler.sample_once()
    assert 0 <= monitor.registry().value("prefetch.queue_depth", -1) <= 3
    gen.close()
    keys = [k for k in sampler._providers if k.startswith("prefetch-")]
    assert not keys


def test_dataloader_prefetch_on_the_cpu_equals_the_host_batches(on_cpu):
    x, y = _images(50)
    kw = dict(batch_size=8, shuffle=True, drop_last=True, seed=9)
    host = list(io.DataLoader(io.TensorDataset(x, y), **kw))
    dl = io.DataLoader(io.TensorDataset(x, y), prefetch_to_device=2, **kw)
    assert dl._device.type == "cpu" and not dl._native_epoch.pin_memory
    got = list(dl)
    assert all(isinstance(t, torch.Tensor) for b in got for t in b)
    _equal_batches([(xb, yb.astype("i4")) for xb, yb in host], got)
    for i, _ in enumerate(dl):
        if i == 1:
            break
    assert not dl._native_epoch.running


# -- the sampler ----------------------------------------------------------------

def test_sampler_publishes_providers_and_no_device_gauges_on_the_cpu():
    reg = monitor.registry()
    key = sampler.register_provider("t", lambda: {"t.depth": 5})
    gone = sampler.register_provider("gone", lambda: None)
    sampler.sample_once()
    assert reg.value("t.depth", None) == 5
    assert reg.value("mem.host.rss_bytes", 0) > 0
    assert not any(k.startswith("mem.device.") for k in monitor.snapshot())
    assert gone not in sampler._providers
    sampler.unregister_provider(key)
    s = sampler.start(interval_s=0.05)
    assert sampler.active() is s and s.running()
    sampler.stop()
    assert sampler.active() is None and not s.running()


# -- the slice: a small ResNet trained from the pipeline ------------------------

BATCH, SIZE, CLASSES, STEPS, LR = 8, 64, 10, 3, 0.002


@pytest.fixture
def no_onednn_convolutions():
    """PyTorch's CPU convolutions through oneDNN have miscomputed once
    XLA's CPU runtime ran in the process (``test_torch_resnet.py``)."""
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def test_resnet_fed_by_the_pipeline_matches_the_reference(
        on_cpu, no_onednn_convolutions):
    """``ResNet(BasicBlock, [1, 1, 1, 1])`` trained 3 steps from
    uint8 images through ``DataLoader(use_native=True,
    prefetch_to_device=2)`` and ``jit.to_static`` on the CPU, against the
    reference's own loop over its own native ``DataLoader`` with the same
    seed: the same batches, and each loss within 1e-4."""
    rng = np.random.RandomState(0)
    n = BATCH * STEPS
    x = (rng.rand(n, 3, SIZE, SIZE) * 255).astype("u1")
    y = rng.randint(0, CLASSES, (n,)).astype("i4")
    pt.seed(0)
    jm = jresnet.ResNet(jresnet.BasicBlock, [1, 1, 1, 1],
                        num_classes=CLASSES)
    jm.train()
    m = resnet.ResNet(resnet.BasicBlock, [1, 1, 1, 1],
                      num_classes=CLASSES).train()
    load_jax_state(m, {k: np.asarray(v.numpy())
                       for k, v in jm.state_dict().items()})

    jo = jopt.Momentum(learning_rate=LR, momentum=0.9,
                       parameters=jm.parameters())

    def jstep(xb, yb):
        xf = (xb.astype("float32") / 255.0 - 0.45) / 0.22
        lo = jloss.cross_entropy(jm(xf), yb)
        lo.backward()
        jo.step()
        jo.clear_grad()
        return lo

    jfn = jjit.to_static(jstep, models=[jm], optimizers=[jo])
    kw = dict(batch_size=BATCH, shuffle=True, drop_last=True, seed=4,
              use_native=True)
    ref_losses, ref_batches = [], []
    for xb, yb in jio.DataLoader(jio.TensorDataset(x, y), **kw):
        ref_batches.append((xb, yb))
        ref_losses.append(float(jfn(pt.to_tensor(xb),
                                    pt.to_tensor(yb)).numpy()))

    o = optimizer.Momentum(learning_rate=LR, momentum=0.9,
                           parameters=m.parameters())

    def step(xb, yb):
        logits = m(bench_resnet.normalize_u8(xb))
        lo = loss.cross_entropy(logits, yb)
        lo.backward()
        o.step()
        o.clear_grad()
        return lo.detach()

    fn = jit.to_static(step, models=[m], optimizers=[o])
    losses, batches = [], []
    for xb, yb in io.DataLoader(io.TensorDataset(x, y), prefetch_to_device=2,
                                **kw):
        batches.append((xb, yb))
        losses.append(float(fn(xb, yb)))
    assert len(losses) == STEPS
    _equal_batches(ref_batches, batches)
    np.testing.assert_allclose(losses, ref_losses, rtol=0, atol=1e-4)


def test_bench_resnet_pipeline_runs_on_the_cpu(on_cpu):
    """The tool's loop at a tiny size on the CPU: both feeds, the stall
    series, and the loader alone; its default device is the card."""
    from paddle_tpu_torch.tools import bench_resnet_pipeline as BRP
    rec = BRP.bench_pipeline(batch=2, steps=2, data_format="NHWC",
                             device="cpu", size=16, model_fn=resnet.ResNet,
                             block=resnet.BottleneckBlock,
                             depths=[1, 1, 1, 1], num_classes=4)
    arm = rec["arms"]["graph"]
    assert rec["loader_images_per_s"] > 0
    for kind in ("pipeline", "resident"):
        assert arm[kind]["step_ms"] > 0 and len(arm[kind]["step_ms_runs"]) \
            == 2
    assert arm["stall_s_per_step"] >= 0 and arm["wait_ms_per_step"] >= 0
    x, y = BRP.make_dataset(2, 2, "NHWC", 16, 4)
    assert x.shape == (8, 16, 16, 3) and x.dtype == np.uint8 and \
        y.dtype == np.int32


def test_bench_resnet_pipeline_defaults_to_the_card(monkeypatch):
    from paddle_tpu_torch.tools import bench_resnet_pipeline as BRP
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(device, "_current", None)
    with pytest.raises(RuntimeError, match="CUDA"):
        BRP.bench_pipeline(batch=2, steps=1, size=16)


PIPELINE_MODULES = (
    "paddle_tpu_torch.io", "paddle_tpu_torch.io.native",
    "paddle_tpu_torch.io.prefetch", "paddle_tpu_torch.monitor.sampler",
    "paddle_tpu_torch.reader", "paddle_tpu_torch.dataset",
    "paddle_tpu_torch.tools.bench_resnet_pipeline")


@pytest.fixture(scope="module")
def jax_loaded_by():
    """``{module: JAX modules loaded once it was imported}``, each module
    of the pipeline imported in turn by one interpreter that starts with
    neither package."""
    code = textwrap.dedent(f"""
        import importlib, json, sys
        sys.path.insert(0, {str(ROOT)!r})
        out = {{}}
        for name in {PIPELINE_MODULES!r}:
            importlib.import_module(name)
            out[name] = sorted(m for m in sys.modules if m.split(".")[0]
                               in ("jax", "jaxlib", "paddle_tpu"))
        print(json.dumps(out))
    """)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=str(ROOT),
                       env=dict(os.environ))
    assert r.returncode == 0, r.stdout + r.stderr
    import json
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("module", PIPELINE_MODULES)
def test_pipeline_modules_load_no_jax(module, jax_loaded_by):
    assert jax_loaded_by[module] == []
