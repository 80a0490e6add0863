"""The port's reader decorators and image datasets against the JAX
package's, on the CPU.

``paddle_tpu_torch.reader`` (the fluid reader decorators) and
``paddle_tpu_torch.dataset`` (``common``, ``image``, ``mnist``,
``cifar``, ``flowers``) run on the same inputs as ``paddle_tpu.reader``
and ``paddle_tpu.dataset``. Tolerance: none. Every sample, array and
order is bit-equal; where a decorator interleaves threads (the unordered
``xmap_readers`` and ``multiprocess_reader``), the samples are compared
as a sorted multiset. Python's ``random`` (the ``shuffle`` decorator's
draw) is seeded alike before each package's pass. Every wait is bounded,
and no test leaves a thread behind.
"""
import io as _io
import pickle
import random
import tarfile
import threading
import time

import numpy as np
import pytest

import paddle_tpu.reader as jreader
from paddle_tpu.dataset import cifar as jcifar
from paddle_tpu.dataset import common as jcommon
from paddle_tpu.dataset import flowers as jflowers
from paddle_tpu.dataset import image as jimage
from paddle_tpu.dataset import mnist as jmnist

import paddle_tpu_torch.dataset as ds
from paddle_tpu_torch import reader
from paddle_tpu_torch.dataset import cifar, common, flowers, image, mnist


@pytest.fixture(autouse=True)
def _no_threads_left():
    before = set(threading.enumerate())
    yield
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline:
        left = [t for t in threading.enumerate()
                if t not in before and t.is_alive()]
        if not left:
            break
        time.sleep(0.05)
    assert not left, f"threads left running: {left}"


def _samples(n=17, seed=0):
    def creator():
        rng = np.random.RandomState(seed)
        for i in range(n):
            yield rng.rand(3).astype("f4"), i
    return creator


def _same(a, b):
    """Two sample streams equal, sample by sample and field by field."""
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, (tuple, list)):
            assert type(x) is type(y) and len(x) == len(y)
            for u, v in zip(x, y):
                _same([u], [v])
        elif isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)
        else:
            assert x == y and type(x) is type(y)


def _key(sample):
    return pickle.dumps(sample)


def _run(mod_reader, make):
    """A decorated creator from ``make(mod)`` run to its end."""
    random.seed(1234)
    return list(make(mod_reader)())


# -- reader decorators ---------------------------------------------------------

DECORATORS = {
    "cache": lambda R: R.cache(_samples()),
    "map_readers": lambda R: R.map_readers(
        lambda a, b: (a[0] * 2, b[1] + 1), _samples(), _samples(seed=1)),
    "shuffle": lambda R: R.shuffle(_samples(40), 7),
    "chain": lambda R: R.chain(_samples(5), _samples(3, seed=2)),
    "compose": lambda R: R.compose(_samples(6), _samples(6, seed=3)),
    "compose_unchecked": lambda R: R.compose(
        _samples(6), _samples(4, seed=3), check_alignment=False),
    "buffered": lambda R: R.buffered(_samples(30), 4),
    "firstn": lambda R: R.firstn(_samples(), 5),
    "xmap_ordered": lambda R: R.xmap_readers(
        lambda s: (s[0] + 1, s[1] * 3), _samples(40), 4, 3, order=True),
    "batch": lambda R: R.batch(_samples(), 5),
    "batch_drop_last": lambda R: R.batch(_samples(), 5, drop_last=True),
}


@pytest.mark.parametrize("name", sorted(DECORATORS))
def test_decorator_equals_the_reference(name):
    _same(_run(jreader, DECORATORS[name]), _run(reader, DECORATORS[name]))


@pytest.mark.parametrize("name,make", [
    ("xmap_unordered", lambda R: R.xmap_readers(
        lambda s: (s[0] * 2, s[1]), _samples(40), 3, 2)),
    ("multiprocess_reader", lambda R: R.multiprocess_reader(
        [_samples(10), _samples(12, seed=5), _samples(3, seed=6)],
        queue_size=4))])
def test_interleaving_decorators_equal_the_reference_as_multisets(name,
                                                                  make):
    a = sorted(_run(jreader, make), key=_key)
    b = sorted(_run(reader, make), key=_key)
    _same(a, b)


def test_cache_replays_only_a_finished_pass():
    calls = []

    def src():
        calls.append(1)
        yield from range(4)

    c = reader.cache(src)
    it = c()
    next(it)
    it.close()
    assert list(c()) == [0, 1, 2, 3] and list(c()) == [0, 1, 2, 3]
    assert len(calls) == 2


def test_compose_not_aligned_raises_in_both():
    for R in (jreader, reader):
        with pytest.raises(R.ComposeNotAligned):
            list(R.compose(_samples(3), _samples(4))())
    assert issubclass(reader.ComposeNotAligned, ValueError)


def test_xmap_forwards_errors_and_stops_its_threads():
    """A raising reader or mapper reaches the consumer (as in the
    reference, whose workers can then stay parked on a full queue: the
    port's stop and are joined)."""
    def bad():
        yield 1
        raise KeyError("reader failed")

    with pytest.raises(KeyError, match="reader failed"):
        list(reader.xmap_readers(lambda s: s, bad, 2, 2)())

    def boom(s):
        raise ValueError("mapper failed")

    with pytest.raises(ValueError, match="mapper failed"):
        list(reader.xmap_readers(boom, _samples(5), 2, 2, order=True)())


@pytest.mark.parametrize("name", ["buffered", "xmap", "multiprocess"])
def test_abandoned_threaded_readers_stop_their_threads(name):
    """The port's threaded decorators stop and join their threads when
    the consumer closes them early (the fixture checks none is left)."""
    make = {"buffered": lambda: reader.buffered(_samples(500), 2),
            "xmap": lambda: reader.xmap_readers(lambda s: s, _samples(500),
                                                3, 2, order=True),
            "multiprocess": lambda: reader.multiprocess_reader(
                [_samples(500), _samples(500, seed=1)], queue_size=2)}[name]
    it = make()()
    next(it)
    next(it)
    it.close()


# -- datasets -------------------------------------------------------------------

def test_data_home_and_rng_follow_the_reference(monkeypatch, tmp_path):
    assert ds.__all__ == ["common", "mnist", "cifar", "flowers", "image"]
    assert common.DATA_HOME == jcommon.DATA_HOME or not \
        common.has_real("mnist")
    for name in ("mnist-train", "cifar10-templates", "flowers-test"):
        np.testing.assert_array_equal(common.rng_for(name).rand(5),
                                      jcommon.rng_for(name).rand(5))
    monkeypatch.setattr(common, "DATA_HOME", str(tmp_path))
    assert common.data_path("a", "b") == str(tmp_path / "a" / "b")
    with pytest.raises(RuntimeError, match="not cached"):
        common.download("http://example.invalid/x.tgz", "m", None)
    f = tmp_path / "m" / "x.tgz"
    f.parent.mkdir()
    f.write_bytes(b"abc")
    assert common.download("http://example.invalid/x.tgz", "m",
                           common.md5file(str(f))) == str(f)
    assert common.md5file(str(f)) == jcommon.md5file(str(f))


def test_split_and_cluster_files_reader_equal_the_reference(tmp_path,
                                                            monkeypatch):
    monkeypatch.chdir(tmp_path)
    files = common.split(_samples(11), 4, suffix=str(tmp_path / "p%05d.pkl"))
    assert len(files) == 3
    for tid in (0, 1):
        a = list(jcommon.cluster_files_reader(str(tmp_path / "p*.pkl"), 2,
                                              tid)())
        b = list(common.cluster_files_reader(str(tmp_path / "p*.pkl"), 2,
                                             tid)())
        _same(a, b)


SPLITS = {
    "mnist.train": (jmnist.train, mnist.train),
    "mnist.test": (jmnist.test, mnist.test),
    "cifar.train10": (jcifar.train10, cifar.train10),
    "cifar.test10": (jcifar.test10, cifar.test10),
    "cifar.train100": (jcifar.train100, cifar.train100),
    "cifar.test100": (jcifar.test100, cifar.test100),
    "flowers.train": (jflowers.train, flowers.train),
    "flowers.test": (jflowers.test, flowers.test),
    "flowers.valid": (jflowers.valid, flowers.valid),
}


@pytest.mark.parametrize("name", sorted(SPLITS))
def test_dataset_samples_equal_the_reference(name):
    a_fn, b_fn = SPLITS[name]
    a, b = list(a_fn()()), list(b_fn()())
    _same(a, b)
    assert isinstance(b[0][1], int)


@pytest.mark.parametrize("name", ["mnist.train", "mnist.test",
                                  "cifar.train_arrays10",
                                  "cifar.train_arrays100"])
def test_dataset_arrays_equal_the_reference(name):
    a, b = {"mnist.train": (jmnist.train_arrays, mnist.train_arrays),
            "mnist.test": (jmnist.test_arrays, mnist.test_arrays),
            "cifar.train_arrays10": (lambda: jcifar.train_arrays(10),
                                     lambda: cifar.train_arrays(10)),
            "cifar.train_arrays100": (lambda: jcifar.train_arrays(100),
                                      lambda: cifar.train_arrays(100)),
            }[name]
    _same(list(a()), list(b()))


def _photo(h=20, w=31, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (h, w, 3)).astype("u1")


IMAGE_FNS = {
    "resize_short": lambda M, im: M.resize_short(im, 12),
    "resize_short_tall": lambda M, im: M.resize_short(im.transpose(1, 0, 2),
                                                      9),
    "resize_exact": lambda M, im: M.resize_exact(im, 7, 40),
    "to_chw": lambda M, im: M.to_chw(im),
    "center_crop": lambda M, im: M.center_crop(im, 11),
    "random_crop": lambda M, im: M.random_crop(
        im, 11, rng=np.random.RandomState(3)),
    "left_right_flip": lambda M, im: M.left_right_flip(im),
    "simple_transform_train": lambda M, im: M.simple_transform(
        im, 16, 12, True, mean=[1.0, 2.0, 3.0],
        rng=np.random.RandomState(5)),
    "simple_transform_test": lambda M, im: M.simple_transform(
        im, 16, 12, False),
    "simple_transform_gray": lambda M, im: M.simple_transform(
        im[:, :, 0], 16, 12, False),
}


@pytest.mark.parametrize("name", sorted(IMAGE_FNS))
def test_image_transforms_equal_the_reference(name):
    im = _photo()
    _same([IMAGE_FNS[name](jimage, im)], [IMAGE_FNS[name](image, im)])


def test_image_loading_equals_the_reference(tmp_path):
    im = _photo(seed=2)
    path = str(tmp_path / "a.npy")
    np.save(path, im)
    _same([jimage.load_image(path)], [image.load_image(path)])
    _same([jimage.load_and_transform(path, 16, 12, False)],
          [image.load_and_transform(path, 16, 12, False)])
    buf = _io.BytesIO()
    np.save(buf, im)
    for color in (True, False):
        _same([jimage.load_image_bytes(buf.getvalue(), color)],
              [image.load_image_bytes(buf.getvalue(), color)])
    with pytest.raises(NotImplementedError):
        image.load_image(str(tmp_path / "a.jpg"))


def test_batch_images_from_tar_writes_the_references_batches(tmp_path):
    tar_path = tmp_path / "imgs.tar"
    labels = {}
    with tarfile.open(tar_path, "w") as tf:
        for i in range(5):
            data = _photo(4, 4, seed=i).tobytes()
            info = tarfile.TarInfo(f"img{i}.raw")
            info.size = len(data)
            tf.addfile(info, _io.BytesIO(data))
            labels[f"img{i}.raw"] = i % 2
    out = {}
    for name, mod in (("ref", jimage), ("port", image)):
        src = tmp_path / name / "imgs.tar"
        src.parent.mkdir()
        src.write_bytes(tar_path.read_bytes())
        meta = mod.batch_images_from_tar(str(src), "t", labels,
                                         num_per_batch=2)
        names = open(meta).read().split()
        out[name] = [pickle.load(open(src.parent / (str(src.name) + "_t_batch")
                                      / n, "rb")) for n in names]
    assert out["ref"] == out["port"] and len(out["port"]) == 3
