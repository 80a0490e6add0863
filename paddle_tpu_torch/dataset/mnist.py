"""paddle_tpu_torch.dataset.mnist — counterpart of
``paddle_tpu/dataset/mnist.py`` (Paddle's ``dataset/mnist.py``: the idx
parser, ``train`` and ``test`` readers yielding (image[784] float32 in
[-1, 1], label)), and its ``train_arrays`` / ``test_arrays``.

Real idx files under DATA_HOME/mnist are parsed; otherwise a synthetic
set of blurred class-template digits (same format, 10 classes) is
generated deterministically so LeNet-style configs actually converge."""
from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from . import common

TRAIN_N = 8000   # synthetic sizes (real idx files override)
TEST_N = 1000


def _parse_idx(image_path, label_path):
    with gzip.open(image_path, "rb") as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        images = np.frombuffer(f.read(), np.uint8).reshape(n, rows * cols)
    with gzip.open(label_path, "rb") as f:
        struct.unpack(">II", f.read(8))
        labels = np.frombuffer(f.read(), np.uint8)
    images = images.astype("float32") / 127.5 - 1.0
    return images, labels.astype("int64")


def _synthetic(n, seed_name):
    rs = common.rng_for(seed_name)
    # class templates: 10 fixed random blobs, low-pass filtered; samples
    # are jittered templates -> linearly separable enough to learn.
    # Templates come from a split-independent seed so train and test
    # draw from the SAME class distributions.
    templates = common.rng_for("mnist-templates").randn(
        10, 28, 28).astype("f4")
    k = np.ones((5, 5), "f4") / 25.0
    from numpy.lib.stride_tricks import sliding_window_view
    smoothed = []
    for t in templates:
        p = np.pad(t, 2, mode="edge")
        smoothed.append(
            sliding_window_view(p, (5, 5)).reshape(28, 28, 25) @ k.ravel())
    templates = np.stack(smoothed) * 3.0
    labels = rs.randint(0, 10, (n,)).astype("int64")
    noise = rs.randn(n, 28, 28).astype("f4") * 0.35
    images = np.tanh(templates[labels] + noise).reshape(n, 784)
    return images.astype("f4"), labels


def _reader(images, labels):
    def creator():
        for img, lab in zip(images, labels):
            yield img, int(lab)
    return creator


def _load(split):
    img_f = common.data_path("mnist", f"{split}-images-idx3-ubyte.gz")
    lab_f = common.data_path("mnist", f"{split}-labels-idx1-ubyte.gz")
    if os.path.exists(img_f) and os.path.exists(lab_f):
        return _parse_idx(img_f, lab_f)
    n = TRAIN_N if split == "train" else TEST_N
    return _synthetic(n, f"mnist-{split}")


def train():
    """Reader creator: yields (image [784] float32 in [-1,1], label int)."""
    return _reader(*_load("train"))


def test():
    return _reader(*_load("t10k" if common.has_real(
        "mnist", "t10k-images-idx3-ubyte.gz") else "test"))


def train_arrays():
    """Whole split as arrays (fast path for the native batcher)."""
    return _load("train")


def test_arrays():
    return _load("t10k" if common.has_real(
        "mnist", "t10k-images-idx3-ubyte.gz") else "test")


def fetch():
    _load("train")
