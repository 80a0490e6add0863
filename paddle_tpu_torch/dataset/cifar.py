"""paddle_tpu_torch.dataset.cifar — counterpart of
``paddle_tpu/dataset/cifar.py`` (CIFAR-10/100, Paddle's
``dataset/cifar.py``: pickled batches yielding (image[3072] float32 in
[0, 1], label)), and its ``train_arrays``.

Real python-pickle tarballs under DATA_HOME/cifar are used when present;
otherwise synthetic class-colored images (same 3×32×32 flat format)."""
from __future__ import annotations

import os
import pickle
import tarfile

import numpy as np

from . import common

TRAIN_N = 4000
TEST_N = 800


def _synthetic(n, num_classes, seed_name):
    rs = common.rng_for(seed_name)
    # class templates from a split-independent seed (train and test must
    # share class distributions)
    trs = common.rng_for(f"cifar{num_classes}-templates")
    base = trs.rand(num_classes, 3, 1, 1).astype("f4")
    pattern = trs.rand(num_classes, 3, 32, 32).astype("f4") * 0.3
    labels = rs.randint(0, num_classes, (n,)).astype("int64")
    noise = rs.rand(n, 3, 32, 32).astype("f4") * 0.25
    imgs = np.clip(base[labels] * 0.6 + pattern[labels] + noise, 0, 1)
    return imgs.reshape(n, 3072).astype("f4"), labels


def _from_tar(path, key_prefix, num_classes):
    images, labels = [], []
    with tarfile.open(path) as tf:
        for m in tf.getmembers():
            if key_prefix in m.name and m.isfile():
                d = pickle.load(tf.extractfile(m), encoding="bytes")
                images.append(np.asarray(d[b"data"], "f4") / 255.0)
                labs = d.get(b"labels", d.get(b"fine_labels"))
                labels.append(np.asarray(labs, "int64"))
    return np.concatenate(images), np.concatenate(labels)


def _load(num_classes, split):
    tar = common.data_path(
        "cifar", f"cifar-{num_classes}-python.tar.gz")
    if os.path.exists(tar):
        prefix = "test" if split == "test" else ("data_batch"
                                                 if num_classes == 10
                                                 else "train")
        return _from_tar(tar, prefix, num_classes)
    n = TRAIN_N if split == "train" else TEST_N
    return _synthetic(n, num_classes, f"cifar{num_classes}-{split}")


def _reader(images, labels):
    def creator():
        for img, lab in zip(images, labels):
            yield img, int(lab)
    return creator


def train10():
    return _reader(*_load(10, "train"))


def test10():
    return _reader(*_load(10, "test"))


def train100():
    return _reader(*_load(100, "train"))


def test100():
    return _reader(*_load(100, "test"))


def train_arrays(num_classes=10):
    return _load(num_classes, "train")


def fetch():
    _load(10, "train")
