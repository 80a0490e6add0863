"""paddle_tpu_torch.dataset.flowers — counterpart of
``paddle_tpu/dataset/flowers.py`` (Oxford-102 flowers, Paddle's
``dataset/flowers.py``, 102 classes). Synthetic fallback: small
class-structured RGB images in the reference's (chw float32, label)
format (sized for model smoke tests rather than 224² realism)."""
from __future__ import annotations

import numpy as np

from . import common

NUM_CLASSES = 102
TRAIN_N = 1020
TEST_N = 204
SIZE = 32  # synthetic images are 3xSIZExSIZE


def _samples(n, seed_name):
    rs = common.rng_for(seed_name)
    trs = common.rng_for("flowers-templates")  # shared across splits
    base = trs.rand(NUM_CLASSES, 3, 1, 1).astype("f4")
    pattern = trs.rand(NUM_CLASSES, 3, SIZE, SIZE).astype("f4") * 0.4
    labels = rs.randint(0, NUM_CLASSES, (n,)).astype("int64")
    noise = rs.rand(n, 3, SIZE, SIZE).astype("f4") * 0.2
    imgs = np.clip(base[labels] * 0.5 + pattern[labels] + noise, 0, 1)
    return imgs.astype("f4"), labels


def _reader(images, labels):
    def creator():
        for img, lab in zip(images, labels):
            yield img, int(lab)
    return creator


def train(mapper=None, buffered_size=1024, use_xmap=False):
    return _reader(*_samples(TRAIN_N, "flowers-train"))


def test(mapper=None, buffered_size=1024, use_xmap=False):
    return _reader(*_samples(TEST_N, "flowers-test"))


def valid(mapper=None, buffered_size=1024, use_xmap=False):
    return _reader(*_samples(TEST_N, "flowers-valid"))


def fetch():
    pass
