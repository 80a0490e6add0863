"""paddle_tpu_torch.dataset.common — the dataset cache and the synthetic
fallback.

Counterpart of ``paddle_tpu/dataset/common.py``, the same rule: a dataset
module first looks for the real files under ``DATA_HOME``
(``$PADDLE_TPU_TORCH_DATA_HOME``, by default the reference's own
``~/.cache/paddle_tpu/dataset``, so that files placed for one package
serve both) and otherwise generates a deterministic synthetic corpus with
the real dataset's sample format (shapes, dtypes, label ranges), drawn
from :func:`rng_for` exactly as the reference draws it. Nothing is
downloaded: :func:`download` returns a cached file or raises.
"""
from __future__ import annotations

import hashlib
import os

import numpy as np

DATA_HOME = os.path.expanduser(
    os.environ.get("PADDLE_TPU_TORCH_DATA_HOME",
                   "~/.cache/paddle_tpu/dataset"))


def data_path(*parts):
    return os.path.join(DATA_HOME, *parts)


def has_real(*parts):
    return os.path.exists(data_path(*parts))


def md5file(fname):
    h = hashlib.md5()
    with open(fname, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def download(url, module_name, md5sum, save_name=None):
    """The reference's signature. Returns the cached path if present;
    raises otherwise: nothing is downloaded."""
    fname = data_path(module_name,
                      save_name or url.split("/")[-1])
    if os.path.exists(fname) and (md5sum is None or
                                  md5file(fname) == md5sum):
        return fname
    raise RuntimeError(
        f"dataset file {fname} not cached, and nothing is downloaded; "
        f"place the file there (source: {url}) or use the synthetic "
        f"readers")


def rng_for(name):
    """Deterministic per-dataset generator for synthetic fallbacks."""
    seed = int.from_bytes(hashlib.sha256(name.encode()).digest()[:4],
                          "little")
    return np.random.RandomState(seed)


def split(reader, line_count, suffix="%05d.pickle", dumper=None):
    """The reference's ``split`` — dump a reader's samples into
    line_count-sized pickle files; returns the file list."""
    import pickle
    dumper = dumper or pickle.dump
    indx_f = 0
    files = []
    lines = []
    for d in reader():
        lines.append(d)
        if len(lines) == line_count:
            filename = suffix % indx_f
            with open(filename, "wb") as f:
                dumper(lines, f)
            files.append(filename)
            indx_f += 1
            lines = []
    if lines:
        filename = suffix % indx_f
        with open(filename, "wb") as f:
            dumper(lines, f)
        files.append(filename)
    return files


def cluster_files_reader(files_pattern, trainer_count, trainer_id,
                         loader=None):
    """The reference's ``cluster_files_reader`` — each trainer reads
    its modulo-slice of the sorted file list."""
    import glob
    import pickle
    loader = loader or pickle.load

    def reader():
        if not callable(loader):
            raise TypeError("loader should be callable.")
        file_list = sorted(glob.glob(files_pattern))
        my_files = [fn for idx, fn in enumerate(file_list)
                    if idx % trainer_count == trainer_id]
        for fn in my_files:
            with open(fn, "rb") as f:
                for line in loader(f):
                    yield line

    return reader
