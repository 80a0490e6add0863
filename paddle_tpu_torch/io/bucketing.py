"""paddle_tpu_torch.io.bucketing — pad ragged batches up to a closed set of
sizes, and slice them back.

Counterpart of ``next_bucket``, ``grow_buckets``, ``pad_to_bucket``,
``batch_mask``, ``unpad`` and ``split_rows`` in
``paddle_tpu/io/bucketing.py``, on numpy
arrays and ``torch.Tensor`` alike. Padding repeats the last real row by default
(``mode="zeros"`` zero-fills). On the card a fixed set of batch shapes
means the warmed-up shapes are the only ones traffic meets.
"""
from __future__ import annotations

import numpy as np
import torch


def next_bucket(n, buckets=None):
    """Smallest bucket >= n: powers of two with ``buckets=None``, else the
    smallest listed bucket that fits (exact ``n`` past the largest)."""
    n = int(n)
    if n <= 0:
        return n
    if buckets:
        for b in sorted(int(b) for b in buckets):
            if b >= n:
                return b
        return n
    b = 1
    while b < n:
        b <<= 1
    return b


def grow_buckets(base, factor=2.0, cap=None):
    """A geometric family of sequence-length buckets: ``base``, then each
    next ``ceil(prev * factor)`` (strictly increasing), up to the first
    bucket >= ``cap``. A tuple, so the family is a stable, hashable key:
    the KV-cache pool's capacity moves only along it, and every shape it
    can take is known before traffic arrives."""
    base = int(base)
    if base < 1:
        raise ValueError(f"grow_buckets: base must be >= 1, got {base}")
    factor = float(factor)
    if factor <= 1.0:
        raise ValueError(
            f"grow_buckets: factor must be > 1, got {factor}")
    if cap is None:
        raise ValueError("grow_buckets: cap is required")
    cap = int(cap)
    if cap < base:
        raise ValueError(
            f"grow_buckets: cap {cap} is below base {base}")
    out = [base]
    while out[-1] < cap:
        out.append(max(int(np.ceil(out[-1] * factor)), out[-1] + 1))
    return tuple(out)


def pad_to_bucket(array, target, axis=0, mode="repeat"):
    """Pad ``array`` (numpy or torch) along ``axis`` up to ``target``
    rows; no-op at exact size."""
    n = array.shape[axis]
    if n == target:
        return array
    if n > target:
        raise ValueError(f"pad_to_bucket: size {n} exceeds bucket {target} "
                         f"on axis {axis}")
    pad = target - n
    is_torch = isinstance(array, torch.Tensor)
    if mode == "repeat":
        idx = [slice(None)] * array.ndim
        idx[axis] = slice(n - 1, n)
        reps = [1] * array.ndim
        reps[axis] = pad
        last = array[tuple(idx)]
        fill = last.repeat(*reps) if is_torch else np.tile(last, reps)
    elif mode == "zeros":
        shape = list(array.shape)
        shape[axis] = pad
        fill = (array.new_zeros(shape) if is_torch
                else np.zeros(shape, dtype=array.dtype))
    else:
        raise ValueError(f"pad_to_bucket: unknown mode {mode!r} "
                         "(use 'repeat' or 'zeros')")
    if is_torch:
        return torch.cat([array, fill], dim=axis)
    return np.concatenate([array, fill], axis=axis)


def batch_mask(real_n, padded_n, dtype="float32"):
    """A ``(padded_n,)`` numpy 0/1 mask, 1 for the real rows: its mean is
    a padded batch's occupancy (``serving.metrics.record_batch``)."""
    m = np.zeros((int(padded_n),), dtype=dtype)
    m[:int(real_n)] = 1
    return m


def unpad(array, real_n, axis=0):
    """The first ``real_n`` rows along ``axis`` (no-op when already that
    long or without a batch dim)."""
    if real_n is None or getattr(array, "ndim", 0) < 1:
        return array
    if array.shape[axis] <= int(real_n):
        return array
    idx = [slice(None)] * array.ndim
    idx[axis] = slice(0, int(real_n))
    return array[tuple(idx)]


def split_rows(array, sizes, axis=0):
    """Split the leading real rows back into per-request chunks of
    ``sizes`` rows; pad rows past ``sum(sizes)`` are dropped."""
    out = []
    off = 0
    for n in sizes:
        n = int(n)
        idx = [slice(None)] * array.ndim
        idx[axis] = slice(off, off + n)
        out.append(array[tuple(idx)])
        off += n
    if off > array.shape[axis]:
        raise ValueError(f"split_rows: sizes sum to {off} but axis {axis} "
                         f"has only {array.shape[axis]} rows")
    return out
