"""paddle_tpu_torch.parallel.planner — the interconnect's bandwidth, for
the comm model.

Counterpart of ``paddle_tpu/parallel/planner.py``'s ``link_bandwidth``
alone (the mesh planner is ROADMAP.md Queue A item 19). The disaggregated
server (``serving/disagg.py``) prices a prefill-to-decode KV hand-off as
``bytes / link_bandwidth()``. In the port a hand-off crosses the host: the
prefill engine copies a segment off the card into numpy, and the decode
engine copies it back onto a card. So the default on a card is that round
trip's measured rate, not an interconnect's datasheet figure.
"""
from __future__ import annotations

import os
import threading
import time

import torch

#: the environment variable that sets the link's rate, in GB/s (the port's
#: prefix, as ``monitor.env`` reads the port's variables)
ENV = "PADDLE_TPU_TORCH_LINK_GBPS"
#: bytes/s of a hand-off between CPU devices: a host ``memcpy`` (the
#: reference's own CPU figure, so both packages price a hand-off alike)
CPU_LINK_BPS = 8e9
#: bytes a measurement moves each way
MEASURE_BYTES = 64 << 20
MEASURE_REPEATS = 3

_measured = {}
_lock = threading.Lock()


def link_bandwidth(link_gbps=None, device=None):
    """Bandwidth, in bytes/s, of the link a KV hand-off crosses. In order:
    ``link_gbps`` (GB/s), then the environment variable :data:`ENV`
    (GB/s), then the default of ``device``'s kind (default: the first CUDA
    card where there is one, else the CPU): :data:`CPU_LINK_BPS` for the
    CPU, and for a card its host round trip, measured once a process
    (:func:`measure_host_round_trip`)."""
    if link_gbps is not None:
        return float(link_gbps) * 1e9
    env = os.environ.get(ENV)
    if env:
        return float(env) * 1e9
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type != "cuda":
        return CPU_LINK_BPS
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    with _lock:
        if dev not in _measured:
            _measured[dev] = measure_host_round_trip(dev)
        return _measured[dev]


def measure_host_round_trip(device, nbytes=MEASURE_BYTES,
                            repeats=MEASURE_REPEATS):
    """The rate, in bytes/s, at which a buffer of ``nbytes`` crosses the
    host as a hand-off's segment does: copied off the card ``device`` into
    pageable host memory, then back onto it, the bytes over the sum of the
    two copies' times (each timed to the card's completion; the median of
    ``repeats`` round trips, after one that warms both ends)."""
    dev = torch.device(device)
    src = torch.empty((nbytes,), dtype=torch.uint8, device=dev)
    src.fill_(1)
    back = torch.empty_like(src)
    rates = []
    for i in range(repeats + 1):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        host = src.cpu()
        t1 = time.perf_counter()
        back.copy_(host)
        torch.cuda.synchronize(dev)
        t2 = time.perf_counter()
        if i:
            rates.append(nbytes / ((t1 - t0) + (t2 - t1)))
    return sorted(rates)[len(rates) // 2]


__all__ = ["link_bandwidth", "measure_host_round_trip", "CPU_LINK_BPS",
           "ENV"]
