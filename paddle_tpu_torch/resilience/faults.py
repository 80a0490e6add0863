"""paddle_tpu_torch.resilience.faults — deterministic fault injection.

Counterpart of ``paddle_tpu/resilience/faults.py``: a process-global
registry of fault specs, each firing at exact step numbers or with a
seeded per-spec probability, with a bounded fire count. The injection
sites sit inside the code paths the faults simulate, so recovery is
exercised end to end.

The kinds the port's sites fire (the registry itself is string-keyed and
open):

* ``replica_error``   — raise inside one serving replica's batch
                        execution or decode tick (default: a transient
                        error; the breaker must absorb it)
* ``replica_hang``    — sleep ``delay`` (default 30 s) at the same site:
                        the supervisor must trip the breaker and move the
                        replica's work
* ``replica_slow``    — sleep ``delay`` at the same site (a straggler;
                        hedging's food)
* ``preempt_replica`` — a scheduler's preemption notice for one serving
                        replica, fired in the supervisor's tick: the
                        replica drains and its work migrates
* ``publish_corrupt`` — garble a published checkpoint before a weight
                        swap reads it (the checkpoint source itself is
                        not ported yet: ROADMAP.md Queue A item 19)

The training kinds (``loader``, ``nan_grad``, ``slow_step``, ``preempt``,
``shard_corrupt``, ``shard_slow_write``, ``host_loss``) register and fire
the same way; their sites come with the training loops that hold them.

Serving faults target replicas, not steps: ``replica=1`` (or a list) makes
a spec fire only for that replica id. Every site is behind
:func:`enabled`, so an empty registry costs one truthiness check.

Specs can also come from the environment:
``PADDLE_TPU_TORCH_FAULTS='[{"kind":"replica_error","replica":0}]'`` (a
JSON list of :func:`inject` keyword dicts) is loaded when
``paddle_tpu_torch.resilience`` is first imported. The reference's
``PADDLE_TPU_FAULTS`` never touches the port.
"""
from __future__ import annotations

import json
import os
import random
import threading
import time

from ._common import record
from .retry import TransientError


class HostLossError(RuntimeError):
    """A (simulated) host dropped out mid-run; ``lost`` is how many
    devices went with it."""

    def __init__(self, msg="host lost", lost=1):
        super().__init__(msg)
        self.lost = int(lost)


class FaultSpec:
    """One injected fault: where it fires (exact steps and/or a seeded
    probability, a replica or replicas, a site label), how often (the
    ``times`` budget), and what it does (raise ``exc``, sleep ``delay``,
    or drop ``lost`` devices for ``host_loss``)."""

    def __init__(self, kind, step=None, probability=1.0, times=1,
                 exc=None, delay=0.0, seed=0, lost=1, replica=None,
                 site=None):
        self.kind = kind
        self.lost = int(lost)
        # replica ids repeat across the pools of a disaggregated
        # topology: a spec may also require the site's pool label
        self.site = site
        if step is None:
            self.steps = None
        elif isinstance(step, (list, tuple, set, frozenset)):
            self.steps = frozenset(int(s) for s in step)
        else:
            self.steps = frozenset((int(step),))
        if replica is None:
            self.replicas = None
        elif isinstance(replica, (list, tuple, set, frozenset)):
            self.replicas = frozenset(int(r) for r in replica)
        else:
            self.replicas = frozenset((int(replica),))
        self.probability = float(probability)
        self.times = None if times is None else int(times)
        self.exc = exc
        self.delay = float(delay)
        self._rng = random.Random(seed)
        self.fired = 0

    def should_fire(self, step, replica=None, site=None):
        if self.times is not None and self.fired >= self.times:
            return False
        if self.steps is not None and (
                step is None or int(step) not in self.steps):
            return False
        if self.replicas is not None and (
                replica is None or int(replica) not in self.replicas):
            return False
        if self.site is not None and site != self.site:
            return False
        if self.probability >= 1.0:
            return True
        return self._rng.random() < self.probability

    def make_exc(self):
        e = self.exc
        if e is None:
            if self.kind == "host_loss":
                return HostLossError(
                    f"injected host_loss fault (fire #{self.fired}, "
                    f"lost={self.lost})", lost=self.lost)
            return TransientError(
                f"injected {self.kind} fault (fire #{self.fired})")
        if isinstance(e, type):
            return e(f"injected {self.kind} fault")
        if callable(e):
            return e()
        return e


_lock = threading.Lock()
_specs = {}   # kind -> [FaultSpec]


def inject(kind, step=None, probability=1.0, times=1, exc=None,
           delay=0.0, seed=0, lost=1, replica=None, site=None):
    """Register a fault. Returns the spec (its ``.fired`` counter is the
    evidence that the injection happened)."""
    spec = FaultSpec(kind, step=step, probability=probability, times=times,
                     exc=exc, delay=delay, seed=seed, lost=lost,
                     replica=replica, site=site)
    with _lock:
        _specs.setdefault(kind, []).append(spec)
    return spec


def clear(kind=None):
    """Drop all specs (or one kind's)."""
    with _lock:
        if kind is None:
            _specs.clear()
        else:
            _specs.pop(kind, None)


def enabled():
    """True when any fault is registered: the one check hot paths pay."""
    return bool(_specs)


def fire(kind, step=None, replica=None, site=None):
    """Consume one firing of ``kind`` at ``step`` if a spec matches.
    Returns the spec (or None). Records ``resilience.fault_injected``."""
    specs = _specs.get(kind)
    if not specs:
        return None
    with _lock:
        for spec in specs:
            if spec.should_fire(step, replica=replica, site=site):
                spec.fired += 1
                record("fault_injected", fault=kind, step=step,
                       replica=replica, fire=spec.fired)
                return spec
    return None


def maybe_raise(kind, step=None, replica=None):
    """Raise the spec's exception if a ``kind`` fault fires at ``step``."""
    spec = fire(kind, step, replica=replica)
    if spec is not None:
        raise spec.make_exc()


def maybe_sleep(kind, step=None, replica=None):
    """Sleep the spec's ``delay`` if a ``kind`` fault fires at ``step``.
    Returns True when a spec fired."""
    spec = fire(kind, step, replica=replica)
    if spec is not None and spec.delay > 0:
        time.sleep(spec.delay)
        return True
    return spec is not None


def maybe_serving_fault(replica, step=None, site=None):
    """The one injection site inside a serving replica's execution:
    ``replica_error`` raises, ``replica_hang`` sleeps a long default (30
    s, so that only supervision resolves it), ``replica_slow`` sleeps its
    ``delay``. ``site`` names the pool in a disaggregated topology."""
    spec = fire("replica_error", step, replica=replica, site=site)
    if spec is not None:
        raise spec.make_exc()
    spec = fire("replica_hang", step, replica=replica, site=site)
    if spec is not None:
        time.sleep(spec.delay if spec.delay > 0 else 30.0)
    spec = fire("replica_slow", step, replica=replica, site=site)
    if spec is not None and spec.delay > 0:
        time.sleep(spec.delay)


def garble_file(path, nbytes=16, seed=0):
    """Deterministically corrupt ``nbytes`` of ``path`` in place (XOR with
    a seeded byte stream at a seeded offset); the file's size never
    changes, so only checksums can catch it."""
    size = os.path.getsize(path)
    if size == 0:
        with open(path, "wb") as f:
            f.write(b"\xff")
        return
    rng = random.Random(seed)
    n = min(int(nbytes), size)
    off = rng.randrange(0, size - n + 1)
    with open(path, "r+b") as f:
        f.seek(off)
        chunk = f.read(n)
        garbled = bytes(b ^ (rng.randrange(1, 256)) for b in chunk)
        f.seek(off)
        f.write(garbled)
        f.flush()
        os.fsync(f.fileno())


def load_env(var="PADDLE_TPU_TORCH_FAULTS"):
    """Load a JSON list of :func:`inject` keyword dicts from the
    environment. Returns the created specs."""
    raw = os.environ.get(var, "")
    if not raw:
        return []
    out = []
    for entry in json.loads(raw):
        kw = dict(entry)
        out.append(inject(kw.pop("kind"), **kw))
    return out
