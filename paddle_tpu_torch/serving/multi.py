"""paddle_tpu_torch.serving.multi — self-healing data-parallel replica
fan-out.

Counterpart of ``paddle_tpu/serving/multi.py``. A serving host runs N
independent replicas, not one sharded model: each replica holds its own
copy of the weights on its device (:func:`replicate`), runs its own
dynamic batcher, and the front door spreads requests across them. There
are no collectives on the request path. ``devices`` may name one card
more than once: the replicas then share it, each with its own weights,
its own engine thread and its own queue (on the card they share its
default stream and its streaming multiprocessors).

Routing is **health-aware**:

* each replica carries a :class:`~paddle_tpu_torch.serving.breaker.
  CircuitBreaker` fed by batch outcomes and supervision verdicts;
  requests route only to replicas whose breaker allows them, and a
  fleet with no healthy replica fast-rejects with the retryable
  :class:`NoHealthyReplicaError` rather than queueing onto a corpse;
* a :class:`~paddle_tpu_torch.serving.supervisor.ServingSupervisor`
  watches per-replica heartbeats, trips the breaker on a hung dispatch,
  moves that replica's queued *and* in-flight requests to healthy peers
  (failover — safe because request resolution is idempotent: whichever
  dispatch finishes first wins, the loser's resolution is swallowed),
  probes half-open breakers with budgeted test traffic, restarts
  replicas that stay dead, and scales the active set from the live
  ``slo.*`` window;
* stragglers are **hedged**: a request still unresolved after the hedge
  delay (p99-derived by default) is re-dispatched to a second healthy
  replica and the first result wins, with total hedges capped at
  ``hedge_budget`` of traffic.

The fleet has a *lifecycle*: scheduler preemption (SIGTERM, or the
injected ``preempt_replica`` fault) flips a replica to **draining** —
healthy but refusing new work — and migrates its queued and in-flight
requests to peers over the same ``disown_inflight``/``requeue`` path
failover uses, so a preemption loses no request and sampled streams
regenerate as they were. :meth:`MultiDeviceEngine.swap_weights` rolls
new weights through the fleet one replica at a time (drain-lite → copy
the state in → probe → readmit) without dropping a request. Every fleet
subscribes itself to ``resilience.preempt`` at construction: a
process-level SIGTERM drains every live fleet.

Not ported: a swap from a sharded checkpoint (``io.sharded``, ROADMAP.md
Queue A item 19) and the ``/healthz`` endpoint and sampler (item 20),
whose payload :func:`health` and :func:`publish_gauges` produce.
"""
from __future__ import annotations

import concurrent.futures
import copy
import heapq
import os
import threading
import time
import weakref

import numpy as np
import torch

from .. import device as _device
from ..resilience import preempt as _preempt
from . import metrics
from .admission import ShedError
from .batcher import Request
from .breaker import CircuitBreaker
from .engine import ServingEngine

#: live MultiDeviceEngines — /healthz walks this (weak: an un-closed
#: engine can still be collected)
_ACTIVE = weakref.WeakSet()

#: most recent lifecycle event across all fleets (the /snapshot block)
_LAST_LIFECYCLE = None


def last_lifecycle():
    return _LAST_LIFECYCLE

#: floor on the auto hedge delay: below this, hedges fire on normal
#: scheduling jitter and burn the budget on non-stragglers
MIN_HEDGE_S = 0.025


class NoHealthyReplicaError(ShedError):
    """Every replica's breaker is open (or routing-excluded): there is
    no capacity to take this request right now. Transient — the breaker
    cooldown is exactly a retry-after."""


def fleet_devices(devices=None):
    """The devices a fleet spans: ``devices`` resolved (a list may name
    one device more than once), or every CUDA card torch sees. Raises
    ``RuntimeError`` when the default finds no card, and ``ValueError``
    on an empty list: a fleet never falls back to the CPU."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if not n:
            raise RuntimeError(
                "a serving fleet spans the CUDA cards by default and none "
                "is available; pass devices=['cpu', ...] to run on the CPU")
        return [torch.device("cuda", i) for i in range(n)]
    out = []
    for d in devices:
        d = _device.resolve(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        out.append(d)
    if not out:
        raise ValueError("replicate: no devices")
    return out


def _state_of(obj):
    """A replica's weights as ``{name: tensor}``, views of its own (a
    ``Predictor``'s model, or a decode model's ``state``)."""
    return dict(obj.state)


def _place_state(state, tree):
    """Copy ``tree`` ({name: tensor or array}) into the tensors of
    ``state`` ({name: tensor}), in place, each cast to its tensor's dtype
    on its device. Only for weights that serve no call yet."""
    with torch.no_grad():
        for name, t in state.items():
            v = tree[name]
            if not isinstance(v, torch.Tensor):
                v = torch.from_numpy(np.array(v, copy=True))
            t.copy_(v.to(device=t.device, dtype=t.dtype))


def _fresh_copy(module, tree):
    """A copy of a serving module that holds ``tree``'s weights, built
    beside it: the module that serves is never written, so a call that
    has begun on it ends on its weights, whole."""
    fresh = copy.deepcopy(module)
    _place_state(dict(fresh.state_dict()), tree)
    return fresh


def replicate(predictor, devices=None):
    """One ``Predictor`` a device, each over its own copy of the model on
    that device (so a rolling swap changes exactly one replica), with its
    own executables (graph entries). ``devices`` defaults to
    every CUDA card (:func:`fleet_devices`); naming one card twice puts
    two replicas on it."""
    replicas = []
    for d in fleet_devices(devices):
        p = copy.copy(predictor)
        p.model = copy.deepcopy(predictor.model).to(d)
        p.device = d
        p._fresh_executables()
        replicas.append(p)
    return replicas


class _Replica:
    """One slot in the fleet: device + predictor + engine + breaker +
    routing flag, plus the supervision tokens that make hang handling
    exactly-once per dispatch."""

    def __init__(self, index, device, predictor, engine, breaker,
                 active=True):
        self.index = index
        self.device = device
        self.predictor = predictor
        self.engine = engine
        self.breaker = breaker
        self.active = active
        # draining: healthy but refusing NEW work (preemption notice or
        # a rolling weight swap); distinct from an open breaker
        self.draining = False
        self.handled_token = None    # last in-flight dispatch failed over
        self.restart_token = None    # last in-flight dispatch restarted on
        self.restarts = 0

    @property
    def state(self):
        """Routing state for /healthz and the gauges: ``draining``
        masks the (healthy) breaker state while the replica refuses
        admission."""
        return "draining" if self.draining else self.breaker.state


class _Hedger(threading.Thread):
    """Deadline heap + daemon thread: ``schedule`` arms a hedge timer
    per request; when it fires and the request is still unresolved, the
    owner re-dispatches it to a second replica."""

    def __init__(self, owner):
        super().__init__(name="paddle_tpu_torch-serving-hedger", daemon=True)
        self._owner = weakref.ref(owner)
        self._cond = threading.Condition()
        self._heap = []
        self._seq = 0
        self._stop = False

    def schedule(self, request, primary_index, delay_s):
        with self._cond:
            self._seq += 1
            heapq.heappush(self._heap,
                           (time.monotonic() + delay_s, self._seq,
                            request, primary_index))
            self._cond.notify()

    def stop(self):
        with self._cond:
            self._stop = True
            self._cond.notify()

    def run(self):
        while True:
            with self._cond:
                if self._stop:
                    return
                if not self._heap:
                    self._cond.wait(0.1)
                    continue
                due = self._heap[0][0]
                now = time.monotonic()
                if due > now:
                    self._cond.wait(min(due - now, 0.1))
                    continue
                _, _, req, primary = heapq.heappop(self._heap)
            owner = self._owner()
            if owner is None:
                return
            try:
                owner._maybe_hedge(req, primary)
            except Exception:   # noqa: BLE001 - hedging is best-effort;
                pass            # the primary dispatch still owns the future


class MultiDeviceEngine:
    """Health-aware fan-out over per-device :class:`ServingEngine`
    replicas, with a ``ServingEngine``'s client surface (``submit``/
    ``run``/``warmup``/``stats``/context manager); engine kwargs apply
    per replica, so ``queue_depth`` and ``max_batch`` are per-replica
    limits. ``devices`` as :func:`fleet_devices` takes it.

    Resilience knobs:

    hedge_ms : straggler hedge delay. ``None`` (default) derives it
        from the live ``slo.p99_ms`` window (floored at 25ms); a number
        fixes it; ``0``/``False`` disables hedging.
    hedge_budget : max fraction of submitted traffic that may be
        hedged (default 0.05).
    breaker_threshold / breaker_cooldown_s / half_open_probes :
        per-replica :class:`CircuitBreaker` tuning.
    inflight_timeout_ms : a dispatch older than this is declared hung —
        breaker trips, batch fails over. ``None`` defaults to 4× the
        engine ``deadline_ms`` when set, else 2000ms.
    supervise : run the :class:`ServingSupervisor` control loop
        (default True; tests drive ticks manually with False).
    min_replicas / initial_active : scaling bounds — the supervisor
        never deactivates below ``min_replicas``; ``initial_active``
        starts the fleet smaller than the device count and lets the
        goodput floor scale it up.
    """

    def __init__(self, predictor, devices=None, hedge_ms=None,
                 hedge_budget=0.05, breaker_threshold=3,
                 breaker_cooldown_s=2.0, half_open_probes=1,
                 inflight_timeout_ms=None, supervise=True,
                 supervisor_interval_s=0.25, min_replicas=1,
                 initial_active=None, restart_after_s=None,
                 tokens_floor=None, **engine_kwargs):
        self.predictor = predictor
        # the last swapped-in state: a restarted replica comes up on it
        self._swapped_state = None
        self._engine_kwargs = dict(engine_kwargs)
        self._breaker_kwargs = dict(
            failure_threshold=breaker_threshold,
            cooldown_s=breaker_cooldown_s,
            half_open_probes=half_open_probes)
        preds = self._replicate(predictor, devices)
        self._replicas = []
        for i, p in enumerate(preds):
            self._replicas.append(self._make_replica(i, p))
        if initial_active is not None:
            for r in self._replicas[int(initial_active):]:
                r.active = False
        self.min_replicas = max(1, int(min_replicas))
        self._rr_lock = threading.Lock()
        self._rr = 0
        # hedging
        if hedge_ms is None:
            self._hedge_fixed = None
            self._hedge_delay_s = 2 * MIN_HEDGE_S   # until p99 exists
        elif not hedge_ms:                          # 0 / False
            self._hedge_fixed = 0.0
            self._hedge_delay_s = 0.0
        else:
            self._hedge_fixed = float(hedge_ms) / 1e3
            self._hedge_delay_s = self._hedge_fixed
        self.hedge_budget = float(hedge_budget)
        self._hedge_lock = threading.Lock()
        self._submitted = 0
        self._hedged = 0
        self._hedge_wins = 0
        self._failovers = 0
        self._hedger = None
        if self._hedge_delay_s or self._hedge_fixed is None:
            self._hedger = _Hedger(self)
            self._hedger.start()
        # supervision
        if inflight_timeout_ms is None:
            dl = engine_kwargs.get("deadline_ms")
            inflight_timeout_ms = 4 * dl if dl else 2000.0
        self.inflight_timeout_s = float(inflight_timeout_ms) / 1e3
        self._warm_sigs = ()
        self.supervisor = None
        if supervise:
            from .supervisor import ServingSupervisor
            self.supervisor = ServingSupervisor(
                self, interval_s=supervisor_interval_s,
                restart_after_s=restart_after_s,
                tokens_floor=tokens_floor)
        # lifecycle: served weights version (stamped into reqtrace
        # records), the fleet's last lifecycle event, and the process
        # preemption subscription — SIGTERM drains this fleet; the
        # subscription holds the fleet weakly so an un-closed engine
        # can still be collected
        self.weights_version = 0
        for r in self._replicas:
            r.engine.weights_version = 0
        self._lifecycle = None
        self._swap_lock = threading.Lock()
        _self_ref = weakref.ref(self)

        def _on_preempt(signum, _ref=_self_ref):
            owner = _ref()
            if owner is not None:
                owner.drain_fleet(reason=f"preempt:{signum}")

        self._preempt_cb = _preempt.subscribe(_on_preempt)
        _ACTIVE.add(self)
        metrics.record_active_replicas(
            sum(1 for r in self._replicas if r.active))

    # -- replica construction hooks (overridden by the decode fleet) -------

    def _replicate(self, predictor, devices):
        """State mechanic: one predictor view per device. The decode
        fleet (``generate.MultiDecodeEngine``) overrides this with
        ``replicate_decode`` — same fan-out spine, different payload."""
        return replicate(predictor, devices)

    def _new_engine(self, predictor, index, on_outcome):
        """Per-replica engine factory — the other decode-fleet seam."""
        return ServingEngine(predictor, replica_id=index,
                             on_outcome=on_outcome, **self._engine_kwargs)

    def _make_replica(self, index, predictor):
        breaker = CircuitBreaker(name=str(index), **self._breaker_kwargs)

        def _outcome(ok, exc, _b=breaker):
            if ok:
                _b.record_success()
            else:
                _b.record_failure(repr(exc))

        engine = self._new_engine(predictor, index, _outcome)
        return _Replica(index, getattr(predictor, "device", None),
                        predictor, engine, breaker)

    # -- compat views ------------------------------------------------------

    @property
    def engines(self):
        return [r.engine for r in self._replicas]

    @property
    def replicas(self):
        return [r.predictor for r in self._replicas]

    # -- routing -----------------------------------------------------------

    def _pick_replica(self, exclude=()):
        """Next active replica whose breaker admits traffic, round-robin
        from the cursor. ``allow()`` on a half-open breaker consumes one
        probe slot — it's only called on replicas actually considered.
        Raises :class:`NoHealthyReplicaError` when nobody can take it."""
        with self._rr_lock:
            n = len(self._replicas)
            order = [(self._rr + k) % n for k in range(n)]
            self._rr = (self._rr + 1) % n
        for idx in order:
            r = self._replicas[idx]
            if not r.active or r.draining or idx in exclude:
                continue
            if r.breaker.allow():
                return r
        states = {r.index: r.state for r in self._replicas}
        raise NoHealthyReplicaError(
            f"no healthy replica (breakers: {states}); retry after "
            f"{self._breaker_kwargs['cooldown_s'] * 1e3:.0f}ms",
            retry_after_ms=self._breaker_kwargs["cooldown_s"] * 1e3,
            level=3)

    def submit(self, *inputs, deadline_ms=None, priority=None,
               trace=None):
        rep = self._pick_replica()
        return self._dispatch(rep, rep.engine.make_request(
            inputs, deadline_ms=deadline_ms, priority=priority, trace=trace))

    def _dispatch(self, rep, req):
        """Enqueue ``req`` on ``rep``, count it, and arm its hedge timer;
        returns its future."""
        fut = rep.engine.submit_request(req)
        with self._hedge_lock:
            self._submitted += 1
        delay = self._hedge_delay_s
        if self._hedger is not None and delay and len(self._replicas) > 1:
            self._hedger.schedule(req, rep.index, delay)
        return fut

    def run(self, *inputs, deadline_ms=None, timeout=None, priority=None):
        return self.submit(*inputs, deadline_ms=deadline_ms,
                           priority=priority).result(timeout)

    # -- hedging -----------------------------------------------------------

    def _maybe_hedge(self, req, primary_index):
        """Hedge timer fired: if the request is still unresolved and the
        budget allows, re-dispatch it to a different healthy replica and
        let the first resolution win."""
        if req.future.done():
            return
        with self._hedge_lock:
            if self._hedged >= self.hedge_budget * self._submitted:
                return
            self._hedged += 1
        try:
            rep = self._pick_replica(exclude=(primary_index,))
        except NoHealthyReplicaError:
            with self._hedge_lock:
                self._hedged -= 1   # unfired: give the budget back
            return
        ptr = req.trace
        # the shadow rides the SAME trace context as a hedge attempt:
        # whichever resolution wins the shared done-latch emits the one
        # record
        shadow = self._shadow(req, None if ptr is None else
                              ptr.ctx.attempt("hedge", rep.index))
        if ptr is not None:
            ptr.hop("hedge", replica=rep.index)
        metrics.record_hedge(replica=rep.index)

        def _on_shadow_done(sf, _req=req, _idx=rep.index):
            if sf.cancelled() or sf.exception() is not None:
                return          # primary still owns the future
            try:
                _req.future.set_result(sf.result())
            except concurrent.futures.InvalidStateError:
                return          # primary won the race
            with self._hedge_lock:
                self._hedge_wins += 1
            metrics.record_hedge_win(replica=_idx)

        shadow.future.add_done_callback(_on_shadow_done)
        try:
            rep.engine.submit_request(shadow)
        except ShedError:
            with self._hedge_lock:
                self._hedged -= 1   # shadow shed at admission: not a hedge
        except RuntimeError:
            pass                    # replica closed under us

    @staticmethod
    def _shadow(req, trace):
        """A hedge's copy of ``req`` (the decode fleet's seam)."""
        return Request(req.inputs, req.n, req.signature,
                       deadline=req.deadline, priority=req.priority,
                       trace=trace)

    def _refresh_hedge_delay(self, p99_ms):
        """Supervisor tick: re-derive the auto hedge delay from the live
        p99 (a hedge should fire only for genuine stragglers)."""
        if self._hedge_fixed is not None:
            return
        if p99_ms:
            self._hedge_delay_s = max(MIN_HEDGE_S, float(p99_ms) / 1e3)

    # -- failover / drain / restart (supervisor verdicts) ------------------

    def _migrate(self, replica, hop, reason=""):
        """Move a replica's queued and in-flight requests to healthy
        peers (the shared spine under failover AND graceful drain). The
        in-flight group is *disowned* first, so even if the source
        dispatch eventually completes, whichever resolution lands first
        wins and the other is swallowed — exactly once, either way.
        Decode requests regenerate bit-identically on the adopting
        replica (counter-based sampling — see ``disown_inflight``)."""
        moved = self._disown(replica)
        moved += replica.engine.steal_pending()
        moved = [r for r in moved if not r.future.done()]
        if not moved:
            return 0
        for r in moved:
            tr = getattr(r, "trace", None)
            if tr is not None:
                tr.hop(hop, replica=replica.index, reason=reason)
        try:
            target = self._pick_replica(exclude=(replica.index,))
        except NoHealthyReplicaError as e:
            for r in moved:
                r.resolve_exception(e)
            return len(moved)
        target.engine.requeue(moved)
        return len(moved)

    def _disown(self, replica):
        """Seam: how in-flight work leaves a replica during migration.
        The disaggregated decode pool overrides this to carry each
        sequence's KV segment along (``disown_inflight(export_kv=True)``)
        so a drained sequence resumes mid-stream instead of
        re-prefilling."""
        return replica.engine.disown_inflight()

    def _failover(self, replica, reason=""):
        """Move a tripped replica's work to healthy peers and count it."""
        moved = self._migrate(replica, "failover", reason)
        if moved:
            with self._hedge_lock:
                self._failovers += 1
            metrics.record_failover(replica.index, moved)
        return moved

    # -- graceful drain (preemption / rolling swap) ------------------------

    def _record_lifecycle(self, event, **fields):
        global _LAST_LIFECYCLE
        entry = {"event": event, "t": time.time(), **fields}
        self._lifecycle = entry
        _LAST_LIFECYCLE = entry
        metrics.record_lifecycle(event, **fields)

    def _resolve_replica(self, replica):
        if isinstance(replica, _Replica):
            return replica
        return self._replicas[int(replica)]

    def _has_peer(self, exclude_index):
        """Is there anywhere for migrated work to land?"""
        return any(r.active and not r.draining
                   and r.breaker.state != "open"
                   and r.index != exclude_index for r in self._replicas)

    def drain_replica(self, replica, reason="preempt"):
        """Preemption notice for ONE replica: stop admitting, migrate
        its queued and in-flight work to healthy peers (zero lost
        requests — streams regenerate bit-identically). With no healthy
        peer the replica keeps its work and finishes it while refusing
        new admissions. Returns the number of requests migrated."""
        r = self._resolve_replica(replica)
        if r.draining:
            return 0
        r.draining = True
        moved = self._migrate(r, "drain", reason) \
            if self._has_peer(r.index) else 0
        self._record_lifecycle("drain", replica=r.index, reason=reason,
                               moved=moved)
        return moved

    def undrain_replica(self, replica, reason=""):
        """Readmit a drained replica into the rotation."""
        r = self._resolve_replica(replica)
        if not r.draining:
            return
        r.draining = False
        self._record_lifecycle("undrain", replica=r.index, reason=reason)

    def drain_fleet(self, reason="preempt"):
        """Process-level preemption notice (SIGTERM): EVERY replica
        stops admitting new work; queued and in-flight requests run to
        completion in place (there is no healthy peer to migrate to —
        the whole process is going away). Subsequent submits shed with
        :class:`NoHealthyReplicaError`. Poll :meth:`drained` / block on
        :meth:`drain_wait` before exiting."""
        flipped = [r.index for r in self._replicas if not r.draining]
        for r in self._replicas:
            r.draining = True
        self._record_lifecycle("drain_fleet", reason=reason,
                               replicas=len(flipped))
        return len(flipped)

    def drained(self, now=None):
        """True when no replica holds queued or in-flight work."""
        for r in self._replicas:
            h = r.engine.heartbeat(now)
            if h["queue_depth"] or h.get("active"):
                return False
        return True

    def drain_wait(self, timeout_s=10.0, poll_s=0.01):
        """Block until :meth:`drained` (or timeout); returns the final
        drained verdict."""
        deadline = time.monotonic() + float(timeout_s)
        while not self.drained():
            if time.monotonic() >= deadline:
                return False
            time.sleep(poll_s)
        return True

    # -- live weight hot-swap ----------------------------------------------

    def _serving_module(self, r):
        """The module whose weights replica ``r`` serves."""
        return r.predictor.model

    def _serve_module(self, r, module):
        """Serve ``module`` on replica ``r`` from its next call on: every
        signature the replica serves is captured over it first
        (``Predictor.prepare``), so that no call under traffic captures;
        then one assignment, read once at the start of each call."""
        r.predictor.prepare(module)
        r.predictor.model = module

    def _replica_empty(self, r, timeout_s, poll_s=0.005):
        """Wait until one replica holds no queued or in-flight work."""
        deadline = time.monotonic() + float(timeout_s)
        while True:
            h = r.engine.heartbeat()
            if not h["queue_depth"] and not h.get("active") \
                    and h["inflight_age_s"] is None:
                return True
            if time.monotonic() >= deadline:
                return False
            time.sleep(poll_s)

    def _resolve_swap_source(self, source, step):
        """Turn a swap source into a state tree: a live tree
        (``{name: tensor or array}``, e.g. a model's ``state_dict()`` or a
        ``Predictor.state``) is served as it is. A sharded checkpoint
        directory or a ``CheckpointManager`` (with ``step=``), which the
        reference reads through ``io.sharded`` after its quorum check,
        raises ``NotImplementedError``: ``io.sharded`` is not ported yet
        (ROADMAP.md Queue A item 19)."""
        if hasattr(source, "_sharded_path") or isinstance(
                source, (str, os.PathLike)):
            raise NotImplementedError(
                "swap_weights from a checkpoint: io.sharded is not ported "
                "yet (ROADMAP.md Queue A item 19); pass a live state tree")
        return source

    def _check_swap_shapes(self, new_tree):
        """Same-shape contract: the swap must meet no new signature, so
        the names and every tensor's shape must match the served
        state's."""
        old = _state_of(self._replicas[0].predictor)
        if set(old) != set(new_tree):
            return (f"tree structure mismatch: {sorted(new_tree)} != "
                    f"{sorted(old)}")
        for name, t in old.items():
            sa, sb = tuple(t.shape), tuple(np.shape(new_tree[name]))
            if sa != sb:
                return f"leaf {name} shape mismatch: {sb} != {sa}"
        return None

    def swap_weights(self, source, step=None, version=None, probe=True,
                     drain_timeout_s=10.0, probe_timeout_s=2.0):
        """Roll new weights through the live fleet, one replica at a
        time, without dropping a request or meeting a new signature.

        Per replica: drain-lite (stop admitting; migrate its queued +
        in-flight work to peers when any exist, else let it finish in
        place), build a copy of the replica's model on its device that
        holds the new state and bind it in one assignment (a call still
        running, where the drain timed out, ends whole on the old
        weights), half-open style :meth:`~ServingEngine.probe` with the
        fresh weights, then readmit. Each replica owns its copy, so
        exactly one replica changes at a time; the shapes are the served
        ones, so the warmed signatures serve on.

        ``source``: a live state tree (see :meth:`_resolve_swap_source`).
        ``version`` defaults to ``weights_version + 1``. On a probe
        failure the whole roll is unwound — the failing replica AND
        every already-swapped replica get their old state back — so the
        fleet is never left serving mixed weights. Returns the new
        version."""
        with self._swap_lock:
            state = self._resolve_swap_source(source, step)
            why = self._check_swap_shapes(state)
            if why is not None:
                self._record_lifecycle("swap_refused", why=why)
                raise ValueError(f"swap_weights: {why}")
            new_version = (int(version) if version is not None
                           else self.weights_version + 1)
            swapped = []   # (replica, old_module) — rollback ledger
            for r in self._replicas:
                was_draining = r.draining
                r.draining = True
                try:
                    if self._has_peer(r.index):
                        self._migrate(r, "swap", reason="hot_swap")
                    # a drain that times out leaves a call running: it
                    # ends on the module it began with, since the new
                    # weights go into a copy bound in one assignment
                    self._replica_empty(r, drain_timeout_s)
                    old_module = self._serving_module(r)
                    self._serve_module(r, _fresh_copy(old_module, state))
                    if probe:
                        ok = r.engine.probe(timeout_s=probe_timeout_s)
                        # None = never served, nothing to replay: pass
                        if ok is False:
                            # unwind the WHOLE roll: a half-swapped
                            # fleet serving mixed weights breaks the
                            # reproducibility contract
                            self._serve_module(r, old_module)
                            for rb, rb_old in swapped:
                                self._serve_module(rb, rb_old)
                                rb.engine.weights_version = \
                                    self.weights_version
                            self._record_lifecycle(
                                "swap_failed", replica=r.index,
                                version=new_version,
                                rolled_back=[x.index for x, _ in swapped])
                            raise RuntimeError(
                                f"swap_weights: probe failed on replica "
                                f"{r.index} with version {new_version}; "
                                f"the roll was unwound and the fleet "
                                f"keeps serving version "
                                f"{self.weights_version}")
                    r.engine.weights_version = new_version
                    swapped.append((r, old_module))
                finally:
                    r.draining = was_draining
            # a restarted replica must come up on the new version; the
            # caller's template object is never written
            self._swapped_state = state
            self.weights_version = new_version
            metrics.record_weights_version(new_version)
            self._record_lifecycle(
                "swap", version=new_version,
                source="tree", replicas=len(swapped))
            return new_version

    def _restart(self, replica):
        """Re-``replicate()`` state onto the replica's device, swap in a
        fresh engine (warmed with the remembered signatures), and close
        the old one in the background with a bounded join — its drain
        thread may be wedged forever."""
        old_engine = replica.engine
        fresh_pred = self._replicate(self.predictor, [replica.device])[0]
        if self._swapped_state is not None:
            _place_state(_state_of(fresh_pred), self._swapped_state)
        fresh = self._make_replica(replica.index, fresh_pred)
        # keep the ORIGINAL breaker (state + flap history): the restarted
        # engine stays open until a probe or budgeted request closes it
        def _outcome(ok, exc, _b=replica.breaker):
            if ok:
                _b.record_success()
            else:
                _b.record_failure(repr(exc))
        fresh.engine.on_outcome = _outcome
        fresh.engine.weights_version = self.weights_version
        if self._warm_sigs:
            try:
                fresh.engine.warmup(*self._warm_sigs)
            except Exception:   # noqa: BLE001 - warm lazily instead
                pass
        fresh.engine.start()
        replica.predictor = fresh.predictor
        replica.engine = fresh.engine
        replica.restarts += 1
        replica.restart_token = None
        # drop the dead engine's per-replica gauges: the next sampler
        # tick re-mints them from the live breaker, so a stale "open"
        # from before the restart can't linger in rollups
        metrics.clear_replica_series(replica.index)
        metrics.record_replica_restart(replica.index)
        threading.Thread(
            target=lambda: old_engine.close(drain=False, timeout=1.0),
            name="paddle_tpu_torch-serving-reap", daemon=True).start()

    # -- scaling (supervisor verdicts) -------------------------------------

    def _active_count(self):
        return sum(1 for r in self._replicas if r.active)

    def _activate_one(self):
        for r in self._replicas:
            if not r.active and not r.draining:
                r.active = True
                metrics.record_active_replicas(self._active_count())
                return r
        return None

    def _deactivate_one(self):
        if self._active_count() <= self.min_replicas:
            return None
        for r in reversed(self._replicas):
            if r.active and not r.draining:
                r.active = False
                # drain its queue onto the survivors
                moved = [q for q in r.engine.steal_pending()
                         if not q.future.done()]
                if moved:
                    try:
                        self._pick_replica(
                            exclude=(r.index,)).engine.requeue(moved)
                    except NoHealthyReplicaError:
                        r.engine.requeue(moved)   # undo: keep serving
                        r.active = True
                        return None
                metrics.record_active_replicas(self._active_count())
                return r
        return None

    # -- fleet lifecycle ---------------------------------------------------

    def warmup(self, *signatures):
        """Warm every replica (each meets every signature once on its own
        weights); the signatures are remembered so a restarted replica
        re-warms before taking traffic. Returns the total of signatures
        met for the first time."""
        self._warm_sigs = signatures
        return sum(r.engine.warmup(*signatures) for r in self._replicas)

    def start(self):
        for r in self._replicas:
            r.engine.start()

    def close(self, drain=True, timeout=None):
        if self.supervisor is not None:
            self.supervisor.stop()
        if self._hedger is not None:
            self._hedger.stop()
        _preempt.unsubscribe(self._preempt_cb)
        _ACTIVE.discard(self)
        for r in self._replicas:
            # a hung replica must not hold close() hostage: bound the
            # join (its stranded futures fail rather than strand)
            t = timeout
            if t is None and drain:
                t = 10.0
            r.engine.close(drain=drain, timeout=t)
            # closed replicas leave no stale per-replica gauges behind
            metrics.clear_replica_series(r.index)

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.close()

    # -- observability -----------------------------------------------------

    def stats(self):
        """Aggregate across replicas, with the per-replica breakdown
        under ``"replicas"`` and the resilience tallies alongside."""
        per = [r.engine.stats() for r in self._replicas]
        agg = {k: sum(s[k] for s in per)
               for k in per[0] if isinstance(per[0][k], (int, float))}
        agg["replicas"] = per
        agg["devices"] = [str(r.device) for r in self._replicas]
        with self._hedge_lock:
            agg["hedged"] = self._hedged
            agg["hedge_wins"] = self._hedge_wins
            agg["failovers"] = self._failovers
        agg["restarts"] = sum(r.restarts for r in self._replicas)
        agg["active_replicas"] = self._active_count()
        agg["draining_replicas"] = sum(
            1 for r in self._replicas if r.draining)
        agg["weights_version"] = self.weights_version
        agg["breakers"] = {r.index: r.state for r in self._replicas}
        return agg

    def health(self, now=None):
        """The /healthz ``serving`` block: per-replica routing state
        (``state`` is the breaker state, or ``draining`` — a healthy
        replica refusing admission is NOT unhealthy) and heartbeat
        ages, plus ``all_open`` (no replica can take traffic → the
        endpoint answers 503; a fully draining fleet reads all_open
        because it really is refusing traffic)."""
        now = time.monotonic() if now is None else now
        reps = []
        any_admitting = False
        for r in self._replicas:
            h = r.engine.heartbeat(now)
            if r.active and not r.draining and r.breaker.state != "open":
                any_admitting = True
            reps.append({
                "replica": r.index,
                "device": str(r.device),
                "state": r.state,
                "breaker": r.breaker.state,
                "draining": bool(r.draining),
                "active": bool(r.active),
                "queue_depth": h["queue_depth"],
                "inflight": h.get("active", 0),
                "inflight_age_s": None if h["inflight_age_s"] is None
                else round(h["inflight_age_s"], 3),
                "heartbeat_age_s": round(h["last_ok_age_s"], 3),
                "restarts": r.restarts,
            })
        out = {"replicas": reps, "all_open": not any_admitting,
               "active_replicas": self._active_count(),
               "weights_version": self.weights_version}
        if self._lifecycle is not None:
            out["last_lifecycle"] = self._lifecycle
        if self.supervisor is not None:
            out["supervisor"] = self.supervisor.last_decision()
        return out


def health():
    """Health blocks for every live MultiDeviceEngine (the ``serving``
    block of a ``/healthz`` payload; the endpoint itself is ROADMAP.md
    Queue A item 20)."""
    return [eng.health() for eng in list(_ACTIVE)]


def publish_gauges():
    """Republish per-replica breaker state, the active count and the
    weights version (transitions set the gauges too, but a periodic call
    keeps the open→half_open cooldown promotion visible without
    traffic)."""
    from .. import monitor as _monitor
    if not _monitor.enabled():
        return
    for eng in list(_ACTIVE):
        metrics.record_active_replicas(eng._active_count())
        metrics.record_weights_version(eng.weights_version)
        for r in eng._replicas:
            _monitor.gauge(f"serving.breaker_state.{r.index}").set(
                metrics._BREAKER_STATE_NUM.get(r.state, -1))
