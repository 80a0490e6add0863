"""paddle_tpu_torch.serving.disagg — disaggregated prefill/decode serving.

Counterpart of ``paddle_tpu/serving/disagg.py``. One engine doing both
prefill and decode (``generate.GenerateEngine``) couples two workloads of
opposite shapes: prefill is a compute-bound burst whose latency is the
user's TTFT, decode a steady memory-bound drip whose throughput is the
fleet's tokens/s. Coupled, a burst of long prompts stalls every live
stream's next token, and scaling for one SLO overprovisions the other.
This module splits them into two independently scaled pools:

* :class:`PrefillPool` — replicas of a lean :class:`PrefillEngine` that
  run the single engine's prefill step and produce a **KV segment** (the
  ``KVCachePool.export_slot`` transport format) plus the request's first
  sampled token;
* :class:`DecodePool` — a ``MultiDecodeEngine`` whose ``GenerateEngine``
  replicas are built with ``kv_import=True``: a hand-off lands through
  ``KVCachePool.import_slot`` on a warmed insert, and a drained decode
  replica's sequences migrate *with their KV*
  (``disown_inflight(export_kv=True)``) and resume mid-stream;
* :class:`DisaggServer` — the front door: admission at the prefill pool,
  a shared :class:`~paddle_tpu_torch.serving.prefix_cache.PrefixCache` in
  front of prefill, and the explicit, *priced* hand-off between the pools
  — ``planned_ms = kv_bytes / link_bandwidth()``
  (``parallel/planner.py``), recorded as
  ``serving.handoff.{bytes,ms,queue_depth}``.

Parity is the design invariant: the decode replica seats a hand-off with
the exact host state the single engine's prefill would have left
(``tokens=[first]``, ``length=prompt_len``, the ``note_length`` ledger),
so every later draw — keyed by ``(request seed, generation index)`` alone
— is the same, and the stream matches the single engine's token for
token, through prefix hits and mid-stream drains.

On the card the prefill engine's two executables are CUDA graphs
(``graphs.GraphEntry``, through ``generate._Steps`` as the decode engine's
are): a ``("prefill", bucket, branch)`` graph runs ``model.prefill_fn``
(kernel #3, causal, on the card) and the first token's sample and keeps
the last logits, and a ``("psample", branch)`` graph samples a sampled
prefix hit's first token from the cached logits, copied into its static
``[1, V]`` float32 input (a greedy hit's is their argmax, on the host). A
miss's segment, first token and logits leave the graph's static outputs
for the host by one pinned copy and one wait; a hit launches no kernel of
the prompt's forward.

Each pool autoscales on its own SLO through its own
:class:`~paddle_tpu_torch.serving.supervisor.ServingSupervisor`: prefill on
``slo.ttft_p99_ms`` / queue depth (``ttft_ceiling_ms`` /
``queue_depth_ceiling``), decode on ``slo.tokens_per_s``
(``tokens_floor``). Breakers, hang failover, probes and drains extend per
pool unchanged — a hung prefill replica fails its queue over to peers
exactly as a hung decode replica does.
"""
from __future__ import annotations

import collections
import functools
import threading
import time

import numpy as np
import torch

from .. import device as _device
from .. import monitor as _monitor
from ..io.bucketing import grow_buckets, next_bucket
from ..resilience import faults as _faults
from ..resilience.deadline import Deadline
from . import metrics
from . import reqtrace
from . import sampling as sampling_mod
from .admission import AdmissionController, resolve_priority
from .generate import (BRANCHES, DecodeRequest, MultiDecodeEngine, _Graphs,
                       _Steps, _branch, _fresh_seed, _knob_rows, _knobs_of,
                       _label, _prompt_lanes, _signature, replicate_decode)
from .kv_cache import _leaves, bytes_per_token, to_host
from .multi import MultiDeviceEngine, fleet_devices
from .prefix_cache import PrefixCache


class PrefillEngine(_Steps):
    """Prompt ingest over one model replica: pops requests, consults the
    shared prefix cache, replays the bucketed prefill graph on a miss, and
    hands a ``(request, segment, first_token, hit)`` to the pool's
    ``on_segment`` callback — the engine never owns a KV arena or a decode
    loop.

    Exposes the full ``MultiDeviceEngine`` supervision surface
    (heartbeat / probe / steal_pending / disown_inflight / requeue /
    warmup / close), so breakers, hang failover and restart work on a
    prefill replica exactly as they do on a decode replica. A disowned
    in-flight request re-runs its prefill on the adopting replica —
    prefill is a function of the prompt alone, so the retried segment is
    the same.

    Executables (``executables()`` counts the signatures met, the
    reference's count; :attr:`captures` the graphs): a ``("prefill",
    bucket, branch)`` graph per prompt bucket and batch-wide branch
    (greedy, sampled, filtered: ``generate.BRANCHES``), the single
    engine's prefill body (its K/V, the first token, and the last logits),
    and a ``("psample", branch)`` graph per sampled branch that samples
    the first token of a prefix hit from the cached logits, with the
    hitting request's own knobs, seed and generation index 0; a greedy
    hit's first token is the cached logits' argmax, taken on the host.
    :meth:`warmup` captures them all; no request after it captures.
    """

    def __init__(self, model, prompt_buckets=None, max_len=512,
                 page=64, factor=2.0, queue_depth=256, deadline_ms=None,
                 shed=True, slo_goodput_floor=0.90, start=True,
                 replica_id=None, on_outcome=None, sampling=None,
                 cache=None, on_segment=None):
        self.model = model
        self.replica_id = replica_id
        self.on_outcome = on_outcome
        self.weights_version = 0
        self.cache = cache                  # shared PrefixCache or None
        self.on_segment = on_segment        # f(req, segment, first, hit)
        self.default_sampling = sampling_mod.resolve(sampling)
        self.device = torch.device(getattr(model, "device", None)
                                   or _device.resolve())
        family = grow_buckets(page, factor, max_len)
        self.max_len = int(family[-1])
        # a request is bounded by the model's position table too, as the
        # decode engine's (GenerateEngine.seq_limit)
        model_len = getattr(model, "max_len", None)
        self.seq_limit = (self.max_len if model_len is None
                          else min(self.max_len, int(model_len)))
        pb = tuple(sorted({int(b) for b in (
            family if prompt_buckets is None else prompt_buckets)}))
        if not pb or pb[-1] > self.seq_limit:
            raise ValueError(
                f"prompt_buckets {pb} must be non-empty and within "
                f"max_len={self.max_len} and the model's max_len="
                f"{model_len}")
        self.prompt_buckets = pb
        self._names = [name for name, _tail, _dt in _leaves(model.kv_spec())]
        self._per_token = bytes_per_token(model.kv_spec())
        self.admission = AdmissionController(
            max_queue_depth=queue_depth, default_deadline_ms=deadline_ms,
            shed=shed, slo_goodput_floor=slo_goodput_floor)
        self.admission.on_event = self._admission_event
        self._queue = collections.deque()
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._current = None            # in-flight request (disownable)
        self._inflight_t0 = None
        # signatures met, and each with its operands' shapes and dtypes
        self._exec = set()
        self._traces = set()
        # the executables (generate._Steps): a GraphEntry a key over the
        # served model, built under one lock, captured on one side stream
        self._graphs = _Graphs(model, self.device)
        self._prepared = None
        self._build_lock = threading.Lock()
        self._stream = None
        # a step's replay and the copy of its static outputs to the host
        # (the worker's, or the probe's on its own thread) run under this
        # lock: a second replay before the copies would overwrite them
        self._step_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self._stats = {"submitted": 0, "completed": 0, "failed": 0,
                       "rejected": 0, "expired": 0, "shed": 0,
                       "prefills": 0, "prefill_tokens": 0,
                       "prefix_hits": 0, "prefix_misses": 0,
                       "compiles": 0, "captures": 0, "prefill_replays": 0,
                       "psample_replays": 0}
        self._running = False
        self._closed = False
        self._draining = False
        self._thread = None
        self._last_progress = time.monotonic()
        self._last_ok_t = time.monotonic()
        if start:
            self.start()

    # -- client surface ----------------------------------------------------

    def make_request(self, prompt, max_new_tokens=32, eos_token=None,
                     deadline_ms=None, priority=None, trace=None,
                     sampling=None, seed=None):
        """The same validation and seed discipline as
        ``GenerateEngine.make_request`` — the request built here rides
        unchanged through the hand-off, so everything failover or the
        decode pool needs (resolved sampling, concrete seed, trace) is
        fixed at the front door."""
        arr = np.asarray(prompt, dtype=np.int32).reshape(-1)
        if arr.size < 1:
            raise ValueError("empty prompt")
        if arr.size > self.prompt_buckets[-1]:
            raise ValueError(
                f"prompt of {arr.size} tokens exceeds the largest prefill "
                f"bucket {self.prompt_buckets[-1]} — raise max_len / "
                f"prompt_buckets")
        m = int(max_new_tokens)
        if m < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {m}")
        if arr.size + m > self.seq_limit:
            raise ValueError(
                f"prompt {arr.size} + max_new_tokens {m} exceeds "
                f"{self.seq_limit}: the KV arena's max_len={self.max_len} "
                f"or the model's max_len")
        deadline = (Deadline.after_ms(deadline_ms)
                    if deadline_ms is not None else None)
        prio = resolve_priority(priority)
        if sampling is None and seed is None:
            params = sampling_mod.resolve(self.default_sampling)
        else:
            params = sampling_mod.resolve(sampling, seed=seed)
        if params.seed is None:
            params.seed = 0 if params.greedy else _fresh_seed()
        return DecodeRequest(arr, m, eos_token=eos_token,
                             deadline=deadline, priority=prio,
                             sampling=params,
                             trace=reqtrace.attach(
                                 trace, kind="decode", priority=prio,
                                 replica=self.replica_id,
                                 version=self.weights_version))

    def submit_request(self, req, admit=True):
        """The disaggregated topology's one admission point: the shed
        ladder runs here, before any prefill work — a request shed at the
        front door has consumed nothing."""
        with self._cond:
            if self._closed:
                raise RuntimeError("prefill engine is closed")
            if admit:
                self.admission.admit(req, len(self._queue))
            self._queue.append(req)
            depth = len(self._queue)
            self._cond.notify()
        metrics.record_submit(1)
        metrics.record_queue_depth(depth)
        if req.trace is not None:
            req.trace.hop("enqueue", replica=self.replica_id)
        with self._stats_lock:
            self._stats["submitted"] += 1
        return req.future

    def depth(self):
        with self._lock:
            return len(self._queue)

    # -- the steps (generate._Steps runs them) -----------------------------

    def _plan(self, model, gkey):
        """Executable ``gkey`` over ``model``: its body, no arena, and idle
        inputs that take the key's branch (a one-token prompt; zero
        logits)."""
        kind, branch = gkey[0], gkey[-1]
        knobs = self._knobs(1, branch)
        if kind == "prefill":
            return (functools.partial(self._prefill_body, model, branch), (),
                    _prompt_lanes(np.zeros((1, gkey[1]), np.int32), 1, knobs))
        return (functools.partial(self._psample_body, branch), (),
                (np.concatenate(_knob_rows(knobs)),
                 np.zeros((1, int(model.vocab)), np.float32)))

    def _psample_body(self, branch, lanes, logits):
        """A prefix hit's first token: the filter and the draw of the
        prefill's body over cached logits ``[1, V]``, under the request's
        knob rows ``lanes [5]``."""
        return [self._sample(logits, _knobs_of(lanes[:, None]), branch)]

    def _note(self, key, *arrays):
        """Record a step's signature; a first meeting counts as a compile,
        as the reference counts its executables."""
        if key not in self._exec:
            self._exec.add(key)
            metrics.record_decode_compile(1, what=_label(key, None))
            with self._stats_lock:
                self._stats["compiles"] += 1
        self._traces.add((key, _signature(*arrays)))

    def executables(self):
        """(signatures met, signatures with their operand shapes and dtypes
        met): both flat after :meth:`warmup` under any traffic, hits and
        misses."""
        return len(self._exec), len(self._traces)

    def _prefill(self, tokens, length, knobs):
        """The prompt's prefill at its bucket: ``(leaves, first, logits)``
        on the host — each K/V leaf ``[L, *tail]``, the first token and the
        last logits ``[V]`` — copied off the graph's static outputs in one
        wait, before any other replay of this engine."""
        g = self._bound()
        host = _prompt_lanes(tokens, length, knobs)
        self._note(("prefill", tokens.shape[1]), host)
        key = ("prefill", tokens.shape[1], _branch(knobs, g.model.vocab))
        with self._step_lock:
            out = to_host(self._run(g, key, host))
        return ({name: a[0] for name, a in zip(self._names, out[:-2])},
                int(out[-2][0]), out[-1])

    def _psample(self, logits, knobs):
        """A prefix hit's first token from the cached ``logits [1, V]``. A
        greedy request's is their argmax, taken on the host: the greedy
        branch's sample is the argmax (ties to the lowest token id, as
        ``np.argmax``'s), of float32 values the host already holds, and a
        replay would add a copy in, a launch and a wait to the hit's TTFT.
        A sampled one replays its branch's psample graph (the hit's one
        wait: one token's copy back)."""
        g = self._bound()
        branch = _branch(knobs, g.model.vocab)
        if branch == "greedy":
            return int(np.argmax(logits))
        host = (np.concatenate(_knob_rows(knobs)),
                np.asarray(logits, np.float32).reshape(1, -1))
        self._note(("psample",), *host)
        key = ("psample", branch)
        with self._step_lock:
            first, = self._run(g, key, host)
            return int(first.cpu()[0])

    def warmup(self, *_signatures):
        """Meet every signature this replica can need and capture every
        graph: a prefill a prompt bucket and branch, and the psample a
        sampled branch (a greedy hit takes no graph, :meth:`_psample`).
        Returns the number of signatures met for the first time;
        traffic (hits and misses) then captures nothing. Positional
        signatures (the fleet's) are accepted and ignored."""
        before = len(self._exec)
        g = self._bound()
        with _monitor.trace.span("serving.prefill_warmup",
                                 buckets=len(self.prompt_buckets)):
            for lb in self.prompt_buckets:
                self._note(("prefill", lb),
                           self._plan(g.model, ("prefill", lb, "greedy"))[2])
                for branch in BRANCHES:
                    self._run(g, ("prefill", lb, branch), warm=True)
            self._note(("psample",),
                       *self._plan(g.model, ("psample", "sampled"))[2])
            for branch in BRANCHES[1:]:
                self._run(g, ("psample", branch), warm=True)
            self._wait()
        return len(self._exec) - before

    # -- lifecycle ---------------------------------------------------------

    def start(self):
        with self._lock:
            if self._running or self._closed:
                return
            self._running = True
            self._draining = False
            self._thread = threading.Thread(
                target=self._worker, name="paddle_tpu_torch-serving-prefill",
                daemon=True)
            self._thread.start()

    def close(self, drain=True, timeout=None):
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._running = False
            self._draining = bool(drain)
            self._cond.notify_all()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            if timeout is None:
                timeout = 10.0 if drain else 5.0
            t.join(timeout)
        leftovers = []
        with self._cond:
            leftovers.extend(self._queue)
            self._queue.clear()
        for r in leftovers:
            r.resolve_exception(RuntimeError("prefill engine closed"))

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.close()

    # -- supervision surface (the MultiDeviceEngine contract) --------------

    def heartbeat(self, now=None):
        now = time.monotonic() if now is None else now
        with self._lock:
            depth = len(self._queue)
            t0 = self._inflight_t0
            active = 1 if self._current is not None else 0
        return {
            "queue_depth": depth,
            "inflight_age_s": None if t0 is None else now - t0,
            "inflight_token": t0,
            "last_progress_age_s": now - self._last_progress,
            "last_ok_age_s": now - self._last_ok_t,
            "active": active,
        }

    def probe(self, timeout_s=1.0):
        """Half-open test traffic: one replay of the smallest bucket's
        greedy prefill graph, on a side thread (the worker may be the
        wedged thing), and whether it finished in time; None before warmup
        or traffic captured it. It replays under the engine's step lock,
        so a step still holding the card keeps it waiting: a timeout."""
        lb = self.prompt_buckets[0]
        key = ("prefill", lb, "greedy")
        g = self._bound()
        entry = g.entries.get(key)
        if entry is None:
            return None
        idle = self._plan(g.model, key)[2]
        done = threading.Event()
        err = []

        def _go():
            try:
                with self._step_lock:
                    to_host(entry.replay(
                        [_device.host_tensor(idle, self.device)],
                        clone=False)[-2:-1])
            except BaseException as e:   # noqa: BLE001 - the verdict
                err.append(e)
            finally:
                done.set()

        threading.Thread(target=_go, daemon=True,
                         name="paddle_tpu_torch-prefill-probe").start()
        ok = done.wait(timeout_s) and not err
        if ok:
            self._last_ok_t = time.monotonic()
        return bool(ok)

    def steal_pending(self):
        with self._cond:
            taken = list(self._queue)
            self._queue.clear()
        metrics.record_queue_depth(0)
        return taken

    def disown_inflight(self, export_kv=False):
        """Failover: hand the in-flight request (if any) to the caller.
        Prefill is a function of the prompt alone — the adopting replica
        re-runs it and produces the same segment; if this replica's wedged
        step ever completes, the ownership check in :meth:`_process`
        discards its result. ``export_kv`` is accepted for the surface's
        sake (nothing is resident here to export)."""
        with self._lock:
            req = self._current
            self._current = None
            self._inflight_t0 = None
        if req is None or req.future.done():
            return []
        return [req]

    def requeue(self, requests):
        if not requests:
            return
        for r in requests:
            tr = getattr(r, "trace", None)
            if tr is not None:
                tr.to("queue")
                tr.hop("requeue", replica=self.replica_id)
        with self._cond:
            if self._closed:
                for r in requests:
                    r.resolve_exception(
                        RuntimeError("prefill engine closed"))
                return
            for r in reversed(requests):
                self._queue.appendleft(r)
            depth = len(self._queue)
            self._cond.notify()
        metrics.record_queue_depth(depth)

    def _note_outcome(self, ok, exc=None):
        if ok:
            self._last_ok_t = time.monotonic()
        cb = self.on_outcome
        if cb is not None:
            try:
                cb(ok, exc)
            except Exception:   # noqa: BLE001 - an observer must not kill
                pass            # the worker

    def _admission_event(self, event):
        key = {"rejected": "rejected", "expired": "expired",
               "poisoned": "failed", "shed": "shed"}.get(event)
        if key is not None:
            with self._stats_lock:
                self._stats[key] += 1

    def stats(self):
        with self._stats_lock:
            s = dict(self._stats)
        s["queue_depth"] = self.depth()
        s["executables"], s["traces"] = self.executables()
        return s

    # -- the worker loop ---------------------------------------------------

    def _pop_next_locked(self, now):
        expired = []
        while self._queue:
            best_i, best_p = 0, self._queue[0].priority
            for i, r in enumerate(self._queue):
                if r.priority < best_p:
                    best_i, best_p = i, r.priority
            r = self._queue[best_i]
            del self._queue[best_i]
            if self.admission.is_expired(r, now):
                expired.append(r)
                continue
            return r, expired
        return None, expired

    def _worker(self):
        while True:
            now = time.monotonic()
            with self._cond:
                req, expired = self._pop_next_locked(now)
                depth = len(self._queue)
                if req is None and not expired:
                    if not self._running:
                        if self._draining and self._queue:
                            continue
                        return
                    self._cond.wait(0.05)
                    continue
            metrics.record_queue_depth(depth)
            for r in expired:
                self.admission.expire(r)
            if req is None:
                continue
            self._process(req)
            self._last_progress = time.monotonic()

    def _process(self, req):
        """One request: prefix lookup → (hit: psample over the cached
        logits | miss: the bucket's prefill + cache insert) → first token
        → ``on_segment`` hand-off. Ownership-checked against
        :meth:`disown_inflight`, so a hung step's late completion is
        discarded rather than delivered twice."""
        with self._lock:
            self._current = req
            self._inflight_t0 = time.monotonic()
        tr = req.trace
        try:
            if tr is not None:
                tr.to("prefix_lookup")
            key = entry = None
            hit = False
            if self.cache is not None:
                key, entry = self.cache.lookup(req.prompt)
                hit = entry is not None
                if tr is not None:
                    tr.note_prefix(hit)
            sp = req.sampling
            # generation index 0: the first token
            knobs = (np.array([sp.temperature], np.float32),
                     np.array([sp.top_k], np.int32),
                     np.array([sp.top_p], np.float32),
                     np.array([sp.seed or 0], np.uint32),
                     np.zeros((1,), np.int32))
            if hit:
                # keep the entry pinned until the stream resolves: the
                # decode replica reads the leaves at seat time (and a
                # drain may import them again later)
                req.future.add_done_callback(
                    lambda _f, c=self.cache, k=key: c.release(k))
                if _faults.enabled():
                    _faults.maybe_serving_fault(self.replica_id,
                                                site="prefill")
                first = self._psample(entry.logits, knobs)
                segment = entry.segment
                with self._stats_lock:
                    self._stats["prefix_hits"] += 1
            else:
                if tr is not None:
                    tr.to("prefill")
                if _faults.enabled():
                    _faults.maybe_serving_fault(self.replica_id,
                                                site="prefill")
                t0 = time.monotonic()
                p = int(req.prompt.size)
                bucket = next_bucket(p, self.prompt_buckets)
                tokens = np.zeros((1, bucket), np.int32)
                tokens[0, :p] = req.prompt
                leaves, first, logits = self._prefill(tokens, p, knobs)
                seg_bytes = sum(int(a.nbytes) for a in leaves.values())
                expected = self._per_token * bucket
                if seg_bytes != expected:
                    raise AssertionError(
                        f"prefill segment {seg_bytes} B != spec-priced "
                        f"{expected} B ({self._per_token} B/token x "
                        f"bucket {bucket})")
                segment = {"length": p, "pad": bucket,
                           "bytes": seg_bytes, "leaves": leaves}
                ms = (time.monotonic() - t0) * 1e3
                metrics.record_prefill(p, ms, bucket)
                with self._stats_lock:
                    self._stats["prefills"] += 1
                    self._stats["prefill_tokens"] += p
                    if self.cache is not None:
                        self._stats["prefix_misses"] += 1
                if self.cache is not None and key is not None:
                    self.cache.insert(key, segment, logits)
        except BaseException as e:   # noqa: BLE001 - to the future
            with self._lock:
                mine = self._current is req
                if mine:
                    self._current = None
                    self._inflight_t0 = None
            self._note_outcome(False, e)
            if mine:
                with self._stats_lock:
                    self._stats["failed"] += 1
                req.resolve_exception(e)
            return
        # the ownership check before delivery: a disowned request was
        # already adopted (and prefilled again) elsewhere — dropping the
        # stale result here is what makes one hang produce one hand-off
        with self._lock:
            mine = self._current is req
            if mine:
                self._current = None
                self._inflight_t0 = None
        if not mine:
            return
        self._note_outcome(True)
        # the TTFT moment: the prefill (or the cached logits' sample)
        # produced the stream's first token
        if tr is not None:
            tr.first_token()
        with self._stats_lock:
            self._stats["completed"] += 1
        if self.on_segment is not None:
            try:
                self.on_segment(req, segment, first, hit)
            except BaseException as e:   # noqa: BLE001 - to the future
                with self._stats_lock:
                    self._stats["failed"] += 1
                req.resolve_exception(e)
        else:
            # standalone use: resolve with the first token
            req.resolve_result(np.asarray([first], np.int32))


# ---------------------------------------------------------------------------
# the two pools


class PrefillPool(MultiDeviceEngine):
    """Breaker-aware fan-out over :class:`PrefillEngine` replicas (each its
    own copy of the model, :func:`~paddle_tpu_torch.serving.generate.
    replicate_decode`) — the same supervision spine as every other fleet
    (hang failover, probes, restart, scaling), with prefill's own SLO
    driving the scaling when the owner wires a supervisor with
    ``ttft_ceiling_ms`` / ``queue_depth_ceiling``. A rolling
    ``swap_weights`` captures each replica's graphs over the new module
    before binding it, as the decode fleet's does."""

    def __init__(self, model, devices=None, **kwargs):
        kwargs.setdefault("hedge_ms", 0)    # a prefill is not hedgeable
        #                                     work: it owns no slot, and
        #                                     re-running it is failover's
        #                                     job, not the tail's
        super().__init__(model, devices=devices, **kwargs)

    def _replicate(self, model, devices):
        return replicate_decode(model, devices)

    def _new_engine(self, model, index, on_outcome):
        return PrefillEngine(model, replica_id=index,
                             on_outcome=on_outcome,
                             **self._engine_kwargs)

    def _serving_module(self, r):
        return r.engine.model

    def _serve_module(self, r, module):
        # every graph the replica holds is captured over the new module
        # before it is bound (PrefillEngine.prepare): a graph replays the
        # weights it captured, so binding first would serve the old ones
        r.engine.prepare(module)
        r.predictor = r.engine.model = module


class DecodePool(MultiDecodeEngine):
    """The decode side of the split: ``GenerateEngine`` replicas built
    with ``kv_import=True`` (warmup meets every capacity-family insert pad,
    so any segment lands on a warmed signature), presets admitted without
    re-running the shed ladder, and drain migration carrying KV so a
    drained replica's streams resume mid-flight on the adopter."""

    def __init__(self, model, devices=None, **kwargs):
        kwargs["kv_import"] = True
        super().__init__(model, devices=devices, **kwargs)

    def submit_preset(self, req):
        """Land a hand-off: the request already passed admission at the
        prefill pool's front door and carries its ``preset`` payload —
        route it to a healthy decode replica, ladder not re-run."""
        rep = self._pick_replica()
        if req.trace is not None:
            req.trace.hop("handoff", replica=rep.index)
            # close the hand-off stage before the enqueue: once the request
            # is in the replica's deque its worker may seat it
            # (to("decode")) concurrently, and a later to("queue") here
            # would steal decode time back into queue. From here on the
            # wait is slot wait, not transport.
            req.trace.to("queue")
        fut = rep.engine.submit_request(req, admit=False)
        with self._hedge_lock:
            self._submitted += 1
        return fut, rep

    def _disown(self, replica):
        # drain/failover migration carries each sequence's KV segment and
        # emitted tokens: the adopter seats it (GenerateEngine.
        # _seat_preset) and the stream continues at the same generation
        # index
        return replica.engine.disown_inflight(export_kv=True)


# ---------------------------------------------------------------------------
# the server


def _cycle(devices, n):
    """``n`` devices from ``devices`` (default: every CUDA card, raising
    where there is none, :func:`~paddle_tpu_torch.serving.multi.
    fleet_devices`), cycled over the replica count as the reference cycles
    ``jax.local_devices()``."""
    if devices is not None:
        return fleet_devices(devices)
    devs = fleet_devices(None)
    return [devs[i % len(devs)] for i in range(int(n))]


class DisaggServer:
    """The disaggregated topology, assembled: a shared
    :class:`PrefixCache`, a :class:`PrefillPool`, a :class:`DecodePool`,
    the priced hand-off between them, and one supervisor per pool scaling
    on that pool's own SLO.

    Capacity planning rule of thumb: size the prefill:decode replica ratio
    to ``mean_prompt_tokens x arrival_rate / prefill_tokens_per_s`` vs
    ``mean_stream_tokens x arrival_rate / (decode_tokens_per_s x
    slots)`` — the pools saturate independently, which is the point of the
    split.

    Parameters mirror :class:`~paddle_tpu_torch.serving.generate.
    GenerateEngine` where they share meaning; both pools are held to one
    ``(page, factor, max_len, prompt_buckets)`` family, so every prefill
    bucket has a warmed decode-side insert. ``prefill_devices`` and
    ``decode_devices`` default to the CUDA cards, cycled over each pool's
    replica count; with no card the default raises ``RuntimeError`` (pass
    ``["cpu"]``). ``link_gbps`` overrides the link model's bandwidth
    (:func:`~paddle_tpu_torch.parallel.planner.link_bandwidth`, whose
    default on a card is the measured host round trip a hand-off makes).
    """

    def __init__(self, model, prefill_replicas=1, decode_replicas=1,
                 prefill_devices=None, decode_devices=None, slots=8,
                 page=64, factor=2.0, max_len=512, prompt_buckets=None,
                 queue_depth=256, deadline_ms=None, sampling=None,
                 prefix_cache=True, prefix_budget_bytes=64 * 1024 * 1024,
                 link_gbps=None, supervise=True,
                 supervisor_interval_s=0.25, inflight_timeout_ms=None,
                 prefill_inflight_timeout_ms=None,
                 decode_inflight_timeout_ms=None,
                 ttft_ceiling_ms=None, queue_depth_ceiling=None,
                 tokens_floor=None, prefill_initial_active=None,
                 decode_initial_active=None):
        from ..parallel.planner import link_bandwidth
        prefill_devices = _cycle(prefill_devices, prefill_replicas)
        decode_devices = _cycle(decode_devices, decode_replicas)
        family = grow_buckets(page, factor, max_len)
        if prompt_buckets is None:
            prompt_buckets = tuple(family)
        self.prompt_buckets = tuple(sorted({int(b)
                                            for b in prompt_buckets}))
        self.spec = model.kv_spec()
        self._kv_per_token = bytes_per_token(self.spec)
        # the link a hand-off crosses ends on a decode replica's device
        self._link_bw = link_bandwidth(link_gbps,
                                       device=decode_devices[0])  # bytes/s
        self.prefix = (PrefixCache(self.spec,
                                   budget_bytes=prefix_budget_bytes)
                       if prefix_cache else None)
        self._lock = threading.Lock()
        self._handoffs = 0
        self._handoff_bytes = 0
        # supervision is wired explicitly per pool (below), so that each
        # scales on its own SLO; the pools' built-in supervisors stay off
        # (no second control loop per pool). Hang detection is tuned per
        # pool: a prefill step is one bounded replay (tight timeouts are
        # safe) while a loaded decode tick stretches under CPU contention
        # — one shared aggressive timeout would push the decode fleet into
        # failover
        if prefill_inflight_timeout_ms is None:
            prefill_inflight_timeout_ms = inflight_timeout_ms
        if decode_inflight_timeout_ms is None:
            decode_inflight_timeout_ms = inflight_timeout_ms
        self.prefill_pool = PrefillPool(
            model, devices=prefill_devices, supervise=False,
            inflight_timeout_ms=prefill_inflight_timeout_ms,
            initial_active=prefill_initial_active,
            # engine kwargs ↓
            prompt_buckets=self.prompt_buckets, max_len=max_len,
            page=page, factor=factor, queue_depth=queue_depth,
            deadline_ms=deadline_ms, sampling=sampling,
            cache=self.prefix, on_segment=self._handoff)
        self.decode_pool = DecodePool(
            model, devices=decode_devices, supervise=False,
            inflight_timeout_ms=decode_inflight_timeout_ms,
            initial_active=decode_initial_active,
            # engine kwargs ↓
            slots=slots, page=page, factor=factor, max_len=max_len,
            prompt_buckets=self.prompt_buckets,
            queue_depth=queue_depth, sampling=sampling)
        self.prefill_supervisor = None
        self.decode_supervisor = None
        if supervise:
            from .supervisor import ServingSupervisor
            # prefill scales only on its own SLO (TTFT / queue depth):
            # goodput_floor 0 turns the generic branch off for this pool.
            # With no ceiling set the pool has no scale-up path either, so
            # scaling is off entirely — otherwise the idle scale-down would
            # be a one-way ratchet that strands the pool at min_replicas
            # before traffic arrives.
            self.prefill_supervisor = ServingSupervisor(
                self.prefill_pool, interval_s=supervisor_interval_s,
                goodput_floor=0.0, ttft_ceiling_ms=ttft_ceiling_ms,
                queue_depth_ceiling=queue_depth_ceiling,
                scale=(ttft_ceiling_ms is not None
                       or queue_depth_ceiling is not None))
            # decode scales only on its own SLO (tokens/s). Goodput is an
            # end-to-end signal spanning both pools — early in a burst it
            # reads 0 (submits recorded, nothing finished yet) and would
            # blame prefill's backlog on decode — so the generic branch is
            # off here too.
            self.decode_supervisor = ServingSupervisor(
                self.decode_pool, interval_s=supervisor_interval_s,
                goodput_floor=0.0, tokens_floor=tokens_floor,
                scale=tokens_floor is not None)

    # -- client surface ----------------------------------------------------

    def submit(self, prompt, max_new_tokens=32, eos_token=None,
               deadline_ms=None, priority=None, trace=None,
               sampling=None, seed=None):
        """One sequence through the split topology. The future resolves to
        the generated token ids — the tokens a single ``GenerateEngine``
        returns for the same seeds."""
        rep = self.prefill_pool._pick_replica()
        req = rep.engine.make_request(
            prompt, max_new_tokens=max_new_tokens, eos_token=eos_token,
            deadline_ms=deadline_ms, priority=priority, trace=trace,
            sampling=sampling, seed=seed)
        return rep.engine.submit_request(req)

    def run(self, prompt, max_new_tokens=32, eos_token=None,
            deadline_ms=None, timeout=None, priority=None,
            sampling=None, seed=None):
        return self.submit(prompt, max_new_tokens=max_new_tokens,
                           eos_token=eos_token, deadline_ms=deadline_ms,
                           priority=priority, sampling=sampling,
                           seed=seed).result(timeout)

    # -- the hand-off ------------------------------------------------------

    def _handoff(self, req, segment, first, hit):
        """Prefill (or a prefix hit) produced a segment: price the transfer
        with the link model, record it, and land the request on a decode
        replica as a ``preset``. Runs on the prefill replica's worker
        thread."""
        t0 = time.perf_counter()
        tr = req.trace
        if tr is not None:
            # handoff_ms covers pricing, routing and the enqueue; the
            # stage closes in submit_preset (to("queue")), so decode-slot
            # wait is blamed on the queue, not the link
            tr.to("handoff")
        nbytes = int(segment["bytes"])
        planned_ms = nbytes / self._link_bw * 1e3
        req.preset = {"segment": segment,
                      "tokens": [int(first)],
                      "last_token": int(first),
                      "prompt_len": int(segment["length"])}
        depth = sum(r.engine.depth() for r in self.decode_pool._replicas
                    if r.active)
        self.decode_pool.submit_preset(req)
        actual_ms = (time.perf_counter() - t0) * 1e3
        metrics.record_handoff(nbytes, planned_ms, actual_ms,
                               queue_depth=depth)
        with self._lock:
            self._handoffs += 1
            self._handoff_bytes += nbytes

    def planned_handoff_ms(self, prompt_len):
        """What the link model predicts one hand-off costs for a prompt of
        this length: ``(bytes, ms)``, the per-token KV spec bytes times the
        prompt's bucket, over the link bandwidth. Recorded hand-off bytes
        equal this arithmetic exactly."""
        pad = next_bucket(int(prompt_len), self.prompt_buckets)
        nbytes = self._kv_per_token * pad
        return nbytes, nbytes / self._link_bw * 1e3

    # -- lifecycle ---------------------------------------------------------

    def warmup(self):
        """Warm both pools (every prefill bucket, each branch, and the
        psample's sampled branches; every decode executable, every
        capacity-family insert pad among them). Returns the signatures met
        for the first time."""
        n = self.prefill_pool.warmup()
        n += self.decode_pool.warmup()
        return n

    def drain_decode_replica(self, index, reason="drain"):
        """Graceful drain of one decode replica: its live sequences migrate
        with their KV (``export_kv=True``) and resume mid-stream on
        peers."""
        return self.decode_pool.drain_replica(index, reason=reason)

    def close(self, drain=True, timeout=10.0):
        for sup in (self.prefill_supervisor, self.decode_supervisor):
            if sup is not None:
                sup.stop()
        if drain:
            # prefill first: stop producing new hand-offs, then let the
            # decode pool run its seated streams dry
            self.prefill_pool.close(drain=True, timeout=timeout)
            self.decode_pool.drain_wait(timeout_s=timeout)
            self.decode_pool.close(drain=True, timeout=timeout)
        else:
            self.prefill_pool.close(drain=False)
            self.decode_pool.close(drain=False)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- observability -----------------------------------------------------

    def stats(self):
        with self._lock:
            handoffs = self._handoffs
            handoff_bytes = self._handoff_bytes
        out = {
            "prefill": self.prefill_pool.stats(),
            "decode": self.decode_pool.stats(),
            "handoffs": handoffs,
            "handoff_bytes": handoff_bytes,
            "kv_bytes_per_token": self._kv_per_token,
            "link_bandwidth_bps": self._link_bw,
        }
        if self.prefix is not None:
            out["prefix"] = self.prefix.stats()
        return out

    def health(self, now=None):
        return {"prefill": self.prefill_pool.health(now),
                "decode": self.decode_pool.health(now)}


__all__ = ["PrefillEngine", "PrefillPool", "DecodePool", "DisaggServer"]
