"""paddle_tpu_torch.serving.metrics — the serving tier's observability
surface.

Counterpart of ``paddle_tpu/serving/metrics.py``, the whole module: pure
host Python over :mod:`paddle_tpu_torch.monitor`. Every record_* helper
is a no-op while the monitor is disabled (the decode windows that feed
control loops fill either way, as the reference's do); with
``monitor.enable()`` the serving pipeline shows up as below. A record
reads only numbers the host already holds (host-clock times, the KV
pool's byte arithmetic): no record reads the card, so the monitor adds
no launch and no synchronisation to a decode tick.

* ``serving.requests`` / ``serving.rows``    — submitted requests and
  their total example rows
* ``serving.qps``        — completed requests/sec, gauge over a rolling
  window (:data:`QPS_WINDOW_S`)
* ``serving.queue_depth`` — requests waiting, gauge set at every
  enqueue/dequeue edge
* ``serving.batches``    — coalesced batches executed
* ``serving.batch_fill`` — histogram: requests coalesced per batch
  (> 1 means dynamic batching is actually amortizing dispatch)
* ``serving.batch_occupancy`` — histogram: real rows ÷ bucket rows
  (the ``io.bucketing.batch_mask`` mean — how much of a batch's work is
  real vs. pad)
* ``serving.pad_rows``   — pad rows shipped to the device
* ``serving.latency_ms`` — histogram: submit→resolve per request
* ``serving.rejected``   — fast-rejects at a full queue
* ``serving.deadline_expired`` — requests dropped at dequeue past SLA
* ``serving.compiles``   — executables minted by the serving path
  (warmup included; steady state must hold this flat)
* ``serving.retries`` / ``serving.isolated`` / ``serving.poisoned`` —
  transient batch retries, batches re-run request-by-request after a
  terminal failure, and the requests that individually failed

Resilience series (the self-healing layer):

* ``serving.shed`` — requests shed by the admission ladder (below the
  top-rung ``serving.rejected``); ``serving.shed_level`` gauge is the
  ladder rung currently in force
* ``serving.breaker_state.<replica>`` — per-replica breaker gauge
  (0 = closed, 1 = half_open, 2 = open); ``serving.breaker_open`` /
  ``serving.breaker_closed`` count the transitions
* ``serving.hedged`` / ``serving.hedge_wins`` — straggler re-dispatches
  and how many beat the primary
* ``serving.failover`` — batches re-dispatched off a tripped replica
* ``serving.replica_hung`` / ``serving.replica_restarts`` — supervision
  verdicts and the restarts they caused
* ``serving.active_replicas`` — gauge, replicas currently taking
  traffic (the supervisor's scaling output)

SLO rollups (published by the telemetry sampler via
:func:`publish_rollups`, rolling :data:`SLO_WINDOW_S` window):

* ``slo.goodput``  — completions within deadline ÷ submissions
* ``slo.p50_ms`` / ``slo.p99_ms`` — service-latency percentiles
* ``slo.ttft_p50_ms`` / ``slo.ttft_p99_ms`` — time-to-first-token
  percentiles (fed per-request by the reqtrace terminal records; for
  fixed-shape requests ttft == service latency)
* ``slo.tpot_p50_ms`` / ``slo.tpot_p99_ms`` — time-per-output-token
  percentiles (multi-token decode requests only)
* ``slo.window_submitted`` / ``slo.window_within_sla`` — the raw
  window tallies behind the ratio

Request-scoped records (``serving.reqtrace``): each completed request
emits exactly one ``serving.request`` JSONL record with a stage-blamed
latency breakdown; ``serving.ttft_ms`` / ``serving.tpot_ms`` histograms
(and every serving latency histogram) use :data:`LATENCY_BUCKETS_MS` —
log-spaced decode-scale bounds from 1 µs to 10 s.

``serving.qps`` decays to 0 when traffic stops: the sampler calls
:func:`qps_now` each tick, which sweeps stale window entries instead
of waiting for a next completion that never comes.

Generative-decode series (the continuous-batching engine):

* ``serving.decode.ticks`` / ``serving.decode.tokens`` — fused decode
  steps executed and tokens they produced
* ``serving.decode.slot_occupancy`` — gauge + histogram: active slots ÷
  total slots per tick (continuous batching's whole point is holding
  this near 1.0 under churn)
* ``serving.decode.prefill_tokens`` / ``serving.decode.prefill_ms`` —
  prompt tokens ingested and per-prefill latency histogram
* ``serving.decode.step_ms`` — per-tick decode latency histogram
* ``serving.decode.prefill_ratio`` — gauge: prefill time ÷ (prefill +
  decode) time over the rolling window (how much of the engine is
  spent ingesting prompts vs. emitting tokens)
* ``serving.decode.compiles`` — executables minted by the decode path
  (prefill buckets + decode step + cache grows; zero growth after
  warmup is a smoke gate)
* ``serving.decode.cache_bytes`` / ``serving.decode.cache_capacity`` /
  ``serving.decode.cache_headroom`` — KV-pool footprint, its current
  length bucket, and worst-case headroom against the card's memory
* ``serving.decode.cache_grows`` — capacity steps along the bucket
  family
* ``slo.tokens_per_s`` / ``slo.decode_p99_ms`` — rolling decode SLO
  window (:data:`TOKENS_WINDOW_S`) the supervisor scales replicas off

Speculative-decode series (draft-model verify loop; every token series
above counts **accepted** tokens only — rejected draft proposals never
inflate ``serving.decode.tokens`` or ``slo.tokens_per_s``):

* ``serving.decode.draft_steps`` — draft-model autoregressive steps
  (k per speculative tick)
* ``serving.decode.verify_steps`` — batched target verify steps (one
  per speculative tick)
* ``serving.decode.spec_proposed`` / ``serving.decode.spec_accepted``
  — draft proposals offered vs accepted by the accept-prefix rule
* ``serving.decode.accept_rate`` — gauge: accepted ÷ proposed over the
  rolling :data:`TOKENS_WINDOW_S` window (the health signal for a
  draft/target pairing — a cold draft shows up here first)
* ``serving.decode.spec_tokens_per_step`` — gauge: accepted tokens
  (resample included) per verify step over the window; the speculative
  multiplier actually realized, upper-bounded by ``spec_k``
* ``serving.decode.rollbacks`` / ``serving.decode.rollback_tokens`` —
  KV-ledger truncations after verify rejects (optimistically written
  positions beyond the accepted prefix), target and draft arenas
  combined; the draft arena's footprint publishes under
  ``serving.decode.draft_cache_bytes`` / ``..draft_cache_capacity``

Disaggregated-serving series (prefill pool → decode pool; recorded by
``serving/disagg.py`` and ``serving/prefix_cache.py``):

* ``serving.handoff.bytes`` — gauge: the last planned KV transfer's
  exact payload (``bytes_per_token(spec) × prompt bucket``);
  ``serving.handoff.bytes_total`` accumulates them
* ``serving.handoff.ms`` — histogram: measured handoff latency
  (transfer + decode-slot queueing); ``serving.handoff.planned_ms``
  gauge is the link-model prediction (``bytes / link_bandwidth()``)
* ``serving.handoff.queue_depth`` — gauge: segments waiting for a
  decode slot at plan time
* ``serving.prefix.hits`` / ``serving.prefix.misses`` — prefix-cache
  verdicts; ``serving.prefix.hit_rate`` gauge over the rolling
  :data:`TOKENS_WINDOW_S` window
* ``serving.prefix.lookup_ms`` — histogram: cache probe latency
* ``serving.prefix.bytes`` / ``serving.prefix.entries`` /
  ``serving.prefix.budget_bytes`` — resident cache footprint vs its
  ``fits_budget``-style byte budget; ``serving.prefix.evictions``
  counts LRU victims

Span sites (``monitor.trace``): ``serving.enqueue``,
``serving.batch_assemble``, ``serving.execute``, ``serving.scatter``,
``serving.warmup`` — the Perfetto view of queue→batch→card.
"""
from __future__ import annotations

import collections
import threading
import time

from .. import monitor as _monitor
from ..io.bucketing import batch_mask

#: rolling window for the serving.qps gauge
QPS_WINDOW_S = 10.0
#: rolling window for the slo.* goodput / latency-percentile gauges
SLO_WINDOW_S = 60.0

#: decode-scale latency bounds for every serving histogram: log-spaced
#: (x~2.15 per step) from 1 µs to 10 s, so a p99 on single-token decode
#: ticks (sub-ms) and a p99 on long-prompt prefills (hundreds of ms)
#: both resolve instead of collapsing into one default bucket
LATENCY_BUCKETS_MS = tuple(round(10.0 ** (e / 3.0), 6)
                           for e in range(-9, 13))

_qps_lock = threading.Lock()
_qps_window = collections.deque()   # (t_monotonic, n_completed)

_slo_lock = threading.Lock()
_slo_submits = collections.deque()  # t_monotonic per submitted request
_slo_done = collections.deque()     # (t, latency_ms|None, within_sla)
_slo_ttft = collections.deque()     # (t, ttft_ms) per completed request
_slo_tpot = collections.deque()     # (t, tpot_ms) per multi-token req


def record_submit(n_rows):
    if _monitor.enabled():
        _monitor.counter("serving.requests").inc()
        _monitor.counter("serving.rows").inc(int(n_rows))
        now = time.monotonic()
        with _slo_lock:
            _slo_submits.append(now)
            _sweep(_slo_submits, now, SLO_WINDOW_S, key=lambda t: t)


def record_queue_depth(depth):
    if _monitor.enabled():
        _monitor.gauge("serving.queue_depth").set(int(depth))


def record_reject():
    if _monitor.enabled():
        _monitor.counter("serving.rejected").inc()
        _monitor.emit(kind="serving", event="rejected")


def record_expired():
    if _monitor.enabled():
        _monitor.counter("serving.deadline_expired").inc()
        _monitor.emit(kind="serving", event="deadline_expired")
        now = time.monotonic()
        with _slo_lock:
            # an expired request is a completed-OUTSIDE-SLA outcome for
            # goodput; it has no service latency to histogram
            _slo_done.append((now, None, False))
            _sweep(_slo_done, now, SLO_WINDOW_S)


def record_batch(real_rows, bucket_rows, n_requests):
    if not _monitor.enabled():
        return
    _monitor.counter("serving.batches").inc()
    _monitor.histogram("serving.batch_fill").observe(float(n_requests))
    occupancy = float(batch_mask(real_rows, bucket_rows).mean())
    _monitor.histogram("serving.batch_occupancy").observe(occupancy)
    if bucket_rows > real_rows:
        _monitor.counter("serving.pad_rows").inc(int(bucket_rows - real_rows))


def record_completed(n_requests, latencies_ms, within_sla=None):
    """Per-batch completion: latency histogram per request, the rolling
    QPS gauge, and the slo.* window. ``within_sla`` is a per-request
    bool list (completed before its deadline; None = no deadlines in
    play, every completion counts as within)."""
    if not _monitor.enabled():
        return
    h = _monitor.histogram("serving.latency_ms",
                           buckets=LATENCY_BUCKETS_MS)
    for ms in latencies_ms:
        h.observe(float(ms))
    now = time.monotonic()
    with _qps_lock:
        _qps_window.append((now, int(n_requests)))
        _set_qps_locked(now)
    with _slo_lock:
        for i, ms in enumerate(latencies_ms):
            ok = True if within_sla is None else bool(within_sla[i])
            _slo_done.append((now, float(ms), ok))
        _sweep(_slo_done, now, SLO_WINDOW_S)


def record_request_slo(ttft_ms=None, tpot_ms=None):
    """One completed request's generative SLO sample, fed by the
    reqtrace terminal record: time-to-first-token and (multi-token
    requests only) time-per-output-token, rolled into the live windows
    behind ``slo.ttft_*`` / ``slo.tpot_*`` and histogrammed on the
    decode-scale bounds."""
    if not _monitor.enabled():
        return
    now = time.monotonic()
    with _slo_lock:
        if ttft_ms is not None:
            _slo_ttft.append((now, float(ttft_ms)))
            _sweep(_slo_ttft, now, SLO_WINDOW_S)
        if tpot_ms is not None:
            _slo_tpot.append((now, float(tpot_ms)))
            _sweep(_slo_tpot, now, SLO_WINDOW_S)
    if ttft_ms is not None:
        _monitor.histogram("serving.ttft_ms",
                           buckets=LATENCY_BUCKETS_MS).observe(
            float(ttft_ms))
    if tpot_ms is not None:
        _monitor.histogram("serving.tpot_ms",
                           buckets=LATENCY_BUCKETS_MS).observe(
            float(tpot_ms))


def _sweep(dq, now, horizon, key=lambda item: item[0]):
    """Drop window entries older than ``horizon`` (callers hold the
    window's lock)."""
    while dq and now - key(dq[0]) > horizon:
        dq.popleft()


def _set_qps_locked(now):
    _sweep(_qps_window, now, QPS_WINDOW_S)
    if not _qps_window:
        _monitor.gauge("serving.qps").set(0.0)
        return 0.0
    total = sum(k for _, k in _qps_window)
    elapsed = max(now - _qps_window[0][0], 0.5)
    val = round(total / elapsed, 3)
    _monitor.gauge("serving.qps").set(val)
    return val


def qps_now(now=None):
    """Sweep the rolling window and re-publish ``serving.qps`` from
    what's left — when traffic stops, the stale entries age out HERE
    instead of waiting for a next completion that never comes, so the
    gauge decays to 0. Called by the telemetry sampler each tick; safe
    to call from anywhere."""
    if not _monitor.enabled():
        return 0.0
    now = time.monotonic() if now is None else now
    with _qps_lock:
        return _set_qps_locked(now)


def _percentile(sorted_vals, q):
    if not sorted_vals:
        return None
    idx = min(len(sorted_vals) - 1,
              int(round(q * (len(sorted_vals) - 1))))
    return sorted_vals[idx]


def slo_rollup(now=None):
    """Rolling-window SLO accounting over the last :data:`SLO_WINDOW_S`
    seconds: ``goodput`` = completions within deadline ÷ submissions
    (expired requests count against it; an in-flight backlog does too,
    which is the honest reading under overload), plus p50/p99 service
    latency. Returns the dict and, when the monitor is enabled,
    publishes it as ``slo.*`` gauges."""
    now = time.monotonic() if now is None else now
    with _slo_lock:
        _sweep(_slo_submits, now, SLO_WINDOW_S, key=lambda t: t)
        _sweep(_slo_done, now, SLO_WINDOW_S)
        _sweep(_slo_ttft, now, SLO_WINDOW_S)
        _sweep(_slo_tpot, now, SLO_WINDOW_S)
        submitted = len(_slo_submits)
        done = list(_slo_done)
        ttfts = sorted(v for _, v in _slo_ttft)
        tpots = sorted(v for _, v in _slo_tpot)
    ok = sum(1 for _, _, w in done if w)
    lats = sorted(ms for _, ms, _ in done if ms is not None)
    out = {"window_s": SLO_WINDOW_S, "submitted": submitted,
           "completed": len(lats), "within_sla": ok,
           "goodput": (ok / submitted) if submitted else None,
           "p50_ms": _percentile(lats, 0.50),
           "p99_ms": _percentile(lats, 0.99),
           "ttft_p50_ms": _percentile(ttfts, 0.50),
           "ttft_p99_ms": _percentile(ttfts, 0.99),
           "tpot_p50_ms": _percentile(tpots, 0.50),
           "tpot_p99_ms": _percentile(tpots, 0.99)}
    if _monitor.enabled():
        for key in ("goodput", "p50_ms", "p99_ms", "ttft_p50_ms",
                    "ttft_p99_ms", "tpot_p50_ms", "tpot_p99_ms"):
            if out[key] is not None:
                _monitor.gauge(f"slo.{key}").set(out[key])
        _monitor.gauge("slo.window_submitted").set(submitted)
        _monitor.gauge("slo.window_within_sla").set(ok)
    return out


def publish_rollups(now=None):
    """One sampler tick's worth of derived series: the decaying
    ``serving.qps`` gauge plus the ``slo.*`` rollup (decode window
    included when decode traffic exists)."""
    qps_now(now)
    out = slo_rollup(now)
    out["decode"] = decode_rollup(now)
    return out


def reset_windows():
    """Empty every rolling window (test isolation)."""
    with _qps_lock:
        _qps_window.clear()
    with _slo_lock:
        _slo_submits.clear()
        _slo_done.clear()
        _slo_ttft.clear()
        _slo_tpot.clear()
    with _decode_lock:
        _tokens_window.clear()
        _decode_steps.clear()
        _prefill_steps.clear()
        _spec_window.clear()
        _prefix_window.clear()


def record_compiles(n=1):
    if _monitor.enabled():
        _monitor.counter("serving.compiles").inc(int(n))


def record_retry(where=""):
    if _monitor.enabled():
        _monitor.counter("serving.retries").inc()
        _monitor.emit(kind="serving", event="retry", where=where)


def record_isolated(n_requests):
    if _monitor.enabled():
        _monitor.counter("serving.isolated").inc(int(n_requests))
        _monitor.emit(kind="serving", event="isolated",
                      requests=int(n_requests))


def record_poisoned(error=""):
    if _monitor.enabled():
        _monitor.counter("serving.poisoned").inc()
        _monitor.emit(kind="serving", event="poisoned", error=error)


def goodput_window(now=None):
    """Cheap read of the slo window for control loops: (goodput|None,
    submitted). Unlike :func:`slo_rollup` this publishes nothing and
    skips the latency sort — it's called from the admission hot path.
    The window only fills while the monitor is enabled, so SLO-driven
    shedding (like the rest of the slo plane) needs ``monitor.enable()``."""
    now = time.monotonic() if now is None else now
    with _slo_lock:
        _sweep(_slo_submits, now, SLO_WINDOW_S, key=lambda t: t)
        _sweep(_slo_done, now, SLO_WINDOW_S)
        submitted = len(_slo_submits)
        ok = sum(1 for _, _, w in _slo_done if w)
    return ((ok / submitted) if submitted else None), submitted


# -- resilience series ------------------------------------------------------

#: ``draining`` is a routing state, not a breaker state — a draining
#: replica is healthy but refusing new work while it finishes (or
#: migrates) what it holds; /healthz and the gauges must not read it
#: as ``open``
_BREAKER_STATE_NUM = {"closed": 0, "half_open": 1, "open": 2,
                      "draining": 3}


def record_shed(priority, level, retry_after_ms):
    if _monitor.enabled():
        _monitor.counter("serving.shed").inc()
        _monitor.gauge("serving.shed_level").set(int(level))
        _monitor.emit(kind="serving", event="shed", priority=priority,
                      level=int(level), retry_after_ms=float(retry_after_ms))


def record_shed_level(level):
    if _monitor.enabled():
        _monitor.gauge("serving.shed_level").set(int(level))


def record_breaker_transition(name, old, new, reason=""):
    if _monitor.enabled():
        _monitor.gauge(f"serving.breaker_state.{name}").set(
            _BREAKER_STATE_NUM.get(new, -1))
        if new == "open":
            _monitor.counter("serving.breaker_open").inc()
        elif new == "closed":
            _monitor.counter("serving.breaker_closed").inc()
        _monitor.emit(kind="serving", event="breaker", name=name,
                      old=old, new=new, reason=reason)


def clear_replica_series(replica):
    """Source-scoped stale-gauge hygiene: drop the per-replica gauges a
    closed or restarted replica left behind (``serving.breaker_state.
    <replica>`` and anything under ``serving.replica.<replica>.``) so a
    dead replica's last breaker state can't linger in rollups forever.
    The fleet aggregator's staleness TTL handles the cross-process
    copy; this handles the in-process registry. Returns how many
    metrics were dropped."""
    if not _monitor.enabled():
        return 0
    reg = _monitor.registry()
    removed = int(reg.remove(f"serving.breaker_state.{replica}"))
    removed += reg.clear_prefix(f"serving.replica.{replica}.")
    if removed:
        _monitor.emit(kind="serving", event="replica_series_cleared",
                      replica=replica, removed=removed)
    return removed


def assert_mergeable_latency_histograms(registry=None):
    """Every ``*_ms`` serving/slo histogram in the registry must carry
    exactly :data:`LATENCY_BUCKETS_MS` bounds — the invariant that
    makes fleet bucket-wise merge legal. Raises AssertionError naming
    the offender; returns the checked names (mergeability is asserted,
    not assumed — tests/test_fleet.py and the telemetry smoke both
    call this)."""
    reg = registry if registry is not None else _monitor.registry()
    checked = []
    for name in reg.names():
        if not (name.startswith(("serving.", "slo."))
                and name.endswith("_ms")):
            continue
        m = reg.get(name)
        if m is None or m.kind != "histogram":
            continue
        if tuple(m.buckets) != tuple(LATENCY_BUCKETS_MS):
            raise AssertionError(
                f"histogram {name!r} registered with "
                f"{len(m.buckets)} non-standard bounds — fleet merge "
                f"needs LATENCY_BUCKETS_MS ({len(LATENCY_BUCKETS_MS)} "
                "bounds)")
        checked.append(name)
    return checked


def record_hedge(replica=None):
    if _monitor.enabled():
        _monitor.counter("serving.hedged").inc()
        _monitor.emit(kind="serving", event="hedged", replica=replica)


def record_hedge_win(replica=None):
    if _monitor.enabled():
        _monitor.counter("serving.hedge_wins").inc()
        _monitor.emit(kind="serving", event="hedge_win", replica=replica)


def record_failover(replica, n_requests):
    if _monitor.enabled():
        _monitor.counter("serving.failover").inc()
        _monitor.emit(kind="serving", event="failover", replica=replica,
                      requests=int(n_requests))


def record_replica_hung(replica, age_s):
    if _monitor.enabled():
        _monitor.counter("serving.replica_hung").inc()
        _monitor.emit(kind="serving", event="replica_hung",
                      replica=replica, inflight_age_s=round(float(age_s), 3))


def record_replica_restart(replica):
    if _monitor.enabled():
        _monitor.counter("serving.replica_restarts").inc()
        _monitor.emit(kind="serving", event="replica_restart",
                      replica=replica)


def record_active_replicas(n):
    if _monitor.enabled():
        _monitor.gauge("serving.active_replicas").set(int(n))


def record_lifecycle(event, **fields):
    """Serving lifecycle ledger (``serving.lifecycle.*``): drains,
    undrains, weight swaps, refused publishes — the events /snapshot
    replays to explain a fleet's zero-downtime history."""
    if _monitor.enabled():
        _monitor.counter(f"serving.lifecycle.{event}").inc()
        _monitor.emit(kind="serving", event="lifecycle",
                      lifecycle=event, **fields)


def record_weights_version(version):
    if _monitor.enabled():
        _monitor.gauge("serving.weights_version").set(int(version))


def record_supervisor(decision, **fields):
    """Planner-style decision record: a ledger event the monitor JSONL
    (and /snapshot) can replay to explain why the fleet changed shape."""
    if _monitor.enabled():
        _monitor.counter("serving.supervisor_decisions").inc()
        _monitor.emit(kind="serving", event="supervisor",
                      decision=decision, **fields)


# -- generative decode series -----------------------------------------------

#: rolling window for the slo.tokens_per_s / slo.decode_p99_ms gauges —
#: shorter than SLO_WINDOW_S because token throughput is the supervisor's
#: fast control signal (a 60s window would lag a traffic step by a minute)
TOKENS_WINDOW_S = 15.0

_decode_lock = threading.Lock()
_tokens_window = collections.deque()   # (t_monotonic, n_tokens)
_decode_steps = collections.deque()    # (t, step_ms)
_prefill_steps = collections.deque()   # (t, prefill_ms)
_spec_window = collections.deque()     # (t, proposed, accepted, emitted)
_prefix_window = collections.deque()   # (t, hit: bool)


def record_decode_tick(active_slots, total_slots, n_tokens, step_ms):
    """One fused decode step: ``n_tokens`` emitted across
    ``active_slots`` live sequences in ``step_ms``."""
    occupancy = (float(active_slots) / float(total_slots)
                 if total_slots else 0.0)
    now = time.monotonic()
    with _decode_lock:
        _tokens_window.append((now, int(n_tokens)))
        _decode_steps.append((now, float(step_ms)))
        _sweep(_tokens_window, now, TOKENS_WINDOW_S)
        _sweep(_decode_steps, now, TOKENS_WINDOW_S)
    if not _monitor.enabled():
        return
    _monitor.counter("serving.decode.ticks").inc()
    _monitor.counter("serving.decode.tokens").inc(int(n_tokens))
    _monitor.gauge("serving.decode.slot_occupancy").set(round(occupancy, 4))
    _monitor.histogram("serving.decode.occupancy_hist").observe(occupancy)
    _monitor.histogram("serving.decode.step_ms",
                       buckets=LATENCY_BUCKETS_MS).observe(float(step_ms))


def record_prefill(n_tokens, prefill_ms, bucket):
    """One prefill executable run: a ``bucket``-length prompt ingest."""
    now = time.monotonic()
    with _decode_lock:
        _prefill_steps.append((now, float(prefill_ms)))
        _sweep(_prefill_steps, now, TOKENS_WINDOW_S)
    if not _monitor.enabled():
        return
    _monitor.counter("serving.decode.prefills").inc()
    _monitor.counter("serving.decode.prefill_tokens").inc(int(n_tokens))
    _monitor.histogram("serving.decode.prefill_ms",
                       buckets=LATENCY_BUCKETS_MS).observe(
        float(prefill_ms))
    _monitor.emit(kind="serving", event="prefill", tokens=int(n_tokens),
                  bucket=int(bucket), ms=round(float(prefill_ms), 3))


def record_decode_compile(n=1, what=""):
    """An executable minted by the decode path. Counted both in the
    decode-local series (the zero-growth-after-warmup smoke gate) and
    the engine-wide ``serving.compiles``."""
    if _monitor.enabled():
        _monitor.counter("serving.decode.compiles").inc(int(n))
        _monitor.counter("serving.compiles").inc(int(n))
        if what:
            _monitor.emit(kind="serving", event="decode_compile", what=what)


def record_cache(cache_bytes, capacity, headroom_bytes=None,
                 limit_bytes=None, label=None):
    """KV-arena footprint gauges; ``label`` namespaces a secondary
    arena (the speculative draft pool publishes under
    ``serving.decode.draft_cache_*``)."""
    if not _monitor.enabled():
        return
    prefix = f"serving.decode.{label}_cache" if label \
        else "serving.decode.cache"
    _monitor.gauge(f"{prefix}_bytes").set(int(cache_bytes))
    _monitor.gauge(f"{prefix}_capacity").set(int(capacity))
    if headroom_bytes is not None:
        _monitor.gauge(f"{prefix}_headroom").set(int(headroom_bytes))
    if limit_bytes is not None:
        _monitor.gauge(f"{prefix}_limit").set(int(limit_bytes))


def record_cache_grow(new_capacity):
    if _monitor.enabled():
        _monitor.counter("serving.decode.cache_grows").inc()
        _monitor.emit(kind="serving", event="cache_grow",
                      capacity=int(new_capacity))


def record_rollback(n_tokens, label=None):
    """A KV-ledger truncation: ``n_tokens`` optimistically-written
    positions past the accepted prefix went dead (speculative verify
    reject)."""
    if _monitor.enabled():
        _monitor.counter("serving.decode.rollbacks").inc()
        _monitor.counter("serving.decode.rollback_tokens").inc(
            int(n_tokens))


def record_spec_tick(proposed, accepted, emitted, draft_steps):
    """One speculative tick across the batch: the draft offered
    ``proposed`` tokens (``draft_steps`` autoregressive draft calls),
    the accept-prefix rule kept ``accepted`` of them, and ``emitted``
    tokens actually landed (accepted prefix + the residual resample;
    these are the ONLY tokens that count toward tokens/s). Fills the
    rolling accept-rate window whether or not the monitor is enabled —
    it's a control signal, like :func:`tokens_window`."""
    now = time.monotonic()
    with _decode_lock:
        _spec_window.append((now, int(proposed), int(accepted),
                             int(emitted)))
        _sweep(_spec_window, now, TOKENS_WINDOW_S)
    if not _monitor.enabled():
        return
    _monitor.counter("serving.decode.draft_steps").inc(int(draft_steps))
    _monitor.counter("serving.decode.verify_steps").inc()
    _monitor.counter("serving.decode.spec_proposed").inc(int(proposed))
    _monitor.counter("serving.decode.spec_accepted").inc(int(accepted))
    rate, per_step = spec_window(now)
    if rate is not None:
        _monitor.gauge("serving.decode.accept_rate").set(round(rate, 4))
    if per_step is not None:
        _monitor.gauge("serving.decode.spec_tokens_per_step").set(
            round(per_step, 3))


def spec_window(now=None):
    """Control-loop read of the speculative window: (accept_rate |
    None, emitted tokens per verify step | None) over the last
    :data:`TOKENS_WINDOW_S` seconds. None means no speculative traffic
    in the window."""
    now = time.monotonic() if now is None else now
    with _decode_lock:
        _sweep(_spec_window, now, TOKENS_WINDOW_S)
        if not _spec_window:
            return None, None
        proposed = sum(p for _, p, _a, _e in _spec_window)
        accepted = sum(a for _, _p, a, _e in _spec_window)
        emitted = sum(e for _, _p, _a, e in _spec_window)
        steps = len(_spec_window)
    rate = (accepted / proposed) if proposed else None
    return rate, emitted / steps


def tokens_window(now=None):
    """Cheap control-loop read: (tokens_per_s | None, decode_p99_ms |
    None) over the last :data:`TOKENS_WINDOW_S` seconds. None means no
    decode traffic in the window — the supervisor must not treat an
    idle engine as a throughput breach. Unlike the slo.* window this
    fills whether or not the monitor is enabled (the engine always
    appends; only the gauges need the monitor)."""
    now = time.monotonic() if now is None else now
    with _decode_lock:
        _sweep(_tokens_window, now, TOKENS_WINDOW_S)
        _sweep(_decode_steps, now, TOKENS_WINDOW_S)
        if not _tokens_window:
            return None, None
        total = sum(k for _, k in _tokens_window)
        elapsed = max(now - _tokens_window[0][0], 0.25)
        steps = sorted(ms for _, ms in _decode_steps)
    return total / elapsed, _percentile(steps, 0.99)


def decode_rollup(now=None):
    """Publish the decode SLO window: ``slo.tokens_per_s``,
    ``slo.decode_p99_ms``, and the rolling prefill/decode time ratio.
    Returns the dict (gauges only when the monitor is enabled)."""
    now = time.monotonic() if now is None else now
    tps, p99 = tokens_window(now)
    with _decode_lock:
        _sweep(_prefill_steps, now, TOKENS_WINDOW_S)
        pf = sorted(ms for _, ms in _prefill_steps)
        prefill_ms = sum(pf)
        decode_ms = sum(ms for _, ms in _decode_steps)
    busy = prefill_ms + decode_ms
    ratio = (prefill_ms / busy) if busy > 0 else None
    accept_rate, spec_per_step = spec_window(now)
    out = {"tokens_per_s": tps, "decode_p99_ms": p99,
           "prefill_p50_ms": _percentile(pf, 0.50),
           "prefill_ratio": ratio,
           "accept_rate": accept_rate,
           "spec_tokens_per_step": spec_per_step}
    if _monitor.enabled():
        if tps is not None:
            _monitor.gauge("slo.tokens_per_s").set(round(tps, 3))
        if p99 is not None:
            _monitor.gauge("slo.decode_p99_ms").set(round(p99, 3))
        if ratio is not None:
            _monitor.gauge("serving.decode.prefill_ratio").set(
                round(ratio, 4))
    return out


# -- disaggregated serving series (handoff + prefix cache) ------------------


def record_handoff(n_bytes, planned_ms, actual_ms, queue_depth=0):
    """One planned prefill→decode KV transfer: ``n_bytes`` is the exact
    spec arithmetic (``bytes_per_token × bucket``), ``planned_ms`` the
    link-model prediction, ``actual_ms`` the measured transfer +
    decode-slot wait."""
    if not _monitor.enabled():
        return
    _monitor.counter("serving.handoff.transfers").inc()
    _monitor.counter("serving.handoff.bytes_total").inc(int(n_bytes))
    _monitor.gauge("serving.handoff.bytes").set(int(n_bytes))
    _monitor.gauge("serving.handoff.planned_ms").set(
        round(float(planned_ms), 6))
    _monitor.gauge("serving.handoff.queue_depth").set(int(queue_depth))
    _monitor.histogram("serving.handoff.ms",
                       buckets=LATENCY_BUCKETS_MS).observe(
        float(actual_ms))
    _monitor.emit(kind="serving", event="handoff", bytes=int(n_bytes),
                  planned_ms=round(float(planned_ms), 6),
                  ms=round(float(actual_ms), 3),
                  queue_depth=int(queue_depth))


def record_prefix_lookup(hit, lookup_ms):
    """One prefix-cache probe. Fills the rolling hit-rate window
    whether or not the monitor is enabled — it's a control signal,
    like :func:`spec_window`."""
    now = time.monotonic()
    with _decode_lock:
        _prefix_window.append((now, bool(hit)))
        _sweep(_prefix_window, now, TOKENS_WINDOW_S)
    if not _monitor.enabled():
        return
    _monitor.counter("serving.prefix.hits" if hit
                     else "serving.prefix.misses").inc()
    _monitor.histogram("serving.prefix.lookup_ms",
                       buckets=LATENCY_BUCKETS_MS).observe(
        float(lookup_ms))
    rate = prefix_window(now)
    if rate is not None:
        _monitor.gauge("serving.prefix.hit_rate").set(round(rate, 4))


def prefix_window(now=None):
    """Rolling prefix hit rate over the last :data:`TOKENS_WINDOW_S`
    seconds, or None with no lookups in the window."""
    now = time.monotonic() if now is None else now
    with _decode_lock:
        _sweep(_prefix_window, now, TOKENS_WINDOW_S)
        if not _prefix_window:
            return None
        hits = sum(1 for _, h in _prefix_window if h)
        total = len(_prefix_window)
    return hits / total


def record_prefix_cache(cache_bytes, entries, budget_bytes=None):
    """Resident prefix-cache footprint gauges (published by the cache
    on every insert/evict edge)."""
    if not _monitor.enabled():
        return
    _monitor.gauge("serving.prefix.bytes").set(int(cache_bytes))
    _monitor.gauge("serving.prefix.entries").set(int(entries))
    if budget_bytes is not None:
        _monitor.gauge("serving.prefix.budget_bytes").set(
            int(budget_bytes))


def record_prefix_evict(n=1, freed_bytes=0):
    if _monitor.enabled():
        _monitor.counter("serving.prefix.evictions").inc(int(n))
        _monitor.emit(kind="serving", event="prefix_evict", n=int(n),
                      freed_bytes=int(freed_bytes))
