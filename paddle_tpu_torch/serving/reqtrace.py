"""paddle_tpu_torch.serving.reqtrace — request-scoped tracing and SLO
attribution.

Counterpart of ``paddle_tpu/serving/reqtrace.py``, pure host Python. It
mints one :class:`RequestTrace` per logical request at ``submit()`` and
rides it through every thread hand-off: the batcher's drain thread, a
hand-off between decode engines (``disown_inflight``/``requeue``), and the
``GenerateEngine`` tick loop. On completion it emits exactly one
``serving.request`` JSONL record that splits the request's lifetime into
stages, each blamed on where the time went:

* ``queue_ms``        — waiting in an admission queue
* ``shed_retry_ms``   — time between a shed and the caller's resubmit
* ``assemble_ms``     — coalesce + pad on the drain thread
* ``execute_ms``      — device execution (all attempts)
* ``retry_backoff_ms``— sleeping between transient-fault retries
* ``scatter_ms``      — host transfer + row split + future resolution
* ``prefill_ms``      — decode-engine prompt prefill
* ``prefix_lookup_ms``— disaggregated serving's prefix-cache probe
* ``handoff_ms``      — prefill→decode KV transfer + decode-slot wait
* ``decode_ms``       — wall time from first token to completion
* ``hedge_ms``        — lag between the primary submit and the winning
                        hedge shadow's dispatch

plus ``ttft_ms`` / ``tpot_ms`` as first-class fields — the two numbers
generative serving is actually judged on (time-to-first-token,
time-per-output-token).

Design rules:

* **Exactly once.** The terminal record rides the idempotent future
  funnel: ``Request.resolve_*`` only finalizes when its underlying
  ``set_result``/``set_exception`` actually WON the race. A hedge shadow
  and its primary share one context; whichever resolves first emits the
  record, the loser's attempt is swallowed with its
  ``InvalidStateError``.
* **Audited attribution.** Stages are boundary-derived (each ``to()``
  transition credits the elapsed interval to the PREVIOUS stage), so
  ``stage_sum_ms`` equals the measured end-to-end latency by
  construction; ``recon`` (their ratio) is emitted on every record, and
  a ratio more than 5% from 1 counts in ``serving.request_recon_fail``.
* **One flag check when disabled.** ``new_trace()`` returns None unless
  the monitor is enabled; every instrumentation site in the spine is a
  single ``req.trace is None`` test.
"""
from __future__ import annotations

import collections
import itertools
import os
import threading
import time

from .. import monitor as _monitor
from ..monitor import trace as _trace

_MONO = time.monotonic
_ids = itertools.count(1)

#: gap between a winning attempt's dispatch and the request's birth,
#: blamed by how that attempt came to exist
_GAP_STAGE = {"hedge": "hedge", "retry": "shed_retry"}

#: reconciliation tolerance of ``recon``
RECON_TOL = 0.05


def _exemplar_cap():
    try:
        return max(1, int(os.environ.get("PADDLE_TPU_TORCH_REQ_EXEMPLARS",
                                         "8")))
    except ValueError:
        return 8


# -- exemplar rings + recent-record buffer ----------------------------------

_lock = threading.Lock()
_worst_ttft = []            # records sorted desc by ttft_ms, capped
_worst_tpot = []            # records sorted desc by tpot_ms, capped
_recent = collections.deque(maxlen=512)


def _remember(rec):
    cap = _exemplar_cap()
    with _lock:
        _recent.append(rec)
        for key, ring in (("ttft_ms", _worst_ttft),
                          ("tpot_ms", _worst_tpot)):
            v = rec.get(key)
            if v is None:
                continue
            ring.append(rec)
            ring.sort(key=lambda r: -(r.get(key) or 0.0))
            del ring[cap:]


def exemplars():
    """The slow-request block for /snapshot and flight_record(): the N
    worst completed waterfalls by ttft and by tpot (full stage
    breakdowns + hop lineage, already JSON-safe)."""
    with _lock:
        return {"cap": _exemplar_cap(),
                "worst_ttft": list(_worst_ttft),
                "worst_tpot": list(_worst_tpot)}


def recent(n=None):
    """The last completed ``serving.request`` records (newest last)."""
    with _lock:
        out = list(_recent)
    return out if n is None else out[-int(n):]


def reset():
    """Clear exemplar rings + the recent buffer (tests, fresh runs)."""
    with _lock:
        del _worst_ttft[:]
        del _worst_tpot[:]
        _recent.clear()


# -- the per-request context ------------------------------------------------

class RequestTrace:
    """Shared identity of one logical request: id, birth time, hop
    lineage, and the done-latch that makes the terminal record unique
    across every attempt (primary, hedge shadows, shed retries)."""

    __slots__ = ("rid", "fid", "kind", "priority", "t0", "lock", "done",
                 "hops", "sheds", "attempts", "flow_open", "record_")

    def __init__(self, kind="serve", priority=1):
        n = next(_ids)
        self.rid = f"{os.getpid()}-{n}"
        self.fid = n                      # numeric flow-event id
        self.kind = kind
        self.priority = priority
        self.t0 = _MONO()
        self.lock = threading.Lock()
        self.done = False
        self.hops = []
        self.sheds = 0
        self.attempts = 0
        self.flow_open = False
        self.record_ = None

    def attempt(self, origin="submit", replica=None, version=None):
        """Mint one dispatch attempt (primary submit, hedge shadow, or
        post-shed retry). The attempt IS what rides on ``req.trace``.
        ``version`` stamps the serving fleet's weights version — the
        audit trail a rolling hot-swap leaves on every record."""
        with self.lock:
            self.attempts += 1
        return Attempt(self, origin, replica, version)

    def hop(self, kind, replica=None, **fields):
        """Record one lineage hop (enqueue/hedge/failover/requeue/shed)
        with a relative timestamp; bounded so a requeue loop can't grow
        the record without limit."""
        entry = {"hop": kind, "t_ms": round((_MONO() - self.t0) * 1e3, 3)}
        if replica is not None:
            entry["replica"] = replica
        if fields:
            entry.update(fields)
        with self.lock:
            if len(self.hops) < 64:
                self.hops.append(entry)

    def note_shed(self, level=None, retry_after_ms=None):
        with self.lock:
            self.sheds += 1
        self.hop("shed", level=level, retry_after_ms=retry_after_ms)

    def record(self):
        """The finalized ``serving.request`` record, or None while the
        request is still in flight."""
        return self.record_


class Attempt:
    """One dispatch timeline within a :class:`RequestTrace` — a stage
    state machine where ``to(stage)`` credits the elapsed interval to
    the stage being LEFT, so the breakdown sums to wall time by
    construction. ``req.trace`` holds the Attempt (None = disabled)."""

    __slots__ = ("ctx", "origin", "replica", "version", "t_start", "stage",
                 "t_mark", "stages", "t_first", "n_tokens", "spec_proposed",
                 "spec_accepted", "prefix_hit")

    def __init__(self, ctx, origin, replica, version=None):
        now = _MONO()
        self.ctx = ctx
        self.origin = origin
        self.replica = replica
        self.version = version
        self.t_start = now
        self.stage = "queue"
        self.t_mark = now
        self.stages = {}
        self.t_first = None
        self.n_tokens = None
        self.spec_proposed = 0
        self.spec_accepted = 0
        # None = request never consulted a prefix cache (single-engine
        # path); True/False = disaggregated lookup verdict
        self.prefix_hit = None

    # -- stage machine ------------------------------------------------------

    def to(self, stage, now=None):
        """Enter ``stage``, crediting the time since the last transition
        to the stage being left. No-op once the context has finalized —
        a disowned attempt waking up on a hung replica can't corrupt the
        already-emitted record."""
        ctx = self.ctx
        with ctx.lock:
            if ctx.done:
                return
            if now is None:
                now = _MONO()
            self.stages[self.stage] = (self.stages.get(self.stage, 0.0)
                                       + (now - self.t_mark))
            self.stage = stage
            self.t_mark = now

    def first_token(self):
        """The TTFT moment: prompt prefill produced a real token. A
        failover re-prefill overwrites it — TTFT is honest about when
        the first token that COUNTED arrived."""
        now = _MONO()
        self.to("decode", now)
        self.t_first = now

    def note_tokens(self, n):
        """``tokens`` (and the ``tpot_ms`` derived from it) count
        *accepted* tokens — the ones the caller actually receives. A
        speculative engine's rejected draft proposals never land here;
        they show in the ``accept_rate`` field instead."""
        self.n_tokens = int(n)

    def note_spec(self, proposed, accepted):
        """Per-tick speculative tally for this sequence: draft tokens
        offered vs accepted by the verify step."""
        self.spec_proposed += int(proposed)
        self.spec_accepted += int(accepted)

    def note_prefix(self, hit):
        """Disaggregated prefill's prefix-cache verdict for this
        request (stamped once at lookup; rides to the terminal
        record's ``prefix_hit`` field)."""
        self.prefix_hit = bool(hit)

    def shed(self, level=None, retry_after_ms=None):
        self.ctx.note_shed(level, retry_after_ms)

    def hop(self, kind, replica=None, **fields):
        self.ctx.hop(kind, replica=replica, **fields)

    # -- the terminal record ------------------------------------------------

    def finalize(self, outcome, error=None):
        """Emit the one terminal record — called from ``resolve_*`` only
        when the future transition actually won. Returns the record, or
        None if another attempt already finalized the context."""
        ctx = self.ctx
        now = _MONO()
        with ctx.lock:
            if ctx.done:
                return None
            ctx.done = True
            # credit the residual of the open stage, so even a request
            # that dies waiting in queue reconciles exactly
            self.stages[self.stage] = (self.stages.get(self.stage, 0.0)
                                       + (now - self.t_mark))
            # the lag between the request's birth and this attempt's
            # dispatch: hedge delay, shed backoff, or (for the primary)
            # plain queue time
            gap = self.t_start - ctx.t0
            if gap > 0:
                label = _GAP_STAGE.get(self.origin, "queue")
                self.stages[label] = self.stages.get(label, 0.0) + gap
            hops = list(ctx.hops)
            attempts = ctx.attempts
            sheds = ctx.sheds

        e2e_ms = (now - ctx.t0) * 1e3
        stage_sum_ms = sum(self.stages.values()) * 1e3
        tokens = self.n_tokens
        ttft_ms = tpot_ms = None
        if outcome == "ok":
            if ctx.kind == "decode":
                if self.t_first is not None:
                    ttft_ms = (self.t_first - ctx.t0) * 1e3
                    if tokens is not None and tokens > 1:
                        tpot_ms = (now - self.t_first) * 1e3 / (tokens - 1)
            else:
                # a fixed-shape request's single answer IS its first
                # token: ttft == e2e, and tpot is undefined
                ttft_ms = e2e_ms

        rec = {
            "rid": ctx.rid,
            "reqkind": ctx.kind,
            "outcome": outcome,
            "priority": ctx.priority,
            "origin": self.origin,
            "replica": self.replica,
            "attempts": attempts,
            "sheds": sheds,
            "tokens": tokens,
            "e2e_ms": round(e2e_ms, 3),
            "ttft_ms": round(ttft_ms, 3) if ttft_ms is not None else None,
            "tpot_ms": round(tpot_ms, 3) if tpot_ms is not None else None,
            "stage_sum_ms": round(stage_sum_ms, 3),
            "recon": (round(stage_sum_ms / e2e_ms, 4) if e2e_ms > 0
                      else 1.0),
            "hops": hops,
        }
        if self.version is not None:
            rec["weights_version"] = self.version
        if self.prefix_hit is not None:
            rec["prefix_hit"] = self.prefix_hit
        for stage, secs in self.stages.items():
            rec[f"{stage}_ms"] = round(secs * 1e3, 3)
        if self.spec_proposed:
            rec["spec_proposed"] = self.spec_proposed
            rec["spec_accepted"] = self.spec_accepted
            rec["accept_rate"] = round(
                self.spec_accepted / self.spec_proposed, 4)
        if error is not None:
            rec["error"] = error
        ctx.record_ = rec

        if _monitor.enabled():
            _monitor.counter("serving.request_records").inc()
            if abs(rec["recon"] - 1.0) > RECON_TOL:
                _monitor.counter("serving.request_recon_fail").inc()
            _monitor.emit(kind="serving.request", **rec)
            if outcome == "ok":
                from . import metrics
                metrics.record_request_slo(ttft_ms, tpot_ms)
        _remember(rec)
        if _trace.enabled():
            with _trace.span("serving.request_done", rid=ctx.rid,
                             outcome=outcome):
                _trace.flow_end("serving.req", ctx.fid)
        return rec


# -- spine-facing helpers ---------------------------------------------------

def new_trace(kind="serve", priority=1):
    """Mint the per-request context at submit() — None unless the
    monitor is enabled (the ONE flag check the disabled path pays)."""
    if not _monitor.enabled():
        return None
    return RequestTrace(kind, priority)


def attach(trace, kind="serve", priority=1, replica=None, version=None):
    """The make_request() entry point: mint a fresh context (trace=None)
    or a retry attempt on an existing one (trace=RequestTrace from a
    shed caller re-submitting). Returns the Attempt to ride on
    ``req.trace``, or None when tracing is off. ``version`` is the
    serving engine's current weights version (stamped into the terminal
    record)."""
    if trace is None:
        ctx = new_trace(kind, priority)
        return None if ctx is None else ctx.attempt("submit", replica,
                                                    version)
    if isinstance(trace, Attempt):
        trace = trace.ctx
    return trace.attempt("retry", replica, version)


def transition(requests, stage, flow=False):
    """Batch-wide stage transition from the drain thread; optionally
    drop a flow-event breadcrumb inside the caller's enclosing span so
    Perfetto draws the cross-thread hop arrow."""
    for r in requests:
        tr = r.trace
        if tr is not None:
            tr.to(stage)
            if flow:
                flow_mark(tr)


def flow_mark(att, terminal=False):
    """Emit the request's flow event on the current thread (ph "s" the
    first time its context is seen, "t" after, "f" at terminal). Must be
    called inside an open span for Perfetto to anchor the arrow."""
    if att is None or not _trace.enabled():
        return
    ctx = att.ctx if isinstance(att, Attempt) else att
    if terminal:
        _trace.flow_end("serving.req", ctx.fid)
        return
    if not ctx.flow_open:
        ctx.flow_open = True
        _trace.flow_start("serving.req", ctx.fid, rid=ctx.rid)
    else:
        _trace.flow_step("serving.req", ctx.fid)


__all__ = ["RequestTrace", "Attempt", "new_trace", "attach", "transition",
           "flow_mark", "exemplars", "recent", "reset", "RECON_TOL"]
