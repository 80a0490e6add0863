"""paddle_tpu_torch.serving.admission — backpressure, SLAs, and blast
radius.

Counterpart of ``paddle_tpu/serving/admission.py``, with its metrics,
request-trace calls and the shed ladder's SLO-goodput escalation.

An online endpoint fails three ways a training loop never sees:

* **Overload.** An unbounded queue converts overload into unbounded
  latency for *everyone*. The controller bounds queue depth — but a
  binary full/not-full reject degrades *everything equally*, which is
  the wrong shape for real traffic. Admission is a **shed ladder**
  instead: as the queue fills (and, independently, when the live
  ``slo.*`` goodput window dips below its floor) low-priority classes
  are shed first with a retryable :class:`ShedError` carrying a
  ``retry_after_ms`` hint, then the effective max batch shrinks so
  latency stays bounded, and only at the top rung does everyone get
  :class:`QueueFullError` (itself a :class:`ShedError`, so every
  overload error is retryable-with-backoff). High-priority traffic
  keeps its SLA while the endpoint degrades, instead of everyone
  failing a little.
* **Stale work.** A request past its deadline is pure waste: the caller
  is gone, but executing it still burns a batch slot. Deadlines are
  checked **at dequeue** (:meth:`AdmissionController.is_expired`),
  so an expired request is resolved with :class:`DeadlineExpired` and
  never occupies a slot in the batch it would have ridden.
* **Poison.** One malformed request inside a coalesced batch fails the
  whole executable call. The error path is classified with
  ``resilience.retry.RetryPolicy``: transient failures retry the batch
  (bounded, backed off); terminal failures re-run the batch
  request-by-request (:meth:`AdmissionController.isolate`) so exactly
  the poisoned request's future carries the exception and every
  innocent neighbour still resolves.
"""
from __future__ import annotations

import time

from ..resilience.deadline import Deadline
from ..resilience.retry import RetryPolicy
from . import metrics

#: Priority classes, lower number = more important. ``submit(...,
#: priority=)`` accepts either the name or the number.
PRIORITIES = {"high": 0, "normal": 1, "low": 2}


def resolve_priority(priority):
    """Accept 'high'/'normal'/'low' or an int; default 'normal'."""
    if priority is None:
        return PRIORITIES["normal"]
    if isinstance(priority, str):
        try:
            return PRIORITIES[priority]
        except KeyError:
            raise ValueError(
                f"unknown priority {priority!r}; expected one of "
                f"{sorted(PRIORITIES)}") from None
    return int(priority)


class ShedError(RuntimeError):
    """The admission ladder shed this request. Transient by contract —
    ``RetryPolicy.is_transient`` sees ``.transient`` — and carries a
    ``retry_after_ms`` hint that ``retry_call`` honours as a floor on
    its backoff delay, so a retrying caller naturally backs off harder
    the deeper the ladder it was shed from."""

    transient = True

    def __init__(self, msg, retry_after_ms=25.0, level=1, priority=None):
        super().__init__(msg)
        self.retry_after_ms = float(retry_after_ms)
        self.level = int(level)
        self.priority = priority

    @property
    def retry_after_s(self):
        return self.retry_after_ms / 1e3


class QueueFullError(ShedError):
    """Top rung of the shed ladder: the serving queue is at
    ``max_queue_depth`` and even high-priority traffic is rejected.
    Raised synchronously from ``submit()`` — no future is created."""

    def __init__(self, msg, retry_after_ms=25.0, level=3, priority=None):
        super().__init__(msg, retry_after_ms=retry_after_ms, level=level,
                         priority=priority)


class DeadlineExpired(TimeoutError):
    """Set on a request's future when its SLA deadline passed before a
    batch slot opened (the request was dropped at dequeue, unexecuted)."""


class AdmissionController:
    """Enqueue-time backpressure + dequeue-time SLA + failure triage.

    ``default_deadline_ms`` stamps a deadline on every request that
    didn't bring its own; ``None`` means requests without explicit
    deadlines never expire. ``retry_policy`` classifies batch-execution
    failures (transient → retry, terminal → isolate); the default is a
    fast two-attempt policy suited to in-process serving.
    """

    #: queue-depth fractions at which ladder levels 1..3 engage
    SHED_LEVELS = (0.5, 0.75, 0.9)
    #: ladder level -> lowest priority still admitted (smaller = more
    #: important). Level 1 sheds 'low', level 2 sheds 'normal'+'low';
    #: level 3 (and the hard cap) rejects everyone via QueueFullError.
    _MIN_SHED_PRIORITY = {1: 2, 2: 1, 3: 1}

    def __init__(self, max_queue_depth=256, default_deadline_ms=None,
                 retry_policy=None, shed=True, shed_levels=None,
                 slo_goodput_floor=0.90, retry_after_ms=25.0):
        if max_queue_depth < 1:
            raise ValueError(
                f"max_queue_depth must be >= 1, got {max_queue_depth}")
        self.max_queue_depth = int(max_queue_depth)
        self.default_deadline_ms = default_deadline_ms
        self.retry_policy = retry_policy or RetryPolicy(
            max_attempts=2, base_delay=0.01, max_delay=0.2)
        self.shed = bool(shed)
        self.shed_levels = tuple(shed_levels) if shed_levels is not None \
            else self.SHED_LEVELS
        self.slo_goodput_floor = slo_goodput_floor
        self.retry_after_ms = float(retry_after_ms)
        # SLO window reads are cached briefly: admission runs per
        # submit, the 60s goodput window doesn't move that fast
        self._slo_cache = (0.0, 0)   # (checked_at, slo_escalation)
        # optional observer (the engine's stats dict): called with
        # "rejected" / "expired" / "poisoned" / "shed"
        self.on_event = None

    def _note(self, event):
        if self.on_event is not None:
            self.on_event(event)

    # -- the shed ladder ---------------------------------------------------

    def _slo_escalation(self, now=None):
        """+1 ladder level while the live slo.goodput window sits below
        the floor (with enough submissions in the window to mean it)."""
        if self.slo_goodput_floor is None:
            return 0
        now = time.monotonic() if now is None else now
        checked, esc = self._slo_cache
        if now - checked <= 0.25:
            return esc
        goodput, submitted = metrics.goodput_window(now)
        esc = 1 if (goodput is not None and submitted >= 20
                    and goodput < self.slo_goodput_floor) else 0
        self._slo_cache = (now, esc)
        return esc

    def shed_level(self, depth):
        """Current ladder rung: 0 (admit all) .. 3 (reject all), from
        queue-depth fraction plus the SLO escalation."""
        if not self.shed:
            return 0
        frac = depth / self.max_queue_depth
        level = 0
        for i, threshold in enumerate(self.shed_levels):
            if frac >= threshold:
                level = i + 1
        return min(level + self._slo_escalation(), 3)

    def _retry_after(self, level):
        return self.retry_after_ms * (2 ** (max(level, 1) - 1))

    def effective_max_batch(self, max_batch, depth):
        """Ladder rung 2 halves the largest batch the picker may build,
        rung 3 quarters it — bounded service latency is the lever that
        keeps already-admitted high-priority work inside its SLA."""
        level = self.shed_level(depth)
        if level >= 3:
            return max(1, max_batch // 4)
        if level == 2:
            return max(1, max_batch // 2)
        return max_batch

    # -- enqueue ----------------------------------------------------------

    def admit(self, request, depth):
        """Called under the queue lock before enqueue. Walks the shed
        ladder (priority shed → reject-with-retry-after) before the
        hard capacity check; otherwise stamps the default deadline on
        an undeadlined request."""
        tr = getattr(request, "trace", None)
        if depth >= self.max_queue_depth:
            metrics.record_reject()
            self._note("rejected")
            if tr is not None:
                # the request trace outlives this synchronous reject: a
                # caller that retries hands the same context back via
                # submit(trace=), keeping one record per logical request
                tr.shed(level=3, retry_after_ms=self._retry_after(3))
            raise QueueFullError(
                f"serving queue full ({depth}/{self.max_queue_depth} "
                f"requests waiting)",
                retry_after_ms=self._retry_after(3))
        level = self.shed_level(depth)
        if level:
            prio = getattr(request, "priority", 1)
            min_shed = self._MIN_SHED_PRIORITY.get(min(level, 3), 2)
            if level >= 3 or prio >= min_shed:
                ra = self._retry_after(level)
                metrics.record_shed(prio, level, ra)
                self._note("shed")
                if tr is not None:
                    tr.shed(level=level, retry_after_ms=ra)
                raise ShedError(
                    f"request shed at ladder level {level} "
                    f"(priority={prio}, queue {depth}/"
                    f"{self.max_queue_depth}); retry after {ra:.0f}ms",
                    retry_after_ms=ra, level=level, priority=prio)
        if request.deadline is None and self.default_deadline_ms is not None:
            request.deadline = Deadline.after_ms(self.default_deadline_ms)

    # -- dequeue ----------------------------------------------------------

    @staticmethod
    def is_expired(request, now=None):
        return request.deadline is not None and request.deadline.expired(now)

    def expire(self, request):
        """Resolve an expired request's future (called after it was
        removed from the queue, before any batch slot was assigned)."""
        metrics.record_expired()
        self._note("expired")
        request.resolve_exception(DeadlineExpired(
            f"deadline expired {-request.deadline.remaining() * 1e3:.1f}ms "
            f"ago before a batch slot opened"))

    # -- failure triage ----------------------------------------------------

    def isolate(self, requests, run_one, batch_error):
        """Terminal (or retry-exhausted) batch failure: re-run each
        request on its own so one poisoned request fails only its own
        future. ``run_one(request)`` must execute AND resolve the
        request; any exception it raises is routed to that request's
        future here."""
        metrics.record_isolated(len(requests))
        for r in requests:
            try:
                run_one(r)
            except BaseException as e:  # noqa: BLE001 - routed to future
                metrics.record_poisoned(error=repr(e))
                self._note("poisoned")
                e.__context__ = batch_error
                r.resolve_exception(e)
