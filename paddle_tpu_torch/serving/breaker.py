"""paddle_tpu_torch.serving.breaker — per-replica circuit breaking.

Counterpart of ``paddle_tpu/serving/breaker.py``, its transitions
recorded through the port's ``serving/metrics.py``.

A replica that keeps failing (device error, poisoned state, hung
runtime) must stop receiving traffic *before* callers notice: every
request routed at a dead replica is a blown SLA the healthy replicas
could have served. The breaker is the standard three-state machine,
kept deliberately boring:

* **closed** — healthy; every request allowed. ``failure_threshold``
  *consecutive* failures (errors or supervision timeouts) trip it open.
* **open** — no traffic at all for ``cooldown_s``; the replica gets
  time to recover (a transient hang clears, the supervisor restarts
  it) without burning live requests as probes.
* **half_open** — after the cooldown, up to ``half_open_probes``
  requests are allowed through as budgeted test traffic (the
  supervisor's active probe uses the same budget). One success closes
  the breaker; one failure re-opens it and restarts the cooldown.

State is exported as ``serving.breaker_state.<name>`` (0 = closed,
1 = half_open, 2 = open) plus a ``serving.breaker_open`` /
``serving.breaker_closed`` transition counter pair, so a dashboard
shows both where the fleet is *now* and how often it flaps.

The clock is injectable (the :class:`~paddle_tpu_torch.resilience.
deadline.Deadline` convention) so tests replay exact open→half-open schedules
without sleeping.
"""
from __future__ import annotations

import threading
import time

from . import metrics

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class CircuitBreaker:
    """See module docstring. Thread-safe; every transition is recorded
    through :func:`serving.metrics.record_breaker_transition`."""

    def __init__(self, name="", failure_threshold=3, cooldown_s=5.0,
                 half_open_probes=1, clock=time.monotonic):
        if failure_threshold < 1:
            raise ValueError(
                f"failure_threshold must be >= 1, got {failure_threshold}")
        self.name = str(name)
        self.failure_threshold = int(failure_threshold)
        self.cooldown_s = float(cooldown_s)
        self.half_open_probes = max(1, int(half_open_probes))
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive = 0
        self._opened_at = None
        self._probes_inflight = 0
        self.open_count = 0       # lifetime open transitions (flap gauge)

    # -- state ------------------------------------------------------------

    def _promote_locked(self):
        """open → half_open once the cooldown has elapsed."""
        if self._state == OPEN and \
                self._clock() - self._opened_at >= self.cooldown_s:
            self._transition_locked(HALF_OPEN, "cooldown")

    def _transition_locked(self, new, reason):
        old, self._state = self._state, new
        if new == OPEN:
            self._opened_at = self._clock()
            self.open_count += 1
        if new in (OPEN, CLOSED):
            self._probes_inflight = 0
        if new == CLOSED:
            self._consecutive = 0
        if old != new:
            metrics.record_breaker_transition(self.name, old, new, reason)

    @property
    def state(self):
        """Live state (reading it applies the open→half_open cooldown
        promotion, so pollers see ``half_open`` the moment it's due)."""
        with self._lock:
            self._promote_locked()
            return self._state

    # -- routing ----------------------------------------------------------

    def allow(self):
        """May one request be routed to this replica right now? In
        half_open this *consumes* one probe slot from the budget."""
        with self._lock:
            self._promote_locked()
            if self._state == CLOSED:
                return True
            if self._state == HALF_OPEN and \
                    self._probes_inflight < self.half_open_probes:
                self._probes_inflight += 1
                return True
            return False

    # -- outcomes ---------------------------------------------------------

    def record_success(self):
        with self._lock:
            self._promote_locked()
            if self._state == HALF_OPEN:
                self._transition_locked(CLOSED, "probe_ok")
            self._consecutive = 0

    def record_failure(self, reason=""):
        with self._lock:
            self._promote_locked()
            self._consecutive += 1
            if self._state == HALF_OPEN:
                self._transition_locked(OPEN, reason or "probe_failed")
            elif self._state == CLOSED and \
                    self._consecutive >= self.failure_threshold:
                self._transition_locked(OPEN, reason or "threshold")

    def trip(self, reason=""):
        """Force open immediately (the supervisor's verdict on a hung
        replica — a timeout is not a vote, it's a diagnosis)."""
        with self._lock:
            if self._state != OPEN:
                self._transition_locked(OPEN, reason or "tripped")

    def __repr__(self):
        return (f"CircuitBreaker({self.name!r}, state={self.state}, "
                f"consecutive={self._consecutive})")
