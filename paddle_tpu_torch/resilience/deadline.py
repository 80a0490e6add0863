"""paddle_tpu_torch.resilience.deadline — wall-time budgets for online work.

Training tolerates slow steps; serving does not. A request that has
already blown its SLA is pure waste: executing it burns a batch slot
that a live request could have used, and the caller gave up long ago.
:class:`Deadline` is the one representation of "this work is worthless
after T" shared by the serving tier (``paddle_tpu.serving.admission``
drops expired requests at dequeue, before they occupy a batch slot)
and available to any queue consumer with the same problem.

Monotonic by default (``time.monotonic`` — wall-clock jumps must not
expire a request), with an injectable clock so tests replay exact
expiry schedules without sleeping.
"""
from __future__ import annotations

import time


class Deadline:
    """An absolute expiry instant, built from a relative budget.

    ``Deadline(0.5)`` expires half a second from construction. A zero
    or negative budget is already expired — useful for "drop if any
    queueing at all" requests.
    """

    __slots__ = ("expires_at", "_clock")

    def __init__(self, timeout_s, clock=time.monotonic):
        self._clock = clock
        self.expires_at = clock() + float(timeout_s)

    @classmethod
    def after_ms(cls, ms, clock=time.monotonic):
        return cls(float(ms) / 1e3, clock=clock)

    def remaining(self, now=None):
        """Seconds until expiry (negative once past it)."""
        if now is None:
            now = self._clock()
        return self.expires_at - now

    def expired(self, now=None):
        return self.remaining(now) <= 0.0

    def __repr__(self):
        r = self.remaining()
        state = f"{r * 1e3:.1f}ms left" if r > 0 else "expired"
        return f"Deadline({state})"
