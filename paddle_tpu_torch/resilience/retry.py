"""paddle_tpu_torch.resilience.retry — bounded exponential backoff with
jitter.

Counterpart of ``paddle_tpu/resilience/retry.py`` without its monitor
hook (the counters, JSONL records and backoff spans come back with the
port's monitor). A *transient* failure (I/O hiccup,
injected fault, anything raising :class:`TransientError` or carrying a
truthy ``.transient`` attribute) is retried up to a max-attempt budget
with exponentially growing, jittered sleeps; a *terminal* failure (a
bug: TypeError, ValueError, pickling garbage) propagates immediately —
retrying it would only hide the stack trace.

Jitter is deterministic per policy (seeded ``random.Random``) so tests
and the chaos CI gate replay identical schedules.
"""
from __future__ import annotations

import functools
import random
import time


class TransientError(Exception):
    """A failure the caller expects to succeed on retry (used as the
    marker class by fault injection and as a base for user loaders)."""

    transient = True


class RetryExhausted(RuntimeError):
    """Raised (from the last transient error) when the attempt budget is
    spent. ``__cause__`` carries the final underlying exception."""


# Conservative default classification: network/filesystem flakiness is
# retryable, programming errors are not.
_TRANSIENT_TYPES = (TransientError, OSError, ConnectionError, TimeoutError)
_NEVER_RETRY = (KeyboardInterrupt, SystemExit, MemoryError)


def is_transient(exc, extra_types=()):
    """Transient/terminal classification used by every retry site."""
    if isinstance(exc, _NEVER_RETRY):
        return False
    if getattr(exc, "transient", False):
        return True
    return isinstance(exc, _TRANSIENT_TYPES + tuple(extra_types))


class RetryPolicy:
    """max-attempt budget + exponential backoff schedule.

    delay(attempt) = min(max_delay, base_delay * multiplier**attempt),
    scaled by a uniform jitter in [1-jitter, 1+jitter] drawn from a
    per-policy seeded RNG (deterministic replay).
    """

    def __init__(self, max_attempts=3, base_delay=0.05, max_delay=2.0,
                 multiplier=2.0, jitter=0.5, retryable=(), seed=0):
        if max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {max_attempts}")
        self.max_attempts = int(max_attempts)
        self.base_delay = float(base_delay)
        self.max_delay = float(max_delay)
        self.multiplier = float(multiplier)
        self.jitter = float(jitter)
        self.retryable = tuple(retryable)
        self._rng = random.Random(seed)

    def is_transient(self, exc):
        return is_transient(exc, self.retryable)

    def delay(self, attempt):
        d = min(self.max_delay, self.base_delay * self.multiplier ** attempt)
        if self.jitter:
            d *= 1.0 + self.jitter * (2.0 * self._rng.random() - 1.0)
        return max(0.0, d)


#: Cheap defaults for in-process producers (tests and loaders want fast
#: recovery, not seconds-long sleeps).
DEFAULT_POLICY_ARGS = dict(max_attempts=3, base_delay=0.02, max_delay=1.0)


def default_policy():
    return RetryPolicy(**DEFAULT_POLICY_ARGS)


def retry_call(fn, *args, policy=None, label="", on_retry=None, **kwargs):
    """Call ``fn(*args, **kwargs)``, retrying transient failures under
    ``policy``. Terminal failures propagate untouched; a spent budget
    raises :class:`RetryExhausted` from the last transient error."""
    policy = policy or default_policy()
    last = None
    for attempt in range(policy.max_attempts):
        try:
            return fn(*args, **kwargs)
        except BaseException as e:
            if not policy.is_transient(e):
                raise
            last = e
            if attempt + 1 >= policy.max_attempts:
                break
            if on_retry is not None:
                on_retry(e, attempt)
            d = policy.delay(attempt)
            # a server-side shed hint (serving.ShedError.retry_after_s)
            # floors the backoff: the endpoint told us when it expects
            # capacity, sleeping less just feeds the ladder
            ra = getattr(e, "retry_after_s", None)
            if ra is not None:
                d = max(d, float(ra))
            time.sleep(d)
    raise RetryExhausted(
        f"{label or getattr(fn, '__name__', 'call')}: "
        f"{policy.max_attempts} attempts exhausted (last: {last!r})"
    ) from last


def retrying(policy=None, label=""):
    """Decorator form of :func:`retry_call`."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            return retry_call(fn, *args, policy=policy,
                              label=label or fn.__name__, **kwargs)
        return wrapped
    return deco
