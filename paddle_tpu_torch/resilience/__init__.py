"""paddle_tpu_torch.resilience — deadlines, retry policy, fault injection
and preemption for serving.

Counterpart of ``paddle_tpu/resilience`` for the serving tier:

* :mod:`~paddle_tpu_torch.resilience.deadline` — monotonic wall-time
  budgets (:class:`Deadline`)
* :mod:`~paddle_tpu_torch.resilience.retry`    — exponential backoff
  with deterministic jitter and max-attempt budgets
* :mod:`~paddle_tpu_torch.resilience.faults`   — deterministic fault
  injection (the serving fleet's chaos source)
* :mod:`~paddle_tpu_torch.resilience.preempt`  — SIGTERM as a
  cooperative flag and a process-level broadcast that drains every live
  serving fleet

Every recovery emits a ``resilience.*`` counter and JSONL record on the
port's monitor (:func:`record`). The training side (``guard``,
``watchdog``, ``elastic``) is ROADMAP.md Queue A item 19.
"""
import os as _os

from . import deadline, faults, preempt, retry
from ._common import record
from .deadline import Deadline
from .faults import HostLossError
from .preempt import PreemptionHandler, subscribe, unsubscribe
from .retry import (RetryExhausted, RetryPolicy, TransientError,
                    is_transient, retry_call)

__all__ = ["deadline", "faults", "preempt", "retry", "record", "Deadline",
           "HostLossError", "PreemptionHandler", "subscribe", "unsubscribe",
           "RetryExhausted", "RetryPolicy", "TransientError", "is_transient",
           "retry_call"]

# PADDLE_TPU_TORCH_FAULTS='[{"kind":"replica_error","replica":0}]'
# registers faults at import: chaos runs with no code change
if _os.environ.get("PADDLE_TPU_TORCH_FAULTS"):
    faults.load_env()
