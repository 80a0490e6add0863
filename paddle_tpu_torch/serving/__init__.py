"""paddle_tpu_torch.serving — the online inference runtime.

Counterpart of ``paddle_tpu/serving`` for this slice:

* :mod:`~paddle_tpu_torch.serving.batcher`   — bounded request queue and
  drain thread; coalesces same-signature requests, flushes on
  ``max_batch`` rows or ``timeout_ms``
* :mod:`~paddle_tpu_torch.serving.engine`    — :class:`ServingEngine`:
  ``submit()`` / ``run()`` / ``warmup()`` over one ``Predictor``
* :mod:`~paddle_tpu_torch.serving.admission` — the shed ladder,
  deadlines dropped at dequeue, and failure triage

Metrics, request tracing, the monitor's spans, fault injection and the
multi-replica fleet are not ported yet (see ROADMAP.md).
"""
from .admission import (AdmissionController, DeadlineExpired, PRIORITIES,
                        QueueFullError, ShedError)
from .batcher import DynamicBatcher, Request
from .engine import ServingEngine

__all__ = ["AdmissionController", "DeadlineExpired", "PRIORITIES",
           "QueueFullError", "ShedError", "DynamicBatcher", "Request",
           "ServingEngine"]
