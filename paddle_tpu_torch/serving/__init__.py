"""paddle_tpu_torch.serving — the online inference runtime.

Counterpart of ``paddle_tpu/serving`` for this slice:

* :mod:`~paddle_tpu_torch.serving.batcher`   — bounded request queue and
  drain thread; coalesces same-signature requests, flushes on
  ``max_batch`` rows or ``timeout_ms``
* :mod:`~paddle_tpu_torch.serving.engine`    — :class:`ServingEngine`:
  ``submit()`` / ``run()`` / ``warmup()`` over one ``Predictor``
* :mod:`~paddle_tpu_torch.serving.admission` — the shed ladder,
  deadlines dropped at dequeue, and failure triage
* :mod:`~paddle_tpu_torch.serving.generate`  — :class:`GenerateEngine`,
  continuous-batching autoregressive decode and speculative decoding
  (``draft_model=``), and the reference decode model :class:`DemoLM`
  (:func:`demo_model`, :func:`demo_spec_pair`)
* :mod:`~paddle_tpu_torch.serving.kv_cache`  — :class:`KVCachePool`, the
  fixed-slot KV arena on a closed capacity family
* :mod:`~paddle_tpu_torch.serving.sampling`  — :class:`SamplingParams`,
  the top-k / top-p filter and counter-keyed Gumbel-max draws
* :mod:`~paddle_tpu_torch.serving.metrics`   — the serving series and
  rolling SLO windows over the port's monitor
* :mod:`~paddle_tpu_torch.serving.reqtrace`  — one ``serving.request``
  record a request, its latency split into stages (TTFT, TPOT)

Fault injection, the multi-replica fleet and disaggregated serving are
not ported yet (see ROADMAP.md).
"""
from . import metrics, reqtrace
from .admission import (AdmissionController, DeadlineExpired, PRIORITIES,
                        QueueFullError, ShedError)
from .batcher import DynamicBatcher, Request
from .engine import ServingEngine
from .generate import (DecodeRequest, DemoLM, GenerateEngine, demo_model,
                       demo_spec_pair)
from .kv_cache import KVCachePool
from .sampling import SamplingParams

__all__ = ["AdmissionController", "DeadlineExpired", "PRIORITIES",
           "QueueFullError", "ShedError", "DynamicBatcher", "Request",
           "ServingEngine", "DecodeRequest", "DemoLM", "GenerateEngine",
           "demo_model", "demo_spec_pair", "KVCachePool", "SamplingParams",
           "metrics", "reqtrace"]
