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
* :mod:`~paddle_tpu_torch.serving.multi`     — :class:`MultiDeviceEngine`:
  health-aware fan-out over per-device replicas (breakers, hang
  failover, hedging, drains, rolling weight swaps); :func:`replicate`
* :mod:`~paddle_tpu_torch.serving.breaker`   — :class:`CircuitBreaker`,
  the per-replica closed / open / half-open state machine
* :mod:`~paddle_tpu_torch.serving.supervisor` — :class:`ServingSupervisor`,
  the control loop that trips, fails over, probes, restarts and scales

:class:`MultiDecodeEngine` (:func:`replicate_decode`) is the decode
fleet over :class:`GenerateEngine` replicas. Disaggregated serving and
the prefix cache are not ported yet (see ROADMAP.md).
"""
from . import breaker, metrics, multi, reqtrace, supervisor
from .admission import (AdmissionController, DeadlineExpired, PRIORITIES,
                        QueueFullError, ShedError)
from .batcher import DynamicBatcher, Request
from .breaker import CircuitBreaker
from .engine import ServingEngine
from .generate import (DecodeRequest, DemoLM, GenerateEngine,
                       MultiDecodeEngine, demo_model, demo_spec_pair,
                       replicate_decode)
from .kv_cache import KVCachePool
from .multi import MultiDeviceEngine, NoHealthyReplicaError, replicate
from .sampling import SamplingParams
from .supervisor import ServingSupervisor

__all__ = ["AdmissionController", "DeadlineExpired", "PRIORITIES",
           "QueueFullError", "ShedError", "DynamicBatcher", "Request",
           "CircuitBreaker", "ServingEngine", "DecodeRequest", "DemoLM",
           "GenerateEngine", "MultiDecodeEngine", "demo_model",
           "demo_spec_pair", "replicate_decode", "KVCachePool",
           "MultiDeviceEngine", "NoHealthyReplicaError", "replicate",
           "SamplingParams", "ServingSupervisor", "breaker", "metrics",
           "multi", "reqtrace", "supervisor"]
