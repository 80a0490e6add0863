"""paddle_tpu_torch — the PyTorch and CUDA port of ``paddle_tpu``.

The JAX package ``paddle_tpu`` stays the reference; this package is its
counterpart for an NVIDIA H100, module for module under the same names.
Plain tensor code is PyTorch; every Pallas kernel on a ported path is a
CUDA C++ kernel for ``sm_90a`` under ``csrc/``, built with ``nvcc`` at
first use (:mod:`paddle_tpu_torch.ops.kernels`). The package imports
``torch`` and never ``jax`` or ``paddle_tpu``.

Entry points run on the CUDA card unless the caller asks for the CPU
(``device="cpu"``, or :func:`set_device`); with no card they raise.

This slice serves BERT::

    from paddle_tpu_torch import inference, serving
    from paddle_tpu_torch.models import Bert, BertConfig

    pred = inference.Predictor(Bert(BertConfig.base()).eval())
    eng = serving.ServingEngine(pred, buckets=[8, 32], max_batch=32)
    eng.warmup([((128,), "int32"), ((128,), "int32"), ((128,), "int32")])
    seq, pooled = eng.submit(ids, type_ids, mask).result()
"""
from . import device, random, initializer, nn, ops, models, inference, io
from . import resilience, serving, convert
from .device import get_device, set_device
from .random import seed

__all__ = ["device", "random", "initializer", "nn", "ops", "models",
           "inference", "io", "resilience", "serving", "convert",
           "get_device", "set_device", "seed"]
