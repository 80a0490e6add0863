"""paddle_tpu_torch — the PyTorch and CUDA port of ``paddle_tpu``.

The JAX package ``paddle_tpu`` stays the reference; this package is its
counterpart for an NVIDIA H100, module for module under the same names.
Plain tensor code is PyTorch; every Pallas kernel on a ported path is a
CUDA C++ kernel for ``sm_90a`` under ``csrc/``, built with ``nvcc`` at
first use (:mod:`paddle_tpu_torch.ops.kernels`). The package imports
``torch`` and never ``jax`` or ``paddle_tpu``.

Entry points run on the CUDA card unless the caller asks for the CPU
(``device="cpu"``, or :func:`set_device`); with no card they raise.

The port serves BERT::

    from paddle_tpu_torch import inference, serving
    from paddle_tpu_torch.models import Bert, BertConfig

    pred = inference.Predictor(Bert(BertConfig.base()).eval())
    eng = serving.ServingEngine(pred, buckets=[8, 32], max_batch=32)
    eng.warmup([((128,), "int32"), ((128,), "int32"), ((128,), "int32")])
    seq, pooled = eng.submit(ids, type_ids, mask).result()

and pretrains it (``tools/bench_bert.py`` is the measured loop)::

    from paddle_tpu_torch import amp, optimizer
    from paddle_tpu_torch.models import BertConfig, BertForPretraining

    model = BertForPretraining(BertConfig.base()).cuda()
    opt = optimizer.AdamW(learning_rate=1e-4, parameters=model.parameters())
    with amp.auto_cast(dtype="bfloat16"):
        logits, nsp_logits = model(ids)
    loss = model.loss(logits.float(), nsp_logits.float(), mlm, nsp)
    loss.backward(); opt.step(); opt.clear_grad()

and trains the ResNets, NCHW or NHWC (``tools/bench_resnet.py``; with
``ops.kernels.configure(batch_norm=True)`` an NHWC model's batch norms run
the port's batch-norm kernels)::

    from paddle_tpu_torch.models import resnet50
    from paddle_tpu_torch.ops import loss

    model = resnet50(data_format="NHWC").cuda()
    opt = optimizer.Momentum(0.1, 0.9, parameters=model.parameters())
    with amp.auto_cast(dtype="bfloat16"):
        logits = model(images)
    loss.cross_entropy(logits.float(), labels).backward()
    opt.step(); opt.clear_grad()

and deploys a model: saved, loaded into a Predictor, served in calibrated
int8 (``int8_quantize`` and ``int8_gemm``, the port's int8 kernels), and
exported as a ``torch.export`` program::

    from paddle_tpu_torch import io
    from paddle_tpu_torch.inference import Config, Predictor, load_exported

    io.save_inference_model("out/bert", model)
    pred = Predictor(Config("out/bert").enable_int8([batch0, batch1]))
    pred.export("out/bert.pt2", *batch0)
    outs = load_exported("out/bert.pt2")(*batch0)
"""
from . import device, random, amp, initializer, nn, ops, models, inference
from . import io, resilience, serving, convert, regularizer, optimizer, jit
from . import quantization, clip, reader, dataset
from .reader import batch
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .device import get_device, set_device
from .optimizer import lr
from .random import seed

__all__ = ["device", "random", "amp", "initializer", "nn", "ops", "models",
           "inference", "io", "resilience", "serving", "convert",
           "regularizer", "optimizer", "jit", "quantization", "clip", "lr",
           "reader", "dataset", "batch",
           "ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm",
           "get_device", "set_device", "seed"]
