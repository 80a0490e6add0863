"""ResNet-50 training steps: the port's counterpart of ``bench.py``'s
``bench_resnet`` and of ``scripts/bench_nhwc_resnet.py``.

    python -m paddle_tpu_torch.tools.bench_resnet [--batch 128] [--steps 12]
        [--inner 4] [--data-format NCHW|NHWC] [--kernels NAME,...]
        [--size 224] [--arms graph,eager] [--profile [--top 15]]
        [--out PATH]

The same model, data and step as the reference: ``resnet50(data_format=
...)`` seeded with 0; ``Momentum(learning_rate=0.1, momentum=0.9)``;
``inner`` distinct batches of random uint8 images (numpy,
``RandomState(0)``) resident on the device and normalised there, ``(x /
255 - 0.45) / 0.22``; each step runs the forward under
``amp.auto_cast(dtype="bfloat16")``, the cross entropy of the float32
logits, ``loss.backward()``, ``step()`` and ``clear_grad()``, all wrapped
in ``jit.to_static``, whose CUDA graph is the ``graph`` arm; the ``eager``
arm calls the same step unwrapped. One call of the step runs ``inner``
steps and returns their losses stacked. After one warm-up call and one
more, ``steps // inner`` calls are timed on the host clock, ending in a
sync; the result is images/s and the last loss. ``--arms graph,eager``
times both arms in turns (A B B A).

Three routes, the rows of ``scripts/bench_nhwc_resnet.py``: ``--data-format
NCHW`` (the default, ``bench.py``'s) and ``--data-format NHWC`` run the
plain batch norm; ``--data-format NHWC --kernels batch_norm`` sends all 53
batch-norm layers through the port's four batch-norm kernels.

It runs on the CUDA card (``device=None``) and raises where there is
none; ``device="cpu"`` runs the same steps on the CPU. The command line
prints one JSON line with each arm's step time, images/s and loss, peak
device memory and the card's name and power limit (with ``--profile``,
also each arm's device time of one step by kernel group, its wall time,
idle share and launches, from ``torch.profiler``; the graph arm's step
is one replay).
"""
from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from .. import amp, jit, optimizer, seed
from .. import device as _device
from ..models import resnet50
from ..ops import kernels, loss as loss_ops
from . import bench_bert, profile_bert

# kernel-name fragment -> group, first match wins; names that match none
# fall through to ``profile_bert``'s groups
GROUPS = (("bn_stats", "batch_norm_stats (port)"),
          ("bn_normalize", "batch_norm_normalize (port)"),
          ("bn_bwd_reduce", "batch_norm_bwd_reduce (port)"),
          ("bn_bwd_finish", "batch_norm_bwd_reduce (port)"),
          ("bn_bwd_dx", "batch_norm_bwd_dx (port)"),
          ("nchwtonhwc", "layout copies (cuDNN)"),
          ("nhwctonchw", "layout copies (cuDNN)"),
          ("fprop", "convolution (cuDNN)"), ("dgrad", "convolution (cuDNN)"),
          ("wgrad", "convolution (cuDNN)"), ("conv", "convolution (cuDNN)"),
          ("cudnn", "convolution (cuDNN)"),
          ("max_pool", "pooling (PyTorch)"), ("avg_pool", "pooling (PyTorch)"))


def _group(name):
    low = name.lower()
    for frag, group in GROUPS:
        if frag in low:
            return group
    return profile_bert._group(name)


def normalize_u8(xb):
    """A uint8 image batch as normalised float32, on its device."""
    return (xb.float() / 255.0 - 0.45) / 0.22


def make_data(batch, inner, data_format="NCHW", size=224, num_classes=1000,
              rng_seed=0):
    """``(x, y)`` as numpy: uint8 images of shape (inner, batch, 3, size,
    size), or (inner, batch, size, size, 3) for NHWC, and int32 labels
    (inner, batch): ``bench.py``'s draws."""
    rng = np.random.RandomState(rng_seed)
    shape = (inner, batch, 3, size, size) if data_format == "NCHW" \
        else (inner, batch, size, size, 3)
    x = (rng.rand(*shape) * 255).astype("u1")
    y = rng.randint(0, num_classes, (inner, batch)).astype("i4")
    return x, y


class Trainer:
    """The model, optimizer, data (on the device) and step of the bench.
    ``one(xb, yb)`` is one optimizer step on one batch and returns its
    loss (a device scalar: no sync); ``eager_step(x_k, y_k)`` runs
    ``inner`` of them and returns their losses stacked, and ``step`` is
    the same under ``jit.to_static``. ``model_fn`` builds the network
    (default ``resnet50``) from ``data_format`` and ``model_kw``."""

    def __init__(self, batch=128, inner=4, data_format="NCHW", device=None,
                 size=224, model_fn=resnet50, **model_kw):
        self.device = _device.resolve(device)
        self.inner = inner
        self.data_format = data_format
        seed(0)
        self.model = model_fn(data_format=data_format,
                              **model_kw).to(self.device)
        self.opt = optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                      parameters=self.model.parameters())
        self.data = tuple(torch.from_numpy(a).to(self.device) for a in
                          make_data(batch, inner, data_format, size,
                                    self.model.fc.out_features))
        self.step = jit.to_static(self.eager_step, models=[self.model],
                                  optimizers=[self.opt])

    def one(self, xb, yb):
        with amp.auto_cast(dtype="bfloat16"):
            logits = self.model(normalize_u8(xb))
        loss = loss_ops.cross_entropy(logits.float(), yb)
        loss.backward()
        self.opt.step()
        self.opt.clear_grad()
        return loss.detach()

    def eager_step(self, x_k, y_k):
        return torch.stack([self.one(x_k[i], y_k[i])
                            for i in range(self.inner)])


def bench_resnet(batch=128, steps=12, inner=4, data_format="NCHW",
                 device=None, size=224, **model_kw):
    """Images/s and the last loss of ``steps`` timed training steps
    (``bench.py``'s ``bench_resnet``, on the port), through the step's
    CUDA graph (a re-run of the step on the CPU)."""
    tr = Trainer(batch, inner, data_format, device, size, **model_kw)
    dt, last = bench_bert.timed(tr, steps)
    return batch / dt, last


def profile_step(tr, top=15, graph=False):
    """``bench_bert.profile_step`` for this trainer, with the batch-norm
    and convolution kernel groups."""
    return bench_bert.profile_step(tr, group=_group, top=top, graph=graph)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--inner", type=int, default=4)
    ap.add_argument("--size", type=int, default=224,
                    help="image height and width")
    ap.add_argument("--data-format", default="NCHW",
                    choices=("NCHW", "NHWC"))
    ap.add_argument("--kernels", default="",
                    help="comma-separated kernels to turn on with "
                         "kernels.configure, e.g. batch_norm (which needs "
                         "--data-format NHWC to reach its kernels)")
    ap.add_argument("--arms", default="graph",
                    help="comma-separated arms to time: graph (the "
                         "step's CUDA graph), eager; two arms run in "
                         "turns, A B B A")
    ap.add_argument("--profile", action="store_true",
                    help="also split one step's device time by kernel "
                         "group")
    ap.add_argument("--top", type=int, default=15,
                    help="with --profile: how many kernels to list by name")
    ap.add_argument("--out", help="also write the record to this file")
    args = ap.parse_args(argv)
    arms = [a for a in args.arms.split(",") if a]
    if not arms or set(arms) - {"graph", "eager"}:
        ap.error(f"--arms takes graph and eager, got {args.arms!r}")
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    on = [k for k in args.kernels.split(",") if k]
    kernels.configure(**dict.fromkeys(on, True))
    torch.cuda.reset_peak_memory_stats()
    trainers = {a: Trainer(args.batch, args.inner, args.data_format,
                           size=args.size) for a in arms}
    runs = {a: [] for a in arms}
    for a in arms + arms[::-1] if len(arms) > 1 else arms:
        runs[a].append(bench_bert.timed(trainers[a], args.steps,
                                        a == "graph"))
    del trainers
    rec = dict(batch=args.batch, size=args.size, steps=args.steps,
               inner=args.inner, data_format=args.data_format, kernels_on=on,
               peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               card=smi, arms={})
    for a in arms:
        dt = float(np.median([r[0] for r in runs[a]]))
        rec["arms"][a] = dict(images_per_s=args.batch / dt,
                              step_ms=dt * 1e3, loss=runs[a][-1][1],
                              step_ms_runs=[r[0] * 1e3 for r in runs[a]])
        if args.profile:
            rec["arms"][a]["profile"] = profile_step(
                Trainer(args.batch, 1, args.data_format, size=args.size),
                args.top, graph=a == "graph")
    print(json.dumps(rec), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)


if __name__ == "__main__":
    main()
