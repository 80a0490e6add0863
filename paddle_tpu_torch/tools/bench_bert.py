"""BERT-base pretraining steps: the port's counterpart of ``bench.py``'s
``bench_bert``.

    python -m paddle_tpu_torch.tools.bench_bert [--batch 64] [--seq 128]
        [--steps 32] [--inner 8] [--kernels NAME,...] [--use-fused]
        [--use-multi-tensor] [--flat-arena] [--profile [--top 15]]
        [--out PATH]

The same model, data and step as the reference: ``BertForPretraining(
BertConfig.base())`` with its default dropouts of 0.1, seeded with 0;
``AdamW(learning_rate=1e-4)``; ``inner`` distinct batches of masked-LM
ids, labels (15% of positions, the rest ``-1``) and NSP labels drawn with
numpy from ``RandomState(0)``; each step runs the forward under
``amp.auto_cast(dtype="bfloat16")``, ``model.loss`` in f32,
``loss.backward()``, ``step()`` and ``clear_grad()``, all wrapped in
``jit.to_static``. One call of the step runs ``inner`` steps. The
optimizer's routes are the reference's options (``use_fused``,
``use_multi_tensor``, ``flat_arena``), and ``--kernels`` turns kernels on
through ``kernels.configure`` (``--kernels softmax_xent,fused_adam_multi``
is the fused loss-and-optimizer route; by default both are off, as in the
reference). After one
warm-up call and one more, ``steps // inner`` calls are timed on the host
clock, ending in a sync; the result is tokens/s (``batch * seq`` a step)
and the last loss.

It runs on the CUDA card (``device=None``) and raises where there is
none; ``device="cpu"`` runs the same steps on the CPU. The command line
prints one JSON line with the step time, tokens/s, the loss and the
card's name and power limit (with ``--profile``, also the device time of
one step by kernel group, the step's idle share and its ``--top``
kernels by device time, from ``torch.profiler``).
"""
from __future__ import annotations

import argparse
import collections
import json
import subprocess
import time

import numpy as np
import torch

from .. import amp, jit, optimizer, seed
from .. import device as _device
from ..models import BertConfig, BertForPretraining
from ..ops import kernels
from .profile_bert import _group


def make_data(vocab_size, batch, seq, inner, rng_seed=0):
    """``(ids, mlm, nsp)`` as numpy int32, of shapes (inner, batch, seq),
    (inner, batch, seq) and (inner, batch): ``bench.py``'s draws."""
    rng = np.random.RandomState(rng_seed)
    ids = rng.randint(0, vocab_size, (inner, batch, seq)).astype("i4")
    mlm = np.where(rng.rand(inner, batch, seq) < 0.15,
                   rng.randint(0, vocab_size, (inner, batch, seq)), -1
                   ).astype("i4")
    nsp = rng.randint(0, 2, (inner, batch)).astype("i4")
    return ids, mlm, nsp


class Trainer:
    """The model, optimizer, data (on the device) and step of the bench.
    ``one(ids, mlm, nsp)`` is one optimizer step on one batch and returns
    its loss, which it also appends to ``losses`` (a device scalar: no
    sync); ``step(ids_k, mlm_k, nsp_k)`` (under ``jit.to_static``) runs
    ``inner`` of them and returns the last loss. ``opt_kw`` goes to
    ``AdamW`` (``use_fused``, ``use_multi_tensor``, ``flat_arena``)."""

    def __init__(self, batch=64, seq=128, inner=8, device=None, opt_kw=None,
                 **cfg_kw):
        self.device = _device.resolve(device)
        self.inner = inner
        seed(0)
        self.config = BertConfig.base(**cfg_kw)
        self.model = BertForPretraining(self.config).to(self.device)
        self.opt = optimizer.AdamW(learning_rate=1e-4,
                                   parameters=self.model.parameters(),
                                   **(opt_kw or {}))
        self.data = tuple(torch.from_numpy(a).to(self.device) for a in
                          make_data(self.config.vocab_size, batch, seq,
                                    inner))
        self.step = jit.to_static(self._step, models=[self.model],
                                  optimizers=[self.opt])
        self.losses = []

    def one(self, ids, mlm, nsp):
        with amp.auto_cast(dtype="bfloat16"):
            logits, nsp_logits = self.model(ids)
        loss = self.model.loss(logits.float(), nsp_logits.float(), mlm, nsp)
        loss.backward()
        self.opt.step()
        self.opt.clear_grad()
        self.losses.append(loss.detach())
        return self.losses[-1]

    def _step(self, ids_k, mlm_k, nsp_k):
        loss = None
        for i in range(self.inner):
            loss = self.one(ids_k[i], mlm_k[i], nsp_k[i])
        return loss


def bench_bert(batch=64, seq=128, steps=32, inner=8, device=None,
               opt_kw=None, **cfg_kw):
    """Tokens/s and the last loss of ``steps`` timed pretraining steps
    (``bench.py``'s ``bench_bert``, on the port)."""
    tr = Trainer(batch, seq, inner, device, opt_kw, **cfg_kw)
    tr.step(*tr.data)           # warm-up: builds the kernels, cuBLAS
    loss = tr.step(*tr.data)
    loss.item()                 # sync
    n_calls = max(1, steps // inner)
    t0 = time.perf_counter()
    for _ in range(n_calls):
        loss = tr.step(*tr.data)
    last = loss.item()
    dt = (time.perf_counter() - t0) / (n_calls * inner)
    return batch * seq / dt, last


def profile_step(tr, group=_group, top=15):
    """Device time of one step of trainer ``tr`` by kernel group
    (``torch.profiler``; ``group`` maps a kernel's name to its group), the
    step's CUDA-event time, the share of it the card is idle, and the
    ``top`` kernels that took the most device time."""
    batch = tuple(t[0] for t in tr.data)
    tr.one(*batch)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        start.record()
        tr.one(*batch)
        end.record()
        torch.cuda.synchronize()
    groups = collections.defaultdict(float)
    names = collections.defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms = e.time_range.elapsed_us() / 1e3
            groups[group(e.name)] += ms
            names[e.name][0] += ms
            names[e.name][1] += 1
    busy = sum(groups.values())
    step_ms = start.elapsed_time(end)
    top = sorted(names.items(), key=lambda kv: -kv[1][0])[:top]
    return dict(step_ms=step_ms, busy_ms=busy,
                idle_share=1.0 - busy / step_ms if busy else None,
                launches=sum(n for _, n in names.values()),
                kernels_ms=dict(sorted(groups.items(),
                                       key=lambda kv: -kv[1])),
                top_kernels=[[n[:120], ms, k] for n, (ms, k) in top])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--inner", type=int, default=8)
    ap.add_argument("--kernels", default="",
                    help="comma-separated kernels to turn on with "
                         "kernels.configure, e.g. softmax_xent,"
                         "fused_adam_multi")
    ap.add_argument("--use-fused", action="store_true",
                    help="AdamW(use_fused=True): the per-tensor kernel")
    ap.add_argument("--use-multi-tensor", action="store_true",
                    help="AdamW(use_multi_tensor=True)")
    ap.add_argument("--flat-arena", action="store_true",
                    help="AdamW(flat_arena=True)")
    ap.add_argument("--profile", action="store_true",
                    help="also split one step's device time by kernel "
                         "group")
    ap.add_argument("--top", type=int, default=15,
                    help="with --profile: how many kernels to list by "
                         "device time")
    ap.add_argument("--out", help="also write the record to this file")
    args = ap.parse_args(argv)
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    on = [k for k in args.kernels.split(",") if k]
    kernels.configure(**dict.fromkeys(on, True))
    opt_kw = {k: True for k in ("use_fused", "use_multi_tensor",
                                "flat_arena") if getattr(args, k)}
    tok_s, loss = bench_bert(args.batch, args.seq, args.steps, args.inner,
                             opt_kw=opt_kw)
    rec = dict(batch=args.batch, seq=args.seq, steps=args.steps,
               inner=args.inner, kernels_on=on, optimizer=opt_kw,
               tokens_per_s=tok_s,
               step_ms=args.batch * args.seq / tok_s * 1e3, loss=loss,
               card=smi)
    if args.profile:
        rec["profile"] = profile_step(Trainer(args.batch, args.seq, 1,
                                              opt_kw=opt_kw), top=args.top)
    print(json.dumps(rec), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)


if __name__ == "__main__":
    main()
