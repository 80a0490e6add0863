"""BERT-base pretraining steps: the port's counterpart of ``bench.py``'s
``bench_bert``.

    python -m paddle_tpu_torch.tools.bench_bert [--batch 64] [--seq 128]
        [--steps 32] [--inner 8] [--kernels NAME,...] [--use-fused]
        [--use-multi-tensor] [--flat-arena] [--token-types]
        [--arms graph,eager]
        [--profile [--top 15]] [--out PATH]

The same model, data and step as the reference: ``BertForPretraining(
BertConfig.base())`` with its default dropouts of 0.1, seeded with 0;
``AdamW(learning_rate=1e-4)``; ``inner`` distinct batches of masked-LM
ids, labels (15% of positions, the rest ``-1``) and NSP labels drawn with
numpy from ``RandomState(0)``; each step runs the forward under
``amp.auto_cast(dtype="bfloat16")``, ``model.loss`` in f32,
``loss.backward()``, ``step()`` and ``clear_grad()``, all wrapped in
``jit.to_static``, whose CUDA graph is the ``graph`` arm; the ``eager``
arm calls the same step unwrapped. One call of the step runs ``inner``
steps and returns their losses stacked (a graph replays no Python, so it
could not append them to a list). The
optimizer's routes are the reference's options (``use_fused``,
``use_multi_tensor``, ``flat_arena``), and ``--kernels`` turns kernels on
through ``kernels.configure`` (``--kernels softmax_xent,fused_adam_multi``
is the fused loss-and-optimizer route; by default both are off, as in the
reference). After one
warm-up call and one more, ``steps // inner`` calls are timed on the host
clock, ending in a sync; the result is tokens/s (``batch * seq`` a step)
and the last loss. ``--arms graph,eager`` measures both arms in turns,
each on its own trainer (graph, eager, eager, graph).

It runs on the CUDA card (``device=None``) and raises where there is
none; ``device="cpu"`` runs the same steps on the CPU. The command line
prints one JSON line with each arm's step time, tokens/s and loss and
the card's name and power limit (with ``--profile``, also, for each arm,
the device time of one step by kernel group, the step's wall and device
time, its idle share and launches, and its ``--top`` kernels by device
time, from ``torch.profiler``; the graph arm's step is one replay).
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


def make_token_types(batch, seq, inner, rng_seed=1):
    """Segment ids as numpy int32 (inner, batch, seq): each row is sentence
    A (0) up to a split drawn uniformly in [1, seq), then sentence B (1),
    as a next-sentence pair is; a stream of its own, so that
    :func:`make_data`'s draws are unchanged."""
    rng = np.random.RandomState(rng_seed)
    split = rng.randint(1, seq, (inner, batch, 1))
    return (np.arange(seq) >= split).astype("i4")


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
    its loss (a device scalar: no sync); ``eager_step(ids_k, mlm_k,
    nsp_k)`` runs ``inner`` of them and returns their losses stacked, and
    ``step`` is the same under ``jit.to_static``. ``opt_kw`` goes to
    ``AdamW`` (``use_fused``, ``use_multi_tensor``, ``flat_arena``). With
    ``token_types`` each batch also carries segment ids
    (:func:`make_token_types`), the fourth of ``data``."""

    def __init__(self, batch=64, seq=128, inner=8, device=None, opt_kw=None,
                 token_types=False, **cfg_kw):
        self.device = _device.resolve(device)
        self.inner = inner
        seed(0)
        self.config = BertConfig.base(**cfg_kw)
        self.model = BertForPretraining(self.config).to(self.device)
        self.opt = optimizer.AdamW(learning_rate=1e-4,
                                   parameters=self.model.parameters(),
                                   **(opt_kw or {}))
        arrays = make_data(self.config.vocab_size, batch, seq, inner)
        if token_types:
            arrays += (make_token_types(batch, seq, inner),)
        self.data = tuple(torch.from_numpy(a).to(self.device)
                          for a in arrays)
        self.step = jit.to_static(self.eager_step, models=[self.model],
                                  optimizers=[self.opt])

    def one(self, ids, mlm, nsp, tt=None):
        with amp.auto_cast(dtype="bfloat16"):
            logits, nsp_logits = self.model(ids, tt)
        loss = self.model.loss(logits.float(), nsp_logits.float(), mlm, nsp)
        loss.backward()
        self.opt.step()
        self.opt.clear_grad()
        return loss.detach()

    def eager_step(self, ids_k, mlm_k, nsp_k, tt_k=None):
        return torch.stack([self.one(ids_k[i], mlm_k[i], nsp_k[i],
                                     None if tt_k is None else tt_k[i])
                            for i in range(self.inner)])


def timed(tr, steps, graph=True):
    """The step time of trainer ``tr``: after one warm-up call
    (for the graph arm, its eager run and capture) and one more,
    ``steps // inner`` calls of the graph (``tr.step``) or the eager step
    on the host clock, ending in a sync. Returns ``(seconds a step, the
    last loss)``."""
    fn = tr.step if graph else tr.eager_step
    fn(*tr.data)                # warm-up: builds the kernels, cuBLAS
    fn(*tr.data)[-1].item()     # sync
    n_calls = max(1, steps // tr.inner)
    t0 = time.perf_counter()
    for _ in range(n_calls):
        losses = fn(*tr.data)
    last = losses[-1].item()
    return (time.perf_counter() - t0) / (n_calls * tr.inner), last


def bench_bert(batch=64, seq=128, steps=32, inner=8, device=None,
               opt_kw=None, **cfg_kw):
    """Tokens/s and the last loss of ``steps`` timed pretraining steps
    (``bench.py``'s ``bench_bert``, on the port), through the step's CUDA
    graph (a re-run of the step on the CPU)."""
    tr = Trainer(batch, seq, inner, device, opt_kw, **cfg_kw)
    dt, last = timed(tr, steps)
    return batch * seq / dt, last


def profile_step(tr, group=_group, top=15, graph=False):
    """Device time of one step of trainer ``tr`` (built with ``inner=1``)
    by kernel group (``torch.profiler``; ``group`` maps a kernel's name to
    its group), the step's CUDA-event and host wall time, the share of it
    the card is idle, its launches, and the ``top`` kernels that took the
    most device time. With ``graph`` the step is one replay of its CUDA
    graph, else one eager step."""
    fn = tr.step if graph else tr.eager_step
    fn(*tr.data)
    fn(*tr.data)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        start.record()
        fn(*tr.data)
        end.record()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
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
    return dict(step_ms=step_ms, wall_ms=wall_ms, busy_ms=busy,
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
    ap.add_argument("--token-types", action="store_true",
                    help="feed segment ids too (make_token_types)")
    ap.add_argument("--arms", default="graph",
                    help="comma-separated arms to time: graph (the "
                         "step's CUDA graph), eager; two arms run in "
                         "turns, A B B A")
    ap.add_argument("--profile", action="store_true",
                    help="also split one step's device time by kernel "
                         "group")
    ap.add_argument("--top", type=int, default=15,
                    help="with --profile: how many kernels to list by "
                         "device time")
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
    opt_kw = {k: True for k in ("use_fused", "use_multi_tensor",
                                "flat_arena") if getattr(args, k)}
    trainers = {a: Trainer(args.batch, args.seq, args.inner, opt_kw=opt_kw,
                           token_types=args.token_types) for a in arms}
    runs = {a: [] for a in arms}
    for a in arms + arms[::-1] if len(arms) > 1 else arms:
        runs[a].append(timed(trainers[a], args.steps, a == "graph"))
    del trainers
    rec = dict(batch=args.batch, seq=args.seq, steps=args.steps,
               inner=args.inner, kernels_on=on, optimizer=opt_kw,
               token_types=args.token_types, card=smi, arms={})
    for a in arms:
        dt = float(np.median([r[0] for r in runs[a]]))
        rec["arms"][a] = dict(tokens_per_s=args.batch * args.seq / dt,
                              step_ms=dt * 1e3, loss=runs[a][-1][1],
                              step_ms_runs=[r[0] * 1e3 for r in runs[a]])
        if args.profile:
            rec["arms"][a]["profile"] = profile_step(
                Trainer(args.batch, args.seq, 1, opt_kw=opt_kw,
                        token_types=args.token_types),
                top=args.top, graph=a == "graph")
    print(json.dumps(rec), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)


if __name__ == "__main__":
    main()
