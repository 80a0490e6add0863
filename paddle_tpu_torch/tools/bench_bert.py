"""BERT-base pretraining steps: the port's counterpart of ``bench.py``'s
``bench_bert``.

    python -m paddle_tpu_torch.tools.bench_bert [--batch 64] [--seq 128]
        [--steps 32] [--inner 8] [--kernels NAME,...] [--use-fused]
        [--use-multi-tensor] [--flat-arena] [--token-types] [--recipe]
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

``--recipe`` trains as a user's script does (:data:`RECIPE`): the model
cast to bfloat16 by ``amp.decorate(level="O2")`` and run under
``auto_cast(level="O2")``, ``AdamW`` over a ``LinearWarmup`` of a
``PolynomialDecay`` with ``ClipGradByGlobalNorm(1.0)``, and an
``amp.GradScaler`` around the backward and the step; one optimizer step a
call (``inner`` 1), and ``scheduler.step()`` on the host after each call,
which the next replay reads from the optimizer's rate tensor.

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

from .. import amp, clip, jit, optimizer, seed
from .. import device as _device
from ..optimizer import lr as lr_sched
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


#: ``--recipe``'s schedule, clip and loss scaling
RECIPE = dict(peak_lr=1e-4, decay_steps=20, warmup_steps=4, clip_norm=1.0,
              init_loss_scaling=2.0 ** 15, incr_every_n_steps=4)


def recipe_scheduler():
    """``LinearWarmup(PolynomialDecay(1e-4, decay_steps=20),
    warmup_steps=4, start_lr=0.0, end_lr=1e-4)``."""
    r = RECIPE
    return lr_sched.LinearWarmup(
        lr_sched.PolynomialDecay(r["peak_lr"], decay_steps=r["decay_steps"]),
        warmup_steps=r["warmup_steps"], start_lr=0.0, end_lr=r["peak_lr"])


class Trainer:
    """The model, optimizer, data (on the device) and step of the bench.
    ``one(ids, mlm, nsp)`` is one optimizer step on one batch and returns
    its loss (a device scalar: no sync); ``eager_step(ids_k, mlm_k,
    nsp_k)`` runs ``inner`` of them and returns their losses stacked, and
    ``step`` is the same under ``jit.to_static``. ``opt_kw`` goes to
    ``AdamW`` (``use_fused``, ``use_multi_tensor``, ``flat_arena``). With
    ``token_types`` each batch also carries segment ids
    (:func:`make_token_types`), the fourth of ``data``. With ``recipe``
    the step is :data:`RECIPE`'s (``inner`` must be 1): ``sched`` is the
    scheduler and ``scaler`` the loss scaler, and :meth:`call` steps the
    scheduler after each call."""

    def __init__(self, batch=64, seq=128, inner=8, device=None, opt_kw=None,
                 token_types=False, recipe=False, **cfg_kw):
        if recipe and inner != 1:
            raise ValueError("bench_bert: the recipe takes one optimizer "
                             "step a call (inner=1): its scheduler steps "
                             "on the host between calls")
        self.device = _device.resolve(device)
        self.inner = inner
        self.recipe = recipe
        seed(0)
        self.config = BertConfig.base(**cfg_kw)
        self.model = BertForPretraining(self.config).to(self.device)
        self.sched = self.scaler = None
        kw = dict(opt_kw or {})
        if recipe:
            self.sched = recipe_scheduler()
            kw.update(learning_rate=self.sched, grad_clip=clip.
                      ClipGradByGlobalNorm(RECIPE["clip_norm"]))
        else:
            kw.update(learning_rate=1e-4)
        self.opt = optimizer.AdamW(parameters=self.model.parameters(), **kw)
        if recipe:
            amp.decorate(self.model, self.opt, level="O2")
            self.scaler = amp.GradScaler(
                init_loss_scaling=RECIPE["init_loss_scaling"],
                incr_every_n_steps=RECIPE["incr_every_n_steps"])
        arrays = make_data(self.config.vocab_size, batch, seq, inner)
        if token_types:
            arrays += (make_token_types(batch, seq, inner),)
        self.data = tuple(torch.from_numpy(a).to(self.device)
                          for a in arrays)
        self.step = jit.to_static(
            self.eager_step, models=[self.model], optimizers=[self.opt],
            scalers=[self.scaler] if recipe else [])

    def one(self, ids, mlm, nsp, tt=None):
        level = "O2" if self.recipe else "O1"
        with amp.auto_cast(level=level, dtype="bfloat16"):
            logits, nsp_logits = self.model(ids, tt)
        loss = self.model.loss(logits.float(), nsp_logits.float(), mlm, nsp)
        if self.recipe:
            self.scaler.scale(loss).backward()
            self.scaler.step(self.opt)
        else:
            loss.backward()
            self.opt.step()
        self.opt.clear_grad()
        return loss.detach()

    def call(self, graph=True):
        """One call of the graphed (or the eager) step on ``data``, then
        the recipe's ``scheduler.step()``; returns the losses."""
        losses = (self.step if graph else self.eager_step)(*self.data)
        if self.sched is not None:
            self.sched.step()
        return losses

    def eager_step(self, ids_k, mlm_k, nsp_k, tt_k=None):
        return torch.stack([self.one(ids_k[i], mlm_k[i], nsp_k[i],
                                     None if tt_k is None else tt_k[i])
                            for i in range(self.inner)])


def _call(tr, graph):
    """One call of trainer ``tr``'s graphed or eager step (through its
    ``call``, which steps a recipe's scheduler, where it has one: the
    ResNet bench's trainers share these loops)."""
    if hasattr(tr, "call"):
        return tr.call(graph)
    return (tr.step if graph else tr.eager_step)(*tr.data)


def timed(tr, steps, graph=True):
    """The step time of trainer ``tr``: after one warm-up call
    (for the graph arm, its eager run and capture) and one more,
    ``steps // inner`` calls of the graph (``tr.step``) or the eager step
    on the host clock, ending in a sync. Returns ``(seconds a step, the
    last loss)``."""
    _call(tr, graph)            # warm-up: builds the kernels, cuBLAS
    _call(tr, graph)[-1].item()  # sync
    n_calls = max(1, steps // tr.inner)
    t0 = time.perf_counter()
    for _ in range(n_calls):
        losses = _call(tr, graph)
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
    _call(tr, graph)
    _call(tr, graph)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        start.record()
        _call(tr, graph)
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
    ap.add_argument("--recipe", action="store_true",
                    help="amp O2, the warm-up and decay schedule, global "
                         "norm clipping and the loss scaler (RECIPE); "
                         "forces --inner 1")
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
    if args.recipe:
        args.inner = 1
    on = [k for k in args.kernels.split(",") if k]
    kernels.configure(**dict.fromkeys(on, True))
    opt_kw = {k: True for k in ("use_fused", "use_multi_tensor",
                                "flat_arena") if getattr(args, k)}
    trainers = {a: Trainer(args.batch, args.seq, args.inner, opt_kw=opt_kw,
                           token_types=args.token_types, recipe=args.recipe)
                for a in arms}
    runs = {a: [] for a in arms}
    for a in arms + arms[::-1] if len(arms) > 1 else arms:
        runs[a].append(timed(trainers[a], args.steps, a == "graph"))
    del trainers
    rec = dict(batch=args.batch, seq=args.seq, steps=args.steps,
               inner=args.inner, kernels_on=on, optimizer=opt_kw,
               token_types=args.token_types, recipe=args.recipe, card=smi,
               arms={})
    for a in arms:
        dt = float(np.median([r[0] for r in runs[a]]))
        rec["arms"][a] = dict(tokens_per_s=args.batch * args.seq / dt,
                              step_ms=dt * 1e3, loss=runs[a][-1][1],
                              step_ms_runs=[r[0] * 1e3 for r in runs[a]])
        if args.profile:
            rec["arms"][a]["profile"] = profile_step(
                Trainer(args.batch, args.seq, 1, opt_kw=opt_kw,
                        token_types=args.token_types, recipe=args.recipe),
                top=args.top, graph=a == "graph")
    print(json.dumps(rec), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)


if __name__ == "__main__":
    main()
