"""int8 against bf16 Predictor throughput: the port's counterpart of
``scripts/bench_int8.py``.

    python -m paddle_tpu_torch.tools.bench_int8 [--dim 4096] [--layers 16]
        [--batch 512] [--steps 40] [--profile] [--out PATH]

The reference's model and timing shape: a tower of ``layers`` pairs of
``Linear(dim, dim)`` and ``ReLU``, seeded with 0; one input of ``(batch,
dim)`` drawn as ``0.05 * N(0, 1)`` from ``RandomState(0)``; the int8 arm
``Config().enable_int8([x])`` (calibrated on that input: every Linear
multiplies through ``int8_quantize`` and ``int8_gemm``), the bf16 arm
``Config().enable_bf16()``, both from the same model (each Predictor
serves a copy). Each arm chains ``Predictor.run_device``: every call
takes the previous call's output on the card (one replay of the
signature's CUDA graph, copy-in and clone-out included), ``steps`` calls
after two warm-up calls, one sync at the end. The bf16 arm is fed bf16
(its output's dtype, so the chain keeps one signature, and its products
run in bf16 on the tensor cores; the reference fed float32, which its
bf16 weights promote to float32 products); the int8 arm float32, its
edges' dtype. The arms run in turns (bf16, int8, int8, bf16) and each
reports its median: samples/s (``batch`` a call) and TOP/s (``2 * layers
* batch * dim^2`` a call).

``--profile`` adds one call of each arm under ``torch.profiler``: the
card's busy ms by kernel group, the call's CUDA-event ms and the idle
share ``1 - busy / call``.

It needs a CUDA card. One JSON line, then the card's name and power
limit.
"""
from __future__ import annotations

import argparse
import collections
import json
import subprocess
import time

import numpy as np
import torch

from .. import nn, seed
from ..inference import Config, Predictor
from .profile_bert import _group


def tower(dim, layers):
    blocks = []
    for _ in range(layers):
        blocks += [nn.Linear(dim, dim), nn.ReLU()]
    return nn.Sequential(*blocks)


def chain_s(pred, x, steps):
    """Seconds a call of a ``run_device`` chain of ``steps`` calls."""
    y = pred.run_device(pred.run_device(x))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        y = pred.run_device(y)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / steps


def profile_call(pred, x):
    """One call under ``torch.profiler``: busy ms by kernel group, the
    call's CUDA-event ms and idle share."""
    pred.run_device(x)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        start.record()
        pred.run_device(x)
        end.record()
        torch.cuda.synchronize()
    groups = collections.defaultdict(float)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            groups[_group(e.name)] += e.time_range.elapsed_us() / 1e3
    busy = sum(groups.values())
    call = start.elapsed_time(end)
    return dict(call_ms=call, busy_ms=busy,
                idle_share=1.0 - busy / call if busy else None,
                kernels_ms=dict(sorted(groups.items(),
                                       key=lambda kv: -kv[1])))


def bench_int8(dim=4096, layers=16, batch=512, steps=40, profile=False):
    """The record the command line prints (see the module docstring)."""
    seed(0)
    model = tower(dim, layers)
    x = (np.random.RandomState(0).randn(batch, dim) * 0.05).astype(
        "float32")
    preds = {"bf16": Predictor(model, Config().enable_bf16()),
             "int8": Predictor(model, Config().enable_int8([x]))}
    inputs = {"bf16": torch.from_numpy(x).cuda().bfloat16(),
              "int8": torch.from_numpy(x).cuda()}
    runs = {a: [] for a in preds}
    for arm in ("bf16", "int8", "int8", "bf16"):
        runs[arm].append(chain_s(preds[arm], inputs[arm], steps))
    ops = 2 * layers * batch * dim * dim
    rec = dict(model=f"{layers}x Linear({dim},{dim}) batch {batch}",
               steps=steps, arms={})
    for arm, ts in runs.items():
        dt = float(np.median(ts))
        rec["arms"][arm] = dict(samples_per_s=batch / dt,
                                tops=ops / dt / 1e12, call_ms=dt * 1e3,
                                call_ms_runs=[t * 1e3 for t in ts])
        if profile:
            rec["arms"][arm]["profile"] = profile_call(preds[arm],
                                                       inputs[arm])
    rec["speedup"] = (rec["arms"]["int8"]["samples_per_s"]
                      / rec["arms"]["bf16"]["samples_per_s"])
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dim", type=int, default=4096)
    ap.add_argument("--layers", type=int, default=16)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--profile", action="store_true",
                    help="also one call of each arm under torch.profiler")
    ap.add_argument("--out", help="also write the record to this file")
    args = ap.parse_args(argv)
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    rec = bench_int8(args.dim, args.layers, args.batch, args.steps,
                     args.profile)
    rec["card"] = smi
    print(json.dumps(rec), flush=True)
    print(smi, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)


if __name__ == "__main__":
    main()
