"""Where one served BERT batch spends its time on the card.

    python -m paddle_tpu_torch.tools.profile_bert [--batch 32] [--seq 128]
        [--iters 10] [--out PATH]

Builds BERT-base (12 layers, 768 wide, 12 heads, vocab 30522) with seeded
weights behind ``inference.Predictor``, in float32 and then through
``Config().enable_bf16()``, warms the signature, and prints one JSON line
per precision with:

* ``run_ms``: host wall time of ``Predictor.run`` (numpy in, numpy out:
  the copy to the card, the replay of the signature's CUDA graph, the
  copy back), mean of ``iters``;
* ``forward_ms``: CUDA-event time of ``Predictor.run_device`` on inputs
  already on the card (copy in, replay, clone out), mean of ``iters``;
* ``kernels_ms``: device time per replay by kernel group, from
  ``torch.profiler`` (the port's two kernels, cuBLAS's matrix products,
  PyTorch's elementwise and gather kernels, copies), and ``busy_ms``,
  their sum, and ``launches``, the device events of one replay;
* ``idle_share`` = 1 - busy_ms / forward_ms, the share of the forward in
  which the card waits on the host;
* ``eager``: the same forward called on the served module itself, with
  no graph (``forward_ms``, ``busy_ms``, ``idle_share``, ``launches``):
  the A/B of the graph.

The last line names the card and its power limit. It needs a CUDA card.
"""
from __future__ import annotations

import argparse
import collections
import json
import subprocess
import time

import numpy as np
import torch

from .. import seed
from ..inference import Config, Predictor
from ..models import Bert, BertConfig

# kernel-name fragment -> group, first match wins
GROUPS = (("ln_fwd", "layer_norm_fwd (port)"),
          ("ln_bwd", "layer_norm_bwd (port)"),
          ("flash_fwd", "flash_attention_fwd (port)"),
          ("flash_bwd", "flash_attention_bwd (port)"),
          ("xent_fwd", "softmax_xent_fwd (port)"),
          ("xent_bwd", "softmax_xent_bwd (port)"),
          ("adam_single<false", "fused_adam (port)"),
          ("adam_multi", "fused_adam_multi (port)"),
          ("adam_single<true", "fused_adam_flat (port)"),
          ("gemm", "matmul (cuBLAS)"), ("xmma", "matmul (cuBLAS)"),
          ("cutlass", "matmul (cuBLAS)"), ("nvjet", "matmul (cuBLAS)"),
          ("memcpy", "copies"),
          ("memset", "copies"))


def _group(name):
    low = name.lower()
    for frag, group in GROUPS:
        if frag in low:
            return group
    return "elementwise, gather and other (PyTorch)"


def _inputs(batch, seq, rng):
    ids = rng.randint(0, 30522, (batch, seq)).astype("int32")
    tt = (rng.rand(batch, seq) < 0.5).astype("int32")
    lens = rng.randint(16, seq + 1, batch)
    mask = (np.arange(seq)[None, :] < lens[:, None]).astype("int32")
    return ids, tt, mask


def profile(pred, inputs, iters):
    dev = [torch.from_numpy(a).to(pred.device) for a in inputs]
    pred.warmup([(a.shape, a.dtype) for a in inputs])
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    for _ in range(iters):
        pred.run(*inputs)
    run_ms = (time.perf_counter() - t0) * 1e3 / iters

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        pred.run_device(*dev)
    end.record()
    end.synchronize()
    forward_ms = start.elapsed_time(end) / iters

    rec = dict(run_ms=run_ms, forward_ms=forward_ms,
               **device_profile(lambda: pred.run_device(*dev), iters))
    rec["idle_share"] = 1.0 - rec["busy_ms"] / forward_ms

    def eager():
        with torch.inference_mode():
            return pred.model(*dev)

    eager()
    start.record()
    for _ in range(iters):
        eager()
    end.record()
    end.synchronize()
    eager_ms = start.elapsed_time(end) / iters
    prof = device_profile(eager, iters)
    rec["eager"] = dict(forward_ms=eager_ms, busy_ms=prof["busy_ms"],
                        idle_share=1.0 - prof["busy_ms"] / eager_ms,
                        launches=prof["launches"])
    return rec


def device_profile(call, iters):
    """Device time per ``call()`` by kernel group (``kernels_ms``), their
    sum (``busy_ms``), device events per call (``launches``) and the top
    kernels, from ``torch.profiler`` over ``iters`` calls."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            call()
        torch.cuda.synchronize()
    groups = collections.defaultdict(float)
    names = collections.defaultdict(float)
    n = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            groups[_group(e.name)] += us / 1e3 / iters
            names[e.name] += us / 1e3 / iters
            n += 1
    top = sorted(names.items(), key=lambda kv: -kv[1])[:8]
    return dict(kernels_ms=dict(sorted(groups.items(),
                                       key=lambda kv: -kv[1])),
                busy_ms=sum(groups.values()), launches=n / iters,
                top_kernels=[[name[:90], ms] for name, ms in top])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", help="also write the records to this file")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    seed(args.seed)
    model = Bert(BertConfig.base()).eval()
    inputs = _inputs(args.batch, args.seq, np.random.RandomState(args.seed))
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    records = []
    for label, config in (("float32", None),
                          ("bfloat16", Config().enable_bf16())):
        pred = Predictor(model, config)
        rec = dict(precision=label, batch=args.batch, seq=args.seq,
                   layers=len(model.encoder), card=smi,
                   **profile(pred, inputs, args.iters))
        records.append(rec)
        print(json.dumps(rec), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
    print(smi, flush=True)


if __name__ == "__main__":
    main()
