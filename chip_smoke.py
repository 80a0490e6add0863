#!/usr/bin/env python3
"""Drive the PyTorch port's BERT-base serving and training paths and its
ResNet-50 training path on one CUDA card.

    python3 chip_smoke.py [--out PATH] [--seed N]

Run from the root of a checkout. It imports ``paddle_tpu_torch`` (never
``jax`` or ``paddle_tpu``) and fails, printing no result, where there is
no CUDA card or no port beside it. Phases, each printed as JSON lines:

1. device: the card's name and power limit; every kernel of the path is
   built from ``paddle_tpu_torch/csrc`` (one ``nvcc`` per source, all at
   once) and ``-Xptxas -v``'s registers, shared memory and spills shown,
   with each kernel instance's count of tensor-core (HMMA) instructions
   from ``cuobjdump -sass``: the flash forward, dQ and dK/dV kernels, bf16
   and float32 (split TF32), on the tensor cores must have some, and no
   spill at head dim 64; the layer-norm instances that run D = 768 with
   16-byte accesses (forward f32, bf16 and bf16 with an f32 weight;
   backward f32 and bf16 with an f32 weight) must spill nothing and load
   x by 128-bit global loads (``LDG.E.128``, counted per instance).
2. kernels: each kernel's wrapper against its plain PyTorch version on the
   card, at the shapes the serving path gives it (layer norm also at the
   training step's (8192, 768), and at rows the 16-byte instances do not
   take, D = 770 and a view one element into its buffer, and at rows
   wider than a warp holds, D = 9000 and 16384; flash attention also
   causal at S = 512, a full bias, S = 200, 77 queries over 200 keys, and
   head dim 128 causal with dropout, in bf16; head dims 16 and 96, which
   run zero-padded, in float32 and bf16; float16 through the float32
   kernels; and (B, 1, S, 1) bool and additive masks, which the
   reference hands to sdpa, under causal), with the tolerance
   stated; CUDA-event times of the kernel, the plain version and one
   PyTorch library call computing the same function (a yardstick the port
   never calls), replayed from a CUDA graph so that they are the card's
   time alone, beside the least time the card could take (bytes over
   3.35 TB/s or operations over the peak rate of the inputs' type; the
   float32 forward's three TF32 products a term over the TF32 rate), and
   the eager time per call of the kernel's wrapper and the library call,
   host side included.
3. serving f32: BERT-base at full width (12 layers, 768 wide, 12 heads,
   vocab 30522) with seeded weights behind
   ``ServingEngine(Predictor(model), buckets=[8, 32], max_batch=32,
   timeout_ms=2)``; 40 requests of 1, 3, 7 or 13 rows at seq 128 from 4
   closed-loop client threads, then 4 at seq 512, with padding masks of
   real lengths 16..S. Every future must resolve to finite outputs of the
   right shape, 3 requests must match the same model run on the CPU, and
   the launch counters, zeroed just before the traffic, must show 25
   layer-norm and 12 flash-attention launches per executed batch.
4. serving bf16: the same requests through ``Config().enable_bf16()``,
   held against the f32 card outputs.
5. training kernels: the layer-norm backward kernel (also at phase 2's
   other layer-norm rows), the flash forward
   kernel with in-kernel dropout (and its kept fraction), and the flash
   dQ and dK/dV kernels, each against its plain version on the card at
   the training path's shapes, in bf16 and float32 (and causal, unaligned
   and head-dim-128 cases, and in bf16 the causal, full-bias, S = 200,
   77-over-200 and head-dim-128 causal dropout cases of phase 2, in
   float32 head dim 128 causal, dropout and a full bias, and phase 2's
   padded head dims, float16 and sdpa masks under causal), timed as in
   phase 2 (dK/dV alone, from the delta a dQ launch wrote, on the
   operands the wrapper hands it);
   the library yardsticks are
   ``aten.native_layer_norm_backward`` and the backward of
   ``scaled_dot_product_attention``.
6. loss and optimizer kernels: ``softmax_xent`` forward and backward at
   the masked-LM logits (8192, 30522) in f32 with ``bench_bert``'s labels
   and in bf16, with smoothing 0.1 at (4096, 30522), at the NSP logits
   (64, 2), and at V = 2500 with out-of-range labels; ``fused_adam`` at
   (30522, 768) f32 and a bf16 (1000, 77); ``fused_adam_multi`` over
   ``BertForPretraining``'s 157 trained shapes; ``fused_adam_flat`` at
   their arena length, which must give the many-tensor kernel's bits. Each
   against its plain version, timed as in phase 2; the library yardsticks
   are ``F.cross_entropy(ignore_index=-1, reduction="none")`` (forward,
   and forward+backward minus forward), ``torch._fused_adam_`` and
   ``torch._fused_adamw_`` over the same tensors (the same function up to
   rounding: torch divides ``sqrt(v)`` by ``sqrt(1 - b2^t)`` and decays
   first).
7. training: ``tools/bench_bert``'s step at full width and depth
   (BERT-base pretraining, batch 64, seq 128, amp bf16, AdamW 1e-4,
   dropouts 0.1), first on its default route, then on the fused route
   (``kernels.configure(softmax_xent=True, fused_adam_multi=True)``),
   each from a fresh ``Trainer``: 8 warm-up steps, then 16 steps with the
   launch counters zeroed just before and read just after (26 layer-norm
   forward and backward, 12 flash forward, dQ and dK/dV launches a step;
   on the fused route also 2 ``softmax_xent`` forward and backward, for
   the masked-LM and NSP losses, and 1 ``fused_adam_multi`` for the 157
   tensors with a gradient; on the default route none of these), every
   loss finite, step time and tokens/s; then 11 steps on one batch, whose
   loss must fall.
8. optimizer routes: one BERT-base f32 backward with token types (so that
   all 158 parameters get a gradient) steps four copies of the same
   weights 3 times, by the plain per-parameter AdamW, ``use_fused=True``
   (158 ``fused_adam`` launches a step), ``use_multi_tensor=True`` (1
   ``fused_adam_multi``) and ``flat_arena=True`` under
   ``configure(fused_adam_multi=True)`` (1 ``fused_adam_flat``). The
   multi-tensor and arena copies must agree to the bit, each fused route
   with the plain one within 2 lr a step per element and 1e-2 relative L2
   over the update; then one arena step on ``bench_bert``'s data, without
   token types, must launch ``fused_adam_flat`` no time (its mask route).
9. f32 step check: one BERT-base pretraining step in float32 (TF32 off,
   dropout 0, batch 4, seq 128) on the card and on the CPU from the same
   weights: the loss, every gradient and every parameter after AdamW; the
   counters, zeroed just before the card's step, must show the path's
   launches (12 of each float32 flash kernel).
10. batch-norm kernels: ``batch_norm_stats``, ``batch_norm_normalize``,
   ``batch_norm_bwd_reduce`` and ``batch_norm_bwd_dx`` against their plain
   versions at the five shapes ResNet-50 gives them at batch 128 (rows by
   channels (1605632, 64) to (6272, 2048), bf16), at (100352, 256) in
   f32, and at (10007, 100) in bf16, where no 16-byte load applies and
   the last row chunk is ragged; the two reductions must give the same
   bits twice; timed as in phase 2. The library yardstick is
   ``torch.nn.functional.batch_norm(training=True)`` on the same
   channels-last data: its forward beside stats + normalize, its backward
   (forward+backward minus forward) beside reduce + dx.
11. ResNet-50 training: ``tools/bench_resnet``'s step at full width and
   depth (batch 128, 224x224 uint8 images normalised on the card, amp
   bf16, Momentum(0.1, 0.9)) on three routes, each from a fresh
   ``Trainer``: NCHW and NHWC with the plain batch norm (no launch of any
   kernel), then NHWC under ``kernels.configure(batch_norm=True)`` (53
   launches of each of the four batch-norm kernels a step, counted over 8
   steps with the counters zeroed just before and read just after); every
   loss finite, step time, images/s and peak memory; then 10 steps on one
   batch, whose loss must fall.
12. ResNet f32 step check: one float32 training step of ResNet-50 (TF32
   off, batch 8, 224x224, NHWC, batch-norm kernels on) on the card and on
   the CPU from the same weights: the loss, every gradient, and every
   parameter and running statistic after the Momentum step.
13. the ``kernels`` line (all 14), the card's name and power limit, and
   the last line ``{"ok": true, "device": {...}}``.

Any failed check raises and the script exits non-zero. ``--out`` also
writes every record to a JSON file.
"""
from __future__ import annotations

import argparse
import copy
import json
import math
import re
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent

# H100 SXM, dense (NVIDIA's data sheet): HBM bandwidth, and the peak rate
# for each input type: bf16 on the tensor cores, float32 on the CUDA cores,
# and TF32 on the tensor cores, where the float32 flash kernels run each
# product as three TF32 products (float32 accuracy).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12, "tfloat32": 495e12}
# kernel vs plain version, as |diff| / max(1, |plain|): float32 sums in
# another order; bf16 rounds the f32 result once, one step being 2^-8
# relative, so 2e-2 allows a few steps; float16 runs the float32 kernels
# and rounds once, one step being 2^-11 relative
KERNEL_TOL = {"float32": 1e-4, "bfloat16": 2e-2, "float16": 2e-3}
# the served f32 model on the card vs the same model on the CPU: 12
# layers of float32 matmuls in another summation order, and attention
# products in split TF32 (the gap measured on an H100 is about 2e-5)
SERVE_F32_TOL = 1e-4
# bf16 serving vs f32 serving, as a relative L2 error per output (the gap
# measured on an H100 is about 1.2e-2)
SERVE_BF16_REL_TOL = 3e-2
# the served traffic: requests at seq 128, then at seq 512
REQUESTS_128 = 40
REQUESTS_512 = 4
# BERT-base launches per executed batch: embeddings.norm plus attn_norm
# and ffn_norm in each of 12 layers; one attention in each layer
LAUNCHES_PER_BATCH = {"layer_norm_fwd": 25, "flash_attention_fwd": 12}
# BERT-base pretraining launches per step: 25 encoder/embedding layer
# norms and mlm_norm, forward and backward; one attention a layer
TRAIN_LAUNCHES_PER_STEP = {"layer_norm_fwd": 26, "layer_norm_bwd": 26,
                           "flash_attention_fwd": 12,
                           "flash_attention_bwd_dq": 12,
                           "flash_attention_bwd_dkv": 12}
TRAIN_BATCH, TRAIN_SEQ, TRAIN_INNER = 64, 128, 8
TRAIN_TIMED_CALLS = 2        # x TRAIN_INNER steps, counted and timed
REPEAT_STEPS = 11            # steps on one batch; the loss must fall
# the attention-dropout rate and the kept fraction's tolerance
DROPOUT_P, KEEP_TOL = 0.1, 0.005
# the f32 step, card vs CPU: the loss and each gradient relative to the
# gradient's largest element (12 layers of float32 products summed in
# another order); after AdamW's first step an element moves by about
# lr * sign(g), so where g is rounding noise the two may step opposite
# ways: every element within 2 lr, the whole update within 1e-2 relative
# L2
F32_LOSS_TOL = 1e-4
F32_GRAD_TOL = 1e-3
F32_UPDATE_TOL = 1e-2
# the fused route's launches a step: the default route's, plus the
# masked-LM and NSP losses' softmax_xent forward and backward, and one
# fused_adam_multi for the 157 tensors with a gradient (256 a launch)
FUSED_LAUNCHES_PER_STEP = dict(TRAIN_LAUNCHES_PER_STEP, softmax_xent_fwd=2,
                               softmax_xent_bwd=2, fused_adam_multi=1)
# the optimizer-route check: AdamW steps on one f32 backward's gradients
OPT_LR, OPT_STEPS = 1e-4, 3
# ResNet-50 at batch 128, 224x224: its 53 batch-norm layers, each through
# the four batch-norm kernels once a step on the kernel route
RESNET_BATCH, RESNET_SIZE, RESNET_INNER = 128, 224, 4
RESNET_TIMED_CALLS = 2       # x RESNET_INNER steps, counted and timed
RESNET_REPEAT_STEPS = 10
RESNET_BN_LAYERS = 53
BN_KERNELS = ("batch_norm_stats", "batch_norm_normalize",
              "batch_norm_bwd_reduce", "batch_norm_bwd_dx")
# (N, H, W, C) of the batch-norm inputs the path's five widths first meet
BN_PATH_SHAPES = ((128, 112, 112, 64), (128, 56, 56, 256),
                  (128, 28, 28, 512), (128, 14, 14, 1024),
                  (128, 7, 7, 2048))
BN_ITERS = 20                # launches per timed run of a batch-norm case
# the ResNet f32 step, card vs CPU. Of ResNet-50's tens of millions of
# ReLU inputs at batch 8 a few lie within float32 rounding of 0 and fall
# on the other side on the other device; each such flip moves the
# gradients upstream of it a little, so a gradient is held by its relative
# L2 error rather than element by element (the gap measured on an H100 is
# 2.0e-2 over all gradients, 2.2e-5 for the classifier's, which no flip
# reaches)
RESNET_F32_LOSS_TOL = 1e-4
RESNET_F32_GRAD_TOL = 5e-2
RESNET_F32_FC_GRAD_TOL = 1e-3     # the classifier's: downstream of them all
RESNET_F32_STAT_TOL = 1e-4      # running statistics: the forward alone
# flash cases of phases 2 and 5 beyond the path's widths and dtypes: head
# dims run zero-padded to 64 or 128, float16 through the float32 kernels,
# and (B, 1, S, 1) masks, which the reference hands to sdpa, under causal
FLASH_OTHER = (
    ("head_dim_16", "float32", 4, 12, 128, 16, "key", False),
    ("head_dim_16", "bfloat16", 4, 12, 128, 16, "key", False),
    ("head_dim_96", "float32", 4, 12, 128, 96, "key", False),
    ("head_dim_96", "bfloat16", 4, 12, 128, 96, "key", False),
    ("float16", "float16", 4, 12, 128, 64, "key", False),
    ("row_bool_causal", "float32", 4, 12, 128, 64, "row_bool", True),
    ("row_additive_causal", "float32", 4, 12, 128, 64, "row_additive",
     True),
    ("row_bool_causal", "bfloat16", 4, 12, 128, 64, "row_bool", True),
    ("row_additive_causal", "bfloat16", 4, 12, 128, 64, "row_additive",
     True))
# layer-norm rows beyond the path's width, (n, d, offset): D = 770 and a
# view one element into its buffer take the one-element-a-lane instances,
# D = 9000 and 16384 the block-per-row instances
LN_OTHER = ((8192, 770, 0), (8192, 768, 1), (512, 9000, 0), (512, 16384, 0))
TIMED_ITERS = 50             # launches per timed run (median of 5 runs)
XENT_ITERS = 20              # the same for the (8192, 30522) loss kernels
ADAM_ITERS = 10              # the same for the whole-model Adam cases
ROTATE_BYTES = 128 << 20     # inputs rotate over > 2x the 50 MB L2 cache
RECORDS = []


class CheckFailed(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise CheckFailed(msg)


def emit(rec):
    RECORDS.append(rec)
    print(json.dumps(rec), flush=True)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


# -- timing ------------------------------------------------------------------

def warm_card(torch, seconds=0.5):
    """Keep the card busy for a moment, so that the first timing does not
    run while its clocks rise from idle."""
    a = torch.randn(4096, 4096, device="cuda")
    b = torch.empty_like(a)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        torch.mm(a, a, out=b)
        torch.cuda.synchronize()


def _event_ms(torch, run, iters, repeats):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    runs = []
    for _ in range(repeats):
        start.record()
        run()
        end.record()
        end.synchronize()
        runs.append(start.elapsed_time(end) / iters)
    return statistics.median(runs)


def time_ms(torch, fn, arg_sets, iters, repeats=5):
    """ms per eager call by CUDA events, host side included: the median
    over ``repeats`` runs of the mean over ``iters`` calls, after ``iters``
    warm-up calls. Where the host takes longer to issue a call than the
    card takes to run it, this is the host's time. The calls rotate over
    ``arg_sets`` so each reads its inputs from device memory."""
    def run():
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])
    run()
    torch.cuda.synchronize()
    return _event_ms(torch, run, iters, repeats)


def graph_ms(torch, fn, arg_sets, iters, repeats=5):
    """ms per call of the device work alone: ``iters`` calls (rotating
    over ``arg_sets``) captured into one CUDA graph, whose replay issues
    them with no Python, allocation or launch cost between them; the
    median over ``repeats`` replays, after one warm-up replay."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):       # warm the allocator off-capture
        for args in arg_sets[:2]:
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])
    graph.replay()
    torch.cuda.synchronize()
    ms = _event_ms(torch, graph.replay, iters, repeats)
    del graph
    torch.cuda.empty_cache()
    return ms


def timings(torch, kernel, plain, library, sets, iters):
    """The kernel's, its plain version's and the library call's device
    time per call (``ms``, ``plain_ms``, ``library_ms``, from a CUDA
    graph), and the kernel's and library call's eager time per call, host
    side included (``call_ms``, ``library_call_ms``)."""
    rec = dict(ms=graph_ms(torch, kernel, sets, iters),
               plain_ms=graph_ms(torch, plain, sets, iters),
               call_ms=time_ms(torch, kernel, sets, iters))
    if library is not None:
        rec.update(library_ms=graph_ms(torch, library, sets, iters),
                   library_call_ms=time_ms(torch, library, sets, iters))
    return rec


def n_sets(set_bytes):
    return max(1, min(16, math.ceil(ROTATE_BYTES / max(set_bytes, 1))))


def bound(nbytes, ops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def scaled_err(a, b):
    a, b = a.float(), b.float()
    return ((a - b).abs() / b.abs().clamp_min(1.0)).max().item()


def abs_err(a, b):
    return (a.float() - b.float()).abs().max().item()


# -- phase 1: what the build made ---------------------------------------------

# the tensor-core kernels, by their template instance; those at head dim 64
# (the path's) must also show no spill
TENSOR_CORE_KERNELS = ("flash_fwd_tc<64>", "flash_fwd_tc<128>",
                       "flash_fwd_tf32<64>", "flash_fwd_tf32<128>",
                       "flash_bwd_dq_tc<64>", "flash_bwd_dq_tc<128>",
                       "flash_bwd_dkv_tc<64, false>",
                       "flash_bwd_dkv_tc<128, false>",
                       "flash_bwd_dkv_tc<64, true>",
                       "flash_bwd_dkv_tc<128, true>",
                       "flash_bwd_dq_tf32<64>", "flash_bwd_dq_tf32<128>",
                       "flash_bwd_dkv_tf32<64>", "flash_bwd_dkv_tf32<128>")
NO_SPILL_KERNELS = ("flash_fwd_tc<64>", "flash_fwd_tf32<64>",
                    "flash_bwd_dq_tc<64>", "flash_bwd_dkv_tc<64, false>",
                    "flash_bwd_dq_tf32<64>", "flash_bwd_dkv_tf32<64>")
# the layer-norm instances the path runs at D = 768 with 16-byte accesses
# (x's dtype, the weight's, elements an access, chunks a lane): no spill,
# and 128-bit global loads
LN_VECTOR_KERNELS = ("ln_fwd_warp<float, float, 4, 6>",
                     "ln_fwd_warp<bf16, bf16, 8, 3>",
                     "ln_fwd_warp<bf16, float, 8, 3>",
                     "ln_bwd_warp<float, float, 4, 6>",
                     "ln_bwd_warp<bf16, float, 8, 3>")


def demangle(names, tool_dir):
    """Short names ("flash_fwd_tc<64>") for mangled kernel names, by the
    toolkit's cu++filt (or c++filt); a name stays mangled where neither
    is found."""
    for tool in (tool_dir / "cu++filt", "c++filt"):
        try:
            out = subprocess.run([str(tool)], input="\n".join(names),
                                 capture_output=True, text=True, timeout=60,
                                 check=True).stdout.splitlines()
        except (OSError, subprocess.SubprocessError):
            continue
        if len(out) == len(names):
            short = [re.search(r"::(\w+(?:<[^>]*>)?)\(", d) for d in out]
            return {n: (re.sub(r"\(\w+\)", "", m.group(1))
                        .replace("__nv_bfloat16", "bf16") if m else d)
                    for n, m, d in zip(names, short, out)}
    return {n: n for n in names}


def build_report(kernels, logs):
    """Per kernel instance: registers and spill bytes from ``-Xptxas
    -v``, and its tensor-core (HMMA) instructions and 128-bit global loads
    (``ldg128``) in ``cuobjdump -sass`` of the built library (the
    toolkit's copy beside nvcc)."""
    tool_dir = Path(kernels._nvcc()).parent
    info = {}
    for log in logs.values():
        fn = None
        for ln in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", ln)
            if m:
                fn = m.group(1)
                info[fn] = {}
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", ln)
            if m and fn:
                info[fn]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
            m = re.search(r"Used (\d+) registers", ln)
            if m and fn:
                info[fn]["registers"] = int(m.group(1))
    for source in logs:
        so = kernels._library_path(source)
        out = subprocess.run([str(tool_dir / "cuobjdump"), "-sass", str(so)],
                             capture_output=True, text=True, timeout=300,
                             check=True).stdout
        fn = None
        for ln in out.splitlines():
            m = re.search(r"Function : (\S+)", ln)
            if m:
                fn = m.group(1)
                info.setdefault(fn, {}).update(hmma=0, ldg128=0)
            elif fn and "HMMA" in ln:
                info[fn]["hmma"] += 1
            elif fn and re.search(r"LDG\.E[.\w]*\.128", ln):
                info[fn]["ldg128"] += 1
    names = demangle(sorted(info), tool_dir)
    report = {names[n]: v for n, v in info.items()}

    def entry(name):
        # "flash_fwd_tc<64>" is "...12flash_fwd_tcILi64EE..." mangled,
        # "flash_bwd_dkv_tc<64, true>" "...16flash_bwd_dkv_tcILi64ELb1EE..."
        base, args = name[:-1].split("<")
        code = "".join({"false": "Lb0E", "true": "Lb1E"}.get(a, f"Li{a}E")
                       for a in args.split(", "))
        hits = [v for k, v in info.items()
                if f"{len(base)}{base}I{code}E" in k]
        check(len(hits) == 1, f"{name}: {len(hits)} kernels of that name "
                              f"in the build")
        return hits[0]

    for name in TENSOR_CORE_KERNELS:
        check(entry(name).get("hmma", 0) > 0,
              f"{name}: no tensor-core (HMMA) instruction in the build")
    for name in NO_SPILL_KERNELS:
        check(entry(name).get("spill_bytes") == 0,
              f"{name}: ptxas reports {entry(name).get('spill_bytes')} "
              f"spill bytes")
    for name in LN_VECTOR_KERNELS:
        rec = report.get(name, {})
        check(rec.get("spill_bytes") == 0 and rec.get("ldg128", 0) > 0,
              f"{name}: want no spill and 128-bit global loads, the build "
              f"has {rec or 'no such instance'}")
    return report


# -- phase 2: kernels against their plain versions ----------------------------

def layer_norm_case(torch, LN, dtype, n, d, iters, gen, offset=0):
    """The forward kernel at (n, d), x a view ``offset`` elements into its
    buffer."""
    dt = getattr(torch, dtype)
    es = torch.empty((), dtype=dt).element_size()
    eps = 1e-12
    set_bytes = n * d * es * 2
    sets = []
    for _ in range(n_sets(set_bytes)):
        x = offset_rows((torch.randn(n * d + offset, device="cuda",
                                     generator=gen) * 3 + 1).to(dt),
                        n, d, offset)
        w = (torch.rand(d, device="cuda", generator=gen) + 0.5).to(dt)
        b = torch.randn(d, device="cuda", generator=gen).to(dt)
        sets.append((x, w, b))
    x, w, b = sets[0]
    y, mu, rstd = LN.layer_norm_fwd(x, w, b, eps)
    torch.cuda.synchronize()
    y0, mu0, rstd0 = LN.layer_norm_fwd_plain(x, w, b, eps)
    err = max(scaled_err(y, y0), scaled_err(mu, mu0),
              scaled_err(rstd, rstd0))
    rec = dict(phase="kernel", name="layer_norm_fwd", dtype=dtype,
               shape=[n, d], offset=offset, eps=eps,
               max_abs_err=abs_err(y, y0),
               max_scaled_err=err, tol=KERNEL_TOL[dtype])
    check(err <= KERNEL_TOL[dtype],
          f"layer_norm_fwd {dtype} {n}x{d}+{offset}: error {err} > "
          f"tolerance")
    F = torch.nn.functional
    rec.update(timings(
        torch, lambda *a: LN.layer_norm_fwd(*a, eps),
        lambda *a: LN.layer_norm_fwd_plain(*a, eps),
        lambda x, w, b: F.layer_norm(x, (d,), w, b, eps), sets, iters))
    # x read and y written once, w and b read, mu and rstd written; about
    # 8 operations an element (mean, centre, square, sum, scale, affine)
    nbytes = 2 * n * d * es + 2 * d * es + 2 * n * 4
    rec["bound_ms"], rec["bound_by"] = bound(nbytes, 8 * n * d, dtype)
    rec["bytes"] = nbytes
    emit(rec)
    return rec


def offset_rows(flat, n, d, offset):
    """(n, d) rows of ``flat`` from element ``offset``: contiguous, but
    16-byte aligned only at offset 0."""
    return flat[offset:offset + n * d].view(n, d)


def causal_pairs(sq, sk):
    """(query, key) pairs with q_pos >= k_pos (top-left)."""
    return sum(min(i + 1, sk) for i in range(sq))


def flash_case(torch, FA, label, dtype, b, h, s, d, mask_kind, causal,
               iters, gen, sk=None, dropout_p=0.0, phase="kernel"):
    """The forward kernel at (b, h, s, d) queries over ``sk`` keys (default
    s) against its plain version, with dropout at ``dropout_p`` from one
    seed (and then the kept fraction of its hash mask checked)."""
    sk = sk or s
    dt = getattr(torch, dtype)
    es = torch.empty((), dtype=dt).element_size()
    seed = (20240601, -17)
    kw = dict(causal=causal, dropout_p=dropout_p, seed=seed)
    sets = [st[:4] for st in flash_sets(
        torch, dtype, b, h, s, d, mask_kind, gen,
        n_sets(2 * b * h * (s + sk) * d * es), sk=sk)]
    q, k, v, mask = sets[0]
    out, m, l = FA.flash_attention_fwd(q, k, v, mask, **kw)
    torch.cuda.synchronize()
    out0, m0, l0 = FA.flash_attention_fwd_plain(q, k, v, mask, **kw)
    err = max(scaled_err(out, out0), scaled_err(m, m0), scaled_err(l, l0))
    rec = dict(phase=phase, name="flash_attention_fwd", case=label,
               dtype=dtype, shape=[b, h, s, d], keys=sk, mask=mask_kind,
               causal=causal, dropout_p=dropout_p,
               max_abs_err=abs_err(out, out0), max_scaled_err=err,
               tol=KERNEL_TOL[dtype])
    check(err <= KERNEL_TOL[dtype],
          f"flash_attention_fwd {label}: error {err} > tolerance")
    check_masked_rows(label, mask_kind, out, v)
    if dropout_p > 0:
        kept = FA.dropout_keep_mask(seed, b * h, s, sk, dropout_p,
                                    "cuda").float().mean().item()
        rec["kept_fraction"] = kept
        check(abs(kept - (1 - dropout_p)) <= KEEP_TOL,
              f"flash_attention_fwd {label}: kept fraction {kept}, want "
              f"{1 - dropout_p} +- {KEEP_TOL}")
    F = torch.nn.functional

    def library(q, k, v, mask):
        if mask is not None and mask.dtype != torch.bool:
            mask = mask.to(q.dtype)
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                              is_causal=causal,
                                              dropout_p=dropout_p)

    # sdpa takes no mask beside is_causal: no yardstick for those cases
    rec.update(timings(
        torch, lambda *a: FA.flash_attention_fwd(*a, **kw),
        lambda *a: FA.flash_attention_fwd_plain(*a, **kw),
        None if causal and mask is not None else library, sets, iters))
    # q, k, v read and O written once, the mask read as given, m and l
    # written; two products of 2*D operations per (query, key) pair the
    # function needs (the lower triangle when causal). float32 runs them
    # on the tensor cores as three TF32 products each: its bound is theirs
    # at the TF32 rate, beside the CUDA cores' float32 rate for one
    pairs = causal_pairs(s, sk) if causal else s * sk
    ops = 4 * b * h * pairs * d
    nbytes = (2 * b * h * (s + sk) * d * es + 2 * b * h * s * 4 +
              (0 if mask is None else mask.numel() * mask.element_size()))
    if dtype == "bfloat16":
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, ops, dtype)
    else:
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, 3 * ops,
                                                 "tfloat32")
        rec["bound_cuda_cores_ms"] = bound(nbytes, ops, "float32")[0]
    rec["bytes"] = nbytes
    emit(rec)
    return rec


def check_masked_rows(label, mask_kind, out, v):
    """A bool mask's row with no key gives 0; a row that a (B, 1, Sq, 1)
    mask masks everywhere (row 5 of batch 0) is sdpa's average of all the
    keys, also under causal."""
    if mask_kind == "bool":
        check(bool((out[0, :, 5] == 0).all()),
              f"flash {label}: a fully masked row must give 0")
    elif mask_kind in ("row_bool", "row_additive"):
        err = scaled_err(out[0, :, 5], v[0].float().mean(dim=1))
        check(err <= KERNEL_TOL[str(out.dtype).split(".")[-1]],
              f"flash {label}: a masked row must average the keys, error "
              f"{err}")


# -- phase 5: the training kernels against their plain versions --------------

def layer_norm_bwd_case(torch, LN, dtype, n, d, iters, gen, offset=0):
    """The backward kernel at (n, d), x and g in ``dtype`` and the weight
    f32, as on the training path; x and g views ``offset`` elements into
    their buffers."""
    dt = getattr(torch, dtype)
    es = torch.empty((), dtype=dt).element_size()
    eps = 1e-12
    sets = []
    for _ in range(n_sets(3 * n * d * es)):
        x = offset_rows((torch.randn(n * d + offset, device="cuda",
                                     generator=gen) * 3 + 1).to(dt),
                        n, d, offset)
        w = torch.rand(d, device="cuda", generator=gen) + 0.5
        b = torch.randn(d, device="cuda", generator=gen)
        g = offset_rows(torch.randn(n * d + offset, device="cuda",
                                    generator=gen).to(dt), n, d, offset)
        _, mu, rstd = LN.layer_norm_fwd(x, w, b, eps)
        sets.append((x, w, mu, rstd, g, b))
    x, w, mu, rstd, g, b = sets[0]
    got = LN.layer_norm_bwd(x, w, mu, rstd, g)
    torch.cuda.synchronize()
    ref = LN.layer_norm_bwd_plain(x, w, mu, rstd, g)
    err = scaled_err(got[0], ref[0])
    # dw and db sum n rows: relative to their largest element
    for a, r in zip(got[1:], ref[1:]):
        err = max(err, abs_err(a, r) / max(1.0, r.abs().max().item()))
    rec = dict(phase="train_kernel", name="layer_norm_bwd", dtype=dtype,
               shape=[n, d], offset=offset,
               max_abs_err=max(abs_err(a, r) for a, r in zip(got, ref)),
               max_scaled_err=err, tol=KERNEL_TOL[dtype])
    check(err <= KERNEL_TOL[dtype],
          f"layer_norm_bwd {dtype} {n}x{d}+{offset}: error {err} > "
          f"tolerance")
    check(all(torch.equal(a, c) for a, c in
              zip(got, LN.layer_norm_bwd(x, w, mu, rstd, g))),
          "layer_norm_bwd: two runs differ (the reduction must be "
          "deterministic)")

    def library(x, w, mu, rstd, g, b):
        return torch.ops.aten.native_layer_norm_backward(
            g, x, [d], mu, rstd, w.to(x.dtype), b.to(x.dtype),
            [True, True, True])

    rec.update(timings(
        torch, lambda *a: LN.layer_norm_bwd(*a[:5]),
        lambda *a: LN.layer_norm_bwd_plain(*a[:5]), library, sets, iters))
    # x and g read, dx written once; w, mu, rstd read; dw, db written;
    # about 12 operations an element (xhat, g*w, two sums, dx, dw, db)
    nbytes = 3 * n * d * es + d * 4 + 2 * n * 4 + 2 * d * 4
    rec["bound_ms"], rec["bound_by"] = bound(nbytes, 12 * n * d, dtype)
    rec["bytes"] = nbytes
    emit(rec)
    return rec


def flash_sets(torch, dtype, b, h, s, d, mask_kind, gen, count, sk=None):
    """``count`` input sets (q, k, v, mask, dO): head-split views of a
    fused (B, S, 3, H, D) projection, as BERT gives the kernels (with
    ``sk`` keys other than s: q from a (B, S, H, D) projection, k and v
    from a fused (B, Sk, 2, H, D) one); a key padding mask of real lengths
    16..Sk, a full f32 bias, a bool mask with one query row that sees no
    key, or none; masks the reference hands to sdpa, (B, 1, S, 1) bool
    (``row_bool``) or additive (``row_additive``: 2 N(0, 1), and -1e9),
    with row 5 of batch 0 masked everywhere; and dO in the (B, S, H, D)
    memory order the model hands the backward."""
    dt = getattr(torch, dtype)
    sk = sk or s
    sets = []
    for _ in range(count):
        if sk == s:
            qkv = torch.randn(b, s, 3, h, d, device="cuda", generator=gen)
            q, k, v = qkv.to(dt).permute(2, 0, 3, 1, 4)
        else:
            q = torch.randn(b, s, h, d, device="cuda", generator=gen)
            q = q.to(dt).transpose(1, 2)
            kv = torch.randn(b, sk, 2, h, d, device="cuda", generator=gen)
            k, v = kv.to(dt).permute(2, 0, 3, 1, 4)
        mask = None
        if mask_kind == "key":
            lens = torch.randint(16, sk + 1, (b,), device="cuda",
                                 generator=gen)
            keep = torch.arange(sk, device="cuda")[None, :] < lens[:, None]
            mask = ((~keep).float() * -1e9)[:, None, None, :]
        elif mask_kind == "full":
            mask = torch.randn(b, 1, s, sk, device="cuda", generator=gen) * 2
        elif mask_kind == "bool":
            mask = torch.rand(b, 1, s, sk, device="cuda", generator=gen) > 0.3
            mask[0, 0, 5, :] = False       # one query row sees no key
        elif mask_kind == "row_bool":
            mask = torch.ones(b, 1, s, 1, dtype=torch.bool, device="cuda")
            mask[0, 0, 5, 0] = False
        elif mask_kind == "row_additive":
            mask = torch.randn(b, 1, s, 1, device="cuda", generator=gen) * 2
            mask[0, 0, 5, 0] = -1e9
        do = torch.randn(b, s, h, d, device="cuda", generator=gen).to(dt)
        sets.append((q, k, v, mask, do.transpose(1, 2)))
    return sets


def flash_bwd_case(torch, FA, label, dtype, b, h, s, d, mask_kind, causal,
                   dropout_p, iters, gen, sk=None):
    """The dQ and dK/dV kernels against the plain backward, timed each on
    its own (``dq``, which also computes delta; ``dkv``, from the delta a
    dQ launch wrote) and together through the wrapper (``ms``), and
    against the plain backward and the backward of
    ``scaled_dot_product_attention``, which compute all three gradients.
    ``sk`` keys (default s) for the ``s`` queries."""
    sk = sk or s
    dt = getattr(torch, dtype)
    es = torch.empty((), dtype=dt).element_size()
    seed = (7, 11)
    sets = flash_sets(torch, dtype, b, h, s, d, mask_kind, gen,
                      n_sets(4 * b * h * (s + sk) * d * es), sk=sk)
    fwd = [FA.flash_attention_fwd(q, k, v, mask, causal=causal,
                                  dropout_p=dropout_p, seed=seed)
           for q, k, v, mask, _ in sets]
    full = [st[:4] + f + (st[4],) for st, f in zip(sets, fwd)]
    args = full[0]
    got = FA.flash_attention_bwd(*args, causal=causal, dropout_p=dropout_p,
                                 seed=seed)
    torch.cuda.synchronize()
    ref = FA.flash_attention_bwd_plain(*args, causal=causal,
                                       dropout_p=dropout_p, seed=seed)
    err = max(scaled_err(a, r) for a, r in zip(got, ref))
    names = ("dq", "dk", "dv")
    rec = dict(phase="train_kernel", name="flash_attention_bwd", case=label,
               dtype=dtype, shape=[b, h, s, d], keys=sk, mask=mask_kind,
               causal=causal, dropout_p=dropout_p,
               max_abs_err={n: abs_err(a, r)
                            for n, a, r in zip(names, got, ref)},
               max_scaled_err=err, tol=KERNEL_TOL[dtype])
    check(err <= KERNEL_TOL[dtype],
          f"flash_attention_bwd {label}: error {err} > tolerance")
    check(all(bool(torch.isfinite(a).all()) for a in got),
          f"flash_attention_bwd {label}: non-finite gradient")
    if mask_kind == "row_bool":
        check(not got[0][0, :, 5].any(),
              f"flash_attention_bwd {label}: a masked row gets no dq")
    F = torch.nn.functional
    # each kernel alone, on the operands the wrapper hands it: padded to
    # the kernels' head dim and in their dtype, the mask canonical
    w, kdt = FA._kernel_head_dim(d), FA._kernel_dtype(dt)
    launchers = []
    for q, k, v, mask, out, m, l, do in full:
        cm, rows, causal_k = FA._kernel_mask(mask, b, h, s, sk, causal)
        ops = [FA._to_kernel(t, w, kdt)
               for t in (FA._zero_rows(q, rows), k, v, out, do)]
        launchers.append((FA._bwd_setup(
            *ops[:3], cm, ops[3], m, l, ops[4], causal_k, 1 / math.sqrt(d),
            dropout_p, seed)[3],))
    rec["dq_ms"] = graph_ms(torch, lambda L: L(FA.BWD_DQ), launchers, iters)
    for (L,) in launchers:      # each dK/dV reads the delta its dQ wrote
        L(FA.BWD_DQ)
    rec["dkv_ms"] = graph_ms(torch, lambda L: L(FA.BWD_DKV), launchers,
                             iters)
    # the library's backward alone cannot be captured (autograd runs it on
    # the stream of its forward): its forward and backward are captured
    # together, its forward alone likewise, and the backward is the
    # difference of the two device times
    lib_sets = [tuple(t.detach().requires_grad_() for t in (q, k, v)) +
                (None if mask is None else mask.to(q.dtype), do)
                for q, k, v, mask, do in sets]

    def library_fwd(q, k, v, mask, do):
        return F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, is_causal=causal, dropout_p=dropout_p)

    no_library = causal and sets[0][3] is not None    # sdpa refuses both

    def library_fwd_bwd(q, k, v, mask, do):
        return torch.autograd.grad(library_fwd(q, k, v, mask, do),
                                   (q, k, v), do)

    # the kernel time here is the wrapper's: both kernels
    rec.update(timings(
        torch, lambda *a: FA.flash_attention_bwd(*a, causal=causal,
                                                 dropout_p=dropout_p,
                                                 seed=seed),
        lambda *a: FA.flash_attention_bwd_plain(*a, causal=causal,
                                                dropout_p=dropout_p,
                                                seed=seed),
        None, full, iters))
    rec["library_ms"] = None
    if not no_library:
        with torch.no_grad():
            rec["library_fwd_ms"] = graph_ms(torch, library_fwd, lib_sets,
                                             iters)
        rec["library_fwd_bwd_ms"] = graph_ms(torch, library_fwd_bwd,
                                             lib_sets, iters)
        rec["library_ms"] = rec["library_fwd_bwd_ms"] - rec["library_fwd_ms"]
    # each kernel's own work: dQ reads q, k, v, dO, O, m, l (and the mask)
    # and writes dq and delta, three products of 2 D operations a (query,
    # key) pair and D for delta a query; dK/dV reads q, k, v, dO, m, l,
    # delta (and the mask) and writes dk and dv, four products. In float32
    # (and float16, which runs the float32 kernels) each product is three
    # TF32 products at the TF32 rate
    pairs = causal_pairs(s, sk) if causal else s * sk
    mask_bytes = 0 if sets[0][3] is None else sets[0][3].numel() * 4
    rd = 2 * b * h * (s + sk) * d * es + 3 * b * h * s * 4 + mask_bytes
    ops_dq = 6 * b * h * pairs * d + 2 * b * h * s * d
    ops_dkv = 8 * b * h * pairs * d
    rate, split = ("bfloat16", 1) if dtype == "bfloat16" else ("tfloat32", 3)
    rec["bound_dq_ms"], rec["bound_dq_by"] = bound(
        rd + 2 * b * h * s * d * es, split * ops_dq, rate)
    rec["bound_dkv_ms"], rec["bound_dkv_by"] = bound(
        rd + 2 * b * h * sk * d * es, split * ops_dkv, rate)
    emit(rec)
    return rec


# -- phase 6: the loss and optimizer kernels -----------------------------------

def max_rel_err(a, b):
    """|a - b| over the largest |b|: for outputs whose scale is set by a
    factor (dx by g = 1 / count) rather than near 1."""
    return abs_err(a, b) / max(b.float().abs().max().item(), 1e-30)


def xent_case(torch, SX, label, dtype, n, v, eps, labels, iters, gen):
    """The softmax_xent forward and backward kernels at (n, v) against
    their plain versions. ``labels``: ``bench`` (bench_bert's masked-LM
    labels: a class at 15% of positions, -1, no column, elsewhere), ``oor``
    (a third -1, a fifth beyond the vocabulary) or ``all``. The loss
    gradient is the masked mean's: 1 / count on labelled rows, else 0."""
    from paddle_tpu_torch.tools.bench_bert import make_data
    dt = getattr(torch, dtype)
    es = torch.empty((), dtype=dt).element_size()
    if labels == "bench":
        mlm = make_data(v, TRAIN_BATCH, TRAIN_SEQ, 1)[1][0].reshape(-1)
        lab = torch.from_numpy(mlm[:n].copy()).cuda().reshape(n, 1)
    else:
        lab = torch.randint(0, v, (n, 1), device="cuda", generator=gen,
                            dtype=torch.int32)
        if labels == "oor":
            lab[::3] = -1
            lab[1::5] = v + 7
    valid = lab != -1
    g = valid.float() / valid.sum().clamp_min(1)
    sets = [((torch.randn(n, v, device="cuda", generator=gen) * 3).to(dt),
             lab, g) for _ in range(n_sets(n * v * es))]
    x = sets[0][0]
    loss, lse = SX.softmax_xent_fwd(x, lab, eps)
    dx = SX.softmax_xent_bwd(x, lab, lse, g, eps)
    torch.cuda.synchronize()
    loss0, lse0 = SX.softmax_xent_fwd_plain(x, lab, eps)
    dx0 = SX.softmax_xent_bwd_plain(x, lab, lse, g, eps)
    err_f = max(scaled_err(loss, loss0), scaled_err(lse, lse0))
    err_b = max_rel_err(dx, dx0)
    common = dict(phase="loss_kernel", case=label, dtype=dtype, shape=[n, v],
                  eps=eps, labels=labels,
                  labelled_rows=int(valid.sum().item()))
    fwd = dict(common, name="softmax_xent_fwd",
               max_abs_err=max(abs_err(loss, loss0), abs_err(lse, lse0)),
               max_scaled_err=err_f, tol=KERNEL_TOL["float32"])
    bwd = dict(common, name="softmax_xent_bwd", max_abs_err=abs_err(dx, dx0),
               max_err_rel_to_max=err_b, tol=KERNEL_TOL[dtype])
    check(err_f <= KERNEL_TOL["float32"],
          f"softmax_xent_fwd {label}: error {err_f} > tolerance")
    check(err_b <= KERNEL_TOL[dtype],
          f"softmax_xent_bwd {label}: error {err_b} > tolerance")
    F = torch.nn.functional
    # the library takes no label beyond the vocabulary: those rows ignored
    lib_lab = torch.where((lab >= 0) & (lab < v), lab, -1).long().reshape(-1)

    def library(x, lab, g):
        return F.cross_entropy(x, lib_lab, ignore_index=-1, reduction="none",
                               label_smoothing=eps)

    fwd.update(timings(torch, lambda *a: SX.softmax_xent_fwd(*a[:2], eps),
                       lambda *a: SX.softmax_xent_fwd_plain(*a[:2], eps),
                       library, sets, iters))
    # the logits read once; labels read, loss and lse written; a compare,
    # a subtraction, an exp and an add an element (and the eps sum)
    nbytes = n * v * es + 3 * n * 4
    fwd["bound_ms"], fwd["bound_by"] = bound(nbytes, (5 if eps else 4) * n
                                             * v, "float32")
    fwd["bytes"] = nbytes
    emit(fwd)
    bsets = [(x, lab, SX.softmax_xent_fwd(x, lab, eps)[1], g)
             for x, lab, g in sets]
    bwd.update(timings(torch, lambda *a: SX.softmax_xent_bwd(*a, eps),
                       lambda *a: SX.softmax_xent_bwd_plain(*a, eps), None,
                       bsets, iters))
    # the library's backward is timed as forward+backward minus forward,
    # both captured (autograd runs it on its forward's stream)
    lib_sets = [(x.detach().requires_grad_(), lab, g) for x, lab, g in sets]

    def library_fwd_bwd(x, lab, g):
        return torch.autograd.grad(library(x, lab, g), x,
                                   g.reshape(-1).to(x.dtype))

    with torch.no_grad():
        bwd["library_fwd_ms"] = graph_ms(torch, library, lib_sets, iters)
    bwd["library_fwd_bwd_ms"] = graph_ms(torch, library_fwd_bwd, lib_sets,
                                         iters)
    bwd["library_ms"] = bwd["library_fwd_bwd_ms"] - bwd["library_fwd_ms"]
    # the logits read and dx written once; labels, lse and g read; an exp,
    # a compare, a subtraction and a product an element
    nbytes = 2 * n * v * es + 3 * n * 4
    bwd["bound_ms"], bwd["bound_by"] = bound(nbytes, 5 * n * v, "float32")
    bwd["bytes"] = nbytes
    emit(bwd)
    return fwd, bwd


def adam_state(torch, shapes, dtype, gen):
    dt = getattr(torch, dtype)
    ps, gs, ms, vs = [], [], [], []
    for shape in shapes:
        ps.append(torch.randn(shape, device="cuda", generator=gen).to(dt))
        gs.append(torch.randn(shape, device="cuda", generator=gen))
        ms.append(torch.randn(shape, device="cuda", generator=gen) * 0.1)
        vs.append(torch.rand(shape, device="cuda", generator=gen) * 0.01)
    return ps, gs, ms, vs


def adam_bound(n, p_bytes):
    """p read and written in its dtype; g read, m and v read and written
    in float32; about 15 float32 operations an element."""
    nbytes = n * (2 * p_bytes + 20)
    return bound(nbytes, 15 * n, "float32") + (nbytes,)


def adam_scalars(torch, FAD, wd=None):
    lr, b1p, b2p = (torch.tensor(x, device="cuda")
                    for x in (OPT_LR, 0.9 ** 3, 0.999 ** 3))
    extra = () if wd is None else (wd,)
    return (lr, b1p, b2p), FAD.scalars("cuda", lr, b1p, b2p, *extra)


def fused_adam_case(torch, FAD, dtype, shape, iters, gen):
    """The single-tensor kernel (no decay) against its plain version; the
    library yardstick ``torch._fused_adam_`` takes m and v in p's dtype."""
    dt = getattr(torch, dtype)
    es = torch.empty((), dtype=dt).element_size()
    n = math.prod(shape)
    step = torch.tensor(3.0, device="cuda")
    sets = []
    for _ in range(n_sets(n * (2 * es + 20))):
        (p,), (g,), (m,), (v,) = adam_state(torch, [shape], dtype, gen)
        sets.append((p, g, m, v, g.to(dt), m.to(dt), v.to(dt)))
    (lr, b1p, b2p), scal = adam_scalars(torch, FAD)
    p, g, m, v = sets[0][:4]
    want = FAD.adam_plain(p, g, m, v, scal)
    got = FAD.fused_adam_update(p.clone(), g, m.clone(), v.clone(), lr, b1p,
                                b2p)
    torch.cuda.synchronize()
    err = max(scaled_err(a, b) for a, b in zip(got, want))
    rec = dict(phase="adam_kernel", name="fused_adam", dtype=dtype,
               shape=list(shape),
               max_abs_err=max(abs_err(a, b) for a, b in zip(got, want)),
               max_scaled_err=err, tol=KERNEL_TOL[dtype])
    check(err <= KERNEL_TOL[dtype], f"fused_adam {dtype} {shape}: error "
                                    f"{err} > tolerance")

    def library(p, g, m, v, gl, ml, vl):
        torch._fused_adam_([p], [gl], [ml], [vl], [], [step], lr=OPT_LR,
                           beta1=0.9, beta2=0.999, weight_decay=0.0,
                           eps=1e-8, amsgrad=False, maximize=False)

    rec.update(timings(
        torch, lambda *a: FAD.fused_adam_update(*a[:4], lr, b1p, b2p),
        lambda *a: FAD.adam_plain(*a[:4], scal), library, sets, iters))
    rec["bound_ms"], rec["bound_by"], rec["bytes"] = adam_bound(n, es)
    emit(rec)
    return rec


def pretraining_shapes():
    """The shapes of BERT-base pretraining's 157 parameters with a
    gradient in ``bench_bert`` (all but the token-type table), in
    parameter order."""
    from paddle_tpu_torch.models import BertConfig, BertForPretraining
    model = BertForPretraining(BertConfig.base())
    return [tuple(p.shape) for name, p in model.named_parameters()
            if name != "bert.embeddings.token_type_embeddings.weight"]


def fused_adam_multi_flat_cases(torch, FAD, shapes, iters, gen):
    """The many-tensor kernel over ``shapes`` and the arena kernel over
    the same elements laid flat (padded to 1024), each against its plain
    version, and the two against each other: identical bits. The library
    yardstick is ``torch._fused_adamw_`` over the same tensors."""
    wd = 0.01
    ps, gs, ms, vs = adam_state(torch, shapes, "float32", gen)
    (lr, b1p, b2p), scal = adam_scalars(torch, FAD, wd)
    total = sum(p.numel() for p in ps)
    size = total + (-total) % 1024

    def flat(ts):
        f = torch.zeros(size, device="cuda")
        f[:total] = torch.cat([t.reshape(-1) for t in ts])
        return f

    fp, fg, fm, fv = (flat(ts) for ts in (ps, gs, ms, vs))
    mp, mm, mv = ([t.clone() for t in ts] for ts in (ps, ms, vs))
    FAD.fused_adam_update_multi(mp, gs, mm, mv, lr, b1p, b2p,
                                weight_decay=wd)
    got_flat = FAD.fused_adam_update_flat(fp.clone(), fg, fm.clone(),
                                          fv.clone(), lr, b1p, b2p,
                                          weight_decay=wd)
    torch.cuda.synchronize()
    identical = all(torch.equal(f[:total], torch.cat(
        [t.reshape(-1) for t in ts])) for f, ts in
        zip(got_flat, (mp, mm, mv)))
    check(identical, "fused_adam_flat and fused_adam_multi differ on the "
                     "same inputs")
    err, aerr = 0.0, 0.0
    for p, g, m, v, got in zip(ps, gs, ms, vs, zip(mp, mm, mv)):
        want = FAD.adam_plain(p, g, m, v, scal, decay=True)
        err = max(err, max(scaled_err(a, b) for a, b in zip(got, want)))
        aerr = max(aerr, max(abs_err(a, b) for a, b in zip(got, want)))
    del mp, mm, mv, got_flat
    check(err <= KERNEL_TOL["float32"],
          f"fused_adam_multi: error {err} > tolerance")
    step = torch.tensor(3.0, device="cuda")
    common = dict(phase="adam_kernel", dtype="float32", tensors=len(ps),
                  elements=total, max_abs_err=aerr, max_scaled_err=err,
                  tol=KERNEL_TOL["float32"], flat_equals_multi=identical)

    def library(ps, gs, ms, vs):
        torch._fused_adamw_(ps, gs, ms, vs, [], [step] * len(ps), lr=OPT_LR,
                            beta1=0.9, beta2=0.999, weight_decay=wd,
                            eps=1e-8, amsgrad=False, maximize=False)

    multi = dict(common, name="fused_adam_multi",
                 launches_per_call=-(-len(ps) // FAD.MULTI_MAX_TENSORS))
    multi.update(timings(
        torch, lambda *a: FAD.fused_adam_update_multi(
            *a, lr, b1p, b2p, weight_decay=wd),
        lambda *a: [FAD.adam_plain(*t, scal, decay=True)
                    for t in zip(*a)], library, [(ps, gs, ms, vs)], iters))
    multi["bound_ms"], multi["bound_by"], multi["bytes"] = adam_bound(total,
                                                                      4)
    emit(multi)
    del ps, gs, ms, vs
    flat_rec = dict(common, name="fused_adam_flat", elements=size)
    flat_rec.update(timings(
        torch, lambda *a: FAD.fused_adam_update_flat(
            *a, lr, b1p, b2p, weight_decay=wd),
        lambda *a: FAD.adam_plain(*a, scal, decay=True),
        lambda *a: library(*([t] for t in a)), [(fp, fg, fm, fv)], iters))
    flat_rec["bound_ms"], flat_rec["bound_by"], flat_rec["bytes"] = \
        adam_bound(size, 4)
    emit(flat_rec)
    return multi, flat_rec


# -- phases 3 and 4: serving ---------------------------------------------------

def make_requests(np, seed):
    rng = np.random.RandomState(seed)
    reqs = []
    for i in range(REQUESTS_128 + REQUESTS_512):
        s = 128 if i < REQUESTS_128 else 512
        rows = int(rng.choice([1, 3, 7, 13]))
        ids = rng.randint(0, 30522, (rows, s)).astype("int32")
        tt = (rng.rand(rows, s) < 0.5).astype("int32")
        lens = rng.randint(16, s + 1, rows)
        mask = (np.arange(s)[None, :] < lens[:, None]).astype("int32")
        reqs.append((ids, tt, mask))
    return reqs


def drive(np, eng, reqs, clients=4):
    """Closed loop: each client thread sends its next request when the
    last one has come back. Returns (outputs, latencies_ms, wall_s)."""
    outs = [None] * len(reqs)
    lat = [None] * len(reqs)

    def client(idx):
        for i in idx:
            t0 = time.perf_counter()
            outs[i] = eng.submit(*reqs[i]).result(600)
            lat[i] = (time.perf_counter() - t0) * 1e3

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client,
                                args=(range(c, len(reqs), clients),))
               for c in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return outs, lat, time.perf_counter() - t0


def serve(np, pred, reqs, label, smi):
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.serving import ServingEngine
    eng = ServingEngine(pred, buckets=[8, 32], max_batch=32, timeout_ms=2)
    t0 = time.perf_counter()
    fresh = eng.warmup([((128,), "int32")] * 3, [((512,), "int32")] * 3)
    warm_s = time.perf_counter() - t0
    n128 = REQUESTS_128

    # the main path: counts zeroed just before, read just after
    kernels.reset_launches()
    b0 = eng.stats()["batches"]
    outs128, lat128, wall128 = drive(np, eng, reqs[:n128])
    outs512, lat512, wall512 = drive(np, eng, reqs[n128:])
    launches = dict(kernels.launches)
    st = eng.stats()
    eng.close()
    batches = st["batches"] - b0
    check(all(o is not None for o in outs128 + outs512),
          f"{label}: a future did not resolve")
    check(st["failed"] == 0 and st["expired"] == 0,
          f"{label}: failed or expired requests: {st}")
    for (ids, _, _), (seq, pooled) in zip(reqs, outs128 + outs512):
        n, s = ids.shape
        check(seq.shape == (n, s, 768) and pooled.shape == (n, 768),
              f"{label}: output shapes {seq.shape}, {pooled.shape}")
        check(seq.dtype == np.float32 and np.isfinite(seq).all()
              and np.isfinite(pooled).all(), f"{label}: non-finite output")
    for name, k in LAUNCHES_PER_BATCH.items():
        check(launches[name] == k * batches,
              f"{label}: {name} launched {launches[name]} times in "
              f"{batches} batches, want {k} per batch")
    lat = np.asarray(lat128)
    rec = dict(phase="serve", precision=label, card=smi,
               requests=len(reqs), requests_seq128=n128, batches=batches,
               launches=launches, warmup_s=warm_s, warmed_signatures=fresh,
               compiles_after_warmup=st["compiles"] - fresh,
               p50_ms=float(np.percentile(lat, 50)),
               # the highest percentile with 10 of the 40 samples beyond it
               p75_ms=float(np.percentile(lat, 75)),
               # of 40 samples, p99 is in effect the slowest: not a tail
               p99_ms=float(np.percentile(lat, 99)),
               max_ms=float(lat.max()),
               qps=n128 / wall128,
               rows_per_s=sum(r[0].shape[0] for r in reqs[:n128]) / wall128,
               seq512_latency_ms=[float(x) for x in lat512],
               coalesced_rows=st["coalesced_rows"],
               padded_rows=st["padded_rows"])
    check(rec["compiles_after_warmup"] == 0,
          f"{label}: traffic met a signature warmup did not run")
    return outs128 + outs512, rec


# -- phases 6 and 7: training --------------------------------------------------

def train(np, smi, route):
    """``tools/bench_bert``'s pretraining step at full width and depth, on
    its ``default`` route or the ``fused`` one (the caller has set the
    kernel switch)."""
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.tools.bench_bert import Trainer
    import torch
    want = FUSED_LAUNCHES_PER_STEP if route == "fused" else \
        TRAIN_LAUNCHES_PER_STEP
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = Trainer(TRAIN_BATCH, TRAIN_SEQ, TRAIN_INNER)
    check(len(tr.model.bert.encoder) == 12 and
          tr.config.hidden_dropout_prob == 0.1 and
          tr.config.attention_probs_dropout_prob == 0.1,
          "training runs BERT-base with its default dropouts")
    tr.step(*tr.data)                                 # warm-up
    tr.losses[-1].item()
    warm_s = time.perf_counter() - t0

    # the main path: counts zeroed just before, read just after
    kernels.reset_launches()
    n0 = len(tr.losses)
    t0 = time.perf_counter()
    for _ in range(TRAIN_TIMED_CALLS):
        loss = tr.step(*tr.data)
    loss.item()
    wall = time.perf_counter() - t0
    launches = dict(kernels.launches)
    steps = TRAIN_TIMED_CALLS * TRAIN_INNER
    losses = [x.item() for x in tr.losses[n0:]]
    check(len(losses) == steps and all(math.isfinite(x) for x in losses),
          f"training ({route}): non-finite loss in {losses}")
    for name in kernels.SOURCES:
        k = want.get(name, 0)
        check(launches[name] == k * steps,
              f"training ({route}): {name} launched {launches[name]} times "
              f"in {steps} steps, want {k} a step")
    step_ms = wall / steps * 1e3
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30

    # the loss on one repeated batch must fall
    ids, mlm, nsp = (t[0] for t in tr.data)
    rep = [tr.one(ids, mlm, nsp) for _ in range(REPEAT_STEPS)]
    rep = [x.item() for x in rep]
    check(all(math.isfinite(x) for x in rep) and rep[-1] < rep[0],
          f"training ({route}): the loss on a repeated batch did not "
          f"fall: {rep}")
    rec = dict(phase="train", route=route,
               kernels_on=[k for k in kernels.KERNELS if kernels.enabled(k)],
               card=smi, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
               layers=len(tr.model.bert.encoder), amp="bfloat16",
               optimizer="AdamW(1e-4)", dropout=0.1, warmup_steps=TRAIN_INNER,
               warmup_s=warm_s, steps=steps, launches=launches,
               step_ms=step_ms,
               tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / (wall / steps),
               losses=losses, repeated_batch_losses=rep,
               peak_memory_gib=peak_gb)
    emit(rec)
    del tr
    return rec


def optimizer_routes(np, seed):
    """One BERT-base f32 backward with token types steps four copies of
    the same weights by each AdamW route; then one arena step on
    bench_bert's data (no token types) takes the arena's mask route."""
    import torch
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.models import BertConfig, BertForPretraining
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.tools.bench_bert import make_data
    t0 = time.perf_counter()
    ptt.seed(seed)
    cfg = BertConfig.base(hidden_dropout_prob=0.0,
                          attention_probs_dropout_prob=0.0)
    base = BertForPretraining(cfg).cuda().train()
    ids, mlm, nsp = (torch.from_numpy(a[0]).cuda() for a in
                     make_data(cfg.vocab_size, 4, TRAIN_SEQ, 1,
                               rng_seed=seed))
    tt = torch.from_numpy(np.random.RandomState(seed).randint(
        0, 2, (4, TRAIN_SEQ)).astype("int32")).cuda()
    logits, nsp_logits = base(ids, tt)
    base.loss(logits, nsp_logits, mlm, nsp).backward()
    del logits, nsp_logits
    check(all(p.grad is not None for p in base.parameters()),
          "optimizer routes: a parameter got no gradient")
    grads = [p.grad.detach().clone() for p in base.parameters()]
    base.clear_gradients()
    p0 = [p.detach().clone() for p in base.parameters()]
    n = len(p0)
    # name, AdamW options, kernels switched on, launches a step
    routes = (("plain", dict(use_fused=False, use_multi_tensor=False), {},
               {}),
              ("use_fused", dict(use_fused=True, use_multi_tensor=False), {},
               {"fused_adam": n}),
              ("use_multi_tensor", dict(use_multi_tensor=True), {},
               {"fused_adam_multi": 1}),
              ("flat_arena", dict(flat_arena=True),
               dict(fused_adam_multi=True), {"fused_adam_flat": 1}))
    params, launches, opts = {}, {}, {}
    for name, opt_kw, on, per_step in routes:
        model = copy.deepcopy(base)
        opt = optimizer.AdamW(learning_rate=OPT_LR,
                              parameters=list(model.parameters()), **opt_kw)
        kernels.configure(**on)
        try:
            # this route's path: counts zeroed just before, read just after
            kernels.reset_launches()
            for _ in range(OPT_STEPS):
                for p, g in zip(model.parameters(), grads):
                    p.grad = g.clone()
                opt.step()
                opt.clear_grad()
            torch.cuda.synchronize()
            launches[name] = dict(kernels.launches)
        finally:
            kernels.configure(fused_adam_multi=None)
        for k in ("fused_adam", "fused_adam_multi", "fused_adam_flat"):
            want = per_step.get(k, 0) * OPT_STEPS
            check(launches[name][k] == want,
                  f"optimizer route {name}: {k} launched "
                  f"{launches[name][k]} times, want {want}")
        params[name] = [p.detach() for p in model.parameters()]
        opts[name] = (model, opt)
    same = all(torch.equal(a, b) for a, b in
               zip(params["flat_arena"], params["use_multi_tensor"]))
    check(same, "optimizer routes: flat arena and multi-tensor differ")
    upd_plain = torch.cat([(a - q).ravel() for a, q in
                           zip(params["plain"], p0)])
    vs_plain = {}
    for name in ("use_fused", "use_multi_tensor", "flat_arena"):
        upd = torch.cat([(a - q).ravel() for a, q in zip(params[name], p0)])
        vs_plain[name] = dict(
            max_abs=(upd - upd_plain).abs().max().item(),
            update_rel_l2=((upd - upd_plain).norm() /
                           upd_plain.norm()).item())
        check(vs_plain[name]["max_abs"] <= 2 * OPT_LR * OPT_STEPS and
              vs_plain[name]["update_rel_l2"] <= F32_UPDATE_TOL,
              f"optimizer route {name} vs plain: {vs_plain[name]}")
    del upd, upd_plain
    # the arena on bench_bert's data: the token-type table gets no
    # gradient, so the arena takes its mask route and not the kernel
    model, opt = opts["flat_arena"]
    tt_table = model.bert.embeddings.token_type_embeddings.weight
    before = tt_table.detach().clone()
    kernels.configure(fused_adam_multi=True)
    try:
        kernels.reset_launches()
        logits, nsp_logits = model(ids)
        model.loss(logits, nsp_logits, mlm, nsp).backward()
        opt.step()
        opt.clear_grad()
        torch.cuda.synchronize()
        mask_launches = dict(kernels.launches)
    finally:
        kernels.configure(fused_adam_multi=None)
    check(mask_launches["fused_adam_flat"] == 0 and
          torch.equal(tt_table, before),
          f"flat arena without token types: fused_adam_flat launched "
          f"{mask_launches['fused_adam_flat']} times, or the token-type "
          f"table moved")
    rec = dict(phase="optimizer_routes", params=n, steps=OPT_STEPS,
               lr=OPT_LR, launches={k: {n_: v for n_, v in d.items()
                                        if n_.startswith("fused_adam")}
                                    for k, d in launches.items()},
               flat_equals_multi=same, vs_plain=vs_plain,
               param_tol=2 * OPT_LR * OPT_STEPS, update_tol=F32_UPDATE_TOL,
               mask_step_flat_launches=mask_launches["fused_adam_flat"],
               seconds=time.perf_counter() - t0)
    emit(rec)
    return rec


def f32_step_check(np, seed):
    """One float32 pretraining step of BERT-base (dropout 0) on the card
    and on the CPU from the same weights; on the card the float32 flash
    kernels launch once a layer each, counted."""
    import torch
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.models import BertConfig, BertForPretraining
    from paddle_tpu_torch.tools.bench_bert import make_data
    ptt.seed(seed)
    cfg = BertConfig.base(hidden_dropout_prob=0.0,
                          attention_probs_dropout_prob=0.0)
    cpu = BertForPretraining(cfg).train()
    card = copy.deepcopy(cpu).cuda()
    p0 = {n: p.detach().clone() for n, p in cpu.named_parameters()}
    data = [torch.from_numpy(a[0]) for a in
            make_data(cfg.vocab_size, 4, TRAIN_SEQ, 1, rng_seed=seed)]
    # token types too, so that every parameter has a gradient to compare
    data.append(torch.from_numpy(
        np.random.RandomState(seed).randint(0, 2, (4, TRAIN_SEQ)))
        .to(torch.int32))

    def step(model, dev):
        opt = optimizer.AdamW(learning_rate=1e-4,
                              parameters=model.parameters())
        ids, mlm, nsp, tt = (a.to(dev) for a in data)
        logits, nsp_logits = model(ids, tt)
        loss = model.loss(logits, nsp_logits, mlm, nsp)
        loss.backward()
        grads = {n: p.grad.detach().cpu() for n, p in
                 model.named_parameters() if p.grad is not None}
        opt.step()
        return loss.item(), grads, {n: p.detach().cpu() for n, p in
                                    model.named_parameters()}

    t0 = time.perf_counter()
    kernels.reset_launches()
    l_card, g_card, p_card = step(card, "cuda")
    torch.cuda.synchronize()
    launches = {n: kernels.launches[n] for n in TRAIN_LAUNCHES_PER_STEP}
    l_cpu, g_cpu, p_cpu = step(cpu, "cpu")
    check(set(g_card) == set(g_cpu) == set(p0),
          f"f32 step: gradients for {len(g_card)} and {len(g_cpu)} of "
          f"{len(p0)} params")
    loss_err = abs(l_card - l_cpu) / max(1.0, abs(l_cpu))
    grad_err = max((g_card[n] - g_cpu[n]).abs().max().item() /
                   max(g_cpu[n].abs().max().item(), 1e-30)
                   for n in g_cpu if g_cpu[n].abs().max() > 0)
    upd_card = torch.cat([(p_card[n] - p0[n]).ravel() for n in p0])
    upd_cpu = torch.cat([(p_cpu[n] - p0[n]).ravel() for n in p0])
    upd_err = ((upd_card - upd_cpu).norm() / upd_cpu.norm()).item()
    param_err = (upd_card - upd_cpu).abs().max().item()
    rec = dict(phase="f32_step", batch=4, seq=TRAIN_SEQ, loss_card=l_card,
               loss_cpu=l_cpu, loss_err=loss_err, loss_tol=F32_LOSS_TOL,
               max_grad_err_rel_to_max=grad_err, grad_tol=F32_GRAD_TOL,
               update_rel_l2=upd_err, update_tol=F32_UPDATE_TOL,
               max_param_abs_err=param_err, param_tol=2e-4,
               params_checked=len(p0), launches=launches,
               seconds=time.perf_counter() - t0)
    emit(rec)
    check(launches == TRAIN_LAUNCHES_PER_STEP,
          f"f32 step: launches {launches}, want {TRAIN_LAUNCHES_PER_STEP}")
    check(loss_err <= F32_LOSS_TOL, f"f32 step: loss {l_card} vs {l_cpu}")
    check(grad_err <= F32_GRAD_TOL, f"f32 step: gradient error {grad_err}")
    check(upd_err <= F32_UPDATE_TOL and param_err <= 2e-4,
          f"f32 step: parameters after AdamW differ: update relative L2 "
          f"{upd_err}, max {param_err}")
    return rec


# -- phase 10: the batch-norm kernels ---------------------------------------------

def batch_norm_case(torch, BN, label, dtype, shape, iters, gen):
    """The four batch-norm kernels on ``shape`` (N, H, W, C) channels-last
    data seen as (N H W, C) rows, x and g in ``dtype`` and every
    per-channel operand f32, as on the training path. Returns the four
    records in ``BN_KERNELS``' order."""
    dt = getattr(torch, dtype)
    es = torch.empty((), dtype=dt).element_size()
    c = shape[-1]
    m = math.prod(shape[:-1])
    eps = 1e-5
    sets = []
    for _ in range(n_sets(3 * m * c * es)):
        x = (torch.randn(m, c, device="cuda", generator=gen) * 2 + 1).to(dt)
        g = torch.randn(m, c, device="cuda", generator=gen).to(dt)
        w = torch.rand(c, device="cuda", generator=gen) + 0.5
        b = torch.randn(c, device="cuda", generator=gen)
        mean, _, rstd, scale, shift = BN.bn_stats_plain(x, w, b, eps)
        dg, db = BN.bn_bwd_reduce_plain(x, g, mean, rstd)
        gm, gv = torch.randn(2, c, device="cuda", generator=gen).unbind(0)
        sets.append(dict(x=x, g=g, w=w, b=b, eps=eps, mean=mean, rstd=rstd,
                         scale=scale, shift=shift, dg=dg, db=db, gm=gm,
                         gv=gv))
    # name -> (wrapper, plain version, operand names, bytes, operations);
    # the per-channel operands' bytes are counted too
    cases = {
        "batch_norm_stats": (BN.bn_stats, BN.bn_stats_plain,
                             ("x", "w", "b", "eps"),
                             m * c * es + 7 * c * 4, 3 * m * c),
        "batch_norm_normalize": (BN.bn_normalize, BN.bn_normalize_plain,
                                 ("x", "scale", "shift"),
                                 2 * m * c * es + 2 * c * 4, 2 * m * c),
        "batch_norm_bwd_reduce": (BN.bn_bwd_reduce, BN.bn_bwd_reduce_plain,
                                  ("x", "g", "mean", "rstd"),
                                  2 * m * c * es + 4 * c * 4, 5 * m * c),
        "batch_norm_bwd_dx": (BN.bn_bwd_dx, BN.bn_bwd_dx_plain,
                              ("x", "g", "mean", "rstd", "w", "dg", "db",
                               "gm", "gv"), 3 * m * c * es + 7 * c * 4,
                              6 * m * c),
    }
    recs = []
    for name in BN_KERNELS:
        kernel, plain, names, nbytes, ops = cases[name]
        arg_sets = [tuple(st[k] for k in names) for st in sets]
        got = kernel(*arg_sets[0])
        torch.cuda.synchronize()
        ref = plain(*arg_sets[0])
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        if name == "batch_norm_bwd_reduce":
            # sums over m rows: relative to their largest element
            err = max(abs_err(a, r) / max(1.0, r.abs().max().item())
                      for a, r in zip(got, ref))
        else:
            err = max(scaled_err(a, r) for a, r in zip(got, ref))
        # stats and sums are f32 whatever x's dtype
        tol = KERNEL_TOL[dtype if name in ("batch_norm_normalize",
                                           "batch_norm_bwd_dx")
                         else "float32"]
        rec = dict(phase="bn_kernel", name=name, case=label, dtype=dtype,
                   shape=[m, c],
                   max_abs_err=max(abs_err(a, r) for a, r in zip(got, ref)),
                   max_scaled_err=err, tol=tol)
        check(err <= tol, f"{name} {label} {dtype} {m}x{c}: error {err} > "
                          f"tolerance {tol}")
        check(all(bool(torch.isfinite(a).all()) for a in got),
              f"{name} {label}: non-finite output")
        if name in ("batch_norm_stats", "batch_norm_bwd_reduce"):
            again = kernel(*arg_sets[0])
            check(all(torch.equal(a, c2) for a, c2 in zip(got, again)),
                  f"{name} {label}: two runs differ (the reduction must be "
                  f"deterministic)")
        rec.update(timings(torch, kernel, plain, None, arg_sets, iters))
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, ops, "float32")
        rec["bytes"] = nbytes
        recs.append(rec)
    # the library yardstick: torch's training-mode batch norm on the same
    # channels-last data, forward, and forward+backward minus forward
    F = torch.nn.functional
    lib_sets = [(st["x"].view(shape).permute(0, 3, 1, 2).detach()
                 .requires_grad_(), st["w"].detach().requires_grad_(),
                 st["b"].detach().requires_grad_(),
                 st["g"].view(shape).permute(0, 3, 1, 2)) for st in sets]

    def library_fwd(x, w, b, g):
        return F.batch_norm(x, None, None, w, b, training=True, eps=eps)

    def library_fwd_bwd(x, w, b, g):
        return torch.autograd.grad(library_fwd(x, w, b, g), (x, w, b), g)

    with torch.no_grad():
        lib_fwd = graph_ms(torch, library_fwd, lib_sets, iters)
    lib_fwd_bwd = graph_ms(torch, library_fwd_bwd, lib_sets, iters)
    st, no, rd, dx = recs
    for rec, lib, pair in ((st, lib_fwd, st["ms"] + no["ms"]),
                           (no, lib_fwd, st["ms"] + no["ms"]),
                           (rd, lib_fwd_bwd - lib_fwd, rd["ms"] + dx["ms"]),
                           (dx, lib_fwd_bwd - lib_fwd, rd["ms"] + dx["ms"])):
        # the library call does the pair's work: stats + normalize in its
        # forward, reduce + dx in its backward
        rec.update(library_ms=lib, pair_ms=pair,
                   library_covers="stats + normalize"
                   if rec in (st, no) else "bwd_reduce + bwd_dx")
        emit(rec)
    return recs


# -- phases 11 and 12: ResNet-50 training -------------------------------------------

def train_resnet(np, smi, route, data_format):
    """``tools/bench_resnet``'s training step at full width and depth on
    one route (the caller has set the kernel switch)."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.tools.bench_resnet import Trainer
    import torch
    per_step = RESNET_BN_LAYERS if route == "kernels" else 0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = Trainer(RESNET_BATCH, RESNET_INNER, data_format, size=RESNET_SIZE)
    bns = [m for m in tr.model.modules() if isinstance(m, nn.BatchNorm)]
    n_params = sum(p.numel() for p in tr.model.parameters())
    check(len(bns) == RESNET_BN_LAYERS and n_params == 25_557_032,
          f"training runs ResNet-50: {len(bns)} batch norms, {n_params} "
          f"parameters")
    tr.step(*tr.data)                                 # warm-up
    tr.losses[-1].item()
    warm_s = time.perf_counter() - t0

    # the main path: counts zeroed just before, read just after
    kernels.reset_launches()
    n0 = len(tr.losses)
    t0 = time.perf_counter()
    for _ in range(RESNET_TIMED_CALLS):
        loss = tr.step(*tr.data)
    loss.item()
    wall = time.perf_counter() - t0
    launches = dict(kernels.launches)
    steps = RESNET_TIMED_CALLS * RESNET_INNER
    losses = [x.item() for x in tr.losses[n0:]]
    check(len(losses) == steps and all(math.isfinite(x) for x in losses),
          f"resnet training ({route}): non-finite loss in {losses}")
    for name in kernels.SOURCES:
        k = per_step if name in BN_KERNELS else 0
        check(launches[name] == k * steps,
              f"resnet training ({route}): {name} launched {launches[name]} "
              f"times in {steps} steps, want {k} a step")
    step_ms = wall / steps * 1e3
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30

    # the loss on one repeated batch must fall
    xb, yb = (t[0] for t in tr.data)
    rep = [tr.one(xb, yb) for _ in range(RESNET_REPEAT_STEPS)]
    rep = [x.item() for x in rep]
    check(all(math.isfinite(x) for x in rep) and rep[-1] < rep[0],
          f"resnet training ({route}): the loss on a repeated batch did not "
          f"fall: {rep}")
    stats = bns[0]._mean.float()
    check(bool(torch.isfinite(stats).all()) and bool(stats.abs().sum() > 0),
          f"resnet training ({route}): the running mean did not move")
    rec = dict(phase="train_resnet", route=route, data_format=data_format,
               kernels_on=[k for k in kernels.KERNELS if kernels.enabled(k)],
               card=smi, batch=RESNET_BATCH, size=RESNET_SIZE,
               batch_norm_layers=len(bns), params=n_params, amp="bfloat16",
               optimizer="Momentum(0.1, 0.9)", warmup_steps=RESNET_INNER,
               warmup_s=warm_s, steps=steps,
               launches={k: launches[k] for k in BN_KERNELS},
               launches_per_step={k: launches[k] // steps
                                  for k in BN_KERNELS},
               step_ms=step_ms, images_per_s=RESNET_BATCH / (wall / steps),
               losses=losses, repeated_batch_losses=rep,
               peak_memory_gib=peak_gb)
    emit(rec)
    del tr
    return rec


def resnet_f32_step_check(np, seed):
    """One float32 training step of ResNet-50 on the kernel route (NHWC,
    batch-norm kernels on) on the card and on the CPU, where the wrappers
    compute their plain versions, from the same weights."""
    import torch
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.models import resnet50
    from paddle_tpu_torch.ops import kernels, loss as loss_ops
    from paddle_tpu_torch.tools.bench_resnet import make_data, normalize_u8
    ptt.seed(seed)
    cpu = resnet50(data_format="NHWC").train()
    card = copy.deepcopy(cpu).cuda()
    s0 = {n: t.detach().clone() for n, t in cpu.state_dict().items()}
    x, y = (torch.from_numpy(a[0]) for a in
            make_data(8, 1, "NHWC", RESNET_SIZE, rng_seed=seed))

    def step(model, dev):
        opt = optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                 parameters=model.parameters())
        loss = loss_ops.cross_entropy(model(normalize_u8(x.to(dev))),
                                      y.to(dev))
        loss.backward()
        grads = {n: p.grad.detach().cpu() for n, p in
                 model.named_parameters()}
        opt.step()
        return loss.item(), grads, {n: t.detach().cpu() for n, t in
                                    model.state_dict().items()}

    t0 = time.perf_counter()
    kernels.reset_launches()
    l_card, g_card, s_card = step(card, "cuda")
    launches = {k: kernels.launches[k] for k in BN_KERNELS}
    l_cpu, g_cpu, s_cpu = step(cpu, "cpu")
    check(all(v == RESNET_BN_LAYERS for v in launches.values()),
          f"resnet f32 step: launches {launches}")
    check(set(g_card) == set(g_cpu) and len(g_cpu) == 161,
          f"resnet f32 step: gradients for {len(g_card)} and {len(g_cpu)} "
          f"params")
    loss_err = abs(l_card - l_cpu) / max(1.0, abs(l_cpu))
    rel = {n: ((g_card[n] - g_cpu[n]).norm() /
               g_cpu[n].norm().clamp_min(1e-30)).item() for n in g_cpu}
    worst = max(rel, key=rel.get)
    all_card = torch.cat([g_card[n].ravel() for n in g_cpu])
    all_cpu = torch.cat([g_cpu[n].ravel() for n in g_cpu])
    grad_err = ((all_card - all_cpu).norm() / all_cpu.norm()).item()
    # after the step: a parameter moved by lr * g, so the update is held as
    # the gradient is; the running statistics come from the forward alone
    params = list(g_cpu)
    upd_card = torch.cat([(s_card[n] - s0[n]).ravel() for n in params])
    upd_cpu = torch.cat([(s_cpu[n] - s0[n]).ravel() for n in params])
    upd_err = ((upd_card - upd_cpu).norm() / upd_cpu.norm()).item()
    stat_err = max(scaled_err(s_card[n], s_cpu[n]) for n in s_cpu
                   if n not in g_cpu)
    moved = all(not torch.equal(s_cpu[n], s0[n]) for n in s_cpu)
    rec = dict(phase="resnet_f32_step", batch=8, size=RESNET_SIZE,
               data_format="NHWC", launches=launches, loss_card=l_card,
               loss_cpu=l_cpu, loss_err=loss_err,
               loss_tol=RESNET_F32_LOSS_TOL, grad_rel_l2=grad_err,
               worst_grad=worst, worst_grad_rel_l2=rel[worst],
               fc_grad_rel_l2=rel["fc.weight"],
               grad_tol=RESNET_F32_GRAD_TOL,
               fc_grad_tol=RESNET_F32_FC_GRAD_TOL, update_rel_l2=upd_err,
               update_tol=RESNET_F32_GRAD_TOL,
               max_running_stat_scaled_err=stat_err,
               running_stat_tol=RESNET_F32_STAT_TOL,
               entries_checked=len(s_cpu),
               seconds=time.perf_counter() - t0)
    emit(rec)
    check(loss_err <= RESNET_F32_LOSS_TOL,
          f"resnet f32 step: loss {l_card} vs {l_cpu}")
    check(grad_err <= RESNET_F32_GRAD_TOL and
          rel["fc.weight"] <= RESNET_F32_FC_GRAD_TOL,
          f"resnet f32 step: gradient relative L2 {grad_err}, the "
          f"classifier's {rel['fc.weight']}")
    check(upd_err <= RESNET_F32_GRAD_TOL and moved,
          f"resnet f32 step: the Momentum update differs by {upd_err} "
          f"relative L2 (or an entry did not move)")
    check(stat_err <= RESNET_F32_STAT_TOL,
          f"resnet f32 step: running statistics differ by {stat_err}")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write every record to this file")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights, inputs and requests")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "false); the port's kernels run only on one", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    try:
        import paddle_tpu_torch as ptt
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e}); run "
              f"it from the root of a checkout", file=sys.stderr)
        return 2
    if Path(ptt.__file__).resolve().parent.parent != HERE:
        print(f"chip_smoke: imported {ptt.__file__}, not the checkout's "
              f"port", file=sys.stderr)
        return 2
    from paddle_tpu_torch.inference import Config, Predictor
    from paddle_tpu_torch.models import Bert, BertConfig
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.ops.kernels import batch_norm as BN
    from paddle_tpu_torch.ops.kernels import flash_attention as FA
    from paddle_tpu_torch.ops.kernels import fused_adam as FAD
    from paddle_tpu_torch.ops.kernels import layer_norm as LN
    from paddle_tpu_torch.ops.kernels import softmax_xent as SX

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # 1. device and build
    smi = nvidia_smi()
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    emit(dict(phase="device", nvidia_smi=smi, kind=kind,
              count=torch.cuda.device_count(), torch=torch.__version__,
              cuda=torch.version.cuda, python=sys.version.split()[0]))
    t0 = time.perf_counter()
    logs = kernels.build()
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "Used" in ln or "spill" in ln or "Compiling" in ln]
             for name, log in logs.items()}
    build_s = time.perf_counter() - t0
    emit(dict(phase="build", seconds=build_s,
              flags=" ".join(kernels.NVCC_FLAGS), ptxas=ptxas,
              instances=build_report(kernels, logs)))

    # 2. kernels against their plain versions, at the path's shapes
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    warm_card(torch)
    ln = [layer_norm_case(torch, LN, dt, n, 768, TIMED_ITERS, gen)
          for n in (4096, 8192) for dt in ("float32", "bfloat16")]
    for n, d, offset in LN_OTHER:
        for dt in ("float32", "bfloat16"):
            layer_norm_case(torch, LN, dt, n, d, TIMED_ITERS, gen, offset)
    fa = [flash_case(torch, FA, *c, TIMED_ITERS, gen) for c in (
        ("bert_s128", "float32", 32, 12, 128, 64, "key", False),
        ("bert_s128", "bfloat16", 32, 12, 128, 64, "key", False),
        ("bert_s512", "float32", 4, 12, 512, 64, "key", False),
        ("causal", "float32", 4, 12, 512, 64, None, True),
        ("full_mask", "float32", 4, 12, 128, 64, "full", False),
        ("bool_fully_masked_row", "bfloat16", 4, 12, 128, 64, "bool",
         False),
        ("unaligned_s200", "float32", 4, 12, 200, 64, "key", False),
        ("head_dim_128", "bfloat16", 4, 8, 256, 128, None, False),
        ("causal", "bfloat16", 4, 12, 512, 64, None, True),
        ("unaligned_s200", "bfloat16", 4, 12, 200, 64, "key", False),
        ("full_mask", "bfloat16", 4, 12, 128, 64, "full", False))]
    fa += [flash_case(torch, FA, "q77_k200", "bfloat16", 4, 12, 77, 64,
                      "key", False, TIMED_ITERS, gen, sk=200),
           flash_case(torch, FA, "head_dim_128_causal_dropout", "bfloat16",
                      4, 8, 256, 128, None, True, TIMED_ITERS, gen,
                      dropout_p=DROPOUT_P)]
    # head dims the kernels run zero-padded, float16 through the float32
    # kernels, and masks the reference hands to sdpa under causal
    fa += [flash_case(torch, FA, *c, TIMED_ITERS, gen) for c in FLASH_OTHER]

    # 3. serving, f32
    ptt.seed(args.seed)
    model = Bert(BertConfig.base()).eval()
    check(len(model.encoder) == 12, "BertConfig.base() must have 12 layers")
    n_params = sum(p.numel() for p in model.parameters())
    cpu_model = copy.deepcopy(model)
    reqs = make_requests(np, args.seed)
    outs32, rec32 = serve(np, Predictor(model), reqs, "float32", smi)
    cpu = Predictor(cpu_model, device="cpu")
    small = [i for i in range(REQUESTS_128)
             if reqs[i][0].shape[0] <= 7][:3]
    errs = []
    for i in small:
        ref = cpu.run(*reqs[i])
        errs.append(max(float(np.abs(a - r).max())
                        for a, r in zip(outs32[i], ref)))
    check(len(small) == 3 and max(errs) <= SERVE_F32_TOL,
          f"f32 serving vs the CPU: errors {errs} > {SERVE_F32_TOL}")
    rec32.update(params=n_params, layers=len(model.encoder),
                 cpu_check_requests=small, cpu_max_abs_err=errs,
                 cpu_tol=SERVE_F32_TOL)
    emit(rec32)

    # 4. serving, bf16
    outs16, rec16 = serve(np, Predictor(model, Config().enable_bf16()),
                          reqs, "bfloat16", smi)
    rel = max(float(np.linalg.norm(a - r) / np.linalg.norm(r))
              for o16, o32 in zip(outs16, outs32) for a, r in zip(o16, o32))
    mx = max(float(np.abs(a - r).max())
             for o16, o32 in zip(outs16, outs32) for a, r in zip(o16, o32))
    check(rel <= SERVE_BF16_REL_TOL,
          f"bf16 serving vs f32: relative error {rel} > tolerance")
    rec16.update(vs_f32_max_rel_l2=rel, vs_f32_max_abs=mx,
                 tol_rel_l2=SERVE_BF16_REL_TOL)
    emit(rec16)

    # 5. the training kernels against their plain versions
    lnb = [layer_norm_bwd_case(torch, LN, dt, 8192, 768, TIMED_ITERS, gen)
           for dt in ("float32", "bfloat16")]
    for n, d, offset in LN_OTHER:
        for dt in ("float32", "bfloat16"):
            layer_norm_bwd_case(torch, LN, dt, n, d, TIMED_ITERS, gen,
                                offset)
    flash_case(torch, FA, "bert_s128_dropout", "bfloat16", 64, 12, 128, 64,
               "key", False, TIMED_ITERS, gen, dropout_p=DROPOUT_P,
               phase="train_kernel")
    fab = [flash_bwd_case(torch, FA, *c, TIMED_ITERS, gen) for c in (
        ("bert_s128_dropout", "bfloat16", 64, 12, 128, 64, "key", False,
         DROPOUT_P),
        ("bert_s128", "bfloat16", 64, 12, 128, 64, "key", False, 0.0),
        ("bert_s128", "float32", 64, 12, 128, 64, "key", False, 0.0),
        ("causal", "float32", 4, 12, 512, 64, None, True, 0.0),
        ("unaligned_s200", "float32", 4, 12, 200, 64, "key", False, 0.0),
        ("head_dim_128", "bfloat16", 4, 8, 256, 128, None, False, 0.0),
        ("causal", "bfloat16", 4, 12, 512, 64, None, True, 0.0),
        ("unaligned_s200", "bfloat16", 4, 12, 200, 64, "key", False, 0.0),
        ("full_mask", "bfloat16", 4, 12, 128, 64, "full", False, 0.0),
        ("head_dim_128_causal_dropout", "bfloat16", 4, 8, 256, 128, None,
         True, DROPOUT_P))]
    fab.append(flash_bwd_case(torch, FA, "q77_k200", "bfloat16", 4, 12, 77,
                              64, "key", False, 0.0, TIMED_ITERS, gen,
                              sk=200))
    fab += [flash_bwd_case(torch, FA, *c, TIMED_ITERS, gen) for c in (
        ("head_dim_128_causal", "float32", 4, 8, 256, 128, None, True, 0.0),
        ("bert_s128_dropout", "float32", 64, 12, 128, 64, "key", False,
         DROPOUT_P),
        ("full_mask", "float32", 4, 12, 128, 64, "full", False, 0.0))]
    fab += [flash_bwd_case(torch, FA, *c, 0.0, TIMED_ITERS, gen)
            for c in FLASH_OTHER]

    # 6. the loss and optimizer kernels against their plain versions
    del model, cpu_model
    torch.cuda.empty_cache()
    xent = [xent_case(torch, SX, *c, XENT_ITERS, gen) for c in (
        ("bert_mlm", "float32", 8192, 30522, 0.0, "bench"),
        ("bert_mlm", "bfloat16", 8192, 30522, 0.0, "bench"),
        ("smoothing", "float32", 4096, 30522, 0.1, "all"),
        ("bert_nsp", "float32", 64, 2, 0.0, "all"),
        ("out_of_range", "float32", 8192, 2500, 0.0, "oor"))]
    adam1 = [fused_adam_case(torch, FAD, *c, TIMED_ITERS, gen) for c in (
        ("float32", (30522, 768)), ("bfloat16", (1000, 77)))]
    multi, flat = fused_adam_multi_flat_cases(torch, FAD, pretraining_shapes(),
                                              ADAM_ITERS, gen)
    torch.cuda.empty_cache()

    # 7. training on the default route, then on the fused route
    rect = train(np, smi, "default")
    kernels.configure(softmax_xent=True, fused_adam_multi=True)
    try:
        rectf = train(np, smi, "fused")
    finally:
        kernels.configure(softmax_xent=None, fused_adam_multi=None)
    emit(dict(phase="train_routes", card=smi,
              default_step_ms=rect["step_ms"],
              default_tokens_per_s=rect["tokens_per_s"],
              fused_step_ms=rectf["step_ms"],
              fused_tokens_per_s=rectf["tokens_per_s"]))

    # 8. the optimizer routes, and 9. the f32 step against the CPU
    rop = optimizer_routes(np, args.seed)
    f32_step_check(np, args.seed)

    # 10. the batch-norm kernels against their plain versions
    torch.cuda.empty_cache()
    bn = [batch_norm_case(torch, BN, "x".join(map(str, shape)), "bfloat16",
                          shape, BN_ITERS, gen) for shape in BN_PATH_SHAPES]
    batch_norm_case(torch, BN, "f32", "float32", (128, 28, 28, 256),
                    BN_ITERS, gen)
    batch_norm_case(torch, BN, "scalar_route_ragged_rows", "bfloat16",
                    (10007, 1, 1, 100), BN_ITERS, gen)
    torch.cuda.empty_cache()

    # 11. ResNet-50 training: NCHW and NHWC on the plain batch norm, then
    # NHWC through the batch-norm kernels
    recr = {}
    for route, fmt, on in (("default", "NCHW", None),
                           ("nhwc_plain", "NHWC", None),
                           ("kernels", "NHWC", True)):
        kernels.configure(batch_norm=on)
        try:
            recr[route] = train_resnet(np, smi, route, fmt)
        finally:
            kernels.configure(batch_norm=None)
    for route, rec in recr.items():
        print(json.dumps(dict(
            phase="train_resnet_route", route=route, card=smi,
            step_ms=rec["step_ms"], images_per_s=rec["images_per_s"],
            peak_memory_gib=rec["peak_memory_gib"],
            batch_norm_launches_per_step=rec["launches_per_step"])),
            flush=True)

    # 12. the ResNet f32 step against the CPU
    kernels.configure(batch_norm=True)
    try:
        resnet_f32_step_check(np, args.seed)
    finally:
        kernels.configure(batch_norm=None)

    # 13. the kernels line, the card, and the verdict
    csrc = "paddle_tpu_torch/csrc/"
    pallas = "paddle_tpu/ops/pallas/"
    fb = fab[0]
    line = []
    for name, source, replaces, launches, rec in (
            ("layer_norm_fwd", "layer_norm.cu", "layer_norm.py:78",
             rec32["launches"], ln[0]),
            ("flash_attention_fwd", "flash_attention.cu",
             "flash_attention.py:344", rec16["launches"], fa[1]),
            ("layer_norm_bwd", "layer_norm_bwd.cu", "layer_norm.py:122",
             rect["launches"], lnb[0]),
            ("flash_attention_bwd_dq", "flash_attention_bwd.cu",
             "flash_attention.py:434", rect["launches"],
             dict(fb, ms=fb["dq_ms"], max_abs_err=fb["max_abs_err"]["dq"],
                  bound_ms=fb["bound_dq_ms"], bound_by=fb["bound_dq_by"])),
            ("flash_attention_bwd_dkv", "flash_attention_bwd.cu",
             "flash_attention.py:469", rect["launches"],
             dict(fb, ms=fb["dkv_ms"],
                  max_abs_err=max(fb["max_abs_err"]["dk"],
                                  fb["max_abs_err"]["dv"]),
                  bound_ms=fb["bound_dkv_ms"], bound_by=fb["bound_dkv_by"])),
            ("softmax_xent_fwd", "softmax_xent.cu", "softmax_xent.py:79",
             rectf["launches"], xent[0][0]),
            ("softmax_xent_bwd", "softmax_xent.cu", "softmax_xent.py:105",
             rectf["launches"], xent[0][1]),
            ("fused_adam", "fused_adam.cu", "fused_adam.py:62",
             rop["launches"]["use_fused"], adam1[0]),
            ("fused_adam_multi", "fused_adam.cu", "fused_adam.py:161",
             rectf["launches"], multi),
            ("fused_adam_flat", "fused_adam.cu", "fused_adam.py:232",
             rop["launches"]["flat_arena"], flat),
            ("batch_norm_stats", "batch_norm.cu", "batch_norm.py:118",
             recr["kernels"]["launches"], bn[0][0]),
            ("batch_norm_normalize", "batch_norm.cu", "batch_norm.py:138",
             recr["kernels"]["launches"], bn[0][1]),
            ("batch_norm_bwd_reduce", "batch_norm.cu", "batch_norm.py:181",
             recr["kernels"]["launches"], bn[0][2]),
            ("batch_norm_bwd_dx", "batch_norm.cu", "batch_norm.py:199",
             recr["kernels"]["launches"], bn[0][3])):
        check(launches[name] > 0,
              f"{name}: no launch on its path")
        line.append(dict(name=name, route="cuda", source=csrc + source,
                         replaces=pallas + replaces,
                         launches=launches[name],
                         max_abs_err=rec["max_abs_err"], ms=rec["ms"],
                         plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
                         bound_by=rec["bound_by"],
                         library_ms=rec["library_ms"]))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            dict(records=RECORDS, kernels=line,
                 seconds=time.perf_counter() - t_start), indent=1))
    print(json.dumps({"kernels": line}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
