#!/usr/bin/env python3
"""Drive the PyTorch port's BERT-base serving and training paths on one
CUDA card.

    python3 chip_smoke.py [--out PATH] [--seed N]

Run from the root of a checkout. It imports ``paddle_tpu_torch`` (never
``jax`` or ``paddle_tpu``) and fails, printing no result, where there is
no CUDA card or no port beside it. Phases, each printed as JSON lines:

1. device: the card's name and power limit; every kernel of the path is
   built from ``paddle_tpu_torch/csrc`` (one ``nvcc`` per source, all at
   once) and ``-Xptxas -v``'s registers, shared memory and spills shown.
2. kernels: each kernel's wrapper against its plain PyTorch version on the
   card, at the shapes the serving path gives it, with the tolerance
   stated; CUDA-event times of the kernel, the plain version and one
   PyTorch library call computing the same function (a yardstick the port
   never calls), replayed from a CUDA graph so that they are the card's
   time alone, beside the least time the card could take (bytes over
   3.35 TB/s or operations over the peak rate of the inputs' type), and
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
5. training kernels: the layer-norm backward kernel, the flash forward
   kernel with in-kernel dropout (and its kept fraction), and the flash
   dQ and dK/dV kernels, each against its plain version on the card at
   the training path's shapes (and causal, unaligned and head-dim-128
   cases), timed as in phase 2; the library yardsticks are
   ``aten.native_layer_norm_backward`` and the backward of
   ``scaled_dot_product_attention``.
6. training: ``tools/bench_bert``'s step at full width and depth
   (BERT-base pretraining, batch 64, seq 128, amp bf16, AdamW 1e-4,
   dropouts 0.1): 8 warm-up steps, then 16 steps with the launch counters
   zeroed just before and read just after (26 layer-norm forward and
   backward, 12 flash forward, dQ and dK/dV launches a step), every loss
   finite, step time and tokens/s; then 11 steps on one batch, whose loss
   must fall.
7. f32 step check: one BERT-base pretraining step in float32 (TF32 off,
   dropout 0, batch 4, seq 128) on the card and on the CPU from the same
   weights: the loss, every gradient and every parameter after AdamW.
8. the ``kernels`` line, the card's name and power limit, and the last
   line ``{"ok": true, "device": {...}}``.

Any failed check raises and the script exits non-zero. ``--out`` also
writes every record to a JSON file.
"""
from __future__ import annotations

import argparse
import copy
import json
import math
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent

# H100 SXM, dense (NVIDIA's data sheet): HBM bandwidth, and the peak rate
# for each input type: bf16 on the tensor cores, float32 on the CUDA cores
# (the port's float32 arithmetic is full float32, not TF32).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12}
# kernel vs plain version, as |diff| / max(1, |plain|): float32 sums in
# another order; bf16 rounds the f32 result once, one step being 2^-8
# relative, so 2e-2 allows a few steps
KERNEL_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# the served f32 model on the card vs the same model on the CPU: 12
# layers of float32 matmuls in another summation order (the gap measured
# on an H100 is about 5e-6)
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
TIMED_ITERS = 50             # launches per timed run (median of 5 runs)
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


# -- phase 2: kernels against their plain versions ----------------------------

def layer_norm_case(torch, LN, dtype, n, d, iters, gen):
    dt = getattr(torch, dtype)
    es = torch.empty((), dtype=dt).element_size()
    eps = 1e-12
    set_bytes = n * d * es * 2
    sets = []
    for _ in range(n_sets(set_bytes)):
        x = (torch.randn(n, d, device="cuda", generator=gen) * 3 + 1).to(dt)
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
               shape=[n, d], eps=eps, max_abs_err=abs_err(y, y0),
               max_scaled_err=err, tol=KERNEL_TOL[dtype])
    check(err <= KERNEL_TOL[dtype],
          f"layer_norm_fwd {dtype} {n}x{d}: error {err} > tolerance")
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


def flash_case(torch, FA, label, dtype, b, h, s, d, mask_kind, causal,
               iters, gen):
    dt = getattr(torch, dtype)
    es = torch.empty((), dtype=dt).element_size()
    sets = [st[:4] for st in flash_sets(torch, dtype, b, h, s, d, mask_kind,
                                         gen, n_sets(4 * b * h * s * d * es))]
    q, k, v, mask = sets[0]
    out, m, l = FA.flash_attention_fwd(q, k, v, mask, causal=causal)
    torch.cuda.synchronize()
    out0, m0, l0 = FA.flash_attention_fwd_plain(q, k, v, mask, causal=causal)
    err = max(scaled_err(out, out0), scaled_err(m, m0), scaled_err(l, l0))
    rec = dict(phase="kernel", name="flash_attention_fwd", case=label,
               dtype=dtype, shape=[b, h, s, d], mask=mask_kind,
               causal=causal, max_abs_err=abs_err(out, out0),
               max_scaled_err=err, tol=KERNEL_TOL[dtype])
    check(err <= KERNEL_TOL[dtype],
          f"flash_attention_fwd {label}: error {err} > tolerance")
    if mask_kind == "bool":
        check(bool((out[0, :, 5] == 0).all()),
              "flash_attention_fwd: a fully masked row must give 0")
    F = torch.nn.functional

    def library(q, k, v, mask):
        if mask is not None and mask.dtype != torch.bool:
            mask = mask.to(q.dtype)
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                              is_causal=causal)

    rec.update(timings(
        torch, lambda *a: FA.flash_attention_fwd(*a, causal=causal),
        lambda *a: FA.flash_attention_fwd_plain(*a, causal=causal),
        library, sets, iters))
    # q, k, v read and O written once, the mask read as given, m and l
    # written; two products of 2*D operations per (query, key) pair the
    # function needs (the lower triangle when causal)
    pairs = s * (s + 1) // 2 if causal else s * s
    nbytes = (4 * b * h * s * d * es + 2 * b * h * s * 4 +
              (0 if mask is None else mask.numel() * mask.element_size()))
    rec["bound_ms"], rec["bound_by"] = bound(nbytes, 4 * b * h * pairs * d,
                                             dtype)
    rec["bytes"] = nbytes
    emit(rec)
    return rec


# -- phase 5: the training kernels against their plain versions --------------

def layer_norm_bwd_case(torch, LN, dtype, n, d, iters, gen):
    """The backward kernel at (n, d), x and g in ``dtype`` and the weight
    f32, as on the training path."""
    dt = getattr(torch, dtype)
    es = torch.empty((), dtype=dt).element_size()
    eps = 1e-12
    sets = []
    for _ in range(n_sets(3 * n * d * es)):
        x = (torch.randn(n, d, device="cuda", generator=gen) * 3 + 1).to(dt)
        w = torch.rand(d, device="cuda", generator=gen) + 0.5
        b = torch.randn(d, device="cuda", generator=gen)
        g = torch.randn(n, d, device="cuda", generator=gen).to(dt)
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
               shape=[n, d], max_abs_err=max(abs_err(a, r)
                                             for a, r in zip(got, ref)),
               max_scaled_err=err, tol=KERNEL_TOL[dtype])
    check(err <= KERNEL_TOL[dtype],
          f"layer_norm_bwd {dtype} {n}x{d}: error {err} > tolerance")
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


def flash_sets(torch, dtype, b, h, s, d, mask_kind, gen, count):
    """``count`` input sets (q, k, v, mask, dO): head-split views of a
    fused (B, S, 3, H, D) projection, as BERT gives the kernels; a key
    padding mask of real lengths 16..S, a full f32 bias, a bool mask with
    one query row that sees no key, or none; and dO in the (B, S, H, D)
    memory order the model hands the backward."""
    dt = getattr(torch, dtype)
    sets = []
    for _ in range(count):
        qkv = torch.randn(b, s, 3, h, d, device="cuda", generator=gen)
        qkv = qkv.to(dt).permute(2, 0, 3, 1, 4)
        mask = None
        if mask_kind == "key":
            lens = torch.randint(16, s + 1, (b,), device="cuda",
                                 generator=gen)
            keep = torch.arange(s, device="cuda")[None, :] < lens[:, None]
            mask = ((~keep).float() * -1e9)[:, None, None, :]
        elif mask_kind == "full":
            mask = torch.randn(b, 1, s, s, device="cuda", generator=gen) * 2
        elif mask_kind == "bool":
            mask = torch.rand(b, 1, s, s, device="cuda", generator=gen) > 0.3
            mask[0, 0, 5, :] = False       # one query row sees no key
        do = torch.randn(b, s, h, d, device="cuda", generator=gen).to(dt)
        sets.append((qkv[0], qkv[1], qkv[2], mask, do.transpose(1, 2)))
    return sets


def flash_dropout_fwd_case(torch, FA, dtype, b, h, s, d, iters, gen):
    """The forward kernel with in-kernel dropout at the training path's
    shape, against its plain version with the same seed."""
    dt = getattr(torch, dtype)
    es = torch.empty((), dtype=dt).element_size()
    seed = (20240601, -17)
    sets = [st[:4] for st in flash_sets(torch, dtype, b, h, s, d, "key",
                                         gen, n_sets(4 * b * h * s * d * es))]
    q, k, v, mask = sets[0]
    out, m, l = FA.flash_attention_fwd(q, k, v, mask, dropout_p=DROPOUT_P,
                                       seed=seed)
    torch.cuda.synchronize()
    out0, m0, l0 = FA.flash_attention_fwd_plain(q, k, v, mask,
                                                dropout_p=DROPOUT_P,
                                                seed=seed)
    err = max(scaled_err(out, out0), scaled_err(m, m0), scaled_err(l, l0))
    kept = FA.dropout_keep_mask(seed, b * h, s, s, DROPOUT_P,
                                "cuda").float().mean().item()
    rec = dict(phase="train_kernel", name="flash_attention_fwd",
               case="bert_s128_dropout", dtype=dtype, shape=[b, h, s, d],
               mask="key", dropout_p=DROPOUT_P, kept_fraction=kept,
               max_abs_err=abs_err(out, out0), max_scaled_err=err,
               tol=KERNEL_TOL[dtype])
    check(err <= KERNEL_TOL[dtype],
          f"flash_attention_fwd with dropout: error {err} > tolerance")
    check(abs(kept - (1 - DROPOUT_P)) <= KEEP_TOL,
          f"flash_attention_fwd: kept fraction {kept}, want "
          f"{1 - DROPOUT_P} +- {KEEP_TOL}")
    F = torch.nn.functional
    rec.update(timings(
        torch, lambda *a: FA.flash_attention_fwd(*a, dropout_p=DROPOUT_P,
                                                 seed=seed),
        lambda *a: FA.flash_attention_fwd_plain(*a, dropout_p=DROPOUT_P,
                                                seed=seed),
        lambda q, k, v, mask: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask.to(q.dtype), dropout_p=DROPOUT_P),
        sets, iters))
    nbytes = 4 * b * h * s * d * es + 2 * b * h * s * 4 + b * s * 4
    rec["bound_ms"], rec["bound_by"] = bound(nbytes, 4 * b * h * s * s * d,
                                             dtype)
    rec["bytes"] = nbytes
    emit(rec)
    return rec


def flash_bwd_case(torch, FA, label, dtype, b, h, s, d, mask_kind, causal,
                   dropout_p, iters, gen):
    """The dQ and dK/dV kernels against the plain backward, timed each on
    its own (``dq``, ``dkv``), together with the delta reduction
    (``ms``), and against the plain backward and the backward of
    ``scaled_dot_product_attention``, which compute all three gradients."""
    dt = getattr(torch, dtype)
    es = torch.empty((), dtype=dt).element_size()
    seed = (7, 11)
    sets = flash_sets(torch, dtype, b, h, s, d, mask_kind, gen,
                      n_sets(8 * b * h * s * d * es))
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
               dtype=dtype, shape=[b, h, s, d], mask=mask_kind,
               causal=causal, dropout_p=dropout_p,
               max_abs_err={n: abs_err(a, r)
                            for n, a, r in zip(names, got, ref)},
               max_scaled_err=err, tol=KERNEL_TOL[dtype])
    check(err <= KERNEL_TOL[dtype],
          f"flash_attention_bwd {label}: error {err} > tolerance")
    check(all(bool(torch.isfinite(a).all()) for a in got),
          f"flash_attention_bwd {label}: non-finite gradient")
    F = torch.nn.functional
    cms = [FA._canon_mask(a[3], b, h, s, s) for a in full]
    launchers = [(FA._bwd_setup(q, k, v, cm, out, m, l, do, causal, None,
                                dropout_p, seed)[3],)
                 for (q, k, v, _, out, m, l, do), cm in zip(full, cms)]
    rec["dq_ms"] = graph_ms(torch, lambda L: L(FA.BWD_DQ), launchers, iters)
    rec["dkv_ms"] = graph_ms(torch, lambda L: L(FA.BWD_DKV), launchers,
                             iters)
    # the library's backward alone cannot be captured (autograd runs it on
    # the stream of its forward): its forward and backward are captured
    # together, its forward alone likewise, and the backward is the
    # difference of the two device times
    lib_sets = [(torch.stack([q, k, v]).detach().requires_grad_(),
                 None if mask is None else mask.to(q.dtype), do)
                for q, k, v, mask, do in sets]

    def library_fwd(qkv, mask, do):
        return F.scaled_dot_product_attention(
            qkv[0], qkv[1], qkv[2], attn_mask=mask, is_causal=causal,
            dropout_p=dropout_p)

    def library_fwd_bwd(qkv, mask, do):
        return torch.autograd.grad(library_fwd(qkv, mask, do), qkv, do)

    # the kernel time here is the wrapper's: delta, then both kernels
    rec.update(timings(
        torch, lambda *a: FA.flash_attention_bwd(*a, causal=causal,
                                                 dropout_p=dropout_p,
                                                 seed=seed),
        lambda *a: FA.flash_attention_bwd_plain(*a, causal=causal,
                                                dropout_p=dropout_p,
                                                seed=seed),
        None, full, iters))
    with torch.no_grad():
        rec["library_fwd_ms"] = graph_ms(torch, library_fwd, lib_sets, iters)
    rec["library_fwd_bwd_ms"] = graph_ms(torch, library_fwd_bwd, lib_sets,
                                         iters)
    rec["library_ms"] = rec["library_fwd_bwd_ms"] - rec["library_fwd_ms"]
    # each kernel's own work: dQ reads q, k, v, dO, m, l, delta (and the
    # mask) and writes dq, three products of 2 D operations a (query, key)
    # pair; dK/dV reads the same and writes dk and dv, four products
    pairs = s * (s + 1) // 2 if causal else s * s
    mask_bytes = 0 if sets[0][3] is None else sets[0][3].numel() * 4
    rd = 4 * b * h * s * d * es + 3 * b * h * s * 4 + mask_bytes
    rec["bound_dq_ms"], rec["bound_dq_by"] = bound(
        rd + b * h * s * d * es, 6 * b * h * pairs * d, dtype)
    rec["bound_dkv_ms"], rec["bound_dkv_by"] = bound(
        rd + 2 * b * h * s * d * es, 8 * b * h * pairs * d, dtype)
    emit(rec)
    return rec


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

def train(np, smi):
    """``tools/bench_bert``'s pretraining step at full width and depth."""
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.tools.bench_bert import Trainer
    import torch
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
          f"training: non-finite loss in {losses}")
    for name, k in TRAIN_LAUNCHES_PER_STEP.items():
        check(launches[name] == k * steps,
              f"training: {name} launched {launches[name]} times in "
              f"{steps} steps, want {k} a step")
    step_ms = wall / steps * 1e3
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30

    # the loss on one repeated batch must fall
    ids, mlm, nsp = (t[0] for t in tr.data)
    rep = [tr.one(ids, mlm, nsp) for _ in range(REPEAT_STEPS)]
    rep = [x.item() for x in rep]
    check(all(math.isfinite(x) for x in rep) and rep[-1] < rep[0],
          f"training: the loss on a repeated batch did not fall: {rep}")
    rec = dict(phase="train", card=smi, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
               layers=len(tr.model.bert.encoder), amp="bfloat16",
               optimizer="AdamW(1e-4)", dropout=0.1, warmup_steps=TRAIN_INNER,
               warmup_s=warm_s, steps=steps, launches=launches,
               step_ms=step_ms,
               tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / (wall / steps),
               losses=losses, repeated_batch_losses=rep,
               peak_memory_gib=peak_gb)
    emit(rec)
    return rec


def f32_step_check(np, seed):
    """One float32 pretraining step of BERT-base (dropout 0) on the card
    and on the CPU from the same weights."""
    import torch
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import optimizer
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
    l_card, g_card, p_card = step(card, "cuda")
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
               params_checked=len(p0), seconds=time.perf_counter() - t0)
    emit(rec)
    check(loss_err <= F32_LOSS_TOL, f"f32 step: loss {l_card} vs {l_cpu}")
    check(grad_err <= F32_GRAD_TOL, f"f32 step: gradient error {grad_err}")
    check(upd_err <= F32_UPDATE_TOL and param_err <= 2e-4,
          f"f32 step: parameters after AdamW differ: update relative L2 "
          f"{upd_err}, max {param_err}")
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
    from paddle_tpu_torch.ops.kernels import flash_attention as FA
    from paddle_tpu_torch.ops.kernels import layer_norm as LN

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
    emit(dict(phase="build", seconds=time.perf_counter() - t0,
              flags=" ".join(kernels.NVCC_FLAGS), ptxas=ptxas))

    # 2. kernels against their plain versions, at the path's shapes
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    warm_card(torch)
    ln = [layer_norm_case(torch, LN, dt, 4096, 768, TIMED_ITERS, gen)
          for dt in ("float32", "bfloat16")]
    fa = [flash_case(torch, FA, *c, TIMED_ITERS, gen) for c in (
        ("bert_s128", "float32", 32, 12, 128, 64, "key", False),
        ("bert_s128", "bfloat16", 32, 12, 128, 64, "key", False),
        ("bert_s512", "float32", 4, 12, 512, 64, "key", False),
        ("causal", "float32", 4, 12, 512, 64, None, True),
        ("full_mask", "float32", 4, 12, 128, 64, "full", False),
        ("bool_fully_masked_row", "bfloat16", 4, 12, 128, 64, "bool",
         False),
        ("unaligned_s200", "float32", 4, 12, 200, 64, "key", False),
        ("head_dim_128", "bfloat16", 4, 8, 256, 128, None, False))]

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
    flash_dropout_fwd_case(torch, FA, "bfloat16", 64, 12, 128, 64,
                           TIMED_ITERS, gen)
    fab = [flash_bwd_case(torch, FA, *c, TIMED_ITERS, gen) for c in (
        ("bert_s128_dropout", "bfloat16", 64, 12, 128, 64, "key", False,
         DROPOUT_P),
        ("bert_s128", "bfloat16", 64, 12, 128, 64, "key", False, 0.0),
        ("causal", "float32", 4, 12, 512, 64, None, True, 0.0),
        ("unaligned_s200", "float32", 4, 12, 200, 64, "key", False, 0.0),
        ("head_dim_128", "bfloat16", 4, 8, 256, 128, None, False, 0.0))]

    # 6. training, and 7. the f32 step against the CPU
    del model, cpu_model
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rect = train(np, smi)
    f32_step_check(np, args.seed)

    # 8. the kernels line, the card, and the verdict
    csrc = "paddle_tpu_torch/csrc/"
    pallas = "paddle_tpu/ops/pallas/"
    fb = fab[0]
    line = []
    for name, source, replaces, launches, rec in (
            ("layer_norm_fwd", "layer_norm.cu", "layer_norm.py:78",
             rec32["launches"], ln[0]),
            ("flash_attention_fwd", "flash_attention.cu",
             "flash_attention.py:344", rec32["launches"], fa[0]),
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
                  bound_ms=fb["bound_dkv_ms"], bound_by=fb["bound_dkv_by"]))):
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
