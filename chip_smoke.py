#!/usr/bin/env python3
"""Drive the PyTorch port's BERT-base serving path on one CUDA card.

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
5. the ``kernels`` line, the card's name and power limit, and the last
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
    return dict(ms=graph_ms(torch, kernel, sets, iters),
                plain_ms=graph_ms(torch, plain, sets, iters),
                library_ms=graph_ms(torch, library, sets, iters),
                call_ms=time_ms(torch, kernel, sets, iters),
                library_call_ms=time_ms(torch, library, sets, iters))


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
    set_bytes = 4 * b * h * s * d * es
    sets = []
    for _ in range(n_sets(set_bytes)):
        # the layout BERT gives the kernel: head-split views of the fused
        # QKV projection's (B, S, 3, H, D) output
        qkv = torch.randn(b, s, 3, h, d, device="cuda", generator=gen)
        qkv = qkv.to(dt).permute(2, 0, 3, 1, 4)
        lens = torch.randint(16, s + 1, (b,), device="cuda", generator=gen)
        keep = torch.arange(s, device="cuda")[None, :] < lens[:, None]
        if mask_kind == "key":
            mask = ((~keep).float() * -1e9)[:, None, None, :]
        elif mask_kind == "full":
            mask = torch.randn(b, 1, s, s, device="cuda", generator=gen) * 2
        elif mask_kind == "bool":
            mask = torch.rand(b, 1, s, s, device="cuda", generator=gen) > 0.3
            mask[0, 0, 5, :] = False       # one query row sees no key
        else:
            mask = None
        sets.append((qkv[0], qkv[1], qkv[2], mask))
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

    # 5. the kernels line, the card, and the verdict
    sources = {"layer_norm_fwd": "paddle_tpu_torch/csrc/layer_norm.cu",
               "flash_attention_fwd":
                   "paddle_tpu_torch/csrc/flash_attention.cu"}
    replaces = {"layer_norm_fwd":
                    "paddle_tpu/ops/pallas/layer_norm.py:78",
                "flash_attention_fwd":
                    "paddle_tpu/ops/pallas/flash_attention.py:344"}
    line = []
    for name, rec in (("layer_norm_fwd", ln[0]),
                      ("flash_attention_fwd", fa[0])):
        line.append(dict(name=name, route="cuda", source=sources[name],
                         replaces=replaces[name],
                         launches=rec32["launches"][name],
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
