"""Closed-loop generative-decode load generator: ``GenerateEngine`` under
ragged traffic, continuous refill against run-to-completion waves.

Counterpart of ``scripts/decode_loadgen.py``'s ``make_workload`` and
``run_load``: the same workload from the same seed (prompts of 1 to 16
tokens across the prefill buckets (4, 16); 85% of requests asking for
4-8 new tokens and 15% for 64-80), offered all at once to a warmed
engine over ``demo_model(vocab=64,
dim=256, heads=4, layers=2, seed=1)`` with ``slots=8, page=32,
factor=2.0, max_len=96``. It measures tokens/s from the first submit to
the last completion, ticks, mean lane occupancy, each request's
completion latency (p50, p99), the signatures traffic met after warmup
(0 expected), the port's kernel launches the traffic made, and the
decode window's prefill p50, tick p99 and prefill share
(``metrics.decode_rollup``). With the port's monitor on
(``--monitor DIR``, or ``monitor.enable()`` around ``run_load``) it also
collects each request's ``serving.request`` record: time to first token
and time per output token (p50, p99), and the run's summed prefill and
tick times from the monitor's histograms.

    python -m paddle_tpu_torch.tools.decode_loadgen [--mode both]
        [--sampling temperature=1.0,top_k=20,top_p=0.9] [--device cpu]
        [--profile]
    python -m paddle_tpu_torch.tools.decode_loadgen --spec [--spec-k 8]
        [--draft pair|self] [--device cpu] [--profile]
    ... [--monitor DIR]

prints one JSON line: each mode's measurement, ``speedup_x`` (continuous
tokens/s over drain's, the reference's A/B), and the card's name and
power limit. ``--spec`` makes the A/B speculative against plain decode
on the same sampled traffic (temperature 1 unless ``--sampling`` says
otherwise), continuous refill both, as the reference's
(``scripts/decode_loadgen.py:398-429``): the target is
``demo_spec_pair(vocab=64, dim=192, heads=2, draft_layers=1,
extra_layers=7, seed=1, distill=0.10)``'s, drafted for by its first
layer (``--draft pair``), or ``demo_model(vocab=64, dim=192, heads=2,
layers=2, seed=1)`` drafting for itself (``--draft self``); it adds
``spec_speedup_x`` and ``accept_rate``. It runs on the card unless
``--device cpu``; a CPU run's times are the CPU's, not the card's.
``--profile`` adds :func:`profile_decode`: a decode tick's (with
``--spec``, a speculative and a plain tick's) wall time against its
device time, from ``torch.profiler`` (``chip_smoke.py`` prints it too).
``--monitor DIR`` turns the port's monitor and span tracer on: the JSONL
events and a Chrome trace (``trace-<pid>.json``, the engine's slot lanes
in it) land in ``DIR``.

The engine's steps are CUDA graphs captured at warmup (the ``graph``
arm). ``--arms graph,eager`` measures each run in both arms, in turns
(graph, eager, eager, graph), and reports each arm's median tokens/s;
the ``eager`` arm is :class:`EagerEngine`, the same engine whose step
bodies run launch by launch. With ``--profile`` each arm's tick is
profiled.

    python -m paddle_tpu_torch.tools.decode_loadgen --replicas 1,2,3
        [--sampling ...] [--profile]

runs the traffic instead through a ``MultiDecodeEngine`` over each count
of replicas on the one device (:func:`run_fleet`: every replica its own
copy of the weights, its own engine thread, the same engine settings),
continuous refill: tokens/s, each replica's ticks and the run's wall time
over them, and the port's kernel launches the traffic made; with
``--profile`` the same run again under ``torch.profiler``, the card's
busy time, idle share and profiled events over the whole run.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from paddle_tpu_torch import device as _device
from paddle_tpu_torch import graphs
from paddle_tpu_torch.serving import GenerateEngine

# short answers dominate; the long tail is what run-to-completion
# batching stalls a whole batch on
SHORT_NEW = (4, 8)       # 85% of requests
LONG_NEW = (64, 80)      # 15% of requests
LONG_FRAC = 0.15
PROMPT_BUCKETS = (4, 16)
PAGE, FACTOR = 32, 2.0   # the arena's page schedule, as the reference's
PROFILE_TICKS, PROFILE_TOP = 10, 8
ARMS = ("graph", "eager")
# the speculative A/B's models (scripts/decode_loadgen.py:410-419)
SPEC_PAIR = dict(vocab=64, dim=192, heads=2, draft_layers=1, extra_layers=7,
                 seed=1, distill=0.10)
SPEC_SELF = dict(vocab=64, dim=192, heads=2, layers=2, seed=1)


def _engine_class(arm):
    if arm not in ARMS:
        raise ValueError(f"arm must be one of {ARMS}, got {arm!r}")
    return GenerateEngine if arm == "graph" else EagerEngine


def _reserved(device):
    """The caching allocator's reserved bytes on a CUDA ``device`` (None on
    the CPU)."""
    if torch.device(device).type != "cuda":
        return None
    torch.cuda.synchronize(device)
    return torch.cuda.memory_reserved(device)


def make_workload(n, prompt_buckets, max_len, seed=0):
    """(prompt tokens, max_new_tokens) per request: ragged prompt lengths
    across the bucket family, bimodal output lengths; the reference's
    draws from the same seed."""
    rng = np.random.RandomState(seed)
    reqs = []
    for _ in range(n):
        if rng.rand() < LONG_FRAC:
            new = int(rng.randint(LONG_NEW[0], LONG_NEW[1] + 1))
        else:
            new = int(rng.randint(SHORT_NEW[0], SHORT_NEW[1] + 1))
        hi = min(int(prompt_buckets[-1]), max_len - new)
        plen = int(rng.randint(1, hi + 1))
        prompt = rng.randint(1, 31, size=plen).tolist()
        reqs.append((prompt, new))
    return reqs


def _pct(sorted_vals, q):
    if not sorted_vals:
        return None
    i = min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))
    return sorted_vals[i]


def _decode_sums(snap):
    """The monitor's prefill and tick histograms: (count, summed ms)."""
    return {key: (snap.get(f"serving.decode.{key}", {}).get("count", 0),
                  snap.get(f"serving.decode.{key}", {}).get("sum", 0.0))
            for key in ("prefill_ms", "step_ms")}


def _rnd(v, n=3):
    return round(v, n) if v is not None else None


def run_load(model, mode, workload, slots, max_len, prompt_buckets,
             sampling=None, seed_base=None, draft=None, spec_k=4,
             arm="graph"):
    """Drive one warmed engine in ``mode`` over the workload, offered all
    at once, and return its measurement, with every request's tokens
    under ``"outputs"``. ``arm`` is ``"graph"`` (the engine's steps
    replayed from the CUDA graphs its warmup captured) or ``"eager"``
    (:class:`EagerEngine`); the result carries the graphs captured at
    warmup and after it, the replays, and on the card the reserved bytes
    the engine's construction and warmup added. ``sampling`` (dict or SamplingParams) makes
    every request sampled, request ``i`` with seed ``seed_base + i``.
    ``draft`` drafts ``spec_k`` tokens a verify (speculative decoding);
    the result then carries the accept rate and tokens a verify. With
    the port's monitor on, each request's ``serving.request`` record is
    collected (``"records"``) and summarised (TTFT, TPOT)."""
    from paddle_tpu_torch import monitor
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.serving import metrics
    metrics.reset_windows()
    reserved0 = _reserved(model.device)
    eng = _engine_class(arm)(
        model, slots=slots, page=PAGE, factor=FACTOR, max_len=max_len,
        prompt_buckets=prompt_buckets, queue_depth=len(workload) + 8,
        refill=mode, shed=False, start=True, draft_model=draft,
        spec_k=spec_k)
    try:
        t0 = time.perf_counter()
        eng.warmup()
        if model.device.type == "cuda":
            torch.cuda.synchronize(model.device)
        warmup_s = time.perf_counter() - t0
        reserved1 = _reserved(model.device)
        graph_pool = graphs.pool_bytes(eng._graphs.pool)
        captures = eng.captures
        n_exec, n_trace = eng.executables()
        sums0 = _decode_sums(monitor.snapshot())
        kernels.reset_launches()
        reqs, t_sub, t_done = [], [], [None] * len(workload)
        t0 = time.perf_counter()
        for i, (prompt, new) in enumerate(workload):
            r = eng.make_request(
                prompt, max_new_tokens=new, eos_token=None,
                sampling=sampling,
                seed=(seed_base + i) if seed_base is not None else None)
            t_sub.append(time.perf_counter())
            r.future.add_done_callback(
                lambda _f, i=i: t_done.__setitem__(i, time.perf_counter()))
            eng.submit_request(r)
            reqs.append(r)
        outs = [r.future.result(timeout=600) for r in reqs]
        wall_s = time.perf_counter() - t0
        launches = {k: v for k, v in kernels.launches.items() if v}
        rollup = metrics.decode_rollup()
        stats = eng.stats()
        n_exec2, n_trace2 = eng.executables()
        sums1 = _decode_sums(monitor.snapshot())
    finally:
        eng.close()
    # each request's record (the monitor on: otherwise no request has a
    # trace, and only the throughput numbers come back)
    records = [r.trace.ctx.record() for r in reqs
               if r.trace is not None and r.trace.ctx.record() is not None]
    slo = {}
    if records:
        ttfts = sorted(r["ttft_ms"] for r in records
                       if r.get("ttft_ms") is not None)
        tpots = sorted(r["tpot_ms"] for r in records
                       if r.get("tpot_ms") is not None)
        queues = sorted(r.get("queue_ms", 0.0) for r in records)
        slo = {
            "records": records,
            "ttft_p50_ms": _rnd(_pct(ttfts, 0.50)),
            "ttft_p99_ms": _rnd(_pct(ttfts, 0.99)),
            "tpot_p50_ms": _rnd(_pct(tpots, 0.50)),
            "tpot_p99_ms": _rnd(_pct(tpots, 0.99)),
            "queue_p99_ms": _rnd(_pct(queues, 0.99)),
            # the run's prefills and ticks on the host clock, from the
            # monitor's histograms: (count, summed ms)
            "prefill_ms_total": [sums1["prefill_ms"][i]
                                 - sums0["prefill_ms"][i] for i in (0, 1)],
            "tick_ms_total": [sums1["step_ms"][i] - sums0["step_ms"][i]
                              for i in (0, 1)],
        }
    lat = sorted((d - s) * 1e3 for s, d in zip(t_sub, t_done))
    tokens = int(sum(len(o) for o in outs))
    spec = {}
    if draft is not None:
        spec = {
            "spec_k": spec_k,
            "verify_steps": stats["verify_steps"],
            "accept_rate": (stats["spec_accepted"]
                            / max(stats["spec_proposed"], 1)),
            "spec_tokens_per_step": (stats["tokens"]
                                     / max(stats["verify_steps"], 1)),
            "pool_rollbacks": stats["pool_rollbacks"],
            "spec_proposed": stats["spec_proposed"],
            "spec_accepted": stats["spec_accepted"],
        }
    return {
        **slo,
        **spec,
        "mode": mode,
        "device": str(eng.device),
        "requests": len(workload),
        "tokens": tokens,
        "wall_s": wall_s,
        "tokens_per_s": tokens / wall_s,
        "batch_occupancy": stats["avg_occupancy"],
        "ticks": stats["ticks"],
        "prefills": stats["prefills"],
        "latency_p50_ms": _pct(lat, 0.50),
        "latency_p99_ms": _pct(lat, 0.99),
        "prefill_p50_ms": _rnd(rollup["prefill_p50_ms"]),
        "decode_p99_ms": _rnd(rollup["decode_p99_ms"]),
        "prefill_ratio": _rnd(rollup["prefill_ratio"], 4),
        "decode_rollup": rollup,
        "arm": arm,
        "warmup_s": warmup_s,
        "warmup_captures": captures,
        "post_warmup_captures": stats["captures"] - captures,
        "tick_replays": stats["tick_replays"],
        "prefill_replays": stats["prefill_replays"],
        "draft_prefill_replays": stats["draft_prefill_replays"],
        # the engine's construction and warmup: its arenas (the pools'
        # whole storage, kv_cache.KVCachePool.arena) and, in the graph
        # arm, the graphs' pool and static buffers
        "reserved_bytes": (None if reserved0 is None
                           else reserved1 - reserved0),
        # the segments of the graphs' own pool after warmup (0 in the
        # eager arm, None on the CPU)
        "graph_pool_bytes": graph_pool,
        "arena_bytes": eng.pool.reserved_bytes() + (
            eng.draft_pool.reserved_bytes() if draft is not None else 0),
        "executables": n_exec2,
        "post_warmup_signatures": (n_exec2 - n_exec) + (n_trace2 - n_trace),
        "pool_bytes": stats["pool_cache_bytes"],
        "grows": stats["grows"],
        "failed": stats["failed"],
        "launches": launches,
        "outputs": outs,
    }


def teacher_forced_logits(model, prompt, tokens, chunk=None):
    """The logits ``model`` gives at every generated position when fed
    ``tokens`` (another run's stream) after ``prompt``: row 0 from the
    prefill, row ``i`` from the decode step whose input is ``tokens[i -
    1]``, or with ``chunk``, from the ``verify_fn`` call over ``chunk``
    consecutive inputs that holds it (the last chunk padded); ``[len(
    tokens), V]`` on the host. Comparing two devices' logits this way
    holds every position, where comparing free-running greedy streams
    stops at the first near-tie that rounds apart."""
    dev = model.device
    state = model.state
    p = len(prompt)
    cap = p + len(tokens)
    with torch.no_grad():
        toks = torch.tensor([list(prompt)], dtype=torch.int64, device=dev)
        kv, last = model.prefill_fn(state, toks,
                                    torch.tensor([p], device=dev))
        arena = {name: torch.zeros((1, cap) + tuple(c.shape[2:]),
                                   dtype=c.dtype, device=dev)
                 for name, c in kv.items()}
        for name, c in kv.items():
            arena[name][0, :p] = c[0]
        rows = [last[0]]
        inputs = [int(t) for t in tokens[:-1]]
        step = chunk or 1
        for i in range(0, len(inputs), step):
            part = inputs[i:i + step]
            ln = torch.tensor([p + i], device=dev)
            if chunk is None:
                logits, entry = model.decode_fn(
                    state, torch.tensor(part, device=dev), arena, ln)
                logits, entry = logits[:, None], {
                    name: e[:, None] for name, e in entry.items()}
            else:
                logits, entry = model.verify_fn(state, torch.tensor(
                    [part + [0] * (chunk - len(part))], device=dev), arena,
                    ln)
            for name, e in entry.items():
                arena[name][0, p + i:p + i + len(part)] = e[0, :len(part)]
            rows.extend(logits[0, :len(part)])
        return torch.stack(rows).cpu().numpy()


def profile_decode(model, workload, slots, max_len, prompt_buckets,
                   sampling=None, draft=None, spec_k=4, arm="graph"):
    """Where a decode tick's time goes on the card: ``slots`` requests of
    ``workload`` (each asking for the whole arena) are seated and two
    ticks run to warm; then :data:`PROFILE_TICKS` ticks are timed on the
    host clock (each ends by reading its tokens back) and as many more
    under ``torch.profiler``, after one in its warm-up step. With
    ``draft`` the ticks are speculative
    (``spec_k`` proposals a lane), and fewer where a lane's budget could
    end before the last of them: every lane stays live throughout.
    Returns the wall time a tick, the tokens a tick, the card's busy time
    a tick (its kernels' and copies' device time, profiled), the idle
    share (1 - busy / wall), the profiled wall time a tick, launches a
    tick, the kernels that took the most device time and the count of
    each profiled event's name (``"events"``). ``arm`` as in
    :func:`run_load`: a graphed tick is one replay between the lanes'
    copy in and the tokens' read back; the replays the timed and
    profiled ticks made are counted (``"tick_replays"``)."""
    eng = _engine_class(arm)(
        model, slots=slots, page=PAGE, factor=FACTOR, max_len=max_len,
        prompt_buckets=prompt_buckets, start=False, shed=False,
        draft_model=draft, spec_k=spec_k)
    seated = workload[:slots]
    limit = min(max_len, eng.seq_limit)
    # a tick emits at most spec_k tokens a lane; the prefill emits one
    room = limit - max(len(p) for p, _ in seated) - 1
    ticks = min(PROFILE_TICKS, (room // (spec_k if draft else 1) - 3) // 2)
    try:
        eng.warmup()
        for i, (prompt, _new) in enumerate(seated):
            eng.submit(prompt, max_new_tokens=limit - len(prompt),
                       sampling=sampling, seed=i if sampling else None)
        eng.tick()
        eng.tick()
        torch.cuda.synchronize()
        tokens0 = eng.stats()["tokens"]
        replays0 = eng.stats()["tick_replays"]
        t0 = time.perf_counter()
        for _ in range(ticks):
            eng.tick()
        wall = time.perf_counter() - t0
        tokens = eng.stats()["tokens"] - tokens0
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        # the card's first events after tracing starts can be lost (a
        # tick's first dozen, in some runs): one tick in the profiler's
        # warm-up step goes first, and only the ticks after it count
        sched = torch.profiler.schedule(wait=0, warmup=1, active=ticks,
                                        repeat=1)
        with torch.profiler.profile(activities=acts, schedule=sched) as prof:
            eng.tick()
            prof.step()
            t0 = time.perf_counter()
            for _ in range(ticks):
                eng.tick()
                prof.step()
            torch.cuda.synchronize()
            wall_profiled = time.perf_counter() - t0
        live = eng.pool.used_slots()
        replays = eng.stats()["tick_replays"] - replays0
    finally:
        eng.close(drain=False)
    if live != len(seated):
        raise RuntimeError(f"profile_decode: {len(seated) - live} lanes "
                           f"ended inside the timed ticks")
    names = {}
    for e in prof.events():
        # the steps' own ranges are marked on the card's timeline too
        if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(
                e, "is_user_annotation", False):
            ms, n = names.get(e.name, (0.0, 0))
            names[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    busy = sum(ms for ms, _ in names.values()) / ticks
    tick_ms = wall * 1e3 / ticks
    return {
        "arm": arm,
        "tick_replays": replays,
        "sampled": sampling is not None,
        "spec_k": spec_k if draft is not None else None,
        "ticks": ticks,
        "tick_ms": tick_ms,
        "tokens_per_tick": tokens / ticks,
        "busy_ms_per_tick": busy,
        "idle_share": 1.0 - busy / tick_ms,
        "profiled_tick_ms": wall_profiled * 1e3 / ticks,
        "launches_per_tick": sum(n for _, n in names.values()) / ticks,
        # every profiled event's name with its count over the ticks
        "events": {name: n for name, (_ms, n) in names.items()},
        "top_kernels": [[name[:100], ms / ticks, n // ticks] for name, (ms, n)
                        in sorted(names.items(), key=lambda kv: -kv[1][0])
                        [:PROFILE_TOP]],
    }


def run_fleet(model, workload, replicas, slots, max_len, prompt_buckets,
              sampling=None, seed_base=None, profile=False):
    """The workload offered all at once to a warmed ``MultiDecodeEngine``
    over ``replicas`` copies of ``model`` on its device (continuous
    refill, no supervision, no hedging), request ``i`` seeded
    ``seed_base + i`` where sampled. Returns tokens/s, the wall time,
    the requests each replica took, its prefills and ticks and the wall
    time over them, the signatures met after warmup, the port's kernel
    launches the traffic made (counted from zero after warmup) and every
    request's tokens (``"outputs"``); with ``profile`` the run is under
    ``torch.profiler`` and the card's busy time (kernels and copies),
    idle share and profiled events over the run are added."""
    import contextlib
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.serving import MultiDecodeEngine
    fleet = MultiDecodeEngine(
        model, devices=[model.device] * replicas, slots=slots, page=PAGE,
        factor=FACTOR, max_len=max_len, prompt_buckets=prompt_buckets,
        queue_depth=len(workload) + 8, shed=False, supervise=False)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if model.device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    try:
        fleet.warmup()
        before = [e.executables() for e in fleet.engines]
        ctx = (torch.profiler.profile(activities=acts) if profile
               else contextlib.nullcontext())
        kernels.reset_launches()
        with ctx as prof:
            t0 = time.perf_counter()
            futs = [fleet.submit(p, max_new_tokens=n, sampling=sampling,
                                 seed=(seed_base + i) if seed_base is not
                                 None else None)
                    for i, (p, n) in enumerate(workload)]
            outs = [f.result(timeout=600) for f in futs]
            wall = time.perf_counter() - t0
        launches = {k: v for k, v in kernels.launches.items() if v}
        st = fleet.stats()
        after = [e.executables() for e in fleet.engines]
    finally:
        fleet.close(drain=False, timeout=10.0)
    tokens = int(sum(len(o) for o in outs))
    ticks = [r["ticks"] for r in st["replicas"]]
    out = {"replicas": replicas, "wall_s": wall, "tokens": tokens,
           "tokens_per_s": tokens / wall,
           "routed": [r["submitted"] for r in st["replicas"]],
           "prefills": [r["prefills"] for r in st["replicas"]],
           "ticks": ticks,
           "wall_ms_per_tick": [wall * 1e3 / max(t, 1) for t in ticks],
           "post_warmup_signatures": sum(
               (a[0] - b[0]) + (a[1] - b[1]) for a, b in zip(after, before)),
           "launches": launches,
           "outputs": [np.asarray(o).tolist() for o in outs]}
    if profile:
        dev = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(e.time_range.elapsed_us() for e in dev) / 1e3
        out.update(profiled=True, busy_ms=busy,
                   idle_share=1.0 - busy / (wall * 1e3),
                   device_events=len(dev))
    return out


def nvidia_smi():
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def _parse_sampling(text):
    out = {}
    for kv in text.split(","):
        k, _, v = kv.partition("=")
        out[k.strip()] = int(v) if k.strip() == "top_k" else float(v)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--requests", type=int, default=96)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=96)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mode", choices=["both", "continuous", "drain"],
                    default="both")
    ap.add_argument("--sampling", default=None,
                    help="comma key=value SamplingParams, e.g. "
                         "temperature=1.0,top_k=20,top_p=0.9")
    ap.add_argument("--seed-base", type=int, default=1000,
                    help="request i samples with seed seed-base + i")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the card)")
    ap.add_argument("--profile", action="store_true",
                    help="also time a decode tick on the host clock and "
                         "under torch.profiler (the card only)")
    ap.add_argument("--spec", action="store_true",
                    help="A/B speculative against plain decode instead of "
                         "continuous against drain (sampled traffic)")
    ap.add_argument("--spec-k", type=int, default=8,
                    help="draft tokens proposed a verify step")
    ap.add_argument("--draft", choices=["pair", "self"], default="pair",
                    help="pair: the distilled demo pair; self: the target "
                         "drafts for itself (accept rate 1)")
    ap.add_argument("--monitor", default=None, metavar="DIR",
                    help="turn the port's monitor and span tracer on; the "
                         "events and a Chrome trace land in DIR")
    ap.add_argument("--arms", default="graph",
                    help="comma-separated arms: graph (the steps' CUDA "
                         "graphs), eager; two arms run in turns, A B B A")
    ap.add_argument("--replicas", default=None, metavar="N,N,...",
                    help="run the traffic through a MultiDecodeEngine over "
                         "each count of replicas on the one device")
    args = ap.parse_args(argv)
    args.arms = [a for a in args.arms.split(",") if a]
    if not args.arms or set(args.arms) - set(ARMS):
        ap.error(f"--arms takes graph and eager, got {args.arms!r}")
    if args.replicas and args.arms != ["graph"]:
        ap.error("--replicas runs the graph arm only")
    if args.profile and args.device == "cpu":
        ap.error("--profile reads the card's device time; drop --device cpu")

    from paddle_tpu_torch import monitor
    from paddle_tpu_torch.serving import demo_model, demo_spec_pair
    torch.backends.cuda.matmul.allow_tf32 = False
    sampling = _parse_sampling(args.sampling) if args.sampling else None
    workload = make_workload(args.requests, PROMPT_BUCKETS, args.max_len,
                             seed=args.seed)
    draft = None
    if args.spec:
        sampling = sampling or {"temperature": 1.0}
        if args.draft == "pair":
            model, draft = demo_spec_pair(**SPEC_PAIR, max_len=args.max_len,
                                          device=args.device)
        else:
            model = demo_model(**SPEC_SELF, max_len=args.max_len,
                               device=args.device)
            draft = model
    else:
        model = demo_model(vocab=64, dim=256, heads=4, layers=2,
                           max_len=args.max_len, seed=1, device=args.device)
    result = {"requests": args.requests, "slots": args.slots,
              "sampling": sampling}
    if model.device.type == "cuda":
        result["card"] = nvidia_smi()
    seed_base = args.seed_base if sampling else None
    if args.monitor:
        monitor.enable(args.monitor)
        monitor.trace.enable()
    try:
        _arms(args, result, model, draft, workload, sampling, seed_base)
    finally:
        if args.monitor:
            result["chrome_trace"] = monitor.trace.export_chrome_trace(
                args.monitor)
            monitor.disable()
            monitor.trace.disable()
    print(json.dumps(result))
    return 0


def _arms(args, result, model, draft, workload, sampling, seed_base):
    """The CLI's runs into ``result``: the fleet runs, or the speculative
    or refill A/B and with ``--profile`` the ticks. With two arms each
    run is made in each, in turns (A B B A), and each entry holds one
    record an arm: its first run, with the median tokens/s over its
    runs and every run's (``tokens_per_s_runs``)."""
    if args.replicas:
        fleet = {}
        for n in (int(x) for x in args.replicas.split(",")):
            r = run_fleet(model, workload, n, args.slots, args.max_len,
                          PROMPT_BUCKETS, sampling=sampling,
                          seed_base=seed_base)
            if args.profile:
                p = run_fleet(model, workload, n, args.slots, args.max_len,
                              PROMPT_BUCKETS, sampling=sampling,
                              seed_base=seed_base, profile=True)
                r["profile"] = {k: p[k] for k in (
                    "wall_s", "tokens_per_s", "busy_ms", "idle_share",
                    "device_events")}
            r.pop("outputs")
            fleet[n] = r
        result["fleet"] = fleet
        return
    arms = args.arms
    order = arms + arms[::-1] if len(arms) > 1 else arms

    def turns(**kw):
        runs = {a: [] for a in arms}
        for a in order:
            r = run_load(model, workload=workload, slots=args.slots,
                         max_len=args.max_len, prompt_buckets=PROMPT_BUCKETS,
                         sampling=sampling, seed_base=seed_base, arm=a, **kw)
            r.pop("outputs")
            r.pop("records", None)
            runs[a].append(r)
        out = {}
        for a, rs in runs.items():
            out[a] = dict(rs[0], tokens_per_s=float(np.median(
                [r["tokens_per_s"] for r in rs])),
                tokens_per_s_runs=[r["tokens_per_s"] for r in rs])
        return out if len(arms) > 1 else out[arms[0]]

    def ratio(num, den):
        if len(arms) == 1:
            return num["tokens_per_s"] / den["tokens_per_s"]
        return {a: num[a]["tokens_per_s"] / den[a]["tokens_per_s"]
                for a in arms}

    if args.spec:
        # the same sampled traffic, continuous refill, draft off and on
        for key, d in (("nonspec", None), ("spec", draft)):
            result[key] = turns(mode="continuous", draft=d,
                                spec_k=args.spec_k)
        result["spec_speedup_x"] = ratio(result["spec"], result["nonspec"])
        result["accept_rate"] = (
            result["spec"]["accept_rate"] if len(arms) == 1 else
            {a: result["spec"][a]["accept_rate"] for a in arms})
    else:
        modes = (["continuous", "drain"] if args.mode == "both"
                 else [args.mode])
        for mode in modes:
            result[mode] = turns(mode=mode)
        if len(modes) == 2:
            result["speedup_x"] = ratio(result["continuous"],
                                        result["drain"])
    if args.profile:
        prof = {}
        for a in arms:
            prof[a] = {"plain": profile_decode(
                model, workload, args.slots, args.max_len, PROMPT_BUCKETS,
                sampling=sampling, arm=a)}
            if args.spec:
                prof[a]["spec"] = profile_decode(
                    model, workload, args.slots, args.max_len,
                    PROMPT_BUCKETS, sampling=sampling, draft=draft,
                    spec_k=args.spec_k, arm=a)
        if len(arms) == 1:
            result["profile"] = prof[arms[0]]["plain"]
            if args.spec:
                result["profile_spec"] = prof[arms[0]]["spec"]
        else:
            result["profile"] = prof


class EagerEngine(GenerateEngine):
    """The A/B's eager arm: the engine whose every step runs its body launch
    by launch over the live arenas, as ``bench_bert``'s ``eager_step`` is
    the body its graph arm replays. Its warmup meets the same signatures
    and runs each body once over zero arenas (it builds the kernels and
    meets each cuBLAS shape); it captures nothing."""

    def _run(self, g, gkey, host=None, warm=False):
        body, arenas, idle = self._plan(g.model, gkey)
        if warm:
            arenas = tuple({name: torch.zeros_like(t) for name, t in
                            a.items()} for a in arenas)
        lanes = _device.to_device(idle if host is None else host,
                                  self.device)
        with torch.no_grad():
            out = body(lanes, *arenas)
        return None if warm else out


if __name__ == "__main__":
    sys.exit(main())
