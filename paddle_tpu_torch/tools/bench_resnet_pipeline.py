"""ResNet-50 trained from the input pipeline: the port's counterpart of
``bench.py``'s ``bench_resnet_pipeline``.

    python -m paddle_tpu_torch.tools.bench_resnet_pipeline [--batch 128]
        [--steps 12] [--data-format NCHW|NHWC] [--kernels batch_norm]
        [--size 224] [--arms graph,eager] [--profile] [--out PATH]

The reference's loop: ``resnet50(data_format=...)`` seeded with 0,
``Momentum(0.1, 0.9)``, ``batch * (steps + 2)`` uint8 images (N x 3 x 224
x 224, or N x 224 x 224 x 3 for NHWC) and int32 labels drawn as
``tools/bench_resnet.make_data`` draws them (``RandomState(0)``), in a
``TensorDataset`` behind ``DataLoader(batch_size=batch, shuffle=True,
drop_last=True, use_native=True, prefetch_to_device=2)``: the C++ batcher
shuffles and assembles each batch into a page-locked slot, and a
background thread copies it to the card on a stream of its own. The step
is ``tools/bench_resnet.Trainer``'s (``normalize_u8`` on the card, amp
bf16, the f32 cross entropy, the Momentum step) under ``jit.to_static``:
one CUDA graph replay a batch (the ``graph`` arm; ``eager`` calls the
step unwrapped). The same trainer also steps on the one batch it holds on
the card (``resident``), through the same graph, so that the two feeds
are timed in one process, in turns (pipeline, resident, resident,
pipeline).

The record (one JSON line):

* ``loader_images_per_s``: the loader alone (host batches, no card in
  the loop), its second epoch; ``slots_images_per_s``, the C++ batcher's
  slots alone (no copy out of the slot); ``gather_rows_*_ms``, one
  batch's rows gathered by ``io.native.gather_rows`` on 4 threads and
  on 1;
* for each arm, ``pipeline`` and ``resident``: images/s and ms a step
  (the median of the two turns; the first two batches of the first
  pipeline epoch warm up and capture, and are not timed);
* ``stall_s_per_step``: ``prefetch.stall_seconds`` (the monitor's
  counter, on in memory during the pipeline's turns) over its steps, and
  ``wait_ms_per_step``, the loop's own clock around each ``next()``;
* with ``--profile``: ``idle_share`` of the card over 4 pipeline steps
  (1 - the union of the device's kernel and copy intervals over the
  steps' wall time, from ``torch.profiler``'s trace), and the host-to-
  device copies by stream and by source (``Pinned`` or ``Pageable``),
  with their bytes and ms.

It runs on the CUDA card (``device=None``) and raises where there is
none; ``device="cpu"`` runs the same loop on the CPU.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import tempfile
import time

import numpy as np
import torch

from .. import device as _device
from .. import io, monitor
from ..ops import kernels
from . import bench_resnet

SEED = 0


def make_dataset(batch, steps, data_format="NCHW", size=224,
                 num_classes=1000, rng_seed=0):
    """``(x, y)``: ``batch * (steps + 2)`` uint8 images, N x 3 x size x
    size (N x size x size x 3 for NHWC), and int32 labels, drawn as
    ``bench_resnet.make_data`` draws them."""
    n = batch * (steps + 2)
    rng = np.random.RandomState(rng_seed)
    shape = (n, 3, size, size) if data_format == "NCHW" \
        else (n, size, size, 3)
    x = (rng.rand(*shape) * 255).astype("u1")
    y = rng.randint(0, num_classes, (n,)).astype("i4")
    return x, y


@contextlib.contextmanager
def default_device(device):
    """``device`` as the port's default device for the block: where a
    ``DataLoader(prefetch_to_device=N)`` places its batches."""
    prev = _device.get_device()
    _device.set_device(str(device))
    try:
        yield
    finally:
        _device.set_device(prev)


def make_loader(x, y, batch, device, prefetch=2, seed=SEED, **kw):
    """The bench's loader: shuffled, ``drop_last``, native; batches on
    ``device`` (``prefetch=0``: host batches)."""
    with default_device(device):
        return io.DataLoader(io.TensorDataset(x, y), batch_size=batch,
                             shuffle=True, drop_last=True, use_native=True,
                             prefetch_to_device=prefetch, seed=seed, **kw)


def loader_rate(x, y, batch):
    """Images/s of the loader alone (host batches; a warm epoch first)."""
    loader = make_loader(x, y, batch, "cpu", prefetch=0)
    for _ in loader:
        pass
    t0 = time.perf_counter()
    got = sum(xb.shape[0] for xb, _ in loader)
    return got / (time.perf_counter() - t0)


def host_rates(x, y, batch, repeats=5):
    """The host side alone: images/s of the native batcher's slots with
    no copy out (its worker's shuffle and assembly), and the ms of
    ``gather_rows`` for one batch's images on 4 threads and on 1 (the
    median of ``repeats``)."""
    from ..io import native
    b = native.NativeBatcher([x, y], batch_size=batch, shuffle=True,
                             drop_last=True, seed=SEED)
    rates = []
    for _ in range(2):
        t0 = time.perf_counter()
        got = 0
        for sb in b.slots():
            got += len(sb[0])
            sb.release()
        rates.append(got / (time.perf_counter() - t0))
    idx = np.random.RandomState(1).permutation(len(x))[:batch]
    out = np.empty((batch,) + x.shape[1:], x.dtype)
    ms = {}
    for threads in (4, 1):
        ts = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            native.gather_rows(x, idx, out=out, n_threads=threads)
            ts.append(time.perf_counter() - t0)
        ms[threads] = float(np.median(ts)) * 1e3
    return dict(slots_images_per_s=rates[-1], gather_rows_4_threads_ms=ms[4],
                gather_rows_1_thread_ms=ms[1])


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _step_fn(tr, arm):
    return tr.step if arm == "graph" else tr.eager_step


def pipeline_epoch(tr, loader, arm="graph", skip=0, keep=False):
    """One epoch of ``loader`` through trainer ``tr``'s step (``tr`` built
    with ``inner=1``). Returns a dict: the seconds of the timed steps (all
    but the first ``skip``; ends in a sync), their count, the seconds the
    loop waited in ``next()``, the losses (device scalars) and, with
    ``keep``, the batches as they reached the device."""
    fn = _step_fn(tr, arm)
    it = iter(loader)
    losses, batches = [], []
    wait = 0.0
    t0 = None
    n = 0
    try:
        while True:
            w0 = time.perf_counter()
            try:
                xb, yb = next(it)
            except StopIteration:
                break
            if t0 is not None:
                wait += time.perf_counter() - w0
            losses.append(fn(xb[None], yb[None])[-1])
            if keep:
                batches.append((xb, yb))
            if len(losses) == skip:
                _sync(tr.device)
                t0 = time.perf_counter()
            elif t0 is not None:
                n += 1
        _sync(tr.device)
    finally:
        it.close()
    return dict(seconds=time.perf_counter() - t0 if t0 else None, steps=n,
                wait_s=wait, losses=losses, batches=batches)


def resident_run(tr, steps, arm="graph"):
    """Seconds a step of ``steps`` steps on the batch ``tr`` holds on the
    device (after one untimed step)."""
    fn = _step_fn(tr, arm)
    fn(*tr.data)
    _sync(tr.device)
    t0 = time.perf_counter()
    for _ in range(steps):
        fn(*tr.data)
    _sync(tr.device)
    return (time.perf_counter() - t0) / steps


def _trace_events(prof):
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    return trace.get("traceEvents", trace) if isinstance(trace, dict) \
        else trace


def profile_pipeline(tr, loader, steps=4, arm="graph"):
    """``steps`` pipeline steps under ``torch.profiler`` (after one
    unprofiled step): the wall ms a step, the card's busy ms a step (the
    union of its kernel and copy intervals on every stream), the idle
    share, the compute streams, and every host-to-device copy by stream
    and source kind with its count, bytes and ms."""
    fn = _step_fn(tr, arm)
    it = iter(loader)
    try:
        xb, yb = next(it)
        fn(xb[None], yb[None])
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                xb, yb = next(it)
                fn(xb[None], yb[None])
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        it.close()
    spans, h2d, kernel_streams = [], {}, {}
    for e in _trace_events(prof):
        cat = e.get("cat", "")
        if cat not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        ts, dur = float(e["ts"]), float(e.get("dur", 0))
        spans.append((ts, ts + dur))
        stream = e.get("args", {}).get("stream")
        if cat == "kernel":
            kernel_streams[stream] = kernel_streams.get(stream, 0) + 1
        name = e.get("name", "")
        if cat == "gpu_memcpy" and "HtoD" in name:
            kind = "Pinned" if "Pinned" in name else (
                "Pageable" if "Pageable" in name else name)
            key = f"stream {stream} {kind}"
            rec = h2d.setdefault(key, dict(stream=stream, source=kind,
                                           count=0, bytes=0, ms=0.0,
                                           sizes=[]))
            nbytes = int(e.get("args", {}).get("bytes", 0))
            rec["count"] += 1
            rec["bytes"] += nbytes
            rec["ms"] += dur / 1e3
            if nbytes not in rec["sizes"]:
                rec["sizes"].append(nbytes)
    busy = 0.0
    end = None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    busy_ms = busy / 1e3
    return dict(steps=steps, wall_ms_per_step=wall_ms / steps,
                busy_ms_per_step=busy_ms / steps,
                idle_share=1.0 - busy_ms / wall_ms,
                kernel_streams=kernel_streams, h2d=list(h2d.values()))


def bench_pipeline(batch=128, steps=12, data_format="NCHW", device=None,
                   size=224, arms=("graph",), profile=False, data=None,
                   **model_kw):
    """The bench's record for one route (module docstring); ``data`` is
    ``make_dataset``'s ``(x, y)`` where the caller made it; ``model_kw``
    go to ``bench_resnet.Trainer`` (``model_fn``, ``num_classes``)."""
    dev = _device.resolve(device)
    x, y = data if data is not None else make_dataset(
        batch, steps, data_format, size,
        model_kw.get("num_classes", 1000))
    rec = dict(batch=batch, size=size, steps=steps, data_format=data_format,
               batch_norm_kernels=kernels.enabled("batch_norm"),
               loader_images_per_s=loader_rate(x, y, batch),
               **host_rates(x, y, batch), arms={})
    for arm in arms:
        tr = bench_resnet.Trainer(batch, 1, data_format, dev, size,
                                  **model_kw)
        loader = make_loader(x, y, batch, dev)
        on = monitor.enabled()
        monitor.enable()
        runs = dict(pipeline=[], resident=[])
        stall = waited = 0.0
        n_pipe = 0
        try:
            first = True
            for kind in ("pipeline", "resident", "resident", "pipeline"):
                if kind == "resident":
                    runs[kind].append(resident_run(tr, steps, arm))
                    continue
                stall0 = monitor.registry().value(
                    "prefetch.stall_seconds", 0.0)
                r = pipeline_epoch(tr, loader, arm, skip=2 if first else 1)
                first = False
                runs[kind].append(r["seconds"] / r["steps"])
                stall += monitor.registry().value(
                    "prefetch.stall_seconds", 0.0) - stall0
                waited += r["wait_s"]
                n_pipe += r["steps"] + 1
        finally:
            if not on:
                monitor.disable(flush_counters=False)
        out = {}
        for kind, ts in runs.items():
            dt = float(np.median(ts))
            out[kind] = dict(images_per_s=batch / dt, step_ms=dt * 1e3,
                             step_ms_runs=[t * 1e3 for t in ts])
        out["pipeline_over_resident"] = \
            out["pipeline"]["images_per_s"] / out["resident"]["images_per_s"]
        out["stall_s_per_step"] = stall / n_pipe
        out["wait_ms_per_step"] = waited / n_pipe * 1e3
        if profile and dev.type == "cuda":
            out["profile"] = profile_pipeline(tr, loader, arm=arm)
        rec["arms"][arm] = out
        del tr, loader
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--size", type=int, default=224,
                    help="image height and width")
    ap.add_argument("--data-format", default="NCHW",
                    choices=("NCHW", "NHWC"))
    ap.add_argument("--kernels", default="",
                    help="comma-separated kernels to turn on with "
                         "kernels.configure, e.g. batch_norm (which needs "
                         "--data-format NHWC to reach its kernels)")
    ap.add_argument("--arms", default="graph",
                    help="comma-separated arms: graph (the step's CUDA "
                         "graph), eager")
    ap.add_argument("--profile", action="store_true",
                    help="also profile 4 pipeline steps: the card's idle "
                         "share and the host-to-device copies by stream "
                         "and source")
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
    rec = bench_pipeline(args.batch, args.steps, args.data_format,
                         size=args.size, arms=arms, profile=args.profile)
    rec.update(card=smi)
    print(json.dumps(rec), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)


if __name__ == "__main__":
    main()
