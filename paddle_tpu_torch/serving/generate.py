"""paddle_tpu_torch.serving.generate — continuous-batching autoregressive
decode, and the reference decode model :class:`DemoLM`.

Counterpart of ``paddle_tpu/serving/generate.py``'s ``GenerateEngine``
and ``DemoLM``. A request is a sequence that holds a decode lane for as
many steps as it generates, and sequences join and leave mid-flight:

* a fixed-width batch of ``slots`` lanes advances every live sequence one
  token a tick, in one decode step over the KV arena
  (:class:`~paddle_tpu_torch.serving.kv_cache.KVCachePool`);
* a finished sequence frees its lane at once (host bookkeeping), and a
  queued request takes it at the next tick (``refill="continuous"``), or
  only once every lane is free (``refill="drain"``, the run-to-completion
  baseline the load generator measures against, on the same steps);
* prefill is its own step per prompt bucket: the prompt runs through the
  model with causal flash attention (kernel #3 on the card), its K/V rows
  are written into the lane's arena rows, and its last logits give the
  first token.

Shapes come from closed families, so that warmup meets every one before
traffic: one decode step per arena capacity, one prefill per prompt
bucket, one insert per (bucket, capacity), one grow per step of the page
schedule. The decode step always runs ``slots`` rows, whatever the
occupancy: a row's logits then depend on its own inputs and the arena's
capacity, never on the other rows, and the sampled streams, whose random
draws are keyed by ``(seed, generation index)``
(:mod:`~paddle_tpu_torch.serving.sampling`), come out the same under
either refill discipline and any admission order.

Each step is an executable, as in the reference: one per signature and
batch-wide sampling branch, captured at :meth:`GenerateEngine.warmup`
into a CUDA graph (``paddle_tpu_torch.graphs.GraphEntry``) over a static
lane array, the served weights and the KV arena, whose addresses never
move (``KVCachePool.arena``); on the CPU the same entry re-runs the step
over its static lane array. Lane state (lengths, last tokens, sampling
knobs) lives on the host; a tick copies it in as one pinned array,
replays, and synchronises with the card once, to read the next tokens;
an admission replays its prefill, inserts the K/V and waits once, for
the first token. A step that a graph cannot capture raises
``CaptureError``: nothing falls back to eager steps on the card.

Speculative decoding (``draft_model=``, ``spec_k=``): a cheaper model of
the same vocabulary proposes ``k`` tokens a lane from its own arena (a
second pool on the same slots and page schedule, grown in lockstep), and
the target verifies all of them in one chunked forward (``verify_fn``)
under the accept-prefix rule
(:func:`~paddle_tpu_torch.serving.sampling.accept_prefix`). A lane emits
the accepted proposals and, after a rejection, the residual resample;
after a full accept it emits exactly the ``k`` proposals (no bonus
token, so the two arenas stay in step), and both ledgers roll back to the
kept prefix. Proposal ``i`` is drawn under the key plain sampling uses at
that generation index, so a model drafting for itself reproduces plain
sampling, and greedy speculation reproduces greedy decode for any draft.

A sequence moves between engines with its history: ``disown_inflight(
export_kv=True)`` exports each live lane's KV as a host segment
(:meth:`~paddle_tpu_torch.serving.kv_cache.KVCachePool.export_slot`)
with its tokens so far, and an engine built with ``kv_import=True``
seats such a request (``DecodeRequest.preset``) by importing the segment
instead of running its prefill; its ledger length and generation index
carry over, so the stream continues as if it never moved. Without
``export_kv`` the requests move bare and re-prefill, which regenerates
the same stream from the prompt.

The engine reports through the port's monitor (``serving/metrics.py``,
``serving/reqtrace.py``, ``monitor.trace``) at the reference's sites;
every record reads host numbers only, and with the monitor off each
site is one flag check.

A fleet of engines (:class:`MultiDecodeEngine`, one ``GenerateEngine``
a replica, each with its own copy of the weights, :func:`replicate_decode`)
rides ``serving/multi.py``'s supervision spine: each engine reports to
its replica's breaker (``on_outcome=``), answers the supervisor's
:meth:`~GenerateEngine.heartbeat` and :meth:`~GenerateEngine.probe`, and
carries the fault-injection site (``resilience/faults.py``) at the
reference's four places: a prefill, a segment import, a decode tick and
a speculative tick. A failed-over request moves bare and re-prefills on
its new replica, which regenerates the same stream.

The model contract (duck-typed; :class:`DemoLM` implements it)::

    model.state        # {name: tensor} on the model's device
    model.vocab        # int
    model.device       # torch.device the state lives on
    model.kv_spec()    # {leaf: (tail_shape, dtype)} per cached token
    model.prefill_fn(state, tokens[B, L], lengths[B])
        -> (kv {leaf: [B, L, *tail]}, last_logits[B, V])
    model.decode_fn(state, tokens[S], kv {leaf: [S, cap, *tail]},
                    lengths[S])
        -> (logits[S, V], entry {leaf: [S, *tail]})
    model.verify_fn(state, tokens[S, C], kv, lengths[S])   # the target
        -> (logits[S, C, V], entry {leaf: [S, C, *tail]})  # of a draft
"""
from __future__ import annotations

import collections
import concurrent.futures
import copy
import functools
import itertools
import math
import os
import threading
import time

import numpy as np
import torch

from .. import device as _device
from .. import monitor as _monitor
from ..graphs import GraphEntry, eager_on_side_stream
from ..io.bucketing import next_bucket
from ..ops.kernels.flash_attention import flash_attention
from ..resilience import faults as _faults
from ..resilience.deadline import Deadline
from . import metrics
from . import reqtrace
from . import sampling as sampling_mod
from .admission import AdmissionController, resolve_priority
from .batcher import _outcome
from .kv_cache import KVCachePool, device_memory_limit
from .multi import MultiDeviceEngine, fleet_devices

_seed_counter = itertools.count(1)


def _fresh_seed():
    """Engine-assigned per-request seed (sampled requests that passed
    none): unique per process and submit order, and recorded on the
    request."""
    return (os.getpid() * 2654435761 + next(_seed_counter)) & 0x7FFFFFFF


class DecodeRequest:
    """One sequence in flight: a prompt, a generation budget, and a future
    resolving to the generated token ids (``np.int32``, EOS included when
    hit). The first resolution wins, and only it finalizes the request's
    trace."""

    __slots__ = ("prompt", "max_new_tokens", "eos_token", "future",
                 "deadline", "t_enqueue", "priority", "trace", "sampling",
                 "preset")

    def __init__(self, prompt, max_new_tokens, eos_token=None,
                 deadline=None, priority=1, trace=None, sampling=None):
        self.prompt = prompt                    # 1-D int32 host array
        self.max_new_tokens = int(max_new_tokens)
        self.eos_token = eos_token
        # resolved SamplingParams with a concrete seed
        self.sampling = (sampling if sampling is not None
                         else sampling_mod.SamplingParams(seed=0))
        self.future = concurrent.futures.Future()
        self.deadline = deadline
        self.priority = int(priority)
        self.t_enqueue = time.monotonic()
        # reqtrace.Attempt (None while the monitor is off)
        self.trace = trace
        # a sequence that arrives with its history: {"segment" (the KV
        # pool's transport format), "tokens" emitted so far, "last_token",
        # "prompt_len"}; seated by importing the segment, no prefill
        self.preset = None

    def age(self, now=None):
        return (now if now is not None else time.monotonic()) \
            - self.t_enqueue

    def resolve_result(self, value):
        try:
            self.future.set_result(value)
        except concurrent.futures.InvalidStateError:
            return
        if self.trace is not None:
            self.trace.finalize("ok")

    def resolve_exception(self, exc):
        try:
            self.future.set_exception(exc)
        except concurrent.futures.InvalidStateError:
            return
        if self.trace is not None:
            self.trace.finalize(*_outcome(exc))


class _Slot:
    """Host-side state of one decode-batch lane."""

    __slots__ = ("req", "length", "tokens", "last_token", "t_seat")

    def __init__(self):
        self.req = None          # DecodeRequest occupying the lane
        self.length = 0          # tokens resident in the KV arena
        self.tokens = None       # generated so far (list of int)
        self.last_token = 0      # next decode input
        self.t_seat = 0.0        # perf_counter at seating (its lane's
        #                          occupancy interval starts there)


def _signature(*tensors):
    return tuple((tuple(t.shape), str(t.dtype)) for t in tensors)


def _label(key, k):
    """A signature key as the reference names its executable."""
    kind, *b = key
    if kind in ("prefill", "dprefill"):
        return f"{kind}[L={b[0]}]"
    if kind in ("insert", "dinsert"):
        return f"{kind}[L={b[0]}, cap={b[1]}]"
    if kind in ("grow", "dgrow"):
        return f"{kind}[{b[0]}->{b[1]}]"
    if kind in ("sdraft", "verify"):
        return f"{kind}[cap={b[0]}, k={k}]"
    return f"{kind}[cap={b[0]}]"


# the batch-wide host branches of a sampling step, each its own executable:
# every row greedy (the argmax), sampled with no filter, and sampled with
# top-k or top-p on some row (``sampling.needs_filter``)
BRANCHES = ("greedy", "sampled", "filtered")
# a prefill's lane array: the bucket's tokens, then the length and five knobs
_PROMPT_EXTRA = 6
# the stats counter each executable kind's replays advance
_REPLAYS = {"decode": "tick_replays", "spec": "tick_replays",
            "prefill": "prefill_replays", "dprefill": "draft_prefill_replays"}


def _gkey_label(gkey):
    return f"{gkey[0]}[{', '.join(str(x) for x in gkey[1:])}]"


def _bits(a):
    """float32 values as their bits (int32), to ride in an int64 lane
    array."""
    return np.asarray(a, np.float32).view(np.int32)


def _lanes(tokens, lengths, active, knobs):
    """A tick's lane array, int64 ``[8, slots]``: the tokens, lengths and
    active flags, then the knobs as :func:`_knobs_of` reads them (top-k,
    seed, generation index, and the temperature's and top-p's float32
    bits)."""
    temps, top_ks, top_ps, seeds, positions = knobs
    return np.stack([np.asarray(a, np.int64) for a in (
        tokens, lengths, active, top_ks, seeds, positions, _bits(temps),
        _bits(top_ps))])


def _prompt_lanes(tokens, length, knobs):
    """A prefill's lane array, int64 ``[L + 6]``: the bucket's ``L``
    tokens, the prompt's length, then the request's knobs as in
    :func:`_lanes`."""
    temps, top_ks, top_ps, seeds, positions = knobs
    return np.concatenate([np.asarray(a, np.int64).reshape(-1) for a in (
        tokens, [length], top_ks, seeds, positions, _bits(temps),
        _bits(top_ps))])


def _knobs_of(rows):
    """Device knobs ``(temps, top_ks, top_ps, seeds, positions)`` from the
    five knob rows of a lane array (``[5, n]``)."""
    f = rows[3:5].to(torch.int32).view(torch.float32)
    return f[0], rows[0], f[1], rows[1], rows[2]


def _branch(knobs, vocab):
    """The batch-wide host branch (:data:`BRANCHES`) of host knobs."""
    temps, top_ks, top_ps = knobs[:3]
    if not (np.asarray(temps) > 0.0).any():
        return "greedy"
    return ("filtered" if sampling_mod.needs_filter(top_ks, top_ps, vocab)
            else "sampled")


def _masked_write(bufs, entry, pos, mask):
    """Each lane's cache entry ``entry[leaf] [S, *tail]`` at arena position
    ``pos [S]`` of its own row where ``mask [S]``; elsewhere the row keeps
    what it held (the mask rides on the values, as in the reference's
    ``_masked_write``): a write of fixed shape, one entry a row."""
    rows = torch.arange(pos.shape[0], device=pos.device)
    for name, buf in bufs.items():
        old = buf[rows, pos]
        m = mask.view((-1,) + (1,) * (old.ndim - 1))
        buf[rows, pos] = torch.where(m, entry[name], old)


def _window_write(bufs, entry, lengths, active):
    """A verify's chunk ``entry[leaf] [S, C, *tail]`` at the positions
    ``lengths + i`` that lie inside the arena. Each lane writes a window of
    ``m = min(C, cap)`` consecutive positions of its row, slid back from
    the arena's end where the chunk runs past it (``[w, w + m)``, ``w =
    min(length, cap - m)``): a chunk entry where the window meets the
    chunk, the row's own value before it. The shape never varies, no two
    entries land on one row (the reference clamps the entries past its
    arena onto the last row; CUDA's ``index_put_`` would leave the winner
    undefined), and an entry past the arena lands nowhere."""
    n, c = next(iter(entry.values())).shape[:2]
    cap = next(iter(bufs.values())).shape[1]
    m = min(c, cap)
    dev = lengths.device
    w = lengths.clamp(max=cap - m).clamp(min=0)
    pos = w[:, None] + torch.arange(m, device=dev)[None, :]
    idx = pos - lengths[:, None]            # the chunk entry there: <= c - 1
    keep = active[:, None] & (idx >= 0)
    src = idx.clamp(0, c - 1)
    rows = torch.arange(n, device=dev)[:, None]
    for name, buf in bufs.items():
        old = buf[rows, pos]
        k = keep.view(keep.shape + (1,) * (old.ndim - 2))
        buf[rows, pos] = torch.where(k, entry[name][rows, src], old)


class _Graphs:
    """An engine's executables over one model: a ``GraphEntry`` per key
    ``(kind, capacity or bucket[, branch])``, every one reading this
    model's weights. They share a graph pool (on the card) and a lock."""

    def __init__(self, model, device):
        self.model = model
        self.entries = {}
        self.lock = threading.Lock()
        self.pool = (torch.cuda.graph_pool_handle()
                     if device.type == "cuda" else None)


class GenerateEngine:
    """Continuous-batching decode over one model.

    Parameters
    ----------
    model : the decode-model contract above (see :func:`demo_model`); the
        engine runs on ``model.device``.
    slots : decode batch width, sequences served concurrently.
    page / factor / max_len : the KV arena's capacity schedule
        (``grow_buckets(page, factor, max_len)``); ``max_len``, and the
        model's own ``max_len`` where it has one, cap prompt + generated
        tokens per sequence (``seq_limit``).
    prompt_buckets : prefill length buckets (default: the capacity
        family), within ``seq_limit``; a prompt longer than the largest
        is rejected at submit.
    queue_depth / deadline_ms / shed / slo_goodput_floor : the admission
        ladder's knobs, as in ``ServingEngine``.
    refill : ``"continuous"`` (freed lanes refill at the next tick) or
        ``"drain"`` (no admission until every lane is free).
    sampling : engine-default :class:`~paddle_tpu_torch.serving.sampling.
        SamplingParams` (or dict) for submits that pass none; None is
        greedy.
    draft_model : speculative decoding: a model of the same vocabulary
        whose proposals the target (which must have ``verify_fn``)
        verifies; it rides its own arena on the same slots and page
        schedule, and its weights are used on the engine's device.
    spec_k : draft proposals a lane a speculative tick (>= 1).
    kv_import : this engine receives KV segments (requests carrying a
        ``preset``): :meth:`warmup` also meets an insert for every
        capacity-family pad, so that an imported segment meets no new
        signature.
    start : launch the tick thread now (False: tests call :meth:`tick`).
    replica_id : identity inside a :class:`MultiDecodeEngine` fleet (fault
        targeting, request records, the ``kv{id}`` trace lanes); None for
        a standalone engine.
    on_outcome : breaker feedback, called with ``(ok, exc or None)`` after
        each prefill, import and tick settles.
    """

    def __init__(self, model, slots=8, page=64, factor=2.0, max_len=512,
                 prompt_buckets=None, queue_depth=256, deadline_ms=None,
                 refill="continuous", shed=True, slo_goodput_floor=0.90,
                 start=True, replica_id=None, on_outcome=None,
                 sampling=None, draft_model=None, spec_k=4,
                 kv_import=False):
        if refill not in ("continuous", "drain"):
            raise ValueError(
                f"refill must be 'continuous' or 'drain', got {refill!r}")
        self.model = model
        self.replica_id = replica_id
        self.on_outcome = on_outcome
        self.kv_import = bool(kv_import)
        # the served weights' version, stamped into each request record
        self.weights_version = 0
        self.refill = refill
        self.default_sampling = sampling_mod.resolve(sampling)
        self.device = torch.device(getattr(model, "device", None)
                                   or _device.resolve())
        self.pool = KVCachePool(model.kv_spec(), slots, page=page,
                                factor=factor, max_len=max_len,
                                device=self.device)
        self.slots = self.pool.slots
        self.max_len = self.pool.max_len
        self.spec_k = int(spec_k)
        self.draft_model = draft_model
        self.draft_pool = None
        self._draft_state = None
        if draft_model is not None:
            self._mount_draft(draft_model, page, factor, max_len)
        # the arena's last bucket may pass the model's position table
        # (grow_buckets(32, 2.0, 96) ends at 128): a request or a prefill
        # bucket is bounded by both, and by the draft's, since a position
        # past the table would index out of it
        model_len = min((int(m.max_len) for m in (model, draft_model)
                         if getattr(m, "max_len", None) is not None),
                        default=None)
        self.seq_limit = (self.max_len if model_len is None
                          else min(self.max_len, model_len))
        pb = tuple(sorted({int(b) for b in (
            self.pool.seq_buckets if prompt_buckets is None
            else prompt_buckets)}))
        if not pb or pb[-1] > self.seq_limit:
            raise ValueError(
                f"prompt_buckets {pb} must be non-empty and within "
                f"max_len={self.max_len} and the model's max_len="
                f"{model_len}")
        self.prompt_buckets = pb
        self.admission = AdmissionController(
            max_queue_depth=queue_depth, default_deadline_ms=deadline_ms,
            shed=shed, slo_goodput_floor=slo_goodput_floor)
        self.admission.on_event = self._admission_event
        self._queue = collections.deque()
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._slots = [_Slot() for _ in range(self.slots)]
        # the Chrome export's resource lanes, one a KV slot ("kv.slot3",
        # or "kv1.slot3" inside a fleet)
        self._lane = "kv" if replica_id is None else f"kv{replica_id}"
        # (kind, *buckets) met so far, and each with its operands'
        # shapes and dtypes: a new entry in either after warmup is a
        # signature that traffic met first (a first-call cost on the card)
        self._exec = set()
        self._traces = set()
        # the executables: a GraphEntry a key, over the served model (and
        # those a swap prepared over the next one), built under one lock,
        # captured on one side stream
        self._graphs = _Graphs(model, self.device)
        self._prepared = None
        self._build_lock = threading.Lock()
        self._stream = None
        self._names = [name for name, _t, _d in self.pool._leaf_list]
        self._draft_names = ([name for name, _t, _d in
                              self.draft_pool._leaf_list]
                             if self.draft_pool is not None else [])
        self._stats_lock = threading.Lock()
        self._stats = {"submitted": 0, "completed": 0, "failed": 0,
                       "rejected": 0, "expired": 0, "shed": 0,
                       "ticks": 0, "tokens": 0, "prefills": 0,
                       "prefill_tokens": 0, "compiles": 0, "grows": 0,
                       "draft_steps": 0, "verify_steps": 0,
                       "spec_proposed": 0, "spec_accepted": 0,
                       "kv_imports": 0, "captures": 0, "tick_replays": 0,
                       "prefill_replays": 0, "draft_prefill_replays": 0}
        self._occupancy_sum = 0.0
        self._running = False
        self._closed = False
        self._draining = False
        self._thread = None
        # supervision: when the running tick began (None between ticks),
        # and when the engine last made progress and last succeeded
        self._tick_t0 = None
        self._last_progress = time.monotonic()
        self._last_ok_t = time.monotonic()
        if start:
            self.start()

    def _mount_draft(self, draft, page, factor, max_len):
        """The draft's checks, its arena and its weights on the engine's
        device."""
        if self.spec_k < 1:
            raise ValueError(f"spec_k must be >= 1, got {self.spec_k}")
        if int(draft.vocab) != int(self.model.vocab):
            raise ValueError(
                f"draft vocab {draft.vocab} != target vocab "
                f"{self.model.vocab}: the accept rule compares "
                f"distributions over one vocabulary")
        if not hasattr(self.model, "verify_fn"):
            raise ValueError("speculative decoding needs model.verify_fn "
                             "(chunked decode) on the target model")
        # the same slots and page schedule, so that both arenas grow in
        # lockstep and every speculative step sees one capacity
        self.draft_pool = KVCachePool(draft.kv_spec(), self.slots, page=page,
                                      factor=factor, max_len=max_len,
                                      device=self.device, label="draft")
        limit = device_memory_limit(self.device)
        need = self.pool.max_bytes() + self.draft_pool.max_bytes()
        if limit is not None and need > limit:
            raise ValueError(
                f"the target and draft arenas at max_len={self.max_len} "
                f"take {need} bytes, more than the device's {limit}: fewer "
                f"slots (plan_slots) or a shorter max_len")
        # no copy where the draft's weights are on this device already
        self._draft_state = {name: t.to(self.device)
                             for name, t in draft.state.items()}

    # -- client surface ----------------------------------------------------

    def make_request(self, prompt, max_new_tokens=32, eos_token=None,
                     deadline_ms=None, priority=None, trace=None,
                     sampling=None, seed=None):
        """Validate one submit into a :class:`DecodeRequest` (not yet
        enqueued). ``sampling`` is None (the engine default), a dict of
        knobs, or ``SamplingParams``; ``seed`` overrides its seed. A
        sampled request with no seed gets a fresh one here, recorded on
        the request. ``trace=`` carries a shed request's ``RequestTrace``
        into its retry (one record for both)."""
        arr = np.asarray(prompt, dtype=np.int32).reshape(-1)
        if arr.size < 1:
            raise ValueError("empty prompt")
        if arr.size > self.prompt_buckets[-1]:
            raise ValueError(
                f"prompt of {arr.size} tokens exceeds the largest prefill "
                f"bucket {self.prompt_buckets[-1]} — raise max_len / "
                f"prompt_buckets")
        m = int(max_new_tokens)
        if m < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {m}")
        if arr.size + m > self.seq_limit:
            raise ValueError(
                f"prompt {arr.size} + max_new_tokens {m} exceeds "
                f"{self.seq_limit}: the KV arena's max_len={self.max_len} "
                f"or the model's max_len")
        deadline = (Deadline.after_ms(deadline_ms)
                    if deadline_ms is not None else None)
        prio = resolve_priority(priority)
        if sampling is None and seed is None:
            params = sampling_mod.resolve(self.default_sampling)
        else:
            params = sampling_mod.resolve(sampling, seed=seed)
        if params.seed is None:
            params.seed = 0 if params.greedy else _fresh_seed()
        return DecodeRequest(arr, m, eos_token=eos_token, deadline=deadline,
                             priority=prio, sampling=params,
                             trace=reqtrace.attach(
                                 trace, kind="decode", priority=prio,
                                 replica=self.replica_id,
                                 version=self.weights_version))

    def submit_request(self, req, admit=True):
        """Admit and enqueue; returns the future. Raises ``ShedError`` /
        ``QueueFullError`` from the admission ladder. ``admit=False``
        skips the ladder: a request handed over from another engine was
        admitted there, and must not be charged (or shed) twice."""
        with self._cond:
            if self._closed:
                raise RuntimeError("decode engine is closed")
            if admit:
                self.admission.admit(req, len(self._queue))
            self._queue.append(req)
            depth = len(self._queue)
            self._cond.notify()
        metrics.record_submit(1)
        metrics.record_queue_depth(depth)
        if req.trace is not None:
            req.trace.hop("enqueue", replica=self.replica_id)
            if _monitor.trace.enabled():
                with _monitor.trace.span("serving.enqueue", depth=depth):
                    reqtrace.flow_mark(req.trace)
        with self._stats_lock:
            self._stats["submitted"] += 1
        return req.future

    def submit(self, prompt, max_new_tokens=32, eos_token=None,
               deadline_ms=None, priority=None, trace=None, sampling=None,
               seed=None):
        """Enqueue one sequence; the future resolves to the generated token
        ids (``np.int32``; the first comes from the prefill, an EOS, when
        given and hit, is included and ends the sequence)."""
        return self.submit_request(self.make_request(
            prompt, max_new_tokens=max_new_tokens, eos_token=eos_token,
            deadline_ms=deadline_ms, priority=priority, trace=trace,
            sampling=sampling, seed=seed))

    def run(self, prompt, max_new_tokens=32, eos_token=None,
            deadline_ms=None, timeout=None, priority=None, sampling=None,
            seed=None):
        return self.submit(prompt, max_new_tokens=max_new_tokens,
                           eos_token=eos_token, deadline_ms=deadline_ms,
                           priority=priority, sampling=sampling,
                           seed=seed).result(timeout)

    def depth(self):
        with self._lock:
            return len(self._queue)

    # -- the steps ---------------------------------------------------------
    #
    # Each of the reference's jitted closures is a step body here
    # (``_decode_body``, ``_spec_body``, ``_prefill_body``,
    # ``_draft_prefill_body``): a function of one int64 lane array on the
    # device and of the arenas it writes in place. ``_run`` runs a body
    # through its ``GraphEntry`` (``graphs.py``), one per executable key
    # ``(kind, capacity or bucket, host branch)``: on the card a CUDA graph
    # captured over the entry's static lane array, the served model's
    # weights and the arenas at their fixed addresses
    # (``KVCachePool.arena``); on the CPU a re-run over the static lane
    # array. A step copies its lanes in from pinned memory, replays, and
    # reads back once. What capture demands, and what the bodies do:
    #
    # * fixed shapes: every write covers all lanes, masked on the values
    #   (``_masked_write``, as the reference's), and never puts two entries
    #   on one row (``_window_write``: CUDA's ``index_put_`` leaves the
    #   winner of two undefined);
    # * no host work inside: tokens, lengths, the knobs, seeds and
    #   generation indices ride in the lane array (the float knobs as
    #   their float32 bits), keys and the draft's noise are derived on the
    #   card, and the two batch-wide branches (all greedy; top-k or top-p
    #   on some row) are part of the key (``_branch``), read from the
    #   host's knobs;
    # * weights: an entry belongs to the model it captured (``_Graphs``);
    #   a rebinding captures over the new model first (``prepare``).
    #
    # The inserts and grows stay plain copies (one ``_foreach_copy_`` an
    # insert; a grow, at most once a capacity in an engine's life, three
    # copies a leaf): a graph of its own would add a replay to each
    # admission, and folding the insert into the prefill's graph would
    # multiply the prefill's executables by the capacities.

    def _note(self, key, *tensors):
        """Record a step's signature; a first meeting counts as a
        compile, as the reference counts its executables."""
        if key not in self._exec:
            self._exec.add(key)
            metrics.record_decode_compile(1, what=_label(key, self.spec_k))
            with self._stats_lock:
                self._stats["compiles"] += 1
        self._traces.add((key, _signature(*tensors)))

    def executables(self):
        """(signatures met, signatures with their operand shapes and
        dtypes met): both stay flat after :meth:`warmup` under any
        join/leave churn."""
        return len(self._exec), len(self._traces)

    @property
    def captures(self):
        """The graphs (on the CPU, the re-run entries) built so far, each
        executable key once a model, a swap's captures included: flat
        after :meth:`warmup` under any traffic."""
        with self._stats_lock:
            return self._stats["captures"]

    def _bound(self):
        """The executables of the served model: after a rebinding of
        ``model``, those :meth:`prepare` captured over it, else none yet
        (each key then captures at its first step, under traffic)."""
        model = self.model
        g = self._graphs
        if g.model is not model:
            with self._build_lock:
                g = self._graphs
                if g.model is not model:
                    p, self._prepared = self._prepared, None
                    g = (p if p is not None and p.model is model
                         else _Graphs(model, self.device))
                    self._graphs = g
        return g

    def _plan(self, model, gkey):
        """Executable ``gkey`` over ``model``: its body, the live arenas
        it writes, and lanes that leave them as they are (every lane
        inactive, the knobs taking the key's branch)."""
        kind, size = gkey[:2]
        branch = gkey[2] if len(gkey) > 2 else "greedy"
        n = self.slots
        if kind in ("decode", "spec"):
            idle = _lanes(np.zeros((n,), np.int32), np.ones((n,), np.int32),
                          np.zeros((n,), bool), self._knobs(n, branch))
            if kind == "decode":
                return (functools.partial(self._decode_body, model, branch),
                        (self.pool.arena(size),), idle)
            return (functools.partial(self._spec_body, model, branch),
                    (self.pool.arena(size), self.draft_pool.arena(size)),
                    idle)
        idle = _prompt_lanes(np.zeros((1, size), np.int32), 1,
                             self._knobs(1, branch))
        if kind == "prefill":
            return (functools.partial(self._prefill_body, model, branch), (),
                    idle)
        return self._draft_prefill_body, (), idle

    def _run(self, g, gkey, host=None, warm=False):
        """Executable ``gkey`` of ``g`` over the lane array ``host``:
        returns its static outputs (read them, or queue their copies,
        before the next step). A key met for the first time is captured;
        on the card its body first runs eagerly on a side stream, over the
        live arenas (that run is this call's result), or with ``warm`` (a
        warmup's or a swap's, which must not touch the live arenas and
        return nothing) over zero arenas of their shapes, from idle lanes
        where ``host`` is None. No key falls back to an eager step: one
        that cannot be captured raises ``CaptureError``."""
        entry = g.entries.get(gkey)
        if entry is None:
            with self._build_lock:
                entry = g.entries.get(gkey)
                if entry is None:
                    first, entry = self._capture(g, gkey, host, warm)
                    if first is not None:
                        return first
        if warm:
            return None
        out = entry.replay([_device.host_tensor(host, self.device)],
                           clone=False)
        with self._stats_lock:
            self._stats[_REPLAYS[gkey[0]]] += 1
        return out

    def _capture(self, g, gkey, host, warm):
        """A new entry of ``g`` for ``gkey`` (under the build lock); on the
        card the body's eager run, then its capture in ``g``'s pool, on
        the engine's side stream, thread-locally (another replica on the
        card keeps stepping meanwhile); on the CPU, where ``warm``, the
        body's run over zero arenas alone. Returns (the eager run's
        outputs, or None where ``warm`` or on the CPU, the entry)."""
        body, arenas, idle = self._plan(g.model, gkey)
        lanes = _device.to_device(idle if host is None else host,
                                  self.device)

        def run(x):
            with torch.no_grad():
                return body(x, *arenas)

        entry = GraphEntry(run, [lanes], self.device, lock=g.lock,
                           label=f"GenerateEngine {_gkey_label(gkey)}")
        work = tuple({name: torch.zeros_like(t) for name, t in a.items()}
                     for a in arenas) if warm else arenas

        def eager(x):
            with torch.no_grad():
                return body(x, *work)

        first = None
        if not entry.card and warm:
            # the card's warm run on the CPU too: the first step under
            # traffic finds the step's operators warmed up, as on the card
            eager(lanes)
        elif entry.card:
            if self._stream is None:
                self._stream = torch.cuda.Stream(self.device)
            first = eager_on_side_stream(eager, [lanes], self._stream)
            with torch.no_grad():
                entry.inputs[0].copy_(lanes)
            entry.capture(pool=g.pool, stream=self._stream,
                          mode="thread_local")
        g.entries[gkey] = entry
        with self._stats_lock:
            self._stats["captures"] += 1
        return (None if warm else first), entry

    def _sample(self, logits, knobs, branch):
        """Next tokens from ``logits [n, V]`` under device knobs ``(temps,
        top_ks, top_ps, seeds, positions)``, on the host's ``branch``. An
        all-greedy batch is its argmax: what the filter and the Gumbel
        draw give a greedy row, whatever the noise."""
        if branch == "greedy":
            return torch.argmax(logits, dim=-1)
        temps, top_ks, top_ps, seeds, positions = knobs
        filt = sampling_mod.filter_logits(logits, temps, top_ks, top_ps,
                                          any_filter=branch == "filtered")
        return sampling_mod.sample_from_filtered(filt, seeds, positions)

    def _decode_body(self, model, branch, lanes, bufs):
        """The decode step: one token for every lane of arena ``bufs``,
        each active lane's entry written in place at its ``length``."""
        cap = next(iter(bufs.values())).shape[1]
        tok, ln, active = lanes[0], lanes[1], lanes[2] != 0
        logits, entry = model.decode_fn(model.state, tok, bufs, ln)
        nxt = self._sample(logits, _knobs_of(lanes[3:]), branch)
        _masked_write(bufs, entry, ln.clamp(max=cap - 1), active)
        return [nxt]

    def _prefill_body(self, model, branch, lanes):
        """The prompt's forward at one bucket: its K/V chunk, leaf by leaf,
        and the first token sampled from its last logits."""
        lb = lanes.shape[0] - _PROMPT_EXTRA
        kv, last = model.prefill_fn(model.state, lanes[:lb][None],
                                    lanes[lb:lb + 1])
        first = self._sample(last, _knobs_of(lanes[lb + 1:, None]), branch)
        return [kv[name] for name in self._names] + [first]

    def _draft_prefill_body(self, lanes):
        """The draft's prompt forward at one bucket: its K/V chunk only (the
        first token is the target prefill's)."""
        lb = lanes.shape[0] - _PROMPT_EXTRA
        kv, _ = self.draft_model.prefill_fn(self._draft_state,
                                            lanes[:lb][None],
                                            lanes[lb:lb + 1])
        return [kv[name] for name in self._draft_names]

    def _spec_body(self, model, branch, lanes, bufs, dbufs):
        """The draft-then-verify step: ``k`` draft steps over the draft
        arena ``dbufs``, the target's verify of ``[last, d_1 .. d_k]`` over
        ``bufs`` and the accept-prefix rule; ``[S, k + 2]``: the accepted
        count, the resample and the proposals. Each step writes its cache
        entries in place at the active lanes' positions inside the arena;
        a lane within ``k`` of its budget computes the rest of its chunk
        too, and those entries land nowhere."""
        k, n = self.spec_k, self.slots
        v = int(model.vocab)
        cap = next(iter(bufs.values())).shape[1]
        tok, ln, active = lanes[0], lanes[1], lanes[2] != 0
        temps, top_ks, top_ps, seeds, positions = _knobs_of(lanes[3:])
        filtered = branch == "filtered"
        # every proposal's Gumbel noise at once: proposal i is keyed by
        # (seed, position + i, SALT_TOKEN) alone, as the plain draw at that
        # generation index is
        noise = (sampling_mod.gumbel_ahead(seeds, positions, k, v)
                 if branch != "greedy" else None)
        d, proposals, qs = tok, [], []
        for i in range(k):
            at = ln + i
            logits, entry = self.draft_model.decode_fn(self._draft_state, d,
                                                       dbufs, at)
            filt = sampling_mod.filter_logits(logits, temps, top_ks, top_ps,
                                              any_filter=filtered)
            scored = filt if noise is None else filt + noise[:, i]
            d = torch.argmax(scored, dim=-1)
            proposals.append(d)
            qs.append(sampling_mod.probs_from_filtered(filt))
            _masked_write(dbufs, entry, at.clamp(max=cap - 1),
                          active & (at < cap))
        proposals = torch.stack(proposals, dim=1)
        qs = torch.stack(qs, dim=1)
        chunk = torch.cat([tok[:, None], proposals], dim=1)
        logits, entry = model.verify_fn(model.state, chunk, bufs, ln)
        _window_write(bufs, entry, ln, active)

        def each(a):            # a lane's knob at each of its k + 1 rows
            return a[:, None].expand(n, k + 1).reshape(-1)

        # the k+1 target distributions, each filtered with its lane's knobs
        p = sampling_mod.probs_from_filtered(sampling_mod.filter_logits(
            logits.reshape(n * (k + 1), v), each(temps), each(top_ks),
            each(top_ps), any_filter=filtered)).view(n, k + 1, v)
        a, resampled = sampling_mod.accept_prefix(p, qs, proposals, seeds,
                                                  positions)
        return [torch.cat([a[:, None], resampled[:, None], proposals],
                          dim=1)]

    def _decode_step(self, tokens, lengths, active, knobs):
        """One token for every lane of the arena; returns the next tokens
        on the host: the tick's one wait."""
        g = self._bound()
        cap = self.pool.capacity
        host = _lanes(tokens, lengths, active, knobs)
        self._note(("decode", cap), host, *self.pool.buffers.values())
        nxt, = self._run(g, ("decode", cap, _branch(knobs, g.model.vocab)),
                         host)
        return nxt.cpu().numpy()

    def _spec_step(self, tokens, lengths, active, knobs):
        """One draft-then-verify step for every lane; returns
        ``(n_accepted, resampled, proposals)`` on the host, read back in
        the tick's one wait."""
        g = self._bound()
        cap = self.pool.capacity
        host = _lanes(tokens, lengths, active, knobs)
        self._note(("sdraft", cap), host, *self.draft_pool.buffers.values())
        self._note(("verify", cap), host, *self.pool.buffers.values())
        out, = self._run(g, ("spec", cap, _branch(knobs, g.model.vocab)),
                         host)
        out = out.cpu().numpy()
        return out[:, 0], out[:, 1], out[:, 2:]

    def _prefill(self, tokens, length, knobs):
        """Prompt ingest at one bucket: ``(kv, first)``, the K/V chunk
        ``{leaf: [1, L, *tail]}`` on the device (the step's outputs:
        insert it before the next step) and the first token, its copy to
        the host queued behind the step (read it after :meth:`_wait`)."""
        g = self._bound()
        host = _prompt_lanes(tokens, length, knobs)
        self._note(("prefill", tokens.shape[1]), host)
        out = self._run(g, ("prefill", tokens.shape[1],
                            _branch(knobs, g.model.vocab)), host)
        return (dict(zip(self._names, out[:-1])),
                out[-1].to("cpu", non_blocking=True))

    def _draft_prefill(self, tokens, length):
        """The draft's prompt ingest at one bucket: its K/V chunk on the
        device, as :meth:`_prefill`'s."""
        g = self._bound()
        host = _prompt_lanes(tokens, length, self._knobs(1))
        self._note(("dprefill", tokens.shape[1]), host)
        return dict(zip(self._draft_names,
                        self._run(g, ("dprefill", tokens.shape[1]), host)))

    def _wait(self):
        """Wait for the work queued so far (the copies to the host
        included)."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def _insert(self, bufs, chunk, slot, kind="insert"):
        """Write a prefill's ``chunk {leaf: [1, L, *tail]}`` into arena
        rows ``[slot, :L]``, in place (``kind`` "dinsert": the draft's):
        one multi-tensor copy."""
        lb = next(iter(chunk.values())).shape[1]
        cap = next(iter(bufs.values())).shape[1]
        self._note((kind, lb, cap), *chunk.values(), *bufs.values())
        names = list(bufs)
        torch._foreach_copy_([bufs[name][slot, :lb] for name in names],
                             [chunk[name][0] for name in names])

    def _grow(self, pool, kind, bufs, old, new):
        """``pool``'s arena at capacity ``new`` (``kind`` "grow", or "dgrow"
        for the draft's): the arenas of both capacities are views of one
        storage (``KVCachePool.arena``), so the old rows are copied out,
        the new arena's positions past ``old`` zeroed, and the rows copied
        in at their new places."""
        self._note((kind, old, new), *bufs.values())
        out = pool.arena(new)
        for name, buf in bufs.items():
            rows = buf.clone()
            out[name][:, old:].zero_()
            out[name][:, :old].copy_(rows)
        return out

    @staticmethod
    def _knobs(n, branch="greedy"):
        """Host sampling knobs of width ``n`` that take ``branch``
        (:data:`BRANCHES`): greedy, sampled with no filter, or sampled
        with both filters on."""
        sampled, filt = branch != "greedy", branch == "filtered"
        temps = np.full((n,), 1.0 if sampled else 0.0, np.float32)
        top_ks = np.full((n,), 1 if filt else 0, np.int32)
        top_ps = np.full((n,), 0.5 if filt else 1.0, np.float32)
        return (temps, top_ks, top_ps, np.zeros((n,), np.uint32),
                np.zeros((n,), np.int32))

    def warmup(self, *_signatures):
        """Meet every signature the engine can need once, and capture
        every executable: a decode step a capacity and host branch (greedy,
        sampled, filtered), an insert per (prompt bucket, capacity) that
        can co-occur (with ``kv_import``, also per (capacity-family pad,
        capacity): a moved lane's segment is padded to a capacity
        bucket), a grow per consecutive capacity pair, and a prefill a
        prompt bucket and host branch; with a draft, also the speculative
        family: a draft-then-verify step a capacity and branch (one graph
        for the reference's draft scan and verify), and the draft's
        insert, grow and prefill on the same buckets. On the card each
        executable's body runs once on zero arenas (it builds the flash
        kernel and meets each cuBLAS shape) and is captured over the live
        arenas, whose addresses no grow moves; after this no step of any
        traffic captures. Positional signatures (the fleet's) are accepted
        and ignored: the engine's shapes come from its bucket families.
        Returns the number of signatures met for the first time."""
        before = len(self._exec)
        g = self._bound()
        family = self.pool.seq_buckets
        speculative = self.draft_model is not None
        insert_pads = set(self.prompt_buckets)
        if self.kv_import:
            insert_pads |= set(family)
        tick = self._plan(g.model, ("decode", family[0]))[2]
        with _monitor.trace.span("serving.warmup", buckets=len(family)):
            for cap in family:
                bufs = self.pool.arena(cap)
                self._note(("decode", cap), tick, *bufs.values())
                if speculative:
                    dbufs = self.draft_pool.arena(cap)
                    self._note(("sdraft", cap), tick, *dbufs.values())
                    self._note(("verify", cap), tick, *bufs.values())
                for branch in BRANCHES:
                    self._run(g, ("spec" if speculative else "decode", cap,
                                  branch), warm=True)
                for lb in sorted(insert_pads):
                    if lb <= cap:
                        self._note(("insert", lb, cap), *self.pool.zeros(
                            lb, rows=1).values(), *bufs.values())
                if speculative:
                    for lb in self.prompt_buckets:
                        if lb <= cap:
                            self._note(("dinsert", lb, cap),
                                       *self.draft_pool.zeros(
                                           lb, rows=1).values(),
                                       *dbufs.values())
            for old, new in zip(family, family[1:]):
                self._note(("grow", old, new),
                           *self.pool.arena(old).values())
                if speculative:
                    self._note(("dgrow", old, new),
                               *self.draft_pool.arena(old).values())
            for lb in self.prompt_buckets:
                prompt = self._plan(g.model, ("prefill", lb))[2]
                self._note(("prefill", lb), prompt)
                for branch in BRANCHES:
                    self._run(g, ("prefill", lb, branch), warm=True)
                if speculative:
                    self._note(("dprefill", lb), prompt)
                    self._run(g, ("dprefill", lb), warm=True)
            self._wait()
        return len(self._exec) - before

    def prepare(self, model):
        """Capture every executable this engine holds over ``model`` before
        ``model`` is bound (a fleet's weight swap,
        ``MultiDecodeEngine._serve_module``), so that no step after the
        rebinding captures; the steps take them up when they find the
        model rebound. The live arenas are captured and never written:
        each body's eager run goes to zero arenas. Returns the number
        captured."""
        with self._build_lock:
            keys = list(self._graphs.entries)
        prepared = _Graphs(model, self.device)
        for gkey in keys:
            self._run(prepared, gkey, warm=True)
        self._prepared = prepared
        self._wait()
        return len(prepared.entries)

    # -- lifecycle ---------------------------------------------------------

    def start(self):
        with self._lock:
            if self._running or self._closed:
                return
            self._running = True
            self._draining = False
            self._thread = threading.Thread(
                target=self._worker, name="paddle_tpu_torch-decode",
                daemon=True)
            self._thread.start()

    def close(self, drain=True, timeout=None):
        """Stop the tick thread. ``drain=True`` keeps ticking until the
        queue and every lane are empty (bounded join); anything left
        after the join fails with RuntimeError, so no future is lost."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._running = False
            self._draining = bool(drain)
            self._cond.notify_all()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            if timeout is None:
                timeout = 10.0 if drain else 5.0
            t.join(timeout)
        leftovers = []
        with self._cond:
            leftovers.extend(self._queue)
            self._queue.clear()
            for s, slot in enumerate(self._slots):
                if slot.req is not None:
                    leftovers.append(slot.req)
                    slot.req = None
                    self._release(s)
        for r in leftovers:
            r.resolve_exception(RuntimeError("decode engine closed"))

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.close()

    # -- supervision surface (the fleet's) ---------------------------------

    def heartbeat(self, now=None):
        now = time.monotonic() if now is None else now
        with self._lock:
            t0 = self._tick_t0
            depth = len(self._queue)
            seated = sum(1 for s in self._slots if s.req is not None)
        return {
            "queue_depth": depth,
            "inflight_age_s": None if t0 is None else now - t0,
            "inflight_token": t0,
            "last_progress_age_s": now - self._last_progress,
            "last_ok_age_s": now - self._last_ok_t,
            # seated (still generating) sequences: what a drain waits to
            # reach zero
            "active": seated,
        }

    def probe(self, timeout_s=1.0):
        """Half-open test traffic: one decode step (on a speculative
        engine, one draft-then-verify step) over an all-inactive batch, on
        a side thread (the tick thread may be the thing that is wedged),
        and whether it finished in time; None before warmup or traffic met
        the step. The step's body runs eagerly over zero arenas of its own,
        greedy: neither the engine's arena, which a wedged tick may still
        hold, nor its graphs, which the tick thread replays, are touched."""
        cap = self.pool.capacity
        kind = ("decode" if ("decode", cap) in self._exec
                else "verify" if ("verify", cap) in self._exec else None)
        if kind is None:
            return None
        done = threading.Event()
        err = []

        def _go():
            try:
                body, arenas, idle = self._plan(
                    self.model, ("decode" if kind == "decode" else "spec",
                                 cap, "greedy"))
                own = [{name: torch.zeros_like(t) for name, t in a.items()}
                       for a in arenas]
                with torch.no_grad():
                    body(_device.to_device(idle, self.device),
                         *own)[0].cpu()
            except BaseException as e:   # noqa: BLE001 - the verdict
                err.append(e)
            finally:
                done.set()

        threading.Thread(target=_go, daemon=True,
                         name="paddle_tpu_torch-decode-probe").start()
        ok = done.wait(timeout_s) and not err
        if ok:
            self._last_ok_t = time.monotonic()
        return bool(ok)

    def _note_outcome(self, ok, exc=None):
        if ok:
            self._last_ok_t = time.monotonic()
        cb = self.on_outcome
        if cb is not None:
            try:
                cb(ok, exc)
            except Exception:   # noqa: BLE001 - an observer must not kill
                pass            # the tick thread

    # -- hand-off between engines ------------------------------------------

    def steal_pending(self):
        """Hand every queued request to the caller."""
        with self._cond:
            taken = list(self._queue)
            self._queue.clear()
        metrics.record_queue_depth(0)
        return taken

    def disown_inflight(self, export_kv=False):
        """Evict every live sequence and hand its request over; each lane
        is freed and its draft ledger zeroed. Decode is a function of the
        request alone (greedy argmax, or draws keyed by the request's
        ``(seed, generation index)``), so an engine that re-prefills a
        bare request regenerates the same stream.

        ``export_kv=True`` carries each sequence's history instead: the
        lane's KV is exported (:meth:`KVCachePool.export_slot`), padded to
        its capacity bucket (a warmed insert signature of an engine built
        with ``kv_import=True``), into ``req.preset`` with the tokens so
        far, the last token and the prompt's length; the adopting engine
        continues at the same ledger length and generation index instead
        of running the prefill again. Only the target's arena travels: an
        adopting engine with a draft starts the lane's draft ledger at 0,
        as the reference's does (ROADMAP.md Queue C)."""
        taken, evicted = [], []
        with self._lock:
            for s, slot in enumerate(self._slots):
                if slot.req is None:
                    continue
                if export_kv and slot.length > 0:
                    seg = self.pool.export_slot(
                        s, pad_to=self.pool.capacity_for(slot.length))
                    slot.req.preset = {
                        "segment": seg,
                        "tokens": list(slot.tokens),
                        "last_token": slot.last_token,
                        "prompt_len": int(slot.req.prompt.size),
                    }
                taken.append(slot.req)
                evicted.append((s, slot.t_seat))
                slot.req = None
                slot.tokens = None
                self._release(s)
        trc = _monitor.trace
        if trc.enabled() and evicted:
            now_pc = time.perf_counter()
            for s, t_seat in evicted:
                trc.lane_complete(f"{self._lane}.slot{s}", "req evicted",
                                  t_seat, now_pc)
        return taken

    def requeue(self, requests):
        """Put requests at the front of the queue with no re-admission
        (they were admitted where they came from); on a closed engine each
        future fails instead."""
        if not requests:
            return
        for r in requests:
            tr = getattr(r, "trace", None)
            if tr is not None:
                # back to queue wait, on this engine
                tr.to("queue")
                tr.hop("requeue", replica=self.replica_id)
        with self._cond:
            if self._closed:
                for r in requests:
                    r.resolve_exception(
                        RuntimeError("decode engine closed"))
                return
            for r in reversed(requests):
                self._queue.appendleft(r)
            depth = len(self._queue)
            self._cond.notify()
        metrics.record_queue_depth(depth)

    def _admission_event(self, event):
        key = {"rejected": "rejected", "expired": "expired",
               "poisoned": "failed", "shed": "shed"}.get(event)
        if key is not None:
            with self._stats_lock:
                self._stats[key] += 1

    def stats(self):
        with self._stats_lock:
            s = dict(self._stats)
            occ_sum = self._occupancy_sum
        s["queue_depth"] = self.depth()
        s["active_slots"] = self.pool.used_slots()
        s["slots"] = self.slots
        s["avg_occupancy"] = (occ_sum / s["ticks"]) if s["ticks"] else 0.0
        s["executables"], s["traces"] = self.executables()
        s.update({f"pool_{k}": v for k, v in self.pool.stats().items()
                  if isinstance(v, (int, float))})
        return s

    # -- the tick loop -----------------------------------------------------

    def _worker(self):
        while True:
            if self.tick():
                continue
            with self._cond:
                if not self._running:
                    if self._draining and (
                            self._queue or self.pool.used_slots()):
                        continue    # drain: keep ticking until empty
                    return
                if not self._queue and self.pool.used_slots() == 0:
                    self._cond.wait(0.05)

    def tick(self):
        """One engine step: admit into free lanes (per the refill
        discipline), then advance every live sequence one token. Returns
        whether any work happened."""
        t0 = time.monotonic()
        with self._lock:
            self._tick_t0 = t0
        try:
            admitted = self._admit()
            stepped = (self._spec_once() if self.draft_model is not None
                       else self._decode_once())
        finally:
            with self._lock:
                self._tick_t0 = None
                self._last_progress = time.monotonic()
        return bool(admitted or stepped)

    # -- admission into lanes ----------------------------------------------

    def _pop_next_locked(self, now):
        """Highest-priority (then FIFO) unexpired request; expired ones
        met on the way are returned for resolution outside the lock."""
        expired = []
        while self._queue:
            best_i, best_p = 0, self._queue[0].priority
            for i, r in enumerate(self._queue):
                if r.priority < best_p:
                    best_i, best_p = i, r.priority
            r = self._queue[best_i]
            del self._queue[best_i]
            if self.admission.is_expired(r, now):
                expired.append(r)
                continue
            return r, expired
        return None, expired

    def _admit(self):
        if self.refill == "drain" and self.pool.used_slots() != 0:
            return 0            # run to completion: wait out the wave
        admitted = 0
        while self.pool.free_slots() > 0:
            now = time.monotonic()
            with self._cond:
                req, expired = self._pop_next_locked(now)
                depth = len(self._queue)
            for r in expired:
                self.admission.expire(r)
            metrics.record_queue_depth(depth)
            if req is None:
                break
            try:
                self._prefill_into_slot(req)
                admitted += 1
            except BaseException as e:   # noqa: BLE001 - to the future
                self._note_outcome(False, e)
                with self._stats_lock:
                    self._stats["failed"] += 1
                req.resolve_exception(e)
        return admitted

    def _ensure_capacity(self, needed_len):
        target = self.pool.capacity_for(needed_len)
        while self.pool.capacity < target:
            old = self.pool.capacity
            new = next_bucket(old + 1, self.pool.seq_buckets)
            self.pool.grow_to(new, functools.partial(self._grow, self.pool,
                                                     "grow"))
            if self.draft_pool is not None:
                # in lockstep: every speculative step sees one capacity
                self.draft_pool.grow_to(new, functools.partial(
                    self._grow, self.draft_pool, "dgrow"))
            with self._stats_lock:
                self._stats["grows"] += 1
            # the growth marker on the arena's lane, beside the slots'
            # occupancy intervals
            _monitor.trace.lane_instant(f"{self._lane}.pool",
                                        f"grow {old}->{new}",
                                        old_cap=old, new_cap=new)

    def _release(self, s):
        """Free lane ``s`` in the target pool and zero its draft ledger
        (the draft pool's slots follow the target's)."""
        self.pool.free(s)
        if self.draft_pool is not None:
            self.draft_pool.note_length(s, 0)

    def _prefill_into_slot(self, req):
        """Prompt ingest: the bucketed prefill, its K/V written into a
        free lane's arena rows, the sequence seated. The first generated
        token comes from the prefill. A request carrying a ``preset`` is
        seated by importing its segment instead (:meth:`_seat_preset`):
        no prefill runs."""
        if req.preset is not None:
            return self._seat_preset(req)
        p = int(req.prompt.size)
        bucket = next_bucket(p, self.prompt_buckets)
        tr = req.trace
        if tr is not None:
            tr.to("prefill")
        # the arena must hold the prompt, the first decode write (position
        # p) and the whole insert bucket
        self._ensure_capacity(max(p + 1, bucket))
        s = self.pool.alloc()
        if s is None:
            raise RuntimeError("no free slot after free_slots() > 0")
        pc_seat = time.perf_counter()
        try:
            if _faults.enabled():
                _faults.maybe_serving_fault(self.replica_id)
            t0 = time.monotonic()
            tokens = np.zeros((1, bucket), np.int32)
            tokens[0, :p] = req.prompt
            sp = req.sampling
            # generation index 0: the prefill's token
            kv, first = self._prefill(tokens, p, (
                np.array([sp.temperature], np.float32),
                np.array([sp.top_k], np.int32),
                np.array([sp.top_p], np.float32),
                np.array([sp.seed or 0], np.uint32),
                np.zeros((1,), np.int32)))
            self._insert(self.pool.buffers, kv, s)
            self.pool.note_length(s, p)
            if self.draft_model is not None:
                self._insert(self.draft_pool.buffers,
                             self._draft_prefill(tokens, p), s,
                             kind="dinsert")
                self.draft_pool.note_length(s, p)
            # the admission's one wait: the first token
            self._wait()
            first = int(first[0])
            ms = (time.monotonic() - t0) * 1e3
            metrics.record_prefill(p, ms, bucket)
            with self._stats_lock:
                self._stats["prefills"] += 1
                self._stats["prefill_tokens"] += p
        except BaseException:
            self._release(s)
            raise
        self._note_outcome(True)
        # the first token: the prefill's last logits sampled
        if tr is not None:
            tr.first_token()
        trc = _monitor.trace
        rid = tr.ctx.rid if tr is not None else None
        if trc.enabled():
            trc.lane_complete(f"{self._lane}.slot{s}", "prefill", pc_seat,
                              pc_seat + ms / 1e3, rid=rid, tokens=p,
                              bucket=bucket)
        if (req.eos_token is not None and first == req.eos_token) \
                or req.max_new_tokens == 1:
            self._release(s)
            if trc.enabled():
                trc.lane_complete(f"{self._lane}.slot{s}",
                                  f"req {rid}" if rid else "req", pc_seat,
                                  rid=rid, tokens=1)
            self._complete(req, [first])
            return
        self._seat(s, req, p, [first], first, pc_seat)

    def _seat(self, s, req, length, tokens, last, t_seat):
        slot = self._slots[s]
        with self._lock:
            slot.req = req
            slot.length = length
            slot.tokens = tokens
            slot.last_token = last
            slot.t_seat = t_seat

    def _seat_preset(self, req):
        """Seat a sequence whose history arrives as a host segment
        (``req.preset``, from :meth:`disown_inflight`): the segment lands
        by :meth:`KVCachePool.import_slot` through the insert step for its
        pad (a signature ``warmup`` met with ``kv_import``), and the
        ledger's length restores the generation index, so the stream
        continues as if it never moved. With a draft, the lane's draft
        ledger starts at 0, as in the reference: the draft attends over
        rows it never wrote, its proposals lose their footing and the
        lane's accept rate falls, while the verify keeps the emitted
        distribution exact (greedy: the plain stream)."""
        preset = req.preset
        seg = preset["segment"]
        pad = int(seg["pad"])
        length = int(seg["length"])
        toks = list(preset["tokens"])
        last = int(preset["last_token"])
        tr = req.trace
        self._ensure_capacity(max(length + 1, pad))
        s = self.pool.alloc()
        if s is None:
            raise RuntimeError("no free slot after free_slots() > 0")
        pc_seat = time.perf_counter()
        try:
            if _faults.enabled():
                _faults.maybe_serving_fault(self.replica_id)
            self.pool.import_slot(s, seg, insert_fn=self._insert)
            with self._stats_lock:
                self._stats["kv_imports"] += 1
        except BaseException:
            self._release(s)
            raise
        self._note_outcome(True)
        # the first token was stamped where it came out; entering "decode"
        # closes the hand-off's queue wait
        if tr is not None:
            tr.to("decode")
        trc = _monitor.trace
        if trc.enabled():
            trc.lane_complete(f"{self._lane}.slot{s}", "kv import", pc_seat,
                              time.perf_counter(),
                              rid=tr.ctx.rid if tr is not None else None,
                              tokens=length, pad=pad)
        if (req.eos_token is not None and last == req.eos_token) \
                or len(toks) >= req.max_new_tokens:
            self._release(s)
            self._complete(req, toks)
            return
        self._seat(s, req, length, toks, last, pc_seat)

    # -- the decode tick ---------------------------------------------------

    def _gather_batch(self, extra=1):
        """Snapshot the live lanes into the tick's host arrays: tokens,
        lengths, active, the sampling knobs and each lane's generation
        index (the counter its random draw is keyed by). ``extra`` is the
        arena headroom a lane needs this tick (1 for a decode step, k + 1
        for a speculative one)."""
        with self._lock:
            assigned = [(s, slot.req) for s, slot in enumerate(self._slots)
                        if slot.req is not None]
            if not assigned:
                return None
            n = self.slots
            tokens = np.zeros((n,), np.int32)
            lengths = np.zeros((n,), np.int32)
            active = np.zeros((n,), bool)
            temps = np.zeros((n,), np.float32)
            top_ks = np.zeros((n,), np.int32)
            top_ps = np.ones((n,), np.float32)
            seeds = np.zeros((n,), np.uint32)
            positions = np.zeros((n,), np.int32)
            max_needed = 0
            for s, req in assigned:
                slot = self._slots[s]
                sp = req.sampling
                tokens[s] = slot.last_token
                lengths[s] = slot.length
                active[s] = True
                temps[s] = sp.temperature
                top_ks[s] = sp.top_k
                top_ps[s] = sp.top_p
                seeds[s] = sp.seed or 0
                positions[s] = len(slot.tokens)
                max_needed = max(max_needed, slot.length + extra)
        return (assigned, tokens, lengths, active,
                (temps, top_ks, top_ps, seeds, positions), max_needed)

    def _decode_once(self):
        batch = self._gather_batch()
        if batch is None:
            return False
        assigned, tokens, lengths, active, knobs, max_needed = batch
        self._ensure_capacity(max_needed)
        try:
            if _faults.enabled():
                _faults.maybe_serving_fault(self.replica_id)
            t0 = time.monotonic()
            nxt = self._decode_step(tokens, lengths, active, knobs)
            step_ms = (time.monotonic() - t0) * 1e3
        except BaseException as e:   # noqa: BLE001 - fail the wave
            self._note_outcome(False, e)
            self._fail_active(assigned, e)
            return True
        self._note_outcome(True)
        finished = []
        with self._lock:
            n_active = 0
            for s, req in assigned:
                slot = self._slots[s]
                if slot.req is not req:
                    continue
                n_active += 1
                tok = int(nxt[s])
                slot.length += 1
                slot.tokens.append(tok)
                slot.last_token = tok
                self.pool.note_length(s, slot.length)
                if (req.eos_token is not None and tok == req.eos_token) \
                        or len(slot.tokens) >= req.max_new_tokens:
                    finished.append((s, req, slot.tokens, slot.t_seat))
                    slot.req = None
                    slot.tokens = None
                    self.pool.free(s)
        with self._stats_lock:
            self._stats["ticks"] += 1
            self._stats["tokens"] += n_active
            self._occupancy_sum += n_active / self.slots
        metrics.record_decode_tick(n_active, self.slots, n_active, step_ms)
        self._finish(finished)
        return True

    def _finish(self, finished):
        """Close each finished sequence's occupancy interval on its slot's
        lane, then resolve it."""
        trc = _monitor.trace
        if trc.enabled() and finished:
            now_pc = time.perf_counter()
            for s, req, toks, t_seat in finished:
                rid = req.trace.ctx.rid if req.trace is not None else None
                trc.lane_complete(f"{self._lane}.slot{s}",
                                  f"req {rid}" if rid else "req", t_seat,
                                  now_pc, rid=rid, tokens=len(toks))
        for _s, req, toks, _t in finished:
            self._complete(req, toks)

    def _spec_once(self):
        """One speculative tick: ``k`` proposals a live lane and one verify
        (:meth:`_spec_step`), then each lane's ledger settled on the host:

        * partial accept (``a < k``): emit ``d_1 .. d_a`` and the residual
          resample, ``a + 1`` tokens;
        * full accept: emit exactly ``d_1 .. d_k`` and keep ``d_k`` as the
          next input, with no bonus token, so that the draft arena never
          falls an entry behind the target's;

        an EOS or the budget cuts the emitted tokens where it falls. Both
        steps wrote their entries ahead; ``note_length`` then ``rollback``
        trims each pool's ledger to the kept prefix (no device copy)."""
        k = self.spec_k
        batch = self._gather_batch(extra=k + 1)
        if batch is None:
            return False
        assigned, tokens, lengths, active, knobs, max_needed = batch
        # a lane within k of its budget still verifies a whole chunk: its
        # writes past the arena are dropped and its ledgers clamp below,
        # so the chunk's shape never varies
        self._ensure_capacity(min(max_needed, self.pool.max_len))
        cap = self.pool.capacity
        try:
            if _faults.enabled():
                _faults.maybe_serving_fault(self.replica_id)
            t0 = time.monotonic()
            a, resampled, proposals = self._spec_step(tokens, lengths,
                                                      active, knobs)
            step_ms = (time.monotonic() - t0) * 1e3
        except BaseException as e:   # noqa: BLE001 - fail the wave
            self._note_outcome(False, e)
            self._fail_active(assigned, e)
            return True
        self._note_outcome(True)
        finished = []
        emitted_total = accepted_total = n_active = 0
        with self._lock:
            for s, req in assigned:
                slot = self._slots[s]
                if slot.req is not req:
                    continue
                n_active += 1
                L, ai = int(lengths[s]), int(a[s])
                new = [int(t) for t in proposals[s, :ai]]
                if ai < k:
                    new.append(int(resampled[s]))
                emitted, done = [], False
                for t in new:
                    emitted.append(t)
                    if (req.eos_token is not None and t == req.eos_token) \
                            or len(slot.tokens) + len(emitted) \
                            >= req.max_new_tokens:
                        done = True
                        break
                e = len(emitted)
                # the verify wrote the target's entries for [last, d_1 ..
                # d_k] at L .. L+k, the draft its own for [last, d_1 ..
                # d_k-1] at L .. L+k-1 (those inside the arena): keep the
                # L + e entries before the new last token
                self.pool.note_length(s, min(L + k + 1, cap))
                self.pool.rollback(s, L + e)
                self.draft_pool.note_length(s, min(L + k, cap))
                if e < k:
                    self.draft_pool.rollback(s, L + e)
                slot.tokens.extend(emitted)
                slot.length = L + e
                slot.last_token = emitted[-1]
                if req.trace is not None:
                    req.trace.note_spec(k, ai)
                emitted_total += e
                accepted_total += ai
                if done:
                    finished.append((s, req, slot.tokens, slot.t_seat))
                    slot.req = None
                    slot.tokens = None
                    self._release(s)
        with self._stats_lock:
            self._stats["ticks"] += 1
            self._stats["tokens"] += emitted_total
            self._stats["draft_steps"] += k
            self._stats["verify_steps"] += 1
            self._stats["spec_proposed"] += k * n_active
            self._stats["spec_accepted"] += accepted_total
            self._occupancy_sum += n_active / self.slots
        metrics.record_decode_tick(n_active, self.slots, emitted_total,
                                   step_ms)
        metrics.record_spec_tick(k * n_active, accepted_total, emitted_total,
                                 k)
        self._finish(finished)
        return True

    def _fail_active(self, assigned, exc):
        with self._lock:
            failed = []
            for s, req in assigned:
                slot = self._slots[s]
                if slot.req is not req:
                    continue
                failed.append((s, req, slot.t_seat))
                slot.req = None
                slot.tokens = None
                self._release(s)
        with self._stats_lock:
            self._stats["failed"] += len(failed)
        trc = _monitor.trace
        if trc.enabled() and failed:
            now_pc = time.perf_counter()
            for s, _r, t_seat in failed:
                trc.lane_complete(f"{self._lane}.slot{s}", "req failed",
                                  t_seat, now_pc)
        for _s, r, _t in failed:
            r.resolve_exception(exc)

    def _complete(self, req, tokens):
        now = time.monotonic()
        latency_ms = req.age(now) * 1e3
        within = req.deadline is None or not req.deadline.expired(now)
        if req.trace is not None:
            # the token count lands before the record is finalized: tpot
            # derives from it
            req.trace.note_tokens(len(tokens))
        # count before resolving: a stats() read right after result()
        # must already see this completion
        metrics.record_completed(1, [latency_ms], within_sla=[within])
        with self._stats_lock:
            self._stats["completed"] += 1
        req.resolve_result(np.asarray(tokens, np.int32))


# ---------------------------------------------------------------------------
# fleet fan-out


def replicate_decode(model, devices=None):
    """One decode model a device, each its own copy of ``model`` (weights
    included) on that device, so that a rolling swap changes exactly one
    replica; the hyperparameters and the prefill/decode functions are the
    model's. ``devices`` as :func:`~paddle_tpu_torch.serving.multi.
    fleet_devices` takes it (default: every CUDA card)."""
    return [copy.deepcopy(model).to(d) for d in fleet_devices(devices)]


class MultiDecodeEngine(MultiDeviceEngine):
    """Breaker-aware decode fan-out: one :class:`GenerateEngine` per
    replica (:func:`replicate_decode`; ``devices`` may name one card more
    than once), behind the same supervision spine as fixed-shape serving
    — per-replica circuit breakers, hang failover (evicted sequences
    regenerate deterministically on the adopting replica), half-open
    probes, restart, and supervisor scaling (goodput floor plus
    ``tokens_floor``). Engine kwargs (``slots``, ``draft_model``, ...)
    apply per replica.

    Hedging defaults OFF for decode (``hedge_ms=0``): a decode request
    occupies a slot for its whole lifetime, so a hedge doubles slot
    pressure for the duration rather than shaving a straggler's tail —
    exactly the wrong trade under load. Pass ``hedge_ms`` explicitly to
    re-enable it for latency-critical, lightly-loaded fleets."""

    def __init__(self, model, devices=None, hedge_ms=0, **kwargs):
        super().__init__(model, devices=devices, hedge_ms=hedge_ms,
                         **kwargs)

    def _replicate(self, model, devices):
        return replicate_decode(model, devices)

    def _new_engine(self, model, index, on_outcome):
        return GenerateEngine(model, replica_id=index,
                              on_outcome=on_outcome,
                              **self._engine_kwargs)

    def _serving_module(self, r):
        return r.engine.model

    def _serve_module(self, r, module):
        # every executable the replica holds is captured over the new
        # module before it is bound (GenerateEngine.prepare), so that no
        # step under traffic captures; each step reads ``model`` once
        r.engine.prepare(module)
        r.predictor = r.engine.model = module

    def submit(self, prompt, max_new_tokens=32, eos_token=None,
               deadline_ms=None, priority=None, trace=None,
               sampling=None, seed=None):
        rep = self._pick_replica()
        return self._dispatch(rep, rep.engine.make_request(
            prompt, max_new_tokens=max_new_tokens, eos_token=eos_token,
            deadline_ms=deadline_ms, priority=priority, trace=trace,
            sampling=sampling, seed=seed))

    def run(self, prompt, max_new_tokens=32, eos_token=None,
            deadline_ms=None, timeout=None, priority=None,
            sampling=None, seed=None):
        return self.submit(prompt, max_new_tokens=max_new_tokens,
                           eos_token=eos_token, deadline_ms=deadline_ms,
                           priority=priority, sampling=sampling,
                           seed=seed).result(timeout)

    @staticmethod
    def _shadow(req, trace):
        """A decode hedge re-prefills the same prompt on a second replica:
        the shadow carries the primary's resolved ``sampling`` (seed
        included), so both replicas derive the same counter keys and
        produce the same tokens; the first resolution wins."""
        return DecodeRequest(req.prompt, req.max_new_tokens,
                             eos_token=req.eos_token, deadline=req.deadline,
                             priority=req.priority, sampling=req.sampling,
                             trace=trace)


# ---------------------------------------------------------------------------
# the reference decode model


class DemoLM(torch.nn.Module):
    """A small causal LM that implements the decode-model contract:
    tied-embedding transformer (RMSNorm, per-layer attention and a ReLU
    MLP), sinusoidal positions, float32. Prefill attends through
    :func:`~paddle_tpu_torch.ops.kernels.flash_attention.flash_attention`
    (causal), which launches kernel #3 on a CUDA tensor; decode attends
    over the KV arena in plain PyTorch, as the reference's einsums do.

    The position table is read clamped to its last row, as JAX's gather
    reads it: a speculative chunk near the end of a request's budget
    reaches past the table, and the rows there are computed and thrown
    away (on the card an index out of the table would be a device assert).

    Its parameters and buffer carry the reference state's names
    (``embed``, ``pos``, ``wq0`` .. ``w2{L-1}``), so
    ``convert.load_jax_state(lm, {k: np.asarray(v) for k, v in
    ref.state.items()})`` carries the reference's weights across. The
    weights here are drawn from ``torch.Generator().manual_seed(seed)``
    (other numbers than the reference's threefry draws)."""

    def __init__(self, vocab=64, dim=32, heads=2, layers=2, max_len=512,
                 seed=0, device=None):
        super().__init__()
        if dim % heads:
            raise ValueError(f"dim {dim} not divisible by heads {heads}")
        dev = _device.resolve(device)
        self.vocab = int(vocab)
        self.dim = int(dim)
        self.heads = int(heads)
        self.head_dim = self.dim // self.heads
        self.layers = int(layers)
        self.max_len = int(max_len)
        gen = torch.Generator().manual_seed(int(seed))
        scale = 1.0 / math.sqrt(self.dim)

        def weight(*shape):
            return torch.nn.Parameter(
                torch.randn(*shape, generator=gen) * scale,
                requires_grad=False)

        self.embed = weight(self.vocab, self.dim)
        # sinusoidal positions: deterministic, and identical between
        # prefill and decode by construction
        pos = np.arange(self.max_len)[:, None]
        div = np.exp(np.arange(0, self.dim, 2)
                     * (-np.log(10000.0) / self.dim))
        table = np.zeros((self.max_len, self.dim), np.float32)
        table[:, 0::2] = np.sin(pos * div)
        table[:, 1::2] = np.cos(pos * div)
        self.register_buffer("pos", torch.from_numpy(table))
        for layer in range(self.layers):
            for name, shape in (("wq", (self.dim, self.dim)),
                                ("wk", (self.dim, self.dim)),
                                ("wv", (self.dim, self.dim)),
                                ("wo", (self.dim, self.dim)),
                                ("w1", (self.dim, 2 * self.dim)),
                                ("w2", (2 * self.dim, self.dim))):
                setattr(self, f"{name}{layer}", weight(*shape))
        self.to(dev)

    @property
    def device(self):
        return self.embed.device

    @property
    def state(self):
        """The weights as ``{name: tensor}`` (views of the module's own)."""
        return dict(self.state_dict())

    def kv_spec(self):
        tail = (self.heads, self.head_dim)
        spec = {}
        for layer in range(self.layers):
            spec[f"k{layer}"] = (tail, "float32")
            spec[f"v{layer}"] = (tail, "float32")
        return spec

    @staticmethod
    def _norm(x):
        return x * torch.reciprocal(
            torch.sqrt(torch.mean(torch.square(x), dim=-1, keepdim=True)
                       + 1e-6))

    @staticmethod
    def _positions(state, index):
        """Rows of the position table at ``index``, clamped to its last."""
        table = state["pos"]
        return table[index.clamp(max=table.shape[0] - 1)]

    def _mlp(self, state, x, layer):
        hidden = self._norm(x)
        return x + torch.relu(hidden @ state[f"w1{layer}"]) \
            @ state[f"w2{layer}"]

    def prefill_fn(self, state, tokens, lengths):
        """Full-prompt forward: (B, L) -> K/V chunks ``[B, L, H, Dh]`` and
        the last real token's logits ``[B, V]``. Causal attention makes
        end-padding harmless: a real position sees only real ones."""
        b, seq = tokens.shape
        h, hd = self.heads, self.head_dim
        x = state["embed"][tokens] + state["pos"][:seq][None]
        kv = {}
        for layer in range(self.layers):
            hidden = self._norm(x)
            q = (hidden @ state[f"wq{layer}"]).reshape(b, seq, h, hd)
            k = (hidden @ state[f"wk{layer}"]).reshape(b, seq, h, hd)
            v = (hidden @ state[f"wv{layer}"]).reshape(b, seq, h, hd)
            kv[f"k{layer}"] = k
            kv[f"v{layer}"] = v
            # (B, H, L, Dh) views with the head dim contiguous: no copy
            # before the kernel
            out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), causal=True)
            out = out.transpose(1, 2).reshape(b, seq, self.dim)
            x = x + out @ state[f"wo{layer}"]
            x = self._mlp(state, x, layer)
        # the logits of the last real token only: the norm and the
        # projection act row by row
        last = x[torch.arange(b, device=x.device), lengths - 1]
        return kv, self._norm(last) @ state["embed"].T

    def decode_fn(self, state, tokens, kv, lengths):
        """One token per lane against the KV arena: attend over the
        resident history (masked by live length) plus the incoming
        token's own K/V, as prefill does at position ``lengths``, and
        return that token's cache entry."""
        s = tokens.shape[0]
        h, hd = self.heads, self.head_dim
        cap = next(iter(kv.values())).shape[1]
        inv = 1.0 / math.sqrt(hd)
        x = state["embed"][tokens] + self._positions(state, lengths)
        entry = {}
        hist_mask = (torch.arange(cap, device=x.device)[None, None, :]
                     < lengths[:, None, None])
        for layer in range(self.layers):
            hidden = self._norm(x)
            q = (hidden @ state[f"wq{layer}"]).reshape(s, h, hd)
            k_new = (hidden @ state[f"wk{layer}"]).reshape(s, h, hd)
            v_new = (hidden @ state[f"wv{layer}"]).reshape(s, h, hd)
            entry[f"k{layer}"] = k_new
            entry[f"v{layer}"] = v_new
            scores_h = torch.einsum("shd,schd->shc", q,
                                    kv[f"k{layer}"]) * inv
            scores_h = torch.where(hist_mask, scores_h, -1e9)
            score_s = torch.sum(q * k_new, dim=-1, keepdim=True) * inv
            scores = torch.cat([scores_h, score_s], dim=-1)
            probs = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
            probs = probs / probs.sum(dim=-1, keepdim=True)
            out = torch.einsum("shc,schd->shd", probs[..., :cap],
                               kv[f"v{layer}"]) \
                + probs[..., cap:] * v_new
            x = x + out.reshape(s, self.dim) @ state[f"wo{layer}"]
            x = self._mlp(state, x, layer)
        return self._norm(x) @ state["embed"].T, entry

    def verify_fn(self, state, tokens, kv, lengths):
        """Chunked decode, :meth:`decode_fn` over a ``(S, C)`` chunk (the
        speculative verify): chunk position ``i`` sits at arena position
        ``lengths + i`` and attends over the resident history (masked by
        live length) plus chunk positions ``<= i``; all C logits rows and
        cache entries come back. At ``C == 1`` it computes what
        :meth:`decode_fn` does (a masked score is an exact zero after the
        softmax)."""
        s, c = tokens.shape
        h, hd = self.heads, self.head_dim
        cap = next(iter(kv.values())).shape[1]
        inv = 1.0 / math.sqrt(hd)
        dev = tokens.device
        chunk = torch.arange(c, device=dev)
        x = state["embed"][tokens] + self._positions(
            state, lengths[:, None] + chunk[None, :])
        entry = {}
        hist_mask = (torch.arange(cap, device=dev)[None, None, None, :]
                     < lengths[:, None, None, None])       # [S, 1, 1, cap]
        self_mask = (chunk[None, :] <= chunk[:, None])[None, :, None, :]
        for layer in range(self.layers):
            hidden = self._norm(x)
            q = (hidden @ state[f"wq{layer}"]).reshape(s, c, h, hd)
            k_new = (hidden @ state[f"wk{layer}"]).reshape(s, c, h, hd)
            v_new = (hidden @ state[f"wv{layer}"]).reshape(s, c, h, hd)
            entry[f"k{layer}"] = k_new
            entry[f"v{layer}"] = v_new
            scores_h = torch.einsum("schd,sChd->schC", q,
                                    kv[f"k{layer}"]) * inv
            scores_h = torch.where(hist_mask, scores_h, -1e9)
            scores_c = torch.einsum("schd,sChd->schC", q, k_new) * inv
            scores_c = torch.where(self_mask, scores_c, -1e9)
            scores = torch.cat([scores_h, scores_c], dim=-1)
            probs = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
            probs = probs / probs.sum(dim=-1, keepdim=True)
            out = torch.einsum("schC,sChd->schd", probs[..., :cap],
                               kv[f"v{layer}"]) \
                + torch.einsum("schC,sChd->schd", probs[..., cap:], v_new)
            x = x + out.reshape(s, c, self.dim) @ state[f"wo{layer}"]
            x = self._mlp(state, x, layer)
        return self._norm(x) @ state["embed"].T, entry


def demo_model(vocab=64, dim=32, heads=2, layers=2, max_len=512, seed=0,
               device=None):
    """The reference decode model for tests, the load generator and the
    smoke run; on the card unless ``device`` says otherwise."""
    return DemoLM(vocab=vocab, dim=dim, heads=heads, layers=layers,
                  max_len=max_len, seed=seed, device=device)


def demo_spec_pair(vocab=64, dim=32, heads=2, draft_layers=1,
                   extra_layers=1, max_len=512, seed=0, distill=0.15,
                   device=None):
    """A (target, draft) :class:`DemoLM` pair built for a high accept rate,
    as a distilled draft would give one:

    * the target has ``draft_layers + extra_layers`` layers, and its
      refinement layers' weights are scaled by ``distill`` (each one's
      residual contribution lands near ``distill**2``), so its
      distribution is a small perturbation of its prefix's;
    * the draft is that prefix: it holds the target's own ``embed``,
      ``pos`` and first ``draft_layers`` layers' tensors (the same
      ``Parameter`` and buffer objects), so the pair costs one model's
      memory plus the extra layers, and loading weights into the target
      (``convert.load_jax_state``) loads the draft's too.

    On the card unless ``device`` says otherwise."""
    target = DemoLM(vocab=vocab, dim=dim, heads=heads,
                    layers=draft_layers + extra_layers, max_len=max_len,
                    seed=seed, device=device)
    with torch.no_grad():
        for layer in range(draft_layers, target.layers):
            for w in ("wq", "wk", "wv", "wo", "w1", "w2"):
                getattr(target, f"{w}{layer}").mul_(float(distill))
    # built on the host, then every tensor swapped for the target's
    draft = DemoLM(vocab=vocab, dim=dim, heads=heads, layers=draft_layers,
                   max_len=max_len, seed=seed, device="cpu")
    for name in list(draft.state_dict()):
        setattr(draft, name, getattr(target, name))
    return target, draft
