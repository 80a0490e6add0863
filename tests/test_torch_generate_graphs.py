"""The ``GenerateEngine``'s executables (one graph entry per step signature
and host branch, ``paddle_tpu_torch.graphs``) against the JAX package's
engine, on the CPU.

On the card each decode step, draft-then-verify step and prefill is a
CUDA graph captured at ``warmup()`` over a static lane array, the served
weights and the KV arena, whose addresses no grow moves
(``KVCachePool.arena``); on the CPU the same entry re-runs the step over
its static lane array. So the keys (capacity or bucket, and the
batch-wide branch: greedy, sampled, filtered), the lane arrays' copy-in,
the fixed-shape arena writes, the read-back and the swap's captures are
held here against the reference (weights carried across with
``convert.load_jax_state``, small widths).

Rules, each with its reason:

* sampled streams: token for token at the same seeds (the draws are the
  reference's bits); greedy streams: token for token (no position of
  these streams sits within 1e-5 of a tie of the reference's logits);
* arena rows below each lane's length: within 1e-5 as ``|port - ref| /
  max(1, |ref|)`` (float32 products summed in another order);
* the graphed engine against the eager arm (``decode_loadgen.EagerEngine``,
  the same bodies run launch by launch): bit for bit, the same operations
  on the same inputs.

A step that a graph cannot capture raises ``CaptureError`` on the card:
that case needs the card and lives in ``test_torch_cuda.py``, which
imports no JAX.

Isolation: every test clears both fault registries, turns both monitors
off and runs with the reference's flat-arena hook cleared, as the other
engine files do; every engine is closed.
"""
import numpy as np
import pytest
import torch

import paddle_tpu.tensor as ref_tensor
from paddle_tpu import monitor as ref_monitor
from paddle_tpu import serving as ref_serving
from paddle_tpu.resilience import faults as ref_faults
from paddle_tpu.serving.generate import GenerateEngine as RefEngine
from paddle_tpu_torch import convert, monitor, serving
from paddle_tpu_torch.resilience import faults
from paddle_tpu_torch.serving import generate as G
from paddle_tpu_torch.tools import decode_loadgen as LG

TOL = 1e-5
K = 4
SMALL = dict(vocab=32, dim=16, heads=2)
# three capacities (8, 16, 32): a long request crosses both grows
ENGINE = dict(slots=3, page=8, factor=2.0, max_len=32, prompt_buckets=(4, 8),
              shed=False)
UNFILTERED = {"temperature": 1.0}
FILTERED = {"temperature": 0.8, "top_k": 5, "top_p": 0.9}
# the traffic in three waves, one a batch-wide branch: each wave's batches
# are all greedy, all sampled with no filter, or filtered
WAVES = {
    "greedy": [([1, 2, 3], 28, {}), ([5, 4, 3, 2, 1], 6, {}),
               ([7] * 7, 9, {}), ([2, 9], 5, {})],
    "sampled": [([3, 1, 4], 12, {"sampling": UNFILTERED, "seed": 21}),
                ([6, 6, 1, 2, 8], 7, {"sampling": UNFILTERED, "seed": 22}),
                ([11], 27, {"sampling": UNFILTERED, "seed": 23})],
    "filtered": [([9, 8, 7], 10, {"sampling": FILTERED, "seed": 31}),
                 ([4] * 6, 8, {"sampling": FILTERED, "seed": 32}),
                 ([2, 5], 13, {"sampling": FILTERED, "seed": 33})],
}
JOBS = [j for wave in WAVES.values() for j in wave]


@pytest.fixture(autouse=True)
def _isolated():
    hook = ref_tensor._arena_hook
    ref_tensor._arena_hook = None
    for f in (ref_faults, faults):
        f.clear()
    for mon in (ref_monitor, monitor):
        mon.disable(flush_counters=False)
        mon.reset()
    yield
    for f in (ref_faults, faults):
        f.clear()
    for mon in (ref_monitor, monitor):
        mon.disable(flush_counters=False)
        mon.reset()
    ref_tensor._arena_hook = hook


def _scaled(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float((np.abs(a - b) / np.maximum(1.0, np.abs(b))).max())


def _arrays(ref):
    return {k: np.asarray(v) for k, v in ref.state.items()}


def _drive(engine, jobs, ticks=3000):
    """Submit ``jobs`` (prompt, max_new, submit kwargs), tick, and return
    each future's tokens as a list."""
    futs = [engine.submit(p, max_new_tokens=n, **kw) for p, n, kw in jobs]
    for _ in range(ticks):
        if all(f.done() for f in futs):
            break
        engine.tick()
    return [list(map(int, f.result(timeout=10))) for f in futs]


def _engine(model, draft=None, cls=G.GenerateEngine, **kw):
    return cls(model, start=False, draft_model=draft, spec_k=K,
               **dict(ENGINE, **kw))


@pytest.fixture(scope="module")
def ref_model():
    return ref_serving.demo_model(max_len=64, seed=1, layers=2, **SMALL)


@pytest.fixture(scope="module")
def model(ref_model):
    lm = serving.demo_model(max_len=64, layers=2, device="cpu", **SMALL)
    return convert.load_jax_state(lm, _arrays(ref_model))


@pytest.fixture(scope="module")
def ref_pair():
    return ref_serving.demo_spec_pair(draft_layers=1, extra_layers=1,
                                      max_len=64, seed=1, distill=0.2,
                                      **SMALL)


@pytest.fixture(scope="module")
def pair(ref_pair):
    target, draft = serving.demo_spec_pair(
        draft_layers=1, extra_layers=1, max_len=64, seed=1, distill=0.2,
        device="cpu", **SMALL)
    convert.load_jax_state(target, _arrays(ref_pair[0]))
    return target, draft


@pytest.fixture(scope="module")
def ref_streams(ref_model, ref_pair):
    """The reference's streams of :data:`JOBS`: plain, and drafted by the
    pair at k = 4."""
    out = {}
    for kind, (target, draft) in (("plain", (ref_model, None)),
                                  ("spec", ref_pair)):
        eng = RefEngine(target, start=False, draft_model=draft, spec_k=K,
                        **ENGINE)
        out[kind] = _drive(eng, JOBS)
        eng.close(drain=False)
    return out


def _waves(eng):
    """:data:`WAVES` one after the other through ``eng``, each wave's
    requests joining and leaving together: the streams in :data:`JOBS`'
    order."""
    got = []
    for wave in WAVES.values():
        got += _drive(eng, wave)
    return got


def _replayed_branches(eng, kind):
    """The host branches whose ``kind`` step some capacity replayed."""
    return {gkey[2] for gkey, e in eng._graphs.entries.items()
            if gkey[0] == kind and e.replays}


# -- streams ------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["plain", "spec"])
def test_graphed_streams_match_reference_through_every_grow(
        model, pair, ref_streams, kind):
    """A warmed engine's greedy, sampled and filtered waves give the
    reference's streams token for token, the long requests crossing both
    grows; every tick and admission replays an entry; ``executables()``
    and ``captures`` stay where warmup left them."""
    target, draft = (model, None) if kind == "plain" else pair
    eng = _engine(target, draft)
    eng.warmup()
    fam = len(eng.pool.seq_buckets)
    # a decode (or draft-then-verify) step and a prefill a branch, a draft
    # prefill a bucket
    assert eng.captures == 3 * fam + 3 * 2 + (2 if draft else 0)
    before = (eng.executables(), eng.captures)
    got = _waves(eng)
    st = eng.stats()
    assert got == ref_streams[kind]
    assert (eng.executables(), eng.captures) == before
    assert st["pool_grows"] == 2 and eng.pool.capacity == 32
    assert st["tick_replays"] == st["ticks"] > 0
    assert st["prefill_replays"] == st["prefills"] == len(JOBS)
    assert st["draft_prefill_replays"] == (len(JOBS) if draft else 0)
    step = "spec" if draft else "decode"
    assert _replayed_branches(eng, step) == set(G.BRANCHES)
    if draft:
        assert 0 < st["spec_accepted"] <= st["spec_proposed"]
    eng.close(drain=False)


@pytest.mark.parametrize("kind", ["plain", "spec"])
def test_graphed_engine_equals_the_eager_arm_bit_for_bit(model, pair, kind):
    """The loadgen's eager arm runs the same step bodies launch by launch:
    its streams, ledgers and arenas equal the graphed engine's, and it
    captures nothing."""
    target, draft = (model, None) if kind == "plain" else pair
    out = {}
    for arm, cls in (("graph", G.GenerateEngine), ("eager", LG.EagerEngine)):
        eng = _engine(target, draft, cls=cls)
        eng.warmup()
        futs = [eng.submit(p, max_new_tokens=n, **kw) for p, n, kw in JOBS]
        for _ in range(12):
            eng.tick()
        arena = {k: v.clone() for k, v in eng.pool.buffers.items()}
        lengths = [eng.pool.length(s) for s in range(eng.slots)]
        for _ in range(3000):
            if all(f.done() for f in futs):
                break
            eng.tick()
        out[arm] = ([list(map(int, f.result(timeout=10))) for f in futs],
                    lengths, arena, eng.captures, eng.executables())
        eng.close(drain=False)
    g, e = out["graph"], out["eager"]
    assert g[0] == e[0] and g[1] == e[1] and g[4] == e[4]
    assert all(torch.equal(g[2][k], e[2][k]) for k in g[2])
    assert g[3] > 0 and e[3] == 0


def test_unwarmed_engine_captures_under_traffic_and_counts_them(
        model, ref_streams):
    """An engine that was never warmed (a restarted fleet replica) meets
    its signatures under traffic, as the reference compiles there: each
    key captures at its first step, counted, and the streams are the
    reference's."""
    eng = _engine(model)
    assert eng.captures == 0 and eng.executables() == (0, 0)
    got = _waves(eng)
    assert got == ref_streams["plain"]
    keys = set(eng._graphs.entries)
    assert eng.captures == len(keys) > 0
    assert {k[0] for k in keys} == {"decode", "prefill"}
    eng.close(drain=False)


# -- the arena ----------------------------------------------------------------

@pytest.mark.parametrize("kind", ["plain", "spec"])
def test_live_arena_rows_match_reference_after_each_tick(
        model, ref_model, pair, ref_pair, kind):
    """Ticked in lockstep with the reference's engine, a warmed engine's
    target and draft arenas hold the reference's rows below each live
    lane's length after every tick: through both grows and at the brim,
    where a request fills the arena to its last position (a drafted lane
    within k of its capacity: its entries past the arena land nowhere,
    never two on one row)."""
    target, draft = (model, None) if kind == "plain" else pair
    ref_t, ref_d = (ref_model, None) if kind == "plain" else ref_pair
    jobs = [([1, 2, 3], 29, {}), ([4, 2], 30, {"sampling": UNFILTERED,
                                               "seed": 3}),
            ([9] * 6, 26, {"sampling": FILTERED, "seed": 4})]
    ref = RefEngine(ref_t, start=False, draft_model=ref_d, spec_k=K,
                    **ENGINE)
    eng = _engine(target, draft)
    eng.warmup()
    captures = eng.captures
    futs = [[e.submit(p, max_new_tokens=n, **kw) for p, n, kw in jobs]
            for e in (ref, eng)]
    brim = 0
    for _ in range(200):
        if all(f.done() for f in futs[1]):
            break
        ref.tick()
        eng.tick()
        for s, slot in enumerate(eng._slots):
            assert (slot.req is None) == (ref._slots[s].req is None)
            if slot.req is None:
                continue
            n = slot.length
            assert n == ref._slots[s].length
            brim += n + K >= eng.pool.capacity == eng.pool.max_len
            pools = [(eng.pool, ref.pool)]
            if draft is not None:
                assert eng.draft_pool.length(s) == ref.draft_pool.length(s)
                pools.append((eng.draft_pool, ref.draft_pool))
            for mine, theirs in pools:
                m = mine.length(s)
                for name, buf in mine.buffers.items():
                    assert _scaled(buf[s, :m].numpy(), np.asarray(
                        theirs.buffers[name][s, :m])) <= TOL
    assert brim > 0
    assert [list(map(int, f.result(timeout=10))) for f in futs[1]] == \
        [list(map(int, f.result(timeout=10))) for f in futs[0]]
    assert eng.captures == captures
    ref.close(drain=False)
    eng.close(drain=False)


@pytest.mark.parametrize("c,cap", [(5, 16), (5, 8), (5, 4), (1, 8)])
def test_window_write_lands_inside_the_arena_one_entry_a_row(c, cap):
    """The verify's write, against a numpy oracle of the port's rule: chunk
    entry ``i`` of an active lane lands at ``length + i`` where that lies
    inside the arena, nowhere otherwise; every other position keeps its
    value; no two entries address one row."""
    rng = np.random.RandomState(c * 100 + cap)
    n = 6
    lengths = np.array([0, 1, cap - c, cap - 2, cap - 1, 3]).clip(0, cap - 1)
    active = np.array([True, True, True, True, True, False])
    arena = rng.randn(n, cap, 2).astype("f4")
    chunk = rng.randn(n, c, 2).astype("f4")
    want = arena.copy()
    for s in range(n):
        for i in range(c):
            if active[s] and lengths[s] + i < cap:
                want[s, lengths[s] + i] = chunk[s, i]
    bufs = {"k0": torch.from_numpy(arena.copy())}
    G._window_write(bufs, {"k0": torch.from_numpy(chunk)},
                    torch.from_numpy(lengths), torch.from_numpy(active))
    assert np.array_equal(bufs["k0"].numpy(), want)


# -- hand-off, churn, swaps ---------------------------------------------------

def test_kv_handoff_into_a_graphed_engine(model, ref_streams):
    """Live lanes exported mid-stream from one warmed engine seat in a
    warmed ``kv_import=True`` engine by importing their segments into its
    live arena, which its graphs read: every stream is the reference's
    unmoved one, and the adopting engine neither meets a signature nor
    captures after its warmup."""
    a = _engine(model)
    a.warmup()
    futs = [a.submit(p, max_new_tokens=n, **kw) for p, n, kw in JOBS]
    for _ in range(14):
        a.tick()
    moved = a.disown_inflight(export_kv=True) + a.steal_pending()
    a.close(drain=False)
    exported = [r for r in moved if r.preset is not None]
    assert exported
    b = _engine(model, kv_import=True)
    b.warmup()
    before = (b.executables(), b.captures)
    b.requeue(moved)
    for _ in range(3000):
        if all(f.done() for f in futs):
            break
        b.tick()
    got = [list(map(int, f.result(timeout=10))) for f in futs]
    st = b.stats()
    assert got == ref_streams["plain"]
    assert st["kv_imports"] == len(exported)
    assert st["prefill_replays"] == st["prefills"] == len(moved) \
        - len(exported)
    assert (b.executables(), b.captures) == before
    b.close(drain=False)


@pytest.mark.parametrize("kind", ["plain", "spec"])
def test_churn_keeps_executables_and_captures_flat(model, pair, kind):
    """Join/leave churn after warmup, its batches greedy, sampled with no
    filter, filtered and mixed, its lanes crossing every grow and ending
    on EOS or their budget: no signature and no capture after warmup."""
    target, draft = (model, None) if kind == "plain" else pair
    eng = _engine(target, draft)
    fresh = eng.warmup()
    assert fresh > 0 and eng.warmup() == 0
    before = (eng.executables(), eng.captures)
    rng = np.random.default_rng(0)
    futs = [eng.submit([2] * 3, max_new_tokens=28)]
    for i in range(18):
        samp = (None, UNFILTERED, FILTERED)[i % 3]
        futs.append(eng.submit(rng.integers(0, 32, size=1 + i % 8),
                               max_new_tokens=3 + i % 6, sampling=samp,
                               seed=i, eos_token=12 if i % 4 == 1 else None))
        eng.tick()
    for _ in range(3000):
        if all(f.done() for f in futs):
            break
        eng.tick()
    assert len(futs[0].result(timeout=10)) == 28
    assert all(len(f.result(timeout=10)) >= 1 for f in futs)
    assert (eng.executables(), eng.captures) == before
    assert eng.stats()["pool_grows"] == 2
    eng.close(drain=False)


def test_a_fleet_swap_captures_before_it_binds(model):
    """``MultiDecodeEngine.swap_weights`` captures every executable of each
    replica over the new module before binding it (``prepare``), so the
    steps after the swap take the prepared entries up and capture
    nothing; the streams are those of an engine built on the new
    weights."""
    other = serving.demo_model(max_len=64, layers=2, seed=2, device="cpu",
                               **SMALL)
    cfg = {k: v for k, v in ENGINE.items() if k != "shed"}
    f = serving.MultiDecodeEngine(model, devices=["cpu", "cpu"],
                                  supervise=False, start=False, shed=False,
                                  **cfg)
    seen = []
    try:
        f.warmup()
        engines = f.engines
        for e in engines:
            e.warmup()
        counts = [(e.captures, len(e._graphs.entries)) for e in engines]
        assert all(n > 0 for _, n in counts)
        for e in engines:
            prepare = e.prepare

            def spy(module, e=e, prepare=prepare):
                seen.append(e.model is not module)   # not bound yet
                return prepare(module)

            e.prepare = spy
        assert f.swap_weights(other.state, probe=False) == 1
        assert seen == [True, True]
        for e, (caps, n) in zip(engines, counts):
            assert e.captures == caps + n
            assert e._prepared is not None and e._prepared.model is e.model
        job = [([3, 1, 4], 20, {"sampling": UNFILTERED, "seed": 5})]
        got = [_drive(e, job)[0] for e in engines]
        for e, (caps, n) in zip(engines, counts):
            assert e.captures == caps + n
            assert e._graphs.model is e.model and e._prepared is None
    finally:
        f.close(drain=False, timeout=2.0)
    fresh = _engine(other)
    want = _drive(fresh, job)[0]
    fresh.close(drain=False)
    assert got == [want, want]
