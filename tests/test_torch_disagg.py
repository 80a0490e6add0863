"""Disaggregated serving (``paddle_tpu_torch.serving.prefix_cache``,
``serving.disagg``, ``parallel.planner.link_bandwidth``) against the JAX
package's, on the CPU.

The port's models carry the reference's weights across
(``convert.load_jax_state``). Rules, each with its reason:

* the prefix cache is host-side numpy in both packages, so the same
  operations give the same verdicts, stats and byte counts, and
  ``prompt_key`` the same keys byte for byte;
* a prefill is the same function of the prompt in both packages: its
  segment and last logits within 1e-5 (float32; absolute and relative)
  of the reference's, its first token equal (sampled: the draws are the
  reference's bits);
* the split topology serves the reference's streams: sampled token for
  token, greedy token for token up to a first parting that must sit on a
  near-tie (top-2 margin within 1e-5 scaled) of the reference's own logits
  (``_departures``), through prefix hits and a mid-stream drain, with
  the reference's counts (hits, misses, prefills, imports, hand-offs and
  their bytes) and request records' stages;
* after warmup neither pool meets a signature or captures a graph (on the
  CPU an entry re-runs its step, so the captures are counted as on the
  card).

Isolation: both monitors off and reset, both packages' request records,
rolling windows and fault registries cleared, and the reference's
flat-arena hook cleared (the file runs reference layers), around every
test.
"""
import importlib.util
import pathlib
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import paddle_tpu.tensor as ref_tensor
from paddle_tpu import monitor as ref_monitor
from paddle_tpu import serving as ref_serving
from paddle_tpu.parallel import planner as ref_planner
from paddle_tpu.resilience import faults as ref_faults
from paddle_tpu.serving import prefix_cache as ref_pc
from paddle_tpu.serving import metrics as ref_metrics
from paddle_tpu.serving import reqtrace as ref_reqtrace
from paddle_tpu.serving.disagg import DisaggServer as RefServer
from paddle_tpu.serving.disagg import PrefillEngine as RefPrefill
from paddle_tpu.serving.generate import GenerateEngine as RefEngine
from paddle_tpu.serving.kv_cache import bytes_per_token as ref_bpt
from paddle_tpu_torch import convert, monitor, serving
from paddle_tpu_torch.parallel import planner
from paddle_tpu_torch.resilience import faults
from paddle_tpu_torch.serving import metrics
from paddle_tpu_torch.serving import prefix_cache as pc
from paddle_tpu_torch.serving import reqtrace
from paddle_tpu_torch.serving.disagg import PrefillEngine
from paddle_tpu_torch.serving.kv_cache import bytes_per_token

TOL = 1e-5
SMALL = dict(vocab=32, dim=16, heads=2, layers=2, max_len=64)
# the reference's topology tests (tests/test_disagg.py:196-267)
TOPO = dict(slots=4, page=16, factor=2.0, max_len=64, prompt_buckets=(8, 32))
SAMPLED = {"temperature": 0.9, "top_k": 8}
PARITY_JOBS = [([1, 2, 3], 8, None, None),
               ([5] * 20, 8, None, None),
               ([1, 2, 3], 8, SAMPLED, 101),       # repeat: a prefix hit
               ([1, 2, 3], 8, SAMPLED, 202),       # again, another seed
               ([9, 8, 7, 6], 8, SAMPLED, 303)]
DRAIN_JOBS = [([1, 2, 3], 40, {"temperature": 1.0, "top_k": 8}, 77),
              ([4, 5], 40, None, None)]
SPEC = {"k0": ((2, 4), "float32"), "v0": ((2, 4), "float32")}
BRANCH_SAMPLING = {"greedy": None, "sampled": {"temperature": 0.9},
                   "filtered": {"temperature": 0.9, "top_k": 5,
                                "top_p": 0.8}}


@pytest.fixture(autouse=True)
def _isolated():
    hook = ref_tensor._arena_hook
    ref_tensor._arena_hook = None
    for f in (ref_faults, faults):
        f.clear()
    for mon in (ref_monitor, monitor):
        mon.disable(flush_counters=False)
        mon.reset()
    for rt in (ref_reqtrace, reqtrace):
        rt.reset()
    for m in (ref_metrics, metrics):
        m.reset_windows()
    yield
    for f in (ref_faults, faults):
        f.clear()
    for mon in (ref_monitor, monitor):
        mon.disable(flush_counters=False)
        mon.reset()
    for rt in (ref_reqtrace, reqtrace):
        rt.reset()
    ref_tensor._arena_hook = hook


@pytest.fixture(scope="module")
def ref_model():
    return ref_serving.demo_model(seed=1, **SMALL)


def _port_of(ref):
    lm = serving.demo_model(vocab=ref.vocab, dim=ref.dim, heads=ref.heads,
                            layers=ref.layers, max_len=ref.max_len,
                            device="cpu")
    return convert.load_jax_state(lm, {k: np.asarray(v) for k, v in
                                       ref.state.items()})


@pytest.fixture(scope="module")
def model(ref_model):
    return _port_of(ref_model)


def _departures(ref_model, jobs, want, got):
    """Streams token for token up to a first parting, which must be a
    greedy job's and a near-tie of the reference's own logits; returns
    the count."""
    parted = 0
    for (prompt, _n, sp, _s), w, g in zip(jobs, want, got):
        assert len(w) == len(g)
        t = next((i for i in range(len(w)) if w[i] != g[i]), None)
        if t is None:
            continue
        assert sp is None, f"a sampled stream parts at {t}"
        seq = list(prompt) + w[:t]
        _, last = ref_model.prefill_fn(ref_model.state,
                                       jnp.asarray([seq], jnp.int32),
                                       jnp.asarray([len(seq)], jnp.int32))
        top2 = np.sort(np.asarray(last[0]))[-2:]
        assert top2[1] - top2[0] <= TOL * max(1.0, abs(float(top2[1]))), (
            f"streams part at {t}, margin {top2[1] - top2[0]}")
        parted += 1
    return parted


def _ref_oracle(ref_model, jobs):
    """The reference's single engine over ``jobs``, as its tests run it."""
    eng = RefEngine(ref_model, start=False, **TOPO)
    eng.warmup()
    futs = [eng.submit(p, max_new_tokens=n, sampling=sp, seed=s)
            for p, n, sp, s in jobs]
    for _ in range(2000):
        eng.tick()
        if all(f.done() for f in futs):
            break
    out = [[int(t) for t in f.result(timeout=5)] for f in futs]
    eng.close(drain=False)
    return out


@pytest.fixture(scope="module")
def ref_parity(ref_model):
    """The reference's ``DisaggServer`` over the parity jobs: its streams,
    stats and request records (each JAX engine compiles every executable
    it meets, so the run is made once a module)."""
    ref_monitor.enable()
    ref_reqtrace.reset()
    try:
        srv = RefServer(ref_model, prefill_replicas=1, decode_replicas=1,
                        supervise=False, **TOPO)
        srv.warmup()
        futs = [srv.submit(p, max_new_tokens=n, sampling=sp, seed=s)
                for p, n, sp, s in PARITY_JOBS]
        streams = [[int(t) for t in f.result(timeout=60)] for f in futs]
        srv.run([1, 2, 3], max_new_tokens=6, timeout=60)
        stats = srv.stats()
        srv.close()
        records = [r for r in ref_reqtrace.recent() if r["outcome"] == "ok"]
    finally:
        ref_monitor.disable(flush_counters=False)
        ref_monitor.reset()
        ref_reqtrace.reset()
    return streams, stats, records


def _port_server(model, prefill=1, decode=1, **kw):
    return serving.DisaggServer(model, prefill_devices=["cpu"] * prefill,
                                decode_devices=["cpu"] * decode,
                                **dict(TOPO, **kw))


def _counts(srv):
    """Each replica's (signatures met, graphs captured), both pools."""
    return [(r.engine.executables(), r.engine.captures)
            for pool in (srv.prefill_pool, srv.decode_pool)
            for r in pool._replicas]


# -- the prefix cache ----------------------------------------------------------


def _segment(pad, length=None, fill=None):
    """A well-formed transport segment for SPEC."""
    length = pad if length is None else length
    rng = np.random.RandomState(0 if fill is None else fill)
    leaves = {name: rng.rand(pad, *tail).astype(np.float32)
              for name, (tail, _dt) in SPEC.items()}
    return {"length": length, "pad": pad,
            "bytes": sum(a.nbytes for a in leaves.values()),
            "leaves": leaves}


def _scenario_hit_miss(mod, bpt):
    cache = mod.PrefixCache(SPEC, budget_bytes=bpt(SPEC) * 16 * 4)
    key, entry = cache.lookup([1, 2, 3])
    log = [key, entry is None]
    log.append(cache.insert(key, _segment(16, length=3),
                            np.zeros(32, np.float32)))
    key2, entry = cache.lookup([1, 2, 3])
    log += [key2 == key, entry.refs, entry.prompt_len, entry.nbytes,
            entry.hits]
    cache.release(key)
    cache.release(key)              # a release past zero is a no-op
    log += [cache.stats(), cache.hit_rate(), len(cache), cache.bytes()]
    return log


def _scenario_asserts(mod, bpt):
    cache = mod.PrefixCache(SPEC, budget_bytes=1 << 20)
    log = []
    seg = _segment(16)
    seg["leaves"]["k0"] = seg["leaves"]["k0"][:8]
    with pytest.raises(AssertionError, match="spec-priced"):
        cache.insert("k", seg, np.zeros(32, np.float32))
    seg2 = _segment(16)
    seg2["bytes"] += 1
    with pytest.raises(AssertionError, match="self-reported"):
        cache.insert("k", seg2, np.zeros(32, np.float32))
    log.append(cache.stats())
    return log


def _scenario_lru_pinning(mod, bpt):
    logits = np.zeros(32, np.float32)
    cache = mod.PrefixCache(SPEC, budget_bytes=bpt(SPEC) * 16 * 2)
    log = [cache.insert("a", _segment(16), logits),
           cache.insert("b", _segment(16), logits),
           cache.insert("c", _segment(16), logits),
           cache.stats(), sorted(cache._entries)]
    cache._entries["b"].refs += 1
    log += [cache.insert("d", _segment(16), logits), sorted(cache._entries)]
    cache._entries["d"].refs += 1
    log += [cache.insert("e", _segment(16), logits), cache.stats(),
            cache.bytes() <= cache.budget_bytes]
    # a racer's second insert of a resident key, pinned
    log += [cache.insert("d", _segment(16), logits, pin=True),
            cache._entries["d"].refs, cache.stats()]
    return log


def _scenario_oversized(mod, bpt):
    cache = mod.PrefixCache(SPEC, budget_bytes=bpt(SPEC) * 16 - 1)
    return [cache.insert("a", _segment(16), np.zeros(32, np.float32)),
            len(cache), cache.stats(), cache.hit_rate()]


def _scenario_lookup_order(mod, bpt):
    """A lookup moves its entry to the LRU's young end: the eviction then
    takes the other."""
    logits = np.zeros(32, np.float32)
    cache = mod.PrefixCache(SPEC, budget_bytes=bpt(SPEC) * (8 + 16))
    ka, kb = mod.prompt_key([1]), mod.prompt_key([2])
    log = [cache.insert(ka, _segment(8, length=1), logits),
           cache.insert(kb, _segment(16, length=1), logits)]
    key, entry = cache.lookup([1])
    cache.release(key)
    log += [key == ka, entry.hits,
            cache.insert("c", _segment(8), logits), sorted(cache._entries)
            == sorted([ka, "c"]), cache.stats()]
    return log


@pytest.mark.parametrize("scenario", [
    _scenario_hit_miss, _scenario_asserts, _scenario_lru_pinning,
    _scenario_oversized, _scenario_lookup_order],
    ids=lambda f: f.__name__[len("_scenario_"):])
def test_prefix_cache_matches_the_reference(scenario):
    """The same operations on both packages' caches (the reference's own
    cases, ``tests/test_disagg.py:110-190``, and a lookup's LRU move) give
    the same verdicts, stats, hits, evictions, refusals and bytes."""
    assert bytes_per_token(SPEC) == ref_bpt(SPEC)
    assert scenario(pc, bytes_per_token) == scenario(ref_pc, ref_bpt)


@pytest.mark.parametrize("prompt", [[1, 2, 3], [1, 2, 3, 4], [7],
                                    list(range(64)), [2 ** 31 - 1, 0]],
                         ids=["three", "four", "one", "long", "wide"])
def test_prompt_key_is_the_references_byte_for_byte(prompt):
    for p in (prompt, np.asarray(prompt, np.int64),
              np.asarray(prompt, np.int32).reshape(1, -1)):
        assert pc.prompt_key(p) == ref_pc.prompt_key(p)
    assert pc.prompt_key(prompt) != pc.prompt_key(prompt + [0])


def test_prefix_cache_records_the_reference_series():
    """Lookups, inserts and evictions publish the ported
    ``serving.prefix.*`` series, as the reference's cache does."""
    monitor.enable()
    logits = np.zeros(32, np.float32)
    cache = pc.PrefixCache(SPEC, budget_bytes=bytes_per_token(SPEC) * 16)
    key, _ = cache.lookup([4, 5])
    cache.insert(key, _segment(16), logits)
    cache.lookup([4, 5])
    cache.release(key)
    cache.insert("other", _segment(16), logits)
    snap = monitor.snapshot("serving.prefix")
    assert snap["serving.prefix.hits"] == snap["serving.prefix.misses"] == 1
    assert snap["serving.prefix.evictions"] == 1
    assert snap["serving.prefix.entries"] == 1
    assert snap["serving.prefix.bytes"] == cache.bytes()
    assert snap["serving.prefix.hit_rate"] == 0.5
    assert snap["serving.prefix.lookup_ms"]["count"] == 2


# -- the link model ------------------------------------------------------------


def test_link_bandwidth_order_of_precedence(monkeypatch):
    monkeypatch.delenv(planner.ENV, raising=False)
    monkeypatch.setenv("PADDLE_TPU_LINK_GBPS", "123")   # the reference's
    assert planner.link_bandwidth(2.5) == 2.5e9
    assert planner.link_bandwidth() == planner.CPU_LINK_BPS
    monkeypatch.setenv(planner.ENV, "40")
    assert planner.link_bandwidth() == 40e9
    assert planner.link_bandwidth(2.5) == 2.5e9
    assert planner.link_bandwidth(device="cpu") == 40e9


def test_link_bandwidth_default_on_the_cpu_is_the_references(monkeypatch):
    """Both packages price a hand-off between CPU devices alike."""
    for var in (planner.ENV, "PADDLE_TPU_LINK_GBPS"):
        monkeypatch.delenv(var, raising=False)
    assert jax.devices()[0].platform == "cpu"
    assert planner.link_bandwidth(device="cpu") == \
        ref_planner.link_bandwidth() == 8e9
    if not torch.cuda.is_available():
        assert planner.link_bandwidth() == 8e9


# -- the prefill engine --------------------------------------------------------


def _prefill_both(ref_model, model, prompt, sampling, seed):
    """One prompt through each package's ``PrefillEngine._process`` twice
    (a miss, then a hit with another seed), each with its own cache:
    [(segment, first, hit)] and the cached logits, per package."""
    out = {}
    for name, cls, m, cache_mod in (("ref", RefPrefill, ref_model, ref_pc),
                                    ("port", PrefillEngine, model, pc)):
        got = []
        cache = cache_mod.PrefixCache(m.kv_spec())
        eng = cls(m, start=False, cache=cache,
                  on_segment=lambda r, seg, first, hit, g=got:
                  g.append((seg, first, hit)), **{
                      k: v for k, v in TOPO.items() if k != "slots"})
        for s in ((seed, seed + 1) if seed is not None else (None, None)):
            eng._process(eng.make_request(prompt, max_new_tokens=4,
                                          sampling=sampling, seed=s))
        key = cache_mod.prompt_key(prompt)
        out[name] = (got, np.asarray(cache._entries[key].logits),
                     eng.stats())
        eng.close()
    return out


@pytest.mark.parametrize("branch", sorted(BRANCH_SAMPLING))
@pytest.mark.parametrize("plen", [3, 8, 20, 32], ids=lambda n: f"len{n}")
def test_prefill_engine_matches_the_references(ref_model, model, plen,
                                               branch):
    """At each bucket (8 and 32) and branch: the miss's segment leaves and
    the cached last logits within 1e-5 of the reference's, the first
    token equal, and the hit's first token (the psample over the cached
    logits, another seed) equal too."""
    rng = np.random.RandomState(plen)
    prompt = rng.randint(1, 31, size=plen).tolist()
    sp = BRANCH_SAMPLING[branch]
    out = _prefill_both(ref_model, model, prompt, sp,
                        17 if sp is not None else None)
    (ref_got, ref_logits, ref_st), (got, logits, st) = out["ref"], out["port"]
    assert [(g[1], g[2]) for g in got] == [(g[1], g[2]) for g in ref_got]
    assert [g[2] for g in got] == [False, True]
    seg, ref_seg = got[0][0], ref_got[0][0]
    assert {k: seg[k] for k in ("length", "pad", "bytes")} == \
        {k: ref_seg[k] for k in ("length", "pad", "bytes")}
    assert sorted(seg["leaves"]) == sorted(ref_seg["leaves"])
    for name, leaf in seg["leaves"].items():
        want = np.asarray(ref_seg["leaves"][name])
        assert leaf.shape == want.shape and leaf.dtype == want.dtype
        np.testing.assert_allclose(leaf, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(logits, ref_logits, rtol=TOL, atol=TOL)
    assert got[1][0] is seg                 # the hit hands the cached one
    for key in ("prefills", "prefix_hits", "prefix_misses", "completed"):
        assert st[key] == ref_st[key]
    # a greedy hit's first token is the cached logits' argmax, on the host
    assert st["prefill_replays"] == 1
    assert st["psample_replays"] == (0 if sp is None else 1)


def test_prefill_engine_warmup_captures_every_key_once(model):
    eng = PrefillEngine(model, start=False, **{
        k: v for k, v in TOPO.items() if k != "slots"})
    assert eng.warmup() == 3                # prefill at 8 and 32, psample
    # each prefill in three branches, the psample in the two sampled ones
    assert eng.captures == 2 * 3 + 2
    assert eng.executables() == (3, 3)
    assert sorted(eng._graphs.entries) == sorted(
        [("prefill", b, br) for b in (8, 32) for br in BRANCH_SAMPLING]
        + [("psample", br) for br in ("sampled", "filtered")])
    assert eng.warmup() == 0 and eng.captures == 8
    assert eng.probe(timeout_s=10.0) is True
    assert eng.stats()["compiles"] == 3
    eng.close()


def test_prefill_engine_probe_before_warmup_is_none(model):
    eng = PrefillEngine(model, start=False, **{
        k: v for k, v in TOPO.items() if k != "slots"})
    assert eng.probe() is None
    eng.close()


def test_prefill_engine_rejects_what_the_reference_rejects(ref_model, model):
    kw = {k: v for k, v in TOPO.items() if k != "slots"}
    for cls, m in ((RefPrefill, ref_model), (PrefillEngine, model)):
        eng = cls(m, start=False, **kw)
        for prompt, n, what in (([], 4, "empty prompt"),
                                ([1] * 33, 4, "largest prefill bucket"),
                                ([1, 2], 0, "max_new_tokens"),
                                ([1] * 30, 40, "exceeds")):
            with pytest.raises(ValueError, match=what):
                eng.make_request(prompt, max_new_tokens=n)
        eng.close()
        with pytest.raises(RuntimeError, match="closed"):
            eng.submit_request(eng.make_request([1, 2]))


def test_prefill_engine_standalone_resolves_the_first_token(model):
    """With no ``on_segment`` the engine resolves the request with its
    first token: the port's threaded worker against the reference's
    greedy first token."""
    eng = PrefillEngine(model, **{k: v for k, v in TOPO.items()
                                  if k != "slots"})
    eng.warmup()
    first = eng.submit_request(eng.make_request([3, 1, 4])).result(10)
    eng.close()
    lm = serving.GenerateEngine(model, start=False, **TOPO)
    fut = lm.submit([3, 1, 4], max_new_tokens=1)
    lm.tick()
    assert list(first) == list(fut.result(10))
    lm.close(drain=False)


# -- the topology --------------------------------------------------------------


def test_disagg_server_matches_the_references(ref_model, model, ref_parity):
    """The reference's parity jobs (``tests/test_disagg.py:196-235``) and
    its trace stages' two requests (``:270-294``): the reference's
    streams, its counts, flat signatures and captures after warmup, every
    hand-off priced by the spec's arithmetic, and the request records'
    prefix verdicts and stages."""
    ref_streams, ref_stats, ref_records = ref_parity
    monitor.enable()
    srv = _port_server(model, supervise=False)
    srv.warmup()
    before = _counts(srv)
    futs = [srv.submit(p, max_new_tokens=n, sampling=sp, seed=s)
            for p, n, sp, s in PARITY_JOBS]
    got = [[int(t) for t in f.result(timeout=60)] for f in futs]
    srv.run([1, 2, 3], max_new_tokens=6, timeout=60)
    st = srv.stats()
    after = _counts(srv)
    srv.close()
    _departures(ref_model, PARITY_JOBS, ref_streams, got)
    assert after == before
    for key in ("handoffs", "handoff_bytes", "kv_bytes_per_token",
                "link_bandwidth_bps"):
        assert st[key] == ref_stats[key], key
    # (the pins drop as the futures resolve: their count is a race)
    assert {k: v for k, v in st["prefix"].items() if k != "pinned"} == \
        {k: v for k, v in ref_stats["prefix"].items() if k != "pinned"}
    for pool, keys in (("prefill", ("prefills", "prefill_tokens",
                                    "prefix_hits", "prefix_misses",
                                    "completed", "submitted")),
                       ("decode", ("prefills", "kv_imports", "completed",
                                   "tokens"))):
        assert {k: st[pool][k] for k in keys} == \
            {k: ref_stats[pool][k] for k in keys}, pool
    assert st["prefix"]["hits"] == 3 and st["decode"]["prefills"] == 0
    assert st["handoff_bytes"] == sum(
        srv.planned_handoff_ms(len(p))[0] for p, *_ in PARITY_JOBS) + \
        srv.planned_handoff_ms(3)[0]
    records = [r for r in reqtrace.recent() if r["outcome"] == "ok"]
    assert len(records) == len(ref_records) == len(PARITY_JOBS) + 1
    # the trace stages' two requests: the last, run alone (a hit)
    for rec, ref in zip(records[-1:], ref_records[-1:]):
        assert rec["prefix_hit"] is ref["prefix_hit"] is True
        assert "prefill_ms" not in rec and "prefill_ms" not in ref
    assert sorted(r["prefix_hit"] for r in records) == \
        sorted(r["prefix_hit"] for r in ref_records)
    for rec in records:
        assert rec["prefix_lookup_ms"] >= 0.0 and rec["handoff_ms"] >= 0.0
        assert abs(rec["recon"] - 1.0) <= reqtrace.RECON_TOL
        assert rec["ttft_ms"] is not None
        assert any(h["hop"] == "handoff" for h in rec["hops"])
        assert ("prefill_ms" in rec) is (rec["prefix_hit"] is False)


def test_disagg_records_a_miss_then_a_hit(model):
    """The reference's stage test (``tests/test_disagg.py:270-294``): a
    miss then a hit of one prompt, each record's prefix verdict, lookup
    and hand-off stages, and a waterfall that reconciles."""
    monitor.enable()
    srv = _port_server(model, supervise=False)
    srv.warmup()
    srv.run([1, 2, 3], max_new_tokens=6, timeout=30)
    srv.run([1, 2, 3], max_new_tokens=6, timeout=30)
    srv.close()
    miss, hit = [r for r in reqtrace.recent() if r["outcome"] == "ok"]
    assert miss["prefix_hit"] is False and hit["prefix_hit"] is True
    assert "prefill_ms" in miss and "prefill_ms" not in hit
    snap = monitor.snapshot("serving.handoff")
    assert snap["serving.handoff.transfers"] == 2


def test_disagg_drain_midstream_matches_the_references(ref_model, model):
    """The reference's drain test (``tests/test_disagg.py:237-267``): the
    decode replica that seated work drains mid-stream, its lanes move with
    their KV, and the streams are the reference's single engine's."""
    want = _ref_oracle(ref_model, DRAIN_JOBS)
    srv = _port_server(model, decode=2, supervise=False)
    srv.warmup()
    before = _counts(srv)
    futs = [srv.submit(p, max_new_tokens=n, sampling=sp, seed=s)
            for p, n, sp, s in DRAIN_JOBS]
    deadline = time.monotonic() + 10
    victim = None
    while victim is None and time.monotonic() < deadline:
        for r in srv.decode_pool._replicas:
            if r.engine.stats()["kv_imports"] > 0:
                victim = r
                break
        time.sleep(0.001)
    assert victim is not None
    lanes, disown = [], victim.engine.disown_inflight

    def spy(**kw):
        out = disown(**kw)
        lanes.extend(out)
        return out

    victim.engine.disown_inflight = spy
    moved = srv.drain_decode_replica(victim.index, reason="test")
    got = [[int(t) for t in f.result(timeout=60)] for f in futs]
    st = srv.stats()
    after = _counts(srv)
    srv.close()
    assert moved >= 1 and lanes
    _departures(ref_model, DRAIN_JOBS, want, got)
    assert after == before
    assert st["decode"]["prefills"] == 0
    # each request imported once at its hand-off, and each live lane the
    # drain moved once more on the peer
    assert st["decode"]["kv_imports"] == len(DRAIN_JOBS) + len(lanes)


@pytest.mark.parametrize("branch", sorted(BRANCH_SAMPLING))
def test_disagg_pools_are_flat_after_warmup(model, branch):
    """Misses and hits of every bucket, on each branch, against a warmed
    server: no signature met and no graph captured in either pool, and
    each prefill and psample a replay."""
    srv = _port_server(model, decode=2, supervise=False)
    srv.warmup()
    before = _counts(srv)
    sp = BRANCH_SAMPLING[branch]
    prompts = [[1, 2], [3] * 9, [1, 2], [4] * 31, [3] * 9]
    futs = [srv.submit(p, max_new_tokens=5, sampling=sp,
                       seed=i if sp else None)
            for i, p in enumerate(prompts)]
    for f in futs:
        assert len(f.result(timeout=60)) == 5
    st = srv.stats()
    assert _counts(srv) == before
    srv.close()
    assert st["prefix"]["hits"] == 2 and st["prefix"]["misses"] == 3
    assert st["prefill"]["prefill_replays"] == 3
    assert st["prefill"]["psample_replays"] == (0 if sp is None else 2)
    assert st["decode"]["prefill_replays"] == 0


def test_default_devices_raise_without_a_card(model, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="CUDA cards"):
        serving.DisaggServer(model, supervise=False, **TOPO)
    with pytest.raises(RuntimeError, match="CUDA cards"):
        serving.PrefillPool(model, supervise=False)
    with pytest.raises(RuntimeError, match="CUDA cards"):
        serving.DisaggServer(model, prefill_devices=["cpu"],
                             supervise=False, **TOPO)


def test_default_devices_cycle_over_the_replicas(model, monkeypatch):
    """The defaults cycle the cards over each pool's replica count, as the
    reference cycles ``jax.local_devices()``."""
    from paddle_tpu_torch.serving import disagg
    monkeypatch.setattr(disagg, "fleet_devices", lambda d: (
        [torch.device("cpu")] * 2 if d is None else
        [torch.device(x) for x in d]))
    assert disagg._cycle(None, 3) == [torch.device("cpu")] * 3
    assert disagg._cycle(["cpu"], 3) == [torch.device("cpu")]


def test_prefill_pool_swap_serves_the_new_weights(ref_model, model):
    """A rolling ``swap_weights`` on the prefill pool (and the decode
    pool) captures each replica's graphs over the new module before
    binding it; the streams of new prompts then equal a fresh server's on
    the new weights. The prefix cache is keyed on the prompt alone and
    outlives the swap, as the reference's does: a prompt cached before it
    hits, and hands over the segment the old weights computed."""
    other = _port_of(ref_serving.demo_model(seed=2, **SMALL))
    old_prompt, jobs = [6, 6, 2], [([1, 5, 9], 10), ([7] * 12, 10)]
    srv = _port_server(model, prefill=2, supervise=False)
    srv.warmup()
    srv.run(old_prompt, max_new_tokens=4, timeout=60)
    key = pc.prompt_key(old_prompt)
    cached = srv.prefix._entries[key].segment
    held = [len(r.engine._graphs.entries)
            for pool in (srv.prefill_pool, srv.decode_pool)
            for r in pool._replicas]
    caps = [c for _, c in _counts(srv)]
    assert srv.prefill_pool.swap_weights(other.state) == 1
    assert srv.decode_pool.swap_weights(other.state) == 1
    swapped = [c for _, c in _counts(srv)]
    assert [b - a for a, b in zip(caps, swapped)] == held
    got = [[int(t) for t in srv.run(p, max_new_tokens=n, timeout=60)]
           for p, n in jobs]
    srv.run(old_prompt, max_new_tokens=4, timeout=60)
    st = srv.stats()
    assert [c for _, c in _counts(srv)] == swapped
    assert srv.prefix._entries[key].segment is cached
    srv.close()
    assert st["prefix"]["hits"] == 1 and st["prefill"]["prefills"] == 3

    fresh = _port_server(other, prefill=2, supervise=False)
    fresh.warmup()
    want = [[int(t) for t in fresh.run(p, max_new_tokens=n, timeout=60)]
            for p, n in jobs]
    fresh.run(old_prompt, max_new_tokens=4, timeout=60)
    new_seg = fresh.prefix._entries[key].segment
    fresh.close()
    assert got == want
    assert not all(np.array_equal(cached["leaves"][k], new_seg["leaves"][k])
                   for k in cached["leaves"])


def test_hung_prefill_replica_fails_over(model):
    """One of two prefill replicas hangs in its first prefill: the
    supervisor fails its request over to the peer, every future resolves,
    and the retried prefill's segment equals, bit for bit, the one the
    hung replica computes once the hang ends (and discards)."""
    srv = _port_server(model, prefill=2, supervise=True,
                       supervisor_interval_s=0.02,
                       prefill_inflight_timeout_ms=200.0)
    prefills = []

    def spy(engine):
        orig = engine._prefill

        def _prefill(tokens, length, knobs):
            out = orig(tokens, length, knobs)
            prefills.append((engine.replica_id, tuple(tokens[0, :length]),
                             out))
            return out

        engine._prefill = _prefill

    try:
        srv.warmup()
        for e in srv.prefill_pool.engines:
            spy(e)
        spec = faults.inject("replica_hang", replica=0, delay=1.0, times=1,
                             site="prefill")
        prompts = [[3 + i, 1, 4, 1][: 2 + i % 3] for i in range(8)]
        futs = [srv.submit(p, max_new_tokens=6, seed=40 + i,
                           sampling={"temperature": 0.8})
                for i, p in enumerate(prompts)]
        outs = [f.result(timeout=60) for f in futs]
        deadline = time.monotonic() + 30
        while len({r for r, *_ in prefills}) < 2 \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        st = srv.stats()
        decisions = [d["decision"]
                     for d in srv.prefill_supervisor.decisions]
    finally:
        srv.close(drain=False)
    assert spec.fired == 1 and all(len(o) == 6 for o in outs)
    assert st["prefill"]["failovers"] == 1 and "failover" in decisions
    by_prompt = {}
    for rid, prompt, out in prefills:
        by_prompt.setdefault(prompt, {})[rid] = out
    twice = [v for v in by_prompt.values() if len(v) == 2]
    assert len(twice) == 1
    (la, fa, ga), (lb, fb, gb) = twice[0][0], twice[0][1]
    assert fa == fb and np.array_equal(ga, gb)
    assert all(np.array_equal(la[k], lb[k]) for k in la)


def test_each_pool_scales_on_its_own_slo(model):
    """Each pool held at 1 of 2 active replicas under load, with a queue
    ceiling of 1 and a tokens/s floor no traffic reaches: the prefill
    supervisor scales up on its queue depth, the decode one on tokens/s,
    neither on goodput (the supervisors' passes taken by hand, at the
    moments the signals stand)."""
    srv = _port_server(model, prefill=2, decode=2, slots=2,
                       supervise=True, supervisor_interval_s=60.0,
                       queue_depth_ceiling=1, tokens_floor=1e9,
                       prefill_initial_active=1, decode_initial_active=1,
                       queue_depth=64)
    srv.warmup()
    # the active prefill replica's first request sleeps: the rest queue
    faults.inject("replica_slow", replica=0, delay=0.3, times=1,
                  site="prefill")
    futs = [srv.submit([1 + i % 7, 2], max_new_tokens=6) for i in range(12)]
    srv.prefill_supervisor.tick()
    for f in futs:
        f.result(timeout=60)
    srv.decode_supervisor.tick()
    pre = [d for d in srv.prefill_supervisor.decisions
           if d["decision"] == "scale_up"]
    dec = [d for d in srv.decode_supervisor.decisions
           if d["decision"] == "scale_up"]
    active = [srv.prefill_pool._active_count(),
              srv.decode_pool._active_count()]
    srv.close()
    assert pre and "queue_depth_ceiling" in pre[0]
    assert "goodput" not in pre[0] and "tokens_floor" not in pre[0]
    assert dec and "tokens_floor" in dec[0]
    assert "goodput" not in dec[0] and "queue_depth_ceiling" not in dec[0]
    assert active == [2, 2]


# -- the load generator --------------------------------------------------------


def _ref_loadgen():
    path = pathlib.Path(__file__).resolve().parents[1] / "scripts" / \
        "decode_loadgen.py"
    spec = importlib.util.spec_from_file_location("_ref_decode_loadgen",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_prefix_workload_is_the_references():
    from paddle_tpu_torch.tools import decode_loadgen as LG
    ref_lg = _ref_loadgen()
    for n, frac, heads, seed in ((96, 0.6, 4, 0), (24, 0.3, 2, 5)):
        assert LG.make_prefix_workload(n, frac, heads, LG.PROMPT_BUCKETS,
                                       96, seed=seed) == \
            ref_lg.make_prefix_workload(n, frac, heads, LG.PROMPT_BUCKETS,
                                        96, seed=seed)


@pytest.mark.parametrize("clients", [0, 2], ids=["at_once", "closed_loop"])
def test_loadgen_prefix_reuse_on_the_cpu(clients, capsys):
    """``decode_loadgen --prefix-reuse`` at a small size: the hit rate,
    the TTFT split, flat pools after warmup, prefills equal to the
    cache's misses, hand-off bytes equal to the link model's."""
    import json
    from paddle_tpu_torch.tools import decode_loadgen as LG
    assert LG.main(["--device", "cpu", "--prefix-reuse", "0.6",
                    "--requests", "16", "--clients", str(clients)]) == 0
    r = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    d = r["disagg"]
    assert r["prefix_reuse"] == 0.6 and d["records"] == d["requests"] == 16
    assert d["clients"] == (clients or None)
    assert 0.0 < d["prefix_hit_rate"] < 1.0
    assert d["ttft_hit_p50_ms"] is not None
    assert d["ttft_miss_p50_ms"] is not None
    assert d["post_warmup_captures"] == d["post_warmup_signatures"] == 0
    assert d["prefills"] == d["prefix_cache"]["misses"]
    assert d["handoff_bytes"] == d["planned_bytes"]
    assert d["decode_prefills"] == 0 and d["kv_imports"] == 16
    assert d["link_bandwidth_bps"] == 8e9 and d["launches"] == {}
    assert d["warmup"]["prefill"]["captures"] == 8
    assert not monitor.enabled()


def test_loadgen_prefix_reuse_runs_the_graph_arm_only():
    from paddle_tpu_torch.tools import decode_loadgen as LG
    for extra in (["--arms", "graph,eager"], ["--spec"],
                  ["--replicas", "1"]):
        with pytest.raises(SystemExit):
            LG.main(["--device", "cpu", "--prefix-reuse", "0.5"] + extra)
