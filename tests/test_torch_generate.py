"""The port's generative serving (``paddle_tpu_torch.serving.generate``:
``DemoLM``, ``GenerateEngine``; ``tools.decode_loadgen``) against the JAX
package's, on the CPU, where the prefill's flash attention computes its
plain version (the reference's computes plain sdpa off the TPU).

The port's ``DemoLM`` carries the reference's weights across
(``convert.load_jax_state``). Tolerances and rules, each with its reason:

* ``prefill_fn``'s K/V and last logits, and ``decode_fn``'s logits and
  cache entry: within 1e-5 as ``|port - ref| / max(1, |ref|)`` (float32
  matmuls summed in another order, a few layers deep);
* greedy streams: token for token up to the first position where they
  part, and there the reference's own logits must have a top-2 margin
  within that tolerance (a near-tie that rounds either way; from there
  on the two streams continue from different prefixes, so nothing later
  is comparable);
* sampled streams: token for token at the same seeds (the draws are the
  reference's bits, see ``test_torch_sampling.py``).

The reference engines and streams are built once per module: each JAX
engine compiles every executable it meets on the CPU.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from paddle_tpu import serving as ref_serving
from paddle_tpu.serving.generate import GenerateEngine as RefEngine
from paddle_tpu_torch import convert, serving
from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.serving import generate as G
from paddle_tpu_torch.tools import decode_loadgen as LG

TOL = 1e-5
PROMPTS = [[1, 2, 3], [5, 4, 3, 2, 1, 9, 8], [7] * 11]
MAX_NEW = 12
SAMPLED = {"temperature": 1.0, "top_k": 8, "top_p": 0.9}
ENGINE = dict(slots=2, page=16, factor=2.0, max_len=64,
              prompt_buckets=(4, 8, 16), shed=False)


def _scaled(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float((np.abs(a - b) / np.maximum(1.0, np.abs(b))).max())


def _port_of(ref):
    lm = serving.demo_model(vocab=ref.vocab, dim=ref.dim, heads=ref.heads,
                            layers=ref.layers, max_len=ref.max_len,
                            device="cpu")
    return convert.load_jax_state(
        lm, {k: np.asarray(v) for k, v in ref.state.items()})


@pytest.fixture(scope="module")
def models():
    ref = ref_serving.demo_model(vocab=32, dim=16, heads=2, layers=2,
                                 max_len=64, seed=1)
    return ref, _port_of(ref)


def _drive(engine, jobs, ticks=200):
    """Submit ``jobs`` (prompt, max_new, submit kwargs), tick, and return
    each future's tokens as a list."""
    futs = [engine.submit(p, max_new_tokens=n, **kw) for p, n, kw in jobs]
    for _ in range(ticks):
        if all(f.done() for f in futs):
            break
        engine.tick()
    return [list(map(int, f.result(timeout=10))) for f in futs]


def _jobs():
    greedy = [(p, MAX_NEW, {}) for p in PROMPTS]
    sampled = [(p, MAX_NEW, {"sampling": SAMPLED, "seed": 11 + i})
               for i, p in enumerate(PROMPTS)]
    return greedy + sampled


@pytest.fixture(scope="module")
def ref_streams(models):
    """The reference engine's streams for :func:`_jobs`, then the EOS
    request: its EOS is a token the reference's own greedy stream for
    ``PROMPTS[0]`` meets first after position 0."""
    ref, _ = models
    eng = RefEngine(ref, start=False, **ENGINE)
    out = _drive(eng, _jobs())
    first = out[0]
    eos = next((t for i, t in enumerate(first) if i and t not in first[:i]),
               first[0])
    eos_out = _drive(eng, [(PROMPTS[0], MAX_NEW, {"eos_token": eos})])[0]
    eng.close()
    return out, eos, eos_out


def _assert_greedy_match(ref_model, prompt, ref_toks, got):
    """Token-equal up to the first parting, which must sit on a near-tie
    of the reference's own logits."""
    n = min(len(ref_toks), len(got))
    part = next((i for i in range(n) if ref_toks[i] != got[i]), None)
    if part is None:
        assert len(ref_toks) == len(got)
        return
    seq = list(prompt) + list(ref_toks[:part])
    _, last = ref_model.prefill_fn(ref_model.state,
                                   jnp.asarray([seq], jnp.int32),
                                   jnp.asarray([len(seq)], jnp.int32))
    top2 = np.sort(np.asarray(last[0]))[-2:]
    assert top2[1] - top2[0] <= TOL * max(1.0, abs(float(top2[1]))), (
        f"streams part at {part} where the reference's margin is "
        f"{top2[1] - top2[0]}")


# -- the model ---------------------------------------------------------------

@pytest.mark.parametrize("cfg", [dict(vocab=32, dim=16, heads=2, layers=2),
                                 dict(vocab=64, dim=256, heads=4, layers=2)],
                         ids=["small", "loadgen_width"])
def test_demo_lm_matches_reference(cfg):
    ref = ref_serving.demo_model(max_len=64, seed=1, **cfg)
    lm = _port_of(ref)
    assert set(lm.state) == set(ref.state)
    assert lm.kv_spec() == ref.kv_spec()
    rng = np.random.RandomState(0)
    tokens = np.zeros((2, 8), np.int32)
    tokens[0, :5] = rng.randint(1, 31, 5)
    tokens[1, :8] = rng.randint(1, 31, 8)
    lengths = np.array([5, 8], np.int32)
    kv_r, last_r = ref.prefill_fn(ref.state, jnp.asarray(tokens),
                                  jnp.asarray(lengths))
    with torch.no_grad():
        kv_p, last_p = lm.prefill_fn(lm.state, torch.from_numpy(tokens).long(),
                                     torch.from_numpy(lengths).long())
    assert _scaled(last_p.numpy(), last_r) <= TOL
    for name in kv_r:
        assert _scaled(kv_p[name].numpy(), kv_r[name]) <= TOL
    # decode against an arena holding the prefill's rows, lanes at lengths
    cap = 16
    arena_r = {n: jnp.zeros((2, cap) + tuple(v.shape[2:]), jnp.float32)
               .at[:, :8].set(v) for n, v in kv_r.items()}
    arena_p = {n: torch.from_numpy(np.array(v)) for n, v in arena_r.items()}
    nxt = np.array([3, 17], np.int32)
    logits_r, entry_r = ref.decode_fn(ref.state, jnp.asarray(nxt), arena_r,
                                      jnp.asarray(lengths))
    with torch.no_grad():
        logits_p, entry_p = lm.decode_fn(lm.state,
                                         torch.from_numpy(nxt).long(),
                                         arena_p,
                                         torch.from_numpy(lengths).long())
    assert _scaled(logits_p.numpy(), logits_r) <= TOL
    for name in entry_r:
        assert _scaled(entry_p[name].numpy(), entry_r[name]) <= TOL


def test_demo_lm_is_a_module_on_the_card_by_default():
    lm = serving.demo_model(vocab=16, dim=8, heads=2, layers=1, max_len=16,
                            device="cpu")
    assert isinstance(lm, torch.nn.Module) and lm.device.type == "cpu"
    names = {n for n, _ in lm.named_parameters()}
    assert "embed" in names and "w21" not in names and "w20" in names
    assert all(not p.requires_grad for p in lm.parameters())
    # the same seed draws the same weights; another seed others
    again = serving.demo_model(vocab=16, dim=8, heads=2, layers=1,
                               max_len=16, device="cpu")
    other = serving.demo_model(vocab=16, dim=8, heads=2, layers=1,
                               max_len=16, seed=3, device="cpu")
    assert torch.equal(lm.embed, again.embed)
    assert not torch.equal(lm.embed, other.embed)
    with pytest.raises(ValueError):
        serving.DemoLM(dim=10, heads=4, device="cpu")
    if torch.cuda.is_available():
        assert serving.demo_model(vocab=16, dim=8, heads=2, layers=1,
                                  max_len=16).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            serving.demo_model(vocab=16, dim=8, heads=2, layers=1,
                               max_len=16)


def test_prefill_runs_causal_flash_attention(models, monkeypatch):
    _, lm = models
    calls = []
    real = G.flash_attention

    def spy(q, k, v, **kw):
        calls.append((tuple(q.shape), kw, q.stride(-1)))
        return real(q, k, v, **kw)

    monkeypatch.setattr(G, "flash_attention", spy)
    with torch.no_grad():
        lm.prefill_fn(lm.state, torch.ones((1, 8), dtype=torch.long),
                      torch.tensor([5]))
    assert calls == [((1, 2, 8, 8), {"causal": True}, 1)] * lm.layers


# -- the engine against the reference -----------------------------------------

def test_engine_streams_match_reference(models, ref_streams):
    ref, lm = models
    out, _, _ = ref_streams
    eng = serving.GenerateEngine(lm, start=False, **ENGINE)
    got = _drive(eng, _jobs())
    eng.close()
    n = len(PROMPTS)
    for p, r, g in zip(PROMPTS, out[:n], got[:n]):
        _assert_greedy_match(ref, p, r, g)
    assert got[n:] == out[n:]
    assert all(len(g) == MAX_NEW for g in got)


def test_engine_eos_from_the_reference_stream(models, ref_streams):
    ref, lm = models
    _, eos, eos_out = ref_streams
    assert eos_out[-1] == eos and len(eos_out) <= MAX_NEW
    eng = serving.GenerateEngine(lm, start=False, **ENGINE)
    got = _drive(eng, [(PROMPTS[0], MAX_NEW, {"eos_token": eos})])[0]
    eng.close()
    _assert_greedy_match(ref, PROMPTS[0], eos_out, got)
    assert got[-1] == eos and eos not in got[:-1]


def test_continuous_and_drain_give_the_same_streams(models):
    """The tail-skewed workload of the reference's own A/B: the same
    streams, greedy and sampled, under both disciplines and any
    admission order; continuous refill needs fewer ticks at higher
    occupancy."""
    _, lm = models
    wl = [([1, 2, 3], 4), ([4, 5], 24), ([6], 4), ([7, 8, 9], 4),
          ([2, 4], 4), ([3], 24), ([8], 4), ([9, 1], 4)]
    jobs = [(p, n, {}) for p, n in wl] + \
        [(p, n, {"sampling": SAMPLED, "seed": 100 + i})
         for i, (p, n) in enumerate(wl)]
    outs, stats = {}, {}
    for mode in ("continuous", "drain"):
        eng = serving.GenerateEngine(lm, slots=2, page=32, factor=2.0,
                                     max_len=32, prompt_buckets=(4,),
                                     queue_depth=32, refill=mode,
                                     start=False, shed=False)
        outs[mode] = _drive(eng, jobs, ticks=400)
        stats[mode] = eng.stats()
        eng.close()
    assert outs["continuous"] == outs["drain"]
    assert [len(o) for o in outs["drain"]] == [n for _, n, _ in jobs]
    eng = serving.GenerateEngine(lm, slots=2, page=32, factor=2.0,
                                 max_len=32, prompt_buckets=(4,),
                                 start=False, shed=False)
    assert _drive(eng, jobs[::-1], ticks=400) == outs["drain"][::-1]
    eng.close()
    assert stats["continuous"]["ticks"] < stats["drain"]["ticks"]
    assert (stats["continuous"]["avg_occupancy"]
            > stats["drain"]["avg_occupancy"])


def test_growth_is_warmed_and_churn_meets_no_new_signature(models):
    _, lm = models
    eng = serving.GenerateEngine(lm, slots=3, page=16, factor=2.0,
                                 max_len=64, prompt_buckets=(4, 8),
                                 start=False, shed=False)
    fresh = eng.warmup()
    # decode at 16, 32, 64; insert (4|8, 16|32|64); grow 16->32->64;
    # prefill at 4 and 8
    assert fresh == 3 + 6 + 2 + 2 and eng.warmup() == 0
    before = eng.executables()
    futs = [eng.submit([2] * 8, max_new_tokens=50)]    # crosses 16 and 32
    rng = np.random.RandomState(3)
    for i in range(12):
        plen = int(rng.randint(1, 9))
        futs.append(eng.submit(
            rng.randint(1, 31, size=plen).tolist(),
            max_new_tokens=int(rng.randint(1, 20)),
            eos_token=12 if i % 2 else None,
            sampling=SAMPLED if i % 3 == 0 else None))
    for _ in range(200):
        if all(f.done() for f in futs):
            break
        eng.tick()
    assert len(futs[0].result(timeout=10)) == 50
    assert all(len(f.result(timeout=10)) >= 1 for f in futs)
    assert eng.pool.capacity == 64 and eng.pool.stats()["grows"] == 2
    assert eng.executables() == before
    st = eng.stats()
    assert st["compiles"] == fresh and st["completed"] == len(futs)
    assert eng.pool.allocated_bytes() == eng.pool.bytes()
    eng.close()


def test_rejects_what_the_reference_rejects(models):
    ref, lm = models
    for mod, model in ((ref_serving, ref), (serving, lm)):
        eng = mod.GenerateEngine(model, slots=1, page=16, max_len=32,
                                 prompt_buckets=(8,), start=False,
                                 shed=False)
        for prompt, new in (([1] * 9, 4), ([1] * 8, 25), ([], 4),
                            ([1], 0)):
            with pytest.raises(ValueError):
                eng.make_request(prompt, max_new_tokens=new)
        eng.close()
        eng = mod.GenerateEngine(model, slots=1, page=16, max_len=32,
                                 prompt_buckets=(4,), queue_depth=2,
                                 start=False, shed=False)
        for _ in range(2):
            eng.submit([1, 2], max_new_tokens=4)
        with pytest.raises(mod.QueueFullError):
            eng.submit([1, 2], max_new_tokens=4)
        eng.close(drain=False)
    with pytest.raises(ValueError):
        serving.GenerateEngine(lm, refill="eager", start=False)
    with pytest.raises(ValueError):
        serving.GenerateEngine(lm, max_len=32, page=16,
                               prompt_buckets=(64,), start=False)


def test_requests_are_bounded_by_the_models_positions():
    # grow_buckets(16, 2.0, 48) ends at 64, past a 48-position table: a
    # request there would read positions the model does not have
    lm = serving.demo_model(vocab=16, dim=8, heads=2, layers=1, max_len=48,
                            device="cpu")
    eng = serving.GenerateEngine(lm, slots=1, page=16, max_len=48,
                                 prompt_buckets=(8,), start=False)
    assert eng.pool.max_len == 64 and eng.seq_limit == 48
    with pytest.raises(ValueError, match="model's max_len"):
        eng.make_request([1] * 8, max_new_tokens=41)
    fut = eng.submit([1] * 8, max_new_tokens=40)
    while not fut.done():
        eng.tick()
    assert len(fut.result()) == 40
    eng.close()
    with pytest.raises(ValueError, match="model's max_len"):
        serving.GenerateEngine(lm, slots=1, page=16, max_len=48,
                               start=False)


def test_unported_options_raise(models):
    """The fleet's arguments, once unported, are taken now (item 17.3):
    ``replica_id`` names the engine's trace lanes and ``on_outcome`` hears
    each settled step; a request with a malformed KV segment (``kv_import``
    and ``preset`` are ported) fails its own future, frees its lane and
    is reported as a failure."""
    _, lm = models
    outcomes = []
    eng = serving.GenerateEngine(
        lm, slots=1, page=16, max_len=32, prompt_buckets=(4,), start=False,
        kv_import=True, replica_id=0,
        on_outcome=lambda ok, exc: outcomes.append((ok, type(exc))))
    assert eng.replica_id == 0 and eng._lane == "kv0"
    req = eng.make_request([1, 2], max_new_tokens=3)
    req.preset = {"segment": None}
    eng.submit_request(req)
    eng.tick()
    with pytest.raises(TypeError):
        req.future.result(timeout=10)
    assert eng.stats()["failed"] == 1 and eng.pool.free_slots() == 1
    assert outcomes == [(False, TypeError)]
    eng.close()


def test_threaded_engine_serves_and_close_fails_leftovers(models):
    _, lm = models
    with serving.GenerateEngine(lm, slots=2, page=16, max_len=32,
                                prompt_buckets=(4,)) as eng:
        toks = eng.run([1, 2, 3], max_new_tokens=5, timeout=30)
        assert toks.dtype == np.int32 and len(toks) == 5
        sampled = eng.run([1, 2, 3], max_new_tokens=5, timeout=30,
                          sampling={"temperature": 1.0})
        assert len(sampled) == 5
    eng = serving.GenerateEngine(lm, slots=1, page=16, max_len=32,
                                 prompt_buckets=(4,), start=False)
    fut = eng.submit([1, 2], max_new_tokens=4)
    eng.close(drain=False)
    with pytest.raises(RuntimeError, match="closed"):
        fut.result(timeout=10)
    with pytest.raises(RuntimeError, match="closed"):
        eng.submit([1], max_new_tokens=1)


def test_sampled_request_without_a_seed_gets_one(models):
    _, lm = models
    eng = serving.GenerateEngine(lm, slots=1, page=16, max_len=32,
                                 prompt_buckets=(4,), start=False,
                                 sampling={"temperature": 0.8})
    a = eng.make_request([1], max_new_tokens=2)
    b = eng.make_request([1], max_new_tokens=2)
    assert a.sampling.seed is not None and a.sampling.seed != b.sampling.seed
    assert eng.make_request([1], max_new_tokens=2,
                            sampling={}).sampling.seed == 0
    eng.close()


# -- the slice as a whole -----------------------------------------------------

def test_loadgen_workload_and_streams_match_reference(models):
    """The load generator's workload from its seed, served by the port's
    ``run_load`` in both modes and by the reference's engine: the same
    streams (sampled, per-request seeds), every request complete, no
    signature met after warmup."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "scripts" / \
        "decode_loadgen.py"
    spec = importlib.util.spec_from_file_location("_ref_decode_loadgen",
                                                  path)
    ref_lg = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref_lg)
    wl = LG.make_workload(12, LG.PROMPT_BUCKETS, 96, seed=0)
    assert wl == ref_lg.make_workload(12, LG.PROMPT_BUCKETS, 96, seed=0)
    assert LG.make_workload(96, LG.PROMPT_BUCKETS, 96, seed=0) == \
        ref_lg.make_workload(96, LG.PROMPT_BUCKETS, 96, seed=0)

    ref = ref_serving.demo_model(vocab=64, dim=16, heads=2, layers=2,
                                 max_len=128, seed=1)
    lm = _port_of(ref)
    sampling = {"temperature": 1.0, "top_k": 20, "top_p": 0.9}
    res = {mode: LG.run_load(lm, mode, wl, 4, 96, LG.PROMPT_BUCKETS,
                             sampling=sampling, seed_base=1000)
           for mode in ("continuous", "drain")}
    reng = RefEngine(ref, slots=4, page=32, factor=2.0, max_len=96,
                     prompt_buckets=LG.PROMPT_BUCKETS, start=False,
                     shed=False, queue_depth=32)
    want = _drive(reng, [(p, n, {"sampling": sampling, "seed": 1000 + i})
                         for i, (p, n) in enumerate(wl)], ticks=400)
    reng.close()
    for mode, r in res.items():
        assert [list(map(int, o)) for o in r["outputs"]] == want, mode
        assert r["tokens"] == sum(n for _, n in wl) and r["failed"] == 0
        assert r["post_warmup_signatures"] == 0 and r["device"] == "cpu"
        assert r["latency_p50_ms"] <= r["latency_p99_ms"]
        assert r["ticks"] > 0 and 0 < r["batch_occupancy"] <= 1
    assert res["continuous"]["ticks"] < res["drain"]["ticks"]


def test_teacher_forced_logits_match_the_engine_stream(models):
    _, lm = models
    eng = serving.GenerateEngine(lm, start=False, **ENGINE)
    toks = _drive(eng, [(PROMPTS[1], MAX_NEW, {})])[0]
    eng.close()
    logits = LG.teacher_forced_logits(lm, PROMPTS[1], toks)
    assert logits.shape == (MAX_NEW, lm.vocab)
    np.testing.assert_array_equal(np.argmax(logits, axis=-1), toks)


def test_cpu_prefill_launches_no_kernel(models):
    _, lm = models
    kernels.reset_launches()
    eng = serving.GenerateEngine(lm, start=False, **ENGINE)
    _drive(eng, [(PROMPTS[0], 3, {})])
    eng.close()
    assert kernels.launches["flash_attention_fwd"] == 0
