"""The port's speculative decoding (``paddle_tpu_torch.serving.generate``:
``DemoLM.verify_fn``, ``demo_spec_pair``, ``GenerateEngine(draft_model=,
spec_k=)``; ``tools.decode_loadgen --spec``) against the JAX package's,
on the CPU.

The port's models carry the reference's weights across
(``convert.load_jax_state``). Tolerances and rules, each with its reason:

* ``verify_fn``'s logits and cache entries: within 1e-5 as ``|port -
  ref| / max(1, |ref|)`` (float32 products summed in another order, up
  to 8 layers deep);
* streams against the reference's: token for token up to the first
  position where they part, and there the decision that parted must be a
  near-tie of the reference's own numbers within that tolerance: for a
  greedy stream the target's top-2 margin; for a sampled speculative
  stream the draft's Gumbel-perturbed top-2 margin, the accept test's
  ``|u q(d) - p(d)|`` or the residual resample's perturbed margin (each
  token of a speculative stream is a function of its prefix and of the
  draws at its generation index alone, whatever the chunk it fell in);
  the departures are counted, and no seed is chosen to avoid one;
* the port against itself, where both sides compute the same products at
  one arena capacity (the reference's own single-capacity setup:
  ``max_len=16``, one prompt bucket): bit for bit.

The reference engines are built once per module: each JAX engine compiles
every executable it meets.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from paddle_tpu import serving as ref_serving
from paddle_tpu.serving import sampling as ref_sampling
from paddle_tpu.serving.generate import GenerateEngine as RefEngine
from paddle_tpu_torch import convert, serving
from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.serving import sampling as S
from paddle_tpu_torch.tools import decode_loadgen as LG

TOL = 1e-5
SMALL = dict(vocab=32, dim=16, heads=2)
# the reference's single-capacity engine (tests/test_spec_decode.py:42-48)
ENGINE = dict(slots=4, page=16, max_len=16, prompt_buckets=(16,))
GREEDY_PROMPT, GREEDY_NEW = [3, 1, 4, 1, 5], 11
CONFIGS = [{"temperature": 1.0},
           {"temperature": 0.8, "top_k": 6},
           {"temperature": 1.2, "top_p": 0.9},
           {"temperature": 1.0, "top_k": 8, "top_p": 0.8}]
PAIR_JOBS = [(p, n, {"sampling": c, "seed": 200 + i}) for i, ((p, n), c) in
             enumerate(zip([([7, 2], 12), ([3, 1, 4], 12), ([5, 9, 2, 6], 10),
                            ([11], 14), ([2, 8], 13), ([6, 6, 1], 9)],
                           CONFIGS + CONFIGS[:2]))]


def _scaled(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float((np.abs(a - b) / np.maximum(1.0, np.abs(b))).max())


def _arrays(ref):
    return {k: np.asarray(v) for k, v in ref.state.items()}


def _port_of(ref):
    lm = serving.demo_model(vocab=ref.vocab, dim=ref.dim, heads=ref.heads,
                            layers=ref.layers, max_len=ref.max_len,
                            device="cpu")
    return convert.load_jax_state(lm, _arrays(ref))


def _pair_of(ref_target, draft_layers, distill, **cfg):
    target, draft = serving.demo_spec_pair(
        draft_layers=draft_layers, extra_layers=ref_target.layers
        - draft_layers, max_len=ref_target.max_len, seed=1,
        distill=distill, device="cpu", **cfg)
    convert.load_jax_state(target, _arrays(ref_target))
    return target, draft


def _drive(engine, jobs, ticks=3000):
    """Submit ``jobs`` (prompt, max_new, submit kwargs), tick, and return
    each future's tokens as a list."""
    futs = [engine.submit(p, max_new_tokens=n, **kw) for p, n, kw in jobs]
    for _ in range(ticks):
        if all(f.done() for f in futs):
            break
        engine.tick()
    return [list(map(int, f.result(timeout=10))) for f in futs]


def _engine(model, draft=None, k=4, **kw):
    return serving.GenerateEngine(model, start=False, shed=False,
                                  draft_model=draft, spec_k=k,
                                  **{**ENGINE, **kw})


@pytest.fixture(scope="module")
def ref_model():
    return ref_serving.demo_model(max_len=64, seed=1, layers=2, **SMALL)


@pytest.fixture(scope="module")
def model(ref_model):
    return _port_of(ref_model)


@pytest.fixture(scope="module")
def ref_pair():
    return ref_serving.demo_spec_pair(draft_layers=1, extra_layers=1,
                                      max_len=64, seed=1, distill=0.2,
                                      **SMALL)


@pytest.fixture(scope="module")
def pair(ref_pair):
    return _pair_of(ref_pair[0], 1, 0.2, **SMALL)


@pytest.fixture(scope="module")
def ref_bad_draft():
    return ref_serving.demo_model(layers=1, max_len=64, seed=99, **SMALL)


@pytest.fixture(scope="module")
def ref_streams(ref_model, ref_pair, ref_bad_draft):
    """The reference's speculative streams: greedy over an unrelated
    draft, and the pair's sampled jobs."""
    out = {}
    eng = RefEngine(ref_model, start=False, shed=False,
                    draft_model=ref_bad_draft, spec_k=4, **ENGINE)
    out["greedy"] = _drive(eng, [(GREEDY_PROMPT, GREEDY_NEW, {})])[0]
    eng.close(drain=False)
    eng = RefEngine(ref_pair[0], start=False, shed=False,
                    draft_model=ref_pair[1], spec_k=4, **ENGINE)
    out["pair"] = _drive(eng, PAIR_JOBS)
    eng.close(drain=False)
    return out


@pytest.fixture(scope="module")
def plain_eng(model):
    eng = _engine(model)
    eng.warmup()
    yield eng
    eng.close(drain=False)


@pytest.fixture(scope="module")
def spec_eng(model):
    eng = _engine(model, draft=model, k=4)
    eng.warmup()
    yield eng
    eng.close(drain=False)


def _ref_last_logits(ref, seq):
    _, last = ref.prefill_fn(ref.state, jnp.asarray([seq], jnp.int32),
                             jnp.asarray([len(seq)], jnp.int32))
    return torch.from_numpy(np.array(last[0]))[None]


def _margin(x):
    top2 = torch.topk(x[0], 2).values
    return float(top2[0] - top2[1]) / max(1.0, abs(float(top2[0])))


def _spec_near_tie(ref_target, ref_draft, seq, t, params):
    """The smallest of the three decisions' closeness at generation index
    ``t`` after ``seq`` (prompt + common prefix), from the reference's own
    logits: the draft's perturbed top-2 margin, ``|u q(d) - p(d)|`` and
    the residual resample's perturbed margin."""
    knobs = ([params["temperature"]], [params.get("top_k", 0)],
             [params.get("top_p", 1.0)])
    seed, pos = [params["seed"]], [t]
    fd = S.filter_logits(_ref_last_logits(ref_draft, seq), *knobs)
    ft = S.filter_logits(_ref_last_logits(ref_target, seq), *knobs)
    q, p = S.probs_from_filtered(fd), S.probs_from_filtered(ft)
    g = S.gumbel(S.keys_for(seed, pos, S.SALT_TOKEN), fd.shape[-1])
    d = int(torch.argmax(fd + g))
    u = float(S.uniform_for(seed, pos, S.SALT_ACCEPT)[0])
    resid = torch.clamp(p - q, min=0.0)
    resid = resid / resid.sum() if float(resid.sum()) > 0 else p
    lr = torch.where(resid > 0, torch.log(resid), S.NEG)
    gr = S.gumbel(S.keys_for(seed, pos, S.SALT_RESID), fd.shape[-1])
    return min(_margin(fd + g), abs(u * float(q[0, d]) - float(p[0, d])),
               _margin(lr + gr))


def _departures(want, got, near_tie):
    """Token-equal up to the first parting, whose decision must be a
    near-tie (``near_tie(t)`` within the tolerance); returns 1 for a
    departure, 0 for equal streams."""
    n = min(len(want), len(got))
    t = next((i for i in range(n) if want[i] != got[i]), None)
    if t is None:
        assert len(want) == len(got)
        return 0
    closeness = near_tie(t)
    assert closeness <= TOL, (
        f"streams part at {t} where the decision is {closeness} from a tie")
    return 1


# -- the models ---------------------------------------------------------------

@pytest.mark.parametrize("cfg", [dict(layers=2, **SMALL),
                                 dict(vocab=64, dim=192, heads=2, layers=8)],
                         ids=["small", "loadgen_pair_width"])
def test_verify_fn_matches_reference(cfg):
    """The chunked decode on the same arena, lengths and chunk as the
    reference's, one lane with no history and one whose chunk reaches past
    the position table (both gathers clamp); at ``C == 1`` it computes
    ``decode_fn``'s logits and entries (bit for bit at the small width,
    where the products take the same path)."""
    ref = ref_serving.demo_model(max_len=64, seed=1, **cfg)
    lm = _port_of(ref)
    rng = np.random.RandomState(0)
    s, c, cap = 3, 5, 64
    arena = {n: rng.randn(s, cap, *tail).astype(np.float32)
             for n, (tail, _) in ref.kv_spec().items()}
    lengths = np.array([0, 7, 61], np.int32)
    chunk = rng.randint(0, ref.vocab, (s, c)).astype(np.int32)
    logits_r, entry_r = ref.verify_fn(
        ref.state, jnp.asarray(chunk),
        {k: jnp.asarray(v) for k, v in arena.items()}, jnp.asarray(lengths))
    arena_p = {k: torch.from_numpy(np.array(v)) for k, v in arena.items()}
    lens = torch.from_numpy(lengths).long()
    with torch.no_grad():
        logits_p, entry_p = lm.verify_fn(lm.state,
                                         torch.from_numpy(chunk).long(),
                                         arena_p, lens)
        one, one_entry = lm.verify_fn(lm.state,
                                      torch.from_numpy(chunk[:, :1]).long(),
                                      arena_p, lens)
        dec, dec_entry = lm.decode_fn(lm.state,
                                      torch.from_numpy(chunk[:, 0]).long(),
                                      arena_p, lens)
    assert logits_p.shape == (s, c, ref.vocab)
    assert _scaled(logits_p.numpy(), logits_r) <= TOL
    for name in entry_r:
        assert entry_p[name].shape == (s, c, ref.heads, ref.head_dim)
        assert _scaled(entry_p[name].numpy(), entry_r[name]) <= TOL
    assert _scaled(one[:, 0].numpy(), dec.numpy()) <= TOL
    for name in dec_entry:
        assert _scaled(one_entry[name][:, 0].numpy(),
                       dec_entry[name].numpy()) <= TOL
    if cfg["dim"] == SMALL["dim"]:
        assert torch.equal(one[:, 0], dec)


@pytest.mark.parametrize("c", [1, 2, 3, 4, 8])
def test_verify_fn_chunk_widths_match_reference(ref_model, model, c):
    """Each chunk width a ``spec_k`` gives the verify (C = k), on a lane
    with no history, one mid-arena and one whose chunk runs past the
    position table, against the reference's logits and cache entries."""
    rng = np.random.RandomState(c)
    cap = ref_model.max_len
    arena = {n: rng.randn(3, cap, *tail).astype(np.float32)
             for n, (tail, _) in ref_model.kv_spec().items()}
    lengths = np.array([0, 13, cap - 2], np.int32)
    chunk = rng.randint(0, ref_model.vocab, (3, c)).astype(np.int32)
    logits_r, entry_r = ref_model.verify_fn(
        ref_model.state, jnp.asarray(chunk),
        {k: jnp.asarray(v) for k, v in arena.items()}, jnp.asarray(lengths))
    with torch.no_grad():
        logits_p, entry_p = model.verify_fn(
            model.state, torch.from_numpy(chunk).long(),
            {k: torch.from_numpy(v) for k, v in arena.items()},
            torch.from_numpy(lengths).long())
    assert logits_p.shape == (3, c, ref_model.vocab)
    assert _scaled(logits_p.numpy(), logits_r) <= TOL
    assert set(entry_p) == set(entry_r)
    for name in entry_r:
        assert _scaled(entry_p[name].numpy(), entry_r[name]) <= TOL


@pytest.mark.parametrize("start", [0, 27, 31, 40])
def test_position_rows_clamp_as_the_reference_gathers(start):
    """``DemoLM._positions`` gives the rows the reference's gather of the
    position table gives (JAX clamps an index past the table to its last
    row), for chunks inside, across and wholly past a 32-row table."""
    ref = ref_serving.demo_model(max_len=32, seed=4, layers=1, **SMALL)
    lm = _port_of(ref)
    index = np.arange(start, start + 5)[None, :] + np.array([[0], [3]])
    want = np.asarray(ref.state["pos"][jnp.asarray(index)])
    got = lm._positions(lm.state, torch.from_numpy(index))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("cfg", [dict(extra_layers=1, distill=0.2, **SMALL),
                                 dict(vocab=64, dim=192, heads=2,
                                      extra_layers=7, distill=0.10)],
                         ids=["small", "loadgen_pair"])
def test_demo_spec_pair_shares_the_targets_tensors(cfg):
    """After conversion both models hold the reference pair's weights; the
    draft's tensors are the target's own (one copy loads both), and the
    draft converts from the reference draft's state as well."""
    ref_t, ref_d = ref_serving.demo_spec_pair(draft_layers=1, max_len=96,
                                              seed=1, **cfg)
    cfg = dict(cfg)
    extra, distill = cfg.pop("extra_layers"), cfg.pop("distill")
    target, draft = serving.demo_spec_pair(draft_layers=1,
                                           extra_layers=extra, max_len=96,
                                           seed=1, distill=distill,
                                           device="cpu", **cfg)
    assert (target.layers, draft.layers) == (ref_t.layers, ref_d.layers)
    assert set(draft.state) == set(ref_d.state) < set(target.state)
    # the port's own seeded weights: the refinement layers scaled
    lone = serving.demo_model(layers=target.layers, max_len=96, seed=1,
                              device="cpu", **cfg)
    assert torch.equal(target.wq1, lone.wq1 * distill)
    assert torch.equal(target.wq0, lone.wq0)
    convert.load_jax_state(target, _arrays(ref_t))
    for name, t in draft.state.items():
        assert t.data_ptr() == target.state[name].data_ptr(), name
        np.testing.assert_array_equal(t.numpy(), np.asarray(ref_d.state[name]))
    for name, t in target.state.items():
        np.testing.assert_array_equal(t.numpy(), np.asarray(ref_t.state[name]))
    assert draft.embed is target.embed and draft.pos is target.pos
    convert.load_jax_state(draft, _arrays(ref_d))
    assert draft.wq0 is target.wq0
    assert draft.kv_spec() == ref_d.kv_spec()
    assert serving.demo_spec_pair is serving.generate.demo_spec_pair


def test_hoisted_draws_equal_per_step_draws():
    """All k rows of a draft's Gumbel noise drawn in one call are, bit for
    bit, the per-step draws, and give the per-step tokens."""
    rng = np.random.RandomState(5)
    seeds = np.array([0, 7, 2 ** 32 - 1, 123456], np.uint32)
    positions = np.array([0, 3, 90, 2 ** 20], np.int32)
    k, v = 8, 64
    noise = S.gumbel_ahead(seeds, positions, k, v)
    assert noise.shape == (4, k, v) and noise.dtype == torch.float32
    filt = S.filter_logits(torch.from_numpy(rng.randn(4, v).astype(
        np.float32)), np.ones(4, np.float32), np.array([0, 5, 0, 9]),
        np.array([1.0, 1.0, 0.9, 0.8], np.float32))
    for i in range(k):
        keys = S.keys_for(seeds, positions + i, S.SALT_TOKEN)
        assert torch.equal(noise[:, i], S.gumbel(keys, v))
        assert torch.equal(torch.argmax(filt + noise[:, i], dim=-1),
                           S.sample_from_filtered(filt, seeds, positions + i))


@pytest.mark.parametrize("v", [32, 64, 97])
@pytest.mark.parametrize("k", [1, 2, 5, 8])
def test_hoisted_proposals_match_reference_draws(k, v):
    """A draft's k proposals taken from the noise drawn in one call are
    the reference's per-step draws (``sample_from_filtered`` at
    ``positions + i``), token for token, over greedy, plain and filtered
    rows."""
    rng = np.random.RandomState(100 * k + v)
    s = 12
    logits = (rng.randn(s, v) * 2).astype(np.float32)
    temps = rng.choice([0.0, 0.7, 1.0, 1.5], size=s).astype(np.float32)
    top_ks = rng.choice([0, 3, v // 2], size=s).astype(np.int32)
    top_ps = rng.choice([1.0, 0.9], size=s).astype(np.float32)
    seeds = rng.randint(0, 2 ** 31, size=s).astype(np.uint32)
    seeds[:2] = [0, 2 ** 32 - 1]
    positions = rng.randint(0, 200, size=s).astype(np.int32)
    filt = S.filter_logits(torch.from_numpy(logits), temps, top_ks, top_ps)
    noise = S.gumbel_ahead(seeds, positions, k, v)
    for i in range(k):
        got = torch.argmax(filt + noise[:, i], dim=-1).numpy()
        want = np.asarray(ref_sampling.sample_from_filtered(
            jnp.asarray(filt.numpy()), jnp.asarray(seeds),
            jnp.asarray(positions + i)))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", [1, 2, 3, 8])
def test_accept_prefix_matches_reference_at_spec_k(k):
    """The accept rule at each draft depth: rows whose target equals the
    draft accept all k; greedy (one-hot) rows accept the run of proposals
    equal to the target's argmax and resample that argmax at the first
    other; sampled rows take the reference's counts and tokens."""
    rng = np.random.RandomState(k)
    s, v = 16, 24

    def dist(*shape):
        x = rng.rand(*shape).astype(np.float32) ** 3
        return x / x.sum(-1, keepdims=True)

    q = dist(s, k, v)
    p = dist(s, k + 1, v)
    p[:4, :k] = q[:4]
    proposals = rng.randint(0, v, size=(s, k)).astype(np.int32)
    # greedy rows 4..7: one-hot target argmaxes, the proposals agreeing
    # for the first g positions of row 4 + g
    target = rng.randint(0, v, size=(s, k + 1))
    for row in range(4, 8):
        agree = min(row - 4, k)
        proposals[row] = (target[row, :k] + (np.arange(k) >= agree)) % v
        q[row] = np.eye(v, dtype=np.float32)[proposals[row]]
        p[row] = np.eye(v, dtype=np.float32)[target[row]]
    seeds = rng.randint(0, 2 ** 31, size=s).astype(np.uint32)
    pos0 = rng.randint(0, 100, size=s).astype(np.int32)
    a_ref, r_ref = ref_sampling.accept_prefix(
        jnp.asarray(p), jnp.asarray(q), jnp.asarray(proposals),
        jnp.asarray(seeds), jnp.asarray(pos0))
    a, r = S.accept_prefix(torch.from_numpy(p), torch.from_numpy(q),
                           torch.from_numpy(proposals), seeds, pos0)
    np.testing.assert_array_equal(a.numpy(), np.asarray(a_ref))
    np.testing.assert_array_equal(r.numpy(), np.asarray(r_ref))
    a, r = a.numpy(), r.numpy()
    assert (a[:4] == k).all()
    for row in range(4, 8):
        agree = min(row - 4, k)
        assert a[row] == agree
        if agree < k:
            assert r[row] == target[row, agree]


@pytest.mark.parametrize("mix,branch", [("greedy", False), ("plain", False),
                                        ("k_is_vocab", False),
                                        ("top_k", True), ("top_p", True)])
def test_filter_branch_from_host_knobs(mix, branch):
    """The engine hands the knobs over as tensors and the batch-wide
    branch from their host copies (``needs_filter``): the filtered logits
    are those of the host knobs alone, and the branch is the reference's
    (sort only where a row asks for top-k below the vocabulary or top-p
    below 1)."""
    rng = np.random.RandomState(len(mix))
    s, v = 6, 40
    logits = (rng.randn(s, v) * 2).astype(np.float32)
    temps = np.array([0.0, 1.0, 0.7, 1.3, 1.0, 0.5], np.float32)
    top_ks = np.zeros(s, np.int32)
    top_ps = np.ones(s, np.float32)
    if mix == "greedy":
        temps[:] = 0.0
    elif mix == "k_is_vocab":
        top_ks[2:] = v
    elif mix == "top_k":
        top_ks[3] = 5
    elif mix == "top_p":
        top_ps[4] = 0.8
    assert S.needs_filter(top_ks, top_ps, v) is branch
    host = S.filter_logits(torch.from_numpy(logits), temps, top_ks, top_ps)
    hinted = S.filter_logits(torch.from_numpy(logits),
                             torch.from_numpy(temps),
                             torch.from_numpy(top_ks),
                             torch.from_numpy(top_ps), any_filter=branch)
    assert torch.equal(hinted, host)
    ref = np.asarray(ref_sampling.filter_logits(
        jnp.asarray(logits), jnp.asarray(temps), jnp.asarray(top_ks),
        jnp.asarray(top_ps)))
    np.testing.assert_array_equal(host.numpy(), ref)


# -- exactness ----------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 2, 3, 4, 8])
def test_greedy_spec_equals_plain_for_any_draft(model, plain_eng, ref_model,
                                                ref_bad_draft, ref_streams,
                                                k):
    """Greedy: a proposal is kept iff it is the target's argmax, and a
    rejection resamples the argmax, so an unrelated draft gives the
    target's greedy stream; and the reference's greedy speculative
    stream."""
    bad = _port_of(ref_bad_draft)
    want = _drive(plain_eng, [(GREEDY_PROMPT, GREEDY_NEW, {})])[0]
    spec = _engine(model, draft=bad, k=k)
    spec.warmup()
    got = _drive(spec, [(GREEDY_PROMPT, GREEDY_NEW, {})])[0]
    st = spec.stats()
    spec.close(drain=False)
    assert got == want and len(got) == GREEDY_NEW
    assert st["verify_steps"] > 0 and st["spec_proposed"] > 0
    assert st["draft_steps"] == k * st["verify_steps"]
    _departures(ref_streams["greedy"], got, lambda t: _margin(
        _ref_last_logits(ref_model, GREEDY_PROMPT + got[:t])))


def test_sampled_self_draft_is_bit_identical(plain_eng, spec_eng):
    """A model drafting for itself proposes what plain sampling draws (the
    same keys) and the accept test always passes: the streams are plain
    sampling's bit for bit, filtered ones too."""
    jobs = [([7, 2], 12, {"sampling": c, "seed": 100 + i})
            for i, c in enumerate(CONFIGS)]
    want = _drive(plain_eng, jobs)
    st0 = spec_eng.stats()
    got = _drive(spec_eng, jobs)
    st1 = spec_eng.stats()
    assert got == want
    proposed = st1["spec_proposed"] - st0["spec_proposed"]
    assert st1["spec_accepted"] - st0["spec_accepted"] == proposed > 0


@pytest.mark.parametrize("k", [1, 2, 8])
def test_sampled_self_draft_is_bit_identical_at_any_depth(model, plain_eng,
                                                          k):
    """The self-draft's streams are plain sampling's bit for bit at every
    draft depth, with each of its proposals accepted."""
    jobs = [([4, 1], 10, {"sampling": c, "seed": 300 + i})
            for i, c in enumerate(CONFIGS)]
    want = _drive(plain_eng, jobs)
    spec = _engine(model, draft=model, k=k)
    spec.warmup()
    got = _drive(spec, jobs)
    st = spec.stats()
    spec.close(drain=False)
    assert got == want
    assert st["spec_accepted"] == st["spec_proposed"] > 0
    assert st["draft_steps"] == k * st["verify_steps"]


def test_sampled_pair_streams_match_reference(pair, ref_pair, ref_streams):
    """The distilled pair's sampled speculative streams against the
    reference's, token for token at the same seeds; a departure must sit
    on a near-tie of the reference's numbers, and is counted."""
    target, draft = pair
    eng = _engine(target, draft=draft, k=4)
    got = _drive(eng, PAIR_JOBS)
    st = eng.stats()
    eng.close(drain=False)
    departed = 0
    for (prompt, n, kw), want, g in zip(PAIR_JOBS, ref_streams["pair"], got):
        params = dict(kw["sampling"], seed=kw["seed"])
        departed += _departures(want, g, lambda t, p=prompt, g=g: (
            _spec_near_tie(ref_pair[0], ref_pair[1], p + g[:t], t, params)))
        assert len(g) == n
    assert departed <= len(PAIR_JOBS)
    assert 0 < st["spec_accepted"] <= st["spec_proposed"]


def test_eos_mid_chunk_truncates_the_stream(plain_eng, spec_eng):
    """An EOS inside an accepted chunk ends the stream at the EOS, as plain
    decode ends it."""
    probe = _drive(plain_eng, [([5, 9], 12, {"sampling": {
        "temperature": 1.3}, "seed": 7})])[0]
    eos = probe[len(probe) // 2]
    job = [([5, 9], 12, {"sampling": {"temperature": 1.3}, "seed": 7,
                         "eos_token": eos})]
    want = _drive(plain_eng, job)[0]
    assert want[-1] == eos and eos not in want[:-1]
    assert _drive(spec_eng, job)[0] == want


@pytest.mark.parametrize("speculative", [False, True])
def test_streams_reproducible_across_admission_orders(model, plain_eng,
                                                      spec_eng, speculative):
    """The same (prompt, params, seed) gives the same stream whenever it
    was admitted and whatever shared its batch, with speculation on or
    off."""
    eng = spec_eng if speculative else plain_eng
    reqs = [([2 + i, 5], {"temperature": 1.0, "top_k": 8}, 40 + i)
            for i in range(4)]
    together = _drive(eng, [(p, 12, {"sampling": c, "seed": s})
                            for p, c, s in reqs])
    eng2 = _engine(model, draft=model if speculative else None)
    eng2.warmup()
    staggered = {}
    for p, c, s in reversed(reqs):
        staggered[s] = eng2.submit(p, max_new_tokens=12, sampling=c, seed=s)
        eng2.tick()
    for _ in range(200):
        if all(f.done() for f in staggered.values()):
            break
        eng2.tick()
    eng2.close(drain=False)
    for (_, _, s), want in zip(reqs, together):
        assert list(map(int, staggered[s].result(timeout=10))) == want


# -- the engine's families and ledgers ----------------------------------------

def test_spec_warmup_and_churn_mint_no_signature(model):
    """Warmup meets the speculative family (a draft-then-verify step a
    capacity, the draft's insert, grow and prefill); churn meets nothing
    new, and every verify settles its ledgers by rollback."""
    eng = serving.GenerateEngine(model, slots=3, page=16, factor=2.0,
                                 max_len=64, prompt_buckets=(4, 8),
                                 start=False, shed=False, draft_model=model,
                                 spec_k=4)
    fresh = eng.warmup()
    # decode, sdraft and verify at 16, 32, 64; insert and dinsert at (4|8,
    # 16|32|64); grow and dgrow 16->32->64; prefill and dprefill at 4, 8
    assert fresh == 3 * 3 + 2 * 6 + 2 * 2 + 2 * 2 and eng.warmup() == 0
    before = eng.executables()
    rng = np.random.default_rng(0)
    futs = [eng.submit([2] * 8, max_new_tokens=50)]
    for i in range(12):
        samp = (None if i % 3 == 0 else
                {"temperature": 0.5 + 0.1 * i, "top_k": int(i % 5),
                 "top_p": 0.8 + 0.015 * i})
        futs.append(eng.submit(rng.integers(0, 32, size=1 + i % 7),
                               max_new_tokens=4 + i % 5, sampling=samp,
                               seed=i, eos_token=12 if i % 2 else None))
    for _ in range(300):
        if all(f.done() for f in futs):
            break
        eng.tick()
    assert len(futs[0].result(timeout=10)) == 50
    assert all(len(f.result(timeout=10)) >= 1 for f in futs)
    assert eng.executables() == before
    st = eng.stats()
    assert st["compiles"] == fresh and st["completed"] == len(futs)
    assert st["spec_accepted"] <= st["spec_proposed"]
    assert st["pool_rollbacks"] > 0 and st["pool_grows"] == 2
    assert eng.draft_pool.capacity == eng.pool.capacity == 64
    assert eng.draft_pool.allocated_bytes() == eng.draft_pool.bytes()
    assert [eng.draft_pool.length(s) for s in range(3)] == [0, 0, 0]
    eng.close()


def test_draft_pool_keeps_pace_to_the_brim(model):
    """A request at prompt + new == the arena's max_len under speculation:
    both arenas grow in lockstep, the chunk reaches past the arena near
    the budget (those writes are dropped), and the stream is the plain
    one."""
    plain = _engine(model, max_len=32)
    want = _drive(plain, [(list(range(1, 9)), 24, {})])[0]
    plain.close(drain=False)
    spec = _engine(model, draft=model, k=4, max_len=32)
    spec.warmup()
    assert spec.draft_pool.capacity == spec.pool.capacity == 16
    base = spec.executables()
    got = _drive(spec, [(list(range(1, 9)), 24, {})])[0]
    assert spec.pool.capacity == spec.draft_pool.capacity == 32
    assert spec.executables() == base
    spec.close(drain=False)
    assert len(got) == 24 and got == want


def test_arena_rows_below_each_lanes_length_match_reference(model, ref_model):
    """After each speculative tick the target's and the draft's arena rows
    below each lane's length hold what the reference's arenas hold, the
    lanes at the brim included (their writes past the arena dropped, never
    two onto one row)."""
    jobs = [(list(range(1, 9)), 8, {}), ([4, 2], 14, {}),
            ([9], 15, {"sampling": {"temperature": 1.0}, "seed": 3})]
    ref = RefEngine(ref_model, start=False, shed=False,
                    draft_model=ref_model, spec_k=4, **ENGINE)
    eng = _engine(model, draft=model, k=4)
    futs = [[e.submit(p, max_new_tokens=n, **kw) for p, n, kw in jobs]
            for e in (ref, eng)]
    for _ in range(40):
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
            assert eng.pool.length(s) == ref.pool.length(s) == n
            assert eng.draft_pool.length(s) == ref.draft_pool.length(s)
            for mine, theirs in ((eng.pool, ref.pool),
                                 (eng.draft_pool, ref.draft_pool)):
                for name, buf in mine.buffers.items():
                    assert _scaled(buf[s, :n].numpy(), np.asarray(
                        theirs.buffers[name][s, :n])) <= TOL
    assert [list(map(int, f.result(timeout=10))) for f in futs[1]] == \
        [list(map(int, f.result(timeout=10))) for f in futs[0]]
    ref.close(drain=False)
    eng.close(drain=False)


def test_spec_rejects_what_the_reference_rejects(model, ref_model):
    """spec_k < 1, a draft of another vocabulary and a target without
    ``verify_fn`` raise ``ValueError`` in both packages."""
    class NoVerify:
        def __init__(self, m):
            for name in ("vocab", "state", "device", "kv_spec",
                         "prefill_fn", "decode_fn", "max_len"):
                setattr(self, name, getattr(m, name))

    other_ref = ref_serving.demo_model(vocab=16, dim=16, heads=2, layers=1,
                                       max_len=64, seed=2)
    for m, other, make in (
            (ref_model, other_ref, lambda m, **kw: RefEngine(
                m, start=False, **ENGINE, **kw)),
            (model, _port_of(other_ref), lambda m, draft_model, spec_k=4:
             _engine(m, draft=draft_model, k=spec_k))):
        with pytest.raises(ValueError, match="vocab"):
            make(m, draft_model=other)
        with pytest.raises(ValueError, match="spec_k"):
            make(m, draft_model=m, spec_k=0)
        with pytest.raises(ValueError, match="verify_fn"):
            make(NoVerify(m), draft_model=m)


def test_position_clamp_at_the_models_max_len():
    """Model max_len equal to the engine's, prompt + new equal to both: the
    verify chunk and the draft loop reach positions past the table near
    the budget. The gathers clamp there (without the clamp the gather
    raises ``IndexError``), the request completes, and its stream is the
    plain one."""
    lm = serving.demo_model(max_len=32, seed=4, layers=2, device="cpu",
                            **SMALL)
    prompt = list(range(1, 9))
    plain = _engine(lm, max_len=32)
    want = _drive(plain, [(prompt, 24, {})])[0]
    plain.close(drain=False)
    spec = _engine(lm, draft=lm, k=4, max_len=32)
    assert spec.seq_limit == 32
    got = _drive(spec, [(prompt, 24, {}), (prompt[:5], 27, {
        "sampling": {"temperature": 1.0}, "seed": 9})])
    st = spec.stats()
    spec.close(drain=False)
    assert st["failed"] == 0 and [len(g) for g in got] == [24, 27]
    assert got[0] == want
    # the reach past the table: a chunk at length 30 covers positions 30
    # .. 34 of a 32-row table, and the rows past it read the last
    with torch.no_grad():
        arena = {n: torch.zeros(1, 32, *t) for n, (t, _) in
                 lm.kv_spec().items()}
        logits, _ = lm.verify_fn(lm.state, torch.ones(1, 5, dtype=torch.long),
                                 arena, torch.tensor([30]))
    assert torch.isfinite(logits).all()
    with pytest.raises(IndexError):
        lm.state["pos"][torch.tensor([30]) + torch.arange(5)]


# -- the load generator -------------------------------------------------------

def test_loadgen_spec_arm_reports_and_self_draft_matches_plain():
    """``run_load`` with a draft returns the speculative keys; under a
    self-draft its streams are ``draft=None``'s; and ``main --spec`` runs
    the A/B on the CPU."""
    lm = serving.demo_model(vocab=64, dim=16, heads=2, layers=2, max_len=96,
                            seed=1, device="cpu")
    wl = LG.make_workload(10, LG.PROMPT_BUCKETS, 96, seed=0)
    sampling = {"temperature": 1.0}
    runs = {name: LG.run_load(lm, "continuous", wl, 4, 96,
                              LG.PROMPT_BUCKETS, sampling=sampling,
                              seed_base=1000, draft=d, spec_k=4)
            for name, d in (("plain", None), ("spec", lm))}
    plain, spec = runs["plain"], runs["spec"]
    assert "accept_rate" not in plain
    for key in ("spec_k", "verify_steps", "accept_rate",
                "spec_tokens_per_step", "pool_rollbacks"):
        assert key in spec, key
    assert spec["spec_k"] == 4 and spec["verify_steps"] == spec["ticks"]
    assert spec["tokens"] == plain["tokens"] == sum(n for _, n in wl)
    assert spec["post_warmup_signatures"] == 0 and spec["failed"] == 0
    assert [list(o) for o in spec["outputs"]] == \
        [list(o) for o in plain["outputs"]]
    assert spec["accept_rate"] == 1.0 and spec["launches"] == {}


def test_loadgen_main_spec_on_the_cpu(capsys):
    import json
    assert LG.main(["--spec", "--device", "cpu", "--requests", "6",
                    "--slots", "4", "--spec-k", "4", "--draft", "self"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["sampling"] == {"temperature": 1.0}
    assert out["spec"]["accept_rate"] == out["accept_rate"] == 1.0
    assert out["spec"]["tokens"] == out["nonspec"]["tokens"]
    assert out["spec_speedup_x"] > 0 and "card" not in out


def test_cpu_spec_prefill_launches_no_kernel(pair):
    target, draft = pair
    kernels.reset_launches()
    eng = _engine(target, draft=draft, k=4)
    _drive(eng, [([1, 2, 3], 5, {})])
    eng.close()
    assert kernels.launches["flash_attention_fwd"] == 0
