"""The KV hand-off within one engine (``paddle_tpu_torch.serving``:
``KVCachePool.export_slot``/``import_slot``, ``GenerateEngine(kv_import=
True)``, ``DecodeRequest.preset``, ``disown_inflight``, ``steal_pending``,
``requeue``, ``submit_request(admit=False)``) against the JAX package's,
on the CPU.

Rules, each with its reason:

* a segment is the reference's format, so one dict moves between the two
  packages' pools; its leaves move bit for bit, with the same byte
  accounting and the same errors (the reference's cases,
  ``tests/test_disagg.py:50-100``);
* a lane exported mid-stream and seated in a ``kv_import=True`` engine
  continues at the same ledger length and generation index (the
  reference's claim, ``paddle_tpu/serving/generate.py:942-948``). The
  moved streams are held to the reference's streams of the same requests
  run without a move: sampled token for token (the draws are the
  reference's bits); greedy token for token up to the first parting, which
  must sit on a near-tie (top-2 margin within 1e-5 scaled) of the
  reference's own logits, and is counted;
* a drafted engine seats an imported lane with its draft ledger at 0, as
  the reference's does (its draft arena is not carried): greedy output is
  still the plain greedy stream (the verify keeps it exact), while a
  sampled lane's draws meet another draft distribution and its stream is
  not the unmoved one, in the reference too (ROADMAP.md Queue C). The
  port's sampled drafted hand-off is held to the reference's own hand-off
  of the same requests at the same cut, token for token;
* a bare move (no ``export_kv``) re-prefills and regenerates the clean
  stream (``tests/test_spec_decode.py:220-250``).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from paddle_tpu import serving as ref_serving
from paddle_tpu.serving.generate import GenerateEngine as RefEngine
from paddle_tpu.serving.kv_cache import KVCachePool as RefPool
from paddle_tpu_torch import convert, serving
from paddle_tpu_torch.serving.kv_cache import KVCachePool, bytes_per_token

TOL = 1e-5
SPEC = {"k0": ((2, 4), "float32"), "v0": ((2, 4), "float32")}
SAMPLED = {"temperature": 1.0, "top_k": 8, "top_p": 0.9}
# several capacities (16, 32, 64) and prompt buckets that are not all of
# them: a moved lane's pad is a capacity bucket (32 here) a prompt never
# takes
PLAIN_ENGINE = dict(slots=2, page=16, factor=2.0, max_len=64,
                    prompt_buckets=(4, 8, 16), shed=False)
PLAIN_JOBS = [([1, 2, 3], 12), ([7] * 11, 40), ([5, 4, 3, 2, 1, 9, 8], 12)]
PLAIN_CUTS = (1, 4, 8)
# the reference's single-capacity speculative engine
# (tests/test_spec_decode.py:42-48)
SPEC_ENGINE = dict(slots=2, page=16, max_len=16, prompt_buckets=(16,),
                   shed=False)
SPEC_JOBS = [([7, 2], 12), ([3, 1, 4], 12), ([5, 9, 2, 6], 10)]
SPEC_CUTS = (1, 2)
K = 4


def _segment(pad, length=None, fill=None):
    """A well-formed segment for SPEC."""
    length = pad if length is None else length
    rng = np.random.RandomState(0 if fill is None else fill)
    leaves = {name: rng.rand(pad, *tail).astype(np.float32)
              for name, (tail, _dt) in SPEC.items()}
    return {"length": length, "pad": pad,
            "bytes": sum(a.nbytes for a in leaves.values()),
            "leaves": leaves}


def _pool(cls, slots, page, max_len=64):
    kw = {} if cls is RefPool else {"device": "cpu"}
    return cls(SPEC, slots=slots, page=page, factor=2.0, max_len=max_len,
               **kw)


def _arrays(ref):
    return {k: np.asarray(v) for k, v in ref.state.items()}


def _port_of(ref):
    lm = serving.demo_model(vocab=ref.vocab, dim=ref.dim, heads=ref.heads,
                            layers=ref.layers, max_len=ref.max_len,
                            device="cpu")
    return convert.load_jax_state(lm, _arrays(ref))


def _jobs(jobs, sampled):
    return [(p, n, {"sampling": SAMPLED, "seed": 31 + i} if sampled else {})
            for i, (p, n) in enumerate(jobs)]


def _drive(engine, futs, ticks=500):
    for _ in range(ticks):
        if all(f.done() for f in futs):
            break
        engine.tick()
    return [list(map(int, f.result(timeout=10))) for f in futs]


def _handoff(make_a, make_b, jobs, cut, export_kv=True, via="requeue"):
    """Submit ``jobs`` to engine A, tick it ``cut`` times, move every
    request (live lanes exported with ``export_kv``, queued ones bare) to
    a warmed engine B, and drive B. Returns (streams, A, B, moved, the
    signatures B met after its warmup)."""
    a = make_a()
    futs = [a.submit(p, max_new_tokens=n, **kw) for p, n, kw in jobs]
    for _ in range(cut):
        a.tick()
    moved = a.disown_inflight(export_kv=export_kv) + a.steal_pending()
    a.close(drain=False)
    b = make_b()
    b.warmup()
    before = b.executables()
    if via == "requeue":
        b.requeue(moved)
    else:
        for r in moved:
            b.submit_request(r, admit=False)
    streams = _drive(b, futs)
    after = b.executables()
    b.close(drain=False)
    return streams, a, b, moved, (after[0] - before[0]) + (after[1]
                                                          - before[1])


def _departures(ref_model, jobs, want, got):
    """Greedy streams: token-equal up to the first parting, which must be
    a near-tie of the reference's own logits; returns the count."""
    parted = 0
    for (prompt, _, _), w, g in zip(jobs, want, got):
        assert len(w) == len(g)
        t = next((i for i in range(len(w)) if w[i] != g[i]), None)
        if t is None:
            continue
        seq = list(prompt) + w[:t]
        _, last = ref_model.prefill_fn(ref_model.state,
                                       jnp.asarray([seq], jnp.int32),
                                       jnp.asarray([len(seq)], jnp.int32))
        top2 = np.sort(np.asarray(last[0]))[-2:]
        assert top2[1] - top2[0] <= TOL * max(1.0, abs(float(top2[1]))), (
            f"streams part at {t}, margin {top2[1] - top2[0]}")
        parted += 1
    return parted


@pytest.fixture(scope="module")
def ref_model():
    return ref_serving.demo_model(vocab=32, dim=16, heads=2, layers=2,
                                  max_len=64, seed=1)


@pytest.fixture(scope="module")
def model(ref_model):
    return _port_of(ref_model)


@pytest.fixture(scope="module")
def ref_pair():
    return ref_serving.demo_spec_pair(vocab=32, dim=16, heads=2,
                                      draft_layers=1, extra_layers=1,
                                      max_len=64, seed=1, distill=0.2)


@pytest.fixture(scope="module")
def pair(ref_pair):
    target, draft = serving.demo_spec_pair(vocab=32, dim=16, heads=2,
                                           draft_layers=1, extra_layers=1,
                                           max_len=64, seed=1, distill=0.2,
                                           device="cpu")
    convert.load_jax_state(target, _arrays(ref_pair[0]))
    return target, draft


@pytest.fixture(scope="module")
def ref_plain_streams(ref_model):
    """The reference's unmoved streams of PLAIN_JOBS, greedy and sampled."""
    out = {}
    for sampled in (False, True):
        eng = RefEngine(ref_model, start=False, **PLAIN_ENGINE)
        jobs = _jobs(PLAIN_JOBS, sampled)
        out[sampled] = _drive(eng, [eng.submit(p, max_new_tokens=n, **kw)
                                    for p, n, kw in jobs])
        eng.close(drain=False)
    return out


@pytest.fixture(scope="module")
def ref_spec_streams(ref_pair):
    """The reference target's unmoved greedy streams of SPEC_JOBS, without
    a draft (greedy speculation gives them for any draft), and the
    reference's sampled drafted hand-off at each cut."""
    target, draft = ref_pair
    eng = RefEngine(target, start=False, **SPEC_ENGINE)
    jobs = _jobs(SPEC_JOBS, False)
    greedy = _drive(eng, [eng.submit(p, max_new_tokens=n, **kw)
                          for p, n, kw in jobs])
    eng.close(drain=False)
    moved = {}
    for cut in SPEC_CUTS:
        moved[cut] = _handoff(
            lambda: RefEngine(target, start=False, draft_model=draft,
                              spec_k=K, **SPEC_ENGINE),
            lambda: RefEngine(target, start=False, draft_model=draft,
                              spec_k=K, kv_import=True, **SPEC_ENGINE),
            _jobs(SPEC_JOBS, True), cut)[0]
    return {"greedy": greedy, "moved_sampled": moved}


# -- the segment transport ----------------------------------------------------

@pytest.mark.parametrize("cls", [KVCachePool, RefPool],
                         ids=["port", "reference"])
def test_export_import_roundtrip_exact_bytes(cls):
    """The reference's round trip, on each package's pool."""
    src = _pool(cls, 2, 32)
    s = src.alloc()
    seg_in = _segment(16, length=10, fill=7)
    src.import_slot(s, seg_in)
    assert src.length(s) == 10
    before = src.allocated_bytes()
    seg = src.export_slot(s, pad_to=32)
    assert src.allocated_bytes() == before       # export never resizes
    assert seg["length"] == 10 and seg["pad"] == 32
    assert seg["bytes"] == bytes_per_token(SPEC) * 32
    for name, (tail, _dt) in SPEC.items():
        assert seg["leaves"][name].shape == (32, *tail)
        assert seg["leaves"][name].dtype == np.float32
        np.testing.assert_array_equal(seg["leaves"][name][:16],
                                      seg_in["leaves"][name])
        np.testing.assert_array_equal(seg["leaves"][name][16:], 0.0)
    dst = _pool(cls, 2, 32)
    d = dst.alloc()
    before = dst.allocated_bytes()
    assert dst.import_slot(d, seg) == seg["bytes"]
    assert dst.allocated_bytes() == before       # import never resizes
    assert dst.length(d) == 10                   # ledger through note_length
    again = dst.export_slot(d)
    assert again["pad"] == 10
    for name in SPEC:
        np.testing.assert_array_equal(again["leaves"][name],
                                      seg["leaves"][name][:10])


def _oversize_insert(buffers, chunk, slot):
    """An insert that resizes the arena: the import must refuse it."""
    for name in list(buffers):
        buffers[name] = torch.zeros((buffers[name].shape[0],
                                     buffers[name].shape[1] * 2)
                                    + tuple(buffers[name].shape[2:]))


ERROR_CASES = {
    "export_pad_below_length": (ValueError, "pad 8 < live length 12"),
    "export_pad_above_capacity": (ValueError, "exceeds arena capacity"),
    "import_pad_above_capacity": (ValueError, "exceeds arena capacity"),
    "import_missing_leaf": (ValueError, "leaves"),
    "import_extra_leaf": (ValueError, "leaves"),
    "import_byte_drift": (AssertionError, "byte accounting"),
    "import_footprint_change": (AssertionError, "footprint"),
}


def _error_case(pool, case):
    s = pool.alloc()
    pool.note_length(s, 12)
    if case == "export_pad_below_length":
        pool.export_slot(s, pad_to=8)
    elif case == "export_pad_above_capacity":
        pool.export_slot(s, pad_to=128)
    elif case == "import_pad_above_capacity":
        pool.import_slot(s, _segment(128))
    elif case == "import_missing_leaf":
        bad = _segment(16)
        bad["leaves"] = {"k0": bad["leaves"]["k0"]}
        pool.import_slot(s, bad)
    elif case == "import_extra_leaf":
        bad = _segment(16)
        bad["leaves"]["k1"] = bad["leaves"]["k0"]
        pool.import_slot(s, bad)
    elif case == "import_byte_drift":
        short = _segment(16)
        short["leaves"]["k0"] = short["leaves"]["k0"][:8]
        pool.import_slot(s, short)
    elif case == "import_footprint_change":
        if isinstance(pool, RefPool):
            def grow(buffers, chunk, slot):
                return {n: jnp.zeros((b.shape[0], b.shape[1] * 2)
                                     + b.shape[2:]) for n, b in
                        buffers.items()}
            pool.import_slot(s, _segment(16), insert_fn=grow)
        else:
            pool.import_slot(s, _segment(16), insert_fn=_oversize_insert)


@pytest.mark.parametrize("case", sorted(ERROR_CASES))
def test_export_import_errors_match_reference(case):
    """Every check the reference makes, with its exception type and
    message, on both pools; a failed import leaves the ledger alone."""
    exc, match = ERROR_CASES[case]
    for cls in (RefPool, KVCachePool):
        pool = _pool(cls, 1, 16)
        with pytest.raises(exc, match=match):
            _error_case(pool, case)
        if case != "import_footprint_change":
            assert pool.length(0) == 12


@pytest.mark.parametrize("direction", ["reference_to_port",
                                       "port_to_reference"])
@pytest.mark.parametrize("length,pad", [(10, 16), (16, 16), (19, 32)])
def test_segment_moves_between_packages(direction, length, pad):
    """A segment exported by one package's pool lands in the other's
    bit for bit, with the same length, pad and bytes; exported back, it
    is the same segment."""
    src_cls, dst_cls = ((RefPool, KVCachePool)
                        if direction == "reference_to_port"
                        else (KVCachePool, RefPool))
    src = _pool(src_cls, 2, 16)
    s = src.alloc()
    src.alloc()
    src.grow_to(32, (lambda b, o, n: {k: jnp.pad(v, ((0, 0), (0, n - o),
                                                     (0, 0), (0, 0)))
                                      for k, v in b.items()})
                if src_cls is RefPool else
                (lambda b, o, n: {k: torch.cat([v, torch.zeros(
                    (v.shape[0], n - o) + tuple(v.shape[2:]))], 1)
                    for k, v in b.items()}))
    src.import_slot(1, _segment(32, length=32, fill=3))
    src.import_slot(s, _segment(pad, length=length, fill=5))
    seg = src.export_slot(s, pad_to=pad)
    assert seg["bytes"] == bytes_per_token(SPEC) * pad
    dst = _pool(dst_cls, 3, 32)
    dst.alloc()
    d = dst.alloc()
    assert dst.import_slot(d, seg) == seg["bytes"]
    assert dst.length(d) == length
    back = dst.export_slot(d, pad_to=pad)
    assert (back["length"], back["pad"], back["bytes"]) == (
        seg["length"], seg["pad"], seg["bytes"])
    for name in SPEC:
        np.testing.assert_array_equal(back["leaves"][name],
                                      seg["leaves"][name])
        np.testing.assert_array_equal(
            seg["leaves"][name], _segment(pad, length, fill=5)[
                "leaves"][name])
    # the neighbouring lane is untouched
    np.testing.assert_array_equal(dst.export_slot(0, pad_to=32)["leaves"]
                                  ["k0"], 0.0)


# -- the engine's hand-off ----------------------------------------------------

def _plain_engines(model, kv_import=True):
    return (lambda: serving.GenerateEngine(model, start=False,
                                           **PLAIN_ENGINE),
            lambda: serving.GenerateEngine(model, start=False,
                                           kv_import=kv_import,
                                           **PLAIN_ENGINE))


@pytest.mark.parametrize("via", ["requeue", "submit_request"])
@pytest.mark.parametrize("cut", PLAIN_CUTS)
@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_moved_lanes_continue_the_unmoved_stream(model, ref_model,
                                                 ref_plain_streams, sampled,
                                                 cut, via):
    """Live lanes exported at ``cut`` ticks and queued requests moved bare,
    into a warmed ``kv_import=True`` engine: every stream is the
    reference's unmoved one (sampled token for token, greedy up to counted
    near-ties); B imports each exported lane without a prefill, prefills
    only the bare ones, and meets no signature after its warmup."""
    jobs = _jobs(PLAIN_JOBS, sampled)
    got, a, b, moved, fresh = _handoff(*_plain_engines(model), jobs, cut,
                                       via=via)
    exported = [r for r in moved if r.preset is not None]
    assert exported and len(moved) == len(PLAIN_JOBS) - a.stats()[
        "completed"]
    st = b.stats()
    assert st["kv_imports"] == len(exported)
    assert st["prefills"] == len(moved) - len(exported)
    assert fresh == 0
    for r in exported:
        seg = r.preset["segment"]
        assert seg["bytes"] == bytes_per_token(model.kv_spec()) * seg["pad"]
        assert seg["pad"] == a.pool.capacity_for(seg["length"])
        assert seg["length"] == r.preset["prompt_len"] + len(
            r.preset["tokens"]) - 1
    want = ref_plain_streams[sampled]
    if sampled:
        assert got == want
    else:
        assert _departures(ref_model, jobs, want, got) <= len(jobs)


def test_a_pad_beyond_the_prompt_buckets_is_warmed_only_by_kv_import(
        model):
    """The long lane's segment is padded to capacity 32, no prompt bucket:
    without ``kv_import`` its insert is a signature traffic meets first,
    with it warmup met it."""
    jobs = _jobs(PLAIN_JOBS, False)
    pads = {}
    for kv_import in (False, True):
        got, _a, _b, moved, fresh = _handoff(
            *_plain_engines(model, kv_import=kv_import), jobs, 8)
        pads[kv_import] = sorted(r.preset["segment"]["pad"] for r in moved
                                 if r.preset is not None)
        assert (fresh > 0) == (not kv_import)
    assert 32 in pads[True] and pads[False] == pads[True]


def test_kv_import_warmup_meets_the_references_family(model, ref_model):
    """A ``kv_import`` engine's warmup meets the reference's executables:
    its prompt buckets' and every capacity pad's inserts."""
    ref = RefEngine(ref_model, start=False, kv_import=True, **PLAIN_ENGINE)
    port = serving.GenerateEngine(model, start=False, kv_import=True,
                                  **PLAIN_ENGINE)
    plain = serving.GenerateEngine(model, start=False, **PLAIN_ENGINE)
    try:
        assert port.warmup() == ref.warmup()
        assert port.warmup("ignored", [((4,), "int32")]) == 0
        inserts = sorted(k for k in port._exec if k[0] == "insert")
        assert inserts == sorted(k for k in ref._exec if k[0] == "insert")
        plain.warmup()
        assert {k for k in port._exec} - {k for k in plain._exec} == {
            ("insert", 32, 32), ("insert", 32, 64), ("insert", 64, 64)}
    finally:
        ref.close(drain=False)
        port.close(drain=False)
        plain.close(drain=False)


@pytest.mark.parametrize("cut", SPEC_CUTS)
def test_drafted_greedy_hand_off_is_the_plain_greedy_stream(
        pair, ref_pair, ref_spec_streams, cut):
    """Into a drafted ``kv_import`` engine: the imported lane's draft
    ledger starts at 0, as in the reference, and greedy output is still
    the plain greedy stream."""
    target, draft = pair
    jobs = _jobs(SPEC_JOBS, False)

    def make(kv_import):
        return lambda: serving.GenerateEngine(
            target, start=False, draft_model=draft, spec_k=K,
            kv_import=kv_import, **SPEC_ENGINE)

    got, _a, b, moved, fresh = _handoff(make(False), make(True), jobs, cut)
    assert fresh == 0
    assert b.stats()["kv_imports"] == sum(r.preset is not None
                                          for r in moved) > 0
    assert _departures(ref_pair[0], jobs, ref_spec_streams["greedy"],
                       got) <= len(jobs)


def test_imported_lane_starts_with_its_draft_ledger_at_zero(pair, ref_pair):
    """Seating an exported lane: the target ledger is the exported length,
    the draft ledger 0, in both packages."""
    seated = {}
    for name, (target, draft), cls in (("port", pair, serving.GenerateEngine),
                                       ("reference", ref_pair, RefEngine)):
        a = cls(target, start=False, draft_model=draft, spec_k=K,
                **SPEC_ENGINE)
        a.submit([7, 2], max_new_tokens=12)
        a.tick()
        moved = a.disown_inflight(export_kv=True)
        a.close(drain=False)
        b = cls(target, start=False, draft_model=draft, spec_k=K,
                kv_import=True, **SPEC_ENGINE)
        b.requeue(moved)
        b._admit()
        seated[name] = (b.pool.length(0), b.draft_pool.length(0),
                        moved[0].preset["segment"]["length"])
        b.close(drain=False)
    assert seated["port"] == seated["reference"]
    length, dlength, exported = seated["port"]
    assert length == exported > 2 and dlength == 0


@pytest.mark.parametrize("cut", SPEC_CUTS)
def test_drafted_sampled_hand_off_matches_the_references(
        pair, ref_spec_streams, cut):
    """A sampled drafted lane after an import draws against a draft that
    lost its history, in both packages alike: the port's moved streams are
    the reference's moved streams, token for token."""
    target, draft = pair

    def make(kv_import):
        return lambda: serving.GenerateEngine(
            target, start=False, draft_model=draft, spec_k=K,
            kv_import=kv_import, **SPEC_ENGINE)

    got, _a, b, moved, fresh = _handoff(make(False), make(True),
                                        _jobs(SPEC_JOBS, True), cut)
    assert fresh == 0 and any(r.preset is not None for r in moved)
    assert got == ref_spec_streams["moved_sampled"][cut]
    st = b.stats()
    assert 0 < st["spec_accepted"] <= st["spec_proposed"]


@pytest.mark.parametrize("speculative", [False, True])
def test_failover_requeue_reprefills_the_clean_stream(model, speculative):
    """The reference's failover case: in-flight sequences disowned bare
    and requeued on a second engine re-prefill and regenerate the stream
    a clean run gives, sampled, plain or speculative."""
    eng = dict(SPEC_ENGINE, slots=4)
    draft = model if speculative else None
    a = serving.GenerateEngine(model, start=False, draft_model=draft,
                               spec_k=K, **eng)
    a.warmup()
    fut = a.submit([11, 3, 8], max_new_tokens=12,
                   sampling={"temperature": 0.9, "top_p": 0.95}, seed=77)
    for _ in range(2):
        a.tick()
    assert not fut.done()
    moved = a.disown_inflight() + a.steal_pending()
    assert len(moved) == 1 and moved[0].preset is None
    a.close(drain=False)
    b = serving.GenerateEngine(model, start=False, draft_model=draft,
                               spec_k=K, **eng)
    b.warmup()
    b.requeue(moved)
    got = _drive(b, [fut])[0]
    want = _drive(b, [b.submit([11, 3, 8], max_new_tokens=12,
                               sampling={"temperature": 0.9, "top_p": 0.95},
                               seed=77)])[0]
    assert b.stats()["kv_imports"] == 0
    b.close(drain=False)
    assert got == want


def test_requeue_on_a_closed_engine_fails_the_futures(model):
    a = serving.GenerateEngine(model, start=False, **PLAIN_ENGINE)
    futs = [a.submit(p, max_new_tokens=n) for p, n in PLAIN_JOBS]
    a.tick()
    moved = a.disown_inflight(export_kv=True) + a.steal_pending()
    assert len(moved) == 3 and a.pool.free_slots() == 2
    a.close(drain=False)
    b = serving.GenerateEngine(model, start=False, kv_import=True,
                               **PLAIN_ENGINE)
    b.close()
    b.requeue(moved)
    for f in futs:
        with pytest.raises(RuntimeError, match="closed"):
            f.result(timeout=10)
    b.requeue([])


def test_submit_request_admit_false_skips_the_ladder(model):
    """A handed-over request is not charged twice: with the queue at its
    cap, ``admit=False`` enqueues where ``admit=True`` rejects."""
    from paddle_tpu_torch.serving import QueueFullError
    eng = serving.GenerateEngine(model, start=False, queue_depth=1,
                                 **PLAIN_ENGINE)
    eng.submit([1, 2], max_new_tokens=2)
    req = eng.make_request([3], max_new_tokens=2)
    with pytest.raises(QueueFullError):
        eng.submit_request(req)
    fut = eng.submit_request(req, admit=False)
    assert eng.depth() == 2 and eng.stats()["rejected"] == 1
    assert len(_drive(eng, [fut])[0]) == 2
    eng.close()


def test_disown_frees_every_lane_and_both_ledgers(model):
    """``disown_inflight`` frees every lane and leaves the pool's ledger
    and the draft ledger at 0; an engine with nothing in flight hands
    over nothing."""
    a = serving.GenerateEngine(model, start=False, draft_model=model,
                               spec_k=2, **SPEC_ENGINE)
    assert a.disown_inflight(export_kv=True) == [] == a.steal_pending()
    a.submit([1, 2, 3], max_new_tokens=8)
    a.tick()
    (req,) = a.disown_inflight(export_kv=True)
    assert a.pool.free_slots() == 2
    assert a.pool.length(0) == 0 and a.draft_pool.length(0) == 0
    assert req.preset["tokens"][-1] == req.preset["last_token"]
    a.close()
