"""The port's KV-cache pool and bucket family
(``paddle_tpu_torch.serving.kv_cache``, ``io.bucketing.grow_buckets``)
against the JAX package's, on the CPU. The pool is host bookkeeping over
device buffers, so the two are held for equal values: families, slot
ledgers, capacity schedules and byte counts, and the budget verdicts at
the same budget."""
import jax.numpy as jnp
import pytest
import torch

from paddle_tpu.io.bucketing import grow_buckets as ref_grow_buckets
from paddle_tpu.serving import kv_cache as R
from paddle_tpu_torch.io.bucketing import grow_buckets
from paddle_tpu_torch.serving import kv_cache as P

SPEC = {"k0": ((2, 8), "float32"), "v0": ((2, 8), "float32")}
SPEC_MIXED = {"k0": ((4, 16), "float32"), "v0": ((4, 16), "bfloat16"),
              "k1": ((3,), "int32")}


def _jax_grow(bufs, old, new):
    return {k: jnp.pad(v, [(0, 0), (0, new - old)] + [(0, 0)] * (v.ndim - 2))
            for k, v in bufs.items()}


def _torch_grow(bufs, old, new):
    return {k: torch.nn.functional.pad(v, [0, 0] * (v.dim() - 2)
                                       + [0, new - old])
            for k, v in bufs.items()}


@pytest.mark.parametrize("base", [1, 3, 16, 32, 64])
@pytest.mark.parametrize("factor", [1.01, 1.3, 1.5, 2.0, 3.0])
def test_grow_buckets_equals_reference(base, factor):
    for cap in (base, base + 1, base * 7, 96, 512, 1024):
        if cap < base:
            continue
        fam = grow_buckets(base, factor, cap)
        assert fam == ref_grow_buckets(base, factor, cap)
        assert isinstance(fam, tuple) and fam[0] == base and fam[-1] >= cap
        assert all(isinstance(b, int) for b in fam)
        assert all(b < a for b, a in zip(fam, fam[1:]))
    assert grow_buckets(32, 2.0, 512) == (32, 64, 128, 256, 512)


@pytest.mark.parametrize("args", [(0, 2.0, 8), (8, 1.0, 64), (8, 0.5, 64),
                                  (8, 2.0, None), (8, 2.0, 4)])
def test_grow_buckets_rejects_what_the_reference_rejects(args):
    with pytest.raises(ValueError) as ref:
        ref_grow_buckets(*args)
    with pytest.raises(ValueError) as got:
        grow_buckets(*args)
    assert str(got.value) == str(ref.value)


def _pools(**kw):
    return (R.KVCachePool(SPEC, **kw),
            P.KVCachePool(SPEC, device="cpu", **kw))


def test_pool_slot_cycle_and_double_free():
    ref, pool = _pools(slots=3, page=16, max_len=32)
    for p in (ref, pool):
        got = [p.alloc() for _ in range(3)]
        assert got == [0, 1, 2] and p.alloc() is None
        assert p.used_slots() == 3 and p.free_slots() == 0
        p.note_length(1, 9)
        assert p.length(1) == 9
        p.free(1)
        assert p.length(1) == 0 and p.alloc() == 1
        p.free(1)
        with pytest.raises(ValueError):
            p.free(1)
        with pytest.raises(ValueError):
            p.note_length(0, 17)       # past the capacity
    with pytest.raises(ValueError):
        P.KVCachePool(SPEC, slots=0, device="cpu")


def test_pool_rollback_matches_reference():
    ref, pool = _pools(slots=2, page=16, max_len=32)
    for p in (ref, pool):
        s = p.alloc()
        p.note_length(s, 12)
        assert p.rollback(s, 7) == 5 and p.length(s) == 7
        assert p.rollback(s, 7) == 0
        with pytest.raises(ValueError):
            p.rollback(s, 8)           # would grow
        with pytest.raises(ValueError):
            p.rollback(s, -1)
    assert pool.stats() == ref.stats()


def test_pool_capacity_schedule_and_bytes():
    ref, pool = _pools(slots=4, page=16, factor=2.0, max_len=64)
    assert pool.seq_buckets == ref.seq_buckets == (16, 32, 64)
    for n in (1, 16, 17, 33, 64):
        assert pool.capacity_for(n) == ref.capacity_for(n)
        assert pool.needs_growth(n) == ref.needs_growth(n)
    with pytest.raises(ValueError):
        pool.capacity_for(65)
    with pytest.raises(ValueError):
        pool.grow_to(48, _torch_grow)  # not in the family
    per_tok = P.bytes_per_token(SPEC)
    assert per_tok == R.bytes_per_token(SPEC) == 2 * 2 * 8 * 4
    assert pool.bytes() == pool.allocated_bytes() == 4 * 16 * per_tok
    assert pool.max_bytes() == ref.max_bytes() == 4 * 64 * per_tok
    for p, grow in ((ref, _jax_grow), (pool, _torch_grow)):
        p.grow_to(32, grow)
        p.grow_to(16, grow)            # never shrinks
    assert pool.capacity == ref.capacity == 32
    assert pool.bytes() == pool.allocated_bytes() == ref.allocated_bytes()
    assert pool.stats() == ref.stats()
    for name, buf in pool.buffers.items():
        assert buf.device.type == "cpu"
        assert tuple(buf.shape) == tuple(ref.buffers[name].shape)
        assert buf.dtype == torch.float32


def test_bytes_per_token_mixed_and_listed_specs():
    assert P.bytes_per_token(SPEC_MIXED) == R.bytes_per_token(SPEC_MIXED)
    assert P.bytes_per_token([SPEC, SPEC_MIXED]) == \
        R.bytes_per_token([SPEC, SPEC_MIXED])
    pool = P.KVCachePool(SPEC_MIXED, slots=2, page=8, max_len=16,
                         device="cpu")
    assert pool.buffers["v0"].dtype == torch.bfloat16
    assert pool.buffers["k1"].dtype == torch.int32
    assert pool.allocated_bytes() == pool.bytes()


@pytest.mark.parametrize("limit_scale", [0.5, 1.0, 1.0 - 1e-9, 2.0, 3.7])
@pytest.mark.parametrize("reserve", [0.0, 0.25, 0.5])
def test_fits_budget_and_plan_slots_match_reference(limit_scale, reserve):
    need = 4 * 64 * P.bytes_per_token(SPEC)
    limit = int(need * limit_scale)
    for spec in (SPEC, [SPEC, SPEC_MIXED]):
        assert P.fits_budget(spec, 4, 64, limit_bytes=limit,
                             reserve_frac=reserve) == \
            R.fits_budget(spec, 4, 64, limit_bytes=limit,
                          reserve_frac=reserve)
        assert P.plan_slots(spec, 64, limit_bytes=limit,
                            reserve_frac=reserve) == \
            R.plan_slots(spec, 64, limit_bytes=limit, reserve_frac=reserve)
    assert P.plan_slots(SPEC, 64, limit_bytes=10 ** 12, max_slots=7) == 7
    pool = P.KVCachePool(SPEC, slots=4, page=16, max_len=64, device="cpu")
    assert pool.headroom(limit_bytes=limit) == (limit - need, limit)


def test_budget_without_a_card_gives_no_verdict(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert P.fits_budget(SPEC, 4, 64) == \
        (None, 4 * 64 * P.bytes_per_token(SPEC), None)
    assert P.plan_slots(SPEC, 64) is None
    pool = P.KVCachePool(SPEC, slots=4, page=16, max_len=64, device="cpu")
    assert pool.headroom() == (None, None)


def test_pool_defaults_to_the_card():
    if torch.cuda.is_available():
        assert P.KVCachePool(SPEC, slots=1, page=8,
                             max_len=8).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            P.KVCachePool(SPEC, slots=1, page=8, max_len=8)


def test_pool_refuses_an_arena_larger_than_the_device(monkeypatch):
    need = 4 * 64 * P.bytes_per_token(SPEC)
    monkeypatch.setattr(P, "device_memory_limit", lambda device: need - 1)
    with pytest.raises(ValueError, match="more than the device"):
        P.KVCachePool(SPEC, slots=4, page=16, max_len=64, device="cpu")
    monkeypatch.setattr(P, "device_memory_limit", lambda device: need)
    assert P.KVCachePool(SPEC, slots=4, page=16, max_len=64,
                         device="cpu").max_bytes() == need
