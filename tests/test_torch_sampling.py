"""The port's decode sampling (``paddle_tpu_torch.serving.sampling``)
against the JAX package's ``paddle_tpu.serving.sampling``, on the same
inputs made with numpy from a seed.

* The counter keys and the uniform draws are JAX's threefry2x32 bits,
  reproduced in int64 tensors: held bit for bit over a grid of seeds
  (0 and 2^32 - 1 among them), positions and salts.
* The Gumbel noise is ``-log(-log(u))`` of bit-equal ``u``: PyTorch's
  and XLA's ``log`` each round to within one float32 step, and near
  ``g = 0`` the outer log turns the inner one's last bit into an absolute
  error of about 2^-24, so the noise is held within 2 steps of float32 at
  the scale of ``max(1, |g|)``, the scale of the logits it is added to.
* The filter keeps the exact temperature-scaled logits of the tokens it
  keeps, so it is held for equality, except where the reference's own
  cumulative mass lies within float32 rounding of ``top_p`` (PyTorch's
  softmax and cumsum round otherwise than XLA's; see
  ``_near_threshold``); the draws and the accept rule for equal tokens.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax
from paddle_tpu.serving import sampling as R
from paddle_tpu_torch.serving import sampling as P

SEEDS = np.array([0, 1, 2, 7, 1000, 123456789, 2 ** 31 - 1, 2 ** 31,
                  2 ** 32 - 2, 2 ** 32 - 1], np.uint32)
POSITIONS = np.array([0, 1, 2, 3, 17, 255, 4096, 65537, 2 ** 24 + 3,
                      2 ** 30 - 1], np.int32)


def _grid():
    s, p = np.meshgrid(SEEDS, POSITIONS, indexing="ij")
    return s.reshape(-1), p.reshape(-1)


@pytest.mark.parametrize("salt", [P.SALT_TOKEN, P.SALT_ACCEPT, P.SALT_RESID,
                                  3])
def test_keys_for_bits_equal_jax(salt):
    seeds, pos = _grid()
    ref = np.asarray(R.keys_for(jnp.asarray(seeds), jnp.asarray(pos), salt))
    got = P.keys_for(seeds, pos, salt)
    assert got.dtype == torch.int64 and tuple(got.shape) == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.int64))


@pytest.mark.parametrize("salt", [P.SALT_TOKEN, P.SALT_ACCEPT])
def test_uniform_for_bits_equal_jax(salt):
    seeds, pos = _grid()
    ref = np.asarray(R.uniform_for(jnp.asarray(seeds), jnp.asarray(pos),
                                   salt))
    got = P.uniform_for(seeds, pos, salt).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))
    # broadcast [S, 1] against [1, k], as the accept rule calls it
    ref2 = np.asarray(R.uniform_for(jnp.asarray(SEEDS)[:, None],
                                    jnp.asarray(POSITIONS[:4])[None, :],
                                    salt))
    got2 = P.uniform_for(SEEDS[:, None], POSITIONS[None, :4], salt).numpy()
    np.testing.assert_array_equal(got2, ref2)


def test_threefry2x32_known_answer():
    # the Threefry2x32-20 test vector (Salmon et al., Random123): key and
    # counter all ones
    m = torch.tensor([0xFFFFFFFF], dtype=torch.int64)
    x1, x2 = P.threefry2x32(m, m, m, m)
    assert (int(x1), int(x2)) == (0x1CB996FC, 0xBB002BE7)


@pytest.mark.parametrize("v", [1, 64, 1000])
def test_gumbel_within_2ulp_of_jax(v):
    seeds, pos = _grid()
    keys = R.keys_for(jnp.asarray(seeds), jnp.asarray(pos), P.SALT_TOKEN)
    ref = np.asarray(jax.vmap(
        lambda k: jax.random.gumbel(k, (v,), jnp.float32))(keys))
    got = P.gumbel(P.keys_for(seeds, pos, P.SALT_TOKEN), v).numpy()
    assert got.shape == ref.shape and np.isfinite(got).all()
    step = np.spacing(np.maximum(np.abs(ref), 1.0).astype(np.float32))
    assert (np.abs(got - ref) <= 2 * step).all()


def _knobs(rng, s, v):
    temps = rng.choice([0.0, 0.7, 1.0, 1.5], size=s).astype(np.float32)
    top_ks = rng.choice([0, 1, 3, v // 2, v, v + 5], size=s).astype(np.int32)
    top_ps = rng.choice([1.0, 0.9, 0.5, 0.05], size=s).astype(np.float32)
    temps[0] = 0.0                       # a greedy row
    top_ks[1], top_ps[1] = 0, 1.0        # a plain-temperature row
    temps[1] = 1.0
    return temps, top_ks, top_ps


def _filters(logits, temps, top_ks, top_ps):
    ref = np.asarray(R.filter_logits(jnp.asarray(logits),
                                     jnp.asarray(temps),
                                     jnp.asarray(top_ks),
                                     jnp.asarray(top_ps)))
    got = P.filter_logits(torch.from_numpy(logits.copy()), temps, top_ks,
                          top_ps).numpy()
    return ref, got


def _near_threshold(logits, temps, top_ks, top_ps, tol=2.0 ** -21):
    """(row, token) where the reference's keep decision is within float32
    rounding of its threshold: the exclusive cumulative mass of the
    sorted probabilities, recomputed with the reference's own operations,
    within ``tol`` (a few steps at 1.0) of ``top_p``. PyTorch's softmax
    and cumsum round differently from XLA's, so there the two may
    decide either way. That includes the tail tokens of a row at ``p =
    1.0``, whose exclusive mass can round to 1.0 and drop them when the
    filter runs for another row of the batch."""
    v = logits.shape[1]
    t = np.where(temps <= 0, 1.0, temps).astype(np.float32)
    z = jnp.asarray(logits) / jnp.asarray(t)[:, None]
    svals, sidx = jax.lax.top_k(z, v)
    k_eff = np.where(top_ks <= 0, v, np.clip(top_ks, 1, v))
    in_k = np.arange(v)[None, :] < k_eff[:, None]
    probs = jax.nn.softmax(jnp.where(jnp.asarray(in_k), svals, R.NEG), -1)
    cum = np.asarray(jnp.cumsum(probs, axis=-1) - probs)
    near = in_k & (np.abs(cum - top_ps[:, None]) <= tol)
    out = np.zeros_like(near)
    np.put_along_axis(out, np.asarray(sidx), near, axis=1)
    return out & (temps > 0)[:, None]


@pytest.mark.parametrize("seed", range(6))
def test_filter_logits_matches_reference_mixed_knobs(seed):
    rng = np.random.RandomState(seed)
    s, v = 16, 50
    logits = (rng.randn(s, v) * 3).astype(np.float32)
    knobs = _knobs(rng, s, v)
    ref, got = _filters(logits, *knobs)
    near = _near_threshold(logits, *knobs)
    assert near.sum() < 0.05 * near.size
    np.testing.assert_array_equal(got[~near], ref[~near])
    # a token that survives keeps its exact temperature-scaled logit
    both = (got > R.NEG / 2) & (ref > R.NEG / 2)
    np.testing.assert_array_equal(got[both], ref[both])
    # the same with the knobs as tensors
    got_t = P.filter_logits(torch.from_numpy(logits.copy()),
                            *(torch.from_numpy(k) for k in knobs)).numpy()
    np.testing.assert_array_equal(got_t, got)


def test_filter_logits_ties_at_the_k_boundary():
    # ties straddle the k boundary; the lowest token ids survive
    logits = np.array([[1.0, 3.0, 3.0, 3.0, 0.0, 3.0],
                       [2.0, 2.0, 2.0, 2.0, 2.0, 2.0],
                       [0.0, 5.0, 1.0, 5.0, 5.0, 1.0]], np.float32)
    temps = np.ones(3, np.float32)
    top_ks = np.array([2, 3, 1], np.int32)
    top_ps = np.ones(3, np.float32)
    ref, got = _filters(logits, temps, top_ks, top_ps)
    np.testing.assert_array_equal(got, ref)
    kept = [list(np.flatnonzero(row > P.NEG / 2)) for row in got]
    assert kept == [[1, 2], [0, 1, 2], [1]]
    # a greedy row of ties takes the lowest id
    ref, got = _filters(logits, np.zeros(3, np.float32), top_ks, top_ps)
    np.testing.assert_array_equal(got, ref)
    assert [int(np.argmax(r)) for r in got] == [1, 0, 1]


def test_filter_logits_batch_with_no_filter():
    # no row asks for top-k or top-p: the sort never runs, and the rows
    # are the temperature-scaled logits (a greedy row its one-hot)
    rng = np.random.RandomState(5)
    logits = (rng.randn(4, 30) * 4).astype(np.float32)
    temps = np.array([0.0, 1.0, 0.5, 2.0], np.float32)
    top_ks = np.array([0, 0, 30, 0], np.int32)      # k = V filters nothing
    top_ps = np.ones(4, np.float32)
    ref, got = _filters(logits, temps, top_ks, top_ps)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got[1:], logits[1:] / temps[1:, None])
    assert got[0].max() == 0.0 and (got[0] < 0).sum() == 29


def test_sample_from_filtered_token_equal():
    rng = np.random.RandomState(7)
    s, v = 64, 40
    logits = (rng.randn(s, v) * 2).astype(np.float32)
    temps, top_ks, top_ps = _knobs(rng, s, v)
    seeds = rng.randint(0, 2 ** 31, size=s).astype(np.uint32)
    seeds[:3] = [0, 2 ** 32 - 1, 12345]
    positions = rng.randint(0, 200, size=s).astype(np.int32)
    ref_f, got_f = _filters(logits, temps, top_ks, top_ps)
    for salt in (P.SALT_TOKEN, P.SALT_RESID):
        ref = np.asarray(R.sample_from_filtered(
            jnp.asarray(ref_f), jnp.asarray(seeds), jnp.asarray(positions),
            salt=salt))
        got = P.sample_from_filtered(torch.from_numpy(got_f), seeds,
                                     positions, salt=salt).numpy()
        np.testing.assert_array_equal(got, ref)
    # greedy rows draw their argmax whatever the seed
    greedy = temps <= 0
    np.testing.assert_array_equal(got[greedy],
                                  np.argmax(logits[greedy], axis=-1))
    # probabilities over the survivors
    np.testing.assert_allclose(
        P.probs_from_filtered(torch.from_numpy(got_f)).numpy(),
        np.asarray(R.probs_from_filtered(jnp.asarray(ref_f))),
        rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("seed", [0, 1])
def test_accept_prefix_token_equal(seed):
    rng = np.random.RandomState(seed)
    s, k, v = 24, 4, 16

    def dist(*shape):
        x = rng.rand(*shape).astype(np.float32) ** 3
        return x / x.sum(-1, keepdims=True)

    q = dist(s, k, v)
    p = dist(s, k + 1, v)
    p[:6, :k] = q[:6]                    # self-draft rows: accept all
    proposals = rng.randint(0, v, size=(s, k)).astype(np.int32)
    seeds = rng.randint(0, 2 ** 31, size=s).astype(np.uint32)
    pos0 = rng.randint(0, 100, size=s).astype(np.int32)
    a_ref, r_ref = R.accept_prefix(jnp.asarray(p), jnp.asarray(q),
                                   jnp.asarray(proposals),
                                   jnp.asarray(seeds), jnp.asarray(pos0))
    a, r = P.accept_prefix(torch.from_numpy(p), torch.from_numpy(q),
                           torch.from_numpy(proposals), seeds, pos0)
    np.testing.assert_array_equal(a.numpy(), np.asarray(a_ref))
    np.testing.assert_array_equal(r.numpy(), np.asarray(r_ref))
    assert (a.numpy()[:6] == k).all()


def test_sampling_params_and_resolve_match_reference():
    for kw in ({}, {"temperature": 0.8, "top_k": 5, "top_p": 0.9,
                    "seed": 3}):
        a, b = R.SamplingParams(**kw), P.SamplingParams(**kw)
        assert repr(a) == repr(b) and a.greedy == b.greedy
    for bad in ({"top_p": 0.0}, {"top_p": 1.5}, {"seed": -1}):
        with pytest.raises(ValueError):
            R.SamplingParams(**bad)
        with pytest.raises(ValueError):
            P.SamplingParams(**bad)
    sp = P.SamplingParams(temperature=1.0, seed=4)
    got = P.resolve(sp, seed=9)
    assert got.seed == 9 and sp.seed == 4 and got is not sp
    assert P.resolve({"top_k": 3}).top_k == 3
    assert P.resolve(None) == P.GREEDY
    with pytest.raises(TypeError):
        P.resolve(0.5)
    assert (P.NEG, P.N_SALTS, P.SALT_TOKEN, P.SALT_ACCEPT, P.SALT_RESID) \
        == (R.NEG, R.N_SALTS, R.SALT_TOKEN, R.SALT_ACCEPT, R.SALT_RESID)
