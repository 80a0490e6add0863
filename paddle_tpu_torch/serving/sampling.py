"""paddle_tpu_torch.serving.sampling — per-slot token sampling with
counter-keyed random draws, and the speculative accept-prefix rule.

Counterpart of ``paddle_tpu/serving/sampling.py``. Temperature, top-k,
top-p and the seed are data, one value a slot (``temperature <= 0`` is
greedy, ``top_k <= 0`` and ``top_p == 1.0`` switch their filters off),
so greedy and sampled rows share one decode step.

Every random decision draws from a key that is a pure function of the
request's seed, the token's generation index and the decision kind::

    fold_in(PRNGKey(seed), position * N_SALTS + salt)

That is JAX's threefry2x32 key derivation, and this module computes it
bit for bit (:func:`threefry2x32`, on uint32 values held in int64 tensors
and masked to 32 bits), with ``jax.random.uniform``'s and ``gumbel``'s
float conversions on top. So a request's sampled stream is the same
whatever tick admitted it and whatever else rode in its batch, and the
same as the reference's where their logits agree: the tests hold the two
token for token.

The filter sorts with a stable descending ``torch.sort``, which keeps the
lowest token id first among equal logits, as ``lax.top_k`` does, and it
runs only when some row asks for top-k or top-p: at ``k = V`` and ``p =
1.0`` the filter body could drop a tail token whose exclusive cumulative
mass rounds to 1.0, so skipping it is part of the semantics, as the
reference's batch-wide ``lax.cond`` is.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import to_device

# Filtered-out logits get this, not -inf: exp(-1e30) is exactly 0.0 in
# float32 and -inf arithmetic breeds NaNs
NEG = -1e30

# Salt per random-decision kind; the per-position counter is
# position * N_SALTS + salt
SALT_TOKEN = 0       # the token draw itself (sampled decode + proposals)
SALT_ACCEPT = 1      # speculative accept test u_i
SALT_RESID = 2       # residual resample at the first rejected position
N_SALTS = 4          # room to grow without re-keying history

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA
_F32_ONE_BITS = 0x3F800000
_F32_TINY = float(np.finfo(np.float32).tiny)


class SamplingParams:
    """One request's decode-sampling config.

    ``temperature <= 0`` selects greedy (argmax) decode and the other
    knobs are ignored. ``top_k <= 0`` disables the top-k filter;
    ``top_p`` must sit in (0, 1] and ``1.0`` disables the nucleus
    filter. ``seed`` is the per-request PRNG root; ``None`` lets the
    engine assign one at ``make_request`` time (recorded on the
    request)."""

    __slots__ = ("temperature", "top_k", "top_p", "seed")

    def __init__(self, temperature=0.0, top_k=0, top_p=1.0, seed=None):
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        if not (0.0 < self.top_p <= 1.0):
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        if seed is not None:
            seed = int(seed)
            if seed < 0:
                raise ValueError(f"seed must be >= 0, got {seed}")
        self.seed = seed

    @property
    def greedy(self):
        return self.temperature <= 0.0

    def __eq__(self, other):
        return (isinstance(other, SamplingParams)
                and self.temperature == other.temperature
                and self.top_k == other.top_k
                and self.top_p == other.top_p
                and self.seed == other.seed)

    def __repr__(self):
        return (f"SamplingParams(temperature={self.temperature}, "
                f"top_k={self.top_k}, top_p={self.top_p}, "
                f"seed={self.seed})")


GREEDY = SamplingParams()


def resolve(sampling=None, seed=None):
    """Normalize the ``sampling=`` submit knob into
    :class:`SamplingParams`: None (greedy), a dict of knob overrides,
    or a ready-made params object (copied). ``seed=`` overrides the
    params' own seed either way."""
    if sampling is None:
        params = SamplingParams()
    elif isinstance(sampling, SamplingParams):
        params = SamplingParams(sampling.temperature, sampling.top_k,
                                sampling.top_p, sampling.seed)
    elif isinstance(sampling, dict):
        params = SamplingParams(**sampling)
    else:
        raise TypeError(
            f"sampling must be None, a dict, or SamplingParams — "
            f"got {type(sampling).__name__}")
    if seed is not None:
        params.seed = int(seed)
    return params


# -- threefry2x32 on uint32 values held in int64 ------------------------------

def _u32(x, device=None):
    """``x`` (array-like or tensor) as an int64 tensor of uint32 values:
    negative ints wrap as a cast to uint32 does."""
    if not isinstance(x, torch.Tensor):
        return to_device(np.asarray(x, dtype=np.int64) & _M32,
                         device or "cpu")
    return x.to(device=device, dtype=torch.int64) & _M32


def threefry2x32(k1, k2, x1, x2):
    """JAX's threefry2x32 hash (20 rounds) of the counter pair ``(x1,
    x2)`` under the key ``(k1, k2)``; every operand an int64 tensor of
    uint32 values, broadcast together. Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = (((x2 << r) | (x2 >> (32 - r))) & _M32) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x1, x2


def keys_for(seeds, positions, salt, device=None):
    """One key a slot, ``fold_in(PRNGKey(seed), position * N_SALTS +
    salt)`` over uint32 seeds and positions: an int64 tensor ``[S, 2]``
    of uint32 words, the bits of JAX's ``[S, 2]`` uint32 keys."""
    seeds = _u32(seeds, device)
    counters = (_u32(positions, seeds.device) * N_SALTS + salt) & _M32
    # PRNGKey(s) of a uint32 seed is (0, s); fold_in(key, d) hashes the
    # counter pair (0, d)
    k1, k2 = threefry2x32(torch.zeros_like(seeds), seeds,
                          torch.zeros_like(counters), counters)
    return torch.stack([k1, k2], dim=-1)


def _bits_to_unit(bits):
    """``jax.random.uniform``'s conversion: 23 random mantissa bits under
    the exponent of 1.0, minus 1, as float32 in [0, 1)."""
    fb = ((bits >> 9) | _F32_ONE_BITS).to(torch.int32)
    return fb.view(torch.float32) - 1.0


def _random_bits(keys, n):
    """``jax.random.bits`` (32-bit, partitionable threefry) of ``n``
    values under each key of ``keys [..., 2]``: ``[..., n]``."""
    k1, k2 = keys[..., 0:1], keys[..., 1:2]
    lo = torch.arange(n, dtype=torch.int64, device=keys.device)
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(lo), lo)
    return b1 ^ b2


def uniform_for(seeds, positions, salt):
    """One U(0, 1) float32 per entry, ``jax.random.uniform(key, ())``
    under the counter key, on ``seeds``' device; ``seeds`` and
    ``positions`` broadcast to a common shape first."""
    seeds = _u32(seeds)
    positions = _u32(positions, seeds.device)
    shape = torch.broadcast_shapes(seeds.shape, positions.shape)
    keys = keys_for(seeds.expand(shape).reshape(-1),
                    positions.expand(shape).reshape(-1), salt)
    return _bits_to_unit(_random_bits(keys, 1)[:, 0]).reshape(shape)


def gumbel(keys, v):
    """``jax.random.gumbel(key, (v,), float32)`` under each key of ``keys
    [S, 2]``: ``-log(-log(u))`` with ``u`` uniform on ``[tiny, 1)``, as
    ``[S, v]`` float32."""
    u = _bits_to_unit(_random_bits(keys, v))
    # uniform(minval=tiny, maxval=1) in float32: maxval - minval rounds
    # to 1.0, then the floor at minval
    u = (u * 1.0 + _F32_TINY).clamp_min(_F32_TINY)
    return -torch.log(-torch.log(u))


# -- the filter pipeline ------------------------------------------------------

def _knob(x, dtype, device):
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return to_device(np.asarray(x), device, dtype)


def needs_filter(top_k, top_p, v):
    """Whether any row asks for top-k (``0 < k < v``) or top-p (``p <
    1``): the batch-wide branch. Host knobs decide it without waiting for
    the card."""
    top_k, top_p = torch.as_tensor(top_k), torch.as_tensor(top_p)
    return bool((((top_k > 0) & (top_k < v)) | (top_p < 1.0)).any())


def filter_logits(logits, temperature, top_k, top_p, any_filter=None):
    """Temperature, top-k and top-p per row of ``logits [S, V]``; the
    three knobs are ``[S]`` (tensors or host arrays). Returns float32
    filtered logits, excluded tokens at :data:`NEG`. ``any_filter`` is
    the batch-wide branch (:func:`needs_filter`), which a caller that
    hands over knobs already on the card decides from its host copies:
    read from the card, it would wait for the queued work.

    * ``temperature <= 0``: greedy, the row becomes a one-hot of its
      argmax (ties to the lowest token id);
    * ``top_k <= 0`` keeps all V; ties at the k boundary resolve by the
      sort order (value descending, then lowest token id);
    * ``top_p == 1.0`` switches the nucleus off; the nucleus is the
      shortest sorted prefix with cumulative mass ``>= top_p``, and the
      top token always survives.
    """
    s, v = logits.shape
    dev = logits.device
    if any_filter is None:
        any_filter = needs_filter(top_k, top_p, v)
    temperature = _knob(temperature, torch.float32, dev)
    greedy = temperature <= 0.0
    t = torch.where(greedy, torch.ones_like(temperature), temperature)
    z = (logits / t[:, None]).to(torch.float32)
    if any_filter:
        top_k = _knob(top_k, torch.int64, dev)
        top_p = _knob(top_p, torch.float32, dev)
        svals, sidx = torch.sort(z, dim=-1, descending=True, stable=True)
        k_eff = torch.where(top_k <= 0, v, top_k.clamp(1, v))
        in_k = torch.arange(v, device=dev)[None, :] < k_eff[:, None]
        kz = torch.where(in_k, svals, NEG)
        # the nucleus in sorted space: keep ranks whose exclusive
        # cumulative mass is < p (rank 0 has exclusive mass 0)
        probs = torch.softmax(kz, dim=-1)
        cum_excl = torch.cumsum(probs, dim=-1) - probs
        keep = in_k & (cum_excl < top_p[:, None])
        filt_sorted = torch.where(keep, kz, NEG)
        filt = torch.full_like(z, NEG).scatter_(1, sidx, filt_sorted)
    else:
        filt = z
    am = torch.argmax(z, dim=-1)
    onehot = torch.arange(v, device=dev)[None, :] == am[:, None]
    greedy_filt = torch.where(onehot, 0.0, NEG)
    return torch.where(greedy[:, None], greedy_filt, filt)


def probs_from_filtered(filtered):
    """Normalized distribution over the surviving tokens (greedy rows
    come out one-hot)."""
    return torch.softmax(filtered, dim=-1)


def sample_from_filtered(filtered, seeds, positions, salt=SALT_TOKEN):
    """Gumbel-max draw per row of ``filtered [S, V]`` under the counter
    key ``(seed, position, salt)``, on ``filtered``'s device. A greedy
    (one-hot) row returns its argmax whatever the noise. Returns int64
    token ids ``[S]``."""
    keys = keys_for(seeds, positions, salt, device=filtered.device)
    g = gumbel(keys, filtered.shape[-1])
    return torch.argmax(filtered + g, dim=-1)


def gumbel_ahead(seeds, positions, k, v, device=None):
    """The token draws' Gumbel noise at ``k`` consecutive generation
    indices a row, ``[S, k, V]`` float32 on ``device`` (default: the
    seeds' own): row ``s``'s ``i``-th is, bit for bit, the noise
    :func:`sample_from_filtered` draws under ``(seeds[s], positions[s] +
    i, SALT_TOKEN)``, here from one key derivation and one draw (a
    speculative draft's proposals; ``seeds`` and ``positions`` ``[S]``,
    host arrays or tensors). Every step after the operands reach the
    device runs there, so a CUDA graph captures it."""
    seeds = _u32(seeds, device)
    positions = _u32(positions, seeds.device)
    n = seeds.shape[0]
    at = positions[:, None] + torch.arange(k, device=seeds.device)[None, :]
    keys = keys_for(seeds[:, None].expand(n, k).reshape(-1), at.reshape(-1),
                    SALT_TOKEN)
    return gumbel(keys, v).view(n, k, v)


# -- the speculative accept-prefix rule ---------------------------------------

def accept_prefix(p_probs, q_probs, proposals, seeds, pos0):
    """The draft-verify accept rule, vectorized over slots.

    ``p_probs [S, k+1, V]`` are the target's filtered distributions at
    generation indices ``pos0 .. pos0+k``, ``q_probs [S, k, V]`` the
    draft's, ``proposals [S, k]`` the draft tokens, ``seeds``/``pos0``
    ``[S]``. Accept proposal ``i`` while ``u_i * q_i(d_i) <= p_i(d_i)``,
    ``u_i`` under ``(seed, pos0+i, SALT_ACCEPT)``; the first rejected
    position resamples from ``normalize(max(p - q, 0))`` under
    ``SALT_RESID`` (from ``p`` itself where that has no mass). Returns
    ``(n_accepted [S], resampled [S])``."""
    s, k, v = q_probs.shape
    dev = q_probs.device
    seeds = _u32(seeds, dev)
    pos0 = _u32(pos0, dev)
    rows = torch.arange(s, device=dev)
    cols = torch.arange(k, device=dev)[None, :]
    pos = pos0[:, None] + cols                              # [S, k]
    u = uniform_for(seeds[:, None], pos, SALT_ACCEPT)       # [S, k]
    proposals = proposals.to(device=dev, dtype=torch.int64)
    p_at = p_probs[rows[:, None], cols, proposals]
    q_at = q_probs[rows[:, None], cols, proposals]
    ok = u * q_at <= p_at
    a = torch.cumprod(ok.to(torch.int64), dim=1).sum(dim=1)
    j = torch.clamp(a, max=k - 1)                           # reject index
    pj = p_probs[rows, j]
    qj = q_probs[rows, j]
    resid = torch.clamp(pj - qj, min=0.0)
    mass = resid.sum(dim=-1, keepdim=True)
    resid = torch.where(mass > 0.0, resid / mass, pj)
    resid_logits = torch.where(resid > 0.0, torch.log(resid), NEG)
    resampled = sample_from_filtered(resid_logits, seeds, pos0 + j,
                                     salt=SALT_RESID)
    return a, resampled
