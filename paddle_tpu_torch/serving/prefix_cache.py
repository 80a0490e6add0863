"""paddle_tpu_torch.serving.prefix_cache — KV reuse for shared prompt
heads.

Counterpart of ``paddle_tpu/serving/prefix_cache.py``. Production traffic
is head-heavy: most requests open with one of a handful of system prompts,
and prefill recomputes the same KV for that head on every arrival. This
module is the memo table in front of the prefill pool: a hash of the
*full* prompt token sequence maps to the KV segment (and final-position
logits) prefill produced the first time, so a repeat prompt skips prefill
entirely and hands cached KV straight to a decode slot.

Design constraints, in order:

* **No new executables on a hit.** Cached KV is stored padded to the
  prompt bucket prefill ran at, so the segment lands on the decode pool's
  already-warmed insert for that ``(pad, capacity)`` pair, and the hit's
  first token comes from a graph warmup captured
  (``PrefillEngine``'s ``psample``). A hit never changes the set of shapes
  in flight, and launches no kernel of the prompt's forward.
* **Bit-identical streams.** The cache stores prefill's *inputs to
  sampling* (the last-position logits), not its sampled token — the
  hitting request samples its own first token from those logits with its
  own counter-keyed draw at generation index 0, exactly as the prefill
  would have. Greedy and sampled streams are therefore the streams the
  single engine emits.
* **Pinned entries never evict.** ``lookup`` takes a reference; eviction
  (LRU order under a byte budget) only considers entries with zero
  outstanding references, so a segment mid-handoff cannot vanish
  underneath the transfer. Callers must ``release`` when the segment has
  landed (or the request died).

The cache is host-side numpy — it prices and stores segments in the same
transport format ``KVCachePool.export_slot`` produces (``{"length", "pad",
"bytes", "leaves"}``), so handoff, drain migration, and prefix hits all
ride one copy primitive. The cache is keyed on the prompt alone: it
outlives a rolling weight swap of the prefill pool, whose hits then serve
the KV and logits of the weights that computed them, as the reference's
do (ROADMAP.md Queue C).
"""
from __future__ import annotations

import hashlib
import threading
import time
from collections import OrderedDict

import numpy as np

from . import metrics
from .kv_cache import bytes_per_token


def prompt_key(tokens):
    """Stable key for a full prompt: blake2b over the little-endian
    int32 token bytes, salted with the length (so a prefix of another
    prompt can never collide with it)."""
    arr = np.ascontiguousarray(np.asarray(tokens, dtype=np.int32))
    h = hashlib.blake2b(digest_size=16)
    h.update(arr.size.to_bytes(8, "little"))
    h.update(arr.tobytes())
    return h.hexdigest()


class _Entry:
    __slots__ = ("segment", "logits", "prompt_len", "nbytes", "refs",
                 "hits", "t_insert")

    def __init__(self, segment, logits, prompt_len, nbytes):
        self.segment = segment          # export_slot transport dict
        self.logits = logits            # [V] float32, last prompt position
        self.prompt_len = int(prompt_len)
        self.nbytes = int(nbytes)
        self.refs = 0
        self.hits = 0
        self.t_insert = time.monotonic()


class PrefixCache:
    """Ref-counted LRU over prefill KV segments, bounded by bytes.

    Parameters
    ----------
    spec : the per-token KV spec (``model.kv_spec()``) — used to verify
        inserted segments price out to exactly ``bytes_per_token(spec)
        * pad`` (the same assertion ``export_slot`` makes), so cache
        accounting can never drift from arena accounting.
    budget_bytes : byte ceiling for resident segments (logits ride
        free — they are ~vocab floats against megabytes of KV). When
        the ceiling would be crossed, unpinned entries evict in LRU
        order; if everything is pinned the insert is refused rather
        than the budget broken.
    """

    def __init__(self, spec, budget_bytes=64 * 1024 * 1024):
        self.spec = dict(spec)
        self.budget_bytes = int(budget_bytes)
        self._per_token = bytes_per_token(self.spec)
        self._lock = threading.Lock()
        self._entries = OrderedDict()   # key -> _Entry, LRU order
        self._bytes = 0
        self._hits = 0
        self._misses = 0
        self._inserts = 0
        self._evictions = 0
        self._refused = 0

    # -- lookup / release --------------------------------------------------

    def lookup(self, tokens):
        """Hit: returns ``(key, entry)`` with a reference taken (entry
        is pinned until :meth:`release`). Miss: ``(key, None)`` — the
        caller runs prefill and may :meth:`insert` under the same key."""
        key = prompt_key(tokens)
        t0 = time.perf_counter()
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
                entry.refs += 1
                entry.hits += 1
                self._hits += 1
            else:
                self._misses += 1
        metrics.record_prefix_lookup(entry is not None,
                                     (time.perf_counter() - t0) * 1e3)
        return key, entry

    def release(self, key):
        """Drop one reference taken by a hit (or a just-inserted
        segment). Unpinned entries become evictable again."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None and entry.refs > 0:
                entry.refs -= 1

    # -- insert / evict ----------------------------------------------------

    def insert(self, key, segment, logits, pin=False):
        """Adopt a prefill-produced segment under ``key``. The segment
        must be in export_slot transport format; its byte count is
        re-derived from the spec and asserted, never trusted. Returns
        True when resident (False when the budget is all pinned or the
        single segment exceeds it)."""
        pad = int(segment["pad"])
        nbytes = sum(int(np.asarray(a).nbytes)
                     for a in segment["leaves"].values())
        expected = self._per_token * pad
        if nbytes != expected:
            raise AssertionError(
                f"prefix segment bytes {nbytes} != spec-priced {expected} "
                f"({self._per_token} B/token x pad {pad})")
        if int(segment["bytes"]) != nbytes:
            raise AssertionError(
                f"segment self-reported {segment['bytes']} B, "
                f"leaves hold {nbytes} B")
        logits = np.asarray(logits)
        with self._lock:
            if key in self._entries:        # racer already inserted
                entry = self._entries[key]
                self._entries.move_to_end(key)
                if pin:
                    entry.refs += 1
                return True
            if nbytes > self.budget_bytes:
                self._refused += 1
                return False
            if not self._make_room(nbytes):
                self._refused += 1
                return False
            entry = _Entry(segment, logits, segment["length"], nbytes)
            if pin:
                entry.refs = 1
            self._entries[key] = entry
            self._bytes += nbytes
            self._inserts += 1
            cache_bytes, n = self._bytes, len(self._entries)
        metrics.record_prefix_cache(cache_bytes, n, self.budget_bytes)
        return True

    def _make_room(self, nbytes):
        """Evict unpinned entries (LRU first) until ``nbytes`` fits
        under the budget. Lock held by caller. False when pinned
        entries alone exceed the remaining headroom."""
        freed = 0
        evicted = 0
        while self._bytes + nbytes > self.budget_bytes:
            victim = next((k for k, e in self._entries.items()
                           if e.refs == 0), None)
            if victim is None:
                return False
            entry = self._entries.pop(victim)
            self._bytes -= entry.nbytes
            freed += entry.nbytes
            evicted += 1
        if evicted:
            self._evictions += evicted
            metrics.record_prefix_evict(evicted, freed)
        return True

    # -- introspection -----------------------------------------------------

    def bytes(self):
        with self._lock:
            return self._bytes

    def __len__(self):
        with self._lock:
            return len(self._entries)

    def hit_rate(self):
        with self._lock:
            total = self._hits + self._misses
            return (self._hits / total) if total else None

    def stats(self):
        with self._lock:
            return {
                "entries": len(self._entries),
                "bytes": self._bytes,
                "budget_bytes": self.budget_bytes,
                "hits": self._hits,
                "misses": self._misses,
                "inserts": self._inserts,
                "evictions": self._evictions,
                "refused": self._refused,
                "pinned": sum(1 for e in self._entries.values()
                              if e.refs > 0),
            }
