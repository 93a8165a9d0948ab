"""Sequence-keyed LRU result cache with in-flight request dedup.

Port of ``alphafold2_tpu/serve/cache.py`` (pure stdlib, unchanged): the
keys and the LRU, dedup and interning behaviour are JAX's.

Identical requests are common in production serving (the same viral
sequence submitted by thousands of users), and the engine's outputs are
deterministic in ``(seq, seed)`` whatever bucket or batch slot the request
lands in (pinned by the serve parity tests) — so recomputing them is pure
waste. Two layers remove it:

- **LRU cache** — completed results keyed by ``(seq, seed)``; a hit
  returns the stored :class:`~alphafold2_tpu_torch.serve.engine.ServeResult`
  (same arrays — byte-identical to the dispatch that produced it).
- **In-flight dedup** — a request whose key is already queued or on the
  device *joins* the in-flight entry as a follower instead of dispatching
  again; when the leader's dispatch completes, every follower is resolved
  with the same result. Dedup works even with the LRU disabled
  (``capacity=0``): concurrent identical requests still share one
  dispatch, they just aren't remembered afterwards.

A third layer (:class:`FeatureCache`) serves the variant-scan fast lane:
featurized input trees content-addressed by the bytes of their leaves
(not the raw request string), so requests whose features coincide share
storage — across seeds the seed-independent leaves (``seq``/``mask``)
intern to one copy — and a point mutant of a cached parent can be
featurized by column patching (``data.pipeline.featurize_delta``) instead
of from scratch.

The caches store and return results; they never stamp latencies or bump
counters — the scheduler/engine own per-request accounting. Pure stdlib
(the feature fingerprint duck-types ``.shape``/``.dtype``/``.tobytes()``
so numpy never has to be imported here).
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import Optional, Tuple


def result_key(seq: str, seed: int, mesh_desc: Optional[str] = None) -> tuple:
    """The canonical result-cache / in-flight-dedup key. Outputs are
    deterministic in ``(seq, seed)`` on a FIXED execution layout, but a
    sharded executable's floats are only equal to the single-device ones
    to ~1e-4 (reduction order differs) — so the mesh identity
    (``parallel.sharding.describe_mesh``) is part of the key, and results
    computed on one layout are never served as byte-identical answers for
    another."""
    return (seq, int(seed), mesh_desc)


class InFlightEntry:
    """One key's in-flight record: the leader token plus the follower
    contexts (opaque to the cache — the scheduler registers its pending
    handles here) to resolve when the leader's dispatch completes.
    ``leader_trace`` carries the leader's trace_id so a follower's
    ``sched.dedup_join`` event can name the trace it attached to."""

    __slots__ = ("key", "followers", "leader_trace")

    def __init__(self, key):
        self.key = key
        self.followers: list = []
        self.leader_trace: Optional[str] = None


class ResultCache:
    """Thread-safe LRU + in-flight table over ``(seq, seed)`` keys.

    Protocol (scheduler side):

    1. ``status, payload = lookup_or_claim(key, follower_ctx)`` at submit:
       ``"hit"`` (payload = cached result, done), ``"follower"``
       (``follower_ctx`` was registered on the in-flight entry; the leader
       will resolve it), or ``"leader"`` (payload = the new
       :class:`InFlightEntry`; the caller must eventually ``fulfill``).
    2. ``followers = fulfill(key, result, cache=...)`` when the leader's
       dispatch (or rejection/deadline) resolves: stores ``result`` in the
       LRU when ``cache=True`` (only genuinely-ok results belong there)
       and returns the follower contexts for the caller to resolve.
    """

    def __init__(self, capacity: int):
        self.capacity = max(0, int(capacity))
        self._lru: "OrderedDict" = OrderedDict()
        self._inflight: dict = {}
        self._lock = threading.Lock()

    def __len__(self) -> int:
        with self._lock:
            return len(self._lru)

    def lookup_or_claim(self, key, follower_ctx=None) -> Tuple[str, object]:
        with self._lock:
            if key in self._lru:
                self._lru.move_to_end(key)
                return "hit", self._lru[key]
            entry = self._inflight.get(key)
            if entry is not None:
                if follower_ctx is not None:
                    entry.followers.append(follower_ctx)
                return "follower", entry
            entry = InFlightEntry(key)
            self._inflight[key] = entry
            return "leader", entry

    def fulfill(self, key, result, cache: bool = True) -> list:
        with self._lock:
            entry = self._inflight.pop(key, None)
            if cache and self.capacity:
                self._lru[key] = result
                self._lru.move_to_end(key)
                while len(self._lru) > self.capacity:
                    self._lru.popitem(last=False)
            return list(entry.followers) if entry is not None else []

    def peek(self, key) -> Optional[object]:
        """Cached result without LRU promotion (tests, introspection)."""
        with self._lock:
            return self._lru.get(key)

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._lru),
                "capacity": self.capacity,
                "inflight": len(self._inflight),
            }


# --------------------------------------------------- content-addressed layer


def feature_key(seq: str, bucket: int, msa_depth: int, seed: int) -> tuple:
    """Derivation key of one featurized tree: everything
    ``data.pipeline.featurize_bucketed`` consumes. Request metadata
    (priority, deadline, parent hints, trace identity) is deliberately
    absent — requests differing only in metadata address the same entry."""
    return (seq, int(bucket), int(msa_depth), int(seed))


def feature_fingerprint(item: dict) -> str:
    """Content address of a featurized tree: sha256 over leaf names,
    shapes, dtypes and raw bytes — the hash is of what the model will
    actually consume, not of the request string that produced it."""
    h = hashlib.sha256()
    for name in sorted(item):
        leaf = item[name]
        h.update(name.encode())
        h.update(repr((tuple(leaf.shape), str(leaf.dtype))).encode())
        h.update(leaf.tobytes())
    return h.hexdigest()


def _leaf_fingerprint(name: str, leaf) -> str:
    h = hashlib.sha256()
    h.update(name.encode())
    h.update(repr((tuple(leaf.shape), str(leaf.dtype))).encode())
    h.update(leaf.tobytes())
    return h.hexdigest()


class _FeatureEntry:
    __slots__ = ("key", "item", "plan", "fingerprint", "leaf_fps", "shape")

    def __init__(self, key, item, plan, fingerprint, leaf_fps, shape):
        self.key = key
        self.item = item
        self.plan = plan
        self.fingerprint = fingerprint
        self.leaf_fps = leaf_fps
        self.shape = shape


class FeatureCache:
    """Content-addressed LRU of featurized input trees.

    Two structures under one lock:

    - **derivation LRU** — :func:`feature_key` → entry holding the
      featurized item, its content fingerprint, and the delta plan
      (``data.pipeline.featurize_bucketed_with_plan``) needed to featurize
      point mutants by column patching.
    - **leaf intern table** — per-leaf content hash → (array, refcount).
      Leaves are stored by VALUE: two entries whose ``seq``/``mask``/
      ``msa`` bytes coincide (e.g. different seeds sharing the
      seed-independent leaves, or a delta-featurized mutant sharing the
      parent's masks) hold references to one array. ``leaf_dedup_hits``
      counts every share, so the reuse is observable, not assumed.

    Cached arrays are shared across requests and must never be mutated;
    ``put`` freezes them (numpy ``writeable=False``) so an accidental
    in-place edit fails loudly instead of corrupting every holder.

    ``delta_parent(bucket, msa_depth, seed, length)`` yields recent
    same-derivation-shape entries (most recent first, bounded scan) for
    the engine's point-mutant search."""

    # bounded same-shape scan: mutant-scan traffic keeps the parent hot at
    # the front, so a short window finds it; unrelated traffic pays at
    # most this many token-array comparisons per miss
    DELTA_SCAN = 8

    def __init__(self, capacity: int):
        self.capacity = max(0, int(capacity))
        self._lru: "OrderedDict[tuple, _FeatureEntry]" = OrderedDict()
        self._leaves: dict = {}  # leaf fp -> [array, refcount]
        self._by_shape: dict = {}  # (bucket, msa_depth, seed, length) -> [key]
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.leaf_dedup_hits = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._lru)

    def lookup(self, key) -> Optional[tuple]:
        """(item, plan) for an exact derivation key, with LRU promotion."""
        with self._lock:
            entry = self._lru.get(key)
            if entry is None:
                self.misses += 1
                return None
            self._lru.move_to_end(key)
            self.hits += 1
            return entry.item, entry.plan

    def put(self, key, item: dict, plan: Optional[dict] = None) -> dict:
        """Intern ``item`` under ``key``; returns the canonical (leaf-
        shared, frozen) tree the caller should use from now on."""
        if self.capacity == 0:
            return item
        seq_len = len(key[0]) if isinstance(key[0], str) else None
        shape = (key[1], key[2], key[3], seq_len)
        with self._lock:
            existing = self._lru.get(key)
            if existing is not None:  # racing featurizers: first put wins
                self._lru.move_to_end(key)
                return existing.item
            interned = {}
            leaf_fps = {}
            for name in sorted(item):
                fp = _leaf_fingerprint(name, item[name])
                slot = self._leaves.get(fp)
                if slot is None:
                    leaf = item[name]
                    if hasattr(leaf, "setflags"):
                        leaf.setflags(write=False)
                    self._leaves[fp] = [leaf, 1]
                    interned[name] = leaf
                else:
                    slot[1] += 1
                    interned[name] = slot[0]
                    self.leaf_dedup_hits += 1
                leaf_fps[name] = fp
            entry = _FeatureEntry(
                key, interned, plan,
                hashlib.sha256(
                    "".join(leaf_fps[n] for n in sorted(leaf_fps)).encode()
                ).hexdigest(),
                leaf_fps, shape,
            )
            self._lru[key] = entry
            self._by_shape.setdefault(shape, []).append(key)
            while len(self._lru) > self.capacity:
                self._evict_oldest_locked()
            return interned

    def _evict_oldest_locked(self) -> None:
        _, entry = self._lru.popitem(last=False)
        for name, fp in entry.leaf_fps.items():
            slot = self._leaves.get(fp)
            if slot is not None:
                slot[1] -= 1
                if slot[1] <= 0:
                    del self._leaves[fp]
        keys = self._by_shape.get(entry.shape)
        if keys is not None:
            try:
                keys.remove(entry.key)
            except ValueError:
                pass
            if not keys:
                del self._by_shape[entry.shape]

    def delta_parent(self, bucket: int, msa_depth: int, seed: int,
                     length: int) -> list:
        """Recent entries at the same derivation shape — the candidates a
        point mutant could delta-featurize from. Most recent first,
        bounded to :attr:`DELTA_SCAN`; only entries that carry a plan."""
        shape = (int(bucket), int(msa_depth), int(seed), int(length))
        with self._lock:
            keys = self._by_shape.get(shape)
            if not keys:
                return []
            out = []
            for key in reversed(keys[-self.DELTA_SCAN:]):
                entry = self._lru.get(key)
                if entry is not None and entry.plan is not None:
                    out.append((entry.item, entry.plan))
            return out

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._lru),
                "capacity": self.capacity,
                "hits": self.hits,
                "misses": self.misses,
                "unique_leaves": len(self._leaves),
                "leaf_dedup_hits": self.leaf_dedup_hits,
            }
