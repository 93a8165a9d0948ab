"""Shape-bucket ladder: bounded executable count under ragged request lengths.

Port of ``alphafold2_tpu/serve/bucketing.py`` (pure stdlib, unchanged).

A fresh shape per distinct sequence length is the canonical serving
anti-pattern (a compile per length in JAX; in the port, cold kernel plans,
allocator blocks and library handles per length). Instead, request lengths
are padded UP to the nearest rung of a geometric ladder
(``config.ServeConfig.buckets``): the number of executables is bounded by
the ladder size, padding waste is bounded by the ladder's growth ratio, and
everything downstream (trunk attention, distogram, MDS realization, SE(3)
refinement) runs masked so the padding cannot leak into valid coordinates.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Optional, Sequence


def validate_ladder(buckets: Sequence[int]) -> tuple:
    """Normalize + sanity-check a bucket ladder (ascending unique ints)."""
    if not buckets:
        raise ValueError("bucket ladder is empty")
    ladder = tuple(int(b) for b in buckets)
    if any(b <= 0 for b in ladder):
        raise ValueError(f"bucket lengths must be positive: {ladder}")
    if list(ladder) != sorted(set(ladder)):
        raise ValueError(
            f"bucket ladder must be strictly ascending: {ladder}"
        )
    return ladder


def bucket_for(length: int, buckets: Sequence[int]) -> int:
    """Smallest ladder rung >= ``length`` (residues).

    Raises ValueError when the request exceeds the top rung — the caller
    decides whether that is a reject or a reason to extend the ladder.
    """
    if length <= 0:
        raise ValueError(f"sequence length must be positive, got {length}")
    for b in buckets:
        if length <= b:
            return int(b)
    raise ValueError(
        f"sequence of {length} residues exceeds the largest bucket "
        f"{max(buckets)}; extend serve.buckets or reject the request"
    )


def geometric_ladder(lo: int, hi: int, ratio: float = 1.5) -> tuple:
    """Build a ladder from ``lo`` up to (at least) ``hi`` growing by
    ``ratio`` — the worst-case padded-compute overhead is ``ratio**2`` on
    the N^2 pair grid, the executable count is log_ratio(hi/lo)."""
    if lo <= 0 or hi < lo:
        raise ValueError(f"need 0 < lo <= hi, got lo={lo} hi={hi}")
    if ratio <= 1.0:
        raise ValueError(f"ladder ratio must be > 1, got {ratio}")
    out = [int(lo)]
    while out[-1] < hi:
        nxt = max(out[-1] + 1, int(round(out[-1] * ratio)))
        out.append(min(nxt, int(hi)) if nxt >= hi else nxt)
    return tuple(out)


def formation_ripe(
    n_queued: int, fill: int, oldest_wait_s: float, dwell_s: float
) -> bool:
    """Fill-or-dwell batch-formation predicate: a bucket's queue dispatches
    when it reaches its fill target (a full batch) or its oldest member has
    waited ``dwell_s`` (latency bound on partial batches).

    This is the *queue-side* barrier only — with pipelined dispatch, a
    request arriving while the bucket's previous formation is still in the
    host stage joins that in-flight batch instead of queueing behind this
    predicate (continuous batching; serve.inflight_admission)."""
    if n_queued <= 0:
        return False
    return n_queued >= max(1, int(fill)) or oldest_wait_s >= dwell_s


def padding_fraction(lengths: Sequence[int], buckets: Sequence[int]) -> float:
    """Fraction of padded (wasted) positions a request mix incurs on this
    ladder — an ops-facing planning metric (also in bench_serve records)."""
    total = padded = 0
    for n in lengths:
        b = bucket_for(n, buckets)
        total += b
        padded += b - n
    return padded / total if total else 0.0


# ------------------------------------------------ variant-scan affinity


def point_mutation(seq: str, other: str) -> Optional[int]:
    """Position of the single substitution separating two equal-length
    sequences, or ``None`` when they are not point mutants of each other
    (different lengths, identical, or >1 substitution). Early-exits at the
    second mismatch, so scanning a window of non-relatives is cheap."""
    if len(seq) != len(other):
        return None
    pos = -1
    for i, (a, b) in enumerate(zip(seq, other)):
        if a != b:
            if pos >= 0:
                return None
            pos = i
    return pos if pos >= 0 else None


class FamilyTracker:
    """Mutant-family detection over the arriving request stream.

    A deep mutational scan is ~20·L point mutants of one parent; packing
    them into the same batch formations (parent affinity) is what turns
    near-duplicate traffic into near-zero-padding, maximally-reusing
    batches. ``observe(seq, parent_id)`` assigns each request a family
    label:

    - an explicit ``ServeRequest.parent_id`` hint wins (``"hint:<id>"``) —
      the client knows its scan better than any detector;
    - otherwise the sequence is matched edit-distance-1 (substitutions
      only; indels change length and bucket anyway) against a bounded
      window of recently observed sequences, inheriting the match's label;
    - an unmatched sequence starts a (so far singleton) family of its own
      and ``observe`` returns ``None`` — regular traffic stays regular.

    Thread-safe; the window is an LRU over sequences so a long-running
    frontend's memory stays bounded."""

    def __init__(self, window: int = 64):
        self.window = max(1, int(window))
        self._label: "OrderedDict[str, str]" = OrderedDict()  # seq -> label
        self._lock = threading.Lock()

    def observe(self, seq: str, parent_id: Optional[str] = None
                ) -> Optional[str]:
        with self._lock:
            if parent_id:
                label = f"hint:{parent_id}"
                self._remember(seq, label)
                return label
            known = self._label.get(seq)
            if known is not None:
                self._label.move_to_end(seq)
                # an exact repeat only counts as family traffic when its
                # label names a real family (not its own singleton start)
                return known if known != seq else None
            for other in reversed(self._label):
                if point_mutation(seq, other) is not None:
                    label = self._label[other]
                    self._remember(seq, label)
                    return label
            self._remember(seq, seq)
            return None

    def _remember(self, seq: str, label: str) -> None:
        self._label[seq] = label
        self._label.move_to_end(seq)
        while len(self._label) > self.window:
            self._label.popitem(last=False)


def affinity_take(pendings: list, fill: int) -> list:
    """Choose up to ``fill`` members for one batch formation, preferring
    the head-of-queue request's family: same-family pendings deeper in the
    queue jump ahead so a scan's mutants ride together (identical lengths
    → near-zero padding, one executable). The head is always taken —
    affinity reorders *within* a formation, it never delays the oldest
    request — and leftover slots fall back to plain queue order, so mixed
    traffic still fills the batch. Returns the chosen pendings; the caller
    removes them from its queue by identity."""
    if fill <= 0 or not pendings:
        return []
    head = pendings[0]
    family = getattr(head, "family", None)
    if family is None:
        return pendings[:fill]
    take = [head]
    taken = {id(head)}
    for p in pendings[1:]:
        if len(take) >= fill:
            break
        if getattr(p, "family", None) == family:
            take.append(p)
            taken.add(id(p))
    if len(take) < fill:
        for p in pendings[1:]:
            if len(take) >= fill:
                break
            if id(p) not in taken:
                take.append(p)
                taken.add(id(p))
    return take
