"""Shape-bucketed, batched inference engine over the end-to-end model.

Port of the core of ``alphafold2_tpu/serve/engine.py``: request lengths
pad up the bucket ladder (``serve.buckets``), requests sharing a bucket are
fused up to ``serve.max_batch`` per dispatch, and partial chunks are padded
with fully masked dummy slots (:700-715). The token mask flows through the
trunk, the realization (zero MDS weight on padded pairs, padding-blind
chirality, position-keyed MDS start) and the refiner, so a request's
valid-region coordinates do not depend on its bucket or batch partners.

The engine runs on the CUDA card unless built with ``device="cpu"``.
Pipelining, caches, meshes, fault injection and the async frontend are not
ported yet.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence, Union

import numpy as np
import torch

from alphafold2_tpu_torch import constants
from alphafold2_tpu_torch.config import Config
from alphafold2_tpu_torch.data.pipeline import featurize_bucketed
from alphafold2_tpu_torch.device import resolve_device
from alphafold2_tpu_torch.predict import build_model, encode_sequence, init_params


@dataclasses.dataclass
class ServeRequest:
    """One request; ``seed`` drives the synthesized MSA and nothing else."""

    seq: str
    seed: int = 0


@dataclasses.dataclass
class ServeResult:
    """One request's outcome: ``status`` "ok" (arrays set) or "error"
    (the dispatch raised; ``error`` holds the message). An error is
    converted, never propagated, so a batch partner's poison pill cannot
    crash the caller. ``latency_s`` is ``queue_wait_s + dispatch_s``, as
    JAX's engine reports it."""

    seq: str
    bucket: int
    atom14: Optional[np.ndarray] = None  # (L, 14, 3) refined all-atom coords
    backbone: Optional[np.ndarray] = None  # (L, 3, 3) N/CA/C
    weights: Optional[np.ndarray] = None  # (3L, 3L) distogram confidence
    distogram: Optional[np.ndarray] = None  # (3L, 3L, K) logits if requested
    latency_s: float = 0.0  # queue wait + dispatch: what a caller observes
    queue_wait_s: float = 0.0  # from the start of predict_many to its dispatch's start
    dispatch_s: float = 0.0  # wall time of the dispatch that carried it
    status: str = "ok"
    error: Optional[str] = None

    @property
    def ok(self) -> bool:
        return self.status == "ok"


def bucket_for(length: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if length <= b:
            return b
    raise ValueError(f"sequence of {length} residues exceeds the largest "
                     f"bucket {buckets[-1]}")


class ServeEngine:
    """Synchronous bucketed/batched engine.

    >>> engine = ServeEngine(cfg)               # the CUDA card
    >>> results = engine.predict_many(["ACDEFGH...", "MKV..."])

    ``state_dict`` (e.g. from ``convert.to_state_dict``) or
    ``checkpoint_dir`` (the latest checkpoint's parameters, restored through
    ``CheckpointManager.restore_params`` before any bf16 cast, as JAX's
    engine restores them) replaces the random weights drawn from
    ``cfg.train.seed``; passing both raises, as ``predict`` does.
    ``counters`` counts requests, batches and padded slots/residues."""

    def __init__(self, cfg: Config, state_dict: Optional[dict] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 checkpoint_dir: Optional[str] = None):
        if state_dict is not None and checkpoint_dir:
            raise ValueError("pass state_dict or checkpoint_dir, not both")
        self.cfg = cfg
        self.device = resolve_device(device)
        buckets = tuple(int(b) for b in cfg.serve.buckets)
        if not buckets or list(buckets) != sorted(set(buckets)) or buckets[0] < 1:
            raise ValueError(f"serve.buckets must ascend strictly, got {buckets}")
        if cfg.serve.long_buckets:
            raise NotImplementedError("mesh-gated long buckets are not ported yet")
        if 3 * buckets[-1] > cfg.model.max_seq_len:
            raise ValueError(
                f"largest bucket {buckets[-1]} elongates to {3 * buckets[-1]} "
                f"tokens > model.max_seq_len={cfg.model.max_seq_len}"
            )
        self.buckets = buckets
        self.max_batch = int(cfg.serve.max_batch)
        if self.max_batch < 1:
            raise ValueError(f"serve.max_batch must be >= 1, got {self.max_batch}")
        self.msa_depth = int(cfg.serve.msa_depth or cfg.data.msa_depth)
        if self.msa_depth > constants.MAX_NUM_MSA:
            raise ValueError(f"serve msa_depth={self.msa_depth} exceeds "
                             f"MAX_NUM_MSA={constants.MAX_NUM_MSA}")
        if cfg.serve.dtype not in ("float32", "bfloat16"):
            raise ValueError(f"serve.dtype must be 'float32' or 'bfloat16', "
                             f"got {cfg.serve.dtype!r}")
        model = build_model(cfg, mds_iters=cfg.serve.mds_iters)
        if cfg.serve.dtype == "bfloat16":
            model.af2.dtype = model.refiner.dtype = torch.bfloat16
        if state_dict is not None:
            model.load_state_dict(state_dict)
        elif checkpoint_dir:
            from alphafold2_tpu_torch.train.checkpoint import CheckpointManager

            CheckpointManager(checkpoint_dir).restore_params(model)
        else:
            init_params(model, cfg.train.seed)
        if cfg.serve.dtype == "bfloat16":
            model = model.to(torch.bfloat16)
        self.model = model.to(self.device).eval()
        self.counters = {"requests": 0, "batches": 0, "padded_slots": 0,
                         "padded_residues": 0}

    def _padded_batch(self, n_real: int) -> int:
        return self.max_batch if self.cfg.serve.pad_batches else n_real

    def _dummy_item(self, bucket: int) -> dict:
        """A fully masked batch-padding slot."""
        return {
            "seq": np.full(bucket, constants.AA_PAD_INDEX, np.int32),
            "mask": np.zeros(bucket, bool),
            "msa": np.full((self.msa_depth, bucket), constants.AA_PAD_INDEX, np.int32),
            "msa_mask": np.zeros((self.msa_depth, bucket), bool),
        }

    def _run(self, bucket: int, items: list) -> dict:
        """One forward over a stacked batch; returns host arrays (the
        distogram logits too with ``serve.return_distogram``)."""
        stacked = {k: np.stack([it[k] for it in items]) for k in items[0]}
        dev = self.device

        def t(key):
            return torch.from_numpy(stacked[key]).to(dev, non_blocking=True)

        with torch.inference_mode():
            out = self.model(t("seq").long(), t("msa").long(), mask=t("mask"),
                             msa_mask=t("msa_mask"))
            picked = {"refined": out["refined"], "weights": out["weights"]}
            if self.cfg.serve.return_distogram:
                picked["distogram"] = out["distogram"]
            return {k: v.float().cpu().numpy() for k, v in picked.items()}

    def _dispatch(self, bucket: int, reqs: list, arrival: float) -> list:
        """One chunk of a bucket: featurize, run, unpad. ``arrival`` (a
        ``time.perf_counter`` stamp, the start of ``predict_many``) is the
        queue wait's origin. Any exception becomes per-request error
        results."""
        batch = self._padded_batch(len(reqs))
        self.counters["batches"] += 1
        self.counters["padded_slots"] += batch - len(reqs)
        t0 = time.perf_counter()
        wait = max(0.0, t0 - arrival)
        try:
            items = []
            for r in reqs:
                self.counters["padded_residues"] += bucket - len(r.seq)
                items.append(featurize_bucketed(
                    encode_sequence(r.seq)[0], bucket, self.msa_depth, seed=r.seed
                ))
            items += [self._dummy_item(bucket) for _ in range(batch - len(reqs))]
            out = self._run(bucket, items)
        except Exception as e:  # noqa: BLE001 — converted per request, as JAX does
            msg = f"{type(e).__name__}: {e}"
            dt = time.perf_counter() - t0
            return [ServeResult(seq=r.seq, bucket=bucket, latency_s=wait + dt,
                                queue_wait_s=wait, dispatch_s=dt, status="error", error=msg)
                    for r in reqs]
        dt = time.perf_counter() - t0
        results = []
        disto = out.get("distogram")
        for slot, r in enumerate(reqs):
            L = len(r.seq)
            atom14 = out["refined"][slot, :L]
            results.append(ServeResult(
                seq=r.seq, bucket=bucket, atom14=atom14, backbone=atom14[:, :3],
                weights=out["weights"][slot, : 3 * L, : 3 * L],
                distogram=disto[slot, : 3 * L, : 3 * L] if disto is not None else None,
                latency_s=wait + dt, queue_wait_s=wait, dispatch_s=dt,
            ))
        return results

    def predict_many(self, requests: Sequence[Union[str, ServeRequest]]) -> list:
        """Serve a request list: group by bucket, batch, dispatch, unpad.
        Results come back in input order. Every request's queue wait counts
        from the start of this call, as in JAX's engine."""
        reqs = [r if isinstance(r, ServeRequest) else ServeRequest(seq=r)
                for r in requests]
        self.counters["requests"] += len(reqs)
        by_bucket: dict = {}
        for i, r in enumerate(reqs):
            if not r.seq:
                raise ValueError(f"request {i} has an empty sequence")
            by_bucket.setdefault(bucket_for(len(r.seq), self.buckets), []).append(i)
        results: list = [None] * len(reqs)
        arrival = time.perf_counter()  # the queue wait's origin
        for bucket in sorted(by_bucket):
            order = by_bucket[bucket]
            for lo in range(0, len(order), self.max_batch):
                chunk = order[lo: lo + self.max_batch]
                for idx, res in zip(chunk, self._dispatch(bucket, [reqs[i] for i in chunk],
                                                          arrival)):
                    results[idx] = res
        return results

    def warmup(self) -> dict:
        """One fully masked dispatch per bucket ahead of traffic (builds
        the kernels and warms the library handles). Returns the counters."""
        for bucket in self.buckets:
            self._run(bucket, [self._dummy_item(bucket)] * self._padded_batch(1))
        return dict(self.counters)
