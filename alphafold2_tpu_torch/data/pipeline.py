"""Data: numpy copies of the JAX package's ``alphafold2_tpu/data/pipeline.py``.

- serving featurization: ``featurize_bucketed`` and the ``_fill_msa`` MSA
  synthesis it uses (:49, :84);
- training batches: the synthetic source, ``_smooth_walk`` (:37),
  ``_synthesize_backbone`` (:72), ``SyntheticDataset`` (:207) and
  ``make_dataset`` (:483). The native, npz and sidechainnet sources are not
  ported and raise.

Each must stay byte-identical to the original (same rng consumption order);
tests/test_torch_port_modules.py and tests/test_torch_port_train.py hold the
two against each other. Batches are dicts of numpy arrays: seq (B, L) int32,
msa (B, M, NM) int32, mask (B, L) bool, msa_mask (B, M, NM) bool, coords
(B, L, 3) f32 CA positions, backbone (B, 3L, 3) f32 N/CA/C positions.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

from alphafold2_tpu_torch import constants
from alphafold2_tpu_torch.config import DataConfig


def _smooth_walk(rng: np.random.Generator, n: int) -> np.ndarray:
    """Compact protein-like CA trace: random walk with ~3.8A steps, smoothed."""
    steps = rng.normal(size=(n, 3))
    steps /= np.linalg.norm(steps, axis=-1, keepdims=True) + 1e-9
    # correlate consecutive steps for secondary-structure-like persistence
    for i in range(1, n):
        steps[i] = 0.6 * steps[i - 1] + 0.4 * steps[i]
        steps[i] /= np.linalg.norm(steps[i]) + 1e-9
    coords = np.cumsum(3.8 * steps, axis=0)
    return (coords - coords.mean(0)).astype(np.float32)


def _fill_msa(rng, seq_crop, msa_out, msa_mask_out, mutation_rate=0.15):
    """Fill (M, NM) MSA rows by mutating the primary sequence. The rng
    stream consumed depends only on (seed state, msa_len, M), never on the
    sequence content."""
    M, NM = msa_out.shape
    msa_len = min(NM, len(seq_crop))
    for m in range(M):
        mut = rng.random(msa_len) < mutation_rate
        row = np.asarray(seq_crop[:msa_len]).copy()
        row[mut] = rng.integers(0, 20, size=int(mut.sum()))
        msa_out[m, :msa_len] = row
        msa_mask_out[m, :msa_len] = True


def _synthesize_backbone(rng: np.random.Generator, ca: np.ndarray) -> np.ndarray:
    """Place N and C pseudo-atoms ~1.5A off each CA along the chain direction."""
    n = ca.shape[0]
    d = np.diff(ca, axis=0, prepend=ca[:1] - (ca[1:2] - ca[:1]))
    d /= np.linalg.norm(d, axis=-1, keepdims=True) + 1e-9
    jitter = rng.normal(scale=0.1, size=(n, 3)).astype(np.float32)
    n_atom = ca - 1.46 * d + jitter
    c_atom = ca + 1.52 * d - jitter
    bb = np.stack([n_atom, ca, c_atom], axis=1)  # (L, 3, 3)
    return bb.reshape(n * 3, 3).astype(np.float32)


def featurize_bucketed(
    seq_tokens: np.ndarray,  # (L,) int32 AA tokens
    bucket_len: int,
    msa_depth: int,
    seed: int = 0,
    msa_len: int | None = None,
) -> dict:
    """One request -> unbatched fixed-shape features at a bucket length:
    ``seq``/``mask`` (bucket,), ``msa``/``msa_mask`` (msa_depth, msa_len or
    bucket), padded with ``AA_PAD_INDEX`` and False."""
    seq_tokens = np.asarray(seq_tokens, np.int32).reshape(-1)
    L = len(seq_tokens)
    if L > bucket_len:
        raise ValueError(
            f"sequence of {L} residues does not fit bucket {bucket_len}"
        )
    NM = msa_len or bucket_len
    rng = np.random.default_rng(seed)
    item = {
        "seq": np.full(bucket_len, constants.AA_PAD_INDEX, np.int32),
        "mask": np.zeros(bucket_len, bool),
        "msa": np.full((msa_depth, NM), constants.AA_PAD_INDEX, np.int32),
        "msa_mask": np.zeros((msa_depth, NM), bool),
    }
    item["seq"][:L] = seq_tokens
    item["mask"][:L] = True
    _fill_msa(rng, seq_tokens, item["msa"], item["msa_mask"])
    return item


@dataclasses.dataclass
class SyntheticDataset:
    """Deterministic synthetic chains; infinite iterator of fixed-shape batches."""

    config: DataConfig
    seed: int = 0

    def __iter__(self) -> Iterator[dict]:
        cfg = self.config
        rng = np.random.default_rng(self.seed)
        L, M, NM, B = cfg.crop_len, cfg.msa_depth, cfg.msa_len, cfg.batch_size
        while True:
            batch = {
                "seq": np.zeros((B, L), np.int32),
                "msa": np.zeros((B, M, NM), np.int32),
                "mask": np.zeros((B, L), bool),
                "msa_mask": np.zeros((B, M, NM), bool),
                "coords": np.zeros((B, L, 3), np.float32),
                "backbone": np.zeros((B, L * 3, 3), np.float32),
            }
            min_len = min(cfg.min_len_filter, L)  # crop below the filter floor
            for b in range(B):
                true_len = int(rng.integers(min_len, L + 1))
                seq = rng.integers(0, 20, size=true_len)
                ca = _smooth_walk(rng, true_len)
                batch["seq"][b, :true_len] = seq
                batch["seq"][b, true_len:] = constants.AA_PAD_INDEX
                batch["mask"][b, :true_len] = True
                batch["coords"][b, :true_len] = ca
                batch["backbone"][b, : true_len * 3] = _synthesize_backbone(rng, ca)
                batch["msa"][b, :, :] = constants.AA_PAD_INDEX
                _fill_msa(rng, seq, batch["msa"][b], batch["msa_mask"][b])
            yield batch


def make_dataset(config: DataConfig, seed: int = 0):
    """The batch source ``config.source`` names: ``synthetic`` only."""
    if config.source == "synthetic":
        return SyntheticDataset(config, seed=seed)
    if config.source in ("native", "npz", "sidechainnet"):
        raise NotImplementedError(f"data source {config.source!r} is not ported yet")
    raise ValueError(f"unknown data source {config.source!r}")
