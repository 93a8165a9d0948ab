"""Data: numpy copies of the JAX package's ``alphafold2_tpu/data/pipeline.py``.

- serving featurization: ``featurize_bucketed`` and the ``_fill_msa`` MSA
  synthesis it uses (:49, :84);
- training batches: the synthetic source, ``_smooth_walk`` (:37),
  ``_synthesize_backbone`` (:72) and ``SyntheticDataset`` (:207); local
  ``.npz`` shards (:308-481): ``_npz_paths``, ``_read_shard`` (shapes
  validated), ``_length_ok``, ``_shard_backbone``, ``shards_carry_msa``,
  ``load_npz_chains`` and ``NpzShardDataset``; and ``make_dataset``
  (:483), which routes ``npz`` and ``native`` (``data/native.py``, built
  from ``native/dataloader.cc``: the shards through its prefetch ring, or
  its synthetic stream without ``data_dir``; shards carrying stored MSAs
  go to the numpy pipeline with ``MSA_FALLBACK_WARNING``, as in JAX). The
  sidechainnet source needs the sidechainnet package and its data and
  raises.

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


def _fill_msa(rng, seq_crop, msa_out, msa_mask_out, mutation_rate=0.15,
              mut_rows=None):
    """Fill (M, NM) MSA rows by mutating the primary sequence. The rng
    stream consumed depends only on (seed state, msa_len, M), never on the
    sequence content: the mutation mask is drawn first, and the
    replacement residues for the masked positions whatever they replace.
    :func:`featurize_delta` rests on that. ``mut_rows`` (a list) collects
    each row's mutation mask for the delta plan."""
    M, NM = msa_out.shape
    msa_len = min(NM, len(seq_crop))
    for m in range(M):
        mut = rng.random(msa_len) < mutation_rate
        row = np.asarray(seq_crop[:msa_len]).copy()
        row[mut] = rng.integers(0, 20, size=int(mut.sum()))
        msa_out[m, :msa_len] = row
        msa_mask_out[m, :msa_len] = True
        if mut_rows is not None:
            mut_rows.append(mut)


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
    item, _ = featurize_bucketed_with_plan(
        seq_tokens, bucket_len, msa_depth, seed=seed, msa_len=msa_len
    )
    return item


def featurize_bucketed_with_plan(
    seq_tokens: np.ndarray,
    bucket_len: int,
    msa_depth: int,
    seed: int = 0,
    msa_len: int | None = None,
) -> tuple:
    """:func:`featurize_bucketed` plus the plan :func:`featurize_delta`
    needs to featurize a point mutant without re-synthesizing the MSA: the
    tokens, the derivation (bucket, msa_depth, msa_len, seed) and the
    per-row mutation masks ``_fill_msa`` drew, which at a given (seed,
    length, depth) do not depend on the sequence. Port of JAX's
    ``data/pipeline.py:106-151``; the item is byte-identical to
    :func:`featurize_bucketed`'s (the same rng order)."""
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
    mut_rows: list = []
    _fill_msa(rng, seq_tokens, item["msa"], item["msa_mask"], mut_rows=mut_rows)
    plan = {
        "tokens": seq_tokens.copy(),
        "bucket_len": int(bucket_len),
        "msa_depth": int(msa_depth),
        "msa_len": int(NM),
        "seed": int(seed),
        # (M, min(NM, L)) bool: where _fill_msa put a random residue
        "mut": np.stack(mut_rows) if mut_rows else np.zeros((0, min(NM, L)), bool),
    }
    return item, plan


def featurize_delta(parent_item: dict, plan: dict, mutant_tokens: np.ndarray) -> dict:
    """Featurize a same-length mutant of ``plan``'s parent by patching only
    the changed columns: the sequence slot, and in each MSA row the
    positions its mutation mask left as the primary residue. Byte-identical
    to cold featurization of the mutant at the parent's (bucket, depth,
    seed). The masks are the parent's arrays (content-independent at equal
    length), so callers treat items as immutable. Raises ``ValueError`` on
    a different length. Port of JAX's ``data/pipeline.py:154-206``."""
    mutant_tokens = np.asarray(mutant_tokens, np.int32).reshape(-1)
    parent_tokens = plan["tokens"]
    if len(mutant_tokens) != len(parent_tokens):
        raise ValueError(
            f"delta featurization needs equal lengths: mutant "
            f"{len(mutant_tokens)} vs parent {len(parent_tokens)}"
        )
    positions = np.nonzero(mutant_tokens != parent_tokens)[0]
    seq = parent_item["seq"].copy()
    msa = parent_item["msa"].copy()
    mut = plan["mut"]  # (M, eff_len) bool
    eff_len = mut.shape[1] if mut.size else min(plan["msa_len"], len(parent_tokens))
    for p in positions:
        seq[p] = mutant_tokens[p]
        if p < eff_len:
            msa[~mut[:, p], p] = mutant_tokens[p]
    return {"seq": seq, "mask": parent_item["mask"], "msa": msa,
            "msa_mask": parent_item["msa_mask"]}


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


def _npz_paths(data_dir: str) -> list:
    import glob
    import os

    if not data_dir:
        raise ValueError("npz shards need data.data_dir")
    paths = sorted(glob.glob(os.path.join(data_dir, "*.npz")))
    if not paths:
        raise FileNotFoundError(f"no .npz shards under {data_dir!r}")
    return paths


def _read_shard(path: str):
    """One shard -> (seq (L,) int32, coords float32, msa (M, L) int32 or
    None), shape-validated so a malformed shard fails here and not in the
    native loader, which trusts lengths."""
    with np.load(path) as z:
        seq = np.ascontiguousarray(z["seq"], np.int32)
        coords = np.asarray(z["coords"], np.float32)
        msa = np.asarray(z["msa"], np.int32) if "msa" in z else None
    n = len(seq)
    ok = (coords.ndim == 2 and coords.shape == (n, 3)) or (
        coords.ndim == 3 and coords.shape[0] == n and coords.shape[1] >= 3
        and coords.shape[2] == 3)
    if not ok:
        raise ValueError(
            f"shard {path!r}: coords shape {coords.shape} does not match "
            f"seq length {n} (want (L, 3) CA or (L, k>=3, 3) atomic)")
    if msa is not None and (msa.ndim != 2 or msa.shape[1] != n):
        raise ValueError(
            f"shard {path!r}: msa shape {msa.shape} does not match seq length {n} "
            "(want (M, L))")
    return seq, coords, msa


def _length_ok(n: int, config: DataConfig) -> bool:
    return max(4, config.min_len_filter) <= n <= config.max_len_filter


def _shard_backbone(coords: np.ndarray, rng) -> tuple:
    """coords -> (ca (L, 3), backbone atoms (L*3, 3)); CA-only shards get
    synthesized N/C pseudo-atoms so structure losses have a target."""
    if coords.ndim == 3:  # (L, k, 3) atomic: slots 0..2 are N/CA/C
        return coords[:, 1], coords[:, :3].reshape(-1, 3)
    return coords, _synthesize_backbone(rng, coords)


# one message for the one policy, whichever entry point detects it
MSA_FALLBACK_WARNING = (
    "shards carry stored MSAs, which the native loader would replace with "
    "mutation-synthesized ones; use the numpy npz pipeline "
    "(data.source='npz') to train on the stored alignments"
)


def shards_carry_msa(config: DataConfig) -> bool:
    """Does any length-passing shard store an MSA? Reads only the zip
    directories and the ``seq`` arrays."""
    for p in _npz_paths(config.data_dir):
        with np.load(p) as z:
            if "msa" in z.files and _length_ok(len(z["seq"]), config):
                return True
    return False


def load_npz_chains(config: DataConfig, seed: int = 0) -> tuple:
    """Every length-filtered chain of the shard directory as ``(seq (L,)
    int32, backbone (L, 3, 3) float32)``, the registry the native loader
    copies once, and whether any of them stores an MSA (which the registry
    cannot hold): ``(chains, any_msa)``. ``seed`` draws the N/C
    pseudo-atoms of CA-only shards, once for the run."""
    rng = np.random.default_rng(seed)
    chains = []
    any_msa = False
    for p in _npz_paths(config.data_dir):
        seq, coords, msa = _read_shard(p)
        if not _length_ok(len(seq), config):
            continue
        any_msa = any_msa or msa is not None
        _, backbone_atoms = _shard_backbone(coords, rng)
        chains.append((seq, np.ascontiguousarray(backbone_atoms.reshape(len(seq), 3, 3))))
    if not chains:
        raise ValueError(
            f"no shard in {config.data_dir!r} passes the length filter "
            f"[{config.min_len_filter}, {config.max_len_filter}]")
    return chains, any_msa


@dataclasses.dataclass
class NpzShardDataset:
    """Local real data: a directory of ``.npz`` shards, one chain each
    (``seq`` (L,) AA tokens, ``coords`` (L, 3) CA or (L, k>=3, 3) with
    slots 0..2 N/CA/C, optional ``msa`` (M, L)), length-filtered, cropped
    and padded to static shapes and cycled forever in a seeded shuffle;
    missing MSA rows are synthesized by mutation. ``import_pdbs`` writes
    such shards from PDB files."""

    config: DataConfig
    seed: int = 0

    def __post_init__(self):
        self.paths = _npz_paths(self.config.data_dir)

    def __iter__(self) -> Iterator[dict]:
        cfg = self.config
        rng = np.random.default_rng(self.seed)
        L, M, NM, B = cfg.crop_len, cfg.msa_depth, cfg.msa_len, cfg.batch_size
        order = np.arange(len(self.paths))
        buf = []
        while True:
            rng.shuffle(order)
            accepted = 0
            for idx in order:
                seq, coords, msa_full = _read_shard(self.paths[idx])
                n = len(seq)
                if not _length_ok(n, cfg):
                    continue
                accepted += 1
                ca, backbone_atoms = _shard_backbone(coords, rng)
                start = 0 if n <= L else int(rng.integers(0, n - L + 1))
                end = min(start + L, n)
                w = end - start
                item = {
                    "seq": np.full(L, constants.AA_PAD_INDEX, np.int32),
                    "msa": np.full((M, NM), constants.AA_PAD_INDEX, np.int32),
                    "mask": np.zeros(L, bool),
                    "msa_mask": np.zeros((M, NM), bool),
                    "coords": np.zeros((L, 3), np.float32),
                    "backbone": np.zeros((L * 3, 3), np.float32),
                }
                item["seq"][:w] = seq[start:end]
                item["mask"][:w] = True
                item["coords"][:w] = ca[start:end]
                item["backbone"][: w * 3] = backbone_atoms[start * 3: end * 3]
                if msa_full is not None:
                    msa_len = min(NM, w)
                    rows = min(M, len(msa_full))
                    item["msa"][:rows, :msa_len] = msa_full[:rows, start: start + msa_len]
                    item["msa_mask"][:rows, :msa_len] = True
                    if rows < M:
                        _fill_msa(rng, seq[start:end], item["msa"][rows:],
                                  item["msa_mask"][rows:])
                else:
                    _fill_msa(rng, seq[start:end], item["msa"], item["msa_mask"])
                buf.append(item)
                if len(buf) == B:
                    yield {k: np.stack([it[k] for it in buf]) for k in buf[0]}
                    buf = []
            if accepted == 0:
                raise ValueError(
                    f"no shard in {cfg.data_dir!r} passes the length filter "
                    f"[{cfg.min_len_filter}, {cfg.max_len_filter}]")


def make_dataset(config: DataConfig, seed: int = 0):
    """The batch source ``config.source`` names (module docstring)."""
    if config.source == "synthetic":
        return SyntheticDataset(config, seed=seed)
    if config.source == "native":
        from alphafold2_tpu_torch.data import native

        if not config.data_dir:
            return native.NativeSyntheticLoader(config, seed=seed)
        if shards_carry_msa(config):
            import warnings

            warnings.warn(MSA_FALLBACK_WARNING)
            return NpzShardDataset(config, seed=seed)
        return native.NativeShardLoader(config, seed=seed)
    if config.source == "npz":
        return NpzShardDataset(config, seed=seed)
    if config.source == "sidechainnet":
        raise NotImplementedError(
            "data source 'sidechainnet' needs the sidechainnet package and its data")
    raise ValueError(f"unknown data source {config.source!r}")
