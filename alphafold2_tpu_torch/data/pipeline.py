"""Serving featurization: a numpy copy of the JAX package's
``alphafold2_tpu/data/pipeline.py`` ``featurize_bucketed`` and the
``_fill_msa`` MSA synthesis it uses. It must stay byte-identical to the
original (same rng consumption order); tests/test_torch_port_modules.py
holds the two against each other."""

from __future__ import annotations

import numpy as np

from alphafold2_tpu_torch import constants


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
