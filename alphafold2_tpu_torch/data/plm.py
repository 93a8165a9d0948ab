"""Protein-language-model embeddings for the ``embedds`` input.

Port of ``alphafold2_tpu/data/plm.py`` (numpy only, with the port's own
``constants``): the model's ``embedds`` argument and its ``embedd_project``
are the boundary, the provider is pluggable.

- :class:`HashProjectionProvider`: a fixed random projection of residue
  identity plus sinusoidal position features, deterministic per seed; it
  draws from the same ``default_rng(seed)`` as JAX's and gives the same
  float32 array bit for bit. It needs no weights, so the whole PLM path
  trains and tests without them.
- :class:`PrecomputedProvider`: embeddings exported ahead of time to an
  ``.npz`` archive keyed by sequence string.
- :class:`TransformersESMProvider`: a HuggingFace ESM checkpoint, only when
  ``transformers`` is installed (``ImportError`` otherwise) and the
  checkpoint is cached locally (``RuntimeError`` otherwise: it never
  downloads).
- :func:`wrap_with_embeddings`: the batch-stream adapter that adds
  ``embedds`` and drops ``msa``/``msa_mask`` (the two are exclusive model
  inputs).
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

from alphafold2_tpu_torch import constants


def _sequence_strings(seq: np.ndarray) -> list:
    """(B, L) tokens -> one AA_ALPHABET string a row, "X" past the 20."""
    return ["".join(constants.AA_ALPHABET[t] if t < 20 else "X" for t in row)
            for row in np.asarray(seq)]


class HashProjectionProvider:
    """A deterministic pseudo-PLM: a random (NUM_AMINO_ACIDS, dim) table
    looked up by token, plus sinusoidal position features."""

    def __init__(self, dim: int = constants.NUM_EMBEDDS_TR, seed: int = 0):
        self.dim = dim
        rng = np.random.default_rng(seed)
        self._aa_table = rng.normal(
            scale=1.0, size=(constants.NUM_AMINO_ACIDS, dim)).astype(np.float32)

    def __call__(self, seq: np.ndarray) -> np.ndarray:
        """(B, L) int tokens -> (B, L, dim) float32 embeddings."""
        seq = np.asarray(seq)
        emb = self._aa_table[seq]
        pos = np.arange(seq.shape[1], dtype=np.float32)
        freqs = np.exp(-np.log(10000.0) * np.arange(0, self.dim, 2, dtype=np.float32)
                       / self.dim)
        ang = pos[:, None] * freqs[None, :]
        pe = np.zeros((seq.shape[1], self.dim), np.float32)
        pe[:, 0::2] = np.sin(ang)[:, : pe[:, 0::2].shape[1]]
        pe[:, 1::2] = np.cos(ang)[:, : pe[:, 1::2].shape[1]]
        return emb + pe[None]


class PrecomputedProvider:
    """Embeddings looked up from an ``.npz`` archive keyed by sequence
    string (AA_ALPHABET letters, "X" for the pad token); a sequence the
    archive lacks raises ``KeyError``."""

    def __init__(self, npz_path: str):
        self._store = np.load(npz_path)

    def __call__(self, seq: np.ndarray) -> np.ndarray:
        return np.stack([np.asarray(self._store[key], np.float32)
                         for key in _sequence_strings(seq)])


class TransformersESMProvider:
    """Frozen ESM through HuggingFace ``transformers``, from a locally
    cached checkpoint only."""

    def __init__(self, model_name: str = "facebook/esm1b_t33_650M_UR50S"):
        try:
            from transformers import AutoModel, AutoTokenizer
        except ImportError as e:
            raise ImportError("transformers required for ESM") from e
        try:
            self._tok = AutoTokenizer.from_pretrained(model_name, local_files_only=True)
            self._model = AutoModel.from_pretrained(model_name, local_files_only=True).eval()
        except OSError as e:
            raise RuntimeError(
                f"ESM checkpoint {model_name!r} not cached locally and this environment "
                "has no network; precompute embeddings elsewhere and use "
                "PrecomputedProvider") from e

    def __call__(self, seq: np.ndarray) -> np.ndarray:
        import torch

        with torch.no_grad():
            toks = self._tok(_sequence_strings(seq), return_tensors="pt", padding=True)
            h = self._model(**toks).last_hidden_state
        return h[:, 1: 1 + np.asarray(seq).shape[1]].float().numpy()


def make_provider(kind: str, dim: int = constants.NUM_EMBEDDS_TR,
                  path: Optional[str] = None, seed: int = 0):
    """``data.plm_provider`` -> a provider: "hash", "precomputed" (needs
    ``path``) or "esm"."""
    if kind == "hash":
        return HashProjectionProvider(dim=dim, seed=seed)
    if kind == "precomputed":
        if not path:
            raise ValueError("precomputed provider needs data.plm_path")
        return PrecomputedProvider(path)
    if kind == "esm":
        return TransformersESMProvider()
    raise ValueError(f"unknown plm provider {kind!r}")


def wrap_with_embeddings(dataset, provider) -> Iterator[dict]:
    """Each batch with ``embedds`` (the provider's output for its ``seq``)
    added and ``msa``/``msa_mask`` dropped."""
    for batch in dataset:
        out = {k: v for k, v in batch.items() if k not in ("msa", "msa_mask")}
        out["embedds"] = provider(batch["seq"])
        yield out
