"""Configuration of the port: copies of the JAX package's dataclasses.

``ModelConfig``, ``DataConfig`` and ``ServeConfig`` carry the same field
names and defaults as ``alphafold2_tpu/config.py``, so one set of values
configures both packages. Fields the port does not serve yet (sharding,
sparse attention, pipelining, caches, the async frontend) are kept for that
reason; the entry points reject the ones they cannot honour. ``Config.seed``
stands in for the JAX package's ``train.seed``, the one training field
serving reads (parameter init and the MDS start).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass
class ModelConfig:
    dim: int = 256  # trunk embedding width (single-repr channels)
    max_seq_len: int = 2048  # positional-embedding table size (max residues)
    depth: int = 6  # trunk layers (MSA+pair block repeats)
    heads: int = 8  # attention heads per layer
    dim_head: int = 64  # per-head channel width
    attn_dropout: float = 0.0  # attention-prob dropout rate (train only)
    ff_dropout: float = 0.0  # feedforward dropout rate (train only)
    gelu_exact: bool = False  # exact erf GELU in the GEGLU feedforwards
    remat: bool = False  # rematerialize trunk layers (training only)
    remat_policy: Optional[str] = None  # remat checkpoint policy
    reversible: bool = False  # inversion-based O(1)-memory trunk engine
    sparse_self_attn: bool = False  # block-sparse axial self-attention
    cross_attn_compress_ratio: int = 1  # pair-token pooling for cross-attn
    msa_tie_row_attn: bool = False  # tie row-attention logits across MSA rows
    msa_row_shard: bool = False  # shard the MSA-row axis over a mesh
    context_parallel: Optional[str] = None  # None | "ring" | "ulysses"
    flash_attention: Optional[bool] = None  # JAX kernel switch; port: always K1
    grid_parallel: bool = False  # 2D-sharded pair axial attention
    scan_layers: bool = False  # one scanned trunk layer with stacked params
    template_attn_depth: int = 2  # template pointwise-attention layers
    bfloat16: bool = True  # compute dtype (parameters stay float32)
    init_scheme: str = "flax"  # parameter init distributions


@dataclass
class DataConfig:
    crop_len: int = 128  # residues per crop (static shape)
    msa_depth: int = 5  # MSA rows per example
    msa_len: int = 64  # MSA row length (columns)
    batch_size: int = 1  # examples per training batch
    max_len_filter: int = 250  # drop chains longer than this
    min_len_filter: int = 16  # drop chains shorter than this
    source: str = "synthetic"  # "synthetic" | "native" | "npz" | "sidechainnet"
    casp_version: int = 12  # sidechainnet CASP release to load
    thinning: int = 30  # sidechainnet thinning percentage
    data_dir: Optional[str] = None  # on-disk dataset root for "npz"/"native"
    features: str = "msa"  # "msa" | "plm" | "none"
    plm_provider: str = "hash"  # "hash" | "precomputed" | "esm"
    plm_path: Optional[str] = None  # .npz archive for "precomputed"


@dataclass
class ServeConfig:
    """Shape-bucketed batched inference (serve/engine.py): lengths pad up
    the ``buckets`` ladder, requests sharing a bucket batch up to
    ``max_batch`` with fully masked dummy slots."""

    buckets: Tuple[int, ...] = (64, 96, 128, 192, 256)  # residues, ascending
    long_buckets: Tuple[int, ...] = ()  # mesh-gated long-chain rungs
    long_max_batch: int = 1  # requests per dispatch on the long rungs
    max_batch: int = 4  # requests fused per dispatch (batch-dim padded)
    pad_batches: bool = True  # pad partial chunks up to max_batch
    msa_depth: int = 0  # synthesized MSA rows per request; 0 -> data.msa_depth
    mds_iters: int = 200  # structure-realization Guttman iterations
    dtype: str = "float32"  # "float32" | "bfloat16" (params cast at build)
    kernels: str = ""  # JAX kernel-policy spec; the port always runs K1/K2
    donate_buffers: bool = True  # JAX buffer donation
    return_distogram: bool = False  # ship (3L,3L,K) logits back per request
    pipeline_depth: int = 2  # JAX pipelined dispatch depth
    inflight_admission: bool = True  # async frontend: join in-flight batches
    queue_depth: int = 64  # async frontend admission queue
    dwell_ms: float = 25.0  # async frontend fill wait
    default_deadline_s: float = 0.0  # per-request deadline; 0 = none
    cache_size: int = 256  # result cache entries
    shed_watermark: float = 0.75  # queue fraction where low priority sheds
    retry_failed: bool = True  # retry a failed dispatch on another rung
    feature_cache_size: int = 128  # featurized-input cache entries
    delta_featurize: bool = True  # column-patched mutant featurization
    affinity_batching: bool = True  # pack same-family mutants together


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)  # architecture
    data: DataConfig = field(default_factory=DataConfig)  # dataset + features
    serve: ServeConfig = field(default_factory=ServeConfig)  # inference plane
    seed: int = 0  # parameter init + MDS start (JAX: train.seed)
