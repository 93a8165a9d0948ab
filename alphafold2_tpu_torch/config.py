"""Configuration of the port: copies of the JAX package's dataclasses.

``ModelConfig``, ``MeshConfig``, ``DataConfig``, ``ServeConfig`` and
``TrainConfig`` carry the same field names and defaults as
``alphafold2_tpu/config.py``, so one set of values configures both packages,
and ``Config.apply_overrides`` / :func:`parse_cli` read the same
``section.field=value`` strings. Fields the port does not serve yet
(sharding, sparse attention, pipelining, caches, the async frontend,
checkpoints, profiling) are kept for that reason; the entry points reject
the ones they cannot honour. ``train.seed`` seeds parameter init, the data
order and the MDS start, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
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
    flash_attention: Optional[bool] = None  # flat passes: True SDPA, False plain, None policy
    grid_parallel: bool = False  # 2D-sharded pair axial attention
    scan_layers: bool = False  # one scanned trunk layer with stacked params
    template_attn_depth: int = 2  # template pointwise-attention layers
    bfloat16: bool = True  # compute dtype (parameters stay float32)
    init_scheme: str = "flax"  # parameter init distributions


@dataclass
class MeshConfig:
    data_parallel: int = 1  # dp axis size; -1 = fill with all devices
    seq_parallel: int = 1  # sp axis size (pair-map row sharding)
    grid_rows: int = 1  # spr axis (pair-row shards)
    grid_cols: int = 1  # spc axis (pair-col shards)


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
    kernels: str = ""  # kernel-policy spec (ops/kernels.py); "" = the process's AF2TPU_KERNELS
    donate_buffers: bool = True  # JAX buffer donation; accepted, ignored (no counterpart)
    return_distogram: bool = False  # ship (3L,3L,K) logits back per request
    pipeline_depth: int = 2  # batches in flight on the CUDA-stream pipeline; 0 = serial
    inflight_admission: bool = True  # async frontend: join batches still forming
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
class TrainConfig:
    learning_rate: float = 3e-4  # peak of the warmup-cosine schedule
    num_steps: int = 100000  # steps of a training run
    gradient_accumulate_every: int = 16  # micro-steps per optimizer update
    warmup_steps: int = 1000  # linear LR warmup steps before cosine decay
    weight_decay: float = 0.0  # AdamW decoupled weight decay
    seed: int = 0  # seed of parameter init, data order and the MDS start
    log_every: int = 50  # steps between train-metric log lines
    checkpoint_every: int = 1000  # steps between checkpoint writes
    checkpoint_dir: Optional[str] = None  # checkpoint root; None disables
    keep_checkpoints: int = 3  # newest checkpoints retained
    profile_dir: Optional[str] = None  # profiler trace output
    profile_steps: Tuple[int, int] = (10, 13)  # [start, end) profiled steps
    trace_events: Optional[str] = None  # host-side span trace output
    # "off" | "triage" (per-parameter-group norms every step) | "full"
    numerics: str = "triage"


def _tuplify(section, name):
    """JSON round-trips tuples as lists; restore the tuple type so configs
    compare equal (the engine's keys hold buckets), as JAX's
    ``config.py:185`` does."""
    value = getattr(section, name)
    if isinstance(value, list):
        setattr(section, name, tuple(value))
    return section


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)  # architecture
    mesh: MeshConfig = field(default_factory=MeshConfig)  # device mesh axes
    data: DataConfig = field(default_factory=DataConfig)  # dataset + features
    train: TrainConfig = field(default_factory=TrainConfig)  # optimizer loop
    serve: ServeConfig = field(default_factory=ServeConfig)  # inference plane

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, s: str) -> "Config":
        """The inverse of :meth:`to_json` (JAX's ``config.py:205``): the
        tuple fields ``train.profile_steps``, ``serve.buckets`` and
        ``serve.long_buckets`` come back as tuples."""
        raw = json.loads(s)
        return cls(
            model=ModelConfig(**raw.get("model", {})),
            mesh=MeshConfig(**raw.get("mesh", {})),
            data=DataConfig(**raw.get("data", {})),
            train=_tuplify(TrainConfig(**raw.get("train", {})), "profile_steps"),
            serve=_tuplify(_tuplify(ServeConfig(**raw.get("serve", {})), "buckets"),
                           "long_buckets"),
        )

    def apply_overrides(self, overrides: list) -> "Config":
        """Apply ``section.field=value`` strings (CLI) onto a copy."""
        cfg = dataclasses.replace(
            self, **{f.name: dataclasses.replace(getattr(self, f.name))
                     for f in dataclasses.fields(self)})
        for item in overrides:
            key, _, value = item.partition("=")
            key = key.lstrip("-")
            section_name, _, field_name = key.partition(".")
            section = getattr(cfg, section_name, None)
            if section is None or not hasattr(section, field_name):
                raise KeyError(f"unknown config field {key!r}")
            current = getattr(section, field_name)
            if isinstance(current, bool):
                parsed = value.lower() in ("1", "true", "yes")
            elif isinstance(current, int):
                parsed = int(value)
            elif isinstance(current, float):
                parsed = float(value)
            elif isinstance(current, tuple):
                # comma-separated ints, e.g. --serve.buckets=64,128,256
                parsed = tuple(int(v) for v in value.split(",") if v)
            else:
                parsed = value
            setattr(section, field_name, parsed)
        return cfg


def parse_cli(argv: list, base: Optional[Config] = None) -> Config:
    """``section.field=value`` arguments (``--`` prefix optional) onto
    ``base`` (default ``Config()``); arguments without ``=`` are ignored."""
    cfg = base or Config()
    return cfg.apply_overrides([a for a in argv if "=" in a])
