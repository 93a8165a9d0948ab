"""Serving: shape-bucketed, batched inference with compile accounting.

Port of ``alphafold2_tpu/serve/`` on one device:
:mod:`~alphafold2_tpu_torch.serve.engine` (the batched engine),
:mod:`~alphafold2_tpu_torch.serve.bucketing` (the ladder and the mutant
families), :mod:`~alphafold2_tpu_torch.serve.scheduler` (the async
open-loop frontend: admission control, deadlines, shedding, retry,
continuous batch formation), :mod:`~alphafold2_tpu_torch.serve.cache` (the
result cache with in-flight dedup, the feature cache),
:mod:`~alphafold2_tpu_torch.serve.faults` (deterministic fault injection)
and :mod:`~alphafold2_tpu_torch.serve.pipeline` (pipelined dispatch on CUDA
streams with in-flight admission). Configured by ``config.ServeConfig``.
The multi-replica fleet (``FleetFrontend``, ``ReplicaCell``) is not
ported; ``FleetFaultPlan`` is, and waits for it.
"""

from alphafold2_tpu_torch.serve.bucketing import (
    FamilyTracker,
    affinity_take,
    bucket_for,
    formation_ripe,
    geometric_ladder,
    padding_fraction,
    point_mutation,
    validate_ladder,
)
from alphafold2_tpu_torch.serve.cache import (
    FeatureCache,
    ResultCache,
    feature_fingerprint,
    feature_key,
    result_key,
)
from alphafold2_tpu_torch.serve.engine import ServeEngine, ServeRequest, ServeResult
from alphafold2_tpu_torch.serve.faults import FaultPlan, FleetFaultPlan, InjectedFault
from alphafold2_tpu_torch.serve.pipeline import (
    DispatchHandle,
    PipelineBatch,
    PipelinedDispatcher,
)
from alphafold2_tpu_torch.serve.scheduler import AsyncServeFrontend, PendingResult

__all__ = [
    "AsyncServeFrontend",
    "DispatchHandle",
    "FamilyTracker",
    "FaultPlan",
    "FeatureCache",
    "FleetFaultPlan",
    "InjectedFault",
    "PendingResult",
    "PipelineBatch",
    "PipelinedDispatcher",
    "ResultCache",
    "ServeEngine",
    "ServeRequest",
    "ServeResult",
    "affinity_take",
    "bucket_for",
    "feature_fingerprint",
    "feature_key",
    "formation_ripe",
    "geometric_ladder",
    "padding_fraction",
    "point_mutation",
    "result_key",
    "validate_ladder",
]
