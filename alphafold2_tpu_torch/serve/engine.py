"""Shape-bucketed, batched inference engine over the end-to-end model.

Port of the single-device surface of ``alphafold2_tpu/serve/engine.py``:

- **Bucketing** — request lengths pad up the ladder (``serve.buckets``,
  :mod:`~alphafold2_tpu_torch.serve.bucketing`); requests sharing a bucket
  are fused up to ``serve.max_batch`` per dispatch, partial chunks padded
  with fully masked dummy slots. The token mask flows through the trunk,
  the realization (zero MDS weight on padded pairs, padding-blind
  chirality, position-keyed MDS start) and the refiner, so a request's
  valid-region coordinates do not depend on its bucket or batch partners.
- **Pipelined dispatch** — with ``serve.pipeline_depth > 0`` (the default,
  2) ``predict_many`` and the async frontend go through
  :class:`~alphafold2_tpu_torch.serve.pipeline.PipelinedDispatcher`: host
  featurization and the host-to-device copy of batch N+1 on a copy stream,
  the forward of batch N on a compute stream, the device-to-host copy of
  batch N-1 into pinned buffers. ``pipeline_depth=0`` dispatches serially.
  The stage methods below serve both paths, so they give the same bytes.
- **Featurization reuse** — a content-addressed
  :class:`~alphafold2_tpu_torch.serve.cache.FeatureCache`
  (``serve.feature_cache_size``) and delta featurization of point mutants
  from a cached parent (``serve.delta_featurize``), byte-identical to cold
  featurization; each dispatched request bumps one of ``serve.feat_hits``,
  ``serve.feat_delta`` and ``serve.feat_misses``.
- **Kernel policy** — ``serve.kernels`` (a spec of ``ops/kernels.py``;
  empty: the process's ``AF2TPU_KERNELS`` at construction) is parsed once
  and activated inside every forward of this engine, on whichever thread
  runs it; its description (``kernels_desc``) joins the key and, when not
  ``"auto"``, the compile records, as JAX's does (``serve/engine.py:264-275,
  :590-595``). A fleet's replicas share one model and each keeps its own.
- **Compile accounting** — eager PyTorch builds no executable, so the
  port's "executable" is one warm run a ``(bucket, batch, dtype, kernels)`` key:
  the first dispatch of a key bumps ``serve.traces`` and
  ``serve.compiles``, runs a fully masked batch of that shape once (which
  builds the kernels at first use and warms the library handles) and
  records ``{"bucket", "batch", "seconds"}`` in ``compile_records``; later
  dispatches of the key bump ``serve.cache_hits``. The counts a traffic
  gives equal JAX's (one compile a rung). The cost analysis is one more
  masked run under :func:`~alphafold2_tpu_torch.observe.flops.
  count_forward` (every PyTorch op's flops, plus the K1/K2 wrappers'
  analytic counts): the record gains ``flops``, ``flops_breakdown`` and
  the run's ``peak_bytes``, and each dispatch adds its key's flops to
  ``executed_flops`` (and ``executed_flops_breakdown``).
- **Observability** — ``counters`` (:class:`~alphafold2_tpu_torch.observe.
  metrics.EventCounters`) under JAX's ``serve.*`` names; ``tracer`` spans
  (featurize → get_executable/compile → dispatch → device_get → unpad);
  ``histograms`` of latency, queue wait, dispatch time, batch occupancy
  and pad ratio; a per-request cost ledger (``ServeResult.cost``).
- **Fault injection** — ``faults`` (:class:`~alphafold2_tpu_torch.serve.
  faults.FaultPlan`) at the top of each dispatch and in the transfer,
  compute and fetch stages; a failed dispatch becomes structured
  per-request ``status="error"`` results, never an exception, and leaves a
  ``dispatch_error`` note (with a once-a-process dump) in the installed
  :mod:`~alphafold2_tpu_torch.observe.flightrec` recorder.

- **Device mesh** — ``ServeEngine(cfg, mesh=...)`` (a ``parallel/``
  DeviceMesh over an initialised process group, one process a device) runs
  every forward sharded: the batch over ``dp``, the pair grid over the
  sequence axes (``models/alphafold2.py``). Rank 0 owns the host side:
  ``predict_many``, featurization, results; every other rank runs
  :meth:`ServeEngine.follow`, which receives each forward's stacked batch
  by broadcast, joins the sharded forward, and returns when rank 0's
  :meth:`close` broadcasts a stop. Results exist only on rank 0. Only a
  mesh admits ``serve.long_buckets`` (the long-chain rungs, batched at
  ``serve.long_max_batch``), as JAX's engine gates them
  (``serve/engine.py:212-230``). The mesh identity keys the executables,
  the compile records (with each rank's ``program_bytes``) and the result
  cache. Rank 0 dispatches on a mesh as anywhere, pipelined by default:
  every collective of a forward, the batch's broadcast first, goes out
  from the one thread that runs the forward (the pipeline's device stage,
  or the serial path), under one lock a mesh that every engine on that
  mesh shares (:func:`mesh_session`), so the forwards reach the followers
  whole and in dispatch order, even from the replicas of a fleet. The
  broadcast sends the host stack the transfer stage already holds (no
  device-to-host copy in the compute stage). A follower needs no pipeline:
  :meth:`ServeEngine.follow` runs the forwards in the order they come.

The engine runs on the CUDA card unless built with ``device="cpu"``.
``state_dict=`` or ``checkpoint_dir=`` replaces the random weights;
``model=`` serves another engine's module as it is (a fleet's replicas
share one parameter set). Parameters are replicated on every rank of a
mesh.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from contextlib import nullcontext
from typing import Optional, Sequence, Union

import numpy as np
import torch

from alphafold2_tpu_torch import constants
from alphafold2_tpu_torch.config import Config
from alphafold2_tpu_torch.data.pipeline import featurize_bucketed_with_plan, featurize_delta
from alphafold2_tpu_torch.device import resolve_device
from alphafold2_tpu_torch.observe import flightrec
from alphafold2_tpu_torch.observe.flops import (
    attention_flops_attribution,
    count_forward,
    executable_costs,
    executable_memory,
)
from alphafold2_tpu_torch.observe.histogram import Histogram
from alphafold2_tpu_torch.observe.memory import MemorySampler
from alphafold2_tpu_torch.observe.metrics import EventCounters
from alphafold2_tpu_torch.observe.tracectx import TraceContext
from alphafold2_tpu_torch.observe.tracing import Tracer
from alphafold2_tpu_torch.ops.kernels import current_policy, parse_policy, use_kernel_policy
from alphafold2_tpu_torch.parallel.sharding import (
    DATA_AXIS, axis_size, broadcast_object, census, census_delta, describe_mesh, is_grid,
    pair_layout, use_mesh,
)
from alphafold2_tpu_torch.predict import build_model, encode_sequence, init_params
from alphafold2_tpu_torch.serve.bucketing import bucket_for, validate_ladder
from alphafold2_tpu_torch.serve.cache import FeatureCache, feature_key
from alphafold2_tpu_torch.utils.mds import position_keyed_init


@dataclasses.dataclass
class ServeRequest:
    """One request. ``seed`` drives the synthesized MSA (and nothing
    else). ``arrival_s`` (``time.perf_counter``) makes queue-wait
    accounting per request; ``priority`` and ``deadline_s`` (relative
    seconds) are the frontend's inputs; requests sharing ``parent_id`` are
    one mutant family. ``trace`` is minted at construction unless given."""

    seq: str
    seed: int = 0
    arrival_s: Optional[float] = None
    priority: int = 0
    deadline_s: Optional[float] = None
    parent_id: Optional[str] = None
    trace: Optional[TraceContext] = dataclasses.field(default=None, compare=False, repr=False)

    def __post_init__(self):
        if self.trace is None:
            self.trace = TraceContext.new()


@dataclasses.dataclass
class ServeResult:
    """One request's outcome. ``status``: ``"ok"`` (arrays set),
    ``"error"`` (the dispatch raised; converted, never propagated, so a
    batch partner's poison pill cannot crash the caller), ``"rejected"``
    (admission control; ``retry_after_s`` hints when to come back) or
    ``"deadline_exceeded"``. ``latency_s`` is ``queue_wait_s +
    dispatch_s``. ``feat_reuse`` is how the input was featurized ("miss",
    "hit", "delta"); ``cost`` the request's even share of its batch."""

    seq: str
    bucket: int
    atom14: Optional[np.ndarray] = None  # (L, 14, 3) refined all-atom coords
    backbone: Optional[np.ndarray] = None  # (L, 3, 3) N/CA/C
    weights: Optional[np.ndarray] = None  # (3L, 3L) distogram confidence
    distogram: Optional[np.ndarray] = None  # (3L, 3L, K) logits if requested
    latency_s: float = 0.0  # queue wait + dispatch: what a caller observes
    queue_wait_s: float = 0.0  # arrival to the dispatch's (device) start
    dispatch_s: float = 0.0  # the forward and the result fetch of its batch
    status: str = "ok"  # "ok" | "error" | "rejected" | "deadline_exceeded"
    error: Optional[str] = None  # failure detail for non-"ok" statuses
    retry_after_s: Optional[float] = None  # backoff hint on "rejected"
    cache_hit: bool = False  # served from the result cache / in-flight dedup
    retried: bool = False  # produced by the frontend's retry dispatch
    trace_id: Optional[str] = None  # the owning request's trace identity
    feat_reuse: Optional[str] = None  # "miss" | "hit" | "delta"; None if not dispatched
    # queue_wait_s, device_share_s, compile_share_s, flops_share, pad_fraction;
    # None on non-dispatched results
    cost: Optional[dict] = None

    @property
    def ok(self) -> bool:
        return self.status == "ok"


class MeshSession:
    """What every engine on one mesh shares on rank 0 (a fleet's replicas
    on one mesh too): the forward lock, held from a forward's broadcast to
    its last collective, and how many of those engines are open: the last
    to close tells the followers to stop."""

    def __init__(self):
        self.lock = threading.RLock()
        self.open = 0


_SESSIONS_LOCK = threading.Lock()


def mesh_session(mesh) -> MeshSession:
    """``mesh``'s one :class:`MeshSession`, kept on the mesh itself, so it
    lives as long as the mesh does."""
    with _SESSIONS_LOCK:
        session = getattr(mesh, "_serve_session", None)
        if session is None:
            session = MeshSession()
            mesh._serve_session = session
        return session


class _Stacked(dict):
    """A dispatch's device arrays, with the host stack they were copied
    from (``host``): what a mesh's rank 0 broadcasts to the followers."""

    def __init__(self, host: dict):
        super().__init__()
        self.host = host


def _as_request(r: Union[str, ServeRequest]) -> ServeRequest:
    return r if isinstance(r, ServeRequest) else ServeRequest(seq=r)


class ServeEngine:
    """Bucketed/batched engine.

    >>> engine = ServeEngine(cfg)               # the CUDA card
    >>> results = engine.predict_many(["ACDEFGH...", "MKV..."])
    >>> engine.close()                          # stops the pipeline's workers

    ``state_dict`` (e.g. from ``convert.to_state_dict``) or
    ``checkpoint_dir`` (the latest checkpoint's parameters, restored before
    any bf16 cast, as JAX's engine restores them) replaces the random
    weights drawn from ``cfg.train.seed``; passing both raises, as
    ``predict`` does. ``model`` serves an already built serving module
    (another engine's ``model``, on this engine's device) instead of
    building one: the same parameter tensors, no copy; it excludes the
    other two. ``counters``, ``tracer`` and ``faults`` as JAX's
    (``serve/engine.py:185-194``)."""

    # past this many substitutions a request is no mutant of the parent
    # in any traffic sense: featurize it cold (JAX's constant)
    DELTA_MAX_EDITS = 8

    def __init__(self, cfg: Config, state_dict: Optional[dict] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 checkpoint_dir: Optional[str] = None,
                 counters: Optional[EventCounters] = None,
                 tracer: Optional[Tracer] = None, faults=None,
                 model: Optional[torch.nn.Module] = None, mesh=None):
        if state_dict is not None and checkpoint_dir:
            raise ValueError("pass state_dict or checkpoint_dir, not both")
        if model is not None and (state_dict is not None or checkpoint_dir):
            raise ValueError("a shared model takes no state_dict or checkpoint_dir")
        self.cfg = cfg
        self.faults = faults
        self.device = resolve_device(device)
        # the mesh (parallel/): one process a rank; its identity keys the
        # executables, the compile records and the result cache
        self.mesh = mesh
        self.mesh_desc = describe_mesh(mesh)
        self.rank = 0
        if mesh is not None:
            import torch.distributed as dist

            self.rank = dist.get_rank()
        self._stopped = False
        self.buckets = validate_ladder(cfg.serve.buckets)
        self.long_buckets: tuple = ()
        if cfg.serve.long_buckets:
            long = validate_ladder(cfg.serve.long_buckets)
            if mesh is None:
                # the long rungs' O(N^2) pair state is what the mesh shards:
                # refused without one, as JAX's engine refuses them
                raise ValueError(
                    f"serve.long_buckets={long} require a device mesh: the long-chain "
                    "rungs are mesh-gated (construct ServeEngine with mesh=..., e.g. "
                    "parallel.grid_parallel.make_grid_mesh)")
            if long[0] <= self.buckets[-1]:
                raise ValueError(f"serve.long_buckets {long} must all exceed the top "
                                 f"regular rung {self.buckets[-1]}")
            self.long_buckets = long
            self.buckets = self.buckets + long
        if 3 * self.buckets[-1] > cfg.model.max_seq_len:
            raise ValueError(
                f"largest bucket {self.buckets[-1]} elongates to {3 * self.buckets[-1]} "
                f"tokens > model.max_seq_len={cfg.model.max_seq_len}"
            )
        self.max_batch = int(cfg.serve.max_batch)
        self.long_max_batch = int(cfg.serve.long_max_batch)
        if self.max_batch < 1:
            raise ValueError(f"serve.max_batch must be >= 1, got {self.max_batch}")
        if self.long_buckets and self.long_max_batch < 1:
            raise ValueError(f"serve.long_max_batch must be >= 1, got {self.long_max_batch}")
        if mesh is not None:
            self._validate_mesh(mesh, cfg)
        self.msa_depth = int(cfg.serve.msa_depth or cfg.data.msa_depth)
        if self.msa_depth > constants.MAX_NUM_MSA:
            raise ValueError(f"serve msa_depth={self.msa_depth} exceeds "
                             f"MAX_NUM_MSA={constants.MAX_NUM_MSA}")
        self.serve_dtype = str(cfg.serve.dtype or "float32")
        if self.serve_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"serve.dtype must be 'float32' or 'bfloat16', "
                             f"got {cfg.serve.dtype!r}")
        # the kernel policy (ops/kernels.py): a per-engine spec wins over the
        # process default (AF2TPU_KERNELS at construction); its description
        # keys every executable of this engine and rides in its records.
        # kernel_policy is None without a spec, as JAX's is; _policy is the
        # one _forward activates on whatever thread runs it
        self.kernel_policy = parse_policy(cfg.serve.kernels) if cfg.serve.kernels else None
        self._policy = self.kernel_policy or current_policy()
        self.kernels_desc = self._policy.describe()
        self.pipeline_depth = int(cfg.serve.pipeline_depth)
        if self.pipeline_depth < 0:
            raise ValueError(f"serve.pipeline_depth must be >= 0, got {self.pipeline_depth}")
        self.counters = counters if counters is not None else EventCounters()
        self.tracer = tracer if tracer is not None else Tracer(enabled=False)
        self.memory = MemorySampler([self.device])
        self.histograms = {
            "latency_s": Histogram(),
            "queue_wait_s": Histogram(),
            "dispatch_s": Histogram(),
            "batch_occupancy": Histogram(),
            "pad_ratio": Histogram(),
        }
        self.compile_records: list = []
        # per-key warm-run seconds, dispatch counts and counted flops: the
        # cost ledger's amortized-compile and flops shares
        self._exe_compile_s: dict = {}
        self._exe_dispatches: dict = {}
        self._exe_flops: dict = {}
        self._exe_breakdown: dict = {}
        self.executed_flops: float = 0.0
        self.executed_flops_breakdown: dict = {}
        self._executables: dict = {}
        self._compile_lock = threading.Lock()
        self._account_lock = threading.Lock()
        # one thread at a time runs this engine's forward: the pipeline's
        # device worker, the serial path (the frontend's retry runs it on
        # the fetch worker) and warm runs. A fleet's replicas each hold
        # their own lock, so two forwards of one shared module may run at
        # once on two threads; the kernel wrappers keep their launch counts
        # exact under ops.cuda.build.count's lock. On a mesh every engine
        # of the mesh takes its one lock: a forward's collectives, the
        # broadcast first, must reach the followers whole and in order
        self._forward_lock = threading.RLock()
        self._session = None
        if mesh is not None:
            self._session = mesh_session(mesh)
            self._forward_lock = self._session.lock

        if model is None:
            model = build_model(cfg, mds_iters=cfg.serve.mds_iters)
            if self.serve_dtype == "bfloat16":
                model.af2.dtype = model.refiner.dtype = torch.bfloat16
            if state_dict is not None:
                model.load_state_dict(state_dict)
            elif checkpoint_dir:
                from alphafold2_tpu_torch.train.checkpoint import CheckpointManager

                CheckpointManager(checkpoint_dir).restore_params(model)
            else:
                init_params(model, cfg.train.seed)
            if self.serve_dtype == "bfloat16":
                model = model.to(torch.bfloat16)
        else:
            want = torch.bfloat16 if self.serve_dtype == "bfloat16" else torch.float32
            got = next(model.parameters())
            if got.dtype != want or got.device != self.device:
                raise ValueError(f"a shared model on {got.device} in {got.dtype} cannot "
                                 f"serve {self.serve_dtype} on {self.device}")
        self.model = model.to(self.device).eval()

        fcap = int(cfg.serve.feature_cache_size)
        self.feature_cache = FeatureCache(fcap) if fcap > 0 else None
        self.delta_featurize = bool(cfg.serve.delta_featurize)
        self.pipeline = None
        if self.pipeline_depth > 0 and self.rank == 0:  # a follower only follows
            from alphafold2_tpu_torch.serve.pipeline import PipelinedDispatcher

            self.pipeline = PipelinedDispatcher(self, depth=self.pipeline_depth)
        if self._session is not None and self.rank == 0:
            with self._forward_lock:
                self._session.open += 1

    @property
    def pipeline_desc(self) -> str:
        """The dispatch path: ``"depth<N>"`` or ``"off"``."""
        return f"depth{self.pipeline_depth}" if self.pipeline is not None else "off"

    def close(self) -> None:
        """Stop the pipeline's stage workers (in-flight batches drain first);
        on a mesh, rank 0 tells the followers to stop once the last engine
        on the mesh closes (:class:`MeshSession`)."""
        if self.pipeline is not None:
            self.pipeline.shutdown(wait=True)
        if self._session is not None and self.rank == 0 and not self._stopped:
            self._stopped = True
            with self._forward_lock:
                self._session.open -= 1
                if self._session.open == 0:  # the last engine on the mesh
                    broadcast_object({"op": "stop"}, device=self._object_device())

    def _validate_mesh(self, mesh, cfg: Config) -> None:
        """JAX's checks (``serve/engine.py:377-412``): both batch sizes
        divide by ``dp``; a grid mesh needs ``model.grid_parallel``; every
        rung's ``3 * bucket`` pair rows divide by the sequence tile."""
        n_dp = axis_size(mesh, DATA_AXIS)
        if self.max_batch % n_dp or (self.long_buckets and self.long_max_batch % n_dp):
            raise ValueError(
                f"serve batch sizes (max_batch={self.max_batch}, long_max_batch="
                f"{self.long_max_batch}) must divide by the mesh's dp axis ({n_dp}) for "
                "even batch sharding")
        if is_grid(mesh) and not cfg.model.grid_parallel:
            raise ValueError(
                "a (dp, spr, spc) grid mesh requires model.grid_parallel=true: the pair "
                "axial passes run there only as the sharded transposes that keep the "
                "long-chain rungs at O(N^2/(spr*spc)) memory a rank")
        lay = pair_layout(mesh)
        tile = lay.n_row * lay.n_col
        for b in self.buckets:
            if (3 * b) % tile:
                raise ValueError(
                    f"bucket {b} elongates to {3 * b} pair rows, not divisible by the "
                    f"sequence tile ({tile}) the all-to-all transposes need; adjust "
                    "serve.buckets or the mesh")

    def batch_for(self, bucket: int) -> int:
        """Dispatch batch size of a rung: ``serve.long_max_batch`` on the long
        rungs (their per-request memory is what the mesh shards),
        ``serve.max_batch`` elsewhere."""
        return self.long_max_batch if bucket in self.long_buckets else self.max_batch

    def _object_device(self):
        """Where ``broadcast_object`` stages its bytes: the card under NCCL."""
        return self.device if self.device.type == "cuda" else None

    def follow(self) -> None:
        """A follower rank's loop (every rank but 0 of a mesh): receive each
        forward's stacked batch from rank 0, join the sharded forward, and
        return when rank 0's :meth:`close` sends a stop. A forward that
        raises here is rank 0's dispatch error too (its collectives fail),
        so the loop goes on to the next."""
        if self.mesh is None or self.rank == 0:
            raise RuntimeError("follow() is for the ranks after 0 of a mesh")
        with self._device_scope():
            while True:
                msg = broadcast_object(None, device=self._object_device())
                if msg["op"] == "stop":
                    return
                stacked = {k: torch.from_numpy(a).to(self.device) for k, a in msg["host"].items()}
                try:
                    self._forward_local(stacked)
                except Exception:  # noqa: BLE001 — rank 0 reports the dispatch's error
                    continue

    def _device_scope(self):
        """The engine's device as the thread's current one (a CUDA context
        per thread); nothing on the CPU."""
        return torch.cuda.device(self.device) if self.device.type == "cuda" else nullcontext()

    # ----------------------------------------------------------- executables

    def _exe_key(self, bucket: int, batch: int) -> tuple:
        return (bucket, batch, self.mesh_desc, self.serve_dtype, self.kernels_desc)

    def _forward(self, stacked: dict) -> dict:
        """One forward over a batch on the device, on the current stream,
        under the engine's kernel policy (the policy is thread-local, and the
        pipeline's device worker, the serial path, the warm and the counted
        runs all come through here); the picked outputs stay on the device.
        On a mesh rank 0 first broadcasts the batch to the followers."""
        if self.mesh is not None:
            if self.rank != 0:
                raise RuntimeError(f"rank {self.rank} follows rank 0: call follow()")
            host = getattr(stacked, "host", None)
            if host is None:  # a stack made on the device
                host = {k: v.cpu().numpy() for k, v in stacked.items()}
            with self._forward_lock:
                broadcast_object({"op": "forward", "host": host}, device=self._object_device())
                return self._forward_local(stacked)
        return self._forward_local(stacked)

    def _forward_local(self, stacked: dict) -> dict:
        """:meth:`_forward` on this rank alone (under the mesh when there is
        one); on a follower rank the outputs are None."""
        mesh = use_mesh(self.mesh) if self.mesh is not None else nullcontext()
        with self._forward_lock, torch.inference_mode(), use_kernel_policy(self._policy), mesh:
            out = self.model(stacked["seq"].long(), stacked["msa"].long(),
                             mask=stacked["mask"], msa_mask=stacked["msa_mask"],
                             coords0=stacked["coords0"])
        picked = {"refined": out["refined"], "weights": out["weights"]}
        if self.cfg.serve.return_distogram:
            picked["distogram"] = out["distogram"]
        return picked

    def _get_executable(self, bucket: int, batch: int):
        """The forward for one ``(bucket, batch, dtype)`` key, warmed by
        one fully masked run the first time (under ``_compile_lock``: the
        pipeline's device worker, the serial path and warmup can race to
        the same rung, and exactly one of them builds it)."""
        key = self._exe_key(bucket, batch)
        hit = self._executables.get(key)
        if hit is not None:
            self.counters.bump("serve.cache_hits")
            return hit
        with self._compile_lock:
            hit = self._executables.get(key)
            if hit is not None:  # lost the race: the build already happened
                self.counters.bump("serve.cache_hits")
                return hit
            self.counters.bump("serve.traces")
            t0 = time.perf_counter()
            masked = self._to_device(self._stack_host(bucket, [], batch), bucket)
            before = census()
            with self.tracer.span("serve.compile", bucket=bucket, batch=batch):
                self._forward(masked)
                if self.device.type == "cuda":
                    torch.cuda.current_stream(self.device).synchronize()
            # this rank's collectives of one forward of the rung (none off a mesh)
            collectives = census_delta(before, census())
            self.counters.bump("serve.compiles")
            self._exe_compile_s[key] = round(time.perf_counter() - t0, 4)
            # the cost analysis: one more masked run, counted (XLA's
            # cost_analysis in JAX)
            counted = count_forward(self._forward, masked, device=self.device)
            costs = executable_costs(counted)
            self._exe_flops[key] = costs["flops"] or 0.0
            breakdown = attention_flops_attribution(
                batch=batch, pair_len=3 * bucket, msa_depth=self.msa_depth, msa_len=bucket,
                depth=self.cfg.model.depth, heads=self.cfg.model.heads,
                dim_head=self.cfg.model.dim_head, tie_rows=self.cfg.model.msa_tie_row_attn,
                total_flops=costs["flops"])
            self._exe_breakdown[key] = breakdown
            memory = executable_memory(counted)
            if self.mesh is not None:
                # this rank's bytes: its warm run's peak (on the card) plus the
                # parameters every rank holds
                memory["program_bytes"] = int(memory.get("peak_bytes", 0) + sum(
                    p.numel() * p.element_size() for p in self.model.parameters()))
            self.compile_records.append({
                "bucket": bucket, "batch": batch, "seconds": self._exe_compile_s[key],
                **({"mesh": self.mesh_desc} if self.mesh_desc else {}),
                **({"dtype": self.serve_dtype} if self.serve_dtype != "float32" else {}),
                **({"kernels": self.kernels_desc} if self.kernels_desc != "auto" else {}),
                **({"flops": costs["flops"]} if costs["flops"] else {}),
                **({"flops_breakdown": breakdown} if costs["flops"] else {}),
                **({"collectives": collectives} if collectives else {}),
                **memory,
            })
            self._executables[key] = self._forward
            return self._forward

    # --------------------------------------------------- dispatch stages
    # Shared by the serial path (_dispatch_inner) and the pipeline's stage
    # workers (serve/pipeline.py): the same featurization, stacking,
    # forward and fetch, so the two give the same bytes.

    def _padded_batch(self, bucket: int, n_real: int) -> int:
        """The batch a chunk of ``n_real`` requests dispatches at: the rung's
        batch (``serve.pad_batches``), rounded up to the mesh's dp multiple."""
        batch = self.batch_for(bucket) if self.cfg.serve.pad_batches else n_real
        if self.mesh is not None:
            batch += (-batch) % axis_size(self.mesh, DATA_AXIS)
        return batch

    def _featurize_one(self, bucket: int, req: ServeRequest) -> tuple:
        """Featurize one request, through the feature cache where it has
        one: ``(item, reuse)``, ``reuse`` one of "hit" (exact derivation
        key), "delta" (column-patched from a cached same-shape parent,
        byte-identical to cold) and "miss" (cold). Each bumps its
        ``serve.feat_*`` counter, so the ledger sums to the dispatched
        requests (JAX's ``serve/engine.py:650-698``)."""
        tokens = encode_sequence(req.seq)[0]
        pad = bucket - len(req.seq)
        self.counters.bump("serve.padded_residues", pad)
        self.histograms["pad_ratio"].observe(pad / bucket)
        fc = self.feature_cache
        if fc is None:
            item, _ = featurize_bucketed_with_plan(tokens, bucket, self.msa_depth, seed=req.seed)
            self.counters.bump("serve.feat_misses")
            return item, "miss"
        key = feature_key(req.seq, bucket, self.msa_depth, req.seed)
        found = fc.lookup(key)
        if found is not None:
            self.counters.bump("serve.feat_hits")
            return found[0], "hit"
        if self.delta_featurize:
            for p_item, p_plan in fc.delta_parent(bucket, self.msa_depth, req.seed,
                                                  len(req.seq)):
                edits = int((p_plan["tokens"] != tokens).sum())
                if 0 < edits <= self.DELTA_MAX_EDITS:
                    item = featurize_delta(p_item, p_plan, tokens)
                    # the mutation masks depend only on (seed, length, depth),
                    # so the mutant is itself a valid delta parent
                    plan = dict(p_plan)
                    plan["tokens"] = tokens.copy()
                    item = fc.put(key, item, plan)
                    self.counters.bump("serve.feat_delta")
                    return item, "delta"
        item, plan = featurize_bucketed_with_plan(tokens, bucket, self.msa_depth, seed=req.seed)
        item = fc.put(key, item, plan)
        self.counters.bump("serve.feat_misses")
        return item, "miss"

    def _dummy_item(self, bucket: int) -> dict:
        """A fully masked batch-padding slot."""
        return {
            "seq": np.full(bucket, constants.AA_PAD_INDEX, np.int32),
            "mask": np.zeros(bucket, bool),
            "msa": np.full((self.msa_depth, bucket), constants.AA_PAD_INDEX, np.int32),
            "msa_mask": np.zeros((self.msa_depth, bucket), bool),
        }

    def _stack_host(self, bucket: int, items: list, batch: int) -> dict:
        full = items + [self._dummy_item(bucket) for _ in range(batch - len(items))]
        return {k: np.stack([it[k] for it in full]) for k in full[0]}

    def _transfer(self, host: dict, dispatch_index: int, bucket: int, pinned=None) -> dict:
        """The transfer stage: the fault hook, then :meth:`_to_device`."""
        if self.faults is not None:
            self.faults.on_stage("transfer", dispatch_index, bucket)
        return self._to_device(host, bucket, pinned)

    def _to_device(self, host: dict, bucket: int, pinned=None) -> dict:
        """The host batch and its MDS start (position-keyed, the model's
        seed, so the forward reads nothing from the host) on the device.
        With ``pinned`` (a ring slot of the pipeline) the arrays go through
        pinned buffers and copy with ``non_blocking`` on the current
        stream; without, a plain copy (the CPU: no copy at all)."""
        host = dict(host, coords0=position_keyed_init(3 * bucket, self.model.mds_seed))
        out = _Stacked(host)
        for k, a in host.items():
            if pinned is None:
                out[k] = torch.from_numpy(a).to(self.device)
                continue
            buf = pinned.buffer(k, a.shape, torch.from_numpy(a[:0]).dtype)
            buf.numpy()[...] = a
            out[k] = buf.to(self.device, non_blocking=True)
        return out

    def _execute_batch(self, compiled, stacked, dispatch_index, bucket) -> dict:
        """Run the forward; on the card it is enqueued and returns before
        the device finishes (the fetch stage waits)."""
        if self.faults is not None:
            self.faults.on_stage("compute", dispatch_index, bucket)
        return compiled(stacked)

    def _fetch(self, out: dict, dispatch_index, bucket, done=None) -> tuple:
        """The outputs as host float32 arrays. With ``done`` (the pipeline's
        event after the device-to-host copies into pinned buffers) it waits
        on that event once and copies the arrays out of the ring's buffers;
        without, a blocking copy."""
        if self.faults is not None:
            self.faults.on_stage("fetch", dispatch_index, bucket)
        if done is not None:
            done.synchronize()
        host = {k: v.float().cpu().numpy() for k, v in out.items()}
        if done is not None:
            host = {k: a.copy() for k, a in host.items()}
        return host["refined"], host["weights"], host.get("distogram")

    def _account_flops(self, exe_key) -> None:
        """One dispatch of ``exe_key``: its count, and its counted flops
        into ``executed_flops`` (the pipeline's completion worker and the
        serial path share these, hence the lock)."""
        with self._account_lock:
            self.executed_flops += self._exe_flops.get(exe_key, 0.0)
            self._exe_dispatches[exe_key] = self._exe_dispatches.get(exe_key, 0) + 1
            for kernel, flops in self._exe_breakdown.get(exe_key, {}).items():
                self.executed_flops_breakdown[kernel] = (
                    self.executed_flops_breakdown.get(kernel, 0.0) + flops)

    def _request_cost(self, bucket: int, batch: int, n_real: int, real_residues: int,
                      wait: float, dispatch_s: float) -> dict:
        """One request's even share of its batch (JAX's ``:779-802``); the
        warm run's seconds amortize over the key's dispatches so far, and
        the key's counted flops split over the real members."""
        exe_key = self._exe_key(bucket, batch)
        with self._account_lock:
            dispatches = max(1, self._exe_dispatches.get(exe_key, 1))
        compile_s = self._exe_compile_s.get(exe_key, 0.0)
        flops = self._exe_flops.get(exe_key, 0.0)
        rect = max(1, batch * bucket)
        return {
            "queue_wait_s": round(wait, 6),
            "device_share_s": round(dispatch_s / n_real, 6),
            "compile_share_s": round(compile_s / dispatches / n_real, 6),
            "flops_share": round(flops / n_real, 3),
            "pad_fraction": round(max(0, rect - real_residues) / rect, 4),
        }

    def _build_results(self, bucket, reqs, waits, dispatch_s, refined, weights, disto,
                       feat=None, batch=None) -> list:
        """Unpad one batch's outputs into per-request results; ``feat``
        carries each slot's featurization ledger entry, ``batch`` (the
        padded batch) enables the cost ledger."""
        built = []
        real_residues = sum(len(r.seq) for r in reqs)
        for slot, req in enumerate(reqs):
            L = len(req.seq)
            atom14 = refined[slot, :L]
            wait = max(0.0, waits[slot])
            latency = wait + dispatch_s
            self.histograms["latency_s"].observe(latency)
            built.append(ServeResult(
                seq=req.seq, bucket=bucket, atom14=atom14, backbone=atom14[:, :3],
                weights=weights[slot, : 3 * L, : 3 * L],
                distogram=disto[slot, : 3 * L, : 3 * L] if disto is not None else None,
                latency_s=latency, queue_wait_s=wait, dispatch_s=dispatch_s,
                trace_id=req.trace.trace_id if req.trace else None,
                feat_reuse=feat[slot] if feat is not None else None,
                cost=(self._request_cost(bucket, batch, len(reqs), real_residues, wait,
                                         dispatch_s) if batch else None),
            ))
        return built

    def _error_results(self, bucket, reqs, waits, msg, dispatch_s) -> list:
        """Structured per-request error results for a failed batch (the
        frontend retries them on another rung). The installed flight
        recorder gets a ``dispatch_error`` note and, once a process, a dump
        of the telemetry leading up to it."""
        self.counters.bump("serve.dispatch_errors")
        rec = flightrec.active()
        if rec is not None:
            rec.note("dispatch_error", bucket=int(bucket), error=msg, n_real=len(reqs),
                     trace_ids=[r.trace.trace_id for r in reqs if r.trace])
            rec.dump("dispatch_error")  # once a process (deduped)
        return [
            ServeResult(seq=req.seq, bucket=bucket, status="error", error=msg,
                        latency_s=max(0.0, waits[slot]) + dispatch_s,
                        queue_wait_s=max(0.0, waits[slot]), dispatch_s=dispatch_s,
                        trace_id=req.trace.trace_id if req.trace else None)
            for slot, req in enumerate(reqs)
        ]

    # -------------------------------------------------------------- serving

    def predict_many(self, requests: Sequence[Union[str, ServeRequest]]) -> list:
        """Serve a request list: group by bucket, batch, dispatch, unpad.
        Results come back in input order. A request's queue wait counts
        from its own ``arrival_s``, else from the start of this call."""
        if self.rank != 0:
            raise RuntimeError(f"rank {self.rank} follows rank 0: call follow()")
        reqs = [_as_request(r) for r in requests]
        self.counters.bump("serve.requests", len(reqs))
        by_bucket: dict = {}
        for i, r in enumerate(reqs):
            if not r.seq:
                raise ValueError(f"request {i} has an empty sequence")
            by_bucket.setdefault(bucket_for(len(r.seq), self.buckets), []).append(i)
        results: list = [None] * len(reqs)
        arrival = time.perf_counter()  # the queue wait's origin
        chunks = [(bucket, order[lo: lo + self.batch_for(bucket)])
                  for bucket, order in sorted(by_bucket.items())
                  for lo in range(0, len(order), self.batch_for(bucket))]
        if self.pipeline is not None:
            # every chunk submitted up front: the host stage featurizes batch
            # N+1 while batch N computes; submit blocks at pipeline_depth in
            # flight, and results drain in submission order
            handles = [(chunk, self.pipeline.submit(bucket, [reqs[i] for i in chunk],
                                                    arrival=arrival))
                       for bucket, chunk in chunks]
            for chunk, handle in handles:
                for idx, res in zip(chunk, handle.result()):
                    results[idx] = res
            return results
        for bucket, chunk in chunks:
            self._dispatch(bucket, [reqs[i] for i in chunk], chunk, results, arrival)
        return results

    def dispatch_batch(self, bucket: int, requests: Sequence[Union[str, ServeRequest]]) -> list:
        """Dispatch one pre-formed batch at ``bucket`` serially and return
        its results in order (the async frontend's path without a pipeline,
        and its retry). A failure gives ``status="error"`` results."""
        reqs = [_as_request(r) for r in requests]
        results: list = [None] * len(reqs)
        self._dispatch(bucket, reqs, list(range(len(reqs))), results)
        return results

    def dispatch_batch_async(self, bucket: int, requests: Sequence[Union[str, ServeRequest]],
                             joinable: bool = False):
        """Pipelined dispatch of one pre-formed batch: a
        :class:`~alphafold2_tpu_torch.serve.pipeline.DispatchHandle` over
        its ordered results. With ``joinable`` the batch stays open to
        ``handle.try_join(req)`` while its host stage runs (the frontend's
        in-flight admission). Requires ``serve.pipeline_depth > 0``."""
        if self.pipeline is None:
            raise RuntimeError("pipelined dispatch requires serve.pipeline_depth > 0")
        return self.pipeline.submit(bucket, [_as_request(r) for r in requests],
                                    joinable=joinable)

    def retry_bucket(self, bucket: int) -> Optional[int]:
        """The next rung up the ladder (another ``(bucket, batch)`` key for
        the frontend's retry), or None on the largest rung."""
        i = self.buckets.index(bucket)
        return self.buckets[i + 1] if i + 1 < len(self.buckets) else None

    def _dispatch(self, bucket, chunk_reqs, chunk_idx, results, arrival=None):
        n_real = len(chunk_reqs)
        batch = self._padded_batch(bucket, n_real)
        dispatch_index = self.counters.bump("serve.batches")
        self.counters.bump("serve.padded_slots", batch - n_real)
        t_start = time.perf_counter()
        waits = []
        for r in chunk_reqs:
            origin = r.arrival_s if r.arrival_s is not None else arrival
            waits.append(t_start - origin if origin is not None else 0.0)
            self.histograms["queue_wait_s"].observe(max(0.0, waits[-1]))
        self.histograms["batch_occupancy"].observe(n_real / batch)
        try:
            with self._device_scope():
                self._dispatch_inner(bucket, batch, dispatch_index, chunk_reqs, chunk_idx,
                                     results, waits)
        except Exception as e:  # noqa: BLE001 — converted per request, as JAX does
            msg = f"{type(e).__name__}: {e}"
            errs = self._error_results(bucket, chunk_reqs, waits, msg,
                                       time.perf_counter() - t_start)
            for idx, res in zip(chunk_idx, errs):
                results[idx] = res

    def _dispatch_inner(self, bucket, batch, dispatch_index, chunk_reqs, chunk_idx, results,
                        waits):
        n_real = len(chunk_reqs)
        if self.faults is not None:
            self.faults.on_dispatch(dispatch_index, bucket)
        member_traces = [r.trace.trace_id for r in chunk_reqs if r.trace]
        with self.tracer.span("serve.batch", bucket=bucket, batch=batch, n_real=n_real,
                              dispatch_index=dispatch_index,
                              **({"trace_ids": member_traces} if member_traces else {})
                              ) as batch_span:
            with self.tracer.span("serve.featurize", bucket=bucket,
                                  dispatch_index=dispatch_index):
                items, feat = [], []
                for r in chunk_reqs:
                    item, reuse = self._featurize_one(bucket, r)
                    items.append(item)
                    feat.append(reuse)
                host = self._stack_host(bucket, items, batch)
                stacked = self._transfer(host, dispatch_index, bucket)
            with self.tracer.span("serve.get_executable", bucket=bucket,
                                  batch=batch) as exe_span:
                before = self.counters.get("serve.compiles")
                compiled = self._get_executable(bucket, batch)
                exe_span.set(compiled_now=self.counters.get("serve.compiles") > before)
            t0 = time.perf_counter()
            with self.tracer.span("serve.dispatch", bucket=bucket,
                                  dispatch_index=dispatch_index):
                out = self._execute_batch(compiled, stacked, dispatch_index, bucket)
            # the timed region closes on the fetched values
            with self.tracer.span("serve.device_get", bucket=bucket,
                                  dispatch_index=dispatch_index):
                refined, weights, disto = self._fetch(out, dispatch_index, bucket)
            dispatch_s = time.perf_counter() - t0
            batch_span.set(dispatch_s=round(dispatch_s, 4))
            self.histograms["dispatch_s"].observe(dispatch_s)
            self._account_flops(self._exe_key(bucket, batch))
            self.memory.counter_to(self.tracer)
            with self.tracer.span("serve.unpad", bucket=bucket, dispatch_index=dispatch_index):
                built = self._build_results(bucket, chunk_reqs, waits, dispatch_s, refined,
                                            weights, disto, feat=feat, batch=batch)
            for idx, res in zip(chunk_idx, built):
                results[idx] = res

    # ------------------------------------------------- pipelined completion

    def _complete_pipelined(self, job) -> list:
        """The pipeline's completion stage (on its fetch worker): accounting
        and unpadding into ordered results. An error carried from any stage
        becomes per-request error results, so a poisoned batch cannot wedge
        the completion thread. The queue wait runs to the device start."""
        t_end = time.perf_counter()
        reqs = job.members
        t0 = job.t_device0 if job.t_device0 is not None else t_end
        dispatch_s = max(0.0, t_end - t0)
        waits = []
        for r in reqs:
            origin = r.arrival_s if r.arrival_s is not None else job.arrival
            waits.append(t0 - origin if origin is not None else 0.0)
            self.histograms["queue_wait_s"].observe(max(0.0, waits[-1]))
        if job.error is not None:
            msg = f"{type(job.error).__name__}: {job.error}"
            return self._error_results(job.bucket, reqs, waits, msg, dispatch_s)
        self.histograms["batch_occupancy"].observe(job.n_real / job.batch_size)
        self.histograms["dispatch_s"].observe(dispatch_s)
        self._account_flops(self._exe_key(job.bucket, job.batch_size))
        self.memory.counter_to(self.tracer)
        refined, weights, disto = job.fetched
        with self.tracer.span("serve.unpad", bucket=job.bucket, dispatch_index=job.index):
            built = self._build_results(job.bucket, reqs, waits, dispatch_s, refined, weights,
                                        disto, feat=job.feat, batch=job.batch_size)
        member_traces = [r.trace.trace_id for r in reqs if r.trace]
        # retroactive: the batch's start predates this thread's part in it
        self.tracer.span_event(
            "serve.batch", job.t_host0 if job.t_host0 is not None else t0, t_end,
            bucket=job.bucket, batch=job.batch_size, n_real=job.n_real,
            dispatch_index=job.index, dispatch_s=round(dispatch_s, 4), pipelined=True,
            **({"trace_ids": member_traces} if member_traces else {}),
        )
        return built

    def _completion_fallback(self, job) -> list:
        """Error results if completion itself raised: the future always
        resolves with one result per member."""
        msg = f"{type(job.error).__name__}: {job.error}"
        return [ServeResult(seq=req.seq, bucket=job.bucket, status="error", error=msg,
                            trace_id=req.trace.trace_id if req.trace else None)
                for req in job.members]

    def warmup(self) -> dict:
        """Warm every rung ahead of traffic (one fully masked run a bucket,
        which builds the kernels); returns the counters afterwards."""
        with self._device_scope():
            for bucket in self.buckets:
                self._get_executable(bucket, self._padded_batch(bucket, 1))
        return self.counters.snapshot()

    def stats(self) -> dict:
        return self.counters.snapshot()

    def histogram_snapshots(self, unit_scale: float = 1.0) -> dict:
        """One summary a distribution; the time histograms (``*_s``) scaled
        by ``unit_scale`` (1e3 → ms)."""
        return {name: h.snapshot(unit_scale=unit_scale if name.endswith("_s") else 1.0,
                                 digits=4)
                for name, h in self.histograms.items()}
