"""Distogram pretraining: loss, state, train step and the training loop.

Port of the single-device path of ``alphafold2_tpu/train/loop.py``:
``distogram_cross_entropy`` (:44), ``apply_features`` (:62), ``build_model``
(:83), ``init_state`` (:128, with ``model.init_scheme`` "flax" or "torch"),
``make_train_step`` (:245) and ``train`` (:467). The optimizer
(``build_optimizer`` :110) is ``train/optim.py``, checkpoints are
``train/checkpoint.py``. :func:`run_steps` is the loop that ``train`` and
``train/end2end.py``'s ``train_end2end`` share: restore, steps, logs,
callbacks, checkpoint cadence and SIGTERM, as JAX's ``train`` (:541-712).

On the card every attention's forward runs K1 with its logsumexp and its
backward K3a + K3b (``ops/cuda/axial.py``), unless attention-weight dropout
is active, which takes JAX's dense route (``ops/attention.py``). The step
mirrors the JAX one: gradients that are not all finite are zeroed and still
applied, so Adam's moments and counts move while the parameters do not,
and ``skipped`` counts the step. PyTorch updates the state in place; the
step returns it anyway, as the JAX step returns its new state.

Dropout: step ``i`` passes ``DropoutKey.for_step(train.seed + 1, i)``, as
JAX's loop splits ``key(seed + 1)`` a step (:556, :662), so a run, and a
run resumed from a checkpoint, draws the same masks each time.
``train.numerics``: "off"; "triage" adds per-group norms and reruns a
skipped step fully tagged (:func:`make_triage_step`) one step late,
logging ``event: nan_triage`` with the first non-finite tensor; "full"
also carries every tag's stats (``metrics["numerics"]``). Metrics go to
``MetricsLogger(train.checkpoint_dir)``; ``train`` adds the host spans of
``train.trace_events`` and the profiler window of ``train.profile_dir``.
``compile_s``, ``step_flops`` and ``mfu`` come from XLA's AOT compile in
JAX (:598-624) and have no counterpart here.

``data.features="plm"`` streams ``embedds`` from ``data/plm.py``'s
provider (``data.plm_provider``, seeded by ``train.seed``) in place of the
MSA; ``build_model`` sizes ``embedd_project`` from the stream's first
batch, as JAX's init takes the width from its sample batch (:176-210).
``model.msa_row_shard``, ``grid_parallel`` and ``context_parallel`` run the
plain model without a mesh: JAX's ``train`` without a mesh gives the same
losses and parameters bit for bit with and without each.

On a device mesh (``cfg.mesh``; one process a rank under ``torchrun``,
:func:`train` calls ``parallel.distributed.initialize`` and builds the
mesh as JAX's :487-513 does, :func:`make_train_mesh`): parameters and
optimizer state are replicated, each rank takes its ``dp`` slice of the
global batch (:func:`device_put_batch`) and its block of the pair grid
(``model.msa_row_shard`` adds its rows of the MSA or the PLM grid, which
the model takes from the whole MSA, as it takes its pair block from the
whole sequence: ``models/alphafold2.py``), and the step follows
``parallel/sharding.py``'s rule for the sharded backward:
each rank's loss is its share of the global loss, the collectives
differentiate as their SPMD transposes, and every gradient is a partial
summed once over the world (:func:`reduce_gradients`), so every rank
applies the same update. Metrics are global. Only rank 0 logs, traces,
profiles and writes checkpoints; every rank restores them. Dropout has no
sharded route (the pair stream's masks would be drawn per block): a step
on a mesh refuses a model with a dropout rate. The trunk engines
(``remat`` with ``remat_policy``, ``reversible``, ``scan_layers``) and KV
compression (``model.cross_attn_compress_ratio`` above 1, the pair<-MSA
pass of every engine) train as in JAX (``models/trunk.py``,
``models/reversible.py``, ``ops/attention.py``); the reversible engine
refuses a mesh, as JAX's does. A dataset the loop makes from ``cfg.data``
it also closes (the native loader's threads), as JAX's does (:712-713).
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import os
import time
from typing import Optional, Union

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from alphafold2_tpu_torch.config import Config
from alphafold2_tpu_torch.device import resolve_device
from alphafold2_tpu_torch.models.alphafold2 import Alphafold2
from alphafold2_tpu_torch.observe import MetricsLogger, Profiler, Tracer, flatten_metrics
from alphafold2_tpu_torch.observe import numerics
from alphafold2_tpu_torch.ops.attention import Attention, DropoutKey, FeedForward
from alphafold2_tpu_torch.parallel.sharding import all_reduce, pair_layout, use_mesh
from alphafold2_tpu_torch.train.optim import Optimizer, build_optimizer, global_norm
from alphafold2_tpu_torch.utils.structure import get_bucketed_distance_matrix


@dataclasses.dataclass
class TrainState:
    """The model (its parameters), the optimizer with its state, the count
    of steps taken and the device-side count of skipped steps."""

    model: nn.Module
    optimizer: Optimizer
    step: int = 0
    skipped: Optional[torch.Tensor] = None  # int32 scalar on the model's device


def distogram_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                            ignore_index: int = -100, mesh=None) -> torch.Tensor:
    """Mean cross-entropy over the pairs whose label is not ``ignore_index``,
    in float32; 0 when every pair is ignored. With a ``mesh`` the logits
    and labels are this rank's block and the result is this rank's share of
    the global mean: its pairs' sum over the valid count summed over the
    world (reduced with no gradient), so the shares sum to the mean."""
    valid = labels != ignore_index
    safe = torch.where(valid, labels, 0).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    # the last forward tensor: a first non-finite here is the loss's own
    nll = numerics.tag("loss.distogram_nll", nll)
    validf = valid.to(nll.dtype)
    count = validf.sum()
    if mesh is not None:
        count = all_reduce(count.detach(), mesh, "world")
    return (nll * validf).sum() / count.clamp_min(1.0)


def apply_features(data_iter, cfg: Config):
    """Adapt the batch stream to ``data.features``: "msa" (as is), "plm"
    (``embedds`` from ``data.plm_provider`` replace the MSA) or "none"
    (sequence only)."""
    if cfg.data.features == "plm":
        from alphafold2_tpu_torch.data.plm import make_provider, wrap_with_embeddings

        provider = make_provider(cfg.data.plm_provider, path=cfg.data.plm_path,
                                 seed=cfg.train.seed)
        return wrap_with_embeddings(data_iter, provider)
    if cfg.data.features == "none":
        return ({k: v for k, v in b.items() if k not in ("msa", "msa_mask")}
                for b in data_iter)
    if cfg.data.features != "msa":
        raise ValueError(f"unknown data.features {cfg.data.features!r}")
    return data_iter


def embedds_width(batch: dict) -> Optional[int]:
    """The ``embedds`` width of a batch, None where it carries none."""
    embedds = batch.get("embedds")
    return None if embedds is None else int(embedds.shape[-1])


def build_model(cfg: Config, num_embedds: Optional[int] = None) -> Alphafold2:
    """The distogram model ``cfg.model`` describes; float32 parameters,
    bfloat16 compute when ``model.bfloat16``. ``num_embedds``, the width
    of a PLM stream's ``embedds``, builds ``embedd_project``. The mesh
    flags go to the trunk, which applies none on one device (module
    docstring). ``model.flash_attention`` reaches every ``Attention`` as
    its ``use_flash``, as JAX's ``build_model`` passes it (:102)."""
    m = cfg.model
    model = Alphafold2(
        dim=m.dim, max_seq_len=m.max_seq_len, depth=m.depth, heads=m.heads,
        dim_head=m.dim_head, gelu_exact=m.gelu_exact,
        msa_tie_row_attn=m.msa_tie_row_attn,
        dtype=torch.bfloat16 if m.bfloat16 else torch.float32,
        attn_dropout=m.attn_dropout, ff_dropout=m.ff_dropout, remat=m.remat,
        remat_policy=m.remat_policy, reversible=m.reversible, scan_layers=m.scan_layers,
        sparse_self_attn=m.sparse_self_attn, msa_row_shard=m.msa_row_shard,
        grid_parallel=m.grid_parallel, context_parallel=m.context_parallel,
        num_embedds=num_embedds, cross_attn_compress_ratio=m.cross_attn_compress_ratio,
    )
    if m.flash_attention is not None:
        for mod in model.modules():
            if isinstance(mod, Attention):
                mod.use_flash = m.flash_attention
    return model


def init_state(cfg: Config, model: nn.Module, flax_params=None,
               device: Optional[Union[str, torch.device]] = None) -> TrainState:
    """Parameters from ``flax_params`` (a JAX parameter tree, through
    ``convert.to_state_dict``) or from the port's seeded init
    (``predict.init_params`` with ``train.seed``, then with
    ``model.init_scheme="torch"`` redrawn by ``models.init.torch_match_reinit``);
    the model moves to ``device`` (the card unless ``device="cpu"``) and
    gets its optimizer. Serves the distogram and the end-to-end model."""
    scheme = cfg.model.init_scheme
    if scheme == "torch":
        if cfg.model.scan_layers or cfg.model.reversible:
            raise ValueError(
                "init_scheme='torch' is incompatible with scan_layers and the "
                "reversible engine: their depth-stacked parameters would corrupt "
                "the fan_in computation (models/init.py)")
    elif scheme != "flax":
        raise ValueError(f"unknown init_scheme {scheme!r}; expected 'flax' or 'torch'")
    dev = resolve_device(device)
    if flax_params is not None:
        from alphafold2_tpu_torch.convert import to_state_dict

        model.load_state_dict(to_state_dict(flax_params, model))
    else:
        from alphafold2_tpu_torch.predict import init_params

        init_params(model, cfg.train.seed)
        if scheme == "torch":
            from alphafold2_tpu_torch.models.init import torch_match_reinit

            torch_match_reinit(model, cfg.train.seed)
    model = model.to(dev)
    return TrainState(model=model,
                      optimizer=build_optimizer(cfg, list(model.parameters())),
                      skipped=torch.zeros((), dtype=torch.int32, device=dev))


def _param_groups(model: nn.Module) -> dict:
    """Indices into ``model.parameters()`` by top-level module (``trunk``,
    ``token_emb``, ...), the groups of the flax tree."""
    groups: dict = {}
    for i, (name, _) in enumerate(model.named_parameters()):
        groups.setdefault(name.split(".")[0], []).append(i)
    return groups


def reduce_gradients(grads, mesh) -> list:
    """Every rank's partial gradients summed over the whole world: one flat
    f32 buffer in parameter order, one all_reduce (``parallel/sharding.py``'s
    rule for the sharded backward). ``grads`` itself without a mesh."""
    if mesh is None:
        return grads
    flat = all_reduce(torch.cat([g.reshape(-1).float() for g in grads]), mesh, "world")
    return [part.view_as(g).to(g.dtype)
            for part, g in zip(flat.split([g.numel() for g in grads]), grads)]


def collect_gradients(params, mesh=None) -> tuple:
    """Each parameter's gradient after ``backward`` (zeros where autograd
    left none, as JAX gives zeros for leaves that do not reach the loss),
    summed over the world on a ``mesh``, and whether all are finite, as a
    device bool."""
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    grads = reduce_gradients(grads, mesh)
    grads_ok = torch.stack([torch.isfinite(g).all() for g in grads]).all()
    return grads, grads_ok


def world_sum(t: torch.Tensor, mesh) -> torch.Tensor:
    """A detached metric summed over the world (``t`` without a mesh)."""
    return t.detach() if mesh is None else all_reduce(t.detach(), mesh, "world")


def check_mesh_model(model: nn.Module, mesh) -> None:
    """Refuse what a step on a mesh cannot run: dropout (the sharded
    blocks would draw their masks per block)."""
    if mesh is None:
        return
    for mod in model.modules():
        if isinstance(mod, (Attention, FeedForward)) and mod.dropout > 0.0:
            raise ValueError("dropout has no sharded route: a training step on a device "
                             "mesh needs model.attn_dropout and model.ff_dropout at 0")


def is_lead_rank() -> bool:
    """Whether this process logs, traces and writes checkpoints: rank 0 of
    an initialised process group, or the one process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def apply_gradients(state: TrainState, grads, grads_ok: torch.Tensor) -> None:
    """One optimizer micro-step with the gradients zeroed unless all are
    finite (Adam's moments and counts still move), counting the skip and
    the step."""
    state.optimizer.step([torch.where(grads_ok, g, 0.0) for g in grads])
    state.skipped = state.skipped + (~grads_ok).to(torch.int32)
    state.step += 1


def _labels(batch: dict) -> torch.Tensor:
    labels = batch.get("labels")
    if labels is None:
        labels = get_bucketed_distance_matrix(batch["coords"], batch["mask"])
    return labels


def _forward_loss(model: nn.Module, batch: dict, key: Optional[DropoutKey], mesh=None):
    """The logits and the loss (this rank's share of it on a ``mesh``, whose
    labels are this rank's block of the pair grid)."""
    with use_mesh(mesh) if mesh is not None else contextlib.nullcontext():
        logits = model(batch["seq"], batch.get("msa"), mask=batch["mask"],
                       msa_mask=batch.get("msa_mask"), embedds=batch.get("embedds"),
                       dropout_key=key)
        labels = _labels(batch)
        if mesh is not None:
            lay, n = pair_layout(mesh), labels.shape[1]
            labels = labels[:, lay.rows(n), lay.cols(n)]
        return logits, distogram_cross_entropy(logits, labels, mesh=mesh)


def make_train_step(model: nn.Module, mesh=None, numerics_mode: str = "off"):
    """Build the distogram-pretraining step: ``step(state, batch, key=None)
    -> (state, metrics)``, ``batch`` a dict of tensors on the model's
    device (this rank's ``dp`` slice on a ``mesh``, :func:`device_put_batch`),
    ``key`` the step's ``DropoutKey`` (dropout is off without one). On a
    ``mesh`` the step follows the module docstring's rule; every metric is
    the world's.

    Metrics: ``loss``, ``grad_norm`` (of the raw gradients), ``grads_ok``,
    ``skipped``, ``distogram_entropy``; with ``numerics_mode="norms"`` or
    ``"full"`` also ``grad_norm/<group>``, ``param_norm/<group>``,
    ``update_norm/<group>`` and ``param_norm``; with ``"full"`` also
    ``numerics``, every tag's stats (``observe/numerics.py``; on a mesh
    this rank's blocks'). Values are device tensors (nothing synchronises
    without a mesh)."""
    if numerics_mode not in ("off", "norms", "full"):
        raise ValueError(f"unknown numerics_mode {numerics_mode!r}; "
                         "expected 'off', 'norms' or 'full'")
    check_mesh_model(model, mesh)
    groups = _param_groups(model)
    norms = numerics_mode != "off"

    def step(state: TrainState, batch: dict, key: Optional[DropoutKey] = None):
        params = list(state.model.parameters())
        for p in params:
            p.grad = None
        with numerics.collect(enabled=numerics_mode == "full") as col:
            logits, loss = _forward_loss(state.model, batch, key, mesh)
        loss.backward()
        grads, grads_ok = collect_gradients(params, mesh)
        before = [p.detach().clone() for p in params] if norms else None
        apply_gradients(state, grads, grads_ok)
        with torch.no_grad():
            logits = logits.detach()
            ent = -(torch.softmax(logits, -1) * torch.log_softmax(logits, -1)).sum(-1)
            if mesh is None:
                entropy = ent.mean()
            else:
                total = world_sum(torch.stack([ent.sum(), ent.new_tensor(ent.numel())]), mesh)
                entropy = total[0] / total[1]
        metrics = {"loss": world_sum(loss, mesh), "grad_norm": global_norm(grads),
                   "grads_ok": grads_ok, "skipped": state.skipped,
                   "distogram_entropy": entropy}
        if norms:
            for group, idx in groups.items():
                metrics[f"grad_norm/{group}"] = global_norm([grads[i] for i in idx])
                metrics[f"param_norm/{group}"] = global_norm([params[i].detach() for i in idx])
                metrics[f"update_norm/{group}"] = global_norm(
                    [params[i].detach() - before[i] for i in idx])
            metrics["param_norm"] = global_norm([p.detach() for p in params])
        if numerics_mode == "full":
            metrics["numerics"] = col.stats()
        return state, metrics

    return step


def make_triage_step(model: nn.Module, mesh=None):
    """The fully tagged diagnostic step of NaN triage (JAX :371-425):
    ``triage(batch, key) -> stats``, the model's current parameters run
    forward and backward under ``key`` with no state change. ``stats`` maps
    every tag to its ``numerics.tensor_stats``, then ``loss``, then
    ``grad/<group>`` (``numerics.tree_stats`` of a parameter group's
    gradients), each with its ``index`` in that order, so
    ``numerics.first_nonfinite`` names the first tensor that went bad. On a
    ``mesh`` every rank runs it (the backward's collectives need them all):
    the loss and the gradients are the world's, the tags this rank's."""
    check_mesh_model(model, mesh)
    groups = _param_groups(model)

    def triage(batch: dict, key: Optional[DropoutKey] = None) -> dict:
        params = list(model.parameters())
        with numerics.collect() as col:
            _, loss = _forward_loss(model, batch, key, mesh)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = reduce_gradients([g if g is not None else torch.zeros_like(p)
                                  for g, p in zip(grads, params)], mesh)
        stats = col.stats()
        order = len(stats)
        stats["loss"] = {"index": order, **numerics.tensor_stats(world_sum(loss, mesh))}
        for name in sorted(groups):  # JAX's grads are a dict in key order
            order += 1
            stats[f"grad/{name}"] = {"index": order, **numerics.tree_stats(
                grads[i] for i in groups[name])}
        return stats

    return triage


def batch_to_device(batch: dict, device: torch.device) -> dict:
    """numpy batch -> tensors on ``device``; token arrays become int64."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if k in ("seq", "msa"):
            t = t.long()
        out[k] = t.to(device)
    return out


def device_put_batch(batch: dict, device: Optional[Union[str, torch.device]] = None,
                     mesh=None) -> dict:
    """JAX's ``device_put_batch`` (``train/loop.py:455``): the numpy batch
    on ``device`` (the card by default, as every entry point's), on a
    ``mesh`` this rank's ``dp`` slice of it (``parallel.distributed
    .global_batch``; every rank holds the whole global batch)."""
    if mesh is not None:
        from alphafold2_tpu_torch.parallel.distributed import global_batch

        batch = global_batch(batch, mesh)
    return batch_to_device(batch, resolve_device(device))


def close_owned(dataset, owned: bool) -> None:
    """Close a dataset the loop made itself (the native loaders stop their
    worker threads); one the caller passed stays the caller's."""
    if owned and hasattr(dataset, "close"):
        dataset.close()


def make_train_mesh(cfg: Config):
    """The mesh ``cfg.mesh`` asks for, as JAX's ``train`` builds it
    (:487-513): a ``(dp, spr, spc)`` grid mesh when ``grid_rows *
    grid_cols > 1`` (``data_parallel`` -1 fills the world), which refuses
    ``seq_parallel`` and ``context_parallel`` and needs
    ``model.grid_parallel``; else a ``(dp, sp)`` mesh
    (``parallel.distributed.pod_mesh``) when ``data_parallel *
    seq_parallel > 1`` or ``seq_parallel > 1``; else None. A mesh needs
    an initialised process group (``parallel.distributed.initialize``), and
    a group of several ranks needs a mesh."""
    from alphafold2_tpu_torch.parallel.distributed import pod_mesh
    from alphafold2_tpu_torch.parallel.grid_parallel import make_grid_mesh

    m = cfg.mesh
    mesh = None
    if m.grid_rows * m.grid_cols > 1:
        if m.seq_parallel > 1 or cfg.model.context_parallel:
            raise ValueError(
                "grid_rows/grid_cols builds a (dp, spr, spc) mesh with no sp axis: "
                "mesh.seq_parallel and model.context_parallel cannot be combined with it")
        if not cfg.model.grid_parallel:
            raise ValueError(
                "mesh.grid_rows/grid_cols requires model.grid_parallel=true — without it "
                "the axial passes run dense and GSPMD all-gathers the attended axis, "
                "losing the memory benefit")
        n_dp = m.data_parallel
        if n_dp == -1:
            world = dist.get_world_size() if dist.is_initialized() else 1
            n_dp = max(1, world // (m.grid_rows * m.grid_cols))
        mesh = make_grid_mesh(n_dp, m.grid_rows, m.grid_cols)
    elif m.data_parallel * m.seq_parallel > 1 or m.seq_parallel > 1:
        mesh = pod_mesh(m.data_parallel, m.seq_parallel)
    if mesh is None and dist.is_initialized() and dist.get_world_size() > 1:
        raise ValueError(f"{dist.get_world_size()} ranks and no mesh: set mesh.data_parallel, "
                         "mesh.seq_parallel or mesh.grid_rows/grid_cols to cover them")
    return mesh


def run_steps(cfg: Config, state: TrainState, step_fn, data_iter, num_steps: int,
              callbacks=(), triage_fn=None, tracer: Optional[Tracer] = None,
              profiler: Optional[Profiler] = None, mesh=None) -> TrainState:
    """The loop of both training entry points: ``step_fn(state, batch, i) ->
    (state, metrics)`` for steps ``start .. num_steps - 1``, each batch
    taken from ``data_iter`` (numpy) onto the state's device.

    With ``train.checkpoint_dir`` it follows JAX's cadence: restore the
    latest checkpoint first (``start`` is its step; the batches those steps
    took are skipped, so a resumed run sees the stream an uninterrupted one
    does, where JAX restarts the stream), save every ``checkpoint_every``
    steps and at the end unless a checkpoint of that step exists; on
    SIGTERM finish the step in flight, checkpoint it and stop. The previous
    SIGTERM handler comes back afterwards; off the main thread the loop runs
    without one. Metrics go to ``MetricsLogger(train.checkpoint_dir)``
    (``metrics.jsonl`` there, and stdout): the first step's
    ``first_step_s``, then ``steps_per_sec``, every ``log_every`` steps.

    With ``triage_fn(batch, i) -> stats`` the loop keeps each step's
    ``(grads_ok, batch, i)`` and, one step late (so the host never waits on
    the step it just issued), reruns a skipped step through it on the
    parameters the skip left (``make_triage_step``), logging ``event: nan_triage`` with
    ``first_nonfinite``, ``nonfinite`` and the flattened stats (JAX
    :626-667). ``tracer`` gets the spans ``train.step``,
    ``train.next_batch``, ``train.checkpoint`` and ``train.nan_triage``,
    the ``numerics.nan_triage`` instant and, where the metrics carry
    ``numerics``, its counters; ``profiler`` opens and closes its window
    around the steps.

    In a process group of several ranks every rank runs the loop on the
    same stream: each batch goes to the device whole, or on a ``mesh`` as
    this rank's ``dp`` slice (:func:`device_put_batch`); only rank 0 logs
    metrics and writes checkpoints (every rank waits for the write and
    restores the same files), and a SIGTERM on any rank stops every rank
    after the same step. Returns the state."""
    import signal

    from alphafold2_tpu_torch.train.checkpoint import CheckpointManager

    t = cfg.train
    dev = state.skipped.device
    group = dist.is_initialized() and dist.get_world_size() > 1
    tracer = tracer or Tracer()
    profiler = profiler or Profiler(None)
    logger = MetricsLogger(t.checkpoint_dir, enabled=is_lead_rank())
    ckpt = (CheckpointManager(t.checkpoint_dir, keep=t.keep_checkpoints, distributed=group)
            if t.checkpoint_dir else None)
    start = 0
    if ckpt is not None:
        state, start = ckpt.maybe_restore(state)
        for _ in range(start):
            next(data_iter)
    stop = {"requested": False}
    installed, prev_handler = False, None
    if ckpt is not None:
        def _on_sigterm(signum, frame):
            stop["requested"] = True

        try:
            prev_handler = signal.signal(signal.SIGTERM, _on_sigterm)
            installed = True
        except ValueError:  # not on the main thread
            pass

    def run_triage(ok, t_batch, t_step):
        if bool(ok):
            return
        with tracer.span("train.nan_triage", step=t_step):
            stats = triage_fn(t_batch, t_step)
        report = numerics.triage_report(stats, step=t_step)
        logger.log(t_step, {"event": "nan_triage",
                            "first_nonfinite": report["first_nonfinite"],
                            "nonfinite": report["nonfinite"],
                            **numerics.flatten_stats(stats)})
        tracer.instant("numerics.nan_triage", step=t_step,
                       first_nonfinite=report["first_nonfinite"])

    pending = None  # (grads_ok, batch, step) of the last step under triage
    t0 = time.perf_counter()
    last_logged = None
    try:
        for i in range(start, num_steps):
            if pending is not None:
                run_triage(*pending)
                pending = None
            with tracer.span("train.next_batch", step=i):
                batch = device_put_batch(next(data_iter), dev, mesh)
            profiler.maybe_start(i)
            with tracer.span("train.step", step=i):
                state, metrics = step_fn(state, batch, i)
            profiler.maybe_stop(i)
            if triage_fn is not None:
                pending = (metrics["grads_ok"], batch, i)
            if (i + 1) % t.log_every == 0 or i == start:
                m = flatten_metrics(metrics)
                now = time.perf_counter()
                if last_logged is None:
                    m["first_step_s"] = round(now - t0, 4)
                else:
                    m["steps_per_sec"] = (i - last_logged) / max(now - t0, 1e-9)
                if isinstance(metrics.get("numerics"), dict):
                    numerics.counters_to_tracer(metrics["numerics"], tracer)
                last_logged, t0 = i, now
                logger.log(i, m)
            for cb in callbacks:
                cb(i, state, metrics)
            if ckpt is not None and (i + 1) % t.checkpoint_every == 0:
                with tracer.span("train.checkpoint", step=i + 1):
                    ckpt.save(i + 1, state)
            if group and ckpt is not None:  # one rank's SIGTERM stops them all
                flag = torch.tensor(float(stop["requested"]), device=dev)
                dist.all_reduce(flag, op=dist.ReduceOp.MAX)
                stop["requested"] = bool(flag)
            if stop["requested"]:
                logger.log(i, {"preempted": 1.0})
                if ckpt.latest_step() != i + 1:
                    ckpt.save(i + 1, state)
                break
        if pending is not None:  # a skip on the run's last step
            run_triage(*pending)
    finally:
        if installed:
            signal.signal(signal.SIGTERM, prev_handler)
    if ckpt is not None:
        if not stop["requested"] and ckpt.latest_step() != state.step:
            ckpt.save(state.step, state)
        ckpt.wait()
        ckpt.close()
    return state


def train(cfg: Config, num_steps: Optional[int] = None, dataset=None, callbacks=(),
          device: Optional[Union[str, torch.device]] = None) -> TrainState:
    """Distogram pretraining (the runnable ``train_pre.py`` equivalent).

    Runs on the CUDA card unless ``device="cpu"``; without a card it raises.
    ``dataset`` (an iterable of numpy batches) replaces the configured
    source (a source the loop makes it closes on every exit); each
    ``callbacks`` entry is called as ``cb(step, state, metrics)`` after
    every step; checkpoints, metrics, triage, spans and the profiler window
    as :func:`run_steps` says. Under ``torchrun`` it initialises the process
    group (NCCL on the card, gloo with ``device="cpu"``) and trains on the
    mesh ``cfg.mesh`` asks for (:func:`make_train_mesh`); every rank reads
    the same stream, the global batch. Returns the final
    :class:`TrainState`."""
    from alphafold2_tpu_torch.data.pipeline import make_dataset
    from alphafold2_tpu_torch.parallel.distributed import initialize

    t = cfg.train
    numerics_mode = (os.environ.get("AF2TPU_NUMERICS") or t.numerics or "off").lower()
    if numerics_mode not in ("off", "triage", "full"):
        raise ValueError(f"unknown train.numerics {numerics_mode!r}; "
                         "expected 'off', 'triage' or 'full'")
    initialize(device=device)  # first: it picks this rank's card (LOCAL_RANK)
    dev = resolve_device(device)
    mesh = make_train_mesh(cfg)
    lead = is_lead_rank()
    num_steps = num_steps or t.num_steps
    owned = dataset is None
    dataset = make_dataset(cfg.data, seed=t.seed) if owned else dataset
    tracer = Tracer(t.trace_events if lead else None)
    try:
        data_iter = apply_features(iter(dataset), cfg)
        sample = next(data_iter)
        data_iter = itertools.chain([sample], data_iter)

        model = build_model(cfg, num_embedds=embedds_width(sample))
        state = init_state(cfg, model, device=dev)
        step = make_train_step(state.model, mesh, {"off": "off", "triage": "norms",
                                                   "full": "full"}[numerics_mode])
        key = lambda i: DropoutKey.for_step(t.seed + 1, i)
        triage_fn = None
        if numerics_mode != "off":
            triage = make_triage_step(state.model, mesh)
            triage_fn = lambda batch, i: triage(batch, key(i))
        return run_steps(cfg, state, lambda st, batch, i: step(st, batch, key(i)), data_iter,
                         num_steps, callbacks, triage_fn=triage_fn, tracer=tracer,
                         profiler=Profiler(t.profile_dir if lead else None, t.profile_steps,
                                           dev), mesh=mesh)
    finally:
        tracer.close()
        close_owned(dataset, owned)
