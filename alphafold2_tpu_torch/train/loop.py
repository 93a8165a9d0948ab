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
plain model on one device: JAX's ``train`` without a mesh gives the same
losses and parameters bit for bit with and without each.

Not ported (raises ``NotImplementedError``): a device mesh. The trunk
engines (``remat`` with ``remat_policy``, ``reversible``, ``scan_layers``)
and KV compression (``model.cross_attn_compress_ratio`` above 1, the
pair<-MSA pass of every engine) train as in JAX (``models/trunk.py``,
``models/reversible.py``, ``ops/attention.py``). A dataset the loop makes
from ``cfg.data`` it also closes (the native loader's threads), as JAX's
does (:712-713).
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import time
from typing import Optional, Union

import numpy as np
import torch
from torch import nn

from alphafold2_tpu_torch.config import Config
from alphafold2_tpu_torch.device import resolve_device
from alphafold2_tpu_torch.models.alphafold2 import Alphafold2
from alphafold2_tpu_torch.observe import MetricsLogger, Profiler, Tracer, flatten_metrics
from alphafold2_tpu_torch.observe import numerics
from alphafold2_tpu_torch.ops.attention import DropoutKey
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
                            ignore_index: int = -100) -> torch.Tensor:
    """Mean cross-entropy over the pairs whose label is not ``ignore_index``,
    in float32; 0 when every pair is ignored."""
    valid = labels != ignore_index
    safe = torch.where(valid, labels, 0).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    # the last forward tensor: a first non-finite here is the loss's own
    nll = numerics.tag("loss.distogram_nll", nll)
    validf = valid.to(nll.dtype)
    return (nll * validf).sum() / validf.sum().clamp_min(1.0)


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
    docstring)."""
    m = cfg.model
    return Alphafold2(
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


def collect_gradients(params) -> tuple:
    """Each parameter's gradient after ``backward`` (zeros where autograd
    left none, as JAX gives zeros for leaves that do not reach the loss)
    and whether all are finite, as a device bool."""
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    grads_ok = torch.stack([torch.isfinite(g).all() for g in grads]).all()
    return grads, grads_ok


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


def _forward_loss(model: nn.Module, batch: dict, key: Optional[DropoutKey]):
    logits = model(batch["seq"], batch.get("msa"), mask=batch["mask"],
                   msa_mask=batch.get("msa_mask"), embedds=batch.get("embedds"),
                   dropout_key=key)
    return logits, distogram_cross_entropy(logits, _labels(batch))


def make_train_step(model: nn.Module, numerics_mode: str = "off"):
    """Build the distogram-pretraining step: ``step(state, batch, key=None)
    -> (state, metrics)``, ``batch`` a dict of tensors on the model's
    device, ``key`` the step's ``DropoutKey`` (dropout is off without one).

    Metrics: ``loss``, ``grad_norm`` (of the raw gradients), ``grads_ok``,
    ``skipped``, ``distogram_entropy``; with ``numerics_mode="norms"`` or
    ``"full"`` also ``grad_norm/<group>``, ``param_norm/<group>``,
    ``update_norm/<group>`` and ``param_norm``; with ``"full"`` also
    ``numerics``, every tag's stats (``observe/numerics.py``). Values are
    device tensors (nothing synchronises)."""
    if numerics_mode not in ("off", "norms", "full"):
        raise ValueError(f"unknown numerics_mode {numerics_mode!r}; "
                         "expected 'off', 'norms' or 'full'")
    groups = _param_groups(model)
    norms = numerics_mode != "off"

    def step(state: TrainState, batch: dict, key: Optional[DropoutKey] = None):
        params = list(state.model.parameters())
        for p in params:
            p.grad = None
        with numerics.collect(enabled=numerics_mode == "full") as col:
            logits, loss = _forward_loss(state.model, batch, key)
        loss.backward()
        grads, grads_ok = collect_gradients(params)
        before = [p.detach().clone() for p in params] if norms else None
        apply_gradients(state, grads, grads_ok)
        with torch.no_grad():
            logits = logits.detach()
            entropy = -(torch.softmax(logits, -1) * torch.log_softmax(logits, -1)).sum(-1).mean()
        metrics = {"loss": loss.detach(), "grad_norm": global_norm(grads),
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


def make_triage_step(model: nn.Module):
    """The fully tagged diagnostic step of NaN triage (JAX :371-425):
    ``triage(batch, key) -> stats``, the model's current parameters run
    forward and backward under ``key`` with no state change. ``stats`` maps
    every tag to its ``numerics.tensor_stats``, then ``loss``, then
    ``grad/<group>`` (``numerics.tree_stats`` of a parameter group's
    gradients), each with its ``index`` in that order, so
    ``numerics.first_nonfinite`` names the first tensor that went bad."""
    groups = _param_groups(model)

    def triage(batch: dict, key: Optional[DropoutKey] = None) -> dict:
        params = list(model.parameters())
        with numerics.collect() as col:
            _, loss = _forward_loss(model, batch, key)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        stats = col.stats()
        order = len(stats)
        stats["loss"] = {"index": order, **numerics.tensor_stats(loss)}
        for name in sorted(groups):  # JAX's grads are a dict in key order
            order += 1
            stats[f"grad/{name}"] = {"index": order, **numerics.tree_stats(
                grads[i] if grads[i] is not None else torch.zeros_like(params[i])
                for i in groups[name])}
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


def close_owned(dataset, owned: bool) -> None:
    """Close a dataset the loop made itself (the native loaders stop their
    worker threads); one the caller passed stays the caller's."""
    if owned and hasattr(dataset, "close"):
        dataset.close()


def check_unported(cfg: Config) -> None:
    """Raise for what neither training loop honours yet: a device mesh."""
    mesh = cfg.mesh
    if (mesh.data_parallel not in (1, -1) or mesh.seq_parallel != 1
            or mesh.grid_rows * mesh.grid_cols != 1):
        raise NotImplementedError("a device mesh is not ported yet: one device only")


def run_steps(cfg: Config, state: TrainState, step_fn, data_iter, num_steps: int,
              callbacks=(), triage_fn=None, tracer: Optional[Tracer] = None,
              profiler: Optional[Profiler] = None) -> TrainState:
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
    around the steps. Returns the state."""
    import signal

    from alphafold2_tpu_torch.train.checkpoint import CheckpointManager

    t = cfg.train
    dev = state.skipped.device
    tracer = tracer or Tracer()
    profiler = profiler or Profiler(None)
    logger = MetricsLogger(t.checkpoint_dir)
    ckpt = (CheckpointManager(t.checkpoint_dir, keep=t.keep_checkpoints)
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
                batch = batch_to_device(next(data_iter), dev)
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
    as :func:`run_steps` says. Returns the final :class:`TrainState`."""
    from alphafold2_tpu_torch.data.pipeline import make_dataset

    t = cfg.train
    check_unported(cfg)
    numerics_mode = (os.environ.get("AF2TPU_NUMERICS") or t.numerics or "off").lower()
    if numerics_mode not in ("off", "triage", "full"):
        raise ValueError(f"unknown train.numerics {numerics_mode!r}; "
                         "expected 'off', 'triage' or 'full'")
    dev = resolve_device(device)
    num_steps = num_steps or t.num_steps
    owned = dataset is None
    dataset = make_dataset(cfg.data, seed=t.seed) if owned else dataset
    tracer = Tracer(t.trace_events)
    try:
        data_iter = apply_features(iter(dataset), cfg)
        sample = next(data_iter)
        data_iter = itertools.chain([sample], data_iter)

        model = build_model(cfg, num_embedds=embedds_width(sample))
        state = init_state(cfg, model, device=dev)
        step = make_train_step(state.model, {"off": "off", "triage": "norms",
                                             "full": "full"}[numerics_mode])
        key = lambda i: DropoutKey.for_step(t.seed + 1, i)
        triage_fn = None
        if numerics_mode != "off":
            triage = make_triage_step(state.model)
            triage_fn = lambda batch, i: triage(batch, key(i))
        return run_steps(cfg, state, lambda st, batch, i: step(st, batch, key(i)), data_iter,
                         num_steps, callbacks, triage_fn=triage_fn, tracer=tracer,
                         profiler=Profiler(t.profile_dir, t.profile_steps, dev))
    finally:
        tracer.close()
        close_owned(dataset, owned)
