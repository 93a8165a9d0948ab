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
backward K3a + K3b (``ops/cuda/axial.py``). The step mirrors the JAX one:
gradients that are not all finite are zeroed and still applied, so Adam's
moments and counts move while the parameters do not, and ``skipped`` counts
the step. PyTorch updates the state in place; the step returns it anyway,
as the JAX step returns its new state.

Not ported (each raises ``NotImplementedError``): ``train.numerics="full"``
and the NaN-triage rerun of a skipped step (``numerics="triage"`` gives the
per-group norms and logs that the rerun did not run), profiling, host span
traces, a device mesh, dropout, and the ``plm`` feature stream. The trunk
engines (``remat`` with ``remat_policy``, ``reversible``, ``scan_layers``)
train as in JAX (``models/trunk.py``, ``models/reversible.py``).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional, Union

import numpy as np
import torch
from torch import nn

from alphafold2_tpu_torch.config import Config
from alphafold2_tpu_torch.device import resolve_device
from alphafold2_tpu_torch.models.alphafold2 import Alphafold2
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
    validf = valid.to(nll.dtype)
    return (nll * validf).sum() / validf.sum().clamp_min(1.0)


def apply_features(data_iter, cfg: Config):
    """Adapt the batch stream to ``data.features``: "msa" (as is) or "none"
    (sequence only). "plm" is not ported."""
    if cfg.data.features == "plm":
        raise NotImplementedError("the plm feature stream is not ported yet")
    if cfg.data.features == "none":
        return ({k: v for k, v in b.items() if k not in ("msa", "msa_mask")}
                for b in data_iter)
    if cfg.data.features != "msa":
        raise ValueError(f"unknown data.features {cfg.data.features!r}")
    return data_iter


def build_model(cfg: Config) -> Alphafold2:
    """The distogram model ``cfg.model`` describes; float32 parameters,
    bfloat16 compute when ``model.bfloat16``."""
    m = cfg.model
    if (m.msa_row_shard or m.grid_parallel or m.context_parallel is not None
            or m.cross_attn_compress_ratio != 1):
        raise NotImplementedError(
            "sharding, context parallelism and KV compression are not ported yet"
        )
    return Alphafold2(
        dim=m.dim, max_seq_len=m.max_seq_len, depth=m.depth, heads=m.heads,
        dim_head=m.dim_head, gelu_exact=m.gelu_exact,
        msa_tie_row_attn=m.msa_tie_row_attn,
        dtype=torch.bfloat16 if m.bfloat16 else torch.float32,
        attn_dropout=m.attn_dropout, ff_dropout=m.ff_dropout, remat=m.remat,
        remat_policy=m.remat_policy, reversible=m.reversible, scan_layers=m.scan_layers,
        sparse_self_attn=m.sparse_self_attn,
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


def make_train_step(model: nn.Module, numerics_mode: str = "off"):
    """Build the distogram-pretraining step: ``step(state, batch) ->
    (state, metrics)``, ``batch`` a dict of tensors on the model's device.

    Metrics: ``loss``, ``grad_norm`` (of the raw gradients), ``grads_ok``,
    ``skipped``, ``distogram_entropy``; with ``numerics_mode="norms"`` also
    ``grad_norm/<group>``, ``param_norm/<group>``, ``update_norm/<group>``
    and ``param_norm``. Values are device tensors (nothing synchronises)."""
    if numerics_mode not in ("off", "norms"):
        if numerics_mode == "full":
            raise NotImplementedError("numerics_mode 'full' is not ported yet")
        raise ValueError(f"unknown numerics_mode {numerics_mode!r}; expected 'off' or 'norms'")
    groups = _param_groups(model)

    def step(state: TrainState, batch: dict):
        params = list(state.model.parameters())
        for p in params:
            p.grad = None
        logits = state.model(batch["seq"], batch.get("msa"), mask=batch["mask"],
                             msa_mask=batch.get("msa_mask"))
        labels = batch.get("labels")
        if labels is None:
            labels = get_bucketed_distance_matrix(batch["coords"], batch["mask"])
        loss = distogram_cross_entropy(logits, labels)
        loss.backward()
        grads, grads_ok = collect_gradients(params)
        before = [p.detach().clone() for p in params] if numerics_mode == "norms" else None
        apply_gradients(state, grads, grads_ok)
        with torch.no_grad():
            logits = logits.detach()
            entropy = -(torch.softmax(logits, -1) * torch.log_softmax(logits, -1)).sum(-1).mean()
        metrics = {"loss": loss.detach(), "grad_norm": global_norm(grads),
                   "grads_ok": grads_ok, "skipped": state.skipped,
                   "distogram_entropy": entropy}
        if numerics_mode == "norms":
            for group, idx in groups.items():
                metrics[f"grad_norm/{group}"] = global_norm([grads[i] for i in idx])
                metrics[f"param_norm/{group}"] = global_norm([params[i].detach() for i in idx])
                metrics[f"update_norm/{group}"] = global_norm(
                    [params[i].detach() - before[i] for i in idx])
            metrics["param_norm"] = global_norm([p.detach() for p in params])
        return state, metrics

    return step


def batch_to_device(batch: dict, device: torch.device) -> dict:
    """numpy batch -> tensors on ``device``; token arrays become int64."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if k in ("seq", "msa"):
            t = t.long()
        out[k] = t.to(device)
    return out


def _log(step: int, metrics: dict) -> None:
    print(f"[step {step}] " + " ".join(
        f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
        for k, v in metrics.items()), flush=True)


def _note_skip(pending) -> None:
    """Log a skipped step's NaN triage as not run (read one step late, so
    the host never waits on the step it just issued)."""
    if pending is not None and not bool(pending[0]):
        _log(pending[1], {"event": "nan_triage", "ran": 0.0,
                          "reason": "the fully tagged rerun is not ported"})


def check_unported(cfg: Config) -> None:
    """Raise for the options neither training loop honours yet."""
    m, t = cfg.model, cfg.train
    if m.attn_dropout or m.ff_dropout:
        raise NotImplementedError(
            f"dropout (attn {m.attn_dropout}, ff {m.ff_dropout}) is not ported yet")
    for field, value in (("profile_dir", t.profile_dir), ("trace_events", t.trace_events)):
        if value:
            raise NotImplementedError(f"train.{field} is not ported yet")
    mesh = cfg.mesh
    if (mesh.data_parallel not in (1, -1) or mesh.seq_parallel != 1
            or mesh.grid_rows * mesh.grid_cols != 1):
        raise NotImplementedError("a device mesh is not ported yet: one device only")


def run_steps(cfg: Config, state: TrainState, step_fn, data_iter, num_steps: int,
              callbacks=(), triage: bool = False) -> TrainState:
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
    without one. Logs the first step's ``first_step_s`` and then
    ``steps_per_sec``; with ``triage`` a skipped step's NaN triage is noted
    one step late. Returns the state."""
    import signal

    from alphafold2_tpu_torch.train.checkpoint import CheckpointManager

    t = cfg.train
    dev = state.skipped.device
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
    pending = None  # (grads_ok, step) of the last step under triage
    t0 = time.perf_counter()
    last_logged = None
    try:
        for i in range(start, num_steps):
            _note_skip(pending)
            pending = None
            batch = batch_to_device(next(data_iter), dev)
            state, metrics = step_fn(state, batch, i)
            if triage:
                pending = (metrics["grads_ok"], i)
            if (i + 1) % t.log_every == 0 or i == start:
                m = {k: float(v) for k, v in metrics.items()}
                now = time.perf_counter()
                if last_logged is None:
                    m["first_step_s"] = round(now - t0, 4)
                else:
                    m["steps_per_sec"] = (i - last_logged) / max(now - t0, 1e-9)
                last_logged, t0 = i, now
                _log(i, m)
            for cb in callbacks:
                cb(i, state, metrics)
            if ckpt is not None and (i + 1) % t.checkpoint_every == 0:
                ckpt.save(i + 1, state)
            if stop["requested"]:
                _log(i, {"preempted": 1.0})
                if ckpt.latest_step() != i + 1:
                    ckpt.save(i + 1, state)
                break
        _note_skip(pending)
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
    source; each ``callbacks`` entry is called as ``cb(step, state,
    metrics)`` after every step; checkpoints as :func:`run_steps` says.
    Returns the final :class:`TrainState`."""
    from alphafold2_tpu_torch.data.pipeline import make_dataset

    t = cfg.train
    check_unported(cfg)
    numerics_mode = (os.environ.get("AF2TPU_NUMERICS") or t.numerics or "off").lower()
    if numerics_mode not in ("off", "triage", "full"):
        raise ValueError(f"unknown train.numerics {numerics_mode!r}; "
                         "expected 'off', 'triage' or 'full'")
    if numerics_mode == "full":
        raise NotImplementedError("train.numerics='full' is not ported yet")
    dev = resolve_device(device)
    num_steps = num_steps or t.num_steps
    dataset = dataset if dataset is not None else make_dataset(cfg.data, seed=t.seed)
    data_iter = apply_features(iter(dataset), cfg)

    model = build_model(cfg)
    state = init_state(cfg, model, device=dev)
    step = make_train_step(state.model, "norms" if numerics_mode == "triage" else "off")
    return run_steps(cfg, state, lambda st, batch, i: step(st, batch), data_iter,
                     num_steps, callbacks, triage=numerics_mode == "triage")
