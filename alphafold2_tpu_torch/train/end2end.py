"""End-to-end structure training: distogram -> 3D coordinates -> refine -> RMSD.

Port of ``alphafold2_tpu/train/end2end.py``: ``elongate`` and
``End2EndModel`` (:46-148): residues elongate x3 into (N, CA, C) tokens,
the Alphafold2 trunk predicts a distogram over the 3L x 3L atom grid,
``realize_structure`` turns it into coordinates (softmax, centering,
weighted MDS with the mirror fix), ``sidechain_container`` lifts the
backbone to atom14 (padded residues parked at the origin, :120-126), and
the SE(3) refiner moves the atoms; :func:`structure_loss` (:151),
:func:`make_end2end_step` (:180) and :func:`train_end2end` (:259); JAX's
``init_end2end_state`` (:232) is ``train.loop.init_state``, which both
loops share. The gradient flows back through the refiner,
``sidechain_container``, the MDS iterations and the trunk; the chirality
decision and the Kabsch rotation are taken on detached values, as in JAX.

The MDS start: JAX splits a fresh key each step and starts MDS from a new
uniform draw over (B, 3L, 3). The port draws that start in [-1, 1) from a
numpy generator keyed by ``(train.seed + 1, step)`` (:func:`mds_start`)
and passes it as ``coords0``; the bits differ from threefry, so tests
inject JAX's start. The trunk engines ``remat`` (with ``remat_policy``)
and ``reversible`` train here as in JAX (:285-295, which passes no
``scan_layers``). As JAX's ``train_end2end`` (:259-346), it reads neither
the dropout rates (``End2EndModel`` has none, and no dropout key reaches
it), nor ``train.numerics``, ``profile_dir`` or ``trace_events``: such a
config trains as it would without them. Metrics go to ``metrics.jsonl`` in
``train.checkpoint_dir``, as JAX's loop writes them (:314). With
``data.features="plm"`` the batches carry ``embedds`` (``data/plm.py``)
in place of the MSA: ``End2EndModel`` repeats each residue's embedding
x3 in place, as it elongates the tokens (:86-88), and ``embedd_project``
takes the stream's width (JAX's init takes it from the sample batch). A
device mesh raises.
"""

from __future__ import annotations

import itertools
from typing import Optional, Union

import numpy as np
import torch
from torch import nn

from alphafold2_tpu_torch import constants
from alphafold2_tpu_torch.config import Config
from alphafold2_tpu_torch.device import resolve_device
from alphafold2_tpu_torch.models.alphafold2 import Alphafold2
from alphafold2_tpu_torch.models.se3 import SE3Refiner
from alphafold2_tpu_torch.train.loop import (
    TrainState, apply_features, apply_gradients, check_unported, close_owned,
    collect_gradients, embedds_width, init_state, run_steps,
)
from alphafold2_tpu_torch.train.optim import global_norm
from alphafold2_tpu_torch.utils.metrics import kabsch
from alphafold2_tpu_torch.utils.structure import sidechain_container


def elongate(seq: torch.Tensor, mask: torch.Tensor):
    """(B, L) residue tokens and mask -> (B, 3L) atom-level stream."""
    return (seq.repeat_interleave(3, dim=1), mask.repeat_interleave(3, dim=1))


class End2EndModel(nn.Module):
    """Alphafold2 trunk + structure realization + SE(3) refiner.

    Submodules are ``af2`` and ``refiner``, the flax names. ``mds_seed``
    keys the position-keyed MDS start (utils/mds.py) when no ``coords0`` is
    passed to :meth:`forward`. ``remat``, ``remat_policy`` and
    ``reversible`` choose the trunk's engine (JAX's fields, :71-73);
    ``msa_row_shard``, ``grid_parallel`` and ``context_parallel`` go to the
    trunk (:75-77), which applies none on one device; ``num_embedds``, the
    ``embedds`` width, builds ``af2.embedd_project``."""

    def __init__(
        self,
        dim: int = 256,
        depth: int = 1,
        heads: int = 8,
        dim_head: int = 64,
        max_seq_len: int = 2048,
        mds_iters: int = 200,
        refiner_depth: int = 2,
        msa_tie_row_attn: bool = False,
        mds_seed: int = 0,
        dtype: torch.dtype = torch.float32,
        remat: bool = False,
        remat_policy: Optional[str] = None,
        reversible: bool = False,
        msa_row_shard: bool = False,
        grid_parallel: bool = False,
        context_parallel: Optional[str] = None,
        num_embedds: Optional[int] = None,
    ):
        super().__init__()
        self.mds_iters = mds_iters
        self.mds_seed = mds_seed
        self.af2 = Alphafold2(
            dim=dim, max_seq_len=max_seq_len, depth=depth, heads=heads,
            dim_head=dim_head, msa_tie_row_attn=msa_tie_row_attn, dtype=dtype,
            remat=remat, remat_policy=remat_policy, reversible=reversible,
            msa_row_shard=msa_row_shard, grid_parallel=grid_parallel,
            context_parallel=context_parallel, num_embedds=num_embedds,
        )
        self.refiner = SE3Refiner(
            dim=64, depth=refiner_depth,
            num_tokens=constants.NUM_COORDS_PER_RES, dtype=dtype,
        )

    def forward(self, seq, msa=None, mask=None, msa_mask=None, embedds=None,
                coords0: Optional[torch.Tensor] = None) -> dict:
        from alphafold2_tpu_torch.predict import realize_structure

        b, l = seq.shape
        if mask is None:
            mask = torch.ones((b, l), dtype=torch.bool, device=seq.device)
        seq3, mask3 = elongate(seq, mask)
        if embedds is not None:  # per residue: each repeats x3 in place
            embedds = embedds.repeat_interleave(3, dim=1)
        logits = self.af2(seq3, msa, mask=mask3, msa_mask=msa_mask, embedds=embedds)
        coords, distances, weights = realize_structure(
            logits, iters=self.mds_iters, mask=mask3, coords0=coords0,
            seed=self.mds_seed,
        )  # coords (B, 3, 3L)
        backbone = coords.transpose(-1, -2)  # (B, 3L, 3)
        proto = sidechain_container(backbone, place_oxygen=True, mask=mask)
        # padded residues' atoms sit at the origin: the refiner's geometry
        # must see finite values independent of the padded MDS positions
        proto = torch.where(mask[:, :, None, None], proto, torch.zeros_like(proto))
        n_atoms = constants.NUM_COORDS_PER_RES
        atom_tokens = torch.arange(n_atoms, device=seq.device).repeat(b, l)
        atom_mask = mask.repeat_interleave(n_atoms, dim=1)
        refined = self.refiner(atom_tokens, proto.reshape(b, -1, 3), mask=atom_mask)
        return {
            "distogram": logits,
            "distances": distances,
            "weights": weights,
            "proto": proto,
            "refined": refined.reshape(b, l, n_atoms, 3),
        }


def structure_loss(out: dict, backbone_true: torch.Tensor, mask: torch.Tensor):
    """Kabsch-aligned backbone RMSD over valid atoms (masked atoms zeroed on
    both sides before the alignment) plus 0.1 x the dispersion of 1/w over
    positive weights. Returns ``(loss, {"rmsd", "dispersion"})``, batch
    means."""
    refined_bb = out["refined"][:, :, :3].reshape(backbone_true.shape)  # (B, 3L, 3)
    pred = refined_bb.transpose(-1, -2)  # (B, 3, 3L)
    true = backbone_true.transpose(-1, -2)
    mask3 = mask.repeat_interleave(3, dim=1)
    valid = mask3.to(pred.dtype)
    aligned, centered = kabsch(pred * valid[:, None, :], true * valid[:, None, :])
    denom = mask3.sum(-1).clamp_min(1)
    sq = ((aligned - centered) ** 2).sum(-2) * valid
    rmsd = torch.sqrt(sq.sum(-1) / denom)
    w = out["weights"]
    disp = (torch.abs(1.0 / w.clamp_min(1e-7) - 1.0) * (w > 0).to(w.dtype)).mean(dim=(-1, -2))
    return (rmsd + 0.1 * disp).mean(), {"rmsd": rmsd.mean(), "dispersion": disp.mean()}


def mds_start(seed: int, step: int, batch: int, n: int,
              device: Optional[Union[str, torch.device]] = None) -> torch.Tensor:
    """Step ``step``'s MDS start, (batch, n, 3) float32 in [-1, 1), from a
    numpy generator keyed by ``(seed, step)``."""
    draw = np.random.default_rng([int(seed), int(step)]).random((batch, n, 3))
    return torch.from_numpy((2.0 * draw - 1.0).astype(np.float32)).to(device)


def make_end2end_step(model: End2EndModel):
    """Build the end-to-end step: ``step(state, batch, coords0) -> (state,
    metrics)``, ``batch`` a dict of tensors on the model's device with
    ``backbone`` (B, 3L, 3), ``coords0`` the (B, 3L, 3) MDS start.

    As the distogram step: gradients that are not all finite are zeroed,
    still applied and counted in ``state.skipped``; leaves with no gradient
    get zeros. Metrics: ``loss``, ``grad_norm`` (of the raw gradients),
    ``grads_ok``, ``rmsd``, ``dispersion``, device tensors (nothing
    synchronises)."""

    def step(state: TrainState, batch: dict, coords0: torch.Tensor):
        params = list(state.model.parameters())
        for p in params:
            p.grad = None
        out = state.model(batch["seq"], batch.get("msa"), mask=batch["mask"],
                          msa_mask=batch.get("msa_mask"), embedds=batch.get("embedds"),
                          coords0=coords0)
        loss, aux = structure_loss(out, batch["backbone"], batch["mask"])
        loss.backward()
        grads, grads_ok = collect_gradients(params)
        apply_gradients(state, grads, grads_ok)
        return state, {"loss": loss.detach(), "grad_norm": global_norm(grads),
                       "grads_ok": grads_ok, "rmsd": aux["rmsd"].detach(),
                       "dispersion": aux["dispersion"].detach()}

    return step


def build_end2end_model(cfg: Config, mds_iters: int = 200,
                        num_embedds: Optional[int] = None) -> End2EndModel:
    """The End2EndModel JAX's ``train_end2end`` builds from ``cfg.model``
    (:285-295): serving's fields (``predict.build_model``) and, for
    training, ``remat_policy`` and ``reversible``; the dropout rates are
    not read, as in JAX. ``num_embedds`` is the ``embedds`` width of a PLM
    stream. A device mesh raises (``loop.check_unported``)."""
    from alphafold2_tpu_torch.predict import build_model

    check_unported(cfg)
    return build_model(cfg, mds_iters=mds_iters, remat_policy=cfg.model.remat_policy,
                       reversible=cfg.model.reversible, num_embedds=num_embedds)


def train_end2end(cfg: Config, num_steps: Optional[int] = None, dataset=None,
                  callbacks=(), device: Optional[Union[str, torch.device]] = None
                  ) -> TrainState:
    """End-to-end structure training (the runnable ``train_end2end.py``).

    Runs on the CUDA card unless ``device="cpu"``; without a card it raises.
    ``dataset`` (an iterable of numpy batches with ``backbone``) replaces
    the configured source; each ``callbacks`` entry is called as ``cb(step,
    state, metrics)`` after every step. Checkpoints, logs and SIGTERM as
    ``train.loop.run_steps`` says. Returns the final state."""
    from alphafold2_tpu_torch.data.pipeline import make_dataset

    t = cfg.train
    if cfg.model.max_seq_len < 3 * cfg.data.crop_len:
        raise ValueError(
            f"end-to-end training elongates each residue x3 (N/CA/C): "
            f"model.max_seq_len={cfg.model.max_seq_len} must be >= "
            f"3*data.crop_len={3 * cfg.data.crop_len}")
    check_unported(cfg)
    dev = resolve_device(device)
    num_steps = num_steps or t.num_steps
    owned = dataset is None
    dataset = make_dataset(cfg.data, seed=t.seed) if owned else dataset
    try:
        data_iter = apply_features(iter(dataset), cfg)
        sample = next(data_iter)
        data_iter = itertools.chain([sample], data_iter)

        state = init_state(cfg, build_end2end_model(cfg, num_embedds=embedds_width(sample)),
                           device=dev)
        step = make_end2end_step(state.model)

        def step_fn(st, batch, i):
            b, l = batch["seq"].shape
            return step(st, batch, mds_start(t.seed + 1, i, b, 3 * l, dev))

        return run_steps(cfg, state, step_fn, data_iter, num_steps, callbacks)
    finally:
        close_owned(dataset, owned)
