"""The audited surface: what ``analysis/audit.py`` runs.

Counterpart of ``alphafold2_tpu/analysis/targets.py``. Each target names one
entry point of the port — the model forward, the distogram train step and
its gradients (dense and block-sparse), the serve forward in float32 and
bfloat16, the attention wrappers — built at the JAX registry's tiny shapes
(``_tiny_model_cfg``, :56-69: dim 32, depth 1, heads 2, dim_head 16, crop
16, MSA 2 x 16). ``build(device)`` returns ``(fn, args)``: the audit runs
``fn(*args)`` under its op recorder, on the card (where the wrappers'
CUDA branches and the kernels run) or on the CPU (the plain versions).
Weights come from the port's own init (``predict.init_params``, a seeded
``torch.Generator``), inputs from seeded numpy.

Targets waiving a rule carry its id in ``allow`` with a reason in
``allow_reasons``: a waiver without a reason fails construction, as in JAX.

The two sharded targets, ``serve_fwd_grid`` (a ``(dp, spr, spc)`` grid
mesh, bucket 8, batch 2) and ``serve_fwd_long`` (a 1D ``(1, sp)`` mesh,
bucket 16, batch 1), run the serving forward under a mesh over the
initialised process group's ranks, as JAX's run under a mesh over the
devices there are (``targets.py:184-275``): on one process ``scope`` gives
them a world of one rank (``parallel/distributed.py local_world``), where
every collective still runs; the collective audit
(``analysis/hlo_audit.py``) runs them on 2 and 4 gloo ranks on the CPU.
Every JAX target has its counterpart: :data:`NOT_PORTED` is empty.
"""

from __future__ import annotations

import dataclasses
from contextlib import nullcontext
from typing import Callable, Optional

import numpy as np
import torch

# each port target and the JAX target it stands for
JAX_COUNTERPARTS = {
    "model_fwd": "model_fwd",
    "train_step": "train_step",
    "train_grad": "train_grad",
    "serve_fwd": "serve_fwd",
    "serve_fwd_bf16": "serve_fwd_bf16",
    "attn_tied_row": "attn_tied_row_pallas",
    "attn_axial": "attn_axial_pallas",
    "train_step_sparse": None,  # the port's own: the block-sparse path on the card
    "serve_fwd_grid": "serve_fwd_grid",
    "serve_fwd_long": "serve_fwd_long",
}
NOT_PORTED: dict = {}


@dataclasses.dataclass(frozen=True)
class TraceTarget:
    """One audited entry point: ``build(device)`` returns ``(fn, args)``,
    run as ``fn(*args)``. ``hbm_budget_bytes`` is the declared ceiling on
    the device memory the run allocates (``AF2A110``, on the card); None
    records a no-data verdict. A sharded target's budget is per rank of
    its layout over ``budget_seq_ranks`` sequence ranks, JAX's CPU mesh;
    on fewer it is scaled (``budgets.check_rank_budget``)."""

    name: str
    build: Callable[[torch.device], tuple]
    allow: frozenset = frozenset()
    allow_reasons: Optional[dict] = None
    hbm_budget_bytes: Optional[int] = None
    sharded: bool = False  # runs under a mesh over the process group's ranks
    budget_seq_ranks: int = 1  # the sequence ranks hbm_budget_bytes is set for
    scope: Optional[Callable] = None  # device -> context the build and the run need

    def run_scope(self, device):
        """The context a build and its run go in (a world of one rank for a
        sharded target in a process without a group)."""
        return self.scope(device) if self.scope is not None else nullcontext()

    def __post_init__(self):
        missing = set(self.allow) - set(self.allow_reasons or {})
        if missing:
            raise ValueError(
                f"target {self.name!r} waives {sorted(missing)} without a "
                "reason; every waiver is reviewed"
            )


def _tiny_model_cfg(sparse: bool = False):
    from alphafold2_tpu_torch.config import Config

    cfg = Config()
    m, d, t = cfg.model, cfg.data, cfg.train
    m.dim, m.depth, m.heads, m.dim_head, m.max_seq_len, m.bfloat16 = 32, 1, 2, 16, 64, False
    d.crop_len, d.msa_depth, d.msa_len, d.batch_size, d.min_len_filter = 16, 2, 16, 1, 8
    t.gradient_accumulate_every, t.warmup_steps = 1, 2
    if sparse:
        # two 16-blocks per pair axis, so the layout has more than one block
        m.sparse_self_attn = True
        d.crop_len = d.msa_len = 32
    return cfg


def _batch(cfg, device):
    from alphafold2_tpu_torch.data.pipeline import SyntheticDataset
    from alphafold2_tpu_torch.train.loop import batch_to_device

    return batch_to_device(next(iter(SyntheticDataset(cfg.data, seed=0))), device)


def _distogram_model(cfg, device):
    from alphafold2_tpu_torch.predict import init_params
    from alphafold2_tpu_torch.train.loop import build_model

    return init_params(build_model(cfg), seed=0).to(device)


def _build_model_fwd(device):
    cfg = _tiny_model_cfg()
    model = _distogram_model(cfg, device).eval()
    seq = torch.zeros((1, 16), dtype=torch.long, device=device)
    msa = torch.zeros((1, 2, 16), dtype=torch.long, device=device)
    mask = torch.ones((1, 16), dtype=torch.bool, device=device)
    msa_mask = torch.ones((1, 2, 16), dtype=torch.bool, device=device)

    def fwd(seq, msa, mask, msa_mask):
        with torch.no_grad():
            return model(seq, msa, mask=mask, msa_mask=msa_mask)

    return fwd, (seq, msa, mask, msa_mask)


def _build_train_step(device, sparse: bool = False):
    from alphafold2_tpu_torch.train.loop import build_model, init_state, make_train_step

    cfg = _tiny_model_cfg(sparse)
    state = init_state(cfg, build_model(cfg), device=device)
    return make_train_step(state.model), (state, _batch(cfg, device))


def _build_train_grad(device):
    """Forward, distogram loss and backward: everything up to the
    gradients, without the optimizer."""
    from alphafold2_tpu_torch.train.loop import distogram_cross_entropy
    from alphafold2_tpu_torch.utils.structure import get_bucketed_distance_matrix

    cfg = _tiny_model_cfg()
    model = _distogram_model(cfg, device)
    batch = _batch(cfg, device)

    def grad(batch):
        logits = model(batch["seq"], batch.get("msa"), mask=batch["mask"],
                       msa_mask=batch.get("msa_mask"))
        labels = get_bucketed_distance_matrix(batch["coords"], batch["mask"])
        loss = distogram_cross_entropy(logits, labels)
        loss.backward()
        return loss.detach()

    return grad, (batch,)


def _build_serve_fwd(device, dtype=torch.float32, tied=False):
    """The serving forward at the JAX registry's smallest bucket geometry:
    bucket 8, batch 2, MSA depth 2, 8 MDS iterations."""
    from alphafold2_tpu_torch.predict import init_params
    from alphafold2_tpu_torch.train.end2end import End2EndModel

    bucket, batch, depth = 8, 2, 2
    model = End2EndModel(dim=32, depth=1, heads=2, dim_head=16, max_seq_len=3 * bucket,
                         mds_iters=8, msa_tie_row_attn=tied, dtype=dtype)
    model = init_params(model, seed=0).to(device).eval()
    rng = np.random.default_rng(0)
    seq = torch.from_numpy(rng.integers(0, 20, (batch, bucket))).to(device)
    msa = torch.from_numpy(rng.integers(0, 20, (batch, depth, bucket))).to(device)
    mask = torch.ones((batch, bucket), dtype=torch.bool, device=device)
    mask[1, 6:] = False  # a padded slot, as a bucket holds
    msa_mask = mask[:, None].expand(batch, depth, bucket).contiguous()

    def fwd(seq, msa, mask, msa_mask):
        with torch.inference_mode():
            out = model(seq, msa, mask=mask, msa_mask=msa_mask)
        return {"refined": out["refined"], "weights": out["weights"]}

    return fwd, (seq, msa, mask, msa_mask)


def _sharded_serve_model(device, bucket: int, grid: bool):
    from alphafold2_tpu_torch.predict import init_params
    from alphafold2_tpu_torch.train.end2end import End2EndModel

    model = End2EndModel(dim=32, depth=1, heads=2, dim_head=16, max_seq_len=3 * bucket,
                         mds_iters=8, grid_parallel=grid)
    return init_params(model, seed=0).to(device).eval()


def _build_serve_fwd_mesh(device, grid: bool):
    """The serving forward under a mesh over the process group's ranks:
    ``grid`` a ``(dp, spr, spc)`` mesh (spc 2 from 2 ranks, spr 2 from 4,
    the rest dp) at bucket 8, batch 2, as JAX's ``serve_fwd_grid``; else a
    ``(1, sp)`` mesh at bucket 16, batch 1, JAX's ``serve_fwd_long``. MSA
    depth 2, 8 MDS iterations, every rank the same inputs."""
    import torch.distributed as dist

    from alphafold2_tpu_torch.parallel.grid_parallel import make_grid_mesh
    from alphafold2_tpu_torch.parallel.sharding import (
        describe_mesh, make_mesh, pair_layout, use_mesh,
    )

    world = dist.get_world_size()
    if grid:
        bucket, batch = 8, 2
        n_col = 2 if world >= 2 else 1
        n_row = 2 if world >= 4 else 1
        mesh = make_grid_mesh(world // (n_row * n_col), n_row, n_col)
    else:
        bucket, batch = 16, 1
        mesh = make_mesh(1, world)
    depth = 2
    model = _sharded_serve_model(device, bucket, grid)
    rng = np.random.default_rng(0)
    seq = torch.from_numpy(rng.integers(0, 20, (batch, bucket))).to(device)
    msa = torch.from_numpy(rng.integers(0, 20, (batch, depth, bucket))).to(device)
    mask = torch.ones((batch, bucket), dtype=torch.bool, device=device)
    mask[-1, bucket - 2:] = False  # a padded tail, as a bucket holds
    msa_mask = mask[:, None].expand(batch, depth, bucket).contiguous()

    def fwd(seq, msa, mask, msa_mask):
        with torch.inference_mode(), use_mesh(mesh):
            out = model(seq, msa, mask=mask, msa_mask=msa_mask)
        return {"refined": out["refined"], "weights": out["weights"]}

    lay = pair_layout(mesh)
    fwd.mesh_desc, fwd.seq_ranks = describe_mesh(mesh), lay.n_row * lay.n_col
    return fwd, (seq, msa, mask, msa_mask)


def _world_scope(device):
    from alphafold2_tpu_torch.parallel.distributed import local_world

    return local_world(device)


def _build_attn_tied_row(device):
    """The tied-row wrapper (K2 on the card) at a tiny shape."""
    from alphafold2_tpu_torch.ops.cuda.tied_row import tied_row_attention

    b, r, n, h, d = 1, 2, 16, 2, 16
    gen = torch.Generator().manual_seed(0)
    q = torch.randn((b, r, n, h, d), generator=gen).to(device)
    mask = torch.ones((b, n), dtype=torch.bool, device=device)

    def fwd(q, k, v):
        with torch.no_grad():
            return tied_row_attention(q, k, v, q_mask=mask, kv_mask=mask, sm_scale=d**-0.5)

    return fwd, (q, q, q)


def _build_attn_axial(device):
    """The fused attention wrapper, forward and backward through its
    autograd Function (K1 with lse, K3a and K3b on the card)."""
    from alphafold2_tpu_torch.ops.cuda.axial import fused_attention

    b, h, n, d = 1, 2, 16, 16
    gen = torch.Generator().manual_seed(0)
    q = torch.randn((b, h, n, d), generator=gen).to(device).requires_grad_()
    mask = torch.ones((b, n), dtype=torch.bool, device=device)

    def loss(q, k, v):
        out = fused_attention(q, k, v, kv_mask=mask, sm_scale=d**-0.5)
        (out * out).sum().backward()
        return q.grad

    return loss, (q, q, q)


def default_targets() -> list:
    """The audited surface: model forward, train step and gradients (dense
    and block-sparse), serve forward (float32, and bfloat16 with tied MSA
    rows, and sharded on a grid and a 1D mesh), and the attention
    wrappers."""
    return [
        TraceTarget(name="model_fwd", build=_build_model_fwd, hbm_budget_bytes=64 << 20),
        TraceTarget(name="train_step", build=_build_train_step),
        TraceTarget(name="train_grad", build=_build_train_grad),
        TraceTarget(name="serve_fwd", build=_build_serve_fwd, hbm_budget_bytes=64 << 20),
        TraceTarget(name="serve_fwd_bf16",
                    build=lambda device: _build_serve_fwd(device, torch.bfloat16, tied=True),
                    hbm_budget_bytes=64 << 20),
        TraceTarget(name="attn_tied_row", build=_build_attn_tied_row),
        TraceTarget(name="attn_axial", build=_build_attn_axial),
        TraceTarget(name="train_step_sparse",
                    build=lambda device: _build_train_step(device, sparse=True)),
        # JAX's budgets (targets.py:407-428), per device of its 8-device CPU
        # mesh: 1x2x2 for the grid, (1, 8) for the long rung, whose budget
        # is tight on purpose, so a replicated pair state blows through it
        TraceTarget(name="serve_fwd_grid",
                    build=lambda device: _build_serve_fwd_mesh(device, grid=True),
                    hbm_budget_bytes=16 << 20, sharded=True, budget_seq_ranks=4,
                    scope=_world_scope),
        TraceTarget(name="serve_fwd_long",
                    build=lambda device: _build_serve_fwd_mesh(device, grid=False),
                    hbm_budget_bytes=8 << 20, sharded=True, budget_seq_ranks=8,
                    scope=_world_scope),
    ]


def target_by_name(name: str, targets=None) -> TraceTarget:
    targets = targets if targets is not None else default_targets()
    for t in targets:
        if t.name == name:
            return t
    raise KeyError(f"unknown target {name!r}; known: {[t.name for t in targets]}")
