"""Inference: sequence (+ synthesized MSA) -> distogram -> 3D structure.

Port of ``alphafold2_tpu/predict.py``: :func:`realize_structure`,
:func:`encode_sequence`, :func:`synthesize_msa`, :class:`Prediction` and
:func:`predict`, which runs on the CUDA card unless the caller passes
``device="cpu"``; and :func:`main`, the command line of JAX's
``scripts/predict.py``::

    python -m alphafold2_tpu_torch.predict --seq MKTAYIAKQRQISFVKSHFSRQLEERLGLIEVQ \
        [--checkpoint ckpt_dir] [--out pred.pdb] [--seed 0] [--device cpu] \
        [model.dim=256 serve.kernels=axial=stock ...]

It runs the whole path (elongation, the trunk, the distogram, MDS, the
sidechains, the SE(3) refiner), writes the N/CA/C backbone as a PDB file
and prints one summary line. Without ``--checkpoint`` the weights are
random (from ``train.seed``). The kernel policy is ``serve.kernels`` when
given, else ``AF2TPU_KERNELS`` (``ops/kernels.py``).
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from alphafold2_tpu_torch import constants
from alphafold2_tpu_torch.config import Config, parse_cli
from alphafold2_tpu_torch.device import resolve_device
from alphafold2_tpu_torch.utils import pdb as pdbio
from alphafold2_tpu_torch.utils.mds import mdscaling_backbone, position_keyed_init
from alphafold2_tpu_torch.utils.structure import center_distogram


def realize_structure(
    logits: torch.Tensor,  # (B, N, N, K) distogram logits
    iters: int = 200,
    fix_mirror: bool = True,
    mask: Optional[torch.Tensor] = None,  # (B, N) bool token validity
    coords0: Optional[torch.Tensor] = None,  # (B, N, 3) or (N, 3) MDS start
    seed: int = 0,
):
    """Distogram logits -> (coords (B, 3, N), distances, weights): softmax,
    centering, MDS weights zeroed on pairs touching padding, weighted MDS
    and (for (N, CA, C) streams) the chirality fix over valid residues.
    Without ``coords0`` the MDS starts from :func:`position_keyed_init`."""
    b, n = logits.shape[:2]
    probs = torch.softmax(logits.float(), dim=-1)
    distances, weights = center_distogram(probs)
    residue_mask = None
    if mask is not None:
        weights = weights * (mask[:, :, None] & mask[:, None, :]).to(weights.dtype)
        if fix_mirror:
            residue_mask = mask.reshape(b, n // 3, 3).any(-1)
    if coords0 is None:
        coords0 = torch.from_numpy(position_keyed_init(n, seed))
    coords, _ = mdscaling_backbone(
        distances, coords0.to(distances.device), weights=weights, iters=iters,
        fix_mirror=fix_mirror, residue_mask=residue_mask,
    )
    return coords, distances, weights


@dataclasses.dataclass
class Prediction:
    atom14: np.ndarray  # (L, 14, 3) refined all-atom coordinates
    backbone: np.ndarray  # (L, 3, 3) N/CA/C
    weights: np.ndarray  # (3L, 3L) distogram confidence
    distogram: np.ndarray  # (3L, 3L, K) logits

    def to_pdb(self, seq: str, chain: str = "A") -> pdbio.PDBStructure:
        return pdbio.backbone_to_pdb(seq, self.backbone, chain=chain)


def encode_sequence(seq: str) -> np.ndarray:
    """One-letter AA string -> (1, L) int tokens (AA_ALPHABET order)."""
    idx = {a: i for i, a in enumerate(constants.AA_ALPHABET)}
    return np.asarray([[idx.get(c.upper(), constants.AA_PAD_INDEX) for c in seq]],
                      np.int32)


def synthesize_msa(seq_tokens: np.ndarray, depth: int, seed: int = 0,
                   rate: float = 0.15) -> np.ndarray:
    """Mutate the primary sequence into a stand-in MSA (B, depth, L)."""
    rng = np.random.default_rng(seed)
    b, l = seq_tokens.shape
    msa = np.repeat(seq_tokens[:, None], depth, axis=1)
    mut = rng.random((b, depth, l)) < rate
    msa[mut] = rng.integers(0, 20, size=int(mut.sum()))
    return msa


def build_model(cfg: Config, mds_iters: int = 200, mds_seed: Optional[int] = None,
                remat_policy: Optional[str] = None, reversible: bool = False,
                num_embedds: Optional[int] = None):
    """The End2EndModel a config describes (compute dtype bf16 when
    ``model.bfloat16``), with parameters on the CPU in float32. It takes
    the fields JAX's ``predict`` (``alphafold2_tpu/predict.py:137-143``)
    and ``ServeEngine`` (``serve/engine.py:306-315``) pass, ``remat`` among
    them: ``gelu_exact``, ``sparse_self_attn``, ``remat_policy``,
    ``reversible`` and ``scan_layers`` are training options that serving
    ignores there and here, so a reversible config serves the default
    trunk; end-to-end training passes its ``remat_policy``, ``reversible``
    and, for a PLM stream, ``num_embedds`` (the ``embedds`` width).
    ``msa_row_shard``, ``grid_parallel`` and ``context_parallel`` reach the
    trunk, as JAX's ``train_end2end`` passes them: on one device they apply
    nothing, and the reversible engine refuses them. ``End2EndModel`` has
    no field for ``cross_attn_compress_ratio``, in JAX as here, so it is not
    applied. ``mds_seed`` keys the MDS start (default ``cfg.train.seed``,
    as the serving engines key it)."""
    from alphafold2_tpu_torch.train.end2end import End2EndModel

    m = cfg.model
    return End2EndModel(
        dim=m.dim, depth=m.depth, heads=m.heads, dim_head=m.dim_head,
        max_seq_len=m.max_seq_len, mds_iters=mds_iters,
        msa_tie_row_attn=m.msa_tie_row_attn,
        mds_seed=cfg.train.seed if mds_seed is None else mds_seed,
        dtype=torch.bfloat16 if m.bfloat16 else torch.float32, remat=m.remat,
        remat_policy=remat_policy, reversible=reversible, msa_row_shard=m.msa_row_shard,
        grid_parallel=m.grid_parallel, context_parallel=m.context_parallel,
        num_embedds=num_embedds,
    )


def init_params(model: torch.nn.Module, seed: int = 0) -> torch.nn.Module:
    """Random weights from a seeded ``torch.Generator``, at flax's scales:
    dense kernels N(0, 1/fan_in), the KV compression's conv kernel
    N(0, 1/fan_in) with fan_in its ratio times in/groups, embeddings
    N(0, 1/dim), biases 0, LayerNorm scale 1, the templates' raw
    ``sidechain_proj`` N(0, 1) (the model's weights stay float32). A
    depth-stacked kernel (the scanned and reversible trunks) gets that
    scale in every depth slice: its fan_in is the layer's."""
    from alphafold2_tpu_torch.models.se3 import SE3TemplateEmbedder
    from alphafold2_tpu_torch.ops.layers import Dense, LayerNorm

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, Dense):
                std = mod.in_features ** -0.5
                mod.weight.copy_(torch.randn(mod.weight.shape, generator=gen) * std)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, torch.nn.Conv1d):
                fan_in = mod.in_channels // mod.groups * mod.kernel_size[0]
                mod.weight.copy_(torch.randn(mod.weight.shape, generator=gen) * fan_in**-0.5)
                mod.bias.zero_()
            elif isinstance(mod, torch.nn.Embedding):
                std = mod.embedding_dim ** -0.5
                mod.weight.copy_(torch.randn(mod.weight.shape, generator=gen) * std)
            elif isinstance(mod, LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            elif isinstance(mod, SE3TemplateEmbedder):
                mod.sidechain_proj.copy_(torch.randn(mod.sidechain_proj.shape, generator=gen))
    return model


def predict(
    cfg: Config,
    seq: str,
    state_dict: Optional[dict] = None,
    msa_depth: Optional[int] = None,
    seed: int = 0,
    device: Optional[Union[str, torch.device]] = None,
    checkpoint_dir: Optional[str] = None,
) -> Prediction:
    """Full prediction on the end-to-end model: random weights from
    ``cfg.train.seed`` unless a ``state_dict`` (convert.py) or a
    ``checkpoint_dir`` (the latest checkpoint's parameters, whatever the
    optimizer of the run that wrote it) is given, not both. ``seed``
    drives the synthesized MSA and keys the MDS start, as JAX's
    ``mds_key=jax.random.key(seed)`` does. Runs on the CUDA card unless
    ``device="cpu"``."""
    if state_dict is not None and checkpoint_dir:
        raise ValueError("pass state_dict or checkpoint_dir, not both")
    dev = resolve_device(device)
    L = len(seq)
    if 3 * L > cfg.model.max_seq_len:
        raise ValueError(
            f"sequence of {L} residues needs 3L={3 * L} positions but "
            f"model.max_seq_len={cfg.model.max_seq_len}"
        )
    depth = msa_depth if msa_depth is not None else cfg.data.msa_depth
    if depth > constants.MAX_NUM_MSA:
        raise ValueError(f"msa_depth={depth} exceeds MAX_NUM_MSA={constants.MAX_NUM_MSA}")
    model = build_model(cfg, mds_seed=seed)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    elif checkpoint_dir:
        from alphafold2_tpu_torch.train.checkpoint import CheckpointManager

        CheckpointManager(checkpoint_dir).restore_params(model)
    else:
        init_params(model, cfg.train.seed)
    model = model.to(dev).eval()
    tokens = encode_sequence(seq)
    msa = synthesize_msa(tokens, depth, seed=seed)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    with torch.inference_mode():
        out = model(
            t(tokens).long(), t(msa).long(), mask=t(np.ones((1, L), bool)),
            msa_mask=t(np.ones((1, depth, L), bool)),
        )
    atom14 = out["refined"][0].float().cpu().numpy()
    return Prediction(
        atom14=atom14,
        backbone=atom14[:, :3],
        weights=out["weights"][0].float().cpu().numpy(),
        distogram=out["distogram"][0].float().cpu().numpy(),
    )


def main(argv=None) -> int:
    """``python -m alphafold2_tpu_torch.predict``: JAX's arguments
    (``scripts/predict.py:25-31``) and ``--device``; prints JAX's line."""
    from alphafold2_tpu_torch.ops.kernels import parse_policy, use_kernel_policy

    ap = argparse.ArgumentParser(prog="python -m alphafold2_tpu_torch.predict",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--seq", required=True, help="one-letter AA sequence")
    ap.add_argument("--checkpoint", default=None, help="training checkpoint dir")
    ap.add_argument("--out", default="prediction.pdb")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cpu or cuda (default: the card)")
    ap.add_argument("overrides", nargs="*", help="config overrides section.field=value")
    args = ap.parse_args(argv)
    cfg = parse_cli(args.overrides, Config())
    policy = parse_policy(cfg.serve.kernels) if cfg.serve.kernels else None
    with use_kernel_policy(policy):
        pred = predict(cfg, args.seq, checkpoint_dir=args.checkpoint, seed=args.seed,
                       device=args.device)
    pdbio.save_pdb(pred.to_pdb(args.seq), args.out)
    ca = pred.backbone[:, 1]
    d = np.linalg.norm(ca[1:] - ca[:-1], axis=-1)
    print(f"wrote {args.out}: {len(args.seq)} residues, "
          f"mean consecutive CA-CA distance {d.mean():.2f} A, "
          f"mean confidence weight {pred.weights.mean():.3f}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
