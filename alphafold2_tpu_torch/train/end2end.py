"""The end-to-end structure model's forward pass.

Port of ``alphafold2_tpu/train/end2end.py`` ``elongate`` and the forward of
``End2EndModel`` (:81-148): residues elongate x3 into (N, CA, C) tokens,
the Alphafold2 trunk predicts a distogram over the 3L x 3L atom grid,
``realize_structure`` turns it into coordinates (softmax, centering,
weighted MDS with the mirror fix), ``sidechain_container`` lifts the
backbone to atom14 (padded residues parked at the origin, :120-126), and
the SE(3) refiner moves the atoms. Losses and training steps are not
ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from alphafold2_tpu_torch import constants
from alphafold2_tpu_torch.models.alphafold2 import Alphafold2
from alphafold2_tpu_torch.models.se3 import SE3Refiner
from alphafold2_tpu_torch.utils.structure import sidechain_container


def elongate(seq: torch.Tensor, mask: torch.Tensor):
    """(B, L) residue tokens and mask -> (B, 3L) atom-level stream."""
    return (seq.repeat_interleave(3, dim=1), mask.repeat_interleave(3, dim=1))


class End2EndModel(nn.Module):
    """Alphafold2 trunk + structure realization + SE(3) refiner.

    Submodules are ``af2`` and ``refiner``, the flax names. ``mds_seed``
    keys the position-keyed MDS start (utils/mds.py) when no ``coords0`` is
    passed to :meth:`forward`."""

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
        **engine_flags,
    ):
        super().__init__()
        self.mds_iters = mds_iters
        self.mds_seed = mds_seed
        self.af2 = Alphafold2(
            dim=dim, max_seq_len=max_seq_len, depth=depth, heads=heads,
            dim_head=dim_head, msa_tie_row_attn=msa_tie_row_attn, dtype=dtype,
            **engine_flags,
        )
        self.refiner = SE3Refiner(
            dim=64, depth=refiner_depth,
            num_tokens=constants.NUM_COORDS_PER_RES, dtype=dtype,
        )

    def forward(self, seq, msa=None, mask=None, msa_mask=None,
                coords0: Optional[torch.Tensor] = None) -> dict:
        from alphafold2_tpu_torch.predict import realize_structure

        b, l = seq.shape
        if mask is None:
            mask = torch.ones((b, l), dtype=torch.bool, device=seq.device)
        seq3, mask3 = elongate(seq, mask)
        logits = self.af2(seq3, msa, mask=mask3, msa_mask=msa_mask)
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
