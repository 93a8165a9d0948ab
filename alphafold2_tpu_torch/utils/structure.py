"""Structure math: pairwise distances, distogram centering, NeRF, sidechain lift.

Port of ``alphafold2_tpu/utils/structure.py``: :func:`cdist`,
:func:`get_bucketed_distance_matrix` (:55), :func:`center_distogram` (:76),
:func:`nerf` (:162) and :func:`sidechain_container` (:198). Batched tensor
functions, same layouts.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from alphafold2_tpu_torch import constants

# bucket thresholds spanning 2-20 A
DISTANCE_THRESHOLDS = np.linspace(
    constants.DISTOGRAM_MIN_DIST,
    constants.DISTOGRAM_MAX_DIST,
    constants.DISTOGRAM_BUCKETS,
)
_THRESHOLDS_F32 = DISTANCE_THRESHOLDS.astype(np.float32)  # rounded once, on the host


def cdist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(..., N, D), (..., M, D) -> (..., N, M) Euclidean distances, in the
    expanded-difference form (a matrix product), clamped at 0 before the
    square root."""
    x2 = (x * x).sum(-1, keepdim=True)
    y2 = (y * y).sum(-1, keepdim=True)
    sq = x2 - 2.0 * (x @ y.transpose(-1, -2)) + y2.transpose(-1, -2)
    return sq.clamp_min(0.0).sqrt()


def get_bucketed_distance_matrix(
    coords: torch.Tensor,  # (..., N, 3)
    mask: torch.Tensor,  # (..., N) bool
    num_buckets: int = constants.DISTOGRAM_BUCKETS,
    ignore_index: int = -100,
) -> torch.Tensor:
    """Pairwise distances binned into ``num_buckets`` bins over 2-20 A, as
    int64 labels; pairs where either residue is masked get ``ignore_index``.
    A distance equal to a boundary goes to the lower bin (searchsorted
    side="left", which is ``torch.bucketize(right=False)``). The boundaries
    are the float32 rounding of the exact linspace; the JAX package's
    ``jnp.linspace`` differs from them by one ulp at some bins, which moves
    only a distance within that ulp of a boundary."""
    distances = cdist(coords, coords)
    # the exact linspace, rounded once (on the host: the card computes no float64)
    edges = np.linspace(constants.DISTOGRAM_MIN_DIST, constants.DISTOGRAM_MAX_DIST,
                        num_buckets, dtype=np.float64)[:-1].astype(np.float32)
    boundaries = torch.from_numpy(edges).to(device=coords.device, dtype=distances.dtype)
    discretized = torch.bucketize(distances, boundaries, right=False)
    pair_mask = mask[..., :, None] & mask[..., None, :]
    return torch.where(pair_mask, discretized, ignore_index)


def center_distogram(distogram: torch.Tensor, bins: Optional[torch.Tensor] = None):
    """(B, N, N, K) probabilities -> (central distance, confidence weight),
    each (B, N, N): the mean of bin centers (first clamped to 1.5 A, last
    inflated to 1.33x the top threshold), weight 0 past the penultimate
    threshold, zero diagonal, weight = mask / (1 + std), NaN -> 0."""
    if bins is None:
        bins = torch.from_numpy(_THRESHOLDS_F32).to(device=distogram.device,
                                                     dtype=distogram.dtype)
    half_width = 0.5 * (bins[2] - bins[1])
    centers = bins - half_width
    centers = torch.cat([centers.new_tensor([1.5]), centers[1:-1],
                         (1.33 * bins[-1]).reshape(1)])
    central = (distogram * centers).sum(-1)
    mask = (central <= bins[-2]).to(distogram.dtype)
    n = central.shape[-1]
    eye = torch.eye(n, dtype=torch.bool, device=central.device)
    central = central.masked_fill(eye, 0.0)
    dispersion = torch.sqrt((distogram * (centers - central[..., None]) ** 2).sum(-1))
    weights = torch.nan_to_num(mask / (1.0 + dispersion), nan=0.0)
    return central, weights


def nerf(a, b, c, l, theta, chi) -> torch.Tensor:
    """Place atom d from a, b, c (..., 3) with bond length ``l``, angle
    ``theta`` and dihedral ``chi`` (...,). Degenerate frames give finite
    placements (norms clamped at 1e-8)."""
    ba = b - a
    cb = c - b
    n_plane = torch.cross(ba, cb, dim=-1)
    n_plane_ = torch.cross(n_plane, cb, dim=-1)
    rotate = torch.stack([cb, n_plane_, n_plane], dim=-1)
    rotate = rotate / rotate.norm(dim=-2, keepdim=True).clamp_min(1e-8)
    d = torch.stack(
        [-torch.cos(theta), torch.sin(theta) * torch.cos(chi),
         torch.sin(theta) * torch.sin(chi)],
        dim=-1,
    )
    return c + l[..., None] * torch.einsum("...ij,...j->...i", rotate, d)


def sidechain_container(
    backbones: torch.Tensor,
    place_oxygen: bool = False,
    n_atoms: int = constants.NUM_COORDS_PER_RES,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Lift a (B, L*3, 3) N/CA/C backbone to (B, L, 14, 3): slots 0-2 the
    backbone, slot 3 the carbonyl O (NeRF from psi when ``place_oxygen``),
    the rest CA copies. ``mask`` (B, L) gives chain-terminal residues the
    fixed psi 5*pi/4 (no valid next residue)."""
    from alphafold2_tpu_torch.utils.metrics import get_dihedral

    batch, length = backbones.shape[0], backbones.shape[1] // 3
    bb = backbones.reshape(batch, length, 3, 3)
    ca = bb[:, :, 1:2]
    coords = torch.cat([bb, ca.expand(batch, length, n_atoms - 3, 3)], dim=2)
    if place_oxygen:
        n_i, ca_i, c_i = bb[:, :, 0], bb[:, :, 1], bb[:, :, 2]
        n_next = torch.cat([n_i[:, 1:], torch.zeros_like(n_i[:, :1])], dim=1)
        psis = get_dihedral(n_i, ca_i, c_i, n_next)
        no_next = (torch.arange(length, device=bb.device) == length - 1)[None, :]
        if mask is not None:
            next_valid = torch.cat([mask[:, 1:], torch.zeros_like(mask[:, :1])], dim=1)
            no_next = no_next | ~next_valid
        psis = torch.where(no_next, torch.full_like(psis, math.pi * 5 / 4), psis)
        bond_len = torch.full_like(psis, constants.BB_BUILD_INFO["BONDLENS"]["c-o"])
        bond_ang = torch.full_like(psis, constants.BB_BUILD_INFO["BONDANGS"]["ca-c-o"])
        oxygen = nerf(n_i, ca_i, c_i, bond_len, bond_ang, psis - math.pi)
        coords = torch.cat([coords[:, :, :3], oxygen[:, :, None], coords[:, :, 4:]], dim=2)
    return coords
