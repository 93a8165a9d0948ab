"""Weighted metric MDS (Guttman iterations) with the mirror fix.

Port of ``alphafold2_tpu/utils/mds.py`` ``mds``, ``_flip_mirrors``,
``mdscaling`` (the mirror fix from mask-picked backbone atoms),
``calc_phis_backbone``, ``mdscaling_backbone`` and the public
``MDScaling``: a fixed trip count with
per-element ``done`` flags (converged elements freeze, co-batched elements
cannot extend or end each other's iterations) and the ``n_eff`` divisor
(the number of positions with any positive weight), so zero-weighted
padding leaves the valid region's solve unchanged (:35-116).

The start coordinates are an explicit ``coords0`` argument. The JAX
package draws them from threefry (``fold_in(key, position)``); those bits
cannot be reproduced here, so parity tests inject the JAX start, and the
port's own start is :func:`position_keyed_init` (the default of
:func:`mdscaling` and :func:`MDScaling`, keyed by their ``seed``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from alphafold2_tpu_torch.utils.metrics import calc_phis, get_dihedral
from alphafold2_tpu_torch.utils.structure import cdist


def position_keyed_init(n: int, seed: int = 0) -> np.ndarray:
    """(n, 3) float32 start coordinates in [-1, 1) whose row i depends only
    on (seed, i): a numpy PCG64 stream drawn row-major, so a longer draw
    extends a shorter one and a residue starts from the same point in every
    bucket shape and batch slot."""
    draw = np.random.default_rng(seed).random((n, 3))
    return (2.0 * draw - 1.0).astype(np.float32)


def mds(
    pre_dist_mat: torch.Tensor,  # (B, N, N) or (N, N)
    coords0: torch.Tensor,  # (B, N, 3) or (N, 3) start coordinates
    weights: Optional[torch.Tensor] = None,
    iters: int = 10,
    tol: float = 1e-5,
):
    """Returns (coords (B, 3, N), stress history (iters, B))."""
    if pre_dist_mat.dim() == 2:
        pre_dist_mat = pre_dist_mat[None]
    batch, n, _ = pre_dist_mat.shape
    dtype, device = pre_dist_mat.dtype, pre_dist_mat.device
    coords = coords0.to(device=device, dtype=dtype).expand(batch, n, 3)
    if weights is None:
        weights = torch.ones_like(pre_dist_mat)
        n_eff = torch.full((batch,), float(n), dtype=dtype, device=device)
    else:
        n_eff = (weights > 0).any(-1).sum(-1).to(dtype).clamp_min(1.0)
    diag = torch.eye(n, dtype=dtype, device=device)
    best = torch.full((batch,), float("inf"), dtype=dtype, device=device)
    done = torch.zeros((batch,), dtype=torch.bool, device=device)
    history = []
    for _ in range(iters):
        dist = cdist(coords, coords)
        stress = 0.5 * (weights * (dist - pre_dist_mat) ** 2).sum(dim=(-1, -2))
        dist = torch.where(dist == 0.0, torch.full_like(dist, 1e-7), dist)
        ratio = weights * (pre_dist_mat / dist)
        bmat = -ratio + diag * ratio.sum(-1, keepdim=True)
        new_coords = (bmat @ coords) / n_eff[:, None, None]
        dis = torch.linalg.norm(new_coords, dim=(-1, -2))
        rel = stress / dis
        done = done | ~((best - rel) > tol)
        coords = torch.where(done[:, None, None], coords, new_coords)
        best = torch.where(done, best, rel)
        history.append(rel)
    return coords.transpose(-1, -2), torch.stack(history)


def _flip_mirrors(preds: torch.Tensor, phi_ratios: torch.Tensor) -> torch.Tensor:
    """Flip the Z axis of batch elements whose negative-phi ratio < 0.5."""
    flip = (phi_ratios < 0.5)[:, None]
    z = torch.where(flip, -preds[:, -1], preds[:, -1])
    return torch.cat([preds[:, :-1], z[:, None]], dim=1)


def _start(pre_dist_mat: torch.Tensor, coords0: Optional[torch.Tensor], seed: int):
    if coords0 is not None:
        return coords0
    return torch.from_numpy(position_keyed_init(pre_dist_mat.shape[-1], seed))


def mdscaling(
    pre_dist_mat: torch.Tensor,
    coords0: Optional[torch.Tensor] = None,
    weights: Optional[torch.Tensor] = None,
    iters: int = 10,
    tol: float = 1e-5,
    fix_mirror: bool = True,
    N_mask=None,
    CA_mask=None,
    C_mask=None,
    seed: int = 0,
):
    """MDS plus the chirality fix from backbone phi angles, the atoms picked
    by boolean masks over the flat stream (``utils.structure.
    scn_backbone_mask``). ``coords0`` defaults to
    ``position_keyed_init(N, seed)``. Returns (coords (B, 3, N), stress
    history)."""
    preds, stresses = mds(pre_dist_mat, _start(pre_dist_mat, coords0, seed),
                          weights=weights, iters=iters, tol=tol)
    if not fix_mirror:
        return preds, stresses
    return _flip_mirrors(preds, calc_phis(preds, N_mask, CA_mask, C_mask, prop=True)), stresses


def calc_phis_backbone(coords: torch.Tensor, prop: bool = True,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Phi angles of an (N, CA, C)-repeating stream (B, 3, 3L); with
    ``prop`` the fraction of negative phis over transitions whose flanking
    residues are both valid under ``mask`` (B, L)."""
    coords = coords.detach().transpose(-1, -2)
    b, flat, _ = coords.shape
    res = coords.reshape(b, flat // 3, 3, 3)
    n, ca, c = res[:, :, 0], res[:, :, 1], res[:, :, 2]
    phis = get_dihedral(c[:, :-1], n[:, 1:], ca[:, 1:], c[:, 1:])
    if not prop:
        return phis
    neg = (phis < 0).float()
    if mask is None:
        return neg.mean(-1)
    valid = (mask[:, :-1] & mask[:, 1:]).float()
    return (neg * valid).sum(-1) / valid.sum(-1).clamp_min(1.0)


def mdscaling_backbone(
    pre_dist_mat: torch.Tensor,
    coords0: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
    iters: int = 10,
    tol: float = 1e-5,
    fix_mirror: bool = True,
    residue_mask: Optional[torch.Tensor] = None,
):
    """MDS plus the per-element chirality fix for backbone streams."""
    preds, stresses = mds(pre_dist_mat, coords0, weights=weights, iters=iters, tol=tol)
    if not fix_mirror:
        return preds, stresses
    phi_ratios = calc_phis_backbone(preds, prop=True, mask=residue_mask)
    return _flip_mirrors(preds, phi_ratios), stresses


def MDScaling(pre_dist_mat, backend: str = "auto", **kwargs):
    """The reference's public entry: (N, N) or (B, N, N) distances ->
    (coords (B, 3, N), stress history), numpy for numpy input; ``kwargs``
    as :func:`mdscaling` takes them. ``backend`` is accepted and ignored."""
    del backend
    numpy_in = not isinstance(pre_dist_mat, torch.Tensor)
    d = torch.as_tensor(np.asarray(pre_dist_mat) if numpy_in else pre_dist_mat)
    if d.dim() == 2:
        d = d[None]
    coords, stresses = mdscaling(d, **kwargs)
    if numpy_in:
        return coords.detach().numpy(), stresses.detach().numpy()
    return coords, stresses
