"""Alignment and structure-quality metrics: dihedrals, Kabsch, RMSD, GDT,
TM-score and lDDT.

Port of ``alphafold2_tpu/utils/metrics.py``: :func:`get_dihedral`,
:func:`calc_phis`, :func:`kabsch`, :func:`rmsd`, :func:`gdt`,
:func:`tmscore`, :func:`lddt` and :func:`distogram_lddt` (BASELINE.md's
quality bar), and the public wrappers :func:`Kabsch`, :func:`RMSD`,
:func:`GDT` and :func:`TMscore`, which take (3, N) or (B, 3, N) and give
numpy for numpy input and tensors for tensors. Coordinates are (..., 3, N)
as there, lDDT's (..., N, 3). The SVD inside Kabsch runs on a detached
covariance, so gradients flow through everything but the rotation.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

GDT_TS_CUTOFFS = (1.0, 2.0, 4.0, 8.0)
GDT_HA_CUTOFFS = (0.5, 1.0, 2.0, 4.0)


def get_dihedral(c1, c2, c3, c4) -> torch.Tensor:
    """Dihedral angle (radians) of four points (..., 3) -> (...,)."""
    u1 = c2 - c1
    u2 = c3 - c2
    u3 = c4 - c3
    u23 = torch.cross(u2, u3, dim=-1)
    y = (u2.norm(dim=-1, keepdim=True) * u1 * u23).sum(-1)
    x = (torch.cross(u1, u2, dim=-1) * u23).sum(-1)
    return torch.atan2(y, x)


def calc_phis(pred_coords: torch.Tensor, N_mask, CA_mask, C_mask=None,
              prop: bool = True) -> torch.Tensor:
    """Backbone phi angles of (B, 3, L_atoms) coordinates, the atoms picked
    by boolean (L_atoms,) masks over the flat stream (C: the rest, unless
    ``C_mask``); with ``prop`` the fraction of negative phis per batch
    element. Computed on detached coordinates."""
    coords = pred_coords.detach().transpose(-1, -2)  # (B, L, 3)
    as_mask = lambda m: torch.as_tensor(m, device=coords.device).reshape(-1).bool()
    n_mask, ca_mask = as_mask(N_mask), as_mask(CA_mask)
    n_terms, c_alphas = coords[:, n_mask], coords[:, ca_mask]
    c_terms = coords[:, as_mask(C_mask) if C_mask is not None else ~(n_mask | ca_mask)]
    phis = get_dihedral(c_terms[:, :-1], n_terms[:, 1:], c_alphas[:, 1:], c_terms[:, 1:])
    if prop:
        return (phis < 0).float().mean(-1)
    return phis


def kabsch(X: torch.Tensor, Y: torch.Tensor):
    """Kabsch-align X onto Y, both (..., 3, N). Returns (X_aligned,
    Y_centered); the rotation is a proper one (determinant sign fixed)."""
    Xc = X - X.mean(dim=-1, keepdim=True)
    Yc = Y - Y.mean(dim=-1, keepdim=True)
    C = torch.einsum("...dn,...en->...de", Xc, Yc)
    U, _, Vt = torch.linalg.svd(C.detach())
    flip = (torch.linalg.det(U) * torch.linalg.det(Vt) < 0.0)[..., None, None]
    U = torch.cat([U[..., :-1], torch.where(flip, -U[..., -1:], U[..., -1:])], dim=-1)
    R = U @ Vt
    X_aligned = torch.einsum("...nd,...de->...en", Xc.transpose(-1, -2), R)
    return X_aligned, Yc


def rmsd(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """RMSD over (..., D, N) -> (...,)."""
    return torch.sqrt(((X - Y) ** 2).mean(dim=(-1, -2)))


def gdt(X: torch.Tensor, Y: torch.Tensor, cutoffs, weights=None) -> torch.Tensor:
    """GDT over (..., D, N) -> (...,): the weighted mean over ``cutoffs`` of
    the fraction of points within each."""
    cutoffs = torch.as_tensor(cutoffs, dtype=X.dtype, device=X.device)
    weights = (torch.ones_like(cutoffs) if weights is None
               else torch.as_tensor(weights, dtype=X.dtype, device=X.device))
    dist = ((X - Y) ** 2).sum(-2).sqrt()  # (..., N)
    frac = (dist[..., None, :] <= cutoffs[:, None]).to(X.dtype).mean(-1)  # (..., K)
    return (frac * weights).mean(-1)


def tmscore(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """TM-score over (..., D, N) -> (...,); d0 = 1.24*cbrt(L-15) - 1.8."""
    d0 = 1.24 * np.cbrt(max(X.shape[-1] - 15, 0.1)) - 1.8
    dist = ((X - Y) ** 2).sum(-2).sqrt()
    return (1.0 / (1.0 + (dist / d0) ** 2)).mean(-1)


def _lddt_from_distances(d_pred: torch.Tensor, d_true: torch.Tensor,
                         mask: Optional[torch.Tensor], cutoff: float, thresholds,
                         exclude_neighbors: int = 0) -> torch.Tensor:
    """lDDT's scoring over (..., N, N) predicted and true distances."""
    n = d_true.shape[-1]
    idx = torch.arange(n, device=d_true.device)
    incl = (d_true < cutoff) & (idx[:, None] != idx[None, :])
    if exclude_neighbors > 0:
        incl = incl & ((idx[:, None] - idx[None, :]).abs() > exclude_neighbors)
    if mask is not None:
        incl = incl & mask[..., :, None] & mask[..., None, :]
    delta = (d_true - d_pred).abs()
    th = torch.as_tensor(thresholds, dtype=delta.dtype, device=delta.device)
    ok = (delta[..., None] < th).to(delta.dtype).mean(-1)
    inclf = incl.to(delta.dtype)
    return (ok * inclf).sum((-1, -2)) / inclf.sum((-1, -2)).clamp_min(1.0)


def lddt(pred_coords: torch.Tensor, true_coords: torch.Tensor,
         mask: Optional[torch.Tensor] = None, cutoff: float = 15.0,
         thresholds=(0.5, 1.0, 2.0, 4.0), exclude_neighbors: int = 0) -> torch.Tensor:
    """Local Distance Difference Test of (..., N, 3) CA coordinates ->
    (...,) in [0, 1]: over the pairs within ``cutoff`` in the true
    structure, the fraction whose predicted distance is off by less than
    each threshold, averaged over the thresholds."""
    from alphafold2_tpu_torch.utils.structure import cdist

    return _lddt_from_distances(cdist(pred_coords, pred_coords),
                                cdist(true_coords, true_coords), mask, cutoff, thresholds,
                                exclude_neighbors)


def distogram_lddt(logits: torch.Tensor, true_coords: torch.Tensor,
                   mask: Optional[torch.Tensor] = None, cutoff: float = 15.0,
                   thresholds=(0.5, 1.0, 2.0, 4.0)) -> torch.Tensor:
    """lDDT of the distogram's expected distances (probability-weighted
    bin centers of the (..., N, N, K) logits) against the true (..., N, 3)
    geometry, with no realization: BASELINE.md's metric."""
    from alphafold2_tpu_torch.utils.structure import cdist, center_distogram

    d_pred, _ = center_distogram(torch.softmax(logits.float(), dim=-1))
    return _lddt_from_distances(d_pred, cdist(true_coords, true_coords), mask, cutoff,
                                thresholds)


# Public wrappers: (D, N) or (B, D, N), numpy in numpy out, tensors in tensors out.


def _normalize_pair(A, B, dim_len):
    """(A, B) as tensors with ``dim_len`` dims, and whether to give numpy back."""
    numpy_in = not isinstance(A, torch.Tensor)
    A, B = torch.as_tensor(np.asarray(A) if numpy_in else A), torch.as_tensor(B)
    if A.dim() != B.dim():
        raise ValueError(f"shapes of A ({tuple(A.shape)}) and B ({tuple(B.shape)}) must match")
    expand = lambda t: t.reshape((1,) * (dim_len - t.dim()) + tuple(t.shape))
    return expand(A), expand(B), numpy_in


def _out(t, numpy_in):
    return t.detach().cpu().numpy() if numpy_in else t


def Kabsch(A, B, backend: str = "auto"):
    """Kabsch-rotate A into B; inputs (3, N) or (B, 3, N)."""
    del backend
    A, B, numpy_in = _normalize_pair(A, B, 3)
    X, Y = kabsch(A, B)
    if X.shape[0] == 1:
        X, Y = X[0], Y[0]
    return _out(X, numpy_in), _out(Y, numpy_in)


def RMSD(A, B, backend: str = "auto"):
    del backend
    A, B, numpy_in = _normalize_pair(A, B, 3)
    return _out(rmsd(A, B), numpy_in)


def GDT(A, B, mode: str = "TS", weights=None, backend: str = "auto"):
    del backend
    A, B, numpy_in = _normalize_pair(A, B, 3)
    cutoffs = GDT_HA_CUTOFFS if mode.lower() == "ha" else GDT_TS_CUTOFFS
    return _out(gdt(A, B, cutoffs, weights=weights), numpy_in)


def TMscore(A, B, backend: str = "auto"):
    del backend
    A, B, numpy_in = _normalize_pair(A, B, 3)
    return _out(tmscore(A, B), numpy_in)
