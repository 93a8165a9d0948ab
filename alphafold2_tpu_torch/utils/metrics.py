"""Dihedrals, Kabsch alignment and RMSD.

Port of ``alphafold2_tpu/utils/metrics.py`` ``get_dihedral``, ``kabsch``
and ``rmsd``; coordinates are (..., 3, N) as there.
"""

from __future__ import annotations

import torch


def get_dihedral(c1, c2, c3, c4) -> torch.Tensor:
    """Dihedral angle (radians) of four points (..., 3) -> (...,)."""
    u1 = c2 - c1
    u2 = c3 - c2
    u3 = c4 - c3
    u23 = torch.cross(u2, u3, dim=-1)
    y = (u2.norm(dim=-1, keepdim=True) * u1 * u23).sum(-1)
    x = (torch.cross(u1, u2, dim=-1) * u23).sum(-1)
    return torch.atan2(y, x)


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
