"""Backbone relaxation: Adam on a simple differentiable backbone energy.

Port of ``alphafold2_tpu/utils/relax.py``. The energy (:func:`backbone_energy`)
has three masked, batched terms:

- harmonic bonds between consecutive backbone atoms at the ideal N-CA
  (1.458 A), CA-C (1.525 A) and C-N' (1.329 A) lengths, counted only where
  the reference geometry is within 1 A of ideal, so chain breaks are not
  pulled shut;
- a soft-sphere clash penalty between atoms more than two apart in the
  stream and closer than ``clash_dist``; above 1536 atoms it runs in
  512-row chunks (peak extra memory O(B * 512 * L3)), as JAX's ``lax.map``
  does;
- a harmonic restraint to the input coordinates.

:func:`fast_relax` minimizes it for a fixed number of iterations with Adam
written out as optax's ``adam(lr, eps_root=1e-8)``: ``m/(1-b1^t)`` over
``sqrt(v/(1-b2^t) + eps_root) + eps`` (``torch.optim.Adam`` has no
``eps_root``, which keeps the derivative through ``sqrt(v)`` finite where a
gradient component is 0). Masked atoms snap back to the input after each
step. Where ``backbone`` requires grad the iterations stay in the autograd
graph (``create_graph``), so the result is differentiable with respect to
it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

IDEAL_BONDS = (1.458, 1.525, 1.329)  # N-CA, CA-C, C-N' (Angstrom)
DENSE_CLASH_ATOMS = 1536  # above this the clash rows run in chunks
CLASH_CHUNK = 512
ADAM_B1, ADAM_B2, ADAM_EPS, ADAM_EPS_ROOT = 0.9, 0.999, 1e-8, 1e-8


class RelaxResult(NamedTuple):
    coords: torch.Tensor  # (B, L3, 3) relaxed backbone
    energy: torch.Tensor  # (B,) final energy
    energy_history: torch.Tensor  # (iters, B) energy before each step


def _clash_rows(rows, frows, iglob, all_coords, fall, jidx, clash_dist):
    d = torch.sqrt(((rows[:, :, None, :] - all_coords[:, None, :, :]) ** 2).sum(-1) + 1e-12)
    nb = ((iglob[:, None] - jidx[None, :]).abs() > 2)[None]
    pm = frows[:, :, None] * fall[:, None, :] * nb
    return (pm * torch.clamp(clash_dist - d, min=0.0) ** 2).sum((-1, -2))


def backbone_energy(
    coords: torch.Tensor,  # (B, L3, 3) N/CA/C interleaved
    ref_coords: torch.Tensor,
    mask: Optional[torch.Tensor] = None,  # (B, L3) bool
    clash_dist: float = 2.8,
    bond_weight: float = 1.0,
    clash_weight: float = 0.5,
    restraint_weight: float = 0.02,
) -> torch.Tensor:
    """Per-batch-element scalar energy (B,); differentiable everywhere."""
    b, l3, _ = coords.shape
    dev = coords.device
    fm = (torch.ones((b, l3), device=dev) if mask is None else mask.float())
    lengths = torch.sqrt(((coords[:, 1:] - coords[:, :-1]) ** 2).sum(-1) + 1e-12)
    ideal = torch.tensor(IDEAL_BONDS, dtype=torch.float32, device=dev).repeat(
        l3 // 3 + 1)[: l3 - 1]
    ref_lengths = torch.sqrt(((ref_coords[:, 1:] - ref_coords[:, :-1]) ** 2).sum(-1) + 1e-12)
    is_bond = ((ref_lengths - ideal).abs() < 1.0).float()
    pair_m = fm[:, 1:] * fm[:, :-1] * is_bond
    e_bond = (pair_m * (lengths - ideal) ** 2).sum(-1)

    jidx = torch.arange(l3, device=dev)
    if l3 <= DENSE_CLASH_ATOMS:
        e_clash = _clash_rows(coords, fm, jidx, coords, fm, jidx, clash_dist) / 2
    else:
        e_clash = sum(
            _clash_rows(coords[:, s:s + CLASH_CHUNK], fm[:, s:s + CLASH_CHUNK],
                        jidx[s:s + CLASH_CHUNK], coords, fm, jidx, clash_dist)
            for s in range(0, l3, CLASH_CHUNK)) / 2

    e_rest = (fm * ((coords - ref_coords) ** 2).sum(-1)).sum(-1)
    return bond_weight * e_bond + clash_weight * e_clash + restraint_weight * e_rest


def fast_relax(
    backbone: torch.Tensor,  # (B, L3, 3)
    mask: Optional[torch.Tensor] = None,  # (B, L3) bool
    iters: int = 200,
    lr: float = 2e-2,
    **energy_kw,
) -> RelaxResult:
    """Minimize :func:`backbone_energy` with Adam (module docstring) for a
    fixed ``iters``, restrained to ``backbone``."""
    backbone = backbone.float()
    ref = backbone.detach()
    graph = backbone.requires_grad and torch.is_grad_enabled()
    coords = backbone if graph else ref
    m = torch.zeros_like(ref)
    v = torch.zeros_like(ref)
    history = []
    for t in range(1, iters + 1):
        c = coords if graph else coords.detach().requires_grad_()
        with torch.enable_grad():
            energy = backbone_energy(c, ref, mask=mask, **energy_kw)
            (g,) = torch.autograd.grad(energy.sum(), c, create_graph=graph)
        history.append(energy.detach())
        m = ADAM_B1 * m + (1 - ADAM_B1) * g
        v = ADAM_B2 * v + (1 - ADAM_B2) * g * g
        m_hat = m / (1 - ADAM_B1**t)
        v_hat = v / (1 - ADAM_B2**t)
        coords = c - lr * m_hat / (torch.sqrt(v_hat + ADAM_EPS_ROOT) + ADAM_EPS)
        if mask is not None:
            coords = torch.where(mask[..., None], coords, ref)
        if not graph:
            coords = coords.detach()
    with torch.set_grad_enabled(graph):
        energy = backbone_energy(coords, ref, mask=mask, **energy_kw)
    return RelaxResult(coords=coords, energy=energy,
                       energy_history=torch.stack(history) if history
                       else torch.zeros((0, backbone.shape[0])))
