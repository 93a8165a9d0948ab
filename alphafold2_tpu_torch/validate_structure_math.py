"""Structure-math validation on a realistic chain: Kabsch, RMSD, GDT,
TMscore, the MDS round trip and the PDB round trip.

Port of ``scripts/validate_structure_math.py``, with its checks,
thresholds and output lines, on the port's ``utils/``::

    python -m alphafold2_tpu_torch.validate_structure_math [--pdb FILE]

Without ``--pdb`` a protein-like synthetic chain (``data/pipeline.py
_smooth_walk``, 96 residues, seed 7) is used; with it, the CA trace of a
local PDB file. It runs on the CPU and exits non-zero if any check fails.

The MDS round trip starts where the JAX script's does, from JAX's default
draw (``alphafold2_tpu/utils/mds.py``: 2 * uniform(key(0), (1, N, 3)) - 1),
which :func:`jax_default_start` computes in numpy: SMACOF from a random
start lands in a poor local minimum for some starts (on the synthetic
chain, 3 of 8 draws), so the check holds the port's MDS to JAX's from the
same start, not to another start's luck.
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np

from alphafold2_tpu_torch.utils import GDT, RMSD, Kabsch, MDScaling, TMscore, cdist
from alphafold2_tpu_torch.utils import pdb as pdbio


def load_ca(pdb_path: Optional[str], length: int = 96) -> np.ndarray:
    """The (3, N) CA trace of ``pdb_path``, or of the synthetic chain."""
    if pdb_path is not None:
        seq, ca = pdbio.load_pdb(pdb_path).ca_trace()
        if len(seq) < 4:
            raise SystemExit(f"{pdb_path}: found {len(seq)} CA atoms — not a usable "
                             "protein structure (need >= 4 residues)")
        print(f"loaded {pdb_path}: {len(seq)} residues")
        return ca.T.astype(np.float32)
    from alphafold2_tpu_torch.data.pipeline import _smooth_walk

    ca = _smooth_walk(np.random.default_rng(7), length)
    print(f"synthetic chain: {length} residues")
    return ca.T.astype(np.float32)


def _threefry2x32(key: tuple, x: list) -> list:
    """Threefry-2x32 (20 rounds) of the uint32 counter words ``x`` under
    ``key``, as JAX's ``threefry2x32_p`` computes it."""
    u = np.uint32
    ks = (u(key[0]), u(key[1]), u(key[0]) ^ u(key[1]) ^ u(0x1BD11BDA))
    rotations = ((13, 15, 26, 6), (17, 29, 16, 24))
    x = [x[0] + ks[0], x[1] + ks[1]]
    for i in range(5):
        for r in rotations[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = x[0] ^ ((x[1] << u(r)) | (x[1] >> u(32 - r)))
        x = [x[0] + ks[(i + 1) % 3], x[1] + ks[(i + 2) % 3] + u(i + 1)]
    return x


def jax_default_start(n: int) -> np.ndarray:
    """JAX's MDS start for one (N, N) matrix: 2 * uniform(key(0), (1, n, 3))
    - 1 in float32, the bits of ``jax.random.bits`` with partitionable
    threefry (one 64-bit counter an element, its words hashed and XORed)."""
    idx = np.arange(n * 3, dtype=np.uint64)
    with np.errstate(over="ignore"):
        hi, lo = _threefry2x32((0, 0), [(idx >> np.uint64(32)).astype(np.uint32),
                                        (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)])
    bits = hi ^ lo
    unit = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1)
    return (np.float32(2) * np.maximum(unit, np.float32(0)) - np.float32(1)).reshape(1, n, 3)


def check(name: str, ok: bool, detail: str) -> bool:
    print(f"  [{'ok' if ok else 'FAIL'}] {name}: {detail}")
    return ok


def _scores(a, b) -> tuple:
    return float(RMSD(a, b)[0]), float(TMscore(a, b)[0])


def run_checks(ca: np.ndarray, coords0: Optional[np.ndarray] = None) -> tuple:
    """Every check on the (3, N) trace ``ca``; ``coords0`` (1, N, 3) is
    the MDS start (:func:`jax_default_start` when None). Returns (all
    passed, the metrics by name)."""
    rng = np.random.default_rng(0)
    n = ca.shape[1]
    ok = True
    metrics = {}

    print("rigid-transform recovery:")
    theta = 0.9
    rot = np.array([[np.cos(theta), -np.sin(theta), 0],
                    [np.sin(theta), np.cos(theta), 0],
                    [0, 0, 1.0]], np.float32)
    moved = rot @ ca + np.asarray([[5.0], [-3.0], [2.0]], np.float32)
    r0, tm0 = _scores(*Kabsch(moved, ca))
    metrics.update(kabsch_rmsd=r0, kabsch_tm=tm0)
    ok &= check("kabsch rmsd", r0 < 1e-3, f"rmsd={r0:.2e}")
    ok &= check("kabsch tmscore", tm0 > 0.9999, f"tm={tm0:.6f}")

    print("noise-scale monotonicity:")
    scales = [0.1, 0.5, 1.0, 2.0]
    rmsds, tms, gts, ghs = [], [], [], []
    for s in scales:
        noisy = ca + rng.normal(scale=s, size=ca.shape).astype(np.float32)
        a, b = Kabsch(noisy, ca)
        r, t = _scores(a, b)
        rmsds.append(r)
        tms.append(t)
        gts.append(float(GDT(a, b, mode="TS")[0]))
        ghs.append(float(GDT(a, b, mode="HA")[0]))
    for s, r, t, g, h in zip(scales, rmsds, tms, gts, ghs):
        print(f"    noise={s:>4}: rmsd={r:6.3f} tm={t:.3f} gdt_ts={g:.3f} gdt_ha={h:.3f}")
    metrics.update(noise_rmsd=rmsds, noise_tm=tms, noise_gdt_ts=gts, noise_gdt_ha=ghs)
    ok &= check("rmsd increases", all(np.diff(rmsds) > 0), f"{rmsds}")
    ok &= check("tm decreases", all(np.diff(tms) < 0), f"{tms}")
    ok &= check("gdt_ts decreases", all(np.diff(gts) <= 0), f"{gts}")
    ok &= check("gdt_ha <= gdt_ts", all(h <= g for h, g in zip(ghs, gts)), "")

    print("MDS round-trip from the true distance matrix:")
    import torch

    dist = cdist(torch.from_numpy(ca.T[None]), torch.from_numpy(ca.T[None]))[0].numpy()
    start = jax_default_start(n) if coords0 is None else np.asarray(coords0, np.float32)
    coords3d, stress = MDScaling(dist, iters=200, tol=1e-7, fix_mirror=False,
                                 coords0=torch.from_numpy(start))
    rec = np.asarray(coords3d)[0]  # (3, N)
    best_tm, best_rmsd = -1.0, np.inf
    for cand in (rec, rec * np.asarray([[1.0], [1.0], [-1.0]], np.float32)):
        r, t = _scores(*Kabsch(cand, ca))
        if t > best_tm:
            best_tm, best_rmsd = t, r
    final_stress = float(np.asarray(stress)[-1, 0])
    print(f"    final stress={final_stress:.4f} rmsd={best_rmsd:.3f} tm={best_tm:.3f}")
    metrics.update(mds_stress=final_stress, mds_rmsd=best_rmsd, mds_tm=best_tm)
    ok &= check("mds tmscore", best_tm > 0.8, f"tm={best_tm:.3f}")
    ok &= check("mds rmsd", best_rmsd < 0.25 * n ** 0.5, f"rmsd={best_rmsd:.3f}")

    print("PDB export round-trip:")
    s = pdbio.backbone_to_pdb("A" * n, rec.T)
    _, ca2 = pdbio.parse_pdb(pdbio.to_pdb_string(s)).ca_trace()
    err = float(np.abs(ca2.T - rec).max())
    metrics["pdb_max_err"] = err
    ok &= check("pdb roundtrip", bool(np.allclose(ca2.T, rec, atol=1e-3)), f"max err={err:.2e}")
    return bool(ok), metrics


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Validate the port's structure math.")
    ap.add_argument("--pdb", default=None, help="optional .pdb file to validate on")
    args = ap.parse_args(argv)
    ok, _ = run_checks(load_ca(args.pdb))
    print("ALL OK" if ok else "FAILURES PRESENT")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
