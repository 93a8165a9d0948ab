"""Distogram -> 3D coordinates -> quality metrics.

The port's counterpart of ``examples/04_structure_realization.py``: softmax
the distogram, center it into distances and confidence weights, weighted
MDS into coordinates with the chirality fix, then Kabsch-align and score
(RMSD, TMscore).

Run:  python alphafold2_tpu_torch/examples/04_structure_realization.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import torch

from alphafold2_tpu_torch.device import resolve_device
from alphafold2_tpu_torch.predict import realize_structure
from alphafold2_tpu_torch.utils import RMSD, Kabsch, TMscore, get_bucketed_distance_matrix

TINY = os.environ.get("EX_TINY") == "1"
L = 16 if TINY else 48  # residues; the realization runs on 3L backbone atoms


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    dev = resolve_device(ap.parse_args(argv).device)

    # a synthetic "ground truth" backbone chain (3 atoms a residue)
    gen = torch.Generator().manual_seed(1)
    steps = torch.randn((1, 3 * L, 3), generator=gen)
    true = torch.cumsum(1.2 * steps / steps.norm(dim=-1, keepdim=True), dim=1).to(dev)

    # a perfect distogram for it: one-hot bucketed true distances (a
    # stand-in for the model's output, so the example is self-contained)
    mask = torch.ones((1, 3 * L), dtype=torch.bool, device=dev)
    buckets = get_bucketed_distance_matrix(true, mask)
    logits = 10.0 * torch.nn.functional.one_hot(buckets.clamp_min(0), 37).float()

    coords, distances, weights = realize_structure(logits, iters=50 if TINY else 200, mask=mask,
                                                   seed=2)
    print("realized coords:", tuple(coords.shape))  # (1, 3, 3L)

    aligned, target = Kabsch(coords, true.transpose(-1, -2))
    print("RMSD after alignment:", float(RMSD(aligned, target)[0]))
    print("TM-score:", float(TMscore(aligned, target)[0]))
    assert bool(torch.isfinite(aligned).all())
    print("ok")


if __name__ == "__main__":
    main()
