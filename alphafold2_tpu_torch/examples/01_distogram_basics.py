"""Basic usage: sequence + MSA -> distogram.

The port's counterpart of ``examples/01_distogram_basics.py`` (the
reference README's quick start: Alphafold2(dim=256, depth=2, heads=8,
dim_head=64), a 128-residue sequence with a 5x64 MSA -> a (1, 128, 128, 37)
distogram), on the hand-written Hopper kernels.

Run:  python alphafold2_tpu_torch/examples/01_distogram_basics.py [--device cpu]
(EX_TINY=1 shrinks the dims for a fast smoke run.)
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import torch

from alphafold2_tpu_torch.device import resolve_device
from alphafold2_tpu_torch.models import Alphafold2
from alphafold2_tpu_torch.predict import init_params

TINY = os.environ.get("EX_TINY") == "1"
DIM, N, M, NM = (32, 32, 2, 16) if TINY else (256, 128, 5, 64)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    dev = resolve_device(ap.parse_args(argv).device)

    model = Alphafold2(dim=DIM, depth=2, heads=2 if TINY else 8,
                       dim_head=16 if TINY else 64, max_seq_len=2 * N)
    init_params(model, 0).to(dev)

    gen = torch.Generator().manual_seed(0)
    seq = torch.randint(0, 21, (1, N), generator=gen).to(dev)
    msa = torch.randint(0, 21, (1, M, NM), generator=gen).to(dev)
    mask = torch.ones((1, N), dtype=torch.bool, device=dev)
    msa_mask = torch.ones((1, M, NM), dtype=torch.bool, device=dev)

    with torch.no_grad():
        distogram = model(seq, msa, mask=mask, msa_mask=msa_mask)

    print("distogram:", tuple(distogram.shape))  # (1, N, N, 37)
    assert distogram.shape == (1, N, N, 37)
    assert bool(torch.isfinite(distogram).all())
    print("ok")


if __name__ == "__main__":
    main()
