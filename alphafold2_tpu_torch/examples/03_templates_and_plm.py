"""Template conditioning and the PLM-embedding input path.

The port's counterpart of ``examples/03_templates_and_plm.py``: template
sequences and coordinates (with sidechain vectors through the SE(3)
template embedder), and precomputed language-model residue embeddings
(``embedds``) whose projected outer sum stands in for the MSA stream.

Run:  python alphafold2_tpu_torch/examples/03_templates_and_plm.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import torch

from alphafold2_tpu_torch import constants
from alphafold2_tpu_torch.device import resolve_device
from alphafold2_tpu_torch.models import Alphafold2
from alphafold2_tpu_torch.predict import init_params

TINY = os.environ.get("EX_TINY") == "1"
DIM, N, T = (32, 24, 2) if TINY else (64, 64, 2)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    dev = resolve_device(ap.parse_args(argv).device)

    # the template modules are built for up to max_num_templates templates
    model = Alphafold2(dim=DIM, depth=1, heads=2, dim_head=16, max_seq_len=2 * N,
                       max_num_templates=T, template_attn_depth=1)
    init_params(model, 0).to(dev)

    gen = torch.Generator().manual_seed(0)
    seq = torch.randint(0, 21, (1, N), generator=gen).to(dev)
    mask = torch.ones((1, N), dtype=torch.bool, device=dev)
    # templates: aligned sequences and CA coordinates (plus unit sidechain
    # vectors for the SE(3) template embedder); the distogram is bucketed
    # from the coordinates when not given (reference alphafold2.py:508-509)
    t_seq = torch.randint(0, 21, (1, T, N), generator=gen).to(dev)
    t_coors = (torch.randn((1, T, N, 3), generator=gen) * 10).to(dev)
    t_side = torch.randn((1, T, N, 3), generator=gen)
    t_side = (t_side / t_side.norm(dim=-1, keepdim=True)).to(dev)
    t_mask = torch.ones((1, T, N), dtype=torch.bool, device=dev)

    with torch.no_grad():
        out = model(seq, mask=mask, templates_seq=t_seq, templates_coors=t_coors,
                    templates_mask=t_mask, templates_sidechains=t_side)
    print("templated distogram:", tuple(out.shape))

    # the PLM path: residue embeddings in place of an MSA
    plm = Alphafold2(dim=DIM, depth=1, heads=2, dim_head=16, max_seq_len=2 * N,
                     num_embedds=constants.NUM_EMBEDDS_TR)
    init_params(plm, 0).to(dev)
    embedds = torch.randn((1, N, constants.NUM_EMBEDDS_TR), generator=gen).to(dev)
    with torch.no_grad():
        out2 = plm(seq, mask=mask, embedds=embedds)
    print("plm-conditioned distogram:", tuple(out2.shape))
    assert out.shape == out2.shape == (1, N, N, 37)
    assert bool(torch.isfinite(out).all()) and bool(torch.isfinite(out2).all())
    print("ok")


if __name__ == "__main__":
    main()
