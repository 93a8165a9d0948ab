"""Long-context and memory levers, composed in one model.

The port's counterpart of ``examples/02_memory_scaling.py``. The reference
scales one GPU with four mechanisms (sparse attention, KV-compressed
cross-attention, tied-row MSA attention, a reversible trunk); the port keeps
all four on hand-written Hopper kernels (block-sparse K4/K5, the fused
K1/K3, the tied-row K2) and adds rematerialization with checkpoint policies
and mesh sharding (see 05_distributed_training.py).

Run:  python alphafold2_tpu_torch/examples/02_memory_scaling.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import torch

from alphafold2_tpu_torch.device import resolve_device
from alphafold2_tpu_torch.models import Alphafold2
from alphafold2_tpu_torch.ops.sparse import BlockSparseConfig
from alphafold2_tpu_torch.predict import init_params

TINY = os.environ.get("EX_TINY") == "1"
DIM, N, M = (32, 32, 2) if TINY else (128, 128, 8)


def loss_and_grads(model, seq, msa, mask, msa_mask):
    out = model(seq, msa, mask=mask, msa_mask=msa_mask)
    loss = (out ** 2).mean()
    loss.backward()
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    return float(loss.detach()), len(grads), all(bool(torch.isfinite(g).all()) for g in grads)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    dev = resolve_device(ap.parse_args(argv).device)

    model = Alphafold2(
        dim=DIM, depth=2, heads=2, dim_head=16, max_seq_len=2 * N,
        # block-sparse pair self-attention on the first depth step only
        # (reference README "Sparse Attention"): K4 forward, K5 backward
        sparse_self_attn=(True, False),
        sparse_config=BlockSparseConfig(block_size=16, num_random_blocks=1),
        # compress the pair<-MSA keys and values 2x (reference README
        # "Memory Compressed Attention"); the compressed pass runs K1
        cross_attn_compress_ratio=2,
        # one shared attention matrix across the MSA rows (reference README
        # "MSA Tied Row Attention"), padded entries abstaining: K2
        msa_tie_row_attn=True,
        # O(1)-in-depth activations: each layer recomputed in the backward...
        remat=True,
        # ...keeping the matmul outputs ("dots_no_batch" keeps fewer)
        remat_policy="dots",
    )
    init_params(model, 0).to(dev)

    gen = torch.Generator().manual_seed(0)
    seq = torch.randint(0, 21, (1, N), generator=gen).to(dev)
    msa = torch.randint(0, 21, (1, M, N), generator=gen).to(dev)
    mask = torch.ones((1, N), dtype=torch.bool, device=dev)
    msa_mask = torch.ones((1, M, N), dtype=torch.bool, device=dev)

    loss, n, finite = loss_and_grads(model, seq, msa, mask, msa_mask)
    print(f"loss={loss:.4f}, {n} gradient leaves, all finite: {finite}")
    assert finite

    # reversible=True gives the inversion-based engine instead: the
    # reference's reversible trunk, whose backward recomputes each layer
    # from the next layer's output
    rev = Alphafold2(dim=DIM, depth=2, heads=2, dim_head=16, max_seq_len=2 * N,
                     msa_tie_row_attn=True, reversible=True)
    init_params(rev, 0).to(dev)
    loss, n, finite = loss_and_grads(rev, seq, msa, mask, msa_mask)
    print(f"reversible: loss={loss:.4f}, {n} gradient leaves, all finite: {finite}")
    assert finite
    print("ok")


if __name__ == "__main__":
    main()
