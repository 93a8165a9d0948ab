"""Evaluate a (checkpointed) distogram model: the port's counterpart of
``scripts/evaluate.py``.

    python -m alphafold2_tpu_torch.evaluate [--checkpoint dir] [--batches 4] \
        [--seed 1234] [--realize] [--device=cpu] [section.field=value ...]

Over ``--batches`` batches of the configured source (seeded by ``--seed``,
a held-out stream; the ``data.features`` adaptation of training applies)
it reports BASELINE.md's quality bar, distogram lDDT, with the distogram
cross-entropy and bin accuracy; with ``--realize`` also the realized
structure's RMSD, TM-score and lDDT against the true CA trace (weighted
MDS, 100 iterations, no mirror fix, then Kabsch). The parameters are the
latest checkpoint's of ``--checkpoint`` (a ``train.loop`` run's), else the
seeded init of ``train.seed``. One JSON line at the end carries JAX's keys.
Runs on the card unless ``--device=cpu``.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional, Union

import numpy as np
import torch

from alphafold2_tpu_torch.config import Config, parse_cli


def evaluate(cfg: Config, checkpoint: Optional[str] = None, batches: int = 4,
             seed: int = 1234, realize: bool = False,
             device: Optional[Union[str, torch.device]] = None,
             forward_s: Optional[list] = None) -> dict:
    """The metrics ``main`` prints, as a dict. ``forward_s``, when given,
    gets each batch's forward wall time (seconds, to a synchronize)."""
    from alphafold2_tpu_torch.data.pipeline import make_dataset
    from alphafold2_tpu_torch.device import resolve_device
    from alphafold2_tpu_torch.predict import init_params, realize_structure
    from alphafold2_tpu_torch.train.checkpoint import CheckpointManager
    from alphafold2_tpu_torch.train.loop import (
        apply_features, batch_to_device, build_model, close_owned, distogram_cross_entropy,
        embedds_width)
    from alphafold2_tpu_torch.utils import Kabsch, RMSD, TMscore, distogram_lddt, lddt
    from alphafold2_tpu_torch.utils.structure import get_bucketed_distance_matrix

    dev = resolve_device(device)
    dataset = make_dataset(cfg.data, seed=seed)
    try:
        ds = apply_features(iter(dataset), cfg)
        batch = next(ds)
        model = init_params(build_model(cfg, num_embedds=embedds_width(batch)), cfg.train.seed)
        if checkpoint:
            _, step = CheckpointManager(checkpoint).restore_params(model)
            print(f"restored checkpoint step {step}", flush=True)
        model = model.to(dev).eval()
        ces, accs, dls, struct = [], [], [], []
        for b in range(batches):
            t = batch_to_device(batch, dev)
            t0 = time.perf_counter()
            with torch.inference_mode():
                logits = model(t["seq"], t.get("msa"), mask=t["mask"],
                               msa_mask=t.get("msa_mask"), embedds=t.get("embedds"))
                labels = get_bucketed_distance_matrix(t["coords"], t["mask"])
                ce = distogram_cross_entropy(logits, labels)
                valid = labels != -100
                acc = ((logits.argmax(-1) == labels) & valid).sum() / valid.sum().clamp_min(1)
                dl = distogram_lddt(logits, t["coords"], mask=t["mask"]).mean()
                ce, acc, dl = float(ce), float(acc), float(dl)
            if forward_s is not None:
                forward_s.append(time.perf_counter() - t0)
            ces.append(ce)
            accs.append(acc)
            dls.append(dl)
            print(f"[batch {b}] ce={ce:.4f} bin_acc={acc:.4f} distogram_lddt={dl:.4f}",
                  flush=True)
            if realize:
                # a CA-level distogram: no (N, CA, C) triplets, so no mirror fix
                with torch.inference_mode():
                    coords, _, _ = realize_structure(logits, iters=100, fix_mirror=False,
                                                     mask=t["mask"])
                coords = coords.float().cpu().numpy()
                for k in range(coords.shape[0]):
                    # valid residues by index: real masks can have interior holes
                    keep = np.where(batch["mask"][k])[0]
                    a, true = Kabsch(coords[k][:, keep], batch["coords"][k][keep].T)
                    struct.append({"rmsd": float(RMSD(a, true)[0]),
                                   "tm": float(TMscore(a, true)[0]),
                                   "lddt": float(lddt(torch.from_numpy(a.T[None]),
                                                      torch.from_numpy(true.T[None]))[0])})
            if b + 1 < batches:
                batch = next(ds)
    finally:
        close_owned(dataset, owned=True)
    result = {"distogram_ce": sum(ces) / len(ces),
              "distogram_bin_accuracy": sum(accs) / len(accs),
              "distogram_lddt": sum(dls) / len(dls), "batches": batches}
    for key in ("rmsd", "tm", "lddt"):
        if struct:
            result[f"structure_{key}"] = sum(s[key] for s in struct) / len(struct)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--batches", type=int, default=4)
    ap.add_argument("--seed", type=int, default=1234)  # a held-out stream
    ap.add_argument("--realize", action="store_true",
                    help="also run MDS realization and the structure metrics")
    ap.add_argument("--device", default=None, help="cpu or cuda (default: the card)")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)
    cfg = parse_cli(args.overrides, Config())
    result = evaluate(cfg, checkpoint=args.checkpoint, batches=args.batches, seed=args.seed,
                      realize=args.realize, device=args.device)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
