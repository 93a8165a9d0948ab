"""Structure refinement: the port's counterpart of ``scripts/refinement.py``.

    python -m alphafold2_tpu_torch.refinement in.pdb out.pdb --native \
        [--iters 200] [--device=cpu]

``--native`` relaxes the structure's N/CA/C backbone with
``utils/relax.py`` (Adam on bond geometry, clashes and a restraint to the
input) and writes it back into the structure: chains, numbering,
sidechains and other atoms are kept as they were. The relaxation runs on
the card unless ``--device=cpu``. PyRosetta's FastRelax is not carried:
without ``--native``, :func:`run_fast_relax` loads its configuration and
raises ``NotImplementedError``, the contract of the reference's stub.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Optional, Union

import torch

DEFAULT_CONFIG = {
    "scorefxn": "ref2015",
    "max_iter": 100,
    "constrain_relax_to_start_coords": True,
}


def load_config(path: Optional[str] = None) -> dict:
    cfg = dict(DEFAULT_CONFIG)
    if path is not None:
        cfg.update(json.loads(Path(path).read_text()))
    return cfg


def run_native_relax(pdb_in: str, pdb_out: str, iters: int = 200,
                     device: Optional[Union[str, torch.device]] = None):
    """Relax ``pdb_in``'s complete backbone residues and write ``pdb_out``;
    returns the :class:`~alphafold2_tpu_torch.utils.relax.RelaxResult`."""
    from alphafold2_tpu_torch.device import resolve_device
    from alphafold2_tpu_torch.utils.pdb import load_pdb, replace_coords, save_pdb
    from alphafold2_tpu_torch.utils.relax import fast_relax

    dev = resolve_device(device)
    s = load_pdb(pdb_in)
    seq, bb, rows = s.backbone_trace(return_indices=True)  # (L, 3, 3)
    if len(seq) == 0:
        raise SystemExit(f"no complete N/CA/C backbone residues found in {pdb_in} "
                         "(CA-only traces cannot be relaxed)")
    result = fast_relax(torch.from_numpy(bb.reshape(1, -1, 3)).to(dev), iters=iters)
    e0, e1 = float(result.energy_history[0, 0]), float(result.energy[0])
    print(f"native relax: energy {e0:.2f} -> {e1:.2f} over {iters} iters", flush=True)
    coords = s.coords.copy()
    coords[rows.reshape(-1)] = result.coords[0].cpu().numpy()
    save_pdb(replace_coords(s, coords), pdb_out)
    return result


def run_fast_relax(pdb_in: str, pdb_out: str, config_path: Optional[str] = None) -> str:
    """PyRosetta's FastRelax, which the port does not carry: loads the
    configuration, then raises ``NotImplementedError`` (use
    :func:`run_native_relax`)."""
    config = load_config(config_path)
    raise NotImplementedError(
        f"FastRelax needs pyrosetta (config loaded: {config}); "
        "run with --native for the dependency-free relaxation")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("pdb_in")
    ap.add_argument("pdb_out")
    ap.add_argument("--config", default=None)
    ap.add_argument("--native", action="store_true",
                    help="dependency-free relaxation (utils/relax.py)")
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--device", default=None, help="cpu or cuda (default: the card)")
    args = ap.parse_args(argv)
    if args.native:
        if args.config is not None:
            ap.error("--config applies to the pyrosetta path, not --native")
        run_native_relax(args.pdb_in, args.pdb_out, iters=args.iters, device=args.device)
    else:
        if args.iters != 200:
            ap.error("--iters applies to --native; use --config for pyrosetta")
        run_fast_relax(args.pdb_in, args.pdb_out, config_path=args.config)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
