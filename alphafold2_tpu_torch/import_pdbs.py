"""Convert a directory of PDB files into ``.npz`` training shards: the
port's counterpart of ``scripts/import_pdbs.py``.

    python -m alphafold2_tpu_torch.import_pdbs pdb_dir/ shards_out/ [--chain A]

Each ``.pdb``/``.ent`` file's residues with all three backbone atoms (N,
CA, C), in file order, become one shard: ``seq`` (L,) tokens in
``AA_ALPHABET`` order and ``coords`` (L, 3, 3) N/CA/C. Residues of unknown
type are dropped, and a structure left with fewer than 4 residues is
skipped. The directory then trains with ``data.source=npz
data.data_dir=shards_out`` (or ``native``).
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
from typing import Optional

import numpy as np

from alphafold2_tpu_torch import constants
from alphafold2_tpu_torch.utils import pdb as pdbio

AA_INDEX = {a: i for i, a in enumerate(constants.AA_ALPHABET)}


def convert_structure(s: pdbio.PDBStructure, chain: Optional[str] = None):
    """Structure -> (seq tokens (L,) int32, backbone (L, 3, 3) float32), or
    None below 4 residues. Residues are grouped by (chain, resseq) in file
    order over the protein (non-HETATM) records, of ``chain`` alone when
    given."""
    keep = ~s.hetero
    if chain is not None:
        keep &= s.chain == chain
    sub = s.select(keep)
    seqs, bbs = [], []
    current = None
    atoms: dict = {}
    rows = list(zip(sub.chain, sub.resseq, sub.name, sub.resname, sub.coords))
    rows.append((None, None, None, None, None))  # flushes the last residue
    for ch, ri, nm, rn, xyz in rows:
        key = (ch, ri)
        if key != current:
            if current is not None and all(k in atoms for k in ("N", "CA", "C")):
                aa = pdbio.THREE_TO_ONE.get(str(atoms["resname"]), None)
                if aa is not None and aa in AA_INDEX:
                    seqs.append(AA_INDEX[aa])
                    bbs.append(np.stack([atoms["N"], atoms["CA"], atoms["C"]]))
            current = key
            atoms = {}
        if nm in ("N", "CA", "C") and nm not in atoms:
            atoms[nm] = xyz
            atoms["resname"] = rn
    if len(seqs) < 4:
        return None
    return np.asarray(seqs, np.int32), np.stack(bbs).astype(np.float32)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("pdb_dir")
    ap.add_argument("out_dir")
    ap.add_argument("--chain", default=None, help="restrict to one chain id")
    args = ap.parse_args(argv)

    os.makedirs(args.out_dir, exist_ok=True)
    paths = sorted(glob.glob(os.path.join(args.pdb_dir, "*.pdb"))
                   + glob.glob(os.path.join(args.pdb_dir, "*.ent")))
    if not paths:
        print(f"no .pdb files under {args.pdb_dir!r}", file=sys.stderr)
        return 1
    n_ok = 0
    for path in paths:
        # the extension stays in the name: 1abc.pdb and 1abc.ent are two shards
        name = os.path.basename(path).replace(".", "_")
        try:
            result = convert_structure(pdbio.load_pdb(path), chain=args.chain)
        except (ValueError, IndexError) as e:
            print(f"skip {name}: unparseable ({e})", file=sys.stderr)
            continue
        if result is None:
            print(f"skip {name}: <4 complete backbone residues", file=sys.stderr)
            continue
        seq, backbone = result
        np.savez(os.path.join(args.out_dir, f"{name}.npz"), seq=seq, coords=backbone)
        n_ok += 1
    print(f"imported {n_ok}/{len(paths)} structures -> {args.out_dir}")
    return 0 if n_ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
