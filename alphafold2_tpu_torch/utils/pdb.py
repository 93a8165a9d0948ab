"""PDB export of predicted backbones: a numpy copy of the JAX package's
``alphafold2_tpu/utils/pdb.py`` ``PDBStructure``, ``to_pdb_string`` and
``backbone_to_pdb`` (the parts prediction needs)."""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from alphafold2_tpu_torch import constants

THREE_TO_ONE = {
    "ALA": "A", "CYS": "C", "ASP": "D", "GLU": "E", "PHE": "F",
    "GLY": "G", "HIS": "H", "ILE": "I", "LYS": "K", "LEU": "L",
    "MET": "M", "ASN": "N", "PRO": "P", "GLN": "Q", "ARG": "R",
    "SER": "S", "THR": "T", "VAL": "V", "TRP": "W", "TYR": "Y",
    "MSE": "M", "SEC": "C", "PYL": "K",
}
ONE_TO_THREE = {v: k for k, v in reversed(list(THREE_TO_ONE.items()))}


@dataclasses.dataclass
class PDBStructure:
    """Columnar ATOM/HETATM records of one model."""

    serial: np.ndarray  # (N,) int32
    name: np.ndarray  # (N,) <U4 atom name, e.g. "CA"
    resname: np.ndarray  # (N,) <U3
    chain: np.ndarray  # (N,) <U1
    resseq: np.ndarray  # (N,) int32
    coords: np.ndarray  # (N, 3) float32 Angstroms
    element: np.ndarray  # (N,) <U2
    hetero: np.ndarray  # (N,) bool — HETATM record
    icode: np.ndarray = None  # (N,) <U1 insertion code ('' when absent)

    def __post_init__(self):
        if self.icode is None:
            self.icode = np.full(len(self.serial), "", "<U1")

    def __len__(self) -> int:
        return len(self.serial)


def to_pdb_string(s: PDBStructure) -> str:
    """Serialize to fixed-column PDB v3.3 ATOM/HETATM records + TER/END."""
    lines = []
    prev_chain = None
    for i in range(len(s)):
        if prev_chain is not None and s.chain[i] != prev_chain:
            lines.append("TER")
        prev_chain = s.chain[i]
        rec = "HETATM" if s.hetero[i] else "ATOM  "
        nm = str(s.name[i])
        nm = f" {nm:<3}" if len(nm) < 4 and len(str(s.element[i])) < 2 else f"{nm:<4}"
        x, y, z = (float(v) for v in s.coords[i])
        ic = str(s.icode[i]) or " "
        lines.append(
            f"{rec}{int(s.serial[i]):5d} {nm} {str(s.resname[i]):>3}"
            f" {str(s.chain[i])}{int(s.resseq[i]):4d}{ic}   "
            f"{x:8.3f}{y:8.3f}{z:8.3f}{1.0:6.2f}{0.0:6.2f}"
            f"          {str(s.element[i]):>2}"
        )
    lines.append("TER")
    lines.append("END")
    return "\n".join(lines) + "\n"


def backbone_to_pdb(
    seq: Sequence[int] | str,
    backbone: np.ndarray,
    chain: str = "A",
) -> PDBStructure:
    """A structure from predicted coords: ``seq`` as letters or AA_ALPHABET
    indices, ``backbone`` (L, 3, 3) N/CA/C or (L, 3) CA-only."""
    backbone = np.asarray(backbone, np.float32)
    if isinstance(seq, str):
        letters = list(seq)
    else:
        letters = [
            constants.AA_ALPHABET[int(i)] if int(i) < 20 else "X" for i in seq
        ]
    L = len(letters)
    names = ["CA"] if backbone.ndim == 2 else ["N", "CA", "C"]
    per = len(names)
    if backbone.size != L * per * 3:
        raise ValueError(
            f"backbone {backbone.shape} does not hold {L} residues x "
            f"{per} atoms x 3"
        )
    n = L * per
    return PDBStructure(
        serial=np.arange(1, n + 1, dtype=np.int32),
        name=np.asarray(names * L, "<U4"),
        resname=np.asarray(
            [ONE_TO_THREE.get(a, "UNK") for a in letters for _ in names], "<U3"
        ),
        chain=np.full(n, chain, "<U1"),
        resseq=np.repeat(np.arange(1, L + 1, dtype=np.int32), per),
        coords=backbone.reshape(n, 3),
        element=np.asarray([nm[0] for nm in names] * L, "<U2"),
        hetero=np.zeros(n, bool),
    )
