"""PDB I/O: a numpy copy of the JAX package's ``alphafold2_tpu/utils/pdb.py``.

- :class:`PDBStructure`: columnar ATOM/HETATM records, with ``select``,
  ``chains``, ``ca_trace`` and ``backbone_trace`` (:50-127);
- :func:`parse_pdb` / :func:`load_pdb` / :func:`to_pdb_string` /
  :func:`save_pdb`: the fixed-column record codec, first model only,
  altloc blank or A (:129-197);
- :func:`clean_pdb` (protein ATOM records, optionally one chain),
  :func:`replace_coords` and :func:`custom2pdb` (coordinates written into
  a scaffold in file order, :244-280);
- :func:`backbone_to_pdb`: a structure from a predicted backbone.

:func:`download_pdb` fetches nothing: the port has no network path, so it
raises the ``RuntimeError`` JAX's raises where the network is out of
reach, and :func:`custom2pdb` without a local scaffold raises with it.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence

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

    def _icode(self) -> np.ndarray:
        return self.icode

    def select(self, mask: np.ndarray) -> "PDBStructure":
        return PDBStructure(
            self.serial[mask], self.name[mask], self.resname[mask],
            self.chain[mask], self.resseq[mask], self.coords[mask],
            self.element[mask], self.hetero[mask], self._icode()[mask],
        )

    def chains(self) -> list:
        """Chain ids in file order."""
        seen: dict = {}
        for c in self.chain:
            seen.setdefault(str(c), None)
        return list(seen)

    def ca_trace(self) -> tuple:
        """(sequence, (L, 3) CA coords) over protein residues, file order."""
        sub = self.select((self.name == "CA") & ~self.hetero)
        seq = "".join(THREE_TO_ONE.get(str(r), "X") for r in sub.resname)
        return seq, sub.coords.copy()

    def backbone_trace(self, return_indices: bool = False) -> tuple:
        """(sequence, (L, 3, 3) N/CA/C coords) over the protein residues
        that have all three backbone atoms, in file order, residues keyed
        by (chain, resseq, insertion code); ``return_indices`` adds the
        (L, 3) rows of those atoms in this structure's arrays."""
        residues: dict = {}
        order: list = []
        icodes = self._icode()
        for i in range(len(self)):
            if self.hetero[i]:
                continue
            key = (str(self.chain[i]), int(self.resseq[i]), str(icodes[i]))
            if key not in residues:
                residues[key] = {"resname": str(self.resname[i])}
                order.append(key)
            nm = str(self.name[i])
            if nm in ("N", "CA", "C") and nm not in residues[key]:
                residues[key][nm] = i
        seq_chars, coords, indices = [], [], []
        for key in order:
            r = residues[key]
            if all(nm in r for nm in ("N", "CA", "C")):
                seq_chars.append(THREE_TO_ONE.get(r["resname"], "X"))
                rows = [r["N"], r["CA"], r["C"]]
                indices.append(rows)
                coords.append([self.coords[j] for j in rows])
        coords_arr = np.asarray(coords, np.float32).reshape(-1, 3, 3)
        if return_indices:
            return "".join(seq_chars), coords_arr, np.asarray(indices, np.int64).reshape(-1, 3)
        return "".join(seq_chars), coords_arr


def parse_pdb(text: str) -> PDBStructure:
    """ATOM/HETATM records of the first MODEL of PDB-format text."""
    serial, name, resname, chain, resseq = [], [], [], [], []
    coords, element, hetero, icode = [], [], [], []
    for line in text.splitlines():
        rec = line[:6]
        if rec == "ENDMDL":
            break
        if rec not in ("ATOM  ", "HETATM"):
            continue
        if line[16] not in (" ", "A"):  # altloc: blank or A only
            continue
        serial.append(int(line[6:11]))
        name.append(line[12:16].strip())
        resname.append(line[17:20].strip())
        chain.append(line[21])
        resseq.append(int(line[22:26]))
        icode.append(line[26].strip() if len(line) > 26 else "")
        coords.append((float(line[30:38]), float(line[38:46]), float(line[46:54])))
        element.append(line[76:78].strip() if len(line) >= 78 else "")
        hetero.append(rec == "HETATM")
    return PDBStructure(
        np.asarray(serial, np.int32), np.asarray(name, "<U4"),
        np.asarray(resname, "<U3"), np.asarray(chain, "<U1"),
        np.asarray(resseq, np.int32),
        np.asarray(coords, np.float32).reshape(-1, 3),
        np.asarray(element, "<U2"), np.asarray(hetero, bool),
        np.asarray(icode, "<U1"),
    )


def load_pdb(path: str) -> PDBStructure:
    with open(path) as f:
        return parse_pdb(f.read())


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
        ic = str(s._icode()[i]) or " "
        lines.append(
            f"{rec}{int(s.serial[i]):5d} {nm} {str(s.resname[i]):>3}"
            f" {str(s.chain[i])}{int(s.resseq[i]):4d}{ic}   "
            f"{x:8.3f}{y:8.3f}{z:8.3f}{1.0:6.2f}{0.0:6.2f}"
            f"          {str(s.element[i]):>2}"
        )
    lines.append("TER")
    lines.append("END")
    return "\n".join(lines) + "\n"


def save_pdb(s: PDBStructure, path: str) -> str:
    with open(path, "w") as f:
        f.write(to_pdb_string(s))
    return path


def download_pdb(name: str, route: str, timeout: float = 30.0) -> str:
    """RCSB's entry ``name`` to ``route``: the port has no network path, so
    this raises as JAX's does where the network is out of reach."""
    del route, timeout
    url = f"https://files.rcsb.org/download/{name}.pdb"
    raise RuntimeError(f"cannot download {url!r} (no network access in the port)")


def clean_pdb(name: str, route: Optional[str] = None, chain_id: Optional[str] = None,
              chain_num: Optional[int] = None) -> str:
    """Keep protein ATOM records, optionally one chain (by letter, or by
    0-based index in file order), and write them to ``route`` (default:
    over the input)."""
    s = load_pdb(name)
    keep = ~s.hetero & np.isin(s.resname, list(THREE_TO_ONE))
    if chain_id is not None:
        keep &= s.chain == chain_id
    elif chain_num is not None:
        keep &= s.chain == s.chains()[chain_num]
    return save_pdb(s.select(keep), route if route is not None else name)


def replace_coords(s: PDBStructure, coords: np.ndarray) -> PDBStructure:
    """A copy of ``s`` with its coordinates replaced in file order; (3, N)
    is taken as (N, 3)."""
    coords = np.asarray(coords, np.float32)
    if coords.shape[0] == 3 and coords.shape[-1] != 3:
        coords = coords.T
    if coords.shape != s.coords.shape:
        raise ValueError(f"coords shape {coords.shape} != structure {s.coords.shape}")
    return dataclasses.replace(s, coords=coords)


def custom2pdb(coords, proteinnet_id: str, route: str,
               scaffold_path: Optional[str] = None) -> tuple:
    """Model coordinates -> ``route`` through a scaffold structure whose
    coordinates are replaced in file order; ``proteinnet_id`` is
    ``<class>#<pdb_id>_<chain_number>_<chain_id>``. Without
    ``scaffold_path`` the scaffold would be downloaded, which raises
    (:func:`download_pdb`). Returns (scaffold path, route)."""
    coords = np.asarray(coords, np.float32)
    tokens = proteinnet_id.split("#")[-1].split("_")
    pdb_name, chain_num = tokens[0], tokens[1]
    if scaffold_path is None:
        scaffold_path = os.path.join(os.path.dirname(route) or ".", pdb_name + ".pdb")
        download_pdb(pdb_name, scaffold_path)
        clean_pdb(scaffold_path, chain_num=int(chain_num))
    save_pdb(replace_coords(load_pdb(scaffold_path), coords), route)
    return scaffold_path, route


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
