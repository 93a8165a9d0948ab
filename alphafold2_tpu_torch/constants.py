"""Global constants for alphafold2_tpu_torch.

A copy of ``alphafold2_tpu/constants.py`` (the port imports nothing of the
JAX package). Devices are explicit arguments of the port's entry points, so
no device global exists here.
"""

MAX_NUM_MSA = 20
MAX_NUM_TEMPLATES = 10
NUM_AMINO_ACIDS = 21
NUM_EMBEDDS_TR = 1280  # ESM-1b width
DISTOGRAM_BUCKETS = 37

# distogram span in Angstroms (reference utils.py:29,35)
DISTOGRAM_MIN_DIST = 2.0
DISTOGRAM_MAX_DIST = 20.0

# sidechainnet-compatible atom layout (reference utils.py:13,18-21)
NUM_COORDS_PER_RES = 14
GLOBAL_PAD_CHAR = 0
BB_BUILD_INFO = {
    "BONDLENS": {"c-o": 1.229},
    "BONDANGS": {"ca-c-o": 2.0944},
}

# Amino-acid vocabulary: 20 canonical AAs in single-letter alphabetical order,
# index 20 = padding/unknown. Matches sidechainnet's ProteinVocabulary layout
# the reference relies on (utils.py:11,16).
AA_ALPHABET = "ACDEFGHIKLMNPQRSTVWY"
AA_PAD_INDEX = 20

# Heavy-atom count per residue type (backbone N,CA,C,O = 4 + sidechain),
# indexed by AA_ALPHABET order; pad gets 0. Used by scn_cloud_mask
# (reference utils.py:163-180 derives this from SC_BUILD_INFO at runtime).
ATOMS_PER_AA = {
    "A": 5, "C": 6, "D": 8, "E": 9, "F": 11,
    "G": 4, "H": 10, "I": 8, "K": 9, "L": 8,
    "M": 8, "N": 8, "P": 7, "Q": 9, "R": 11,
    "S": 6, "T": 7, "V": 7, "W": 14, "Y": 12,
}
ATOM_COUNTS = tuple(ATOMS_PER_AA[c] for c in AA_ALPHABET) + (0,)
