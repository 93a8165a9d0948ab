from alphafold2_tpu_torch.utils.structure import (
    DISTANCE_THRESHOLDS,
    cdist,
    center_distogram,
    get_bucketed_distance_matrix,
    nerf,
    scn_backbone_mask,
    scn_cloud_mask,
    sidechain_container,
)
from alphafold2_tpu_torch.utils.metrics import (
    GDT,
    Kabsch,
    RMSD,
    TMscore,
    calc_phis,
    distogram_lddt,
    gdt,
    get_dihedral,
    kabsch,
    lddt,
    rmsd,
    tmscore,
)
from alphafold2_tpu_torch.utils.mds import (
    MDScaling,
    calc_phis_backbone,
    mds,
    mdscaling,
    mdscaling_backbone,
)
