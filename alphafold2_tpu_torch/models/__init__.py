"""The model modules, re-exported under the JAX package's names
(``alphafold2_tpu/models/__init__.py``)."""

from alphafold2_tpu_torch.models.alphafold2 import Alphafold2, TemplateBlock
from alphafold2_tpu_torch.models.trunk import Trunk, TrunkLayer
from alphafold2_tpu_torch.models.se3 import SE3Refiner, SE3TemplateEmbedder, SE3Transformer

__all__ = ["Alphafold2", "SE3Refiner", "SE3TemplateEmbedder", "SE3Transformer",
           "TemplateBlock", "Trunk", "TrunkLayer"]
