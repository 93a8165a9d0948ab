"""The data pipeline, re-exported under the JAX package's names
(``alphafold2_tpu/data/__init__.py``). ``SidechainnetDataset`` needs the
sidechainnet package and is not ported."""

from alphafold2_tpu_torch.data.pipeline import SyntheticDataset, make_dataset

__all__ = ["SyntheticDataset", "make_dataset"]
