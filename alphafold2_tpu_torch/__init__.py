"""alphafold2_tpu_torch: the PyTorch/CUDA port of alphafold2_tpu.

A second package beside the JAX one, which stays the reference. It imports
torch and numpy, never jax, flax or anything of ``alphafold2_tpu``. Its
attention runs two kernels written by hand for Hopper (``csrc/``), built
with nvcc on first use; their plain PyTorch versions serve CPU tensors.

Entry points: :func:`alphafold2_tpu_torch.predict.predict` and
:class:`alphafold2_tpu_torch.serve.engine.ServeEngine`, on the CUDA card
unless the caller passes ``device="cpu"``.
"""
