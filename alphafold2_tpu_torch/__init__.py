"""alphafold2_tpu_torch: the PyTorch/CUDA port of alphafold2_tpu.

A second package beside the JAX one, which stays the reference. It imports
torch and numpy, never jax, flax or anything of ``alphafold2_tpu``. Its
attention runs kernels written by hand for Hopper (``csrc/``), built with
nvcc on first use; their plain PyTorch versions serve CPU tensors.

Entry points: :func:`alphafold2_tpu_torch.predict.predict`,
:class:`alphafold2_tpu_torch.serve.engine.ServeEngine` and
:func:`alphafold2_tpu_torch.train.loop.train`, on the CUDA card unless the
caller passes ``device="cpu"``. :mod:`alphafold2_tpu_torch.analysis` holds
the pre-hardware checks: the linter, the graph audit and the Hopper build
gate.
"""
