"""Runnable examples of the port, the counterparts of the repo's
``examples/01-05``. Run a file,
``python alphafold2_tpu_torch/examples/01_distogram_basics.py [--device cpu]``
(``EX_TINY=1`` shrinks the shapes), or several in one process,
``python -m alphafold2_tpu_torch.examples 01 02 [--device cpu]``; each ends
by printing ``ok``.
"""
