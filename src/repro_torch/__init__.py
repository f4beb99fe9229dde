"""repro_torch — SharedDB (VLDB'12) on PyTorch and CUDA for NVIDIA Hopper.

The port of ``repro.core`` (the batched shared-computation query engine)
beside the JAX/Pallas package.  It mirrors that package's module paths
(``repro_torch.core.storage`` is the port of ``repro.core.storage``, and
so on), imports ``torch`` and numpy and never ``jax``, and runs its hot
loops through hand-written CUDA kernels for ``sm_90a``
(``repro_torch.kernels``) on the card, or through their plain PyTorch
versions on the CPU.
"""

__version__ = "0.1.0"
