"""CORE (correlative proxy models for ML inference queries) in PyTorch.

The PyTorch and CUDA counterpart of the JAX package ``repro``: the same
module names, the same host logic, and a hand-written CUDA kernel for the
fused cascade scorer (``kernels/csrc/cascade_score.cu``).  Every entry
point that touches tensors takes a ``device`` argument that defaults to
``"cuda"`` and raises when no card is present; pass ``device="cpu"`` to run
on the CPU, where each kernel wrapper takes its plain PyTorch version.

This package never imports ``jax`` or ``repro``; ``repro_torch.interop``
carries weights across from the JAX package's numpy-readable parameters.
"""
