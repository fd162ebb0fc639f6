"""PyTorch/CUDA port of the CA-AFL system (``repro``).

The package mirrors ``src/repro`` module for module and imports neither JAX
nor ``repro``: the JAX package is the reference the tests pin this one
against. Entry points take ``device=None``, meaning the CUDA card, and raise
when none is present; pass ``device="cpu"`` to run the plain versions of the
kernels on the CPU.
"""
