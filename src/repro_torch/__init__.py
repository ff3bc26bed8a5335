"""PyTorch/CUDA port of the DGS reproduction (``repro``), module for module.

Imports ``torch`` and ``numpy`` only, never ``jax`` or ``repro``.  Entry
points run on the CUDA card unless the caller asks for the CPU.
"""
