"""PyTorch / CUDA port of dynamicpdb_tpu for one NVIDIA H100.

Module paths mirror the JAX package (``dynamicpdb_tpu``), which stays the
reference; nothing here imports it, or JAX. Entry points take a ``device``
argument that defaults to ``"cuda"`` and raises when no card is present.
"""
