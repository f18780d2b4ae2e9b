"""PyTorch/CUDA port of the ``repro`` serving path for one NVIDIA H100.

Same subpackage layout and module names as the JAX package beside it
(``src/repro/``), which stays the reference.  This package imports
``torch``, numpy and the standard library only — never ``jax`` and never
``repro``: every host module it needs is its own copy.

Entry points run on CUDA unless the caller passes ``device="cpu"``; with no
CUDA device and no explicit CPU request they raise (``device.resolve``).
"""
