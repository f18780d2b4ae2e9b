"""Hand-written Hopper kernels (CUDA C++ for sm_90a, ``csrc/``), their
wrappers and their plain PyTorch versions (``ref.py``)."""
