"""PyTorch/CUDA port of the AGM/EAGM SSSP engine (the JAX package
``repro`` is its reference): torch for the engine, hand-written CUDA
C++ for Hopper (``csrc/``) for the min-plus kernels.

Entry points run on the card unless the caller passes
``device="cpu"``.
"""
