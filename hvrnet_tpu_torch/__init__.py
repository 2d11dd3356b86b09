"""PyTorch/CUDA port of hvrnet_tpu for one NVIDIA H100.

The JAX package ``hvrnet_tpu`` stays the reference; this package imports
nothing of it (nor JAX).  Slice 1 covers HVRNet exact-ring video inference:
``engine.HNMBRCNN`` + ``engine.SlidingWindowRunner``, with the flash masked
attention as a hand-written CUDA kernel (``csrc/masked_attention.cu``).
"""
