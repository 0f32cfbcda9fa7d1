"""PyTorch + CUDA port of pasta_tpu for NVIDIA Hopper (H100).

The JAX package `pasta_tpu` is the reference this package is held against.
Layout at public functions is NHWC (images) and HWIO (conv weights), as in
the JAX package; modules store torch state-dict keys and OIHW weights.
"""
