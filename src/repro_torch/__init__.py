"""PyTorch/CUDA port of the elastic trainer in ``src/repro``.

The JAX package is the reference; this package computes the same
functions in PyTorch, with the reference's TPU kernels replaced by CUDA
kernels written for the H100 (``csrc/``). It imports neither ``jax`` nor
any module of ``repro``: host modules it shares with the reference are
kept here as copies, each naming its source.
"""
