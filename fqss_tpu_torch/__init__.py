"""FQSS on PyTorch and CUDA: the ConvTasNet FQSS-8bit serving path.

A port of :mod:`fqss_tpu` (JAX/Pallas on a TPU) to PyTorch on an NVIDIA
Hopper GPU. Module names mirror ``fqss_tpu`` so each counterpart is easy to
find; the JAX package is the reference every module is tested against.

Layout differs from the JAX package inside the modules only: activations are
NCT, conv weights ``[Cout, Cin/g, k]``, transposed-conv weights
``[Cin, Cout, k]``. Model I/O keeps the JAX shapes (``[B, T]`` in,
``[B, S, T]`` out).

The quantizers run through two hand-written CUDA kernels
(``csrc/fake_quant.cu``) on CUDA tensors and through their plain PyTorch
versions on CPU tensors. This package never imports ``jax`` or ``flax``.
"""

__version__ = "0.1.0"
