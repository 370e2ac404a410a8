"""the_algorithm_tpu_torch: the PyTorch and CUDA port of the_algorithm_tpu.

It mirrors the JAX package's subpackage and module names, so each module has
an obvious counterpart there, and runs the same computations with PyTorch on
the CPU or on an NVIDIA Hopper GPU. The JAX package's Pallas TPU kernels are
hand-written CUDA kernels here (``csrc/``), built at first use by
:mod:`the_algorithm_tpu_torch._build`. The package never imports JAX.
"""

__version__ = "0.1.0"
