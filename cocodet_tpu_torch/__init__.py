"""cocodet_tpu_torch: the PyTorch / CUDA (NVIDIA H100) port of cocodet_tpu.

The JAX package ``cocodet_tpu`` is the reference this package is held
against; this package imports neither it nor JAX. Entry points run on the
card (``device="cuda"``) unless the caller asks for the CPU.
"""
