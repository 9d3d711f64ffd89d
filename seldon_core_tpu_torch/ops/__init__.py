"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (the JAX package's Pallas kernels, thought through again for
Hopper). ``attention`` launches the kernel on CUDA tensors and runs the
plain version on CPU tensors."""

from .flash_attention import LAUNCHES, attention, attention_plain, flash_attention_cuda  # noqa: F401
