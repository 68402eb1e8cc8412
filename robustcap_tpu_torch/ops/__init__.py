r"""Hand-written CUDA kernels (``csrc/``) behind wrappers that run their
plain PyTorch versions on CPU tensors."""
