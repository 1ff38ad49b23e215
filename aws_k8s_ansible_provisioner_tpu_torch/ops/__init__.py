"""Kernels, their wrappers and the attention/sampling ops of the PyTorch port."""
